"""Phi-2 at lr 3e-4: the port's training engine against the JAX engine.

A one-off check, not a tier-1 test (pytest does not collect this file).
Phi-2 at its published width (E = 2560, D = 80, vocab 51200) cut to 2
layers, bf16 compute over fp32 masters, AdamW at lr 3e-4, clipping 1.0,
4 steps of 2 x 512 seeded random tokens.  ``jax`` builds the JAX engine,
writes its initial params to ``<dir>/phi2_init.npz`` and trains; ``torch``
bridges those params into the port's engine and trains on the same
batches.  Each writes its losses to ``<dir>/phi2_<package>.json``.  The
two packages run in separate processes, so neither holds the other's
~8 GB of state.  On the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_phi2_lr_check.py jax DIR
    PYTHONPATH=. python tests/torch_phi2_lr_check.py torch DIR
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np

SEQ, MICRO, STEPS, LR = 512, 2, 4, 3e-4
CONFIG = {"train_micro_batch_size_per_gpu": MICRO,
          "gradient_accumulation_steps": 1,
          "optimizer": {"type": "adamw", "params": {"lr": LR}},
          "zero_optimization": {"stage": 0}, "gradient_clipping": 1.0,
          "steps_per_print": 1000}
# microsoft/phi-2 config.json (deepspeed_tpu_torch/checkpoint/hf.py)
PHI_2 = dict(vocab_size=51200, hidden_size=2560, intermediate_size=10240,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=32, max_position_embeddings=2048,
             partial_rotary_factor=0.4, hidden_act="gelu_new",
             layer_norm_eps=1e-5, rope_theta=10000.0, qk_layernorm=False,
             tie_word_embeddings=False)


def batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, PHI_2["vocab_size"],
                                       (MICRO, SEQ)).astype(np.int32)}
            for _ in range(STEPS)]


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def run_jax(init_path):
    import jax
    from flax.core import meta
    import deepspeed_tpu as dst
    from deepspeed_tpu.checkpoint import hf as jhf
    from deepspeed_tpu.models.transformer import CausalLM
    from deepspeed_tpu.runtime.config import load_config
    from deepspeed_tpu.runtime.engine import _topology_from_config
    cfg = dataclasses.replace(jhf.phi_config_from_hf(
        types.SimpleNamespace(**PHI_2)), num_layers=2)
    topo = _topology_from_config(load_config(CONFIG),
                                 devices=jax.devices()[:1])
    engine, *_ = dst.initialize(model=CausalLM(cfg), config=CONFIG,
                                topology=topo)
    np.savez(init_path, **flatten(jax.tree.map(
        np.asarray, meta.unbox(engine.state.params))))
    return [float(engine.train_batch(b)) for b in batches()]


def run_torch(init_path):
    import torch
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.checkpoint import hf as thf
    from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
    from deepspeed_tpu_torch.models.transformer import CausalLM
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(thf.phi_config_from_hf(
        types.SimpleNamespace(**PHI_2)), num_layers=2)
    params = from_jax(unflatten(dict(np.load(init_path))), cfg, device="cpu")
    engine, *_ = dtt.initialize(model=CausalLM(cfg), config=CONFIG,
                                model_parameters=params, device="cpu")
    return [float(engine.train_batch(b)) for b in batches()]


def main(argv):
    package, out_dir = argv[1], argv[2]
    init_path = os.path.join(out_dir, "phi2_init.npz")
    losses = (run_jax if package == "jax" else run_torch)(init_path)
    with open(os.path.join(out_dir, f"phi2_{package}.json"), "w") as f:
        json.dump({"package": package, "losses": losses}, f)
    print(package, losses)


if __name__ == "__main__":
    main(sys.argv)
