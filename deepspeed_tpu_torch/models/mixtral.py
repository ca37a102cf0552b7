"""Mixtral: a sparse-MoE Llama-style decoder (counterpart of
``deepspeed_tpu/models/mixtral.py``; BASELINE config #4, Mixtral-8x7B).

``mixtral_config`` and its presets are the JAX package's, and so is
``MixtralForCausalLM.init_params``'s tree: the Llama tree with each
layer's dense MLP replaced by the MoE leaves (``gate`` [E, X], ``wi``
and ``wg`` [X, E, F], ``wo`` [X, F, E], stacked over layers when
``scan_layers``), drawn from an explicit ``torch.Generator``.  As in the
JAX package the presets leave ``moe_num_experts`` at 0: the serving
model routes the MLP through the MoE layer when the config it is given
says so (``mixtral_config_from_hf`` does).  The training half
(``logits_and_aux``, ``loss``, ``eval_loss``) raises: MoE training and
expert parallelism are ROADMAP Queue 1 item 11h.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..accelerator import DeviceLike, resolve_device
from ..moe.layer import MoEConfig, init_moe_params
from .transformer import CausalLM, TransformerConfig, init_params


def mixtral_config(size: str = "8x7b", **overrides) -> TransformerConfig:
    presets = {
        "8x7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                     num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=4096),
        "tiny": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                     num_layers=4, num_heads=4, num_kv_heads=2, max_seq_len=256),
        "debug": dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64),
    }
    base = dict(norm="rmsnorm", norm_eps=1e-5, activation="silu_gated",
                pos_emb="rope", causal=True, tie_embeddings=False,
                use_bias=False, dtype=torch.bfloat16)
    base.update(presets[size])
    base.update(overrides)
    return TransformerConfig(**base)


def _moe_training_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"MixtralForCausalLM.{what}: MoE training and expert parallelism "
        "are not ported yet (ROADMAP Queue 1 item 11h); the port serves "
        "Mixtral through inference.v2")


class MixtralForCausalLM(CausalLM):
    """Llama backbone with the dense MLP swapped for a top-k MoE."""

    def __init__(self, size: str = "8x7b", num_experts: int = 8,
                 top_k: int = 2, moe_overrides: Dict[str, Any] = None,
                 **overrides):
        super().__init__(mixtral_config(size, **overrides))
        moe_kw = dict(num_experts=num_experts, top_k=top_k,
                      activation=self.cfg.activation)
        moe_kw.update(moe_overrides or {})
        self.moe_cfg = MoEConfig(**moe_kw)

    def init_params(self, seed: int = 0, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32):
        """The Llama tree (``init_params(cfg, seed)``) with each layer's
        MLP replaced by MoE leaves from a generator seeded ``seed +
        10_000``; fp32 by default, as the JAX initializer draws."""
        dev = resolve_device(device)
        cfg = self.cfg
        params = init_params(cfg, seed, dev, dtype=dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 10_000)
        per_layer = [init_moe_params(self.moe_cfg, cfg.hidden_size,
                                     cfg.intermediate_size, gen, dtype, dev)
                     for _ in range(cfg.num_layers)]
        if cfg.scan_layers:
            params["layers"]["mlp"] = {
                k: torch.stack([p[k] for p in per_layer])
                for k in per_layer[0]}
        else:
            for i, p in enumerate(per_layer):
                params["layers"][f"layer_{i}"]["mlp"] = p
        return params

    def logits_and_aux(self, params, batch, rng=None, is_training=True):
        raise _moe_training_not_ported("logits_and_aux")

    def logits(self, params, batch, rng=None):
        raise _moe_training_not_ported("logits")

    def loss(self, params, batch, rng=None):
        raise _moe_training_not_ported("loss")

    def eval_loss(self, params, batch, rng=None):
        raise _moe_training_not_ported("eval_loss")
