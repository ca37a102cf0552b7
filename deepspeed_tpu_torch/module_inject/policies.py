"""Per-architecture dispatch: HF ``model_type`` -> (config converter,
weight loader).

Counterpart of ``deepspeed_tpu/module_inject/policies.py``: the same
model types grouped the same way, and the same unknown-architecture
error.  Only the dispatch table is ported: the kernels a model runs come
from the serving registry (``inference/v2/modules.py``), not from module
replacement.  Mixtral's pair gives the MoE config and the stacked-expert
tree that the serving model routes through ``moe/layer.py``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ..checkpoint import hf as hf_ckpt


class Policy(NamedTuple):
    config_from_hf: Callable[[Any], Any]
    #: ``load(state_dict, cfg, dtype, device)`` -> the port's param tree
    load: Callable[..., Any]


POLICIES = {
    ("llama", "mistral"): Policy(hf_ckpt.llama_config_from_hf,
                                 hf_ckpt.load_llama),
    ("qwen2",): Policy(hf_ckpt.qwen2_config_from_hf, hf_ckpt.load_qwen2),
    ("mixtral",): Policy(hf_ckpt.mixtral_config_from_hf,
                         hf_ckpt.load_mixtral),
    ("gpt_neox", "gptneox"): Policy(hf_ckpt.gpt_neox_config_from_hf,
                                    hf_ckpt.load_gpt_neox),
    ("gpt2",): Policy(hf_ckpt.gpt2_config_from_hf, hf_ckpt.load_gpt2),
    ("falcon", "refinedweb", "refinedwebmodel"): Policy(
        hf_ckpt.falcon_config_from_hf, hf_ckpt.load_falcon),
    ("opt",): Policy(hf_ckpt.opt_config_from_hf, hf_ckpt.load_opt),
    ("phi",): Policy(hf_ckpt.phi_config_from_hf, hf_ckpt.load_phi),
    ("phi3",): Policy(hf_ckpt.phi3_config_from_hf, hf_ckpt.load_phi3),
    ("bloom",): Policy(hf_ckpt.bloom_config_from_hf, hf_ckpt.load_bloom),
    ("gptj",): Policy(hf_ckpt.gptj_config_from_hf, hf_ckpt.load_gptj),
}


def replace_policy_for(model_type: str) -> Policy:
    """Resolve arch -> (config converter, weight loader)."""
    for model_types, policy in POLICIES.items():
        if model_type.lower() in model_types:
            return policy
    raise ValueError(
        f"no injection policy for architecture {model_type!r}; supported: "
        f"{sorted(t for types in POLICIES for t in types)}")
