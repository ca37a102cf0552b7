"""Hugging Face config translation (counterpart of the ``*_config_from_hf``
functions of ``deepspeed_tpu/checkpoint/hf.py``).

Only the OPT config translation is here.  It reads attributes off any
object (a ``transformers`` config, or a ``types.SimpleNamespace`` holding
a published ``config.json``'s values) and imports no ``transformers``; the
state-dict loaders are not ported yet.
"""

from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig

def _map_hf_act(name: str) -> str:
    """HF activation name -> core activation.  HF's "gelu" is exact erf;
    the tanh approximation goes by gelu_new/gelu_fast/gelu_pytorch_tanh."""
    table = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_fast": "gelu",
             "gelu_pytorch_tanh": "gelu", "relu": "relu"}
    try:
        return table[name]
    except KeyError:
        raise ValueError(f"unsupported HF activation {name!r} "
                         f"(supported: {sorted(table)})") from None


def opt_config_from_hf(hf_cfg) -> TransformerConfig:
    """OPT: learned positions (the HF +2 offset is folded into the table
    when weights are loaded), pre-LN decoder, relu MLP, biases
    everywhere."""
    if getattr(hf_cfg, "word_embed_proj_dim",
               hf_cfg.hidden_size) != hf_cfg.hidden_size:
        raise ValueError("OPT word_embed_proj_dim != hidden_size "
                         "(opt-350m style projections) not supported")
    if not getattr(hf_cfg, "do_layer_norm_before", True):
        raise ValueError("OPT post-layernorm variants not supported")
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.ffn_dim,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_attention_heads,
        max_seq_len=hf_cfg.max_position_embeddings,
        norm="layernorm", norm_eps=1e-5,
        activation=_map_hf_act(hf_cfg.activation_function),
        pos_emb="learned",
        tie_embeddings=getattr(hf_cfg, "tie_word_embeddings", True),
        use_bias=True, dtype=torch.bfloat16)
