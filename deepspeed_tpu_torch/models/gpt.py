"""GPT-2/GPT-3-style family presets (counterpart of
``deepspeed_tpu/models/gpt.py``): LayerNorm, learned positions, tanh
gelu, tied embeddings, biases everywhere."""

from __future__ import annotations

import torch

from .transformer import CausalLM, TransformerConfig


def gpt_config(size: str = "1.3b", **overrides) -> TransformerConfig:
    presets = {
        "125m": dict(vocab_size=50257, hidden_size=768, intermediate_size=3072,
                     num_layers=12, num_heads=12, max_seq_len=1024),
        "350m": dict(vocab_size=50257, hidden_size=1024, intermediate_size=4096,
                     num_layers=24, num_heads=16, max_seq_len=1024),
        "1.3b": dict(vocab_size=50257, hidden_size=2048, intermediate_size=8192,
                     num_layers=24, num_heads=16, max_seq_len=2048),
        "2.7b": dict(vocab_size=50257, hidden_size=2560, intermediate_size=10240,
                     num_layers=32, num_heads=32, max_seq_len=2048),
        "debug": dict(vocab_size=128, hidden_size=64, intermediate_size=256,
                      num_layers=2, num_heads=4, max_seq_len=64),
    }
    base = dict(norm="layernorm", norm_eps=1e-5, activation="gelu",
                pos_emb="learned", causal=True, tie_embeddings=True,
                use_bias=True, dtype=torch.bfloat16)
    base.update(presets[size])
    base.update(overrides)
    return TransformerConfig(**base)


class GPTForCausalLM(CausalLM):
    """Engine-protocol GPT (JAX ``models/gpt.py:31``).  Serving runs these
    families; the training forward raises for learned positions until the
    LayerNorm families are ported there."""

    def __init__(self, size: str = "1.3b", **overrides):
        super().__init__(gpt_config(size, **overrides))
