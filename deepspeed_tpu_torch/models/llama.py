"""LLaMA family presets (counterpart of ``deepspeed_tpu/models/llama.py``)."""

from __future__ import annotations

import torch

from .transformer import CausalLM, TransformerConfig


def llama_config(size: str = "7b", **overrides) -> TransformerConfig:
    presets = {
        # Llama-2 family
        "7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                   num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=4096),
        "13b": dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                    num_layers=40, num_heads=40, num_kv_heads=40, max_seq_len=4096),
        "70b": dict(vocab_size=32000, hidden_size=8192, intermediate_size=28672,
                    num_layers=80, num_heads=64, num_kv_heads=8, max_seq_len=4096),
        # small configs for tests / benches
        "1b": dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                   num_layers=16, num_heads=16, num_kv_heads=16, max_seq_len=2048),
        "2b": dict(vocab_size=32000, hidden_size=2560, intermediate_size=6912,
                   num_layers=24, num_heads=20, num_kv_heads=20, max_seq_len=2048),
        "tiny": dict(vocab_size=512, hidden_size=128, intermediate_size=352,
                     num_layers=4, num_heads=4, num_kv_heads=2, max_seq_len=256),
        "debug": dict(vocab_size=128, hidden_size=64, intermediate_size=176,
                      num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=64),
    }
    base = dict(norm="rmsnorm", norm_eps=1e-5, activation="silu_gated",
                pos_emb="rope", causal=True, tie_embeddings=False,
                use_bias=False, dtype=torch.bfloat16)
    base.update(presets[size])
    base.update(overrides)
    return TransformerConfig(**base)


class LlamaForCausalLM(CausalLM):
    """Engine-protocol Llama (JAX ``models/llama.py:40``)."""

    def __init__(self, size: str = "7b", **overrides):
        super().__init__(llama_config(size, **overrides))
