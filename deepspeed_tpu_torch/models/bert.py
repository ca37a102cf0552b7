"""BERT family: a bidirectional encoder with the masked-LM head (counterpart
of ``deepspeed_tpu/models/bert.py``; BASELINE config #1).

Non-causal attention with a padding mask never takes the flash path: the
training forward runs the dense einsum attention, on the card as in JAX.
"""

from __future__ import annotations

import torch

from ..accelerator import DeviceLike
from .transformer import (TransformerConfig, cross_entropy_loss, forward,
                          init_params)


def bert_config(size: str = "base", **overrides) -> TransformerConfig:
    presets = {
        "base": dict(vocab_size=30522, hidden_size=768, intermediate_size=3072,
                     num_layers=12, num_heads=12, max_seq_len=512),
        "large": dict(vocab_size=30522, hidden_size=1024, intermediate_size=4096,
                      num_layers=24, num_heads=16, max_seq_len=512),
        "debug": dict(vocab_size=128, hidden_size=64, intermediate_size=256,
                      num_layers=2, num_heads=4, max_seq_len=64),
    }
    base = dict(norm="layernorm", norm_eps=1e-12, activation="gelu",
                pos_emb="learned", causal=False, tie_embeddings=True,
                use_bias=True, dtype=torch.bfloat16)
    base.update(presets[size])
    base.update(overrides)
    return TransformerConfig(**base)


class BertForMaskedLM:
    """Engine-protocol masked LM (JAX ``models/bert.py:35``).  Batch:
    ``input_ids``, ``labels`` (-100 or -1 at the positions that are not
    masked; -100 is the Hugging Face convention) and an optional
    ``attention_mask``."""

    def __init__(self, size: str = "base", **overrides):
        self.cfg = bert_config(size, **overrides)

    def init_params(self, seed: int = 0, device: DeviceLike = None):
        """fp32 weights, as the JAX initializer draws them (the masters)."""
        return init_params(self.cfg, seed, device, dtype=torch.float32)

    def logits(self, params, batch) -> torch.Tensor:
        return forward(self.cfg, params, batch["input_ids"],
                       attention_mask=batch.get("attention_mask"))

    def loss(self, params, batch) -> torch.Tensor:
        logits = self.logits(params, batch)
        labels = batch["labels"]
        labels = torch.where(labels == -100, -1, labels)
        return cross_entropy_loss(logits, labels, batch.get("attention_mask"))
