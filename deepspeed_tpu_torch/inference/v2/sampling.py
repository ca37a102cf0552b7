"""Token sampling over per-sequence logits.

Counterpart of ``deepspeed_tpu/inference/v2/sampling.py``.  The filter
(temperature, top-k, top-p) is deterministic and matches the JAX one;
the categorical draw takes its randomness from an explicit
``torch.Generator``, so sampled tokens differ from ``jax.random``'s and
are compared by distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0        # 0 -> greedy
    top_k: int = 0                  # 0 -> disabled
    top_p: float = 1.0              # 1 -> disabled
    max_new_tokens: int = 128
    stop_token: Optional[int] = None


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax per row (first index on ties, like ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _filter_rows(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor):
    """Per-row temperature / top-k / top-p filter.  Returns (masked
    logits with -inf outside the support, greedy argmax, is_greedy)."""
    S, V = logits.shape
    greedy_tok = greedy(logits)
    is_greedy = temperature <= 0.0
    l = logits / torch.where(is_greedy, torch.ones_like(temperature),
                             temperature)[:, None]
    # top-k: the kth-largest value per row is the keep threshold
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=V),
                        torch.full_like(top_k, V)).long()
    kth = torch.gather(sorted_l, 1, (k_eff - 1)[:, None])
    l = torch.where(l < kth, -torch.inf, l)
    # top-p over the top-k-filtered distribution, from the same sort
    col = torch.arange(V, device=logits.device)[None, :]
    sorted_f = torch.where(col < k_eff[:, None], sorted_l, -torch.inf)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = torch.clamp(torch.sum(cum < top_p[:, None], dim=-1),
                             max=V - 1)
    cutoff = torch.gather(sorted_f, 1, cutoff_idx[:, None])
    l = torch.where((top_p < 1.0)[:, None] & (l < cutoff), -torch.inf, l)
    return l, greedy_tok, is_greedy


def sample_dynamic(logits: torch.Tensor, generator: torch.Generator,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic sampling: logits [S, V] + per-row params -> [S]
    int32.  Greedy rows (temperature <= 0) take the argmax; the others
    draw from the filtered distribution with ``generator``."""
    l, greedy_tok, is_greedy = _filter_rows(logits, temperature, top_k,
                                            top_p)
    probs = torch.softmax(l, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(is_greedy, greedy_tok, sampled.to(torch.int32))
