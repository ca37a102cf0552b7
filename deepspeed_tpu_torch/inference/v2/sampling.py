"""Token sampling over per-sequence logits.

Counterpart of ``deepspeed_tpu/inference/v2/sampling.py``.  The filter
(temperature, top-k, top-p) is deterministic and matches the JAX one.
Two draws take it: keyed sampling (:func:`sample_keyed`) draws each row
from its own key, a function of (base key, request uid, generation
position) computed with the port's copy of ``jax.random``
(``threefry.py``), so its tokens equal the JAX package's; otherwise the
categorical draw takes its randomness from an explicit
``torch.Generator``, so sampled tokens differ from ``jax.random``'s and
are compared by distribution only.  :func:`sample_dynamic` takes
per-row parameters (the fused step); :func:`sample` one set for all rows
(the split path, one call per group, on the logits' device).  The draw
is ``torch.multinomial``'s own one-sample path written out (exponential
noise, argmax of p / q): the same numbers from the same generator,
without the host checks that ``multinomial`` syncs on, so a CUDA graph
can capture it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import threefry


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
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    sampled = torch.argmax(probs / q, dim=-1)
    return torch.where(is_greedy, greedy_tok, sampled.to(torch.int32))


def derive_row_keys(base: torch.Tensor, row_uids: torch.Tensor,
                    row_pos: torch.Tensor) -> torch.Tensor:
    """The key of each row's draw, ``fold_in(fold_in(base, uid), pos)``:
    a pure function of (base key, request uid, generation position), so
    a request draws the same token stream whatever step, batch or engine
    samples it.  ``base`` is an int64 [2] key (never split); ``row_uids``
    and ``row_pos`` are [S] int32.  Returns the [S, 2] keys."""
    return threefry.fold_in(threefry.fold_in(base, row_uids), row_pos)


def sample_keyed(logits: torch.Tensor, row_keys: torch.Tensor,
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor) -> torch.Tensor:
    """:func:`sample_dynamic` with one key per row (``row_keys`` [S, 2]
    from :func:`derive_row_keys`): the same filter, and each sampled row
    drawn as ``jax.random.categorical(key, row)`` draws it.  The logits
    must be fp32, as the JAX draw's are."""
    l, greedy_tok, is_greedy = _filter_rows(logits, temperature, top_k,
                                            top_p)
    sampled = threefry.categorical(row_keys, l)
    return torch.where(is_greedy, greedy_tok, sampled.to(torch.int32))


def sample(logits: torch.Tensor, generator: torch.Generator, *,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits [S, V] -> token ids [S] int32, every row with the same
    parameters.  Temperature 0 is the argmax and draws nothing; else one
    draw from ``generator`` for the whole call."""
    if temperature <= 0.0:
        return greedy(logits)
    S = logits.shape[0]

    def row(v, dtype):
        return torch.full((S,), v, dtype=dtype, device=logits.device)

    return sample_dynamic(logits, generator, row(temperature, torch.float32),
                          row(top_k, torch.int32), row(top_p, torch.float32))
