"""MoE gating (counterpart of ``deepspeed_tpu/moe/gating.py``; reference
``deepspeed/moe/sharded_moe.py``: ``TopKGate`` :385, ``top1gating``
:188, ``top2gating`` :301, capacity :160, aux loss).

Capacity is a Python int computed from the token count and the capacity
factor (optionally rounded up through capacity bins), so every shape is
static.  :func:`topk_routing` is the index form: for each of the k
choices, each token's expert, its slot in that expert's queue, whether
it fits the capacity, and its combine weight.  :func:`topk_gating`
builds the JAX package's dense ``[T, E, C]`` combine and dispatch
tensors from it.  Both take any leading batch dims (the JAX package
``vmap``s over groups).  Routing works on fp32 logits: the softmax, the
argmax (the first index of a tie, as ``jnp.argmax``) and the slots
(a token's second choice queues behind every first choice, reference
top2 ``locations2 += sum(mask1)``).

The gate noise policies (``RSample``, ``Jitter``) draw from
``jax.random`` during training; with a generator given they raise
``NotImplementedError`` (ROADMAP Queue 1 item 11h: MoE training).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class GateOutput(NamedTuple):
    l_aux: torch.Tensor            # load-balancing auxiliary loss
    combine_weights: torch.Tensor  # [..., T, E, C] float32
    dispatch_mask: torch.Tensor    # [..., T, E, C] bool
    exp_counts: torch.Tensor       # [..., E] tokens routed per expert (pre-drop)


class Routing(NamedTuple):
    """The index form of a gate: ``experts``, ``slots``, ``kept`` and
    ``weights`` are ``[k, ..., T]`` (choice i of every token)."""
    l_aux: torch.Tensor            # [...]
    experts: torch.Tensor          # int64 expert of choice i
    slots: torch.Tensor            # int64 position in that expert's queue
    kept: torch.Tensor             # bool: the slot is below the capacity
    weights: torch.Tensor          # fp32 combine weight (0 where dropped)
    exp_counts: torch.Tensor       # [..., E] int32
    capacity: int


def compute_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                     min_capacity: int = 4, top_k: int = 1,
                     capacity_bins: Optional[list] = None) -> int:
    """Static capacity (reference _capacity, sharded_moe.py:160)."""
    cap = math.ceil(num_tokens * top_k / num_experts * capacity_factor)
    cap = max(cap, min_capacity)
    if capacity_bins:
        for b in sorted(capacity_bins):
            if cap <= b:
                return b
        return max(capacity_bins)
    return cap


def topk_routing(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
                 min_capacity: int = 4, drop_tokens: bool = True,
                 noisy_gate_policy: Optional[str] = None,
                 rng: Optional[torch.Generator] = None,
                 capacity_bins: Optional[list] = None,
                 route_logits: Optional[torch.Tensor] = None) -> Routing:
    """Top-k routing of ``logits`` [..., T, E] with capacity dropping
    (no dropping with ``drop_tokens=False``: the capacity is then at
    least T).  Static shapes, no host synchronisation.  ``route_logits``
    (default ``logits``) are what the top-k reads, while the gate
    weights are always ``softmax(logits)``: JAX's ``route_logits``, which
    its noise policies perturb (``gating.py:84-89``); a comparison of two
    paths passes one path's choices here to route the other alike."""
    t, e = logits.shape[-2:]
    capacity = compute_capacity(t, e, capacity_factor, min_capacity, k,
                                capacity_bins)
    if not drop_tokens:
        capacity = max(capacity, t)  # nothing can overflow
    if noisy_gate_policy in ("RSample", "Jitter") and rng is not None:
        raise NotImplementedError(
            f"noisy_gate_policy={noisy_gate_policy!r}: the gate noise of "
            "MoE training is not ported yet (ROADMAP Queue 1 item 11h)")

    gates = torch.softmax(logits.float(), dim=-1)              # [..., T, E]
    experts, sel, masks = [], [], []
    remaining = (logits if route_logits is None else route_logits).float()
    for _ in range(k):
        idx = remaining.argmax(dim=-1)                         # [..., T]
        mask = F.one_hot(idx, e)                               # int64
        experts.append(idx)
        masks.append(mask)
        sel.append(torch.gather(gates, -1, idx[..., None])[..., 0])
        remaining = remaining.masked_fill(mask.bool(), float("-inf"))

    # aux loss from the top-1 assignment (reference top1gating l_aux)
    me = gates.mean(dim=-2)
    ce = masks[0].float().mean(dim=-2)
    l_aux = (me * ce).sum(dim=-1) * e
    exp_counts = sum(masks).sum(dim=-2).to(torch.int32)

    slots, kept = [], []
    offset = torch.zeros_like(masks[0][..., :1, :])            # [..., 1, E]
    for idx, mask in zip(experts, masks):
        pos = torch.cumsum(mask, dim=-2) - mask + offset       # [..., T, E]
        offset = offset + mask.sum(dim=-2, keepdim=True)
        slot = torch.gather(pos, -1, idx[..., None])[..., 0]
        slots.append(slot)
        kept.append(slot < capacity)
    weights = [torch.where(w, s, torch.zeros_like(s))
               for w, s in zip(kept, sel)]
    if k > 1:
        # renormalise over the kept choices (reference top2 denom)
        denom = sum(weights)
        weights = [torch.where(denom > 0,
                               w / torch.clamp(denom, min=1e-9),
                               torch.zeros_like(w)) for w in weights]
    return Routing(l_aux=l_aux, experts=torch.stack(experts),
                   slots=torch.stack(slots), kept=torch.stack(kept),
                   weights=torch.stack(weights), exp_counts=exp_counts,
                   capacity=capacity)


def topk_gating(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
                min_capacity: int = 4, drop_tokens: bool = True,
                noisy_gate_policy: Optional[str] = None,
                rng: Optional[torch.Generator] = None,
                capacity_bins: Optional[list] = None) -> GateOutput:
    """General top-k gating with capacity dropping: the JAX package's
    dense combine / dispatch tensors ``[..., T, E, C]`` (the GShard
    formulation), built from :func:`topk_routing`."""
    r = topk_routing(logits, k, capacity_factor, min_capacity, drop_tokens,
                     noisy_gate_policy, rng, capacity_bins)
    e, c = logits.shape[-1], r.capacity
    combine = torch.zeros(logits.shape + (c,), dtype=torch.float32,
                          device=logits.device)
    dispatch = torch.zeros(combine.shape, dtype=torch.bool,
                           device=logits.device)
    for i in range(k):
        slot = F.one_hot(torch.clamp(r.slots[i], 0, c - 1), c).bool()
        hit = (F.one_hot(r.experts[i], e).bool()[..., None]   # [..., T, E, C]
               & slot[..., None, :] & r.kept[i][..., None, None])
        combine = combine + torch.where(hit, r.weights[i][..., None, None],
                                        torch.zeros((), device=hit.device))
        dispatch = dispatch | hit
    return GateOutput(l_aux=r.l_aux, combine_weights=combine,
                      dispatch_mask=dispatch, exp_counts=r.exp_counts)


def top1_gating(logits, **kw) -> GateOutput:
    return topk_gating(logits, k=1, **kw)


def top2_gating(logits, **kw) -> GateOutput:
    return topk_gating(logits, k=2, **kw)
