"""MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``; reference
``deepspeed/moe/layer.py:19`` ``MoE``, ``sharded_moe.py:521``
``MOELayer``, ``experts.py:13`` ``Experts``).

The function is the JAX package's grouped GShard layer: tokens keep
their leading dims as the group dim G (one routing problem per group,
capacity per group), the router logits are computed in the model dtype
(``einsum`` in ``dtype``, JAX ``layer.py:127``), and each token's output
is its kept choices' expert outputs weighted by the renormalised gate.
Where JAX multiplies by one-hot ``[G, S, E, C]`` dispatch and combine
tensors, this module moves rows by index, with the same results:

1. each token row is scattered into its ``[G, E, C]`` slot (the slots
   :func:`~.gating.topk_routing` gives; a dropped choice goes to a spare
   row that nothing reads);
2. the experts run as batched products over ``[E, G * C, D]`` with the
   stacked weights ``wi``, ``wg`` ``[E, D, F]`` and ``wo`` ``[E, F, D]``
   (``torch.bmm``: plain products, as JAX leaves them to XLA), each
   weight dequantised just before its product when it is a channelwise
   quantised leaf;
3. each token gathers its k slots and sums them, weighted by the
   combine weights cast to the model dtype, in fp32, rounded once.

Every shape is static and nothing synchronises with the host, so a
serving step that runs it is captured as one CUDA graph.  The experts
compute ``E * C`` rows a group whatever the routing (``C >= S`` in
serving, where nothing is dropped): JAX's design, four times top-2's
rows.  Expert parallelism (the all-to-alls the JAX package gets from its
sharding constraints) is not ported (ROADMAP Queue 1 item 11h).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..accelerator import DeviceLike, resolve_device
from ..models.transformer import _activation, _wval
from .capacity_bins import build_capacity_bins
from .gating import topk_routing


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    drop_tokens: bool = True
    noisy_gate_policy: Optional[str] = None
    use_residual: bool = False       # PR-MoE residual expert
    aux_loss_coef: float = 0.01
    num_capacity_bins: int = 0
    capacity_bins_exp_base: float = 2.0
    activation: str = "silu_gated"


def init_moe_params(cfg: MoEConfig, hidden: int, ffn: int,
                    generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """One layer's MoE leaves (JAX ``init_moe_params``'s shapes and
    scales: normal * fan_in ** -0.5), drawn from ``generator``, which
    must live on ``device``.  The draws differ from ``jax.random``'s."""
    dev = resolve_device(device)
    e = cfg.num_experts

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return w.mul_(fan_in ** -0.5)

    p = {"gate": dense((hidden, e), hidden),
         "wi": dense((e, hidden, ffn), hidden),
         "wo": dense((e, ffn, hidden), ffn)}
    if "gated" in cfg.activation:
        p["wg"] = dense((e, hidden, ffn), hidden)
    if cfg.use_residual:
        p["res_wi"] = dense((hidden, ffn), hidden)
        p["res_wo"] = dense((ffn, hidden), ffn)
        p["res_coef"] = dense((hidden, 2), hidden)
    return p


def moe_forward(cfg: MoEConfig, params, x: torch.Tensor,
                rng: Optional[torch.Generator] = None,
                is_training: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., D] -> (out [..., D], aux_loss scalar).  With three or
    more dims the leading ones are the groups and dim -2 the tokens of a
    group; a 2-D x is one group."""
    orig_shape = x.shape
    d = x.shape[-1]
    if x.dim() >= 3:
        g, s = math.prod(x.shape[:-2]), x.shape[-2]
    else:
        g, s = 1, x.shape[0]
    xg = x.reshape(g, s, d)
    dtype = x.dtype

    logits = xg @ params["gate"].to(dtype)                     # [G, S, E]
    bins = (build_capacity_bins(cfg, s) if cfg.num_capacity_bins > 0
            else None)
    r = topk_routing(
        logits, cfg.top_k,
        capacity_factor=(cfg.capacity_factor if is_training
                         else cfg.eval_capacity_factor),
        min_capacity=cfg.min_capacity, drop_tokens=cfg.drop_tokens,
        noisy_gate_policy=cfg.noisy_gate_policy if is_training else None,
        rng=rng, capacity_bins=bins)
    e, c = cfg.num_experts, r.capacity

    # 1. token rows into [G, E * C] slots; a dropped choice goes to the
    # spare row E * C
    rows = torch.where(r.kept, r.experts * c + r.slots,
                       torch.full_like(r.slots, e * c))       # [k, G, S]
    slots = xg.new_zeros((g, e * c + 1, d))
    for i in range(cfg.top_k):
        slots.scatter_(1, rows[i][..., None].expand(g, s, d), xg)
    dispatched = slots[:, :e * c].reshape(g, e, c, d).transpose(0, 1) \
        .reshape(e, g * c, d)

    # 2. the experts, one leaf dequantised at a time
    up = torch.bmm(dispatched, _wval(params["wi"], dtype))     # [E, GC, F]
    gate_h = (torch.bmm(dispatched, _wval(params["wg"], dtype))
              if "wg" in params else None)
    h = _activation(cfg, gate_h if "gated" in cfg.activation else None, up)
    del up, gate_h        # [E, GC, F] each: gone before the down product
    y = torch.bmm(h, _wval(params["wo"], dtype))               # [E, GC, D]
    y = y.reshape(e, g, c, d).transpose(0, 1).reshape(g, e * c, d)
    y = torch.cat([y, y.new_zeros((g, 1, d))], dim=1)

    # 3. each token's kept choices, weighted
    out = torch.zeros((g, s, d), dtype=torch.float32, device=x.device)
    for i in range(cfg.top_k):
        picked = torch.gather(y, 1, rows[i][..., None].expand(g, s, d))
        w = r.weights[i].to(dtype).float()[..., None]
        out = out + w * picked.float()
    out = out.to(dtype)

    if cfg.use_residual:
        # PR-MoE (reference moe/layer.py use_residual): dense FFN branch
        # (non-gated) mixed via a learned 2-way coefficient
        res_h = F.silu(xg @ params["res_wi"].to(dtype))
        res = res_h @ params["res_wo"].to(dtype)
        coef = torch.softmax(xg @ params["res_coef"].to(dtype), dim=-1)
        out = out * coef[..., :1] + res * coef[..., 1:]

    l_aux = r.l_aux.mean() * cfg.aux_loss_coef
    return out.reshape(orig_shape), l_aux


class MoE:
    """Standalone MoE module (reference ``deepspeed.moe.layer.MoE``)."""

    def __init__(self, hidden_size: int, ffn_size: int, cfg: MoEConfig):
        self.hidden = hidden_size
        self.ffn = ffn_size
        self.cfg = cfg

    def init_params(self, seed: int = 0, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_moe_params(self.cfg, self.hidden, self.ffn, gen, dtype,
                               dev)

    def __call__(self, params, x, rng=None, is_training=True):
        return moe_forward(self.cfg, params, x, rng, is_training)
