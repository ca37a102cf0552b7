"""1-bit Adam, 1-bit LAMB and 0/1 Adam as a numerics transform.

Counterpart of ``deepspeed_tpu/runtime/comm/compressed.py``
(``_sign_compress`` :38, ``onebit_adam`` :50, ``onebit_optimizer``
:103).  On one rank the compressed all-reduce carries nothing, so what
remains is the arithmetic: Adam for ``freeze_step`` warm-up updates,
then the variance frozen and the momentum replaced by its 1-bit
compression ``sign(x) * mean(|x|)`` of ``x = m + error`` per tensor, the
residual kept as the next update's error feedback.

The JAX transform reads its learning rate at the 1-based count after
the increment (``learning_rate(count)``), one update later than optax's
``scale_by_learning_rate``; the engine honours that through
:attr:`OneBitAdam.lr_count_offset`.  ``get_optimizer`` passes no
``freeze_step`` in JAX, so the engine's is 100; these classes take it
as JAX's function does.  1-bit LAMB runs the same update at lr 1 and
scales it by ``||p|| / ||u|| * lr`` (1 where either norm is 0).
Weight decay ``wd * p`` joins the step when ``wd > 0``.

The arithmetic is fp32 over each tensor (a bf16 parameter is read as
fp32 and rounded once); the state is ``step`` (optax's ``count``),
``exp_avg`` (``mu``), ``exp_avg_sq`` (``nu``) and ``error``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ...ops.fused_optimizer import PortOptimizer, bias_correction


def _sign_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit compression of one tensor: ``sign(x) * mean(|x|)`` and the
    residual ``x - q`` (the error feedback)."""
    q = torch.sign(x) * x.abs().mean()
    return q, x - q


class OneBitAdam(PortOptimizer):
    """1-bit Adam (and 0/1 Adam, the same transform in JAX)."""

    _moments = ("exp_avg", "exp_avg_sq", "error")
    lr_count_offset = 1
    trust_ratio = False

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      freeze_step=int(freeze_step)))

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        count, freeze = state["step"], group["freeze_step"]
        G, P = g.float(), p.float()
        m = (1 - b1) * G + b1 * state["exp_avg"].float()
        warmup = count <= freeze
        if warmup:
            nu = (1 - b2) * G * G + b2 * state["exp_avg_sq"].float()
            state["exp_avg_sq"].copy_(nu)
        else:
            nu = state["exp_avg_sq"].float()
            m, err = _sign_compress(m + state["error"].float())
            state["error"].copy_(err)
        state["exp_avg"].copy_(m)
        bc1 = bias_correction(b1, count)
        bc2 = bias_correction(b2, min(count, freeze))
        step = (m / bc1) / (torch.sqrt(nu / bc2) + float(np.float32(
            group["eps"])))
        wd = group["weight_decay"]
        if wd > 0:
            step = step + float(np.float32(wd)) * P
        lr = float(np.float32(group["lr"]))
        if self.trust_ratio:
            u = -step
            un, pn = torch.linalg.vector_norm(u), torch.linalg.vector_norm(P)
            ratio = torch.where((un > 0) & (pn > 0), pn / un,
                                torch.ones_like(un))
            p.copy_(P + u * ratio * lr)
        else:
            p.copy_(P + (-lr) * step)


class OneBitLamb(OneBitAdam):
    """1-bit LAMB: the 1-bit Adam step at lr 1, scaled per tensor by the
    trust ratio and the lr."""

    trust_ratio = True


def onebit_optimizer(name: str, params: Iterable[torch.Tensor], lr: float,
                     betas: Tuple[float, float] = (0.9, 0.999),
                     eps: float = 1e-8, weight_decay: float = 0.0,
                     freeze_step: int = 100) -> OneBitAdam:
    """The 1-bit optimizer for a DeepSpeed name (JAX
    ``onebit_optimizer``)."""
    name = name.lower().replace("_", "")
    if name in ("onebitadam", "zerooneadam"):
        cls = OneBitAdam
    elif name == "onebitlamb":
        cls = OneBitLamb
    else:
        raise ValueError(f"unknown 1-bit optimizer {name}")
    return cls(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
               freeze_step=freeze_step)
