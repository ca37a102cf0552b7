"""Optimizer factory: every name of the JAX package's.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:38-83``.  The JAX
engine builds an optax transform per name; the port builds the
``torch.optim.Optimizer`` that computes the same update:

* ``adam`` / ``adamw`` / ``fusedadam`` / ``cpuadam`` /
  ``deepspeedcpuadam`` -> :class:`FusedAdamW` (``optax.adamw``); an Adam
  name with ``adam_w_mode`` false -> :class:`AdamL2` (decayed weights
  added to the gradient, then ``scale_by_adam``, then the lr);
* ``lion`` / ``fusedlion`` / ``cpulion`` -> :class:`FusedLion`, and
  ``lamb`` / ``fusedlamb`` -> :class:`FusedLamb` (the fused kernels);
* ``adagrad`` / ``cpuadagrad`` -> :class:`Adagrad` (``optax.adagrad(lr,
  eps=eps)``: accumulators start at 0.1);
* ``sgd`` -> :class:`SGD` (``optax.sgd(lr, momentum or None)``: a trace
  ``t = g + momentum t``, not Nesterov);
* ``adafactor`` -> :class:`Adafactor` (``optax.adafactor(lr)``'s
  defaults: the two largest dims of a leaf factored when both are at
  least 128, decay ``1 - (k + 1) ** -0.8``, eps 1e-30, block-rms clipping
  at 1, the update scaled by the parameter's rms floored at 1e-3);
* ``muon`` -> :class:`Muon` (``optax.contrib.muon(lr)``: a leaf of
  exactly two dims takes Nesterov momentum 0.95 orthogonalised by five
  Newton-Schulz steps with coefficients (3.4445, -4.775, 2.0315) and
  scaled by ``sqrt(max(1, out / in))``; every other leaf, a stacked
  ``[L, ...]`` layer weight included, takes Nesterov AdamW with b1 0.9,
  b2 0.999, eps 1e-8 and no decay, as optax labels leaves by ``ndim``);
* ``onebitadam`` / ``zerooneadam`` / ``onebitlamb`` ->
  ``runtime/comm/compressed.py``.

Hyper-parameters come out as JAX's ``get_optimizer`` gives them: Lion's
``b2`` is ``betas[1]`` and it takes no eps; LAMB takes the config's eps;
Adafactor and Muon take the lr alone; ``bias_correction`` is read by
nothing.  The optimizers other than AdamW, Lion and LAMB are torch ops
on the parameter's device, as optax is plain XLA ops in JAX; each reads
fp32, computes in fp32 and rounds a bf16 parameter once.  Their state is
fp32 (``PortOptimizer``), but Adafactor's, which optax casts to the
parameter's dtype.  An unknown name raises JAX's ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_optimizer import FusedAdamW, FusedLamb, FusedLion, \
    PortOptimizer, bias_correction
from .comm.compressed import onebit_optimizer
from .config import OptimizerParams, optimizer_kind


def _moment(t: torch.Tensor, g: torch.Tensor, decay: float, order: int = 1
            ) -> torch.Tensor:
    """optax ``update_moment``: ``(1 - decay) * g ** order + decay * t``."""
    return (1 - decay) * (g if order == 1 else g * g) + decay * t


class SGD(PortOptimizer):
    """``optax.sgd(lr, momentum)``: state ``momentum_buffer`` (optax's
    ``trace``) when momentum is set."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum))
        self._moments = ("momentum_buffer",) if momentum else ()

    def _update(self, p, g, state, group):
        u = g.float()
        if group["momentum"]:
            u = u + group["momentum"] * state["momentum_buffer"].float()
            state["momentum_buffer"].copy_(u)
        p.copy_(p.float() - float(np.float32(group["lr"])) * u)


class Adagrad(PortOptimizer):
    """``optax.adagrad(lr, eps=eps)``: ``sum_of_squares`` from 0.1; the
    update ``g * rsqrt(sum + eps)`` where the sum is positive."""

    _moments = ("sum_of_squares",)

    def __init__(self, params, lr: float = 1e-3, eps: float = 1e-7,
                 initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(
            lr=lr, eps=eps,
            initial_accumulator_value=initial_accumulator_value))

    def _init_state(self, p, state):
        super()._init_state(p, state)
        state["sum_of_squares"].fill_(
            self.param_groups[0]["initial_accumulator_value"])

    def _update(self, p, g, state, group):
        G = g.float()
        acc = G * G + state["sum_of_squares"].float()
        state["sum_of_squares"].copy_(acc)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                          torch.zeros_like(acc))
        p.copy_(p.float() - float(np.float32(group["lr"])) * (inv * G))


class AdamL2(PortOptimizer):
    """Adam with coupled L2 decay (``adam_w_mode`` false): the chain
    ``add_decayed_weights(wd)``, ``scale_by_adam``, the lr."""

    _moments = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        P, G = p.float(), g.float()
        if group["weight_decay"]:
            G = G + group["weight_decay"] * P
        m = _moment(state["exp_avg"].float(), G, b1)
        v = _moment(state["exp_avg_sq"].float(), G, b2, 2)
        state["exp_avg"].copy_(m)
        state["exp_avg_sq"].copy_(v)
        k = state["step"]
        u = (m / bias_correction(b1, k)) / (
            torch.sqrt(v / bias_correction(b2, k)) + group["eps"])
        p.copy_(P - float(np.float32(group["lr"])) * u)


def factored_dims(shape: Tuple[int, ...], min_dim: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax ``_factored_dims``: the two largest dims (second, largest)
    by ``np.argsort`` when the second is at least ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _block_rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(PortOptimizer):
    """``optax.adafactor(lr)`` with its defaults.  State as optax keeps
    it: ``v_row`` / ``v_col`` (a factored leaf's row and column
    statistics, else one zero) and ``v`` (an unfactored leaf's, else one
    zero)."""

    def __init__(self, params, lr: float = 1e-3, decay_rate: float = 0.8,
                 eps: float = 1e-30, clipping_threshold: float = 1.0,
                 min_dim_size_to_factor: int = 128, min_scale: float = 1e-3):
        super().__init__(params, dict(
            lr=lr, decay_rate=decay_rate, eps=eps,
            clipping_threshold=clipping_threshold,
            min_dim_size_to_factor=min_dim_size_to_factor,
            min_scale=min_scale))

    def _init_state(self, p, state):
        state["step"] = 0
        dims = factored_dims(tuple(p.shape),
                             self.param_groups[0]["min_dim_size_to_factor"])
        one = torch.zeros(1, dtype=p.dtype, device=p.device)
        if dims is None:
            state.update(v_row=one, v_col=one.clone(),
                         v=torch.zeros_like(p))
        else:
            d1, d0 = dims
            shape = list(p.shape)
            state.update(
                v_row=torch.zeros(shape[:d0] + shape[d0 + 1:], dtype=p.dtype,
                                  device=p.device),
                v_col=torch.zeros(shape[:d1] + shape[d1 + 1:], dtype=p.dtype,
                                  device=p.device),
                v=one)

    def _update(self, p, g, state, group):
        G, P = g.float(), p.float()
        k = state["step"] - 1              # optax's count before the update
        decay = float(np.float32(1) - np.float32(k + 1) ** np.float32(
            -group["decay_rate"]))
        sq = G * G + group["eps"]
        dims = factored_dims(tuple(p.shape), group["min_dim_size_to_factor"])
        if dims is not None:
            d1, d0 = dims
            row = decay * state["v_row"].float() + (1 - decay) * sq.mean(d0)
            col = decay * state["v_col"].float() + (1 - decay) * sq.mean(d1)
            state["v_row"].copy_(row)
            state["v_col"].copy_(col)
            row, col = state["v_row"].float(), state["v_col"].float()
            rd1 = d1 - 1 if d1 > d0 else d1
            row_factor = (row / row.mean(rd1, keepdim=True)) ** -0.5
            u = G * row_factor.unsqueeze(d0) * (col ** -0.5).unsqueeze(d1)
        else:
            v = decay * state["v"].float() + (1 - decay) * sq
            state["v"].copy_(v)
            u = G * state["v"].float() ** -0.5
        u = u / torch.clamp(_block_rms(u) / group["clipping_threshold"],
                            min=1.0)
        u = u * float(np.float32(group["lr"]))
        rms = _block_rms(P)
        scale = torch.where(rms <= group["min_scale"],
                            torch.full_like(rms, group["min_scale"]), rms)
        p.copy_(P - u * scale)


#: optax.contrib.muon's Newton-Schulz coefficients (its ``ns_coeffs``)
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(x: torch.Tensor, steps: int = 5, eps: float = 1e-8,
                  coeffs: Tuple[float, float, float] = NS_COEFFS
                  ) -> torch.Tensor:
    """optax ``orthogonalize_via_newton_schulz`` of a 2-D fp32 matrix
    (reduction axis 0, output axis 1): the wider orientation, scaled to
    a Frobenius norm of 1, then ``x = a x + (b A + c A A) x`` with
    ``A = x x^T``."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    a, b, c = (float(np.float32(v)) for v in coeffs)
    for _ in range(steps):
        A = x @ x.T
        B = b * A + c * (A @ A)
        x = a * x + B @ x
    return x.T if transposed else x


class Muon(PortOptimizer):
    """``optax.contrib.muon(lr)``: Muon on leaves of exactly two dims
    (state ``exp_avg``), Nesterov AdamW on the rest (``exp_avg``,
    ``exp_avg_sq``)."""

    def __init__(self, params, lr: float = 1e-3, beta: float = 0.95,
                 ns_steps: int = 5, eps: float = 1e-8,
                 adam_betas: Tuple[float, float] = (0.9, 0.999)):
        super().__init__(params, dict(lr=lr, beta=beta, ns_steps=ns_steps,
                                      eps=eps, adam_betas=adam_betas))

    def _init_state(self, p, state):
        state["step"] = 0
        state["exp_avg"] = torch.zeros(p.shape, device=p.device)
        if p.dim() != 2:
            state["exp_avg_sq"] = torch.zeros(p.shape, device=p.device)

    def _update(self, p, g, state, group):
        G, P = g.float(), p.float()
        k = state["step"]                  # optax's count after the update
        lr = float(np.float32(group["lr"]))
        if p.dim() == 2:
            b = group["beta"]
            m = _moment(state["exp_avg"].float(), G, b)
            state["exp_avg"].copy_(m)
            m_hat = (b * (m / bias_correction(b, k + 1))
                     + (1 - b) * (G / bias_correction(b, k)))
            u = newton_schulz(m_hat, group["ns_steps"], group["eps"])
            u = u * math.sqrt(max(1.0, p.shape[1] / p.shape[0]))
        else:
            b1, b2 = group["adam_betas"]
            m = _moment(state["exp_avg"].float(), G, b1)
            v = _moment(state["exp_avg_sq"].float(), G, b2, 2)
            state["exp_avg"].copy_(m)
            state["exp_avg_sq"].copy_(v)
            m_hat = (b1 * (m / bias_correction(b1, k + 1))
                     + (1 - b1) * (G / bias_correction(b1, k)))
            u = m_hat / (torch.sqrt(v / bias_correction(b2, k))
                         + group["eps"])
        p.copy_(P - lr * u)


def get_optimizer(name: str, params_cfg: OptimizerParams,
                  params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The optimizer for a DeepSpeed optimizer name over ``params``."""
    kind = optimizer_kind(name, params_cfg.adam_w_mode, params_cfg.momentum)
    betas = tuple(params_cfg.betas)
    lr, eps, wd = params_cfg.lr, params_cfg.eps, params_cfg.weight_decay
    if kind == "lion":
        # JAX optimizers.py:65-66: a missing beta takes Lion's own default
        b1 = betas[0] if betas else 0.9
        b2 = betas[1] if len(betas) > 1 else 0.99
        return FusedLion(params, lr=lr, betas=(b1, b2), weight_decay=wd)
    if kind in ("adamw", "lamb"):
        cls = FusedLamb if kind == "lamb" else FusedAdamW
        return cls(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if kind == "adam_l2":
        return AdamL2(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if kind == "adagrad":
        return Adagrad(params, lr=lr, eps=eps)
    if kind in ("sgd", "sgd_momentum"):
        return SGD(params, lr=lr, momentum=params_cfg.momentum)
    if kind == "adafactor":
        return Adafactor(params, lr=lr)
    if kind == "muon":
        return Muon(params, lr=lr)
    return onebit_optimizer(name, params, lr, betas=betas, eps=eps,
                            weight_decay=wd)
