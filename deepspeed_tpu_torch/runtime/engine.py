"""Training engine for the port's one-GPU slice.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``__init__`` :141,
``_init_state`` :497, the train step :613-829, ``_shape_batch`` :930,
``train_batch`` :1094, ``forward`` / ``backward`` / ``step`` :1276-1340,
``eval_batch`` :1341).  The JAX engine compiles the whole step into one
program; this one runs it eagerly, with the same numbers:

1. each step casts the fp32 masters to the compute dtype once (bf16, or
   fp32 with ``"bf16": {"enabled": false}``) and takes gradients with
   respect to that copy; with ZeRO++ quantised weights (stage 3 and
   ``zero_quantized_weights``) every leaf of two or more dimensions is
   first snapped to the blockwise int8 grid (the quantise and dequantise
   kernels, straight into the compute dtype; JAX ``engine.py:641-653``),
   and its gradient passes straight through;
2. each micro-batch's gradient is cast to fp32 and summed into a
   per-master accumulator, which is scaled by ``1 / gas`` at the step;
3. the global norm is taken over every accumulator and, with
   ``gradient_clipping`` c > 0, every one is scaled by
   ``min(1, c / (norm + 1e-6))``;
4. update k (0-based) applies the optimizer (AdamW, Lion or LAMB, each a
   fused kernel) at lr ``schedule(k)``;
5. ``train_batch`` reports the mean of the micro-batch losses.

The accumulators are the masters' ``.grad``, so :attr:`optimizer` is a
plain ``torch.optim.Optimizer`` over the masters.  ZeRO stages 1-3 run
on one rank, where the partition is the identity: they change no
number.  Features outside the slice raise ``NotImplementedError`` from
the config loader or here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..models.base import Model
from ..ops.quantization import quantize_dequantize
from ..tree import tree_leaves, tree_map
from .config import TrainingConfig, load_config, outside_slice
from .lr_schedules import LRScheduler, get_lr_schedule
from .optimizers import get_optimizer


class DeepSpeedEngine:
    """Eager training engine.

    ``model`` follows :class:`~..models.base.Model`.  ``model_parameters``
    (a tree of floating tensors, e.g. a JAX tree bridged by
    ``checkpoint/from_jax.py``) seeds the masters; without it the engine
    calls ``model.init_params(0, device)``.  ``device`` None means the
    GPU and raises without one; ``"cpu"`` runs every kernel's plain
    version."""

    def __init__(self, model: Model, config: Any = None,
                 model_parameters: Optional[Dict[str, Any]] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 device: DeviceLike = None):
        self.config: TrainingConfig = load_config(config)
        self.config.resolve_batch_sizes()
        self.device = resolve_device(device)
        if not isinstance(model, Model):
            raise TypeError("model must define init_params(seed, device) "
                            "and loss(params, batch)")
        self.module = model
        self.compute_dtype = (torch.bfloat16 if self.config.bf16
                              else torch.float32)

        if model_parameters is None:
            tree, copy = model.init_params(0, self.device), False
        else:
            # the engine updates its masters in place: never the caller's
            tree, copy = model_parameters, True

        def master(t):
            if not isinstance(t, torch.Tensor) or not t.is_floating_point():
                raise TypeError(f"parameters must be floating tensors, got "
                                f"{type(t).__name__}")
            return t.detach().to(self.device, torch.float32, copy=copy)
        #: fp32 master weights, in the model's tree layout
        self.params = tree_map(master, tree)
        self._masters = tree_leaves(self.params)
        for p in self._masters:
            # the fp32 gradient accumulator (JAX engine.py:683-688)
            p.grad = torch.zeros_like(p)

        opt = self.config.optimizer
        base_lr = opt.params.lr
        if self.config.scheduler is not None:
            self._schedule = get_lr_schedule(self.config.scheduler.type,
                                             self.config.scheduler.params,
                                             base_lr)
        elif callable(lr_scheduler):
            self._schedule = lr_scheduler
        else:
            self._schedule = lambda step: base_lr
        self.lr_scheduler = LRScheduler(self._schedule)
        self.optimizer = get_optimizer(opt.type, opt.params, self._masters)

        self._params_c: Optional[Dict[str, Any]] = None
        self._pending = 0          # micro-batches accumulated this step
        self.global_steps = 0
        self.micro_steps = 0
        self.global_samples = 0
        self._last_grad_norm = 0.0

    # ------------------------------------------------------------------
    # accessors (JAX engine.py:902-925)
    # ------------------------------------------------------------------
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def get_lr(self) -> List[float]:
        return [float(self._schedule(self.global_steps))]

    def get_global_grad_norm(self) -> float:
        return self._last_grad_norm

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._pending >= self.gradient_accumulation_steps()

    # ------------------------------------------------------------------
    # one step, in three calls
    # ------------------------------------------------------------------
    def _compute_params(self) -> Dict[str, Any]:
        """This step's compute-dtype copy of the masters, made once per
        step; gradients are taken with respect to it.  In fp32 a leaf's
        copy shares the master's storage (nothing changes it until the
        update, after the last backward), except under qwZ, where every
        leaf of two or more dimensions is a new, quantised tensor: its
        blocks run over the leaf's flat layout as the tree holds it
        (stacked ``[L, ...]`` leaves whole, norm scales included)."""
        if self._params_c is None:
            qwz = self.config.quantized_weights

            def cast(p):
                if qwz and p.dim() >= 2:
                    c = quantize_dequantize(p.detach(),
                                            dtype=self.compute_dtype)
                else:
                    c = p.detach().to(self.compute_dtype)
                return c.requires_grad_()
            self._params_c = tree_map(cast, self.params)
        return self._params_c

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The loss of one micro-batch under the current masters, with
        its autograd graph (pass it to :meth:`backward`)."""
        return self.module.loss(self._compute_params(),
                                self._to_device(batch))

    __call__ = forward

    def backward(self, loss: torch.Tensor) -> None:
        """Backpropagate one micro-batch's loss and add its gradient, in
        fp32, to the accumulators."""
        if self._params_c is None:
            raise RuntimeError("backward() needs the loss of a forward() "
                               "of this step")
        loss.backward()
        first = self._pending == 0
        for p, c in zip(self._masters, tree_leaves(self._params_c)):
            if c.grad is None:          # a leaf the loss does not use
                if first:
                    p.grad.zero_()
            elif first:
                p.grad.copy_(c.grad)
            else:
                p.grad.add_(c.grad)
            c.grad = None
        self._pending += 1
        self.micro_steps += 1

    def step(self) -> None:
        """At the gradient-accumulation boundary: average, clip and apply
        the update; before it, do nothing (JAX ``step`` semantics)."""
        if not self.is_gradient_accumulation_boundary():
            return
        grads = [p.grad for p in self._masters]
        inv = 1.0 / self._pending
        for g in grads:
            g.mul_(inv)
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        clip = self.config.gradient_clipping
        if clip > 0:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        lr = self._schedule(self.global_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self._params_c = None
        self._pending = 0
        self._last_grad_norm = float(gnorm)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self.lr_scheduler.step()

    # ------------------------------------------------------------------
    # whole batches
    # ------------------------------------------------------------------
    def _micro_batches(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        """A global batch, [gas * micro, ...] or [gas, micro, ...] per
        leaf, -> gas micro-batch dicts (JAX ``_shape_batch``)."""
        gas = self.gradient_accumulation_steps()
        micro = self.train_micro_batch_size_per_gpu()
        shaped = {}
        for k, x in batch.items():
            x = x if isinstance(x, torch.Tensor) else np.asarray(x)
            if x.shape[0] == gas * micro:
                x = x.reshape((gas, micro) + tuple(x.shape[1:]))
            elif not (x.ndim >= 2 and tuple(x.shape[:2]) == (gas, micro)):
                raise ValueError(f"batch leaf {k!r} of shape "
                                 f"{tuple(x.shape)} does not split into "
                                 f"gas={gas} x micro={micro}")
            shaped[k] = x
        return [{k: x[i] for k, x in shaped.items()} for i in range(gas)]

    def train_batch(self, batch: Optional[Dict[str, Any]] = None,
                    data_iter=None) -> float:
        """gas micro-batches of forward and backward, then the update;
        returns the mean micro-batch loss."""
        if batch is None or data_iter is not None:
            raise outside_slice("train_batch from a data iterator",
                                "11i (dataloaders)")
        if self._pending:
            raise RuntimeError("micro-batches from forward()/backward() are "
                               "pending; finish the step with step()")
        losses = []
        for mb in self._micro_batches(batch):
            loss = self.forward(mb)
            self.backward(loss)
            losses.append(loss.detach().float())
        self.step()
        return float(torch.stack(losses).mean())

    def eval_batch(self, batch: Dict[str, Any]) -> float:
        with torch.no_grad():
            return float(self.forward(batch))

    # ------------------------------------------------------------------
    # outside the slice
    # ------------------------------------------------------------------
    def save_checkpoint(self, *args, **kwargs):
        raise outside_slice("checkpoint save", "11f (checkpointing)")

    def load_checkpoint(self, *args, **kwargs):
        raise outside_slice("checkpoint load", "11f (checkpointing)")
