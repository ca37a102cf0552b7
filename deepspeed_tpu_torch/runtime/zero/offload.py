"""ZeRO-Offload: the optimizer's fp32 masters and moments on the host (or
NVMe), the step in the host C++ kernels.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``:

* :class:`HostOffloadOptimizer` picks the offloaded leaves (all of them,
  or with ``ratio`` < 1 the largest first until that share of the
  elements is reached: ZeRO-Offload++ Twin-Flow), keeps their fp32
  masters as flat host arrays and steps them in ``ops/adam``'s host
  Adam, Adagrad or Lion;
* :class:`NVMeStateSwapper` keeps the host optimizer's moments in one
  file per (leaf, slot) under ``nvme_path/rank0`` and reads leaf k+1's
  while leaf k steps, over ``ops/aio``.

Leaves are indexed as ``jax.tree.flatten`` orders them (dict keys sorted
at every level), so the port and the JAX package pick the same indices
and read each other's ``offload_rank0.npz`` (``master_k``,
``state_k_slot``, ``steps_keys``, ``steps_vals``, k counting offloaded
leaves in that order).  The engine (``runtime/engine.py``) keeps only the
compute-dtype copy and the fp32 gradient accumulator of an offloaded
leaf on the device, and hands the host step the reduced, clipped fp32
gradients leaf by leaf.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...utils.logging import logger


def flatten_sorted(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree.flatten``'s order: dict keys
    sorted at every level, paths ``/``-joined."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_sorted(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


class _Shape:
    """A leaf's shape, all the leaf choice reads (JAX keeps the abstract
    ``ShapeDtypeStruct``)."""
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = shape


def _numel(leaf) -> int:
    return int(np.prod(tuple(leaf.shape)))


class NVMeStateSwapper:
    """Optimizer-state tier on NVMe with async prefetch.

    One file per (leaf, slot) under ``swap_dir``; reads for leaf *i+1* are
    submitted before the host steps leaf *i*.  ``wait_s`` sums the time
    spent blocked on reads and on the final flush.
    """

    def __init__(self, swap_dir: str, aio_threads: int = 4,
                 block_size: int = 1 << 20, queue_depth: int = 128,
                 use_direct: bool = False):
        from ...ops.aio import AsyncIOHandle
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.handle = AsyncIOHandle(num_threads=aio_threads,
                                    block_size=block_size,
                                    queue_depth=queue_depth,
                                    use_direct=use_direct)
        self._pending_reads: Dict[str, Tuple[int, np.ndarray]] = {}
        self._on_disk: set = set()
        self.wait_s = 0.0

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, f"{key}.bin")

    def prefetch(self, key: str, n_elems: int) -> None:
        """Submit an async read of a state buffer (no-op if never written)."""
        if key in self._pending_reads or key not in self._on_disk:
            return
        buf = np.empty(n_elems, np.float32)
        req = self.handle.pread(buf, self._path(key))
        self._pending_reads[key] = (req, buf)

    def fetch(self, key: str, n_elems: int) -> np.ndarray:
        """Blocking read (or completion of a prefetch); zeros if new."""
        t0 = time.perf_counter()
        try:
            if key in self._pending_reads:
                req, buf = self._pending_reads.pop(key)
                self.handle.wait(req)
                return buf
            if key not in self._on_disk:
                return np.zeros(n_elems, np.float32)
            buf = np.empty(n_elems, np.float32)
            self.handle.sync_pread(buf, self._path(key))
            return buf
        finally:
            self.wait_s += time.perf_counter() - t0

    def writeback(self, key: str, buf: np.ndarray) -> None:
        """Async write; the swapper owns the buffer until flushed."""
        self.handle.pwrite(buf, self._path(key))
        self._on_disk.add(key)

    def flush(self) -> None:
        t0 = time.perf_counter()
        self.handle.wait_all()
        self.wait_s += time.perf_counter() - t0

    def close(self) -> None:
        self.handle.close()


class HostOffloadOptimizer:
    """Host-side optimizer over the offloaded subset of the parameters.

    ``params`` is the model's parameter tree (tensors or anything with a
    ``shape``); ``config`` the engine's :class:`~..config.TrainingConfig`.
    """

    #: optimizer types the host kernels cover
    SUPPORTED = ("adam", "adamw", "fusedadam", "cpuadam", "deepspeedcpuadam",
                 "adagrad", "lion", "fusedlion", "cpulion")

    def __init__(self, params: Any, config: Any):
        off = config.offload_optimizer
        self.device = off.device  # "cpu" | "nvme"
        self.ratio = float(off.ratio)
        self._select_leaves(params)
        self._build_host_optimizer(config.optimizer)
        self.swapper: Optional[NVMeStateSwapper] = None
        if self.device == "nvme":
            aio = config.aio
            # aio.thread_count wins when the user set it; else the offload
            # block's aio_threads
            threads = (aio.thread_count if aio.thread_count is not None
                       else int(off.aio_threads))
            root = off.nvme_path or os.path.join(tempfile.gettempdir(),
                                                 "ds_tpu_nvme")
            self.swapper = NVMeStateSwapper(
                os.path.join(root, "rank0"), aio_threads=threads,
                block_size=aio.block_size, queue_depth=aio.queue_depth,
                use_direct=aio.use_direct_io)
        self.masters: List[np.ndarray] = []
        n_off = sum(_numel(self._flat[i]) for i in self.offload_idx)
        n_all = sum(_numel(leaf) for leaf in self._flat)
        logger.info(
            f"ZeRO-Offload: {len(self.offload_idx)}/{len(self._flat)} "
            f"leaves, {n_off}/{n_all} elements ({n_off / max(1, n_all):.0%}) "
            f"-> {self.device}")

    # ------------------------------------------------------------ leaves
    def _select_leaves(self, params: Any) -> None:
        pairs = flatten_sorted(params)
        self.paths = [p for p, _ in pairs]
        # shapes only: the leaves themselves (fp32 weights on the card)
        # must not outlive the engine's build
        self._flat = [_Shape(tuple(leaf.shape)) for _, leaf in pairs]
        total = sum(_numel(leaf) for leaf in self._flat)
        # Twin-Flow partial offload: the largest leaves first until the
        # element ratio is reached (big leaves amortise the transfer best)
        by_size = sorted(range(len(self._flat)),
                         key=lambda i: -_numel(self._flat[i]))
        chosen: List[int] = []
        acc = 0
        for i in by_size:
            if self.ratio >= 1.0 or acc < self.ratio * total:
                chosen.append(i)
                acc += _numel(self._flat[i])
        #: offloaded leaves, as indices in ``jax.tree.flatten`` order
        self.offload_idx = sorted(chosen)
        #: their paths, in the same order (master k is ``offload_paths[k]``)
        self.offload_paths = [self.paths[i] for i in self.offload_idx]

    def device_mask(self) -> List[bool]:
        """True where the device optimizer applies, in flatten order."""
        off = set(self.offload_idx)
        return [i not in off for i in range(len(self._flat))]

    # ----------------------------------------------------- host optimizer
    def _build_host_optimizer(self, opt_cfg) -> None:
        name = opt_cfg.type.lower().replace("_", "")
        p = opt_cfg.params
        if name not in self.SUPPORTED:
            raise ValueError(
                f"offload_optimizer does not support optimizer "
                f"{opt_cfg.type!r}; host kernels exist for "
                f"{sorted(set(self.SUPPORTED))}")
        if name == "adagrad":
            from ...ops.adam import DeepSpeedCPUAdagrad
            self.host_opt = DeepSpeedCPUAdagrad(
                lr=p.lr, eps=p.eps, weight_decay=p.weight_decay)
        elif name in ("lion", "fusedlion", "cpulion"):
            from ...ops.adam import DeepSpeedCPULion
            self.host_opt = DeepSpeedCPULion(
                lr=p.lr, betas=tuple(p.betas)[:2], weight_decay=p.weight_decay)
        else:
            from ...ops.adam import DeepSpeedCPUAdam
            # adamw always decouples; adam/fusedadam/cpuadam follow
            # adam_w_mode, as the device factory does
            self.host_opt = DeepSpeedCPUAdam(
                lr=p.lr, betas=tuple(p.betas)[:2], eps=p.eps,
                weight_decay=p.weight_decay,
                adamw_mode=name == "adamw" or p.adam_w_mode)
        self._slots = self.host_opt.SLOTS

    # ------------------------------------------------------------- state
    def init_masters(self, params: Any) -> None:
        """fp32 masters of the offloaded leaves, copied from the tree
        ``params`` (tensors on any device, or arrays) into flat host
        arrays."""
        leaves = [leaf for _, leaf in flatten_sorted(params)]
        self.masters = [_host_fp32(leaves[i]) for i in self.offload_idx]

    def step(self, host_grads: Sequence[np.ndarray],
             lr: Optional[float] = None,
             on_update: Optional[Callable[[int, np.ndarray], None]] = None
             ) -> List[np.ndarray]:
        """One host optimizer step over every offloaded leaf.

        ``host_grads`` aligns with ``offload_idx``; element k is read only
        when leaf k steps, so it may be a lazy sequence that stages each
        gradient into one reused buffer.  ``on_update(k, master)`` runs
        after leaf k's step.  Returns the updated fp32 masters (flat).
        """
        assert len(host_grads) == len(self.offload_idx)
        if self.swapper is not None:
            return self._step_nvme(host_grads, lr, on_update)
        for k in range(len(self.offload_idx)):
            self.host_opt.step(k, self.masters[k], _flat_fp32(host_grads[k]),
                               lr=lr)
            if on_update is not None:
                on_update(k, self.masters[k])
        return self.masters

    def _step_nvme(self, host_grads, lr, on_update) -> List[np.ndarray]:
        """Sequential leaf loop with one-ahead state prefetch."""
        n = len(self.offload_idx)
        state_of = self.host_opt._state  # managed here, leaf by leaf
        if n:
            for slot in self._slots:
                self.swapper.prefetch(f"l0_{slot}", self.masters[0].size)
        for k in range(n):
            # completes the prefetch of this leaf's slots
            state_of[k] = {
                slot: self.swapper.fetch(f"l{k}_{slot}", self.masters[k].size)
                for slot in self._slots
            }
            self.host_opt._steps.setdefault(k, 0)
            # overlap: the next leaf's reads go out before this one steps
            if k + 1 < n:
                for slot in self._slots:
                    self.swapper.prefetch(f"l{k + 1}_{slot}",
                                          self.masters[k + 1].size)
            self.host_opt.step(k, self.masters[k], _flat_fp32(host_grads[k]),
                               lr=lr)
            if on_update is not None:
                on_update(k, self.masters[k])
            for slot in self._slots:
                self.swapper.writeback(f"l{k}_{slot}", state_of[k][slot])
            del state_of[k]  # the states live on NVMe, not in RAM
        self.swapper.flush()
        return self.masters

    # ------------------------------------------------------ checkpointing
    def state_dict(self) -> Dict[str, Any]:
        if self.swapper is not None:
            # materialise the NVMe states
            states = {}
            for k in range(len(self.offload_idx)):
                states[k] = {
                    slot: self.swapper.fetch(f"l{k}_{slot}",
                                             self.masters[k].size)
                    for slot in self._slots
                }
            return {"masters": [m.copy() for m in self.masters],
                    "state": states, "steps": dict(self.host_opt._steps)}
        sd = {"masters": [m.copy() for m in self.masters]}
        sd.update(self.host_opt.state_dict())
        return sd

    def save_npz(self, path: str) -> None:
        """Masters and host optimizer states in one npz (the JAX keys)."""
        sd = self.state_dict()
        arrays: Dict[str, np.ndarray] = {}
        for k, m in enumerate(sd["masters"]):
            arrays[f"master_{k}"] = m
        for k, slots in sd.get("state", {}).items():
            for slot, buf in slots.items():
                arrays[f"state_{k}_{slot}"] = np.asarray(buf)
        steps = sd.get("steps", {})
        arrays["steps_keys"] = np.asarray(sorted(int(k) for k in steps),
                                          np.int64)
        arrays["steps_vals"] = np.asarray(
            [int(steps[k]) for k in sorted(steps, key=int)], np.int64)
        np.savez(path, **arrays)

    def load_npz(self, path: str) -> None:
        with np.load(path) as z:
            masters = []
            k = 0
            while f"master_{k}" in z:
                masters.append(np.asarray(z[f"master_{k}"], np.float32))
                k += 1
            state: Dict[int, Dict[str, np.ndarray]] = {}
            for name in z.files:
                if name.startswith("state_"):
                    _, idx, slot = name.split("_", 2)
                    state.setdefault(int(idx), {})[slot] = np.asarray(
                        z[name], np.float32)
            steps = {int(k_): int(v) for k_, v in
                     zip(z["steps_keys"], z["steps_vals"])}
        self.load_state_dict({"masters": masters, "state": state,
                              "steps": steps})

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.masters = [np.ascontiguousarray(m, np.float32)
                        for m in sd["masters"]]
        if self.swapper is not None:
            for k, slots in sd.get("state", {}).items():
                for slot, buf in slots.items():
                    self.swapper.writeback(f"l{int(k)}_{slot}",
                                           np.asarray(buf, np.float32))
            self.swapper.flush()
            self.host_opt._steps = {int(k): int(v)
                                    for k, v in sd.get("steps", {}).items()}
        else:
            self.host_opt.load_state_dict({"steps": sd.get("steps", {}),
                                           "state": sd.get("state", {})})

    def update_count(self) -> int:
        """Leaf 0's host update count (0 before the first step)."""
        return int(self.host_opt._steps.get(0, 0))


def _host_fp32(leaf) -> np.ndarray:
    """A new flat C-contiguous fp32 host array holding ``leaf`` (a tensor
    on any device, or an array)."""
    if hasattr(leaf, "detach"):
        import torch
        out = np.empty(_numel(leaf), np.float32)
        torch.from_numpy(out).copy_(leaf.detach().reshape(-1))
        return out
    return np.array(np.asarray(leaf, np.float32).ravel(), copy=True)


def _flat_fp32(grad) -> np.ndarray:
    arr = np.asarray(grad)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr.reshape(-1)
