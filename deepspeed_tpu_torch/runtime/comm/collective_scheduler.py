"""CollectiveScheduler: bucketed, int8-quantised gradient reduction.

Counterpart of ``deepspeed_tpu/runtime/comm/collective_scheduler.py``
(``Bucket`` :78, ``CollectiveScheduler`` :108-400).  The gradient tree
is flattened into one fp32 vector, cut into buckets of
``allreduce_bucket_size`` bytes whose boundaries align to ``world *
block`` elements (every bucket is whole quantisation blocks per rank),
and each bucket rides :func:`~..ops.quantization.quantized_allreduce_ef`
(an int8 all-to-all reduce-scatter and an int8 all-gather over the data
and fsdp ranks at once) or, with ``quantize`` off, an exact all-reduce.
With ``error_feedback`` each rank keeps the first hop's quantisation
error of its flat vector (``residuals``, stored divided by the loss
scale) and adds it, times the current scale, to the next reduction.
With ``overlap`` the engine reduces every micro-batch's buckets as the
micro-batch ends; without it the micro-batches accumulate unreduced and
one reduction runs at the accumulation boundary (fewer quantisations:
a numeric difference, as in JAX).

The engine builds the scheduler under JAX's gates (``engine.py:396-
464``): ``comm_optimization.enabled``, or the legacy qgZ flag at stage 2
or more (quantise on, error feedback off, overlap on); no scheduler when
no data or fsdp axis is larger than 1, or on an hpz, expert or pipe
mesh, and on a tensor or seq mesh with ``scan_layers`` or with the qgZ
flag alone, each with a logged warning.  On a tensor or seq mesh the
split between bucketed and ``direct`` leaves follows JAX's plan leaf by
leaf (``:155-160``): a leaf whose gradient spec touches ``tensor`` (a
tensor shard, each rank's own) takes a ``direct`` exact all-reduce over
the data and fsdp ranks every micro-batch (:meth:`reduce_direct`), and
every other leaf rides the flat vector, whose exchange each tensor and
seq rank runs alike within its own data-fsdp plane (the engine sums the
seq ranks' gradients first: in JAX the seq axis is automatic inside the
scheduler's region).  The plan is static: :meth:`stats` gives the wire
bytes per step, ``record_bucket_plan`` feeds them to the comms logger,
and :meth:`profile_buckets` times each bucket's reduction alone.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ...ops.quantization import quantized_allreduce_ef
from ...utils.logging import logger


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One contiguous slice of the flat gradient vector (elements)."""
    index: int
    start: int
    end: int
    quantized: bool

    @property
    def elems(self) -> int:
        return self.end - self.start

    def wire_bytes(self, block: int, itemsize: int = 4) -> int:
        """Bytes this bucket moves per device per reduction."""
        if self.quantized:
            # two int8 hops, each with fp32 scales every `block` elems
            return int(2 * self.elems * (1 + 4.0 / block))
        return 2 * itemsize * self.elems

    def fp32_bytes(self) -> int:
        """What an uncompressed fp32 all-reduce would move."""
        return 8 * self.elems


class CollectiveScheduler:
    """The bucket plan and its reduction for one engine.  ``shapes``
    are the gradient leaves' shapes on this rank in tree order (a tensor
    shard's for a tensor-sharded leaf), ``direct`` the indices of the
    leaves that take the exact direct sum, ``full_shapes`` the whole
    leaves' (JAX's wire accounting counts those); the reduction runs
    over the topology's data and fsdp axes."""

    def __init__(self, topology, comm_cfg, shapes: Sequence[Tuple[int, ...]],
                 acc_dtype: torch.dtype = torch.float32,
                 direct: Sequence[int] = (),
                 full_shapes: Optional[Sequence[Tuple[int, ...]]] = None):
        self.topology = topology
        self.cfg = comm_cfg
        self.acc_dtype = acc_dtype
        self.block = int(comm_cfg.quantization_block)
        self.quantize = bool(comm_cfg.quantize)
        self.overlap = bool(comm_cfg.overlap)
        self.error_feedback = bool(comm_cfg.error_feedback) and self.quantize
        self.manual_axes: Tuple[str, ...] = topology.live_axes(
            ("data", "fsdp"))
        self.world = topology.size(self.manual_axes)
        if self.world <= 1:
            raise ValueError("CollectiveScheduler needs data*fsdp > 1")
        self.group = topology.group(self.manual_axes)
        self.shapes = [tuple(s) for s in shapes]
        self.direct_idx = sorted(direct)
        self.bucketed_idx = [i for i in range(len(self.shapes))
                             if i not in set(self.direct_idx)]
        self._numels = [math.prod(s) for s in self.shapes]
        self.total_elems = sum(self._numels[i] for i in self.bucketed_idx)
        full = [tuple(s) for s in (full_shapes or shapes)]
        self.direct_elems = sum(math.prod(full[i]) for i in self.direct_idx)
        align = self.world * self.block
        self.padded_elems = (-(-self.total_elems // align) * align
                             if self.total_elems else 0)
        itemsize = torch.empty((), dtype=acc_dtype).element_size()
        per_bucket = max(align, (int(comm_cfg.allreduce_bucket_size)
                                 // itemsize) // align * align)
        self.buckets: List[Bucket] = []
        start = 0
        while start < self.padded_elems:
            end = min(start + per_bucket, self.padded_elems)
            self.buckets.append(Bucket(len(self.buckets), start, end,
                                       quantized=self.quantize))
            start = end
        logger.info(
            "CollectiveScheduler: %d bucket(s) x <=%d elems over axes %s "
            "(world %d), %d/%d elems quantized, %d direct-psum leaves, "
            "overlap=%s error_feedback=%s", len(self.buckets), per_bucket,
            self.manual_axes, self.world,
            self.total_elems if self.quantize else 0,
            self.total_elems + self.direct_elems, len(self.direct_idx),
            self.overlap, self.error_feedback)

    # -- residuals (persistent error feedback) ---------------------------
    def init_residuals(self, device) -> Optional[torch.Tensor]:
        """This rank's row of JAX's [world, E] residuals (None when
        error feedback is off)."""
        if not self.error_feedback or self.padded_elems == 0:
            return None
        return torch.zeros(self.padded_elems, dtype=self.acc_dtype,
                           device=device)

    # -- the flat vector ---------------------------------------------------
    def flatten_local(self, grads: Sequence[Optional[torch.Tensor]],
                      device) -> torch.Tensor:
        """This rank's unreduced gradients of the bucketed leaves (every
        leaf's gradient in tree order, the direct ones skipped) as one
        flat vector in the accumulation dtype, zero-padded, divided by
        ``world`` (JAX ``backward``'s ``flat / world``)."""
        flat = torch.zeros(self.padded_elems, dtype=self.acc_dtype,
                           device=device)
        off = 0
        for i in self.bucketed_idx:
            n, g = self._numels[i], grads[i]
            if g is not None:
                flat[off:off + n].copy_(g.reshape(-1))
            off += n
        return flat.div_(self.world)

    def reduce_direct(self, g: torch.Tensor) -> torch.Tensor:
        """A direct leaf's gradient summed exactly over the data and fsdp
        ranks, divided by ``world`` first, in the accumulation dtype (JAX
        ``lax.psum(g / world, manual)``)."""
        from ...comm import comm
        return comm.all_reduce(g.to(self.acc_dtype) / self.world,
                               self.group)

    def reduce(self, flat: torch.Tensor, residual: Optional[torch.Tensor],
               scale: float = 1.0) -> torch.Tensor:
        """Every bucket of ``flat`` reduced over the data and fsdp ranks
        (int8 or exact), in place: returns ``flat``, which now holds the
        sums.  With error feedback, ``residual`` (this rank's, stored
        divided by ``scale``, the fp16 loss scale, and re-injected times
        the current one) is updated in place too: each bucket reads and
        writes only its own slice."""
        if self.padded_elems == 0:
            return flat
        ef = self.error_feedback
        sc = float(torch.tensor(scale, dtype=torch.float32))
        for b in self.buckets:
            seg = flat[b.start:b.end]
            if ef:
                seg = seg + sc * residual[b.start:b.end]
            if b.quantized:
                red, err = quantized_allreduce_ef(seg, self.group,
                                                  self.world, self.block)
            else:
                from ...comm import comm
                red, err = comm.all_reduce(seg, self.group), None
            flat[b.start:b.end].copy_(red)
            if ef:
                if err is None:
                    residual[b.start:b.end].zero_()
                else:
                    residual[b.start:b.end].copy_(err / sc)
        return flat

    def combine(self, flat: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """The bucketed leaves' gradients (views of ``flat``) in tree
        order, None at the direct leaves."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.shapes)
        off = 0
        for i in self.bucketed_idx:
            n = self._numels[i]
            out[i] = flat[off:off + n].view(self.shapes[i])
            off += n
        return out

    # -- observability -----------------------------------------------------
    def stats(self, gas: int = 1) -> dict:
        """Static per-step wire accounting (JAX ``stats``)."""
        bucket_rounds = gas if self.overlap else 1
        itemsize = torch.empty((), dtype=self.acc_dtype).element_size()
        bucket_bytes = sum(b.wire_bytes(self.block, itemsize)
                           for b in self.buckets)
        bucket_fp32 = sum(b.fp32_bytes() for b in self.buckets)
        direct_bytes = 2 * itemsize * self.direct_elems * gas
        total = bucket_bytes * bucket_rounds + direct_bytes
        fp32_equiv = (bucket_fp32 * bucket_rounds
                      + 8 * self.direct_elems * gas)
        quantized_elems = self.total_elems if self.quantize else 0
        return {
            "bucket_count": len(self.buckets),
            "bucket_rounds_per_step": bucket_rounds,
            "comm_bytes_per_step": int(total),
            "comm_fp32_equiv_bytes_per_step": int(fp32_equiv),
            "comm_quantized_fraction": round(
                quantized_elems
                / max(1, self.total_elems + self.direct_elems), 4),
            "reduce_axes": list(self.manual_axes),
            "reduce_world": self.world,
            "overlap": self.overlap,
            "error_feedback": self.error_feedback,
            "per_bucket": [
                {"index": b.index, "elems": b.elems,
                 "quantized": b.quantized,
                 "wire_bytes": b.wire_bytes(self.block, itemsize),
                 "fp32_bytes": b.fp32_bytes()}
                for b in self.buckets],
        }

    def profile_buckets(self, iters: int = 5, device=None) -> List[dict]:
        """Each bucket's reduction alone, timed on the host clock around
        ``iters`` calls that end in a device synchronise (a collective:
        every rank calls it)."""
        device = torch.device("cpu") if device is None else device
        res = self.init_residuals(device)
        results = []
        for b in self.buckets:
            seg = torch.zeros(b.elems, dtype=self.acc_dtype, device=device)
            r = res[:b.elems] if res is not None else None

            def once():
                sub = dataclasses.replace(b, index=0, start=0, end=b.elems)
                saved = self.buckets
                self.buckets = [sub]
                try:
                    out = self.reduce(seg, r)
                finally:
                    self.buckets = saved
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                return out
            once()
            t0 = time.perf_counter()
            for _ in range(iters):
                once()
            dt = (time.perf_counter() - t0) / iters
            results.append({"index": b.index, "elems": b.elems,
                            "mean_ms": round(dt * 1e3, 3)})
        return results
