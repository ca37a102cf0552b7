"""Communication logging and the serving transfer counters.

Counterpart of ``deepspeed_tpu/utils/comms_logging.py``.
:class:`ServingCounters` (the ``serving_counters`` singleton) is the
facade over the registry's ``ds_serving_*`` counters that the engine,
the scheduler and the state manager advance on every serving step: one
program per dispatch with the host-to-device bytes of its batch arrays,
one step per scheduler step, the device-to-host bytes a step actually
copies to the host (the [S] int32 tokens, a verify step's accept
vectors, the split path's sampled groups), the logits bytes a ``put``
hands back, the prefix cache's lookups, hits and evicted pages, and the
prompt tokens prefilled.  :class:`CommsLogger` records collectives' names
and volumes; nothing in this package calls it until the collectives are
ported, as in the JAX package it serves the training engine.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, List

from ..telemetry import metrics as tm


def get_msg_size(tensor) -> int:
    try:
        return int(math.prod(tensor.shape)) * tensor.dtype.itemsize
    except Exception:
        return 0


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    names = ("B", "KB", "MB", "GB", "TB")
    i = min(int(math.log(size_bytes, 1024)), len(names) - 1)
    return f"{size_bytes / 1024 ** i:.2f} {names[i]}"


class ServingCounters:
    """Per-process serving-step transfer/program accounting.

    The fused serving step's claim is "one step program and one
    token-sized host transfer per scheduler step"; these counters measure
    it.  The engine records every program dispatch (a graph replay on the
    card) and the host-to-device bytes of the batch arrays it feeds; the
    scheduler records step boundaries and the device-to-host bytes it
    actually copies.  Vocab-wide ``[n, V]`` logits handed across the
    ``put()`` contract are tracked apart (``logits_exposed_bytes``): the
    fused sampling path never makes them.  The storage is the registry's
    ``ds_serving_*`` counters: this class is a facade (record methods,
    the field names as properties, the derived per-step snapshot) over
    the one source the ``/metrics`` endpoint also reads."""

    def __init__(self):
        self._counters = (
            tm.SERVING_PROGRAMS, tm.SERVING_STEPS, tm.SERVING_H2D_BYTES,
            tm.SERVING_D2H_BYTES, tm.SERVING_LOGITS_BYTES,
            tm.SERVING_PREFIX_LOOKUP_TOKENS, tm.SERVING_PREFIX_HIT_TOKENS,
            tm.SERVING_PREFIX_EVICTED_PAGES, tm.SERVING_PREFILL_TOKENS)

    def reset(self) -> None:
        for c in self._counters:
            c.reset()

    # -- legacy field names, backed by the registry ------------------------
    @property
    def programs(self) -> int:
        return tm.SERVING_PROGRAMS.value

    @property
    def steps(self) -> int:
        return tm.SERVING_STEPS.value

    @property
    def h2d_bytes(self) -> int:
        return tm.SERVING_H2D_BYTES.value

    @property
    def d2h_bytes(self) -> int:
        return tm.SERVING_D2H_BYTES.value

    @property
    def logits_exposed_bytes(self) -> int:
        return tm.SERVING_LOGITS_BYTES.value

    @property
    def prefix_lookup_tokens(self) -> int:
        return tm.SERVING_PREFIX_LOOKUP_TOKENS.value

    @property
    def prefix_hit_tokens(self) -> int:
        return tm.SERVING_PREFIX_HIT_TOKENS.value

    @property
    def prefix_evicted_pages(self) -> int:
        return tm.SERVING_PREFIX_EVICTED_PAGES.value

    @property
    def prefill_tokens(self) -> int:
        return tm.SERVING_PREFILL_TOKENS.value

    def record_step(self) -> None:
        tm.SERVING_STEPS.inc()

    def record_program(self, h2d_bytes: int = 0) -> None:
        tm.SERVING_PROGRAMS.inc()
        tm.SERVING_H2D_BYTES.inc(int(h2d_bytes))

    def record_h2d(self, nbytes: int) -> None:
        tm.SERVING_H2D_BYTES.inc(int(nbytes))

    def record_d2h(self, nbytes: int) -> None:
        tm.SERVING_D2H_BYTES.inc(int(nbytes))

    def record_logits_exposed(self, nbytes: int) -> None:
        tm.SERVING_LOGITS_BYTES.inc(int(nbytes))

    def record_prefix_lookup(self, lookup_tokens: int,
                             hit_tokens: int) -> None:
        tm.SERVING_PREFIX_LOOKUP_TOKENS.inc(int(lookup_tokens))
        tm.SERVING_PREFIX_HIT_TOKENS.inc(int(hit_tokens))

    def record_prefix_evicted(self, num_pages: int) -> None:
        tm.SERVING_PREFIX_EVICTED_PAGES.inc(int(num_pages))

    def record_prefill(self, num_tokens: int) -> None:
        tm.SERVING_PREFILL_TOKENS.inc(int(num_tokens))

    def snapshot(self) -> Dict[str, Any]:
        steps = max(self.steps, 1)
        return {
            "programs": self.programs,
            "steps": self.steps,
            "programs_per_step": round(self.programs / steps, 3),
            "h2d_bytes_per_step": self.h2d_bytes // steps,
            "d2h_bytes_per_step": self.d2h_bytes // steps,
            "logits_exposed_bytes_per_step":
                self.logits_exposed_bytes // steps,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": round(
                self.prefix_hit_tokens / self.prefix_lookup_tokens, 4)
                if self.prefix_lookup_tokens else 0.0,
            "prefix_evicted_pages": self.prefix_evicted_pages,
            "prefill_tokens": self.prefill_tokens,
        }


#: process-wide singleton (tests reset() around measured windows)
serving_counters = ServingCounters()


class CommsLogger:
    def __init__(self, enabled: bool = True, verbose: bool = False, debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.debug = debug
        # op_name -> msg_size -> [count]
        self.comms_dict: Dict[str, Dict[int, List[int]]] = defaultdict(lambda: defaultdict(lambda: [0]))
        # a collective scheduler's static bucket plan (bytes on the wire,
        # fp32-equivalent bytes, per-bucket volumes)
        self.bucket_plan: Dict[str, Any] = {}

    def append_traced(self, op_name: str, tensor: Any) -> None:
        size = get_msg_size(tensor)
        self.comms_dict[op_name][size][0] += 1
        if self.verbose:
            from .logging import logger
            logger.info("comm op: %s | msg size: %s", op_name, convert_size(size))

    def record_bucket_plan(self, stats: Dict[str, Any]) -> None:
        """Record a collective scheduler's static wire plan so
        ``log_summary`` can attribute gradient-collective volume per
        bucket."""
        self.bucket_plan = dict(stats)
        tm.COMM_BUCKET_COUNT.set(stats.get("bucket_count", 0))
        tm.COMM_WIRE_BYTES.set(stats.get("comm_bytes_per_step", 0))
        tm.COMM_FP32_BYTES.set(
            stats.get("comm_fp32_equiv_bytes_per_step", 0))
        tm.COMM_QUANTIZED_FRACTION.set(
            stats.get("comm_quantized_fraction", 0.0))
        if self.verbose:
            from .logging import logger
            logger.info(
                "comm plan: %d bucket(s), %s/step on the wire "
                "(fp32 equivalent %s), quantized fraction %.2f",
                stats.get("bucket_count", 0),
                convert_size(stats.get("comm_bytes_per_step", 0)),
                convert_size(stats.get("comm_fp32_equiv_bytes_per_step", 0)),
                stats.get("comm_quantized_fraction", 0.0))

    def log_summary(self) -> str:
        lines = [f"{'Comm. Op':<25}{'Message Size':<20}{'Count':<10}{'Total Volume':<15}"]
        for op, sizes in sorted(self.comms_dict.items()):
            for size, (count,) in sorted(sizes.items()):
                lines.append(
                    f"{op:<25}{convert_size(size):<20}{count:<10}{convert_size(size * count):<15}")
        if self.bucket_plan:
            p = self.bucket_plan
            lines.append("")
            lines.append(
                f"Gradient collective schedule: {p.get('bucket_count', 0)} "
                f"bucket(s) over {p.get('reduce_axes')} "
                f"(world {p.get('reduce_world')}), "
                f"{convert_size(p.get('comm_bytes_per_step', 0))}/step "
                f"wire vs {convert_size(p.get('comm_fp32_equiv_bytes_per_step', 0))} fp32-equiv, "
                f"quantized fraction {p.get('comm_quantized_fraction', 0.0)}")
            lines.append(f"{'Bucket':<10}{'Elems':<15}{'Wire Bytes':<15}"
                         f"{'FP32 Bytes':<15}{'Quantized':<10}")
            for b in p.get("per_bucket", []):
                lines.append(
                    f"{b['index']:<10}{b['elems']:<15}"
                    f"{convert_size(b['wire_bytes']):<15}"
                    f"{convert_size(b['fp32_bytes']):<15}"
                    f"{str(b['quantized']):<10}")
        out = "\n".join(lines)
        from .logging import logger
        logger.info("Communication summary:\n%s", out)
        return out

    def reset(self) -> None:
        self.comms_dict.clear()
        self.bucket_plan = {}
