"""Telemetry: the workload trace.

Counterpart of the part of ``deepspeed_tpu/telemetry`` that a mined
bucket lattice needs: the workload trace (:mod:`.workload_trace`) and the
subset of ``apply_settings`` that configures it.  The rest of the JAX
package's telemetry (metrics registry, span tracer, watchdog, flight
recorder, time series, journeys, memory ledger) is ROADMAP open item 4.
``DS_WORKLOAD_TRACE`` is honoured when this package is imported, as in
the JAX package.
"""

from __future__ import annotations

from .workload_trace import (WorkloadTrace, get_workload_trace,  # noqa: F401
                             maybe_configure_from_env)


def apply_settings(workload_trace_path: str = "",
                   workload_trace_max_mb: int = 0) -> None:
    """Push a ``telemetry`` config block's workload-trace knobs into the
    process-wide trace; "" and 0 keep what is configured now."""
    if workload_trace_path or workload_trace_max_mb:
        get_workload_trace().configure(workload_trace_path,
                                       max_mb=workload_trace_max_mb)


maybe_configure_from_env()
