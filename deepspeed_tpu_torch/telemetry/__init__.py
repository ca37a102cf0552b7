"""Telemetry: the core the serving fleet stands on.

Counterpart of ``deepspeed_tpu/telemetry``'s core: the process-wide
switch (:mod:`.state`), the metrics registry and the ``ds_*`` catalog
(:mod:`.registry`, :mod:`.metrics`), the span tracer (:mod:`.tracer`,
each span also a ``torch.profiler.record_function``), the flight
recorder and its postmortem bundle (:mod:`.flight_recorder`), request
journeys (:mod:`.journey`) and the workload trace
(:mod:`.workload_trace`).  Everything but the counters is gated on one
flag (``DS_TELEMETRY=1``, :func:`enable`, or the engine config's
``telemetry.enabled``).  Not ported yet (ROADMAP Queue 1 item 12b): the
metrics HTTP server, the watchdog, the time series, the federation, the
SLO evaluator and the memory ledger.  ``DS_WORKLOAD_TRACE`` and
``DS_POSTMORTEM_ON_EXIT`` are honoured when this package is imported, as
in the JAX package.
"""

from __future__ import annotations

from . import metrics  # noqa: F401  (mints the whole ds_* catalog)
from .flight_recorder import (FlightRecorder, dump_postmortem,  # noqa: F401
                              get_flight_recorder,
                              maybe_install_exit_handlers)
from .journey import Journey, JourneyLog, get_journey_log  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry, log_buckets,
                       percentile_from_counts)
from .state import state
from .tracer import (SpanTracer, dump_trace, get_tracer,  # noqa: F401
                     set_component, trace_span)
from .workload_trace import (WorkloadTrace, get_workload_trace,  # noqa: F401
                             maybe_configure_from_env)


def enabled() -> bool:
    return state.enabled


def enable() -> None:
    set_enabled(True)


def disable() -> None:
    set_enabled(False)


def set_enabled(on: bool) -> None:
    on = bool(on)
    if on and not state.enabled:
        state.generation += 1
    state.enabled = on


def apply_settings(enabled: "bool | None" = None, trace_buffer: int = 0,
                   postmortem_dir: str = "",
                   flight_recorder_events: int = 0,
                   workload_trace_path: str = "",
                   workload_trace_max_mb: int = 0) -> None:
    """Push a ``telemetry`` config block's served knobs into the
    process-wide state.  ``enabled=None`` keeps the current flag; 0 and
    "" keep what is configured now (the JAX package's convention)."""
    if enabled is not None:
        set_enabled(enabled)
    if trace_buffer:
        get_tracer().resize(trace_buffer)
    if workload_trace_path or workload_trace_max_mb:
        get_workload_trace().configure(workload_trace_path,
                                       max_mb=workload_trace_max_mb)
    if postmortem_dir:
        get_flight_recorder().postmortem_dir = postmortem_dir
    if flight_recorder_events:
        get_flight_recorder().resize(flight_recorder_events)


maybe_install_exit_handlers()
maybe_configure_from_env()
