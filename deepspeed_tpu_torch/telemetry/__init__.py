"""Telemetry: one observability layer for the serving stack.

Counterpart of ``deepspeed_tpu/telemetry``: the process-wide switch
(:mod:`.state`), the metrics registry and the ``ds_*`` catalog
(:mod:`.registry`, :mod:`.metrics`) with its Prometheus endpoint
(:mod:`.server`, ``DS_METRICS_PORT``, off by default), the span tracer
(:mod:`.tracer`, each span also a ``torch.profiler.record_function``),
the health watchdog (:mod:`.watchdog`), the flight recorder and its
postmortem bundle (:mod:`.flight_recorder`), request journeys
(:mod:`.journey`), the workload trace (:mod:`.workload_trace`), the
time-series ring (:mod:`.timeseries`), the fleet federation
(:mod:`.federation`), the SLO burn-rate evaluator (:mod:`.slo`) and the
memory ledger (:mod:`.memory`).  Everything but the counters is gated on
one flag (``DS_TELEMETRY=1``, :func:`enable`, or the engine config's
``telemetry.enabled``).  ``DS_METRICS_PORT``, ``DS_POSTMORTEM_ON_EXIT``,
``DS_WORKLOAD_TRACE``, ``DS_TIMESERIES`` and ``DS_FLEET_TARGETS`` are
honoured when this package is imported, as in the JAX package.
"""

from __future__ import annotations

from . import metrics  # noqa: F401  (mints the whole ds_* catalog)
from .federation import Federation, get_federation  # noqa: F401
from .federation import maybe_configure_from_env as _federation_from_env
from .flight_recorder import (FlightRecorder, dump_postmortem,  # noqa: F401
                              get_flight_recorder,
                              maybe_install_exit_handlers)
from .journey import Journey, JourneyLog, get_journey_log  # noqa: F401
from .memory import MemoryLedger, get_memory_ledger  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry, log_buckets,
                       percentile_from_counts)
from .server import (maybe_start_from_env, serve_registry,  # noqa: F401
                     start_http_server, stop_http_server)
from .slo import SLOEvaluator, get_slo_evaluator  # noqa: F401
from .state import state
from .timeseries import TimeSeries, WindowHist, get_timeseries  # noqa: F401
from .timeseries import maybe_configure_from_env as _timeseries_from_env
from .tracer import (SpanTracer, dump_trace, get_tracer,  # noqa: F401
                     set_component, trace_span)
from .watchdog import Watchdog, get_watchdog  # noqa: F401
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


def apply_settings(enabled: "bool | None" = None, metrics_port: int = 0,
                   trace_buffer: int = 0,
                   watchdog: "bool | None" = None,
                   watchdog_threshold: float = 0.0,
                   watchdog_warmup: int = -1,
                   postmortem_dir: str = "",
                   flight_recorder_events: int = 0,
                   workload_trace_path: str = "",
                   workload_trace_max_mb: int = 0,
                   timeseries_interval_s: float = 0.0,
                   timeseries_retention_s: float = 0.0,
                   fleet_targets: str = "",
                   slo_objectives: "list | None" = None) -> None:
    """Push a ``telemetry`` config block into the process-wide state
    (the JAX package's ``apply_settings``, field for field).
    ``enabled=None`` keeps the current flag; 0, -1 (``watchdog_warmup``),
    "" and None keep what is configured now.  ``metrics_port`` 0 means
    off and -1 an ephemeral port (the ``DS_METRICS_PORT=0`` semantics, so
    N replicas on one host never collide); a positive
    ``timeseries_interval_s`` starts the background sampler;
    ``fleet_targets`` replaces the federation's membership; a non-empty
    ``slo_objectives`` replaces the objective set and attaches the
    evaluator to the time-series sampler."""
    if enabled is not None:
        set_enabled(enabled)
    if trace_buffer:
        get_tracer().resize(trace_buffer)
    if workload_trace_path or workload_trace_max_mb:
        get_workload_trace().configure(workload_trace_path,
                                       max_mb=workload_trace_max_mb)
    get_watchdog().configure(enabled=watchdog,
                             threshold=watchdog_threshold,
                             warmup=watchdog_warmup,
                             postmortem_dir=postmortem_dir)
    if postmortem_dir:
        get_flight_recorder().postmortem_dir = postmortem_dir
    if flight_recorder_events:
        get_flight_recorder().resize(flight_recorder_events)
    if timeseries_interval_s or timeseries_retention_s:
        ts = get_timeseries()
        ts.configure(interval_s=timeseries_interval_s,
                     retention_s=timeseries_retention_s)
        if timeseries_interval_s:
            ts.start_thread()
    if fleet_targets:
        get_federation().configure_targets(fleet_targets)
    if slo_objectives:
        ev = get_slo_evaluator()
        ev.configure(slo_objectives)
        ev.attach(timeseries=get_timeseries(),
                  federation=get_federation())
        if not get_timeseries().active:
            # objectives without a sampler are dead: the on-sample hook
            # never fires, so /healthz would report them forever ok
            from ..utils.logging import logger
            logger.warning(
                "telemetry.slo_objectives configured but the "
                "time-series sampler is off: burn rates will never "
                "be evaluated; set telemetry.timeseries_interval_s "
                "(or DS_TIMESERIES) to arm them")
    if metrics_port:
        try:
            start_http_server(0 if metrics_port < 0 else metrics_port)
        except OSError as e:
            # only one process per host can bind a fixed port; the
            # others must still build their engine
            from ..utils.logging import logger
            logger.warning(
                "telemetry.metrics_port=%d: endpoint not started "
                "(%s); continuing without it", metrics_port, e)


maybe_start_from_env()
maybe_install_exit_handlers()
maybe_configure_from_env()
_timeseries_from_env()
_federation_from_env()
