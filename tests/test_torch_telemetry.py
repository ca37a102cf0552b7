"""The port's telemetry core and fault injector, held against the JAX
package.

Plain Python on both sides except the journeys: the registry's counters,
gauges and histograms (and ``percentile_from_counts``) give JAX's values
on the same seeded observations; the ``ds_*`` catalog has JAX's names,
kinds and buckets; the same events give the same flight-recorder events
and postmortem artifacts; ``set_component`` is per thread; a span is a
``torch.profiler.record_function`` in the port; the fault injector fires
at JAX's call ordinals for the same seed and spec.  Journeys: both
schedulers (and both disaggregated pools) serve the same traffic with
telemetry on, and every request's segment chain has JAX's stages.
Telemetry is switched off again after each test (both packages).
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu import serving as JS
from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu.runtime import fault_injection as jfi
from deepspeed_tpu.telemetry import flight_recorder as jfr
from deepspeed_tpu.telemetry import journey as jjourney
from deepspeed_tpu.telemetry import metrics as jtm
from deepspeed_tpu.telemetry import registry as jreg
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu_torch import serving as TS
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.runtime import fault_injection as tfi
from deepspeed_tpu_torch.telemetry import flight_recorder as tfr
from deepspeed_tpu_torch.telemetry import journey as tjourney
from deepspeed_tpu_torch.telemetry import memory as tmemory
from deepspeed_tpu_torch.telemetry import metrics as ttm
from deepspeed_tpu_torch.telemetry import registry as treg
from deepspeed_tpu_torch.telemetry import timeseries as ttimeseries
from deepspeed_tpu_torch.telemetry import tracer as ttracer

PAGE, SEED = 16, 7


def _empty_both():
    for tel, jlog, reg, fr in ((ttel, tjourney, treg, tfr),
                               (jtel, jjourney, jreg, jfr)):
        tel.disable()
        jlog.get_journey_log().clear()
        tel.get_tracer().clear()
        reg.get_registry().reset()
        fr.get_flight_recorder().clear()


@pytest.fixture(autouse=True)
def _telemetry_off_after():
    """Telemetry goes off and the process-wide registries, rings and logs
    are emptied before and after each test: a test here must see what a
    fresh process sees, whatever ran before it in this worker (a JAX
    test that served with telemetry on leaves its journey log full, and a
    dump would then write ``journeys.json`` for one package only), and
    so must a later test file (the queue-wait histogram, say, vetoes
    shedding once it holds samples)."""
    torch.set_num_threads(1)
    # a pool test earlier in this worker may have labelled this thread
    labels = (ttracer.current_component(), jtracer.current_component())
    ttracer.set_component("")
    jtracer.set_component("")
    _empty_both()
    yield
    ttracer.set_component(labels[0])
    jtracer.set_component(labels[1])
    _empty_both()


def _observations(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(1.0, 2.0, 500),
                           [0.0, 1e-9, 5e5, 7e5]]).tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_values_equal_jax(seed):
    obs = _observations(seed)
    regs = {}
    for mod in (treg, jreg):
        r = mod.MetricsRegistry()
        c, g = r.counter("ds_x_total", "x"), r.gauge("ds_g")
        h = r.histogram("ds_h_ms", buckets=mod.log_buckets(1e-2, 1e3))
        d = r.histogram("ds_d_ms")
        for v in obs:
            c.inc(v)
            h.observe(v)
            d.observe(v)
        g.set(obs[3])
        r.gauge_fn("ds_fn", lambda: 42)
        regs[mod] = r
        with pytest.raises(TypeError):
            r.gauge("ds_x_total")
    t, j = regs[treg], regs[jreg]
    assert t.snapshot() == j.snapshot()
    assert t.raw_snapshot() == j.raw_snapshot()
    assert t.prometheus_text() == j.prometheus_text()
    h = t.histogram("ds_h_ms")
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert treg.percentile_from_counts(h.bounds, h.counts, h.count, q) \
            == jreg.percentile_from_counts(h.bounds, h.counts, h.count, q)
    assert treg.DEFAULT_MS_BUCKETS == jreg.DEFAULT_MS_BUCKETS
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot()


def _catalog(reg):
    out = {}
    for name, m in reg.all_metrics().items():
        out[name] = (type(m).__name__,
                     list(m.bounds) if hasattr(m, "bounds") else None)
    return out


def test_the_metric_catalog_equals_jax():
    t, j = _catalog(treg.get_registry()), _catalog(jreg.get_registry())
    # every ds_* series of the JAX catalog, with its kind and buckets
    assert {n: v for n, v in t.items() if n.startswith("ds_")} == {
        n: v for n, v in j.items() if n.startswith("ds_")}
    names = [n for n in dir(jtm) if n.isupper()]
    assert names == [n for n in dir(ttm) if n.isupper()]
    for n in names:
        tj, tt = getattr(jtm, n), getattr(ttm, n)
        if hasattr(tj, "name"):
            assert (tt.name, type(tt).__name__) == (tj.name,
                                                    type(tj).__name__)
    assert {"ds_pool_routed_total", "ds_disagg_handoffs_total",
            "ds_fastgen_spec_drafted_total"} <= set(t)


def _record(fr_mod, tracer_mod, tel):
    tel.enable()
    fr = fr_mod.FlightRecorder(capacity=8)
    tracer_mod.get_tracer().set_step(3)
    for i in range(10):
        fr.record("request.admit", uid=i, prompt_tokens=5 * i)
    fr.record("pool.replica_death", label="r0", reason="killed", inflight=2)
    fr.set_config("inference_v2", {"serving": {"role": "prefill"}})
    return fr


def test_flight_recorder_events_and_dump_equal_jax(tmp_path):
    t = _record(tfr, ttracer, ttel)
    j = _record(jfr, jtracer, jtel)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}  # noqa
                         for e in evs]
    assert strip(t.events()) == strip(j.events())
    assert len(t.events()) == 8                    # the ring's capacity
    assert tfr.EVENT_KINDS == jfr.EVENT_KINDS
    tp = t.dump_postmortem(str(tmp_path / "t"))
    jp = j.dump_postmortem(str(tmp_path / "j"))
    # each package adds the memory ledger's artifact once an engine of it
    # armed the ledger, and the ring's while its sampler runs
    optional = {"memory.json", "timeseries.json"}
    assert set(tp) - optional == set(jp) - optional
    assert ("memory.json" in tp) == tmemory.get_memory_ledger().armed
    assert ("timeseries.json" in tp) == bool(
        ttimeseries.get_timeseries().active
        and ttimeseries.get_timeseries().samples())
    for name in ("events.json", "config.json"):
        a, b = (json.load(open(p[name])) for p in (tp, jp))
        if name == "events.json":
            a, b = strip(a["events"]), strip(b["events"])
        assert a == b
    tenv, jenv = (json.load(open(p["env.json"])) for p in (tp, jp))
    assert set(tenv) - {"torch"} == set(jenv) - {"jax"}
    assert set(tenv["health"]) == set(jenv["health"])
    assert tenv["health"]["watchdog_enabled"] \
        == jenv["health"]["watchdog_enabled"] is True
    with open(tp["trace.json"]) as f:
        assert "traceEvents" in json.load(f)
    ttel.disable()
    t.record("request.admit", uid=99)              # off: recorded nothing
    assert t.events()[-1]["kind"] == "pool.replica_death"


def test_set_component_is_per_thread():
    for tracer_mod, tel in ((ttracer, ttel), (jtracer, jtel)):
        tel.enable()
        tracer_mod.get_tracer().clear()
        seen = {}

        def work(label):
            tracer_mod.set_component(label)
            with tracer_mod.trace_span("unit", {"k": 1}):
                pass
            seen[label] = tracer_mod.current_component()

        threads = [threading.Thread(target=work, args=(f"r{i}",))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
            assert not th.is_alive()
        assert seen == {f"r{i}": f"r{i}" for i in range(4)}
        assert tracer_mod.current_component() == ""
        comps = sorted(r[5]["component"]
                       for r in tracer_mod.get_tracer().records())
        assert comps == [f"r{i}" for i in range(4)]


def test_a_span_is_a_record_function_in_the_port():
    ttel.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttracer.trace_span("fastgen.unit_span"):
            torch.ones(4).sum()
    assert "fastgen.unit_span" in {e.key for e in prof.key_averages()}
    rec = ttracer.get_tracer().records()[-1]
    assert rec[0] == "fastgen.unit_span" and rec[2] >= 0.0
    ttel.disable()
    assert ttracer.trace_span("off") is ttracer._NULL_SPAN


def test_fault_injection_fires_at_jax_ordinals():
    spec = "serving.preempt:p=0.3,max=4;kv.alloc_oom:at=2|5"
    assert tfi.parse_chaos_env(spec) == jfi.parse_chaos_env(spec)
    fires = {}
    for mod in (tfi, jfi):
        inj = mod.FaultInjector()
        inj.configure(mod.parse_chaos_env(spec), seed=11)
        fires[mod] = [(inj.fire("serving.preempt"), inj.fire("kv.alloc_oom"))
                      for _ in range(40)]
        assert inj.stats()["serving.preempt"]["fires"] == 4
        with pytest.raises(mod.InjectedPreemptionFault):
            inj.configure({"serving.preempt": {"p": 1.0}})
            inj.maybe_raise("serving.preempt", mod.InjectedPreemptionFault)
        with pytest.raises(ValueError, match="unknown fault-injection site"):
            inj.configure({"serving.nope": {}})
        inj.disarm()
        assert not inj.fire("serving.preempt")
    assert fires[tfi] == fires[jfi]


def test_the_telemetry_config_serves_the_core_and_names_what_waits():
    wd, ts = ttel.get_watchdog(), ttel.get_timeseries()
    fed, ev = ttel.get_federation(), ttel.get_slo_evaluator()
    # taken before the first apply(), which points the watchdog's dumps
    # at "pm" too: restored, later tests in this process dump nowhere
    saved = (wd.enabled, wd.threshold, wd.warmup, wd.postmortem_dir)
    cfg = T.TelemetryConfig(enabled=True, trace_buffer=128,
                            flight_recorder_events=16, postmortem_dir="pm")
    cfg.apply()
    assert ttel.enabled() and ttel.get_tracer()._cap == 128
    assert tfr.get_flight_recorder().postmortem_dir == "pm"
    tfr.get_flight_recorder().postmortem_dir = ""
    ttel.get_tracer().resize(ttracer.DEFAULT_CAPACITY)
    tfr.get_flight_recorder().resize(tfr.DEFAULT_EVENT_CAPACITY)
    # every other field configures the component it names
    try:
        T.TelemetryConfig(watchdog=False, watchdog_threshold=5.0,
                          watchdog_warmup=3).apply()
        assert (wd.enabled, wd.threshold, wd.warmup) == (False, 5.0, 3)
        T.TelemetryConfig(timeseries_interval_s=60.0,
                          timeseries_retention_s=600.0).apply()
        assert ts.active and ts._interval_s == 60.0 and ts._cap == 11
        T.TelemetryConfig(fleet_targets="a=127.0.0.1:1,127.0.0.1:2").apply()
        assert fed.labels() == ["a", "r1"]
        T.TelemetryConfig(slo_objectives=[{
            "name": "x", "kind": "latency", "hist": "ds_fastgen_ttft_ms",
            "threshold_ms": 500}]).apply()
        assert ev.configured and ev.current()["status"] == "ok"
        T.TelemetryConfig(metrics_port=-1).apply()
        wd.reset()      # no anomaly storm left by an earlier test (503)
        port = ttel.server.bound_port()
        assert port > 0 and ttm.TELEMETRY_PORT.value == port
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
            assert json.loads(r.read())["slo"]["configured"]
    finally:
        ttel.stop_http_server()
        ts.disable()
        fed.clear()
        ev.reset()
        wd.enabled, wd.threshold, wd.warmup, wd.postmortem_dir = saved
    cfg = T.RaggedInferenceEngineConfig.from_dict({"fault_injection": {
        "enabled": True, "seed": 3, "sites": {"kv.alloc_oom": {"at": "2"}}}})
    assert (cfg.fault_injection.enabled, cfg.fault_injection.seed) \
        == (True, 3)


# ---------------------------------------------------------------------------
# journeys: the same traffic gives the same stages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return {J: (model_def.cfg, params), T: (tcfg, tparams)}


def _engine(pkg, weights, role="both"):
    cfg, params = weights[pkg]
    kv = dict(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
              head_dim=cfg.dims_per_head, page_size=PAGE, num_pages=64)
    econf = pkg.RaggedInferenceEngineConfig(
        state_manager=pkg.StateManagerConfig(
            max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=256),
        serving=pkg.ServingOptimizationConfig(role=role,
                                              keyed_sampling=True))
    if pkg is J:
        model = J.RaggedInferenceModel(cfg, params, kv_config=J.KVCacheConfig(
            dtype=jnp.float32, **kv))
    else:
        model = T.RaggedInferenceModel(cfg, params, kv_config=T.KVCacheConfig(
            dtype=torch.float32, **kv), device="cpu")
    return pkg.InferenceEngineV2(model, econf)


def _sched(pkg, eng):
    if pkg is J:
        return J.FastGenScheduler(eng, rng=jax.random.key(SEED))
    return T.FastGenScheduler(eng, seed=SEED)


def _traffic(pkg):
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 128, 32)
    return [(0, np.concatenate([shared, rng.integers(0, 128, 7)]),
             pkg.SamplingParams(max_new_tokens=6)),
            (1, rng.integers(0, 128, 21),
             pkg.SamplingParams(max_new_tokens=4, temperature=0.8)),
            (2, np.concatenate([shared, rng.integers(0, 128, 3)]),
             pkg.SamplingParams(max_new_tokens=5)),
            (3, rng.integers(0, 128, 9),
             pkg.SamplingParams(max_new_tokens=3))]


def _stages(log):
    return {r["uid"]: ([s["seg"] for s in r["segments"]], r["outcome"])
            for r in log.completed()}


def _serve(pkg, weights, disagg):
    tel, jlog = (jtel, jjourney) if pkg is J else (ttel, tjourney)
    tel.enable()
    jlog.get_journey_log().clear()
    if disagg:
        mod = JS if pkg is J else TS
        pool = mod.DisaggPool(
            lambda: _sched(pkg, _engine(pkg, weights, "prefill")),
            lambda: _sched(pkg, _engine(pkg, weights, "decode")),
            handoff_every=1)
        for uid, prompt, params in _traffic(pkg):
            pool.submit(uid, prompt, params)
        pool.run_to_completion()
    else:
        sched = _sched(pkg, _engine(pkg, weights))
        for uid, prompt, params in _traffic(pkg):
            sched.submit(uid, prompt, params)
        sched.run_to_completion()
    log = jlog.get_journey_log()
    recs = log.completed()
    assert len(recs) == 4 and not log.orphans()
    for r in recs:
        assert jlog.chain_gaps(r, eps_ms=5.0) == []
    return _stages(log), sorted(f["uid"] for f in log.fragments())


@pytest.mark.parametrize("disagg", [False, True], ids=["fused", "disagg"])
def test_journeys_have_jax_stages(weights, disagg):
    got = _serve(T, weights, disagg)
    assert got == _serve(J, weights, disagg)
    stages, fragments = got
    if disagg:
        assert fragments == [0, 1, 2, 3]
        assert all({"handoff_export", "handoff_transfer", "handoff_import",
                    "placement"} <= set(s) for s, _ in stages.values())
    else:
        assert stages[0][0][:3] == ["queue_wait", "prefill", "first_token"]
    assert {o for _, o in stages.values()} == {"ok"}
