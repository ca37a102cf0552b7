"""The port's observatory modules held against the JAX package's.

``telemetry/watchdog.py``, ``timeseries.py``, ``slo.py``,
``federation.py`` and ``memory.py`` are plain Python in both packages.
The same seeded sequences go into a fresh instance of each and the
outputs are compared, sampled at explicit ``t=`` and under one fake
clock patched into both modules, never on the wall clock:

- the watchdog: anomalies, ``health()`` (but its uptime), goodput
  fractions and step-cache counts: equal;
- ``TimeSeries``: counter deltas and rates, gauge series and windowed
  histogram percentiles: equal to a relative 1e-12;
- ``SLOEvaluator``: every kind's burns, status sequence, advice and
  flight events: equal;
- ``Federation`` over two in-process registries: merged counts exact
  (equal to the sum of the parts, bucket by bucket), replica rates, and
  the stale flags as the fake clock passes ``stale_after_s``;
- ``MemoryLedger.breakdown()`` over the same accountants (but the
  measured bytes and their source, each package's own process probe);
- ``slo._normalize``'s refusals: the same exception type and message.
"""

import types

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.telemetry import federation as jfed
from deepspeed_tpu.telemetry import flight_recorder as jfr
from deepspeed_tpu.telemetry import memory as jmem
from deepspeed_tpu.telemetry import metrics as jtm
from deepspeed_tpu.telemetry import registry as jreg
from deepspeed_tpu.telemetry import slo as jslo
from deepspeed_tpu.telemetry import timeseries as jts
from deepspeed_tpu.telemetry import tracer as jtr
from deepspeed_tpu.telemetry import watchdog as jwd
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.telemetry import federation as tfed
from deepspeed_tpu_torch.telemetry import flight_recorder as tfr
from deepspeed_tpu_torch.telemetry import memory as tmem
from deepspeed_tpu_torch.telemetry import metrics as ttm
from deepspeed_tpu_torch.telemetry import registry as treg
from deepspeed_tpu_torch.telemetry import slo as tslo
from deepspeed_tpu_torch.telemetry import timeseries as tts
from deepspeed_tpu_torch.telemetry import tracer as ttr
from deepspeed_tpu_torch.telemetry import watchdog as twd

PORT = dict(tel=ttel, wd=twd, ts=tts, slo=tslo, fed=tfed, mem=tmem,
            reg=treg, tm=ttm, fr=tfr, tr=ttr)
JAX = dict(tel=jtel, wd=jwd, ts=jts, slo=jslo, fed=jfed, mem=jmem,
           reg=jreg, tm=jtm, fr=jfr, tr=jtr)
REL = 1e-12


class FakeClock:
    """One clock for ``time.monotonic``, ``time.perf_counter`` and
    ``time.time`` of a module (its ``time`` attribute is replaced)."""

    def __init__(self, t=1000.0):
        self.t = t

    def ns(self):
        return types.SimpleNamespace(monotonic=lambda: self.t,
                                     perf_counter=lambda: self.t,
                                     time=lambda: self.t)


@pytest.fixture(autouse=True)
def _hygiene():
    """Telemetry on in both packages for the test, with empty flight
    recorders and journey logs and no component label on this thread (a
    replica pool stepped earlier in the process leaves its replica's);
    off again after, the flight recorders and the process registries
    emptied."""
    torch.set_num_threads(1)
    for p in (PORT, JAX):
        p["tr"].set_component("")
        p["fr"].get_flight_recorder().clear()
        # a latency page names the dominant segment of the journeys
        # this process recorded: none, in both packages
        p["tel"].get_journey_log().clear()
        p["tel"].enable()
    yield
    for p in (PORT, JAX):
        p["tel"].disable()
        p["fr"].get_flight_recorder().clear()
        p["reg"].get_registry().reset()


def _events(pkg, prefix):
    return [{k: v for k, v in e.items() if k not in ("ts", "step")}
            for e in pkg["fr"].get_flight_recorder().events()
            if e["kind"].startswith(prefix)]


def test_watchdog_verdicts_equal_jax(monkeypatch):
    rng = np.random.default_rng(3)
    times = np.concatenate([rng.normal(20.0, 1.0, 30), [95.0, 110.0],
                            rng.normal(20.0, 1.0, 12), [400.0],
                            rng.normal(20.0, 1.0, 10)]).tolist()
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        clock = FakeClock()
        monkeypatch.setattr(p["wd"], "time", clock.ns())
        wd = p["wd"].Watchdog()
        wd.postmortem_dir = ""
        anomaly0 = p["tm"].TRAIN_ANOMALY.value
        hits0 = p["tm"].FASTGEN_STEP_CACHE_HIT.value
        miss0 = p["tm"].FASTGEN_STEP_CACHE_MISS.value
        onpath0 = p["tm"].FASTGEN_COMPILE_ON_PATH.value
        for i, ms in enumerate(times):
            wd.observe_step_time("fastgen", ms, step=i)
            clock.t += ms / 1e3
            wd.note_phase("step", ms / 1e3)
            if i % 7 == 0:
                wd.note_phase("input_wait", 0.004)
            wd.note_step_cache(hit=i % 5 != 0, key=(1, i % 3, 8, False),
                               compiled_on_path=i % 10 == 0)
        wd.observe_resident_bytes(1 << 30)
        health = wd.health()
        health.pop("uptime_s")
        out[name] = dict(
            health=health, goodput=wd.goodput(),
            anomalies=p["tm"].TRAIN_ANOMALY.value - anomaly0,
            cache=(p["tm"].FASTGEN_STEP_CACHE_HIT.value - hits0,
                   p["tm"].FASTGEN_STEP_CACHE_MISS.value - miss0,
                   p["tm"].FASTGEN_COMPILE_ON_PATH.value - onpath0),
            events=_events(p, "watchdog."))
    port, jax_ = out["port"], out["jax"]
    # the health document's counter fields are process-wide totals
    for key in ("anomaly_total", "step_cache", "nonfinite_total",
                "overflow_skip_total"):
        port["health"].pop(key)
        jax_["health"].pop(key)
    assert port == jax_
    assert port["anomalies"] == 3                  # 95, 110 and 400 ms
    assert port["health"]["step_time"]["fastgen"]["anomalies"] == 3
    assert port["cache"] == (44, 11, 6)
    assert sum(e["kind"] == "watchdog.anomaly" for e in port["events"]) == 3
    assert 0.9 < port["goodput"]["goodput_ratio"] <= 1.0


def _series_registry(reg_mod, rng_seed):
    """A registry and the steps that advance it: counters, a gauge and a
    histogram fed seeded values between samples."""
    r = reg_mod.MetricsRegistry()
    c = r.counter("ds_fastgen_tokens_total")
    bad = r.counter("ds_fastgen_shed_total")
    g = r.gauge("ds_mem_headroom_seqs")
    h = r.histogram("ds_fastgen_ttft_ms")
    rng = np.random.default_rng(rng_seed)

    def advance(k):
        c.inc(int(rng.integers(50, 150)))
        if k % 4 == 3:
            bad.inc(int(rng.integers(0, 5)))
        g.set(float(max(0, 12 - k)))
        for v in rng.lognormal(4.0, 1.0, 20):
            h.observe(float(v))
        if k == 12:
            c.reset()      # a measured-window reset inside the ring

    return r, advance


def _approx(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _approx(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _approx(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=0.0)
    else:
        assert a == b


def test_timeseries_windows_equal_jax():
    reads = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        reg, advance = _series_registry(p["reg"], 11)
        ts = p["ts"].TimeSeries(source=reg.raw_snapshot)
        ts.configure(interval_s=1.0, retention_s=20.0)
        got = []
        for k in range(30):
            advance(k)
            ts.sample_now(t=100.0 + k * 1.25)
            w = ts.hist_window("ds_fastgen_ttft_ms", 6.0)
            got.append(dict(
                rate=ts.counter_rate("ds_fastgen_tokens_total", 5.0),
                delta=ts.counter_delta("ds_fastgen_shed_total", 10.0),
                gauge=ts.gauge_series("ds_mem_headroom_seqs", 4.0),
                p=[w.percentile(q) for q in (50, 90, 99)] if w else None,
                frac=w.frac_above(150.0) if w else None,
                mean=w.mean if w else None))
        got.append(ts.window_snapshot(8.0))
        doc = ts.to_json()
        got.append([s["counters"] for s in doc["samples"]])
        got.append(doc["capacity"])
        reads[name] = got
    _approx(reads["port"], reads["jax"])
    assert reads["port"][-1] == 21                 # 20 s / 1 s + 1
    assert reads["port"][5]["p"] is not None


OBJECTIVES = [
    {"name": "ttft", "kind": "latency", "hist": "ds_fastgen_ttft_ms",
     "threshold_ms": 120.0, "fast_window_s": 5.0, "slow_window_s": 10.0},
    {"name": "shed", "kind": "ratio", "bad": "ds_fastgen_shed_total",
     "total": "ds_fastgen_tokens_total", "fast_window_s": 5.0,
     "slow_window_s": 10.0},
    {"name": "goodput", "kind": "throughput_min",
     "counter": "ds_fastgen_tokens_total", "min_per_s": 80.0,
     "scale_down_below_per_s": 400.0, "fast_window_s": 3.0,
     "slow_window_s": 6.0},
    {"name": "cap", "kind": "capacity", "min_headroom_seqs": 4,
     "fast_window_s": 5.0, "slow_window_s": 10.0},
    {"name": "hot", "kind": "balance", "counter": "ds_fastgen_tokens_total",
     "max_ratio": 1.5},
]


def test_slo_burns_statuses_and_advice_equal_jax(monkeypatch):
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        clock = FakeClock()
        monkeypatch.setattr(p["fed"], "time", clock.ns())
        reg, advance = _series_registry(p["reg"], 5)
        peer = p["reg"].MetricsRegistry()
        peer_tokens = peer.counter("ds_fastgen_tokens_total")
        fed = p["fed"].Federation()
        fed.add_registry("a", reg)
        fed.add_registry("b", peer)
        ts = p["ts"].TimeSeries(source=reg.raw_snapshot)
        ts.configure(interval_s=1.0, retention_s=60.0)
        ev = p["slo"].SLOEvaluator()
        ev.configure(OBJECTIVES)
        ev.attach(timeseries=ts, federation=fed)
        verdicts = []
        for k in range(40):
            advance(k)
            peer_tokens.inc(30 if k < 20 else 120)
            clock.t += 1.0
            fed.scrape()
            ts.sample_now(t=100.0 + k)      # the evaluator rides the hook
            verdicts.append(ev.current())
        out[name] = dict(verdicts=verdicts, events=_events(p, "slo."))
    assert out["port"] == out["jax"]
    seen = {(v["objective"], v["status"])
            for c in out["port"]["verdicts"]
            for v in c["objectives"].values()}
    assert {("ttft", "page"), ("cap", "page"), ("hot", "page")} <= seen
    assert any(e["kind"] == "slo.advice" for e in out["port"]["events"])


def test_federation_merge_and_staleness_equal_jax(monkeypatch):
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        clock = FakeClock()
        monkeypatch.setattr(p["fed"], "time", clock.ns())
        regs = []
        for seed in (1, 2):
            reg, advance = _series_registry(p["reg"], seed)
            for k in range(5):
                advance(k)
            regs.append((reg, advance))
        fed = p["fed"].Federation(stale_after_s=5.0)
        fed.add_registry("r0", regs[0][0])
        fed.add_registry("r1", regs[1][0])
        views = [fed.scrape()]
        clock.t += 2.0
        regs[0][1](5)
        regs[1][1](5)
        views.append(fed.scrape())
        rates = fed.replica_rates("ds_fastgen_tokens_total")
        # r1 stops answering: its last good snapshot stays in the merge
        fed._replicas["r1"].registry = None
        fed._replicas["r1"].url = "http://127.0.0.1:1"
        clock.t += 4.0
        views.append(fed.scrape())
        clock.t += 2.0
        views.append(fed.scrape())
        for v in views:
            v.pop("unix")
            for rep in v["replicas"].values():
                rep.pop("error")
        parts = [r.raw_snapshot() for r, _ in regs]
        out[name] = dict(views=views, rates=rates, parts=parts,
                         text=fed.prometheus_text())
    port, jax_ = out["port"], out["jax"]
    assert port == jax_
    merged = port["views"][1]["hists"]["ds_fastgen_ttft_ms"]
    parts = [p["hists"]["ds_fastgen_ttft_ms"] for p in port["parts"]]
    assert merged["counts"] == [a + b for a, b in
                                zip(parts[0]["counts"], parts[1]["counts"])]
    assert merged["count"] == parts[0]["count"] + parts[1]["count"]
    assert [(v["live"], v["stale"]) for v in port["views"]] \
        == [(2, 0), (2, 0), (2, 0), (1, 1)]
    assert port["views"][3]["replicas"]["r1"]["stale"]
    assert ttm.FLEET_REPLICAS_STALE.value == jtm.FLEET_REPLICAS_STALE.value


class _Owner:
    pass


def test_memory_ledger_breakdown_equal_jax(monkeypatch):
    out = {}
    for name, p in (("port", PORT), ("jax", JAX)):
        led = p["mem"].MemoryLedger()
        monkeypatch.setattr(p["mem"], "_telemetry_ring_bytes", lambda: 4096)
        owner, gone = _Owner(), _Owner()
        led.register("weights", lambda: 3 << 30)
        led.register_object("kv_pages", owner, lambda o: 1 << 30)
        led.register_object("draft_kv", gone, lambda o: 7 << 20)
        led.register("offload", lambda: 5 << 20)
        led.register("tier_host", lambda: 9 << 20)
        led.register("custom", lambda: 123, device=True)
        led.sample()
        del gone
        led.register("offload", lambda: 2 << 20)    # newest owner wins
        bd = led.breakdown()
        for key in ("measured_bytes", "measured_source",
                    "unaccounted_bytes"):
            bd.pop(key)
        out[name] = dict(bd=bd, device=led.device_accounted_bytes(),
                         accounted=led.accounted_bytes(),
                         armed=led.armed)
    assert out["port"] == out["jax"]
    bd = out["port"]["bd"]
    assert bd["dominant"] == "weights" and bd["subsystems"]["draft_kv"] == 0
    assert bd["peaks"]["draft_kv"] == 7 << 20 and bd["peaks"]["offload"] \
        == 5 << 20


BAD_SPECS = [
    {"name": "x", "kind": "p99"},
    {"kind": "latency", "hist": "h", "threshold_ms": 1},
    {"name": "x", "kind": "latency", "hist": "h"},
    {"name": "x", "kind": "ratio", "bad": "b"},
    {"name": "x", "kind": "throughput_min", "counter": "c"},
    {"name": "x", "kind": "balance"},
    {"name": "x", "kind": "capacity"},
    {"name": "x", "kind": "ratio", "bad": "b", "total": "t", "budget": 0},
    {"name": "x", "kind": "capacity", "min_headroom_seqs": 0},
    {"name": "x", "kind": "throughput_min", "counter": "c",
     "min_per_s": 0},
    {"name": "x", "kind": "balance", "counter": "c", "max_ratio": -1},
]


@pytest.mark.parametrize("spec", BAD_SPECS,
                         ids=[str(i) for i in range(len(BAD_SPECS))])
def test_normalize_refuses_as_jax(spec):
    errors = []
    for mod in (tslo, jslo):
        with pytest.raises(Exception) as info:
            mod._normalize(spec)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] is ValueError


def test_normalize_defaults_equal_jax():
    for spec in OBJECTIVES:
        assert tslo._normalize(spec) == jslo._normalize(spec)
