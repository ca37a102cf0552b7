"""The serving path's telemetry sites, held against the JAX package's.

The debug Llama (fp32, the JAX tree bridged through ``from_jax``) serves
the same traffic through the JAX scheduler and the port's, stepped
together (``test_torch_serving.serve_in_lockstep``: the same ``{uid:
token}`` at every step).  Exact, no tolerance:

- ``serving_counters.snapshot()`` and every ``ds_serving_*`` counter
  (programs, steps, host-to-device and device-to-host bytes, logits
  bytes, prefix lookups / hits / evictions, prefill tokens) in four
  serving configurations, and the step-cache hit and miss counts;
- under one fault spec, ``fastgen.poison_request`` fails the same uid
  with ``"poisoned"`` and the other requests' tokens stay equal, and
  ``kv.alloc_oom`` climbs the same ladder rungs and leaves
  ``mem.breakdown`` events with the same subsystems and ``dominant``;
- the memory ledger's weights, ``kv_pages``, ``draft_kv`` and
  ``offload`` bytes, and ``engine.headroom()``;
- both metrics servers up in one process on ephemeral ports:
  ``/snapshot?digests=1`` equal, ``/healthz`` and ``/memory`` with the
  same keys, the ``ds_serving_*`` counters of ``/snapshot?raw=1`` equal.
  Fields that may differ between the packages: timing histograms' and
  step-time values, uptimes, the ledger's measured bytes and their
  source (``"live_arrays"`` in JAX on the CPU, ``"rss"`` in the port),
  and the ``telemetry`` accountant (each package's own rings).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.runtime import fault_injection as jfi
from deepspeed_tpu.telemetry import memory as jmem
from deepspeed_tpu.telemetry import metrics as jtm
from deepspeed_tpu.telemetry import server as jserver
from deepspeed_tpu.utils import comms_logging as jcl
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.runtime import fault_injection as tfi
from deepspeed_tpu_torch.telemetry import memory as tmem
from deepspeed_tpu_torch.telemetry import metrics as ttm
from deepspeed_tpu_torch.telemetry import server as tserver
from deepspeed_tpu_torch.utils import comms_logging as tcl
from test_torch_serving import (_jax_engine, _port_engine,
                                _shared_prefix_traffic, serve_in_lockstep,
                                weights)  # noqa: F401  (the fixture)

PKGS = ((jtel, jfi, jmem, jtm, jcl), (ttel, tfi, tmem, ttm, tcl))
SERVING_COUNTERS = ("SERVING_PROGRAMS", "SERVING_STEPS", "SERVING_H2D_BYTES",
                    "SERVING_D2H_BYTES", "SERVING_LOGITS_BYTES",
                    "SERVING_PREFIX_LOOKUP_TOKENS",
                    "SERVING_PREFIX_HIT_TOKENS",
                    "SERVING_PREFIX_EVICTED_PAGES", "SERVING_PREFILL_TOKENS")
CACHE_COUNTERS = ("FASTGEN_STEP_CACHE_HIT", "FASTGEN_STEP_CACHE_MISS",
                  "FASTGEN_COMPILE_ON_PATH")


def _clean():
    for tel, fi, mem, tm, cl in PKGS:
        fi.get_fault_injector().disarm()
        tel.disable()
        tel.get_tracer().clear()
        tel.get_flight_recorder().clear()
        tel.get_watchdog().reset()
        mem.get_memory_ledger().reset()
        cl.serving_counters.reset()
        # every counter and histogram: a suite that served with
        # telemetry on earlier in this process, in one package only,
        # leaves its TTFT counts behind
        tm.registry.reset()


@pytest.fixture(autouse=True)
def _hygiene():
    """Both packages start and end with telemetry off, disarmed
    injectors, empty ledgers and rings, and zeroed registries and
    serving counters; the watchdogs' thresholds are restored after."""
    torch.set_num_threads(1)
    thresholds = [tel.get_watchdog().threshold for tel, *_ in PKGS]
    _clean()
    yield
    _clean()
    for (tel, *_), threshold in zip(PKGS, thresholds):
        tel.get_watchdog().threshold = threshold
    jtel.stop_http_server()
    ttel.stop_http_server()


def _submit_both(jsched, tsched, prompts, new):
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))


def _serve(weights, traffic=None, **serving):
    jcfg, jparams, tcfg, tparams = weights
    jeng = _jax_engine(jcfg, jparams, **serving)
    teng = _port_engine(tcfg, tparams, **serving)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    prompts, new = traffic or _shared_prefix_traffic(
        np.random.default_rng(4))
    _submit_both(jsched, tsched, prompts, new)
    tokens, _ = serve_in_lockstep(jsched, tsched, jeng, teng)
    return jeng, teng, jsched, tsched, tokens


def _loopy_traffic():
    """Repetitive prompts the n-gram drafter drafts from."""
    rng = np.random.default_rng(9)
    motif = rng.integers(0, 128, 6)
    return ([np.tile(motif, 5), rng.integers(0, 128, 20),
             np.tile(motif[:4], 6)], [14, 9, 12])


@pytest.mark.parametrize("config", ["default", "sync", "split", "spec"])
def test_serving_counters_equal_jax(weights, config):
    """The witness of the ds_serving_* repair: before it the port's
    counters read 0 after any traffic."""
    serving = {"default": {},
               "sync": dict(async_scheduling=False, prefix_caching=False),
               "split": dict(fused_step=False),
               "spec": dict(speculative=True, prefix_caching=False)}[config]
    traffic = _loopy_traffic() if config == "spec" else None
    _serve(weights, traffic, **serving)
    snap = tcl.serving_counters.snapshot()
    assert snap == jcl.serving_counters.snapshot()
    for name in SERVING_COUNTERS + CACHE_COUNTERS:
        assert getattr(ttm, name).value == getattr(jtm, name).value, name
    assert snap["steps"] > 0 and snap["programs"] > 0
    assert ttm.SERVING_D2H_BYTES.value > 0
    assert ttm.SERVING_H2D_BYTES.value > 0
    assert ttm.FASTGEN_STEP_CACHE_MISS.value > 0
    assert ttm.FASTGEN_STEP_CACHE_HIT.value > 0
    if config == "default":
        assert snap["prefix_hit_tokens"] > 0
    if config == "split":
        assert snap["logits_exposed_bytes_per_step"] > 0


def test_poisoned_request_fails_the_same_uid_in_both(weights):
    spec = tfi.parse_chaos_env("fastgen.poison_request:at=4")
    assert spec == jfi.parse_chaos_env("fastgen.poison_request:at=4")
    for fi in (jfi, tfi):
        fi.get_fault_injector().configure(spec, seed=0)
    errors0 = (ttm.FASTGEN_REQUEST_ERROR.value,
               jtm.FASTGEN_REQUEST_ERROR.value)
    jeng, teng, jsched, tsched, tokens = _serve(weights)
    verdicts = {u: (e.code, e.tokens) for u, e in tsched.errors.items()}
    assert verdicts == {u: (e.code, list(map(int, e.tokens)))
                        for u, e in jsched.errors.items()}
    assert [c for c, _ in verdicts.values()] == ["poisoned"]
    (uid,) = verdicts
    prompts, new = _shared_prefix_traffic(np.random.default_rng(4))
    assert all(len(tokens[u]) == n for u, n in enumerate(new) if u != uid)
    assert ttm.FASTGEN_REQUEST_ERROR.value - errors0[0] \
        == jtm.FASTGEN_REQUEST_ERROR.value - errors0[1] == 1


def test_alloc_oom_climbs_the_same_rungs(weights):
    spec = {"kv.alloc_oom": {"at": "2|3|4|5"}}
    for tel, fi, *_ in PKGS:
        fi.get_fault_injector().configure(spec, seed=0)
        tel.enable()
    jeng, teng, jsched, tsched, tokens = _serve(weights)

    def breakdowns(tel):
        return [e for e in tel.get_flight_recorder().events()
                if e["kind"] == "mem.breakdown"]

    jev, tev = breakdowns(jtel), breakdowns(ttel)
    assert len(tev) == len(jev) == 4
    for t, j in zip(tev, jev):
        assert (t["trigger"], t["streak"], t["dominant"], t["rungs"]) \
            == (j["trigger"], j["streak"], j["dominant"], j["rungs"])
        assert set(t["subsystems"]) == set(j["subsystems"])
    assert tev[-1]["dominant"] in ("weights", "kv_pages")
    assert {r["lever"] for r in tev[-1]["rungs"]} \
        >= {"preempt_largest", "shed_request"}
    assert {u: e.code for u, e in tsched.errors.items()} \
        == {u: e.code for u, e in jsched.errors.items()}


def test_accountants_and_headroom_equal_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    draft = dict(speculative=True, spec_drafter="model",
                 spec_draft_layers=1, prefix_caching=True)
    jeng = _jax_engine(jcfg, jparams, **draft)
    teng = _port_engine(tcfg, tparams, **draft)
    led = {J: jmem.get_memory_ledger(), T: tmem.get_memory_ledger()}
    for name in ("weights", "kv_pages", "draft_kv", "offload"):
        assert led[T].read(name) == led[J].read(name), name
    assert led[T].read("draft_kv") > 0 and led[T].read("weights") > 0
    assert teng.headroom() == jeng.headroom()
    prompt = np.random.default_rng(2).integers(0, 128, 40)
    for eng in (jeng, teng):
        eng.put([7], [prompt])
        eng.put([8], [prompt[:21]])
        eng._pages_dist_cache = None    # the estimate is cached 10 s
    assert teng.headroom() == jeng.headroom()
    assert teng.headroom()["basis"] == "live"
    for eng in (jeng, teng):
        eng.offload_sequence(7)
        eng._pages_dist_cache = None
    assert led[T].read("offload") == led[J].read("offload") > 0
    assert teng.headroom() == jeng.headroom()
    bd = {p: led[p].breakdown() for p in (J, T)}
    for key in ("subsystems", "peaks"):
        assert set(bd[T][key]) == set(bd[J][key])
    assert bd[T]["dominant"] == bd[J]["dominant"]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, json.loads(r.read().decode())


def test_both_servers_answer_with_the_same_documents(weights):
    for tel, *_ in PKGS:
        tel.enable()
        # a step slowed by a loaded machine must not start an anomaly
        # storm (503) in one package and not the other
        tel.get_watchdog().threshold = 1e9
    jeng, teng, *_ = _serve(weights)
    ports = {J: jserver.start_http_server(0).server_address[1],
             T: tserver.start_http_server(0).server_address[1]}
    assert ports[J] != ports[T]
    docs = {p: {path: _get(port, path) for path in (
        "/snapshot?digests=1&top_k=8", "/healthz", "/memory?json=1",
        "/snapshot?raw=1")} for p, port in ports.items()}
    dig = "/snapshot?digests=1&top_k=8"
    assert docs[T][dig] == docs[J][dig]
    assert docs[T][dig][1]["digests"] == teng.export_digests(8)
    assert len(docs[T][dig][1]["digests"]) > 0
    status, th = docs[T]["/healthz"]
    jstatus, jh = docs[J]["/healthz"]
    assert status == jstatus == 200
    assert set(th) == set(jh)
    for key in ("step_time", "memory_drift", "step_cache", "goodput",
                "slo"):
        assert set(th[key]) == set(jh[key]), key
    assert th["step_cache"] == jh["step_cache"]
    assert set(th["step_time"]["fastgen"]) == set(jh["step_time"]["fastgen"])
    assert th["step_time"]["fastgen"]["samples"] \
        == jh["step_time"]["fastgen"]["samples"]
    tm_doc, jm_doc = docs[T]["/memory?json=1"][1], docs[J]["/memory?json=1"][1]
    assert set(tm_doc) == set(jm_doc)
    for name in ("weights", "kv_pages", "draft_kv", "offload", "staging"):
        assert tm_doc["subsystems"][name] == jm_doc["subsystems"][name]
    assert tm_doc["headroom_seqs"] == jm_doc["headroom_seqs"]
    assert tm_doc["measured_source"] == "rss"
    traw, jraw = docs[T]["/snapshot?raw=1"][1], docs[J]["/snapshot?raw=1"][1]
    for name, v in jraw["counters"].items():
        if name.startswith("ds_serving_"):
            assert traw["counters"][name] == v, name
    assert set(traw["hists"]) == set(jraw["hists"])
    h, jh_ = traw["hists"]["ds_fastgen_ttft_ms"], jraw["hists"][
        "ds_fastgen_ttft_ms"]
    assert h["bounds"] == jh_["bounds"] and h["count"] == jh_["count"] > 0
