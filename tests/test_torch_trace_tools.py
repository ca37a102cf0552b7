"""The port's trace tools held against the JAX package's, on the CPU.

``analyze_trace.analyze`` and ``plan_capacity``'s ``mine_memory``,
``plan`` and ``_bytes_per_page`` on ``tools/traces/sample_200.jsonl``
equal the root tools' (every field but the free-text notes, which name
each package's own tools); ``gen_sample_trace --requests 8`` writes the
JAX tool's records but for the clock fields; the capacity plan's
``--validate --oom-smoke --check`` and ``analyze --emit-lattice`` run
clean on the CPU; and ``fleetctl``'s pool smoke serves the recorded
trace's lengths with one replica drain-migrated.
"""

import json
import os

import pytest
import torch

from deepspeed_tpu_torch.tools import analyze_trace as TA
from deepspeed_tpu_torch.tools import fleetctl
from deepspeed_tpu_torch.tools import gen_sample_trace as TG
from deepspeed_tpu_torch.tools import plan_capacity as TP
from deepspeed_tpu_torch.tools import replay_trace as TR
from tools import analyze_trace as JA
from tools import plan_capacity as JP
from tools import replay_trace as JR

SAMPLE = TR.SAMPLE_TRACE
#: the ledger fields a run's clock writes
CLOCK_FIELDS = ("arrival_s", "ttft_ms", "itl_ms", "queue_wait_ms",
                "time_unix", "t_s")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _without_notes(obj):
    """``obj`` with every ``note`` string replaced by whether it is set."""
    if isinstance(obj, dict):
        return {k: (v is not None if k == "note" else _without_notes(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_without_notes(v) for v in obj]
    return obj


@pytest.mark.parametrize("kw", [{}, {"max_concurrency": 8, "ratio": 1.5,
                                     "batch_size": 256}],
                         ids=["defaults", "narrow"])
def test_analyze_equals_the_jax_tools(kw):
    got = TA.analyze(TR.load_trace(SAMPLE), **kw)
    want = JA.analyze(JR.load_trace(SAMPLE), **kw)
    assert _without_notes(got) == _without_notes(want)
    # every key traffic formed is in the recommended precompile set
    rec = {tuple(k) for k in got["recommended_lattice"]["keys"]}
    assert {tuple(k) for k, _ in got["occupancy"]["keys"]} <= rec
    assert got["recommended_lattice"]["uncovered_on_path_compile_keys"] == []


@pytest.mark.parametrize("limit", [0, 20])
def test_memory_mining_and_the_plan_equal_the_jax_tools(limit):
    requests = [r for r in JR.load_trace(SAMPLE)["requests"]
                if r.get("outcome") == "ok"]
    if limit:
        requests = requests[:limit]
    mined = TP.mine_memory(requests, 16, concurrency=7)
    assert mined == JP.mine_memory(requests, 16, concurrency=7)
    for kv_pages, bpp, seqs in ((0, 0, 0), (512, 4096, 32), (64, 0, 4)):
        assert (TP.plan(mined, kv_pages, bytes_per_page=bpp, max_seqs=seqs)
                == JP.plan(mined, kv_pages, bytes_per_page=bpp,
                           max_seqs=seqs))
    # the page bytes follow the replay's dtype: fp32 on the CPU, as JAX's
    assert TP._bytes_per_page(16, device="cpu") == JP._bytes_per_page(16)
    assert TP._bytes_per_page(16, device="cuda") * 2 == \
        JP._bytes_per_page(16)
    got = TP.run_plan(SAMPLE, limit=limit, device="cpu")
    want = JP.run_plan(SAMPLE, limit=limit)
    for key in ("requests", "memory", "plan"):
        assert got[key] == want[key], key


def test_the_capacity_plan_validates_against_the_ledger(capsys):
    assert TP.main(["--trace", SAMPLE, "--limit", "20", "--validate",
                    "--oom-smoke", "--check", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    v, s = report["validate"], report["oom_smoke"]
    assert v["ok"] and s["ok"]
    assert v["live_capacity_seqs"] == v["predicted_capacity_seqs"]
    assert s["injected_fires"] == 1 and s["dominant"]


def test_emit_lattice_writes_the_mined_artifact(tmp_path, capsys):
    from deepspeed_tpu_torch.inference.v2 import lattice
    path = str(tmp_path / "lattice.json")
    assert TA.main(["--trace", SAMPLE, "--emit-lattice", path]) == 0
    report = json.loads(capsys.readouterr().out)
    art = lattice.load_artifact(path)
    assert report["emitted_lattice"]["keys"] == len(art["keys"]) > 0
    assert art == lattice.mine_lattice(TR.load_trace(SAMPLE), source=SAMPLE)


def _records(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            for k in CLOCK_FIELDS:
                rec.pop(k, None)
            out.append(rec)
    return out


def test_gen_sample_trace_writes_the_jax_tools_records(tmp_path,
                                                       monkeypatch):
    from tools import gen_sample_trace as JG
    # the JAX tool imports its sibling replay_trace as a top-level module
    monkeypatch.syspath_prepend(os.path.dirname(JR.__file__))
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert TG.main(["--out", ours, "--requests", "8", "--device", "cpu"]) == 0
    assert JG.main(["--out", theirs, "--requests", "8"]) == 0
    got, want = _records(ours), _records(theirs)
    assert got == want
    assert sum(r["kind"] == "request" for r in got) == 8


def test_gen_sample_trace_needs_an_out_path():
    with pytest.raises(SystemExit):
        TG.main(["--requests", "8"])


def test_the_pool_smoke_serves_the_recorded_lengths(capsys):
    engines = {}
    assert fleetctl.run_pool_smoke(limit=16, device="cpu",
                                   engines=engines) == 0
    assert "0 lost, exact generated-length parity" in capsys.readouterr().out
    assert set(engines) == {"r0", "r1"}
    assert all(e.model.cfg.dtype == torch.float32 for e in engines.values())
