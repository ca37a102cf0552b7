"""The fleet's subprocess mode on the CPU: two port replica processes.

``python -m deepspeed_tpu_torch.tools.fleet_replica --device cpu --model
debug`` twice (``fleetctl.ReplicaProc``): the handshake, a scrape of
both, the federation's merge equal to the sum of the parts (every
counter, and every histogram bucket by bucket), ``fetch_remote_hints``
equal to the digests each child printed of its own engine, a request
routed by those hints to the replica that served its prefix; then
``r1`` again under ``DS_CHAOS="serving.preempt:at=N"``: it exits with
status 17 and the federation flags it stale once its last good scrape
is older than ``stale_after_s``.  No assertion reads a rate or a
wall-clock window; the whole test holds itself to 120 s.
"""

import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.serving import PrefixAffinityRouter
from deepspeed_tpu_torch.serving.router import fetch_remote_hints
from deepspeed_tpu_torch.telemetry import metrics as tm
from deepspeed_tpu_torch.tools import fleetctl
from deepspeed_tpu_torch.tools.fleet_replica import (EXIT_PREEMPTED,
                                                     HINT_TOP_K,
                                                     synthetic_workload)

LIMIT_S = 120.0
PAGE, PROMPT = 16, 40
ARGS = ["--device", "cpu", "--model", "debug", "--rounds", "2",
        "--requests", "4", "--prompt-len", str(PROMPT), "--max-new", "8",
        "--page-size", str(PAGE), "--linger-s", "100"]
#: one thread per child: the suite runs beside other workers
ENV = {"OMP_NUM_THREADS": "1", "DS_CHAOS": ""}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def test_two_replica_processes_federate_route_and_die():
    t0 = time.monotonic()

    def left():
        return max(LIMIT_S - (time.monotonic() - t0), 1.0)

    reps = [fleetctl.ReplicaProc("r0", ARGS + ["--seed", "0"], ENV),
            fleetctl.ReplicaProc("r1", ARGS + ["--seed", "1"], ENV)]
    try:
        targets = [(r.label, r.port(timeout=left())) for r in reps]
        for r in reps:
            assert r.wait_line("FLEET_REPLICA done", left()), r.label
        stats = {r.label: r.report("stats") for r in reps}
        digests = {r.label: r.report("digests") for r in reps}
        assert all(s["device"] == "cpu" and s["path_captures"] > 0
                   for s in stats.values())

        # the exact merge: counters and histogram buckets are the sums
        fed = fleetctl._federation(targets, stale_after_s=1.0)
        parts = [fleetctl.fetch_raw(port) for _, port in targets]
        view = fed.scrape()
        assert (view["live"], view["stale"]) == (2, 0)
        assert tm.FLEET_REPLICAS_LIVE.value == 2
        for name, merged in view["counters"].items():
            assert merged == sum(p["counters"].get(name, 0)
                                 for p in parts), name
        ttft = view["hists"]["ds_fastgen_ttft_ms"]
        assert ttft["count"] == 2 * 2 * 4          # 2 replicas x 8 requests
        assert ttft["counts"] == [
            a + b for a, b in zip(*(p["hists"]["ds_fastgen_ttft_ms"]
                                    ["counts"] for p in parts))]
        assert view["counters"]["ds_serving_steps_total"] > 0

        # hints over HTTP are what each child printed of its engine
        router = PrefixAffinityRouter(PAGE, top_k=HINT_TOP_K)
        for label, port in targets:
            doc = fetch_remote_hints(f"127.0.0.1:{port}", top_k=HINT_TOP_K)
            assert doc["page_size"] == PAGE
            assert doc["digests"] == digests[label] and digests[label]
            router.publish(label, doc["digests"])
        work = synthetic_workload(128, 4, PROMPT, 0, seed=0, max_new=8)
        warm = np.asarray(work[2][0] + [5, 6, 7])
        decision = router.decide(warm, {"r0": 0, "r1": 0})
        assert (decision.label, decision.matched_pages) == ("r0", 2)

        # r1 again, killed through the fault site at its 12th step
        reps[1].terminate()
        r1 = fleetctl.ReplicaProc(
            "r1", ARGS + ["--seed", "1", "--step-sleep-s", "0.05",
                          "--rounds", "4"],
            dict(ENV, DS_CHAOS="serving.preempt:at=12"))
        reps[1] = r1
        fed.remove("r1")
        fed.add_http("r1", f"127.0.0.1:{r1.port(timeout=left())}")
        alive = fed.scrape()
        assert alive["replicas"]["r1"]["stale"] is False
        assert r1.proc.wait(timeout=left()) == EXIT_PREEMPTED
        assert r1.wait_line("FLEET_REPLICA preempted", 5.0)
        time.sleep(fed.stale_after_s + 0.2)
        dead = fed.scrape()
        assert dead["replicas"]["r1"]["stale"] is True
        assert dead["replicas"]["r1"]["error"]
        assert (dead["live"], dead["stale"]) == (1, 1)
        assert tm.FLEET_REPLICAS_STALE.value == 1
        # the last good snapshot of r1 stays in the merge
        assert dead["counters"]["ds_serving_steps_total"] >= \
            view["counters"]["ds_serving_steps_total"] - parts[1][
                "counters"]["ds_serving_steps_total"]
        assert router.decide(warm, {"r0": 0}).label == "r0"
        assert reps[0].proc.poll() is None
    finally:
        for r in reps:
            r.terminate()
    assert time.monotonic() - t0 < LIMIT_S
