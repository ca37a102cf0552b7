"""The port's trace replay tool held against the JAX package's, on the CPU.

``deepspeed_tpu_torch.tools.replay_trace`` against the root
``tools/replay_trace.py`` on the in-repo trace
``tools/traces/sample_200.jsonl``: the parsed trace, the anonymised
prompts (all 200 requests, two seeds) and both sharing signatures are
equal; then the first 10 ok requests replay without a warm-up on the
debug Llama in fp32 over the JAX tool's own weights (bridged with
``from_jax``): greedy rows equal at every token, every generated length
equal, ``diff_replay``'s structural block and the on-path capture count
equal to JAX's compiles.  The disaggregated replay runs keyed in both
packages and is held token for token, sampled rows included.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.tools import replay_trace as TR
from tools import replay_trace as JR

SAMPLE = TR.SAMPLE_TRACE
LIMIT = 10


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traces():
    return JR.load_trace(SAMPLE), TR.load_trace(SAMPLE)


@pytest.fixture(scope="module")
def workload(traces):
    """(meta, requests, JAX parts, prompts) of the first LIMIT ok
    requests."""
    jtrace, _ = traces
    requests = [r for r in jtrace["requests"]
                if r.get("outcome") == "ok"][:LIMIT]
    meta = jtrace["meta"]
    parts = JR._replay_model_parts(meta, requests)
    cfg = parts[0]
    vocab = min(int(meta["vocab_size"]), cfg.vocab_size)
    prompts = JR.synthesize_prompts(requests, parts[2], vocab)
    return meta, requests, parts, prompts


@pytest.fixture()
def jax_weights(workload, monkeypatch):
    """The port tool builds its engines over the JAX tool's weights."""
    jparams = jax.tree.map(np.asarray, workload[2][1])
    monkeypatch.setattr(TR, "_init_weights",
                        lambda cfg, device: from_jax(jparams, cfg,
                                                     device=device))


def _tokens():
    out = {}
    return out, (lambda u, t: out.setdefault(int(u), []).append(int(t)))


def test_the_trace_parses_to_the_jax_tools_facts(traces):
    jtrace, ttrace = traces
    assert ttrace == jtrace
    assert len(ttrace["requests"]) == 200


@pytest.mark.parametrize("seed", [0, 3])
def test_prompts_and_share_signatures_equal_the_jax_tools(traces, seed):
    jtrace, ttrace = traces
    page, vocab = 16, 128
    jp = JR.synthesize_prompts(jtrace["requests"], page, vocab, seed=seed)
    tp = TR.synthesize_prompts(ttrace["requests"], page, vocab, seed=seed)
    assert len(tp) == len(jp) == 200
    for a, b in zip(tp, jp):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (TR.share_signature_recorded(ttrace["requests"])
            == JR.share_signature_recorded(jtrace["requests"]))
    assert (TR.share_signature_prompts(tp, page)
            == JR.share_signature_prompts(jp, page)
            == TR.share_signature_recorded(ttrace["requests"]))


def test_the_replay_matches_the_jax_tools(workload, jax_weights):
    """No warm-up: both engines capture (compile) on the path, at the
    same keys."""
    meta, requests, parts, prompts = workload
    jeng = JR._build_engine(*parts, 0, 32)
    teng = TR.build_replay_engine(meta, requests, device="cpu")
    assert teng.model.cfg.dtype == torch.float32
    jtok, jtap = _tokens()
    ttok, ttap = _tokens()
    jrep = JR.replay(jeng, requests, prompts, on_token=jtap)
    trep = TR.replay(teng, requests, prompts, on_token=ttap)
    assert trep["gen_lens"] == jrep["gen_lens"]
    assert trep["submit_order"] == jrep["submit_order"]
    greedy = [i for i, r in enumerate(requests)
              if float(r.get("temperature", 0.0)) == 0.0]
    assert 0 < len(greedy) < len(requests)
    for i in greedy:
        assert ttok[i] == jtok[i], i
    for i in range(len(requests)):
        assert len(ttok[i]) == len(jtok[i]) == max(1, requests[i]["gen_len"])
    jdiff = JR.diff_replay(requests, prompts, parts[2], jrep)
    tdiff = TR.diff_replay(requests, prompts, parts[2], trep)
    for key in ("structural_ok", "problems", "compile_on_path",
                "recorded_queue_wait_p50_ms", "tolerance"):
        assert tdiff[key] == jdiff[key], key
    assert tdiff["structural_ok"]
    assert trep["path_captures"] == trep["compile_on_path"] > 0
    assert sum(n for _, n in trep["dispatches"]) > 0


def test_the_disaggregated_replay_matches_the_jax_tools(workload,
                                                         jax_weights):
    """Keyed sampling on both pools in both packages: every row, sampled
    ones too, equal token for token; the journeys of the port's pass are
    gap-free with no orphan."""
    meta, requests, parts, prompts = workload
    jpre, jdec = JR.build_disagg_engines(meta, requests)
    tpre, tdec = TR.build_disagg_engines(meta, requests, device="cpu")
    jtok, jtap = _tokens()
    ttok, ttap = _tokens()
    jrep = JR.replay_disagg(jpre, jdec, requests, prompts, on_token=jtap)
    trep = TR.replay_disagg(tpre, tdec, requests, prompts, on_token=ttap,
                            journeys=True)
    assert ttok == jtok
    assert len(ttok) == len(requests)
    for key in ("gen_lens", "lost", "handoffs", "pages_streamed",
                "pages_shared", "requests_submitted"):
        assert trep[key] == jrep[key], key
    assert trep["lost"] == 0
    j = trep["journeys"]
    assert j["problems"] == [] and j["orphans"] == 0
    assert j["completed_journeys"] == len(requests)
    assert TR.diff_replay(requests, prompts, parts[2],
                          trep)["structural_ok"]


def test_tp_above_one_raises_naming_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        TR.main(["--trace", SAMPLE, "--limit", "2", "--tp", "2",
                 "--device", "cpu"])


@pytest.mark.parametrize("args", [
    ["--limit", "8", "--spec"],
    ["--limit", "8", "--disagg", "--journeys"],
    ["--limit", "24", "--tier", "--tier-device-pages", "4"]],
    ids=["spec", "disagg-journeys", "tier"])
def test_the_cli_legs_pass_their_check(args, capsys):
    assert TR.main(["--trace", SAMPLE, "--device", "cpu", "--check"]
                   + args) == 0
    assert '"structural_ok": true' in capsys.readouterr().out
