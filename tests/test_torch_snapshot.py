"""Serving snapshots in the port, held against the JAX package.

A bundle is the JAX package's format byte for byte: a bundle packed by
either package unpacks in the other (bf16 arrays through the dtype
manifest, int8 pages with their ``_scale`` sidecar), and a snapshot
taken by one scheduler restores in the other's and finishes with the
uninterrupted JAX run's tokens, greedy and keyed.  In the port itself an
interrupt at every step ordinal (with speculation off and on, and the
self-draft's bundles) resumes tokenwise, and so do a snapshot taken
while a request sits preempted with its KV in a host blob, one over a
sliding-window model's evicted tables and one over int8 pages of debug
OPT; prefix-cache hits, counters, errors and TTLs survive a restore.  A
corrupt, truncated, other-version, non-fresh, other-geometry or
other-draft-trunk restore raises ``SnapshotError``; a write that fails
midway leaves the previous bundle readable; an expired grace budget
ends the live requests as ``"migrated"`` errors with their tokens; and
SIGTERM drives the drain in a child process.
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import snapshot as jsnap
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import snapshot as tsnap
from deepspeed_tpu_torch.models import transformer as TT
from deepspeed_tpu_torch.models.llama import llama_config

PAGE, PAGES, BUDGET, SEED = 16, 96, 64, 7
KEYED = dict(keyed_sampling=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DS_KV_DEBUG", "1")


_WEIGHTS = {}


def _weights(window=None):
    """(JAX cfg, JAX params, port cfg, port params) of the debug llama,
    made once per window."""
    if window not in _WEIGHTS:
        kw = {"sliding_window": window} if window else {}
        model_def = LlamaForCausalLM("debug", max_seq_len=256,
                                     dtype=jnp.float32, **kw)
        params = meta.unbox(model_def.init_params(jax.random.key(0)))
        tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32,
                            **kw)
        _WEIGHTS[window] = (model_def.cfg, params, tcfg, from_jax(
            jax.tree.map(np.asarray, params), tcfg, device="cpu"))
    return _WEIGHTS[window]


def _engine(pkg, weights=None, num_pages=PAGES, page=PAGE, **serving):
    jcfg, jparams, tcfg, tparams = weights or _weights()
    cfg = jcfg if pkg is J else tcfg
    kv = dict(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
              head_dim=cfg.dims_per_head, page_size=page,
              num_pages=num_pages)
    econf = pkg.RaggedInferenceEngineConfig(
        state_manager=pkg.StateManagerConfig(
            max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=BUDGET),
        serving=pkg.ServingOptimizationConfig(**serving))
    if pkg is J:
        model = J.RaggedInferenceModel(jcfg, jparams, kv_config=J.KVCacheConfig(
            dtype=jnp.float32, **kv))
    else:
        model = T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            dtype=torch.float32, **kv), device="cpu")
    return pkg.InferenceEngineV2(model, econf)


def _sched(pkg, eng):
    if pkg is J:
        return J.FastGenScheduler(eng, rng=jax.random.key(SEED))
    return T.FastGenScheduler(eng, seed=SEED)


#: (prompt length, new tokens, temperature, top_k, top_p): greedy and
#: keyed-sampled requests; uid 1's prompt is periodic (the n-gram
#: drafter drafts there)
TRAFFIC = [(3, 8, 0.0, 0, 1.0), (40, 12, 0.8, 0, 1.0), (30, 9, 1.0, 20, 1.0),
           (21, 10, 0.0, 0, 1.0)]


def _requests(pkg, traffic=TRAFFIC, seed=11):
    rng = np.random.default_rng(seed)
    reqs = []
    for uid, (n, new, t, k, p) in enumerate(traffic):
        prompt = (np.tile(rng.integers(0, 128, 6), n // 6 + 1)[:n]
                  if uid == 1 else rng.integers(0, 128, n))
        reqs.append((uid, prompt, pkg.SamplingParams(
            max_new_tokens=new, temperature=t, top_k=k, top_p=p)))
    return reqs


def _serve(pkg, make, reqs, cut=None, resume=None, path=None):
    """Serve ``reqs`` on ``make()``'s scheduler.  With ``cut``: after that
    many steps snapshot it (to ``path``, or in memory) and finish on
    ``resume()``'s scheduler restored from the bundle.  Returns (tokens
    per uid through ``on_token``, the first and the last scheduler)."""
    sched = make()
    for r in reqs:
        sched.submit(*r)
    out = {}

    def on_token(u, t):
        out.setdefault(u, []).append(int(t))

    steps = 0
    while sched.has_work:
        if cut is not None and steps == cut:
            bundle = sched.snapshot(path, on_token=on_token)
            first, sched = sched, resume().restore(
                path if path is not None else bundle)
            while sched.has_work:
                sched.step(on_token=on_token)
            return out, first, sched
        sched.step(on_token=on_token)
        steps += 1
    return out, sched, sched


def _port(**serving):
    return lambda: _sched(T, _engine(T, **serving))


# ---------------------------------------------------------------------------
# the bundle format
# ---------------------------------------------------------------------------

def _arrays(rng):
    bf16 = rng.standard_normal((2, 3, 4, 2, 1, 8)).astype(np.float32)
    return {"page_blob": rng.integers(-127, 128, (2, 3, 4, 2, 1, 8)
                                      ).astype(np.int8),
            "page_blob_scale": rng.random((2, 3, 4, 2, 1)).astype(np.float32),
            "prompt_3": rng.integers(0, 128, 17).astype(np.int32),
            "rng_key": np.array([0, 7], np.uint32),
            "bf16": bf16}


def test_bundles_cross_between_the_packages_both_ways():
    rng = np.random.default_rng(0)
    arrays = _arrays(rng)
    meta_ = {"version": 1, "requests": {"pending": []}, "x": [1, 2.5, None]}
    # the port packs torch tensors: bf16 through the dtype manifest
    port_arrays = dict(arrays, page_blob=torch.from_numpy(arrays["page_blob"]),
                       bf16=torch.from_numpy(arrays["bf16"]).bfloat16())
    jax_arrays = dict(arrays, bf16=arrays["bf16"].astype(ml_dtypes.bfloat16))
    for packed in (tsnap.pack_bundle(meta_, port_arrays),
                   jsnap.pack_bundle(meta_, jax_arrays)):
        for unpack in (tsnap.unpack_bundle, jsnap.unpack_bundle):
            m, a = unpack(packed)
            assert m == meta_ and sorted(a) == sorted(arrays)
            for k in ("page_blob", "page_blob_scale", "prompt_3", "rng_key"):
                got = np.asarray(a[k])
                assert got.dtype == arrays[k].dtype
                np.testing.assert_array_equal(got, arrays[k])
            bits = (a["bf16"].view(torch.int16).numpy()
                    if unpack is tsnap.unpack_bundle
                    else a["bf16"].view(np.int16))
            np.testing.assert_array_equal(
                bits, jax_arrays["bf16"].view(np.int16))
    # the same bytes from either packer
    assert tsnap.pack_bundle(meta_, port_arrays) == jsnap.pack_bundle(
        meta_, jax_arrays)


def test_corrupt_truncated_and_other_version_bundles_raise(tmp_path):
    good = tsnap.pack_bundle({"version": 1}, _arrays(np.random.default_rng(1)))
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF
    for data, match in ((bytes(bad), "checksum"), (good[:-7], "checksum"),
                        (good[:20], "too short"), (b"X" * 64, "magic")):
        with pytest.raises(T.SnapshotError, match=match):
            tsnap.unpack_bundle(data)
    with pytest.raises(T.SnapshotError, match="version"):
        tsnap.unpack_bundle(tsnap.pack_bundle({"version": 2}, {}))
    path = str(tmp_path / "b.snap")
    with open(path, "wb") as f:
        f.write(good[:-100])
    with pytest.raises(T.SnapshotError):
        _sched(T, _engine(T)).restore(path)
    with pytest.raises(T.SnapshotError, match="cannot read"):
        tsnap.read_bundle(str(tmp_path / "missing.snap"))
    with pytest.raises(T.SnapshotError, match="version"):
        _sched(T, _engine(T)).restore({"meta": {"version": 2}, "arrays": {}})


def test_a_write_failing_midway_leaves_the_previous_bundle(tmp_path,
                                                           monkeypatch):
    path = str(tmp_path / "b.snap")
    first = _arrays(np.random.default_rng(2))
    tsnap.write_bundle(path, {"version": 1, "n": 1}, first)
    calls = []

    def failing_fsync(fd):
        calls.append(fd)
        raise OSError("disk went away")

    monkeypatch.setattr(tsnap.os, "fsync", failing_fsync)
    with pytest.warns(UserWarning, match="retry"):
        with pytest.raises(OSError, match="disk went away"):
            tsnap.write_bundle(path, {"version": 1, "n": 2},
                               _arrays(np.random.default_rng(3)),
                               retries=2, backoff_s=0.0)
    assert len(calls) == 3                      # the write and two retries
    m, a = tsnap.read_bundle(path)
    assert m["n"] == 1
    np.testing.assert_array_equal(a["prompt_3"], first["prompt_3"])
    assert os.listdir(tmp_path) == ["b.snap"]   # no tmp file left


def _keys(tree):
    """The key structure of a JSON tree (lists by their first item)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], (dict, list)):
        return [_keys(tree[0])]
    return None


# ---------------------------------------------------------------------------
# across the packages: one run's snapshot finishes in the other
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tokens():
    out, _, _ = _serve(J, lambda: _sched(J, _engine(J, **KEYED)),
                       _requests(J))
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_snapshot_finishes_in_the_other_package(jax_tokens, direction,
                                                  tmp_path):
    src, dst = (J, T) if direction == "jax_to_port" else (T, J)
    path = str(tmp_path / "b.snap")
    out, first, last = _serve(src, lambda: _sched(src, _engine(src, **KEYED)),
                              _requests(src), cut=4,
                              resume=lambda: _sched(dst, _engine(dst, **KEYED)),
                              path=path)
    assert out == jax_tokens
    assert last._running == {} and isinstance(last, dst.FastGenScheduler)
    # the same meta keys and array names as the other package's bundle
    m_src, a_src = tsnap.read_bundle(path)
    other = _serve(dst, lambda: _sched(dst, _engine(dst, **KEYED)),
                   _requests(dst), cut=4, resume=lambda: _sched(
                       dst, _engine(dst, **KEYED)))[1]
    m_dst = other.snapshot()["meta"]
    assert _keys(m_src) == _keys(m_dst)
    assert m_src["draft_digest"] == m_dst["draft_digest"] == ""


# ---------------------------------------------------------------------------
# within the port: an interrupt anywhere resumes tokenwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serving", [
    dict(KEYED), dict(KEYED, speculative=True)], ids=["spec_off", "spec_on"])
def test_an_interrupt_at_every_step_resumes_tokenwise(serving):
    reqs = _requests(T)
    ref, sched, _ = _serve(T, _port(**serving), reqs)
    n_steps = sched._step_ordinal
    if serving.get("speculative"):
        assert sched._spec_steps > 0
    for cut in range(n_steps):
        out, _, last = _serve(T, _port(**serving), reqs, cut=cut,
                              resume=_port(**serving))
        assert out == ref, cut
        # the counter travels (the resumed run may take a step fewer: the
        # snapshot drained the chained step in flight)
        assert n_steps - 1 <= last._step_ordinal <= n_steps, cut


def test_a_self_draft_bundle_round_trips_in_the_port(tmp_path):
    serving = dict(KEYED, speculative=True, spec_drafter="model")
    reqs = _requests(T)
    ref, sched, _ = _serve(T, _port(**serving), reqs)
    assert sched._spec_draft_drafted_cum > 0
    for cut in (2, 5):
        path = str(tmp_path / f"{cut}.snap")
        out, first, last = _serve(T, _port(**serving), reqs, cut=cut,
                                  resume=_port(**serving), path=path)
        assert out == ref
        assert tsnap.read_bundle(path)[0]["draft_digest"] == \
            first._engine.draft_digest != ""


def test_a_snapshot_of_a_preempted_request_carries_its_host_blob():
    """Prompts of 100, 60 and 40 tokens, 24 new each, on 12 pages of 16:
    a request sits preempted (its KV in a host blob) when the snapshot
    is taken, and the restored run finishes with the uninterrupted
    tokens."""
    rng = np.random.default_rng(0)
    reqs = [(u, rng.integers(0, 128, n), T.SamplingParams(max_new_tokens=24))
            for u, n in enumerate((100, 60, 40))]
    make = _port(num_pages=12, prefix_caching=False)
    ref, _, _ = _serve(T, make, reqs)
    sched = make()
    for r in reqs:
        sched.submit(*r)
    out = {}
    while not sched._preempted:
        sched.step(on_token=lambda u, t: out.setdefault(u, []).append(t))
    bundle = sched.snapshot(on_token=lambda u, t: out.setdefault(
        u, []).append(t))
    (victim,) = sched._preempted
    assert f"hostblob_{victim}" in bundle["arrays"]
    restored = make().restore(bundle)
    sm = restored._engine.state_manager
    assert sm.offloaded_blobs == 1 and set(restored._preempted) == {victim}
    assert torch.equal(sm.get_sequence(victim).host_blob,
                       bundle["arrays"][f"hostblob_{victim}"])
    while restored.has_work:
        restored.step(on_token=lambda u, t: out.setdefault(u, []).append(t))
    assert out == ref


def test_a_sliding_window_snapshot_resumes_over_evicted_tables():
    weights = _weights(window=24)
    make = lambda: _sched(T, _engine(T, weights, **KEYED))    # noqa: E731
    rng = np.random.default_rng(5)
    reqs = [(u, rng.integers(0, 128, n), T.SamplingParams(
        max_new_tokens=30, temperature=0.9 * (u % 2)))
        for u, n in enumerate((50, 37, 12))]
    ref, _, _ = _serve(T, make, reqs)
    for cut in (3, 12):
        out, first, _ = _serve(T, make, reqs, cut=cut, resume=make)
        assert out == ref
    seqs = first.snapshot()["meta"]["engine"]["sequences"]
    assert any(0 in s["pages"] for s in seqs)         # evicted null slots


def _opt_weights():
    fields = dict(vocab_size=128, hidden_size=64, intermediate_size=256,
                  num_layers=2, num_heads=4, max_seq_len=256,
                  norm="layernorm", norm_eps=1e-5, activation="relu",
                  pos_emb="learned", tie_embeddings=True, use_bias=True)
    jcfg = JT.TransformerConfig(dtype=jnp.float32, **fields)
    tcfg = TT.TransformerConfig(dtype=torch.float32, **fields)
    tree = jax.tree.map(np.array, meta.unbox(
        JT.init_params(jcfg, jax.random.key(0))))
    return jcfg, None, tcfg, from_jax(tree, tcfg, device="cpu")


def test_an_int8_page_bundle_of_debug_opt_round_trips(tmp_path):
    weights = _opt_weights()
    make = lambda: _sched(T, _engine(                           # noqa: E731
        T, weights, kv_quantization="int8", **KEYED))
    reqs = _requests(T)
    ref, _, _ = _serve(T, make, reqs)
    path = str(tmp_path / "b.snap")
    out, first, _ = _serve(T, make, reqs, cut=5, resume=make, path=path)
    assert out == ref
    m, a = tsnap.read_bundle(path)
    assert m["engine"]["kv"]["quantization"] == "int8"
    assert a["page_blob"].dtype == np.int8
    assert a["page_blob_scale"].shape == a["page_blob"].shape[:-1]


def test_prefix_hits_survive_a_restore():
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 128, 40)
    warm = [(0, np.concatenate([shared, rng.integers(0, 128, 5)]),
             T.SamplingParams(max_new_tokens=4))]
    late = (1, np.concatenate([shared, rng.integers(0, 128, 9)]),
            T.SamplingParams(max_new_tokens=6))

    def serve(restore):
        sched = _port()()
        for r in warm:
            sched.submit(*r)
        sched.run_to_completion()
        if restore:
            sched = _port()().restore(sched.snapshot())
        hits = []
        match = sched._engine.match_prefix
        sched._engine.match_prefix = lambda u, p: hits.append(
            match(u, p)) or hits[-1]
        sched.submit(*late)
        return sched.run_to_completion()[1], hits

    assert serve(True) == serve(False)
    assert serve(True)[1] == [32]


def test_counters_errors_and_ttls_survive_a_restore(monkeypatch):
    from deepspeed_tpu_torch.inference.v2 import scheduler as tscheduler

    class Clock:
        now = 1000.0

        def monotonic(self):
            return self.now

        def __getattr__(self, name):
            import time
            return getattr(time, name)

    clock = Clock()
    monkeypatch.setattr(tscheduler, "time", clock)
    sched = _sched(T, _engine(T, max_queue_depth=2))
    reqs = _requests(T)
    sched.submit(*reqs[0], ttl_s=50.0)
    sched.submit(*reqs[1])
    assert sched.submit(*reqs[2]).code == "shed"
    for _ in range(3):
        sched.step()
    clock.now += 20.0
    bundle = sched.snapshot()
    clock.now += 1000.0                 # the outage: another process
    restored = _sched(T, _engine(T, max_queue_depth=2)).restore(bundle)
    assert {u: (e.code, e.tokens) for u, e in restored.errors.items()} == {
        2: ("shed", [])}
    assert restored._step_ordinal == sched._step_ordinal == 3
    assert restored.last_step_scheduled == sched.last_step_scheduled
    assert restored._running[0].deadline == pytest.approx(clock.now + 30.0)
    assert restored._running[1].deadline is None
    assert restored._has_deadlines


# ---------------------------------------------------------------------------
# refusals and the drain
# ---------------------------------------------------------------------------

def _mid_run_bundle(steps=3, **serving):
    sched = _port(**serving)()
    for r in _requests(T):
        sched.submit(*r)
    for _ in range(steps):
        sched.step()
    return sched.snapshot()


def test_restore_refuses_what_it_cannot_resume():
    bundle = _mid_run_bundle(**KEYED)
    busy = _port(**KEYED)()
    busy.submit(*_requests(T)[0])
    closed = _port(**KEYED)()
    closed.close()
    for sched, match in ((busy, "fresh"), (closed, "fresh"),
                         (_sched(T, _engine(T, page=8, **KEYED)), "geometry"),
                         (_port(prefix_caching=False, **KEYED)(),
                          "prefix_caching")):
        with pytest.raises(T.SnapshotError, match=match):
            sched.restore(bundle)
    drafted = _mid_run_bundle(speculative=True, spec_drafter="model")
    for serving in (dict(), dict(speculative=True, spec_drafter="model",
                                 spec_draft_layers=1)):
        with pytest.raises(T.SnapshotError, match="draft trunk"):
            _port(**serving)().restore(drafted)
    # the selective export (the handoff's) refuses an untracked uid
    with pytest.raises(T.SnapshotError, match="untracked"):
        _engine(T).state_manager.export_state(seq_ids=[0])


def test_an_expired_grace_budget_ends_requests_as_migrated(tmp_path):
    sched = _port(**KEYED)()
    for r in _requests(T):
        sched.submit(*r)
    for _ in range(4):
        sched.step()
    path = str(tmp_path / "b.snap")
    with pytest.warns(UserWarning, match="grace budget"):
        assert sched.drain_and_snapshot(path, grace_s=0.0) is None
    assert not os.path.exists(path) and not sched.has_work
    assert {e.code for e in sched.errors.values()} == {"migrated"}
    assert any(e.tokens for e in sched.errors.values())
    assert sched.submit(*_requests(T)[0]).code == "closing"
    # with the budget the bundle is written and restores
    sched = _port(**KEYED)()
    for r in _requests(T):
        sched.submit(*r)
    sched.step()
    assert sched.drain_and_snapshot(path) == path
    assert _port(**KEYED)().restore(path)._running


_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    model = T.RaggedInferenceModel(cfg, init_params(cfg, 0, device="cpu"),
        kv_config=T.KVCacheConfig(num_layers=cfg.num_layers,
            kv_heads=cfg.kv_heads, head_dim=cfg.dims_per_head,
            page_size=16, num_pages=32, dtype=torch.float32), device="cpu")
    eng = T.InferenceEngineV2(model, T.RaggedInferenceEngineConfig(
        serving=T.ServingOptimizationConfig(
            keyed_sampling=True, snapshot_path={path!r})))
    sched = T.FastGenScheduler(eng, seed=3)
    sched.submit(0, list(range(1, 30)), T.SamplingParams(
        max_new_tokens=40, temperature=0.8))
    for _ in range(5):
        sched.step()
    print("stepped", flush=True)
    os.kill(os.getpid(), 15)
    print("survived", flush=True)
""")


def test_sigterm_drains_to_a_bundle_in_a_child_process(tmp_path):
    path = str(tmp_path / "sigterm.snap")
    env = dict(os.environ, DS_DRAIN_ON_SIGTERM="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=REPO, path=path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGTERM, proc.stderr
    assert "stepped" in proc.stdout and "survived" not in proc.stdout
    m, a = tsnap.read_bundle(path)
    (req,) = m["requests"]["running"]
    assert len(req["generated"]) >= 4 and req["params"]["temperature"] == 0.8
    np.testing.assert_array_equal(a["rng_key"], [0, 3])
