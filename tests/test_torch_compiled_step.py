"""The port's step keys held against the JAX package's.

The JAX package compiles one program per step key; the port captures one
CUDA graph per key on the card and keeps the same key bookkeeping on the
CPU.  Here, on the CPU: the bucket lattice (``lattice_keys`` and
``enumerate_lattice_keys``) equals JAX's at several geometries; the keys
a scheduler run dispatches on the debug llama under the default serving
configuration (async chain and prefix caching on) equal the JAX engine's
``compiled_keys(dispatched_only=True)``; ``strict_shapes`` refuses a key
outside the precompiled set; and ``CountedGraph`` counts the launches
each replay runs, driven with stand-ins for the library and for
``torch.cuda``'s graph calls.
"""

import contextlib
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import engine as jengine
from deepspeed_tpu.inference.v2 import lattice as jlattice
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import engine as tengine
from deepspeed_tpu_torch.inference.v2 import lattice as tlattice
from deepspeed_tpu_torch.inference.v2 import model as TM
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.ops import kernel_loader as KL

PAGE, PAGES, BUDGET = 16, 96, 64


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


# (max_prompt, max_new_tokens, max_concurrency, page_size, batch size)
GEOMETRIES = {
    "debug": (64, 16, 8, 16, 64),
    "serving": (1024, 64, 16, 64, 2048),
    "odd": (100, 30, 5, 8, 256),
    "one_slot": (300, 256, 1, 32, 512),
}


@pytest.mark.parametrize("sampling", [True, False])
@pytest.mark.parametrize("has_fresh", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_lattice_keys_equal_jax(geometry, has_fresh, sampling):
    prompt, new, conc, page, batch = GEOMETRIES[geometry]
    kw = dict(max_prompt=prompt, max_new_tokens=new, max_concurrency=conc,
              page_size=page, max_ragged_batch_size=batch,
              has_fresh=has_fresh, sampling=sampling)
    keys = tengine.lattice_keys(**kw)
    assert keys == jengine.lattice_keys(**kw)
    assert [tengine.lattice_kind_of(k) for k in keys] == \
        [jengine.lattice_kind_of(k) for k in keys]
    for kinds in (("decode", "chain"), ("prefill",)):
        assert tengine.lattice_keys(kinds=kinds, **kw) == \
            jengine.lattice_keys(kinds=kinds, **kw)


def test_enumerate_lattice_keys_equal_jax_over_arbitrary_tops():
    kw = dict(page_size=16, max_ragged_batch_size=96, has_fresh=True,
              sampling=True)
    tops = ([1, 3, 6], [1, 5, 24, 40], [2, 7, 9])
    assert tlattice.enumerate_lattice_keys(*tops, **kw) == \
        jlattice.enumerate_lattice_keys(*tops, **kw)


@pytest.mark.parametrize("spec", [dict(spec_q=4), dict(draft=True)])
def test_speculative_keys_equal_jax(spec):
    """The spec and draft key families over the same tops are the JAX
    package's."""
    kw = dict(page_size=16, max_ragged_batch_size=64, has_fresh=True,
              sampling=True, **spec)
    keys = tlattice.enumerate_lattice_keys([1, 4], [1, 8], [8], **kw)
    assert keys == jlattice.enumerate_lattice_keys([1, 4], [1, 8], [8],
                                                   **kw)
    kinds = {k[4] for k in keys if len(k) > 4}
    assert ("spec" in kinds) == ("spec_q" in spec)
    assert ("draft_fill" in kinds) == ("draft" in spec)


def test_lattice_kinds_must_be_known():
    with pytest.raises(ValueError, match="unknown lattice kinds"):
        tengine.lattice_keys(64, 16, 8, 16, 64, True, True,
                             kinds=("decode", "bogus"))


# ---------------------------------------------------------------------------
# the keys a scheduler run dispatches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return model_def.cfg, params, tcfg, tparams


def _engines(weights):
    jcfg, jparams, tcfg, tparams = weights
    kv = dict(page_size=PAGE, num_pages=PAGES)
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=BUDGET)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams, kv_config=J.KVCacheConfig(
            num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
            head_dim=jcfg.dims_per_head, dtype=jnp.float32, **kv)),
        J.RaggedInferenceEngineConfig(state_manager=J.StateManagerConfig(
            **sm)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, dtype=torch.float32, **kv),
            device="cpu"),
        T.RaggedInferenceEngineConfig(state_manager=T.StateManagerConfig(
            **sm)))
    return jeng, teng


def test_dispatched_keys_equal_the_jax_engines(weights):
    """Mixed, fresh, chained and (after a shared prefix) history-prefill
    steps: the same keys, in the default serving configuration."""
    jeng, teng = _engines(weights)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 128, 40)
    prompts = [np.concatenate([shared, rng.integers(0, 128, 7)]),
               rng.integers(0, 128, 61), rng.integers(0, 128, 30),
               np.concatenate([shared, rng.integers(0, 128, 12)]),
               rng.integers(0, 128, 9)]
    new = [8, 12, 6, 10, 5]
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))
    ref = jsched.run_to_completion()
    out = tsched.run_to_completion()
    assert out == {u: list(map(int, t)) for u, t in ref.items()}
    keys = teng.compiled_keys()
    assert keys == jeng.compiled_keys(dispatched_only=True)
    assert {k[4] for k in keys} == {"sample", "chain", "mixed"}
    counts = teng.model.dispatch_counts
    assert set(counts) == set(keys) and all(counts.values())


def test_strict_shapes_refuses_a_key_outside_the_precompiled_set(weights):
    _, teng = _engines(weights)
    keys = teng.precompile(max_prompt=16, max_concurrency=2,
                           max_new_tokens=8, strict=True, sampling=True)
    assert keys == tengine.lattice_keys(
        max_prompt=16, max_new_tokens=8, max_concurrency=2, page_size=PAGE,
        max_ragged_batch_size=BUDGET, has_fresh=True, sampling=True)
    assert teng.compiled_keys(dispatched_only=False) == sorted(keys,
                                                                key=repr)
    # inside the lattice: one fresh step of 2 rows, then chained decodes
    sched = T.FastGenScheduler(teng)
    for uid in range(2):
        sched.submit(uid, [1 + uid] * 10, T.SamplingParams(max_new_tokens=4))
    out = sched.run_to_completion()
    assert all(len(t) == 4 for t in out.values())
    assert set(teng.compiled_keys()) <= set(keys)
    # a 20-token prompt needs Q=32 > 16
    sched.submit(5, list(range(20)))
    with pytest.raises(RuntimeError, match="not precompiled"):
        sched.step()


def test_strict_chain_falls_back_to_a_precompiled_sample_key(weights):
    """Under strict shapes a chained step whose key was not precompiled
    is planned as a host-path step instead (JAX ``_plan_chain``)."""
    _, teng = _engines(weights)
    keys = [k for k in tengine.lattice_keys(
        max_prompt=16, max_new_tokens=8, max_concurrency=2, page_size=PAGE,
        max_ragged_batch_size=BUDGET, has_fresh=True, sampling=True)
        if len(k) < 5 or k[4] != "chain"]
    teng.precompile_keys(keys)
    teng.model.strict_shapes = True
    sched = T.FastGenScheduler(teng)
    sched.submit(0, [3] * 10, T.SamplingParams(max_new_tokens=4))
    assert len(sched.run_to_completion()[0]) == 4
    assert not any(k[4] == "chain" for k in teng.compiled_keys())


def test_precompile_keys_skips_keys_the_model_cannot_form(weights):
    _, teng = _engines(weights)
    good = [[4, 1, 4, False, "sample", True],        # JSON round trip
            (4, 1, 4, False, "chain", 8, False),
            (4, 1, 4, False, "mixed", 2, 16, 4, True, True),
            (8, 16, 4, True)]
    bad = [(4, 1, 4, False, "spec", 3, True),        # a spec key has 6
           (4, 1, 4, False, "sample"),
           (4, 0, 4, False, "sample", True),
           (4, 1, 4, 1, "sample", True),
           (4, 1, 4)]
    with pytest.warns(UserWarning, match="skipping key") as caught:
        assert teng.precompile_keys(bad[:2] + good + bad[2:]) == len(good)
    assert len(caught) == len(bad)
    assert teng.compiled_keys(dispatched_only=False) == sorted(
        (tuple(k) for k in good), key=repr)
    for key in bad:
        with pytest.raises(ValueError, match="not a step key"):
            teng.model.precompile_step(key, teng.state_manager.kv_cache.data)


def test_precompile_keys_raises_a_failed_capture(weights, monkeypatch):
    _, teng = _engines(weights)

    def fail(key, kv):
        raise RuntimeError("operation not permitted when capturing")

    monkeypatch.setattr(teng.model, "precompile_step", fail)
    with pytest.raises(RuntimeError, match="not permitted"):
        teng.precompile_keys([(4, 1, 4, False, "sample", True)])


def test_predict_step_key_is_the_dispatched_key(weights):
    _, teng = _engines(weights)
    sp = [T.SamplingParams()] * 2
    gen = torch.Generator()
    for toks in ([[1] * 20, [2] * 5], [[3], [4]]):
        key = teng.predict_step_key([0, 1], toks, ("sample", True))
        teng.step_sample([0, 1], toks, sp, gen)
        assert teng.model.dispatch_counts[key] == 1


# ---------------------------------------------------------------------------
# CountedGraph: launches counted per replay
# ---------------------------------------------------------------------------

class StandInLib:
    """Every entry point succeeds and records its call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            return 0
        return fn


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts replays, keeps the
    registered generator."""

    def __init__(self):
        self.replays, self.generators = 0, []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, gen):
        self.generators.append(gen)


@pytest.fixture
def stand_in_cuda(monkeypatch):
    captures = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode="global"):
        # a capture must not fail for another replica thread's CUDA work
        assert capture_error_mode == "thread_local"
        captures.append((g, pool))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", graph)
    return captures


def _kernels():
    a = KL.CudaKernel("rmsnorm.cu", {"x": [], "y": []})
    b = KL.CudaKernel("layernorm.cu", {"z": []})
    a._lib, b._lib = StandInLib(), StandInLib()
    return a, b


def test_launch_counts_survive_threads_and_concurrent_captures(
        stand_in_cuda):
    """Replicas count launches from threads of their own while another
    thread captures: a capture (which takes back the launches it counted)
    never takes back another thread's, and no count is lost."""
    import sys
    import threading
    import time
    a, b = _kernels()
    graph = KL.CountedGraph()
    graph.capture(lambda: (a.launch("x"), b.launch("z")))
    base = (a.launches_by_fn["x"], b.launches_by_fn["z"])
    done = threading.Event()
    counts = {"launch": [], "replay": []}

    def worker(kind):
        n = 0
        while not done.is_set():
            if kind == "launch":
                a.launch("y")
            else:
                graph.replay()
            n += 1
        counts[kind].append(n)

    def slow_step():
        a.launch("x")
        time.sleep(1e-3)           # the other threads run mid-capture

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=worker,
                                args=("launch" if i % 2 else "replay",))
               for i in range(8)]
    try:
        for t in threads:
            t.start()
        for _ in range(50):        # captures while the others count
            KL.CountedGraph().capture(slow_step)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    launched, replayed = sum(counts["launch"]), sum(counts["replay"])
    assert launched > 0 and replayed > 0
    assert a.launches_by_fn == {"x": base[0] + replayed + 50, "y": launched}
    assert b.launches_by_fn == {"z": base[1] + replayed}


def test_counted_graph_counts_every_replay_and_not_the_capture(
        stand_in_cuda):
    a, b = _kernels()

    def step(n):
        for _ in range(n):
            a.launch("x")
        b.launch("z")
        return n

    gen = object()
    graph = KL.CountedGraph(pool="pool", generator=gen)
    assert graph.capture(step, 3) == 3
    # the warm-up run ran and counts; the capture ran nothing
    assert (a.launches_by_fn, b.launches_by_fn) == ({"x": 3, "y": 0},
                                                    {"z": 1})
    assert stand_in_cuda == [(graph.graph, "pool")]
    assert graph.graph.generators == [gen]
    for _ in range(4):
        graph.replay()
    assert graph.graph.replays == 4
    assert (a.launches_by_fn, b.launches_by_fn) == ({"x": 15, "y": 0},
                                                    {"z": 5})
    # two graphs, per key: each replay adds its own capture's launches
    other = KL.CountedGraph()
    other.capture(lambda: a.launch("y"))
    other.replay()
    graph.replay()
    assert (a.launches_by_fn, b.launches_by_fn) == ({"x": 18, "y": 2},
                                                    {"z": 6})


def test_counted_graph_capture_failure_raises_and_counts_nothing(
        stand_in_cuda):
    a, _ = _kernels()
    calls = []

    def step():
        a.launch("x")
        calls.append(1)
        if len(calls) == 2:          # the capture, not the warm-up
            raise RuntimeError("operation not permitted when capturing")

    with pytest.raises(RuntimeError, match="not permitted"):
        KL.CountedGraph().capture(step)
    assert a.launches_by_fn == {"x": 1, "y": 0}


def test_a_dropped_engine_frees_its_model_and_graphs_without_the_collector(
        weights, stand_in_cuda):
    """A step graph holds no reference to its model: dropping the
    scheduler and the engine frees the model, its step graphs and their
    pool by reference counts alone."""
    _, teng = _engines(weights)
    sched = T.FastGenScheduler(teng)
    sched.submit(0, [5] * 20, T.SamplingParams(max_new_tokens=4))
    sched.submit(1, [6] * 9, T.SamplingParams(max_new_tokens=3,
                                              temperature=0.7))
    sched.run_to_completion()
    model = teng.model
    # the card's step cache over the CPU step bodies
    shared = ("pool", _Stream(), torch.Generator())
    for key in list(model.dispatch_counts):
        graph = TM._StepGraph(key, teng.state_manager.kv_cache.data,
                              model.device, shared)
        graph.capture(functools.partial(model._call, key))
        model._step_cache[key] = graph
    refs = [weakref.ref(model)] + [weakref.ref(g)
                                   for g in model._step_cache.values()]
    assert len(refs) > 2
    collecting = gc.isenabled()
    gc.disable()
    try:
        del sched, teng, model, graph
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()
