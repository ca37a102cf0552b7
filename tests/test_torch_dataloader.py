"""The data loader and the engine's data paths held against JAX, on the CPU.

``runtime/dataloader.py`` reads the JAX loader's samples in the JAX
loader's order (numpy's ``default_rng(seed + epoch).permutation``).  The
port's engine and the JAX engine (one device) then train from the same
bridged weights, in fp32: a debug GPT on right- and left-padded batches
(the einsum path under the composed mask, learned positions over the
attended tokens) and a debug BERT masked LM fed through
``initialize(training_data=...)``.  Losses step by step at
``tests/test_torch_training.py``'s rtol 1e-4.  Both engines restart a
loader given as ``training_data`` on every ``train_batch()`` call (JAX
``_resolve_batch`` calls ``iter()`` on it): without shuffle every step
reads the first gas micro-batches, which both show; an iterator passed
as ``data_iter`` advances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.bert import BertForMaskedLM as JBert
from deepspeed_tpu.models.gpt import GPTForCausalLM as JGPT
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime.config import load_config as j_load_config
from deepspeed_tpu.runtime.engine import _topology_from_config
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.models.bert import BertForMaskedLM
from deepspeed_tpu_torch.models.gpt import GPTForCausalLM
from deepspeed_tpu_torch.runtime import dataloader as tdl

LOSS_RTOL = 1e-4
MICRO, GAS, S, VOCAB = 2, 2, 32, 128


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def train_config(**over):
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "bf16": {"enabled": False},
           "gradient_clipping": 1.0,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}}}
    cfg.update(over)
    return cfg


def jax_engine(model, cfg, **kw):
    topo = _topology_from_config(j_load_config(cfg),
                                 devices=jax.devices()[:1])
    return dst.initialize(model=model, config=cfg, topology=topo, **kw)


def bridged(je, cfg):
    tree = jax.tree.map(np.asarray, meta.unbox(je.state.params))
    return from_jax(tree, cfg, device="cpu")


class Recorded:
    """A list of samples that records each index read."""

    def __init__(self, samples):
        self.samples, self.reads = samples, []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.reads.append(int(i))
        return self.samples[i]


def mlm_samples(n, seed=0):
    """BERT samples of mixed lengths, right-padded to S: 15% of the real
    tokens carry a label, -100 elsewhere."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(12, S + 1))
        am = (np.arange(S) < length).astype(np.int32)
        ids = np.where(am == 1, rng.integers(0, VOCAB, S), 0)
        chosen = (am == 1) & (rng.random(S) < 0.15)
        chosen[1] = True
        labels = np.where(chosen, rng.integers(0, VOCAB, S), -100)
        out.append({"input_ids": ids.astype(np.int32),
                    "attention_mask": am,
                    "labels": labels.astype(np.int32)})
    return out


# ---------------------------------------------------------------------------
# the loader alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_loader_reads_the_jax_loaders_samples_in_order(shuffle, drop_last):
    data = [{"x": np.full(3, i, np.float32), "y": np.int32(i)}
            for i in range(11)]
    kw = dict(batch_size=3, shuffle=shuffle, seed=7, drop_last=drop_last)
    ours, ref = tdl.DeepSpeedDataLoader(data, **kw), \
        jdl.DeepSpeedDataLoader(data, **kw)
    assert len(ours) == len(ref) == (3 if drop_last else 4)
    for _ in range(3):                       # epochs: new permutations
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_collate_keeps_torch_samples_as_torch_and_nests():
    samples = [({"a": torch.full((2,), float(i))}, [np.int64(i)])
               for i in range(4)]
    batch = tdl.default_collate(samples)
    assert isinstance(batch, tuple) and isinstance(batch[1], list)
    assert isinstance(batch[0]["a"], torch.Tensor)
    assert batch[0]["a"].shape == (4, 2)
    np.testing.assert_array_equal(batch[1][0], np.arange(4))
    ref = jdl.default_collate([({"a": np.full(2, float(i))}, [np.int64(i)])
                               for i in range(4)])
    np.testing.assert_array_equal(batch[0]["a"].numpy(), ref[0]["a"])


def test_repeating_loader_restarts_at_the_end():
    loader = tdl.DeepSpeedDataLoader(list(range(5)), batch_size=2)
    rep, jrep = tdl.RepeatingLoader(loader), jdl.RepeatingLoader(
        jdl.DeepSpeedDataLoader(list(range(5)), batch_size=2))
    assert len(rep) == 2
    got = [next(rep).tolist() for _ in range(5)]
    assert got == [[0, 1], [2, 3], [0, 1], [2, 3], [0, 1]]
    assert got == [next(jrep).tolist() for _ in range(5)]
    sampled = tdl.DeepSpeedDataLoader(list(range(6)), batch_size=2,
                                      data_sampler=[5, 4, 3, 2, 1, 0])
    assert [b.tolist() for b in sampled] == [[5, 4], [3, 2], [1, 0]]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["right", "left"])
def test_gpt_engine_on_padded_batches_matches_jax(side):
    cfg = train_config()
    je, *_ = jax_engine(JGPT("debug", dtype=jnp.float32), cfg)
    model = GPTForCausalLM("debug", dtype=torch.float32)
    te, _, loader, _ = dtt.initialize(model=model, config=cfg,
                                      model_parameters=bridged(je, model.cfg),
                                      device="cpu")
    assert loader is None
    rng = np.random.default_rng(3)
    for _ in range(3):
        lengths = rng.integers(8, S + 1, GAS * MICRO)
        pos = np.arange(S)[None]
        am = (pos < lengths[:, None]) if side == "right" else \
            (pos >= S - lengths[:, None])
        am = am.astype(np.int32)
        ids = np.where(am == 1, rng.integers(0, VOCAB, am.shape), 0)
        batch = {"input_ids": ids.astype(np.int32), "attention_mask": am}
        ref = je.train_batch(batch)
        got = te.train_batch(batch)
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(),
                                   je.get_global_grad_norm(), rtol=LOSS_RTOL)


def test_bert_engine_through_training_data_matches_jax_and_restarts():
    """initialize(training_data=...) in both packages, then train_batch()
    with no batch: the losses agree step by step, and each call reads
    the first GAS micro-batches again (the loader is restarted, no
    shuffle), so the second step trains on the first step's data."""
    cfg = train_config()
    jdata, tdata = Recorded(mlm_samples(12)), Recorded(mlm_samples(12))
    je, _, jloader, _ = jax_engine(JBert("debug", dtype=jnp.float32), cfg,
                                   training_data=jdata)
    model = BertForMaskedLM("debug", dtype=torch.float32)
    te, _, loader, _ = dtt.initialize(
        model=model, config=cfg, model_parameters=bridged(je, model.cfg),
        device="cpu", training_data=tdata)
    assert loader is te.training_dataloader and len(loader) == len(jloader)
    for _ in range(3):
        ref = je.train_batch()
        got = te.train_batch()
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    first = list(range(GAS * MICRO))
    assert jdata.reads == tdata.reads == first * 3
    # an iterator advances: a RepeatingLoader over the same loader
    jit_, tit = jdl.RepeatingLoader(jloader), tdl.RepeatingLoader(loader)
    jdata.reads.clear()
    tdata.reads.clear()
    for _ in range(2):
        np.testing.assert_allclose(te.train_batch(data_iter=tit),
                                   je.train_batch(data_iter=jit_),
                                   rtol=LOSS_RTOL)
    assert jdata.reads == tdata.reads == list(range(2 * GAS * MICRO))


def test_train_batch_without_batch_or_loader_raises():
    model = GPTForCausalLM("debug", dtype=torch.float32)
    te, *_ = dtt.initialize(model=model, config=train_config(),
                            model_parameters=model.init_params(0, "cpu"),
                            device="cpu")
    with pytest.raises(ValueError, match="no batch and no dataloader"):
        te.train_batch()
    loader = te.deepspeed_io([{"input_ids": np.zeros(S, np.int32)}] * 3,
                             batch_size=3)
    with pytest.raises(ValueError, match="micro-batch is 2"):
        te.train_batch(data_iter=iter(loader))
