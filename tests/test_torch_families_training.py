"""The training forward of every family held against JAX, on the CPU.

Each family's configuration at debug width (the fields its published
configs set, as ``tests/test_torch_families.py`` lists them, plus
Phi-3's window and BERT's masked LM) runs JAX ``CausalLM.loss`` (or
``BertForMaskedLM.loss``) under ``jax.value_and_grad`` and the port's
loss under autograd, in fp32, on the JAX initialiser's tree with every
bias and norm leaf replaced by seeded noise, bridged through
``checkpoint/from_jax.py``.  Each runs unpadded (the flash path, the
Pallas kernel in interpret mode against the port's plain version; ALiBi
and BERT take the einsum path) and with left and right padding (the
einsum path under the composed mask; learned positions count attended
tokens only).  Tolerances, as ``tests/test_torch_training.py``'s: loss
rtol 1e-4 (measured <= 2e-7); logits 1e-4 of the largest logit
(measured <= 1.1e-6); every gradient leaf rtol 1e-4 with atol 1e-6
(fp32 sums in another order; measured <= 2.3e-6 absolute, on elements
of ~1e-2 and more, while the key-bias gradients are ~1e-9, rounding
noise in both packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.models import bert as JB
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.models import bert as TB
from deepspeed_tpu_torch.models import transformer as TT
from deepspeed_tpu_torch.tree import tree_leaves, tree_map

LOSS_RTOL = 1e-4
LOGIT_TOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
B, S = 2, 32

_DEBUG = dict(vocab_size=128, hidden_size=64, intermediate_size=256,
              num_layers=2, num_heads=4, max_seq_len=64, norm="layernorm",
              norm_eps=1e-5)
# family -> the fields its published configs set (checkpoint/hf.py);
# "bert" is models/bert.py's preset
FAMILIES = {
    "gpt2": dict(activation="gelu", pos_emb="learned", tie_embeddings=True,
                 use_bias=True),
    "opt": dict(activation="relu", pos_emb="learned", tie_embeddings=True,
                use_bias=True),
    "bloom": dict(activation="gelu", pos_emb="alibi", embed_layernorm=True,
                  tie_embeddings=True, use_bias=True),
    "falcon": dict(activation="gelu_exact", pos_emb="rope",
                   parallel_residual=True, num_kv_heads=1,
                   tie_embeddings=True),
    "phi": dict(activation="gelu", pos_emb="rope", rope_pct=0.4,
                parallel_residual=True, use_bias=True),
    "phi3": dict(norm="rmsnorm", activation="silu_gated", pos_emb="rope",
                 sliding_window=12),
    "bert": dict(norm_eps=1e-12, activation="gelu", pos_emb="learned",
                 causal=False, tie_embeddings=True, use_bias=True),
}
PADDING = ("none", "left", "right")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _configs(family, **over):
    fields = dict(_DEBUG, **FAMILIES[family], **over)
    return (JT.TransformerConfig(dtype=jnp.float32, **fields),
            TT.TransformerConfig(dtype=torch.float32, **fields))


def _noisy_tree(jcfg, family, seed=0):
    """The JAX initialiser's tree as numpy, biases and norm leaves
    replaced by noise (scale ~1, bias ~0.1), plus the phi family's
    ``lm_head_bias``."""
    tree = jax.tree.map(np.array, meta.unbox(
        JT.init_params(jcfg, jax.random.key(seed))))
    rng = np.random.default_rng(seed)

    def visit(node):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                visit(leaf)
            elif key == "scale":
                node[key] = (1 + 0.2 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
            elif key.startswith("b"):
                node[key] = (0.1 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
    visit(tree)
    if family == "phi":
        tree["lm_head_bias"] = (0.1 * rng.standard_normal(jcfg.vocab_size)
                                ).astype(np.float32)
    return tree


def _batch(family, padding, vocab=128, seed=1):
    """Seeded ids; left or right padding of mixed lengths (a full row and
    a row of 19 tokens); BERT's labels: 15% of the real tokens masked,
    -100 elsewhere."""
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if padding != "none":
        am = np.ones((B, S), np.int32)
        if padding == "right":
            am[1, 19:] = 0
        else:
            am[1, :S - 19] = 0
        batch["attention_mask"] = am
        batch["input_ids"] = np.where(am == 1, batch["input_ids"], 0
                                      ).astype(np.int32)
    if family == "bert":
        real = batch.get("attention_mask", np.ones((B, S), np.int32)) == 1
        chosen = real & (rng.random((B, S)) < 0.15)
        chosen[:, 3] = real[:, 3]               # at least one per row
        batch["labels"] = np.where(chosen, rng.integers(0, vocab, (B, S)),
                                   -100).astype(np.int32)
    return batch


def _models(family, jcfg, tcfg):
    if family == "bert":
        jm, tm = JB.BertForMaskedLM("debug"), TB.BertForMaskedLM("debug")
        jm.cfg, tm.cfg = jcfg, tcfg
        return jm, tm
    return JT.CausalLM(jcfg), TT.CausalLM(tcfg)


def _jax_loss_grads(jm, tree, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, jb))(
        jax.tree.map(jnp.asarray, tree))
    logits = jm.logits(jax.tree.map(jnp.asarray, tree), jb)
    return float(loss), jax.tree.map(np.asarray, grads), np.asarray(logits)


def _port_loss_grads(tm, tree, batch):
    params = tree_map(lambda t: t.requires_grad_(),
                      from_jax(tree, tm.cfg, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tm.loss(params, tb)
    loss.backward()
    with torch.no_grad():
        logits = tm.logits(params, tb).numpy()
    return float(loss.detach()), params, logits


def named_leaves(tree, prefix=""):
    """{path: leaf} of a nested dict, paths as ``jax.tree_util.keystr``
    writes them."""
    if isinstance(tree, dict):
        return {name: leaf for k, v in tree.items()
                for name, leaf in named_leaves(v, f"{prefix}['{k}']").items()}
    return {prefix: tree}


def assert_grads_close(params, jgrads):
    got = named_leaves(params)
    want = {jax.tree_util.keystr(path): ref for path, ref in
            jax.tree_util.tree_leaves_with_path(jgrads)}
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.grad is not None, name
        np.testing.assert_allclose(t.grad.numpy(), want[name],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("padding", PADDING)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_forward_and_gradients_match_jax(family, padding):
    jcfg, tcfg = _configs(family)
    tree = _noisy_tree(jcfg, family)
    batch = _batch(family, padding)
    jm, tm = _models(family, jcfg, tcfg)
    j_loss, j_grads, j_logits = _jax_loss_grads(jm, tree, batch)
    t_loss, params, t_logits = _port_loss_grads(tm, tree, batch)
    assert np.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    scale = np.abs(j_logits).max()
    assert np.abs(t_logits - j_logits).max() <= LOGIT_TOL * scale
    assert_grads_close(params, j_grads)


@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_padding_side_does_not_change_learned_position_logits(family):
    """Learned positions count attended tokens (cumsum of the mask), so a
    sequence's logits do not depend on which side it is padded on, in
    both packages."""
    jcfg, tcfg = _configs(family)
    tree = _noisy_tree(jcfg, family)
    _, tm = _models(family, jcfg, tcfg)
    jm = JT.CausalLM(jcfg)
    left, right = _batch(family, "left"), _batch(family, "right")
    ids = right["input_ids"][1, :19]
    left["input_ids"][1, S - 19:] = ids
    for batch in (left, right):
        batch["input_ids"][0] = right["input_ids"][0]
    outs = []
    for batch in (left, right):
        _, _, t_logits = _port_loss_grads(tm, tree, batch)
        _, _, j_logits = _jax_loss_grads(jm, tree, batch)
        outs.append((t_logits, j_logits))
    (tl, jl), (tr, jr) = outs
    scale = np.abs(jr).max()
    for a, b in ((tl[1, S - 19:], tr[1, :19]), (jl[1, S - 19:], jr[1, :19]),
                 (tl, jl), (tr, jr)):
        assert np.abs(a - b).max() <= LOGIT_TOL * scale


def test_lm_head_bias_enters_the_training_logits():
    """The debug llama with a unit-normal ``lm_head_bias`` leaf: the JAX
    forward adds it after the lm head (transformer.py:764-765), and so
    does the port's.  Without it (the port before the repair) the two
    differ by the bias itself, 3.32 at most on these ids; with it, by
    fp32 rounding."""
    from deepspeed_tpu.models.llama import llama_config as jllama
    from deepspeed_tpu_torch.models.llama import llama_config as tllama
    jcfg, tcfg = jllama("debug", dtype=jnp.float32), tllama(
        "debug", dtype=torch.float32)
    tree = jax.tree.map(np.array, meta.unbox(
        JT.init_params(jcfg, jax.random.key(0))))
    rng = np.random.default_rng(3)
    tree["lm_head_bias"] = rng.standard_normal(jcfg.vocab_size).astype(
        np.float32)
    ids = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ref = np.asarray(JT.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(ids)))
    params = from_jax(tree, tcfg, device="cpu")
    assert "lm_head_bias" in params
    got = TT.forward(tcfg, params, torch.from_numpy(ids)).numpy()
    assert np.abs(got - ref).max() <= LOGIT_TOL * np.abs(ref).max()
    del params["lm_head_bias"]
    without = TT.forward(tcfg, params, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ref - without,
                               np.broadcast_to(tree["lm_head_bias"],
                                               ref.shape), atol=1e-4)


@pytest.mark.parametrize("family", ["gpt2", "phi3"])
def test_packed_positions_match_jax_and_leak_across_sequences(family):
    """Two sequences of 16 packed in one row with positions 0..15, 0..15:
    the port's logits and gradients equal JAX's.  The mask is
    ``positions[q] >= positions[k]`` with no segment term (JAX
    transformer.py:704), so a query of the first sequence attends to
    keys of the second that share or precede its position: changing
    only the second sequence's tokens moves the first one's logits, by
    the same amount in both packages (a reference behaviour, kept;
    ROADMAP Queue 3)."""
    jcfg, tcfg = _configs(family)
    tree = _noisy_tree(jcfg, family)
    jm, tm = _models(family, jcfg, tcfg)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (1, S)).astype(np.int32)
    pos = np.tile(np.arange(S // 2, dtype=np.int32), 2)[None]
    batch = {"input_ids": ids, "positions": pos}
    j_loss, j_grads, j_logits = _jax_loss_grads(jm, tree, batch)
    t_loss, params, t_logits = _port_loss_grads(tm, tree, batch)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    scale = np.abs(j_logits).max()
    assert np.abs(t_logits - j_logits).max() <= LOGIT_TOL * scale
    assert_grads_close(params, j_grads)

    other = dict(batch, input_ids=ids.copy())
    other["input_ids"][0, S // 2:] = (ids[0, S // 2:] + 1) % 128
    _, _, j_other = _jax_loss_grads(jm, tree, other)
    _, _, t_other = _port_loss_grads(tm, tree, other)
    j_leak = np.abs(j_other[0, :S // 2] - j_logits[0, :S // 2]).max(-1)
    t_leak = np.abs(t_other[0, :S // 2] - t_logits[0, :S // 2]).max(-1)
    assert j_leak[0] > 1e-2 and t_leak[0] > 1e-2
    np.testing.assert_allclose(t_leak, j_leak, atol=LOGIT_TOL * scale)


# ---------------------------------------------------------------------------
# chip_smoke.py's padded-batch limits, on a CPU stand-in
# ---------------------------------------------------------------------------

# chip_smoke.py holds a right-padded bf16 micro-batch (the einsum path)
# against its rows unpadded (the flash path): |delta loss| / loss <= 1e-3
# and, per leaf but the key bias, rms(grad delta) / rms(grad) <= 5e-2
PAD_LOSS_REL_TOL = 1e-3
PAD_GRAD_RMS_REL_TOL = 5e-2


def _padded_vs_rows(model, params, ids, lengths, count_pads=False):
    """(loss rel, max grad rms rel but bk) of the padded micro-batch
    against its rows alone; ``count_pads`` drops the mask from the loss
    (a fault: the padding labels count)."""
    params_c = tree_map(
        lambda t: t.detach().to(torch.bfloat16).requires_grad_(), params)
    leaves = tree_leaves(params_c)
    am = (torch.arange(ids.shape[1])[None]
          < torch.tensor(lengths)[:, None]).int()
    batch = {"input_ids": torch.where(am == 1, ids, 0),
             "attention_mask": am}
    if count_pads:
        logits = model.logits(params_c, batch)
        loss_p = TT.cross_entropy_loss(logits[:, :-1],
                                       batch["input_ids"][:, 1:])
    else:
        loss_p = model.loss(params_c, batch)
    loss_p.backward()
    grads_p = [c.grad.float() for c in leaves]
    for c in leaves:
        c.grad = None
    counts = [n - 1 for n in lengths]
    loss_u = 0.0
    for i, n in enumerate(lengths):
        li = model.loss(params_c, {"input_ids": batch["input_ids"][i:i + 1,
                                                                   :n]})
        (li * (counts[i] / sum(counts))).backward()
        loss_u += float(li.detach()) * counts[i] / sum(counts)
    rms = [float((a - c.grad.float()).pow(2).mean().sqrt()
                 / c.grad.float().pow(2).mean().sqrt())
           for n, a, c in zip(named_leaves(params_c), grads_p, leaves)
           if not n.endswith("['bk']")]
    return abs(float(loss_p.detach()) - loss_u) / loss_u, max(rms)


@pytest.mark.parametrize("layers", [2, 8])
def test_padded_limits_pass_rounding_and_fail_counted_pads(layers):
    """A bf16 GPT at E = 128 with drawn norms and biases: the right-padded
    micro-batch (a full row and one of two thirds) on the einsum path
    against its rows unpadded on the flash path (plain versions, which
    round like the kernels) passes the limits; the same batch with its
    padding labels counted fails them."""
    from deepspeed_tpu_torch.models.gpt import gpt_config
    s = 128
    cfg = gpt_config("debug", hidden_size=128, intermediate_size=512,
                     num_layers=layers, max_seq_len=s, vocab_size=512)
    model = TT.CausalLM(cfg)
    params = model.init_params(seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)

    def noisy(node):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                noisy(leaf)
            elif key == "scale" or key.startswith("b"):
                noise = torch.randn(leaf.shape, generator=g)
                node[key] = 1 + 0.1 * noise if key == "scale" \
                    else 0.02 * noise
    noisy(params)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, s)))
    lengths = [s, 2 * s // 3]
    loss_rel, grad_rms = _padded_vs_rows(model, params, ids, lengths)
    print(f"padded vs rows: loss {loss_rel:.2e}, gradients {grad_rms:.2e}")
    assert loss_rel <= PAD_LOSS_REL_TOL and grad_rms <= PAD_GRAD_RMS_REL_TOL
    loss_rel, grad_rms = _padded_vs_rows(model, params, ids, lengths,
                                         count_pads=True)
    print(f"pads counted: loss {loss_rel:.2e}, gradients {grad_rms:.2e}")
    assert loss_rel > PAD_LOSS_REL_TOL and grad_rms > PAD_GRAD_RMS_REL_TOL
