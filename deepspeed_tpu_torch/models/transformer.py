"""Transformer blocks shared by the serving model, and the training
forward (ids -> fp32 logits) with its loss.

Counterpart of ``deepspeed_tpu/models/transformer.py``.  Parameters are
plain nested dicts of tensors in the JAX package's layout, so a JAX
tree converts leaf for leaf (``checkpoint/from_jax.py``):

    attn.wq [E, H, D]   attn.wk / attn.wv [E, K, D]   attn.wo [H, D, E]
    mlp.wi [E, F] (up)  mlp.wg [E, F] (gate)          mlp.wo [F, E]
    embed.tokens [V, E] lm_head [E, V]                norm*.scale [E]

``scan_layers=True`` stacks every layer leaf along a leading ``L`` dim
under ``params["layers"]``; ``False`` keeps ``params["layers"]
["layer_{i}"]`` sub-trees.  Norms, RoPE and softmax run in fp32 and cast
back, as in the JAX package.

The training forward (:func:`forward`, JAX ``transformer.py:646``) takes
every family (rotary, learned and ALiBi positions, the embedding
LayerNorm, the parallel block, ``lm_head_bias``) and optional
``positions`` and ``attention_mask``.  Pure-causal attention (no mask,
default positions, not ALiBi) runs through :class:`~..ops.
flash_attention.FlashAttention` (the flash kernels on the card, their
plain versions on the CPU) unless ``attention_impl="einsum"`` asks for
the dense path (:func:`dot_product_attention`, masked with -1e30 and
biased by ALiBi's per-key slopes as in JAX), which every other mask
takes.

With ``remat`` each layer runs under ``torch.utils.checkpoint`` and
``remat_policy`` says what its backward finds saved, every policy of
JAX ``_REMAT_POLICIES`` and ``resolve_remat_policy`` (:612-643):
``nothing_saveable`` keeps only the layer's input; ``everything_saveable``
keeps everything (no checkpoint); ``dots_saveable`` keeps the outputs of
every matmul (``aten.mm`` / ``addmm`` and the batched ``bmm`` /
``baddbmm``), ``dots_with_no_batch_dims_saveable`` those of ``mm`` /
``addmm`` only; ``save_attn_out`` keeps the attention's output (the
flash forward's ``(out, lse)``, an operator of its own, or the dense
path's probability-times-value product), so the recomputation skips it.
``offload_attn_out`` and ``offload_dots`` (``cpu_checkpointing``) keep
the same values as ``save_attn_out`` and ``dots_with_no_batch_dims_
saveable`` in pinned host memory and bring them back for the backward;
the layer inputs stay on the device, as in JAX.  The selective policies
run as a pair of dispatch modes around the checkpoint (the forward
records the chosen operators' outputs, the recomputation returns them
in the same order), so a policy changes memory and time, never a
number.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map as _pytree_map
from torch.utils.checkpoint import checkpoint

from ..accelerator import DeviceLike, resolve_device
from ..ops.flash_attention import BWD_HEAD_DIMS, flash_attention, \
    flash_fwd_op
from ..ops.fp_quantizer import dequantize_channelwise
from ..runtime.config import outside_slice
from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    head_dim: Optional[int] = None      # None -> hidden/heads
    max_seq_len: int = 4096
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # silu_gated | gelu (tanh approx) | gelu_exact | gelu_gated | relu
    activation: str = "silu_gated"
    pos_emb: str = "rope"              # rope | learned | alibi | none
    # layernorm over the token embeddings (BLOOM word_embeddings_layernorm)
    embed_layernorm: bool = False
    rope_theta: float = 10000.0
    rope_pct: float = 1.0              # partial rotary (GPT-NeoX/phi)
    causal: bool = True
    # Mistral sliding window: position t attends to (t - window, t]
    sliding_window: Optional[int] = None
    qkv_bias: bool = False
    parallel_residual: bool = False
    # MoE geometry (mixtral): >0 means the mlp block holds stacked expert
    # weights, and the serving model routes it through moe_forward
    moe_num_experts: int = 0
    moe_top_k: int = 2
    tie_embeddings: bool = False
    use_bias: bool = False
    scan_layers: bool = True
    # training only: recompute each layer in the backward, keeping what
    # the policy saves (see resolve_remat_policy)
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    # training only: auto (flash when the mask is pure-causal; on the card
    # that needs bf16 at a head_dim of the flash backward's, 64, 80, 96 or
    # 128, else it raises) | flash (force) | einsum (dense path)
    attention_impl: str = "auto"
    dtype: torch.dtype = torch.bfloat16

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def n_params(self) -> int:
        """Matrices and embeddings (the learned position table and the
        embedding norm included); layer norms and biases are left out."""
        e, f, l, v = (self.hidden_size, self.intermediate_size,
                      self.num_layers, self.vocab_size)
        h, k, d = self.num_heads, self.kv_heads, self.dims_per_head
        attn = e * h * d + 2 * e * k * d + h * d * e
        mlp = e * f * (3 if "gated" in self.activation else 2)
        n = l * (attn + mlp) + v * e * (1 if self.tie_embeddings else 2)
        if self.pos_emb == "learned":
            n += self.max_seq_len * e
        if self.embed_layernorm:
            n += e * (2 if self.norm == "layernorm" else 1)
        return n


# ---------------------------------------------------------------------------
# param construction
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random weights in ``dtype`` (default ``cfg.dtype``; training
    masters pass fp32, the JAX initializer's dtype) built directly on
    ``device`` from a seeded ``torch.Generator`` (normal, scaled by
    fan_in**-0.5 like the JAX initializer; embeddings * 0.02; norm scales
    1 in fp32).  The draws differ from ``jax.random``'s: tests that
    compare against JAX bridge JAX's own tree through
    ``checkpoint/from_jax.py`` instead."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, k, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    lead = (cfg.num_layers,) if cfg.scan_layers else ()

    def dense(shape, fan_in, scale=None):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w.mul_(fan_in ** -0.5 if scale is None else scale)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def norm(shape):
        p = {"scale": ones(shape)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros(shape, device=dev, dtype=torch.float32)
        return p

    def layer(lead):
        p = {
            "attn": {"wq": dense(lead + (e, h, d), e),
                     "wk": dense(lead + (e, k, d), e),
                     "wv": dense(lead + (e, k, d), e),
                     "wo": dense(lead + (h, d, e), h * d)},
            "mlp": {"wi": dense(lead + (e, f), e),
                    "wo": dense(lead + (f, e), f)},
            "norm1": norm(lead + (e,)),
            "norm2": norm(lead + (e,)),
        }
        if "gated" in cfg.activation:
            p["mlp"]["wg"] = dense(lead + (e, f), e)
        if cfg.use_bias or cfg.qkv_bias:
            p["attn"].update(bq=zeros(lead + (h, d)), bk=zeros(lead + (k, d)),
                             bv=zeros(lead + (k, d)))
        if cfg.use_bias:
            p["attn"]["bo"] = zeros(lead + (e,))
            p["mlp"].update(bi=zeros(lead + (f,)), bo=zeros(lead + (e,)))
        return p

    if cfg.scan_layers:
        layers = layer(lead)
    else:
        layers = {f"layer_{i}": layer(()) for i in range(cfg.num_layers)}
    params: Dict[str, Any] = {
        "embed": {"tokens": dense((v, e), 1, scale=0.02)},
        "layers": layers,
        "final_norm": norm((e,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((e, v), e)
    if cfg.pos_emb == "learned":
        params["embed"]["positions"] = dense((cfg.max_seq_len, e), 1,
                                             scale=0.02)
    if cfg.embed_layernorm:
        params["embed"]["norm"] = norm((e,))
    return params


def layer_params(cfg: TransformerConfig, params, i: int):
    """Layer ``i``'s sub-tree in either layout (a view into the stacked
    leaves when ``scan_layers``)."""
    layers = params["layers"]
    if cfg.scan_layers:
        return tree_map(lambda leaf: leaf[i], layers)
    return layers[f"layer_{i}"]


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------

def _wval(p, dtype: torch.dtype) -> torch.Tensor:
    """Weight leaf -> compute dtype (no copy when it already matches).
    A channel-quantised leaf (``{"q", "scale"}`` from
    ``ops/fp_quantizer.quantize_channelwise``) is dequantised as JAX
    ``transformer.py:233-240`` does, ``(q.float() * scale).to(dtype)``:
    on the card by the dequantise kernel."""
    if isinstance(p, dict) and "q" in p:
        return dequantize_channelwise(p, dtype)
    return p.to(dtype)


def proj(x: torch.Tensor, w: torch.Tensor, n_in: int = 1) -> torch.Tensor:
    """Contract the trailing ``n_in`` dims of ``x`` with the leading
    ``n_in`` dims of ``w`` (the einsums ``sqe,ehd->sqhd`` and
    ``sqhd,hde->sqe``) as one matmul."""
    k = math.prod(w.shape[:n_in])
    out_shape = x.shape[:x.dim() - n_in] + w.shape[n_in:]
    y = x.reshape(-1, k) @ w.reshape(k, -1)
    return y.reshape(out_shape)


def _norm_apply(cfg: TransformerConfig, p, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    else:
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rope_table(cfg: TransformerConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    d = int(cfg.dims_per_head * cfg.rope_pct)
    d -= d % 2
    exps = -torch.arange(0, d, 2, dtype=torch.float32,
                         device=positions.device) / d
    # theta as a Python number: no host-to-device copy per call, which a
    # CUDA graph's capture refuses
    freqs = torch.pow(float(cfg.rope_theta), exps)
    angles = positions[..., None].float() * freqs          # [S, Q, d/2]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [S, Q, H, D]; rotates INTERLEAVED pairs (x[..., 0::2],
    x[..., 1::2]) in fp32 — not the half-split layout of HF checkpoints.
    With a partial table only the leading ``2 * n_freq`` dims rotate."""
    rot = 2 * sin.shape[-1]
    head = x[..., :rot].float()
    x1, x2 = head[..., 0::2], head[..., 1::2]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(head.shape).to(x.dtype)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


def _activation(cfg: TransformerConfig, gate, up):
    if cfg.activation == "silu_gated":
        return F.silu(gate) * up
    if cfg.activation == "gelu_gated":           # jax.nn.gelu: tanh approx
        return F.gelu(gate, approximate="tanh") * up
    if cfg.activation == "relu":
        return F.relu(up)
    if cfg.activation == "gelu_exact":
        return F.gelu(up)
    return F.gelu(up, approximate="tanh")


def _mlp_block(cfg: TransformerConfig, p, x: torch.Tensor) -> torch.Tensor:
    """``act(x @ wg) * (x @ wi)``: ``wi`` is the UP projection and ``wg``
    the GATE (JAX ``transformer.py:162,169,282``)."""
    dtype = cfg.dtype
    up = proj(x, _wval(p["wi"], dtype))
    if cfg.use_bias:
        up = up + p["bi"].to(dtype)
    gate = proj(x, _wval(p["wg"], dtype)) if "wg" in p else None
    h = _activation(cfg, gate, up)
    out = proj(h, _wval(p["wo"], dtype))
    if cfg.use_bias:
        out = out + p["bo"].to(dtype)
    return out


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (geometric in 2^(-8/n), with the standard
    interleave extension for non-power-of-two head counts)."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]
    k = 2 ** int(np.floor(np.log2(n_heads)))
    slopes = pow2(k)
    if k < n_heads:
        slopes += pow2(2 * k)[0::2][: n_heads - k]
    return np.asarray(slopes, np.float32)


# ---------------------------------------------------------------------------
# training forward (JAX transformer.py:460-824)
# ---------------------------------------------------------------------------

def check_flash_layout(cfg: TransformerConfig, device: torch.device) -> None:
    """Raise unless the flash path takes this model on ``device``.  On the
    CPU its plain versions take any layout; on the card training needs the
    backward kernels, which take bf16 at head_dim 64, 80, 96 and 128, and
    another layout raises rather than run the dense path, which only
    ``attention_impl="einsum"`` chooses."""
    if device.type == "cpu":
        return
    if cfg.dtype != torch.bfloat16 or cfg.dims_per_head not in BWD_HEAD_DIMS:
        dims = ", ".join(map(str, BWD_HEAD_DIMS))
        raise outside_slice(
            f"flash attention on the card in {cfg.dtype} at head_dim "
            f"{cfg.dims_per_head} (the flash backward kernels take "
            f"torch.bfloat16 at head_dim {dims}; attention_impl='einsum' "
            f"runs the dense path)",
            "11k (the flash backward in fp32 and at other head dims)")


# ---------------------------------------------------------------------------
# remat policies (JAX transformer.py:612-643)
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: the matmuls without batch dims (``proj``'s 2-D products)
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
#: every matmul (the dense attention's batched einsums too)
_DOTS = _DOTS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}
#: the attention output inside an ``_attention_output`` region: the flash
#: forward's operator, or the dense path's last product
_ATTN_OUT = frozenset({_aten.bmm.default, flash_fwd_op._opoverload})


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """What a checkpointed layer keeps for its backward.  ``saves`` holds
    "dots", "dots_no_batch" and "attn_out"; ``offload`` keeps them in
    pinned host memory; ``checkpoint`` False keeps everything."""
    name: str
    saves: FrozenSet[str] = frozenset()
    offload: bool = False
    checkpoint: bool = True


_REMAT_POLICIES = {
    "nothing_saveable": RematPolicy("nothing_saveable"),
    "everything_saveable": RematPolicy("everything_saveable",
                                       checkpoint=False),
    "dots_saveable": RematPolicy("dots_saveable", frozenset({"dots"})),
    "dots_with_no_batch_dims_saveable": RematPolicy(
        "dots_with_no_batch_dims_saveable", frozenset({"dots_no_batch"})),
    # the attention outputs: the backward never re-runs the flash forward
    "save_attn_out": RematPolicy("save_attn_out", frozenset({"attn_out"})),
}


def resolve_remat_policy(name: str) -> RematPolicy:
    """Remat-policy lookup, the host-offload variants behind
    ``cpu_checkpointing`` included (JAX ``resolve_remat_policy``)."""
    if name in _REMAT_POLICIES:
        return _REMAT_POLICIES[name]
    if name == "offload_attn_out":
        return RematPolicy(name, frozenset({"attn_out"}), offload=True)
    if name == "offload_dots":
        return RematPolicy(name, frozenset({"dots_no_batch"}), offload=True)
    raise ValueError(
        f"unknown remat policy {name!r}; known: "
        f"{sorted(_REMAT_POLICIES) + ['offload_attn_out', 'offload_dots']}")


#: the policies, in the JAX order of the error message above
REMAT_POLICY_NAMES = tuple(sorted(_REMAT_POLICIES)) + ("offload_attn_out",
                                                       "offload_dots")

_region = threading.local()


@contextlib.contextmanager
def _attention_output():
    """Marks the operator that computes the attention output (JAX names
    it ``attn_out`` with ``checkpoint_name``).  Thread-local: the
    recomputation may run on the autograd engine's thread."""
    _region.depth = getattr(_region, "depth", 0) + 1
    try:
        yield
    finally:
        _region.depth -= 1


class _HostCopy:
    """A saved value in pinned host memory, and the device it left."""
    __slots__ = ("host", "device")

    def __init__(self, host: torch.Tensor, device: torch.device):
        self.host, self.device = host, device


class _SavePolicy:
    def __init__(self, policy: RematPolicy):
        ops = set()
        if "dots" in policy.saves:
            ops |= _DOTS
        if "dots_no_batch" in policy.saves:
            ops |= _DOTS_NO_BATCH
        self.ops = frozenset(ops)
        self.attn_out = "attn_out" in policy.saves
        self.offload = policy.offload

    def saves(self, func) -> bool:
        if self.attn_out and getattr(_region, "depth", 0) and \
                func in _ATTN_OUT:
            return True
        return func in self.ops

    def keep(self, x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if self.offload and x.device.type == "cuda":
            host = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                       device="cpu", pin_memory=True)
            host.copy_(x, non_blocking=True)
            return _HostCopy(host, x.device)
        return x

    @staticmethod
    def fetch(x):
        if isinstance(x, _HostCopy):
            return x.host.to(x.device, non_blocking=True)
        return x


class _SaveMode(TorchDispatchMode):
    """The forward: run every operator, record the chosen ones' outputs."""

    def __init__(self, policy: _SavePolicy, storage: list):
        super().__init__()
        self.policy, self.storage = policy, storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.policy.saves(func):
            self.storage.append(_pytree_map(self.policy.keep, out))
        return out


class _RecomputeMode(TorchDispatchMode):
    """The recomputation: the chosen operators return what the forward
    recorded, in order; the others run again."""

    def __init__(self, policy: _SavePolicy, storage: list):
        super().__init__()
        self.policy, self.storage = policy, storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.policy.saves(func):
            return _pytree_map(self.policy.fetch, self.storage.pop(0))
        return func(*args, **(kwargs or {}))


def remat_call(policy: RematPolicy, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` with ``policy``."""
    if not policy.saves:
        return checkpoint(fn, *args, use_reentrant=False)
    save = _SavePolicy(policy)

    def contexts():
        storage: list = []
        return _SaveMode(save, storage), _RecomputeMode(save, storage)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


def flash_dot_product_attention(cfg: TransformerConfig, q, k, v):
    """Causal (+ sliding window) attention through ``FlashAttention``.
    q: [B,S,H,D], k/v: [B,S,K,D] -> [B,S,H,D].  The [B,H,S,D] operands are
    transposed views, read in place; GQA maps query head h to kv head
    h // G instead of repeating K and V (JAX ``transformer.py:319``
    repeats them, which gives the same values and gradients)."""
    with _attention_output():
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True,
                              window=cfg.sliding_window)
    return out.transpose(1, 2)


def dot_product_attention(cfg: TransformerConfig, q, k, v,
                          mask: Optional[torch.Tensor],
                          attn_bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Dense grouped-query attention with an fp32 softmax.  q: [B,S,H,D],
    k/v: [B,S,K,D], mask [B,S,S] (True = attend), attn_bias [B,H,T] fp32
    added to every query row's scores (ALiBi); masked scores are -1e30,
    the JAX einsum path's value (not the flash mask value)."""
    b, s, hq, dd = q.shape
    kh = k.shape[2]
    q = q.reshape(b, s, kh, hq // kh, dd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / math.sqrt(dd)
    scores = scores.float()
    if attn_bias is not None:
        scores = scores + attn_bias.reshape(b, kh, hq // kh, 1,
                                            attn_bias.shape[-1])
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    with _attention_output():
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq, dd)


def _attention_block(cfg: TransformerConfig, p, x, sin, cos, mask,
                     use_flash: bool, attn_bias=None):
    dtype = cfg.dtype
    q = proj(x, _wval(p["wq"], dtype))
    k = proj(x, _wval(p["wk"], dtype))
    v = proj(x, _wval(p["wv"], dtype))
    if cfg.use_bias or cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    if use_flash:
        out = flash_dot_product_attention(cfg, q, k, v)
    else:
        out = dot_product_attention(cfg, q, k, v, mask, attn_bias)
    out = proj(out, _wval(p["wo"], dtype), n_in=2)
    if cfg.use_bias:
        out = out + p["bo"].to(dtype)
    return out


def _layer_body(cfg: TransformerConfig, lp, x, sin, cos, mask,
                use_flash: bool, attn_bias=None):
    h = _norm_apply(cfg, lp["norm1"], x)
    attn_out = _attention_block(cfg, lp["attn"], h, sin, cos, mask,
                                use_flash, attn_bias)
    if cfg.parallel_residual:
        h2 = _norm_apply(cfg, lp["norm2"], x)
        return x + attn_out + _mlp_block(cfg, lp["mlp"], h2)
    x = x + attn_out
    h = _norm_apply(cfg, lp["norm2"], x)
    return x + _mlp_block(cfg, lp["mlp"], h)


def _unbind_tree(tree, n: int) -> List[Dict[str, Any]]:
    """Stacked layer leaves -> n per-layer trees of views.  ``unbind``
    (not indexing) so the backward stacks the n layer gradients of a
    leaf once instead of adding n full-size zero-padded copies."""
    if isinstance(tree, dict):
        subs = {k: _unbind_tree(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def layer_trees(cfg: TransformerConfig, params) -> List[Dict[str, Any]]:
    """Every layer's sub-tree, in order, in either layout."""
    if cfg.scan_layers:
        return _unbind_tree(params["layers"], cfg.num_layers)
    return [params["layers"][f"layer_{i}"] for i in range(cfg.num_layers)]


def forward(cfg: TransformerConfig, params, input_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids [B,S] -> logits [B,S,V] in fp32 (JAX ``forward``).
    ``positions`` [B,S] (packed sequences) and ``attention_mask`` [B,S]
    (1 = a real token) are optional; with either, or ALiBi, attention
    takes the dense path.  Weights are cast to ``cfg.dtype``, which is
    also the activations' dtype."""
    policy = resolve_remat_policy(cfg.remat_policy) if cfg.remat else None
    remat = (policy is not None and policy.checkpoint
             and torch.is_grad_enabled())
    b, s = input_ids.shape
    dev = input_ids.device
    # as in JAX, only the dense-causal case goes to flash: default
    # positions (no packing), no padding mask, no ALiBi bias
    pure_causal = (cfg.causal and attention_mask is None
                   and positions is None and cfg.pos_emb != "alibi"
                   and s > 1)
    use_flash = cfg.attention_impl != "einsum" and pure_causal
    if cfg.attention_impl == "flash" and not use_flash:
        raise ValueError(
            "attention_impl='flash' requires causal attention over more "
            "than one token with default positions and no attention_mask")
    if use_flash:
        check_flash_layout(cfg, dev)

    if positions is None:
        if cfg.pos_emb == "learned" and attention_mask is not None:
            # padded batches: positions count only attended tokens (HF
            # OPTLearnedPositionalEmbedding, JAX transformer.py:672-680)
            am = attention_mask.to(torch.int64)
            positions = (torch.cumsum(am, dim=-1) - 1).clamp(min=0)
        else:
            positions = torch.arange(s, device=dev).expand(b, s)
    positions = positions.long()
    table = params["embed"]["tokens"].to(cfg.dtype)
    x = table[input_ids.long()]
    if cfg.pos_emb == "learned":
        x = x + params["embed"]["positions"].to(cfg.dtype)[positions]
    if cfg.embed_layernorm:           # BLOOM word_embeddings_layernorm
        x = _norm_apply(cfg, params["embed"]["norm"], x)

    # [B, S(q), S(k)], not needed by flash (the kernels mask blockwise)
    mask = None
    if not use_flash:
        if cfg.causal:
            mask = positions[:, :, None] >= positions[:, None, :]
        else:
            mask = torch.ones((b, s, s), dtype=torch.bool, device=dev)
        if cfg.sliding_window is not None:
            mask = mask & ((positions[:, :, None] - positions[:, None, :])
                           < cfg.sliding_window)
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, :].bool()
    sin, cos = (rope_table(cfg, positions) if cfg.pos_emb == "rope"
                else (None, None))
    # ALiBi: a per-head bias on the KEY position alone (softmax is
    # shift-invariant along a query row), [B, H, T] fp32
    attn_bias = None
    if cfg.pos_emb == "alibi":
        slopes = torch.from_numpy(alibi_slopes(cfg.num_heads)).to(dev)
        attn_bias = slopes[None, :, None] * positions[:, None, :].float()
    for lp in layer_trees(cfg, params):
        if remat:
            x = remat_call(policy, _layer_body, cfg, lp, x, sin, cos, mask,
                           use_flash, attn_bias)
        else:
            x = _layer_body(cfg, lp, x, sin, cos, mask, use_flash, attn_bias)
    x = _norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = proj(x, table.T)
    else:
        logits = proj(x, _wval(params["lm_head"], cfg.dtype))
    if "lm_head_bias" in params:     # the phi family ships one
        logits = logits + params["lm_head_bias"].to(cfg.dtype)
    return logits.float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level cross-entropy in fp32; labels < 0, and positions where
    ``mask`` is 0, are ignored."""
    valid = labels >= 0
    if mask is not None:
        valid = valid & mask.bool()
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


class CausalLM:
    """Engine-protocol causal LM over the transformer core (JAX
    ``transformer.py:798``).  Batch dict: ``input_ids`` [B,S], and
    optional ``labels`` [B,S] (default: the inputs shifted by one),
    ``attention_mask`` [B,S] and ``positions`` [B,S]."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def init_params(self, seed: int = 0, device: DeviceLike = None):
        """fp32 weights, as the JAX initializer draws them (the masters)."""
        return init_params(self.cfg, seed, device, dtype=torch.float32)

    def logits(self, params, batch) -> torch.Tensor:
        return forward(self.cfg, params, batch["input_ids"],
                       positions=batch.get("positions"),
                       attention_mask=batch.get("attention_mask"))

    def loss(self, params, batch) -> torch.Tensor:
        logits = self.logits(params, batch)
        mask = batch.get("attention_mask")
        if "labels" in batch:
            return cross_entropy_loss(logits, batch["labels"], mask)
        # next-token prediction: shift
        ids = batch["input_ids"]
        return cross_entropy_loss(logits[:, :-1], ids[:, 1:],
                                  mask[:, 1:] if mask is not None else None)
