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
import functools
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
    # training only: the embedding's backward sums the [B*S, E] output
    # cotangent per id into the table gradient (runtime/sparse_tensor.py)
    sparse_gradients: bool = False
    # training across a seq axis: "ulysses" reshards tokens -> heads
    # around the flash kernels (two all-to-alls); "ring" keeps the tokens
    # sharded and circulates K/V blocks (sequence/ring.py).  Wired from
    # the engine config's sequence_parallel.mode
    sp_mode: str = "ulysses"
    # reference activation_checkpointing.partition_activations: the
    # residual saved at each layer boundary is the rank's slice of its
    # tokens over ("seq", "tensor"), gathered again when the layer re-runs
    partition_activations: bool = False
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


#: the JAX package's logical axis names of each leaf below a layer
#: (``transformer.py:150-192``, ``_norm_init`` :199): the ZeRO
#: partitioner's sharding rules map them onto mesh axes
LAYER_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "attn/wq": ("embed", "heads", None), "attn/wk": ("embed", "kv", None),
    "attn/wv": ("embed", "kv", None), "attn/wo": ("heads", None, "embed"),
    "attn/bq": ("heads", None), "attn/bk": ("kv", None),
    "attn/bv": ("kv", None), "attn/bo": ("embed",),
    "mlp/wi": ("embed", "mlp"), "mlp/wg": ("embed", "mlp"),
    "mlp/wo": ("mlp", "embed"), "mlp/bi": ("mlp",), "mlp/bo": ("embed",),
    **{f"{n}/{k}": ("norm",) for n in ("norm1", "norm2")
       for k in ("scale", "bias")},
}
#: the same for the leaves outside the layers; ``lm_head_bias`` is a
#: bare leaf in JAX (no names: replicated over ``tensor``)
TOP_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed/tokens": ("vocab", "embed"), "embed/positions": (None, "embed"),
    "lm_head": ("embed", "vocab"),
    **{f"{n}/{k}": ("norm",) for n in ("embed/norm", "final_norm")
       for k in ("scale", "bias")},
}


def logical_axes(cfg: TransformerConfig, path: str
                 ) -> Optional[Tuple[Optional[str], ...]]:
    """The JAX logical axis names of the leaf at ``path`` (``/``-joined),
    a stacked layer leaf's led by "layers"; None for a bare leaf."""
    parts = path.split("/")
    if parts[0] == "layers":
        if cfg.scan_layers:
            names = LAYER_AXES.get("/".join(parts[1:]))
            return None if names is None else ("layers",) + names
        return LAYER_AXES.get("/".join(parts[2:]))
    return TOP_AXES.get(path)


def keeps_fp32(path) -> bool:
    """Whether the leaf at ``path`` (its keys) stays fp32 in a tree of
    compute-dtype weights: norm scales and biases (the norm kernels take
    fp32 vectors; the JAX norms compute in fp32) and every bias."""
    last = str(path[-1])
    return (any("norm" in str(p) for p in path) or last.startswith("b")
            or last == "lm_head_bias")


def cast_params(params, dtype: torch.dtype, device: DeviceLike = None,
                copy: bool = False, path=()):
    """A serving tree of ``params``: every floating leaf on ``device`` in
    ``dtype`` but those :func:`keeps_fp32` names, which are fp32 (a new
    tensor wherever the device or dtype changes, or always with
    ``copy``)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device, copy, path + (k,))
                for k, v in params.items()}
    t = params.detach()
    if device is not None:
        t = t.to(device)
    if t.is_floating_point():
        dtype = torch.float32 if keeps_fp32(path) else dtype
    else:
        dtype = t.dtype
    return t.to(dtype, copy=copy)


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


def _mlp_block(cfg: TransformerConfig, p, x: torch.Tensor,
               plan=None) -> torch.Tensor:
    """``act(x @ wg) * (x @ wi)``: ``wi`` is the UP projection and ``wg``
    the GATE (JAX ``transformer.py:162,169,282``).  Where ``plan`` (the
    forward's :class:`_Plan`) splits the ``mlp`` columns, ``wi`` / ``wg``
    are column-parallel and ``wo`` row-parallel over ``tensor``, its
    output summed before the bias."""
    dtype = cfg.dtype
    mp = plan.mp if plan is not None and plan.mlp else None
    ws = [_wval(p["wi"], dtype)] + ([_wval(p["wg"], dtype)]
                                    if "wg" in p else [])
    up, *gate = _project(x, ws, mp)
    if cfg.use_bias:
        up = up + p["bi"].to(dtype)
    h = _activation(cfg, gate[0] if gate else None, up)
    out = _project_out(h, _wval(p["wo"], dtype), mp)
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


# ---------------------------------------------------------------------------
# the layout of one forward: one rank, or tensor and seq ranks (JAX
# transformer.py:300-583, :645-770, where GSPMD inserts the collectives
# that parallel/tensor_parallel.py writes out)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Plan:
    """How one forward splits over the ``tensor`` and ``seq`` ranks of
    ``mp`` (``tensor_parallel.ONE_RANK`` splits nothing).  ``heads`` /
    ``mlp`` / ``vocab``: whether those dims are tensor-sharded (the
    partitioner's divisibility rule: a dim the axis does not divide
    stays whole); ``kv_index``: the kv heads (indices into wk's K) this
    rank's local q heads read, None for all of them; ``attn``: "flash",
    "ring" or "einsum"; ``part``: ``partition_activations`` slices the
    layer boundaries' tokens over ``tensor``."""
    mp: Any
    heads: bool
    mlp: bool
    vocab: bool
    kv_index: Optional[Tuple[int, ...]]
    attn: str
    part: bool


def _plan(cfg: TransformerConfig, mp, seq_len: int, pure_causal: bool
          ) -> _Plan:
    """The split of this forward (JAX ``_ring_ok`` :383, ``_flash_ok``
    :401, ``_divisible_head_axes`` :429, the flash layout :330-348).  As
    in JAX, only the dense-causal case goes to flash or the ring:
    default positions (no packing), no padding mask, no ALiBi bias."""
    tp, sp = mp.tp, mp.sp
    h, k = cfg.num_heads, cfg.kv_heads
    heads = tp > 1 and h % tp == 0
    use_ring = cfg.sp_mode == "ring" and pure_causal and sp > 1
    shards = sp * tp
    use_flash = (not use_ring and cfg.attention_impl != "einsum"
                 and pure_causal and h % shards == 0 and shards <= h)
    if cfg.attention_impl == "flash" and not (use_flash or use_ring):
        raise ValueError(
            "attention_impl='flash' requires causal attention with default "
            "positions, no attention_mask, and a mesh the head layout "
            "divides")
    attn = "ring" if use_ring else ("flash" if use_flash else "einsum")
    local = h // tp if heads else h
    first = mp.tp_index * local if heads else 0
    # the kv heads divide the head shards: each rank reads its block of
    # them; else K/V repeat up to the q heads before the split (JAX
    # :336-345), and the ring lifts GQA to whole heads (:317-320)
    kv_shards = (sp if attn == "flash" else 1) * (tp if heads else 1)
    groups = h // k
    kv_index = None
    if k % kv_shards or (attn == "ring" and groups > 1):
        kv_index = tuple(q // groups for q in range(first, first + local))
    elif heads:
        per = k // tp
        kv_index = tuple(range(mp.tp_index * per, (mp.tp_index + 1) * per))
    part = (cfg.partition_activations and tp > 1
            and (seq_len // sp) % tp == 0)
    return _Plan(mp, heads, tp > 1 and cfg.intermediate_size % tp == 0,
                 tp > 1 and cfg.vocab_size % tp == 0, kv_index, attn, part)


def _project(x: torch.Tensor, ws, mp) -> List[torch.Tensor]:
    """``x`` by each of ``ws``: a column-parallel region's entry over
    ``mp``'s tensor ranks (``tensor_parallel.column_parallel``), or this
    rank's products when ``mp`` is None (the dim is whole here)."""
    if mp is None:
        return [proj(x, w) for w in ws]
    from ..parallel.tensor_parallel import column_parallel
    return column_parallel(x, ws, mp)


def _project_out(a: torch.Tensor, w: torch.Tensor, mp,
                 n_in: int = 1) -> torch.Tensor:
    """``proj(a, w, n_in)``, summed over ``mp``'s tensor ranks (the
    row-parallel exit) unless ``mp`` is None."""
    if mp is None:
        return proj(a, w, n_in=n_in)
    from ..parallel.tensor_parallel import row_parallel
    return row_parallel(a, w, mp, n_in=n_in)


def _select_kv(w: torch.Tensor, plan: _Plan, dim: int) -> torch.Tensor:
    """wk / wv (or their biases) for this rank's heads: the replicated
    leaf enters the tensor region (its gradient is summed over the
    ranks' heads), then the kv heads the rank reads are taken."""
    if plan.kv_index is None:
        return w
    if plan.heads:
        from ..parallel.tensor_parallel import copy_to_tensor
        w = copy_to_tensor(w, plan.mp)
    idx = torch.tensor(plan.kv_index, device=w.device)
    return w.index_select(dim, idx)


def _attention_block(cfg: TransformerConfig, plan: _Plan, p, x, sin, cos,
                     mask, attn_bias):
    """Attention with q/k/v column-parallel and ``wo`` row-parallel over
    ``tensor`` where the heads split (``wo``'s output summed before the
    bias), the flash kernels (with Ulysses' all-to-alls over ``seq``),
    the ring, or the dense path as ``plan`` says."""
    mp, dtype = plan.mp, cfg.dtype
    tmp = mp if plan.heads else None
    ws = (_wval(p["wq"], dtype), _select_kv(_wval(p["wk"], dtype), plan, 1),
          _select_kv(_wval(p["wv"], dtype), plan, 1))
    q, k, v = _project(x, ws, tmp)
    if cfg.use_bias or cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + _select_kv(p["bk"].to(dtype), plan, 0)
        v = v + _select_kv(p["bv"].to(dtype), plan, 0)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    if plan.attn == "ring":
        # tokens stay seq-sharded; K/V blocks travel the seq ring
        from ..sequence.ring import RingAttention
        with _attention_output():
            out = RingAttention.apply(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                mp.sp_group, mp.sp, mp.sp_index, True,
                1.0 / math.sqrt(q.shape[-1]), cfg.sliding_window)
        out = out.transpose(1, 2)
    elif plan.attn == "flash":
        # Ulysses: tokens over seq -> heads over (seq, tensor), the flash
        # kernels on the local heads at the whole sequence, and back
        if mp.sp > 1:
            from ..sequence.layer import seq_all_to_all
            q, k, v = (seq_all_to_all(t, mp.sp_group, 2, 1)
                       for t in (q, k, v))
        out = flash_dot_product_attention(cfg, q, k, v)
        if mp.sp > 1:
            out = seq_all_to_all(out, mp.sp_group, 1, 2)
    else:
        # the dense path: this rank's queries against every key, K and V
        # gathered over the seq ranks
        from ..parallel.tensor_parallel import gather_from_seq
        k, v = gather_from_seq(k, mp, 1), gather_from_seq(v, mp, 1)
        out = dot_product_attention(cfg, q, k, v, mask, attn_bias)
    out = _project_out(out, _wval(p["wo"], dtype), tmp, n_in=2)
    if cfg.use_bias:
        out = out + p["bo"].to(dtype)
    return out


def _layer_body(cfg: TransformerConfig, plan: _Plan, zero3, i: int, lp, x,
                sin, cos, mask, attn_bias):
    """Layer ``i``; under ZeRO-3 across ranks its pieces are gathered
    first (``runtime/zero/partitioner.ParamGather``), inside the remat
    region, so a recomputed forward gathers the layer again."""
    if zero3 is not None:
        lp = zero3.layer(lp, i)
    if plan.part:
        from ..parallel.tensor_parallel import gather_from_tensor
        x = gather_from_tensor(x, plan.mp, 1)
    h = _norm_apply(cfg, lp["norm1"], x)
    attn_out = _attention_block(cfg, plan, lp["attn"], h, sin, cos, mask,
                                attn_bias)
    if cfg.parallel_residual:
        h2 = _norm_apply(cfg, lp["norm2"], x)
        return x + attn_out + _mlp_block(cfg, lp["mlp"], h2, plan)
    x = x + attn_out
    h = _norm_apply(cfg, lp["norm2"], x)
    return x + _mlp_block(cfg, lp["mlp"], h, plan)


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


def _gather_seq_const(x: torch.Tensor, mp) -> torch.Tensor:
    """A non-differentiable [B, S/P] input (positions, a mask) whole."""
    if mp.sp == 1:
        return x
    from ..comm import comm
    return comm.all_gather.__wrapped__(x.contiguous(), mp.sp_group, axis=1)


def forward(cfg: TransformerConfig, params, input_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids -> fp32 logits (JAX ``forward``).  ``positions`` (packed
    sequences) and ``attention_mask`` (1 = a real token) are optional;
    with either, or ALiBi, attention takes the dense path.  Weights are
    cast to ``cfg.dtype``, which is also the activations' dtype.

    On one rank: ids [B,S] -> logits [B,S,V].  Inside a step whose
    model-parallel layout splits (``tensor_parallel.
    active_model_parallel``): this rank's tokens ``[B, S/sp]`` (seq block
    ``mp.sp_index``) -> its vocab shard of the logits ``[B, S/sp, V/tp]``
    (whole V where tp does not divide it).  Activations between blocks
    are then seq-sharded and the same on every tensor rank (JAX
    ``_constrain(x, BATCH, "seq", None)``); attention and the MLP are
    Megatron regions (heads and ``mlp`` columns over ``tensor``); the lm
    head is vocab-parallel."""
    from ..parallel.tensor_parallel import (ONE_RANK, active_model_parallel,
                                            gather_from_tensor,
                                            split_to_tensor)
    from ..runtime.zero.partitioner import active_param_gather
    mp = active_model_parallel() or ONE_RANK
    policy = resolve_remat_policy(cfg.remat_policy) if cfg.remat else None
    remat = (policy is not None and policy.checkpoint
             and torch.is_grad_enabled())
    b, sl = input_ids.shape
    s = sl * mp.sp
    dev = input_ids.device
    # ZeRO-3 across ranks: params holds this rank's pieces; the leaves
    # outside the layers are gathered here, each layer's in its body
    zero3 = active_param_gather()
    if zero3 is not None:
        params = zero3.top(params)
    pure_causal = (cfg.causal and attention_mask is None
                   and positions is None and cfg.pos_emb != "alibi"
                   and s > 1)
    plan = _plan(cfg, mp, s, pure_causal)
    if plan.attn == "flash":
        check_flash_layout(cfg, dev)
    off = mp.sp_index * sl
    key_mask = (_gather_seq_const(attention_mask, mp)
                if attention_mask is not None else None)
    if positions is None:
        if cfg.pos_emb == "learned" and key_mask is not None:
            # padded batches: positions count only attended tokens (HF
            # OPTLearnedPositionalEmbedding, JAX transformer.py:672-680)
            am = key_mask.to(torch.int64)
            positions = (torch.cumsum(am, dim=-1) - 1).clamp(min=0)
            positions = positions[:, off:off + sl]
        else:
            positions = torch.arange(off, off + sl, device=dev).expand(b, sl)
    positions = positions.long()
    table = params["embed"]["tokens"].to(cfg.dtype)
    whole = gather_from_tensor(table, mp, 0) if plan.vocab else table
    if cfg.sparse_gradients:
        from ..runtime.sparse_tensor import embedding_lookup
        x = embedding_lookup(whole, input_ids)
    else:
        x = whole[input_ids.long()]
    if cfg.pos_emb == "learned":
        x = x + params["embed"]["positions"].to(cfg.dtype)[positions]
    if cfg.embed_layernorm:           # BLOOM word_embeddings_layernorm
        x = _norm_apply(cfg, params["embed"]["norm"], x)

    # [B, S/sp (q), S (k)], not needed by flash or the ring (the kernels
    # mask blockwise)
    mask = attn_bias = None
    if plan.attn == "einsum":
        kpos = _gather_seq_const(positions, mp)
        if cfg.causal:
            mask = positions[:, :, None] >= kpos[:, None, :]
        else:
            mask = torch.ones((b, sl, s), dtype=torch.bool, device=dev)
        if cfg.sliding_window is not None:
            mask = mask & ((positions[:, :, None] - kpos[:, None, :])
                           < cfg.sliding_window)
        if key_mask is not None:
            mask = mask & key_mask[:, None, :].bool()
        if cfg.pos_emb == "alibi":
            # ALiBi: a per-head bias on the KEY position alone (softmax is
            # shift-invariant along a query row), [B, H, T] fp32; each
            # rank takes its heads' slopes (BLOOM's layout under tensor)
            slopes = torch.from_numpy(alibi_slopes(cfg.num_heads)).to(dev)
            if plan.heads:
                n = cfg.num_heads // mp.tp
                slopes = slopes[mp.tp_index * n:(mp.tp_index + 1) * n]
            attn_bias = slopes[None, :, None] * kpos[:, None, :].float()
    sin, cos = (rope_table(cfg, positions) if cfg.pos_emb == "rope"
                else (None, None))
    for i, lp in enumerate(layer_trees(cfg, params)):
        if plan.part:
            # the boundary keeps the rank's slice of its tokens
            x = split_to_tensor(x, mp, 1)
        body = functools.partial(_layer_body, cfg, plan, zero3, i)
        if remat:
            x = remat_call(policy, body, lp, x, sin, cos, mask, attn_bias)
        else:
            x = body(lp, x, sin, cos, mask, attn_bias)
    x = _norm_apply(cfg, params["final_norm"], x)
    head = table.T if cfg.tie_embeddings else _wval(params["lm_head"],
                                                   cfg.dtype)
    logits, = _project(x, [head], mp if plan.vocab else None)
    if "lm_head_bias" in params:     # the phi family ships one
        bias = params["lm_head_bias"].to(cfg.dtype)
        if plan.vocab:
            # a bare leaf in JAX, replicated: each rank adds its columns
            from ..parallel.tensor_parallel import copy_to_tensor
            n = logits.shape[-1]
            bias = copy_to_tensor(bias, mp)[mp.tp_index * n:
                                            (mp.tp_index + 1) * n]
        logits = logits + bias
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
        from ..parallel.tensor_parallel import active_model_parallel
        mp = active_model_parallel()
        if mp is not None:
            return self._loss_parallel(params, batch, mp)
        logits = self.logits(params, batch)
        mask = batch.get("attention_mask")
        if "labels" in batch:
            return cross_entropy_loss(logits, batch["labels"], mask)
        # next-token prediction: shift
        ids = batch["input_ids"]
        return cross_entropy_loss(logits[:, :-1], ids[:, 1:],
                                  mask[:, 1:] if mask is not None else None)

    def _loss_parallel(self, params, batch, mp) -> torch.Tensor:
        """This rank's share of the global mean token loss: its tokens'
        summed negative log-likelihood (over the whole vocabulary from
        its vocab shard, ``vocab_parallel_cross_entropy``) over the
        valid-token count of its batch rows across the seq ranks, so the
        seq ranks' shares sum to the rows' mean.  Across seq ranks the
        engine hands in ``labels`` and ``loss_mask`` built from the whole
        sequence (the next-token shift crosses seq shards)."""
        from ..comm import comm
        from ..parallel.tensor_parallel import vocab_parallel_cross_entropy
        logits = self.logits(params, batch)
        mask = batch.get("attention_mask")
        if "labels" in batch:
            labels = batch["labels"]
            mask = batch.get("loss_mask", mask)
        else:
            ids = batch["input_ids"]
            logits, labels = logits[:, :-1], ids[:, 1:]
            mask = mask[:, 1:] if mask is not None else None
        valid = labels >= 0
        if mask is not None:
            valid = valid & mask.bool()
        n = logits.shape[-1]
        split = n < self.cfg.vocab_size
        nll = vocab_parallel_cross_entropy(
            logits, labels, valid, mp.tp_group if split else None,
            mp.tp_index * n if split else 0)
        count = valid.sum().to(torch.float32)
        if mp.sp > 1:
            count = comm.all_reduce.__wrapped__(count, mp.sp_group)
        return nll.sum() / count.clamp(min=1)

