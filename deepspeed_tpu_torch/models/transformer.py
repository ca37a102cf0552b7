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

The training forward (:func:`forward`, JAX ``transformer.py:646``) runs
pure-causal attention through :class:`~..ops.flash_attention.
FlashAttention` (the flash kernels on the card, their plain versions on
the CPU) unless ``attention_impl="einsum"`` asks for the dense path
(:func:`dot_product_attention`, masked with -1e30 as in JAX).  With
``remat`` each layer runs under ``torch.utils.checkpoint`` and only its
input is kept for the backward (JAX ``nothing_saveable``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..accelerator import DeviceLike, resolve_device
from ..ops.flash_attention import HEAD_DIM, flash_attention
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
    tie_embeddings: bool = False
    use_bias: bool = False
    scan_layers: bool = True
    # training only: recompute each layer in the backward, keeping only
    # its input ("nothing_saveable" is the one policy the port runs)
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    # training only: auto (flash when the mask is pure-causal; on the card
    # that needs bf16 at head_dim 128, else it raises) | flash (force) |
    # einsum (dense path)
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

def _wval(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Weight leaf -> compute dtype (no copy when it already matches)."""
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
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                   device=positions.device), exps)
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
    CPU its plain versions take any layout; on the card the kernels take
    bf16 at head_dim 128, and another layout raises rather than run the
    dense path, which only ``attention_impl="einsum"`` chooses."""
    if device.type == "cpu":
        return
    if cfg.dtype != torch.bfloat16 or cfg.dims_per_head != HEAD_DIM:
        raise outside_slice(
            f"flash attention on the card in {cfg.dtype} at head_dim "
            f"{cfg.dims_per_head} (the kernels take torch.bfloat16 at "
            f"head_dim {HEAD_DIM}; attention_impl='einsum' runs the dense "
            f"path)", "11k (flash kernels in fp32 and at other head dims)")


def flash_dot_product_attention(cfg: TransformerConfig, q, k, v):
    """Causal (+ sliding window) attention through ``FlashAttention``.
    q: [B,S,H,D], k/v: [B,S,K,D] -> [B,S,H,D].  The [B,H,S,D] operands are
    transposed views, read in place; GQA maps query head h to kv head
    h // G instead of repeating K and V (JAX ``transformer.py:319``
    repeats them, which gives the same values and gradients)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          window=cfg.sliding_window)
    return out.transpose(1, 2)


def dot_product_attention(cfg: TransformerConfig, q, k, v,
                          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Dense grouped-query attention with an fp32 softmax.  q: [B,S,H,D],
    k/v: [B,S,K,D], mask [B,S,S] (True = attend); masked scores are
    -1e30, the JAX einsum path's value (not the flash mask value)."""
    b, s, hq, dd = q.shape
    kh = k.shape[2]
    q = q.reshape(b, s, kh, hq // kh, dd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / math.sqrt(dd)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq, dd)


def _attention_block(cfg: TransformerConfig, p, x, sin, cos, mask,
                     use_flash: bool):
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
        out = dot_product_attention(cfg, q, k, v, mask)
    out = proj(out, _wval(p["wo"], dtype), n_in=2)
    if cfg.use_bias:
        out = out + p["bo"].to(dtype)
    return out


def _layer_body(cfg: TransformerConfig, lp, x, sin, cos, mask,
                use_flash: bool):
    h = _norm_apply(cfg, lp["norm1"], x)
    attn_out = _attention_block(cfg, lp["attn"], h, sin, cos, mask,
                                use_flash)
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


def forward(cfg: TransformerConfig, params, input_ids: torch.Tensor
            ) -> torch.Tensor:
    """Token ids [B,S] -> logits [B,S,V] in fp32 (JAX ``forward`` with
    default positions and no padding mask).  Weights are cast to
    ``cfg.dtype``, which is also the activations' dtype."""
    if cfg.pos_emb not in ("rope", "none") or cfg.embed_layernorm:
        raise outside_slice(
            f"training with pos_emb={cfg.pos_emb!r}, "
            f"embed_layernorm={cfg.embed_layernorm}",
            "10 (LayerNorm families in training)")
    if cfg.remat and cfg.remat_policy != "nothing_saveable":
        raise outside_slice(f"remat_policy {cfg.remat_policy!r}",
                            "11a (one-GPU training: other remat policies)")
    b, s = input_ids.shape
    dev = input_ids.device
    # as in JAX, only the pure-causal mask goes to flash under "auto"
    pure_causal = cfg.causal and s > 1
    use_flash = cfg.attention_impl != "einsum" and pure_causal
    if cfg.attention_impl == "flash" and not use_flash:
        raise ValueError(
            "attention_impl='flash' needs causal attention over more than "
            "one token")
    if use_flash:
        check_flash_layout(cfg, dev)

    positions = torch.arange(s, device=dev).expand(b, s)
    table = params["embed"]["tokens"].to(cfg.dtype)
    x = table[input_ids.long()]
    mask = None
    if not use_flash:
        if cfg.causal:
            mask = positions[:, :, None] >= positions[:, None, :]
        else:
            mask = torch.ones((b, s, s), dtype=torch.bool, device=dev)
        if cfg.sliding_window is not None:
            mask = mask & ((positions[:, :, None] - positions[:, None, :])
                           < cfg.sliding_window)
    sin, cos = (rope_table(cfg, positions) if cfg.pos_emb == "rope"
                else (None, None))
    for lp in layer_trees(cfg, params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer_body, cfg, lp, x, sin, cos, mask,
                           use_flash, use_reentrant=False)
        else:
            x = _layer_body(cfg, lp, x, sin, cos, mask, use_flash)
    x = _norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = proj(x, table.T)
    else:
        logits = proj(x, _wval(params["lm_head"], cfg.dtype))
    return logits.float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Token-level cross-entropy in fp32; labels < 0 are ignored."""
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


class CausalLM:
    """Engine-protocol causal LM over the transformer core (JAX
    ``transformer.py:798``).  Batch dict: ``input_ids`` [B,S] and an
    optional ``labels`` [B,S] (default: the inputs shifted by one)."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def init_params(self, seed: int = 0, device: DeviceLike = None):
        """fp32 weights, as the JAX initializer draws them (the masters)."""
        return init_params(self.cfg, seed, device, dtype=torch.float32)

    def logits(self, params, batch) -> torch.Tensor:
        return forward(self.cfg, params, batch["input_ids"])

    def loss(self, params, batch) -> torch.Tensor:
        extra = sorted(set(batch) - {"input_ids", "labels"})
        if extra:
                raise outside_slice(f"batch keys {extra}",
                                "11j (padded and packed training batches)")
        logits = self.logits(params, batch)
        if "labels" in batch:
            return cross_entropy_loss(logits, batch["labels"])
        ids = batch["input_ids"]
        return cross_entropy_loss(logits[:, :-1], ids[:, 1:])
