"""Transformer building blocks shared by the serving model.

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..accelerator import DeviceLike, resolve_device


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
    pos_emb: str = "rope"              # rope | alibi | none
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
    dtype: torch.dtype = torch.bfloat16

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def n_params(self) -> int:
        e, f, l, v = (self.hidden_size, self.intermediate_size,
                      self.num_layers, self.vocab_size)
        h, k, d = self.num_heads, self.kv_heads, self.dims_per_head
        attn = e * h * d + 2 * e * k * d + h * d * e
        mlp = e * f * (3 if "gated" in self.activation else 2)
        return l * (attn + mlp) + v * e * (1 if self.tie_embeddings else 2)


# ---------------------------------------------------------------------------
# param construction
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights in ``cfg.dtype`` built directly on ``device`` from
    a seeded ``torch.Generator`` (normal, scaled by fan_in**-0.5 like the
    JAX initializer; embeddings * 0.02; norm scales 1 in fp32).  The
    draws differ from ``jax.random``'s: tests that compare against JAX
    bridge JAX's own tree through ``checkpoint/from_jax.py`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, k, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    lead = (cfg.num_layers,) if cfg.scan_layers else ()

    def dense(shape, fan_in, scale=None):
        w = torch.randn(shape, generator=gen, device=dev, dtype=cfg.dtype)
        return w.mul_(fan_in ** -0.5 if scale is None else scale)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=cfg.dtype)

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
    return params


def layer_params(cfg: TransformerConfig, params, i: int):
    """Layer ``i``'s sub-tree in either layout (a view into the stacked
    leaves when ``scan_layers``)."""
    layers = params["layers"]
    if cfg.scan_layers:
        return _index_tree(layers, i)
    return layers[f"layer_{i}"]


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


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
