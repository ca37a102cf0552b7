"""Weight bridge: a JAX param tree -> the port's param tree.

The JAX package keeps params as nested dicts of arrays (boxed in
``flax.core.meta.Partitioned`` until unboxed).  The caller unboxes the
tree and hands it over with numpy (or array-like) leaves; this module
never imports JAX.  Both layer layouts are accepted and kept:

* scan-stacked (``scan_layers=True``, the default): ``params["layers"]``
  holds one sub-tree whose leaves carry a leading ``L`` dim;
* per-layer: ``params["layers"]["layer_{i}"]`` for ``i < L``.

Leaf layouts are the JAX package's own (``wq [E,H,D]``, ``wk/wv
[E,K,D]``, ``wo [H,D,E]``, ``mlp.wi`` up ``[E,F]``, ``mlp.wg`` gate
``[E,F]``, ``mlp.wo [F,E]``, ``lm_head [E,V]``, ``embed.positions
[max_seq_len,E]``, biases ``bq [H,D]``, ``bk/bv [K,D]``, ``bo [E]``,
``bi [F]``, ``lm_head_bias [V]``; a MoE mlp, ``moe_num_experts = X >
0``: ``gate [E,X]``, ``wi``/``wg [X,E,F]``, ``wo [X,F,E]``), so no
transposes happen here; every leaf the config calls for is checked for
presence and shape.  A weight-only quantised leaf (``{"q", "scale"}``,
``ops/fp_quantizer.quantize_channelwise``) crosses unchanged: codes in
their storage dtype (a 4-bit JAX array, which torch cannot hold
unpacked, as the port's fp4 storage, ``float8_e4m3fn`` of the same
values) and fp32 scales; its codes take the leaf's shape check.

:func:`to_numpy` goes back: training masters (fp32) leave the port as
numpy arrays bit for bit, so a JAX tree bridged in, trained and brought
out compares leaf for leaf with the JAX engine's ``state.params``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..models.transformer import TransformerConfig
from ..tree import tree_map


#: ml_dtypes' fp8 names -> the torch dtype with the same bits
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _to_tensor(leaf, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name in _FP8:
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            _FP8[arr.dtype.name])
        return t.to(device)
    if arr.dtype.name == "float4_e2m1fn":
        # every e2m1 value is an e4m3 value: the port's fp4 storage
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.float8_e4m3fn)
        return t.to(device)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16; the ml_dtypes array reinterprets bit for bit
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        arr = np.ascontiguousarray(arr)
        # JAX hands out read-only buffers; torch needs its own copy
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _norm_shapes(cfg: TransformerConfig, name: str) -> Dict[str, tuple]:
    e = cfg.hidden_size
    shapes = {f"{name}.scale": (e,)}
    if cfg.norm == "layernorm":
        shapes[f"{name}.bias"] = (e,)
    return shapes


def _expected_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Every leaf a layer of ``cfg`` holds (the JAX ``layer_init``)."""
    e, f = cfg.hidden_size, cfg.intermediate_size
    h, k, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
    shapes = {"attn.wq": (e, h, d), "attn.wk": (e, k, d),
              "attn.wv": (e, k, d), "attn.wo": (h, d, e),
              "mlp.wi": (e, f), "mlp.wo": (f, e),
              **_norm_shapes(cfg, "norm1"), **_norm_shapes(cfg, "norm2")}
    if "gated" in cfg.activation:
        shapes["mlp.wg"] = (e, f)
    x = cfg.moe_num_experts
    if x > 0:
        shapes.update({"mlp.gate": (e, x), "mlp.wi": (x, e, f),
                       "mlp.wo": (x, f, e)})
        if "gated" in cfg.activation:
            shapes["mlp.wg"] = (x, e, f)
    if cfg.use_bias or cfg.qkv_bias:
        shapes.update({"attn.bq": (h, d), "attn.bk": (k, d),
                       "attn.bv": (k, d)})
    if cfg.use_bias:
        shapes.update({"attn.bo": (e,), "mlp.bi": (f,), "mlp.bo": (e,)})
    return shapes


def _check_leaves(tree: Dict[str, Any], shapes: Dict[str, tuple],
                  lead: tuple, where: str) -> None:
    for name, shape in shapes.items():
        node = tree
        for key in name.split("."):
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"{where}: missing {name}")
            node = node[key]
        if isinstance(node, dict) and "q" in node:     # quantised leaf
            node = node["q"]
        got = tuple(np.shape(node))
        if got != lead + shape:
            raise ValueError(
                f"{where}.{name}: shape {got}, expected {lead + shape}")


def _check_layer(cfg: TransformerConfig, lp: Dict[str, Any],
                 lead: tuple, where: str) -> None:
    _check_leaves(lp, _expected_shapes(cfg), lead, where)


def _convert(tree, device, dtype, path=()):
    if isinstance(tree, dict) and "q" in tree:          # quantised leaf
        return {k: _to_tensor(v, device, None) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, path + (k,))
                for k, v in tree.items()}
    # norm scales and biases stay fp32 (the JAX norms compute in fp32);
    # matrices and embeddings take ``dtype`` when one is given
    small = (any("norm" in p for p in path) or path[-1].startswith("b")
             or path[-1] == "lm_head_bias")
    return _to_tensor(tree, device, torch.float32 if small else dtype)


def from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
             device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Convert an unboxed JAX param tree into torch tensors on
    ``device``.  ``dtype`` (e.g. ``cfg.dtype``) casts matrices and
    embeddings; ``None`` keeps the source dtypes.  Norm scales and
    biases are cast to fp32.  Raises on a layout that does not
    match ``cfg``."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if cfg.scan_layers:
        if "attn" not in layers:
            raise ValueError("cfg.scan_layers=True but the tree holds "
                             "per-layer 'layer_{i}' sub-trees")
        _check_layer(cfg, layers, (cfg.num_layers,), "layers")
    else:
        for i in range(cfg.num_layers):
            if f"layer_{i}" not in layers:
                raise ValueError(f"per-layer tree lacks layer_{i}")
            _check_layer(cfg, layers[f"layer_{i}"], (), f"layers.layer_{i}")
    v, e = cfg.vocab_size, cfg.hidden_size
    top = {"embed.tokens": (v, e), **_norm_shapes(cfg, "final_norm")}
    if not cfg.tie_embeddings:
        top["lm_head"] = (e, v)
    if cfg.pos_emb == "learned":
        top["embed.positions"] = (cfg.max_seq_len, e)
    if cfg.embed_layernorm:
        top.update(_norm_shapes(cfg, "embed.norm"))
    if "lm_head_bias" in tree:          # the phi family ships one
        top["lm_head_bias"] = (v,)
    _check_leaves(tree, top, (), "params")
    return _convert(tree, dev, dtype)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        # numpy has no bf16: ml_dtypes' (JAX's own) holds the same bits
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    name = next((n for n, d in _FP8.items() if d == t.dtype), None)
    if name is None:
        return t.numpy()
    # numpy has no fp8 either
    return t.view(torch.uint8).numpy().view(getattr(ml_dtypes, name))


def to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's param tree -> numpy leaves in the same layout: the
    inverse of :func:`from_jax` for fp32 leaves, and for bf16 leaves and
    quantised leaves (fp8 codes) as ``ml_dtypes`` arrays."""
    return tree_map(_to_array, tree)
