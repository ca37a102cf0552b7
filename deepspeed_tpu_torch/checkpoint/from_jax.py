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
``bi [F]``, ``lm_head_bias [V]``), so no transposes happen here; every
leaf the config calls for is checked for presence and shape.

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


def _to_tensor(leaf, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(leaf)
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
        got = tuple(np.shape(node))
        if got != lead + shape:
            raise ValueError(
                f"{where}.{name}: shape {got}, expected {lead + shape}")


def _check_layer(cfg: TransformerConfig, lp: Dict[str, Any],
                 lead: tuple, where: str) -> None:
    _check_leaves(lp, _expected_shapes(cfg), lead, where)


def _convert(tree, device, dtype, path=()):
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


def to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's param tree -> numpy leaves in the same layout: the
    inverse of :func:`from_jax` for fp32 leaves (numpy has no bf16)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
