"""AutoTP: tensor-parallel partition specs for a parameter tree.

Counterpart of ``deepspeed_tpu/module_inject/auto_tp.py`` (``classify``
:55, ``AutoTP`` :77).  A parameter's role comes from its name (the
reference ``tp_parser`` heuristics over HF-style keys):

* **column-parallel** (the output dim is split): q/k/v, gate/up, fused
  qkv, the first MLP linear;
* **row-parallel** (the input dim is split): the attention output, the
  second MLP linear;
* **embed**: the vocabulary dim of an embedding table;
* a dim the degree does not divide stays whole.

``tp_parser`` gives each leaf a :class:`PartitionSpec` (one entry per
dim, the tensor axis's name where it is split), the same entries as the
JAX parser's.  This slice serves on one card: ``tp_size`` 1 (every
spec's split is over one rank, so ``shard`` places the tree whole);
another degree raises, naming ROADMAP Queue 1 item 13
(tensor-parallel serving).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from ..utils.logging import logger

COLUMN_PATTERNS = [
    r"q_proj", r"k_proj", r"v_proj", r"query", r"key", r"value", r"\bwq\b",
    r"\bwk\b", r"\bwv\b", r"qkv", r"gate_proj", r"up_proj", r"\bw1\b",
    r"\bw3\b", r"fc1", r"c_fc", r"dense_h_to_4h", r"wi", r"intermediate",
]
ROW_PATTERNS = [
    r"o_proj", r"out_proj", r"\bwo\b", r"attn[._]out", r"attention[._]output",
    r"down_proj", r"\bw2\b", r"fc2", r"c_proj", r"dense_4h_to_h", r"wo\b",
    r"dense$",
]
EMBED_PATTERNS = [r"embed_tokens", r"\bwte\b", r"word_embeddings",
                  r"lm_head", r"embed_out", r"tokens$", r"unembed"]

_COL = re.compile("|".join(COLUMN_PATTERNS))
_ROW = re.compile("|".join(ROW_PATTERNS))
_EMB = re.compile("|".join(EMBED_PATTERNS))


def classify(name: str) -> Optional[str]:
    """Classify one parameter path: 'column' | 'row' | 'embed' | None."""
    lower = name.lower()
    if _EMB.search(lower):
        return "embed"
    if _COL.search(lower):
        return "column"
    if _ROW.search(lower):
        return "row"
    return None


class PartitionSpec(tuple):
    """One entry per dim: the mesh axis a dim is split over, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _flatten_with_path(tree, path=()):
    if isinstance(tree, PartitionSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (i,))
    else:
        yield path, tree


def _path_str(path) -> str:
    return ".".join(str(p) for p in path)


class AutoTP:
    """Parse a parameter tree into tensor-parallel partition specs."""

    def __init__(self, tp_size: int = 1, tp_axis: str = "tensor",
                 weight_layout: str = "in_out"):
        """``weight_layout``: 'in_out' (the port's [in, out] weights) or
        'out_in' (torch ``Linear``'s [out, in]): which dim 'column' and
        'row' split."""
        if int(tp_size) != 1:
            raise NotImplementedError(
                f"AutoTP at tp_size {tp_size} is not ported yet: the port "
                "serves on one card (ROADMAP Queue 1 item 13)")
        self.tp_axis = tp_axis
        self.layout = weight_layout
        self.tp_size = 1

    def tp_parser(self, params: Any) -> Any:
        """A :class:`PartitionSpec` tree for ``params`` by the name
        heuristics (JAX ``AutoTP.tp_parser``)."""
        def spec_for(path, leaf) -> PartitionSpec:
            name = _path_str(path)
            role = classify(name)
            shape = tuple(getattr(leaf, "shape", ()))
            if role is None or len(shape) == 0:
                return PartitionSpec()
            if len(shape) == 1:
                # column biases split with their outputs; row biases are
                # added after the reduction and stay whole
                if role == "column" and shape[0] % self.tp_size == 0:
                    return PartitionSpec(self.tp_axis)
                return PartitionSpec()
            out_dim = len(shape) - 1 if self.layout == "in_out" \
                else len(shape) - 2
            in_dim = len(shape) - 2 if self.layout == "in_out" \
                else len(shape) - 1
            dim = {"column": out_dim, "row": in_dim}.get(role,
                                                         len(shape) - 2)
            if shape[dim] % self.tp_size != 0:
                logger.debug("AutoTP: %s dim %d (%d) not divisible by "
                             "tp=%d — replicated", name, dim, shape[dim],
                             self.tp_size)
                return PartitionSpec()
            entries: List[Optional[str]] = [None] * len(shape)
            entries[dim] = self.tp_axis
            return PartitionSpec(*entries)

        return _tree_map_with_path(spec_for, params)

    def shard(self, params: Any) -> Any:
        """Place the weights by their specs: over one rank every split
        holds the whole leaf, so the tree is returned as it is."""
        self.tp_parser(params)
        return params

    def replication_report(self, params: Any) -> Dict[str, str]:
        """name -> spec string, to see which weights are split."""
        return {_path_str(path): repr(spec) for path, spec in
                _flatten_with_path(self.tp_parser(params))}
