"""ZeRO partitioning: which dimension of each leaf a rank holds a slice of.

Counterpart of ``deepspeed_tpu/runtime/zero/partitioner.py``
(``_largest_divisible_dim`` :61, ``add_fsdp_axis`` :73, ``_blocked_dims``
:195, ``param_spec`` / ``master_spec`` / ``grad_spec`` :201-250,
``describe`` :274).  The JAX package expresses a stage as shardings over
mesh axes and lets XLA insert the collectives; the specs here are the
same entries (``None``, an axis name, or a tuple of axis names per
dimension, as a ``PartitionSpec`` holds them), chosen by the same rules,
and the engine runs the collectives itself:

* ``param_spec`` — the compute copy: replicated below stage 3; at stage
  3 sharded over ``fsdp`` (over ``hpz`` alone under ZeRO++ hpZ), leaves
  under ``persistence_threshold`` elements kept whole;
* ``master_spec`` — fp32 masters and optimizer moments from stage 1:
  sharded over ``fsdp`` (``fsdp`` x ``hpz`` under hpZ) down to two
  elements, degrading to a prefix of the axes when the product divides
  no dimension; a leaf no size divides stays replicated;
* ``grad_spec`` — the master's from stage 2 (gradients are born as the
  shard), else the parameter's.

The port's layout of a sharded dimension is each rank's contiguous
slice, in the order of the group over the spec's axes (row-major over
them), which is where the JAX array keeps that rank's shard.  The
port's leaves carry no boxes: a transformer's logical axis names come
from the table beside its ``init_params`` (``models/transformer.py``
``logical_axes``), and the sharding rules (``default_sharding_rules``
:141, ``logical_to_mesh_spec`` :125, ``_base_spec`` :175, which drops
an axis that does not divide its dimension) map them onto mesh axes:
``heads``, ``mlp`` and ``vocab`` over ``tensor``.  The blocked
dimensions (the stacked ``layers`` dimension a scan slices, JAX
``_blocked_dims``) come from the model: dim 0 of every leaf under
``params["layers"]`` of a transformer with ``scan_layers``.

A spec may shard two dimensions of a leaf: the ``tensor`` entry of the
base spec and the ZeRO entry ``add_fsdp_axis`` puts on another
dimension.  The engine treats a rank's tensor shard as its own leaf
(:func:`tensor_layout_of`) and takes ZeRO's pieces inside it over the
other axes (:func:`layout_of` skips the ``tensor`` entry), so rank r's
piece is the tensor chunk's ZeRO chunk: the JAX array's shard on
device r.

At stage 3 the engine hands the model shards; :class:`ParamGather`
gathers each layer's leaves just before the layer runs (inside its
remat region, so a re-run of the forward gathers again) through
:class:`GatherParam`, whose backward reduce-scatters the gradient.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from ...utils.logging import logger

#: a PartitionSpec's entries: per dimension None, an axis or axes
Spec = Tuple[Any, ...]


def _largest_divisible_dim(shape: Tuple[int, ...], divisor: int,
                           taken_dims: set) -> Optional[int]:
    best = None
    best_size = 0
    for i, s in enumerate(shape):
        if i in taken_dims:
            continue
        if s % divisor == 0 and s > best_size:
            best, best_size = i, s
    return best


def add_fsdp_axis(spec: Spec, shape: Tuple[int, ...], fsdp_size: int,
                  min_size: int = 2 ** 12,
                  blocked_dims: Optional[set] = None,
                  axes: Tuple[str, ...] = ("fsdp",),
                  axis_sizes: Optional[Tuple[int, ...]] = None) -> Spec:
    """ZeRO sharding on the largest still-unsharded dimension that
    ``fsdp_size`` divides (JAX ``add_fsdp_axis``): leaves under
    ``min_size`` elements stay replicated, ``blocked_dims`` stay whole,
    and with ``axis_sizes`` a prefix of ``axes`` takes the leaf when the
    full product divides no dimension."""
    if fsdp_size <= 1:
        return spec
    if math.prod(shape) < min_size:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    taken = {i for i, e in enumerate(entries) if e is not None}
    if blocked_dims:
        taken |= blocked_dims
    dim = _largest_divisible_dim(shape, fsdp_size, taken)
    use_axes = axes
    if dim is None and axis_sizes is not None and len(axes) > 1:
        for cut in range(len(axes) - 1, 0, -1):
            sub_size = math.prod(axis_sizes[:cut])
            if sub_size <= 1:
                continue
            dim = _largest_divisible_dim(shape, sub_size, taken)
            if dim is not None:
                use_axes = axes[:cut]
                logger.warning(
                    "zero partitioner: shape %s not divisible by the full "
                    "%s=%d partition; degrading to %s=%d (leaf stays "
                    "replicated over %s)", shape, axes, fsdp_size,
                    use_axes, sub_size, axes[cut:])
                break
    if dim is None:
        logger.warning(
            "zero partitioner: no dim of shape %s divisible by %d on axes "
            "%s — leaf stays REPLICATED (memory savings lost)",
            shape, fsdp_size, axes)
        return spec
    entries[dim] = use_axes if len(use_axes) > 1 else use_axes[0]
    return tuple(entries)


def logical_to_mesh_spec(logical_axes: Tuple[Optional[str], ...],
                         rules: Dict[str, Any]) -> Spec:
    """Logical names -> mesh entries by ``rules``; a mesh axis shards one
    dimension at most (JAX ``logical_to_mesh_spec``)."""
    entries = []
    used: Set[str] = set()
    for name in logical_axes:
        axis = rules.get(name) if name is not None else None
        if axis is not None and axis in used:
            axis = None
        if axis is not None:
            used.update(axis if isinstance(axis, tuple) else (axis,))
        entries.append(axis)
    return tuple(entries)


def default_sharding_rules(topology, zero_stage: int = 0) -> Dict[str, Any]:
    """Logical axis -> mesh axis (JAX ``default_sharding_rules``): heads,
    mlp, qkv and vocab over ``tensor`` when it is larger than 1; expert
    and pipeline axes raise in the port before they could map."""
    tp = "tensor" if topology.tp_world_size > 1 else None
    return {"embed": None, "vocab": tp, "mlp": tp, "heads": tp, "kv": None,
            "qkv": tp,
            "expert": "expert" if topology.ep_world_size > 1 else None,
            "layers": None,
            "stages": "pipe" if topology.pp_world_size > 1 else None,
            "norm": None}


def leaf_names_of(model: Any) -> Optional[Callable[[str], Any]]:
    """path -> the JAX logical axis names of a transformer's leaf (None
    for another model)."""
    from ...models.transformer import TransformerConfig, logical_axes
    cfg = getattr(model, "cfg", None)
    if not isinstance(cfg, TransformerConfig):
        return None
    return lambda path: logical_axes(cfg, path)


def spec_repr(spec: Spec) -> str:
    """``PartitionSpec(...)`` as JAX prints it (a tuple's repr)."""
    return f"PartitionSpec{tuple(spec)!r}" if spec else "PartitionSpec()"


def names_leaves(model: Any) -> bool:
    """Whether JAX boxes this model's leaves with logical axis names (a
    transformer's)."""
    from ...models.transformer import TransformerConfig
    return isinstance(getattr(model, "cfg", None), TransformerConfig)


def blocked_dims_of(model: Any) -> Callable[[str], Set[int]]:
    """path -> the dimensions of that leaf that stay whole: dim 0 of the
    stacked layer leaves of a transformer with ``scan_layers``."""
    cfg = getattr(model, "cfg", None)
    stacked = bool(getattr(cfg, "scan_layers", False))

    def blocked(path: str) -> Set[int]:
        return {0} if stacked and path.startswith("layers/") else set()
    return blocked


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where a rank's piece of a leaf lies: ``dim`` None for the whole
    leaf, else chunk ``index`` of ``count`` contiguous chunks of
    ``dim``, the chunks spread over the group of ``axes``."""
    dim: Optional[int]
    axes: Tuple[str, ...] = ()
    count: int = 1
    index: int = 0

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def local_shape(self, shape) -> Tuple[int, ...]:
        shape = tuple(shape)
        if self.dim is None:
            return shape
        return (shape[:self.dim] + (shape[self.dim] // self.count,)
                + shape[self.dim + 1:])

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of ``full`` (a view)."""
        if self.dim is None:
            return full
        c = full.shape[self.dim] // self.count
        return full.narrow(self.dim, self.index * c, c)


def _entry_layout(spec: Spec, topology, tensor: bool) -> ShardLayout:
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if ("tensor" in axes) != tensor:
            continue
        live = topology.live_axes(axes)
        if not live:
            return ShardLayout(None)
        return ShardLayout(dim, live, topology.size(live),
                           topology.index(live))
    return ShardLayout(None)


def layout_of(spec: Spec, topology) -> ShardLayout:
    """The ZeRO layout a spec gives this rank of ``topology``: its entry
    over the data-parallel axes, cut from the rank's tensor shard (the
    ``tensor`` entry is :func:`tensor_layout_of`'s)."""
    return _entry_layout(spec, topology, tensor=False)


def tensor_layout_of(spec: Spec, topology) -> ShardLayout:
    """The ``tensor`` entry's layout: the rank's tensor shard of the
    whole leaf, which the engine holds as the leaf."""
    return _entry_layout(spec, topology, tensor=True)


def cut(full: torch.Tensor, spec: Spec, topology) -> torch.Tensor:
    """Rank's piece of the whole leaf ``full`` by ``spec``: its tensor
    shard's ZeRO chunk (a view)."""
    return layout_of(spec, topology).shard(
        tensor_layout_of(spec, topology).shard(full))


def gather_shard(shard: torch.Tensor, layout: ShardLayout, topology,
                 async_op: bool = False):
    """The whole leaf from every rank's piece (an all-gather over the
    layout's group along its dimension; with ``async_op`` a
    ``comm.Pending``)."""
    from ...comm import comm
    if not layout.sharded:
        return comm.Pending(shard) if async_op else shard
    return comm.all_gather(shard, topology.group(layout.axes),
                           axis=layout.dim, async_op=async_op)


def scatter_sum(full: torch.Tensor, layout: ShardLayout, topology,
                async_op: bool = False):
    """This rank's piece of the sum of every rank's ``full`` over the
    layout's group (a reduce-scatter along its dimension; with
    ``async_op`` a ``comm.Pending``)."""
    from ...comm import comm
    if not layout.sharded:
        return comm.Pending(full) if async_op else full
    return comm.reduce_scatter(full, topology.group(layout.axes),
                               axis=layout.dim, async_op=async_op)


class ZeroPartitioner:
    """Per-leaf specs for params, masters and gradients (JAX
    ``ZeroPartitioner``).  A leaf is a tensor (or anything with a
    ``shape``); ``blocked`` gives a leaf's whole dimensions from its
    ``/``-joined path."""

    def __init__(self, topology, stage: int,
                 persistence_threshold: int = 2 ** 12,
                 blocked: Optional[Callable[[str], Set[int]]] = None,
                 names: Optional[Callable[[str], Any]] = None):
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"invalid ZeRO stage {stage}")
        self.topology = topology
        self.stage = stage
        self.persistence_threshold = persistence_threshold
        self.blocked = blocked or (lambda path: set())
        #: path -> the leaf's logical axis names (``leaf_names_of``);
        #: None: every leaf is bare
        self.names = names
        self.rules = default_sharding_rules(topology, stage)

    def _base(self, shape: Tuple[int, ...], path: str = "") -> Spec:
        """JAX ``_base_spec``: the rules over the leaf's logical names,
        an entry whose axes do not divide its dimension dropped (2 kv
        heads under ``tensor=4`` stay replicated); none for a bare
        leaf."""
        if self.names is None:
            return ()
        names = self.names(path)
        if not names:
            return ()
        spec = logical_to_mesh_spec(tuple(names), self.rules)
        out = []
        for i, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                size = math.prod(self.topology.axis_size(a) for a in axes)
                if i >= len(shape) or shape[i] % size:
                    entry = None
            out.append(entry)
        return tuple(out)

    # -- per-leaf specs ---------------------------------------------------
    def param_spec(self, leaf: Any, path: str = "") -> Spec:
        """The compute copy's spec: from stage 3 over ``fsdp``, or over
        ``hpz`` alone under hpZ (the per-layer gathers then stay inside
        the hpZ group)."""
        shape = tuple(leaf.shape)
        spec = self._base(shape, path)
        if self.stage >= 3:
            hpz = self.topology.hpz_world_size
            if hpz > 1:
                spec = add_fsdp_axis(spec, shape, hpz,
                                     self.persistence_threshold,
                                     blocked_dims=self.blocked(path),
                                     axes=("hpz",))
            else:
                spec = add_fsdp_axis(spec, shape,
                                     self.topology.fsdp_world_size,
                                     self.persistence_threshold,
                                     blocked_dims=self.blocked(path))
        return spec

    def master_spec(self, leaf: Any, path: str = "") -> Spec:
        """The fp32 masters' and moments' spec: the full ZeRO partition
        (``fsdp`` x ``hpz`` under hpZ) from stage 1, even small leaves."""
        shape = tuple(leaf.shape)
        spec = self._base(shape, path)
        if self.stage >= 1:
            topo = self.topology
            hpz = topo.hpz_world_size
            total = topo.fsdp_world_size * hpz
            axes = ("fsdp", "hpz") if hpz > 1 else ("fsdp",)
            sizes = ((topo.fsdp_world_size, hpz) if hpz > 1
                     else (topo.fsdp_world_size,))
            spec = add_fsdp_axis(spec, shape, total, min_size=2,
                                 blocked_dims=self.blocked(path),
                                 axes=axes, axis_sizes=sizes)
        return spec

    def grad_spec(self, leaf: Any, path: str = "") -> Spec:
        """Gradients: born as the master's shard from stage 2."""
        if self.stage >= 2:
            return self.master_spec(leaf, path)
        return self.param_spec(leaf, path)

    # -- tree-level -------------------------------------------------------
    def _tree(self, fn, params, prefix: str = ""):
        if isinstance(params, dict):
            return {k: self._tree(fn, v, f"{prefix}{k}/")
                    for k, v in params.items()}
        return fn(params, prefix[:-1])

    def tree_param_specs(self, params: Any) -> Any:
        return self._tree(self.param_spec, params)

    def tree_master_specs(self, params: Any) -> Any:
        return self._tree(self.master_spec, params)

    def param_layout(self, leaf: Any, path: str = "") -> ShardLayout:
        return layout_of(self.param_spec(leaf, path), self.topology)

    def master_layout(self, leaf: Any, path: str = "") -> ShardLayout:
        return layout_of(self.master_spec(leaf, path), self.topology)

    def tensor_layout(self, leaf: Any, path: str = "") -> ShardLayout:
        """The leaf's tensor shard (the same in every spec: the base
        spec's entry)."""
        return tensor_layout_of(self._base(tuple(leaf.shape), path),
                                self.topology)

    def describe(self, params: Any) -> str:
        lines = [f"ZeRO stage {self.stage} over "
                 f"fsdp={self.topology.fsdp_world_size}"]
        specs = []

        def walk(tree, keys):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    walk(tree[k], keys + [k])
            else:
                specs.append(("".join(f"[{k!r}]" for k in keys),
                              tree))
        walk(self.tree_param_specs(params), [])
        for key, spec in specs[:50]:
            lines.append(f"  {key}: {spec_repr(spec)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# stage 3: each layer's leaves gathered just before use
# ---------------------------------------------------------------------------

class GatherParam(torch.autograd.Function):
    """The whole leaf in ``dtype`` from this rank's fp32 piece: the
    all-gather carries ``dtype`` (the compute dtype's 2-byte words in
    bf16; ``pending``, when given, is that gather already in flight);
    the backward reduce-scatters the gradient in ``dtype`` over the same
    group (the transpose of the gather, as XLA's in JAX), so the piece's
    gradient is summed over the group (autograd widens it to the piece's
    fp32)."""

    @staticmethod
    def forward(ctx, piece: torch.Tensor, layout: ShardLayout, topology,
                dtype: torch.dtype, pending=None):
        ctx.layout, ctx.topology, ctx.dtype = layout, topology, dtype
        if pending is not None:
            return pending.wait()
        return gather_shard(piece.detach().to(dtype), layout, topology)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (scatter_sum(grad.to(ctx.dtype).contiguous(), ctx.layout,
                            ctx.topology), None, None, None, None)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "zero3_param_gather", default=None)


def active_param_gather() -> Optional["ParamGather"]:
    """The stage-3 gather of the step being run (None outside one)."""
    return _ACTIVE.get()


class ParamGather:
    """Stage 3's gathers for one forward: ``layouts`` maps each leaf's
    ``/``-joined path to its piece's layout, ``stacked`` says which
    paths carry a leading layer dimension (sliced before the gather)."""

    def __init__(self, layouts: Dict[str, ShardLayout], topology,
                 dtype: torch.dtype, stacked: bool):
        self.layouts = layouts
        self.topology = topology
        self.dtype = dtype
        self.stacked = stacked

    def _gathered(self, pieces: List[Tuple[str, torch.Tensor]],
                  dim_shift: int = 0) -> List[torch.Tensor]:
        """Each ``(path, piece)`` whole in the compute dtype: every
        sharded piece's gather is started before the first is waited
        for, so the group's gathers overlap."""
        lays = []
        for path, piece in pieces:
            lay = self.layouts[path]
            if lay.sharded and dim_shift:
                lay = dataclasses.replace(lay, dim=lay.dim - dim_shift)
            lays.append(lay)
        pending = [gather_shard(piece.detach().to(self.dtype), lay,
                                self.topology, async_op=True)
                   if lay.sharded else None
                   for (_, piece), lay in zip(pieces, lays)]
        out = []
        for (_, piece), lay, pend in zip(pieces, lays, pending):
            if lay.sharded:
                out.append(GatherParam.apply(piece, lay, self.topology,
                                             self.dtype, pend))
            else:
                out.append(piece.to(self.dtype)
                           if piece.is_floating_point() else piece)
        return out

    def _tree(self, tree, prefix: str, keep=(), dim_shift: int = 0):
        """``tree`` with its leaves gathered (paths under ``prefix``),
        the top-level keys in ``keep`` left as they are."""
        pieces: List[Tuple[str, torch.Tensor]] = []

        def collect(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    if not (path == prefix and k in keep):
                        collect(v, f"{path}{k}/")
            else:
                pieces.append((path[:-1], node))
        collect(tree, prefix)
        whole = iter(self._gathered(pieces, dim_shift))

        def rebuild(node, path):
            if isinstance(node, dict):
                return {k: (v if path == prefix and k in keep
                            else rebuild(v, f"{path}{k}/"))
                        for k, v in node.items()}
            return next(whole)
        return rebuild(tree, prefix)

    def top(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Every leaf outside ``params["layers"]`` gathered; the layers
        stay pieces."""
        return self._tree(params, "", keep=("layers",))

    def layer(self, lp: Dict[str, Any], i: int) -> Dict[str, Any]:
        """Layer ``i``'s pieces (a per-layer tree) gathered."""
        if self.stacked:
            return self._tree(lp, "layers/", dim_shift=1)
        return self._tree(lp, f"layers/layer_{i}/")

    def tree(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Every leaf gathered (a model that gathers nothing itself)."""
        return self._tree(params, "")

    @contextlib.contextmanager
    def active(self):
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

