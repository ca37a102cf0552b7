"""The process mesh: ``torch.distributed`` groups laid out as JAX's mesh.

Counterpart of ``deepspeed_tpu/parallel/topology.py`` (``MESH_AXES``
:43, ``BATCH_AXES`` / ``GRAD_REDUCE_AXES`` :46-47, ``TopologyConfig``
:51-84, ``MeshTopology`` :86-164).  The JAX package names the axes of
one ``jax.sharding.Mesh``; here each rank process is one position of the
same mesh, and an axis (or a set of axes) is the process group of the
ranks that differ only along it.

Ranks are laid out in JAX's axis order, outermost first: rank ``r`` sits
at the position of ``r`` in ``np.arange(W).reshape(shape)``, as device
``r`` does in a JAX mesh built over ``jax.devices()[:W]``, so rank r's
shard of a leaf is the JAX array's ``addressable_shards[r]``.  A group
over several axes orders its members row-major over those axes, which is
the order of JAX's tiled collectives over a tuple of axis names.

The port's engine runs the data, fsdp, hpz, seq and tensor axes; pipe
and expert (ROADMAP Queue 1 item 11h) raise when they are larger than 1.
``tensor`` is innermost, so at ``tensor=2`` ranks 0 and 1 form a tensor
group.  Every group the engine reduces or gathers over is made at
construction, in one fixed order on every rank, as
``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import logger

# Canonical axis order, outermost first (JAX topology.py:43).
MESH_AXES: Tuple[str, ...] = ("pipe", "data", "expert", "fsdp", "hpz",
                              "seq", "tensor")
BATCH_AXES = ("data", "expert", "fsdp", "hpz")  # batch dim of inputs
GRAD_REDUCE_AXES = ("data", "expert", "fsdp", "hpz", "seq")  # grad psum

#: axes larger than 1 that the port does not run yet, with their item
WAITING_AXES = {"pipe": "11h (pipeline)",
                "expert": "11h (expert parallelism)"}

#: the model-parallel axes: a leaf sharded over ``tensor`` is each rank's
#: own leaf, and the heads and tokens of attention split over both
MODEL_AXES = ("seq", "tensor")


def _subsets(axes: Tuple[str, ...]) -> Tuple[Tuple[str, ...], ...]:
    return tuple(sub for n in range(1, len(axes) + 1)
                 for sub in itertools.combinations(axes, n))


#: the axis sets the engine, the model and the collective scheduler
#: reduce or gather over; their groups are made at construction: every
#: subset of the gradient axes (a reduction over the axes a layout does
#: not shard), each ZeRO shard group with ``tensor`` added (the norms of
#: tensor-sharded leaves), ``tensor`` and ``seq`` with the batch axes
#: (the loss), and the model-parallel pair
GROUP_AXES: Tuple[Tuple[str, ...], ...] = (
    _subsets(GRAD_REDUCE_AXES)
    + tuple(a + ("tensor",) for a in _subsets(("fsdp", "hpz")))
    + (("tensor",), MODEL_AXES, BATCH_AXES + ("seq",)))


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Sizes of each mesh axis.  -1 means "absorb remaining devices"."""
    pipe: int = 1
    data: int = -1
    expert: int = 1
    fsdp: int = 1
    hpz: int = 1
    seq: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> "TopologyConfig":
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        free = [a for a, s in sizes.items() if s == -1]
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if n_devices % fixed != 0:
            raise ValueError(
                f"mesh axes {sizes} do not divide device count {n_devices}")
        rem = n_devices // fixed
        if not free:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh axes {sizes} (product {fixed}) != device count "
                    f"{n_devices}")
        else:
            # the first free axis absorbs everything, the rest get 1
            sizes[free[0]] = rem
            for a in free[1:]:
                sizes[a] = 1
        return TopologyConfig(**sizes)


def check_ported_axes(cfg: TopologyConfig) -> None:
    """Raise for an axis larger than 1 that the port does not run."""
    for axis, item in WAITING_AXES.items():
        if getattr(cfg, axis) > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {getattr(cfg, axis)} is not in "
                f"the port yet (ROADMAP Queue 1 item {item})")


class MeshTopology:
    """A resolved process mesh plus DeepSpeed-style group arithmetic.

    ``world_size`` and ``rank`` default to the initialised default
    process group's (1 and 0 without one).  ``devices`` is accepted for
    JAX's signature: its length is the world size.  ``groups=False``
    makes no process group (the arithmetic alone, for any rank of any
    world: what the tests use to ask where rank r sits)."""

    def __init__(self, config: Optional[TopologyConfig] = None,
                 devices: Optional[Sequence] = None,
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None, groups: bool = True):
        from ..comm import comm
        if world_size is None:
            world_size = (len(devices) if devices is not None
                          else comm.get_world_size())
        self._world = int(world_size)
        self.rank = comm.get_rank() if rank is None else int(rank)
        cfg = (config or TopologyConfig()).resolve(self._world)
        check_ported_axes(cfg)
        self.config = cfg
        self.shape = tuple(getattr(cfg, a) for a in MESH_AXES)
        #: this rank's position, one index per axis of ``MESH_AXES``
        self.coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(
            self.rank, self.shape))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if groups and self._world > 1:
            self._make_groups()
        logger.info("MeshTopology: %s over %d ranks (rank %d)",
                    {a: s for a, s in zip(MESH_AXES, self.shape) if s > 1}
                    or "{single}", self._world, self.rank)

    # -- groups ----------------------------------------------------------
    def live_axes(self, axes: Iterable[str]) -> Tuple[str, ...]:
        """``axes`` in mesh order, without those of size 1."""
        axes = set(axes)
        return tuple(a for a in MESH_AXES
                     if a in axes and self.axis_size(a) > 1)

    def members(self, axes: Iterable[str], rank: Optional[int] = None
                ) -> Tuple[int, ...]:
        """The ranks that differ from ``rank`` (default this one) only
        along ``axes``, row-major over those axes."""
        axes = self.live_axes(axes)
        pos = np.unravel_index(self.rank if rank is None else rank,
                               self.shape)
        out = []
        for idx in itertools.product(*(range(self.axis_size(a))
                                       for a in axes)):
            p = list(pos)
            for a, i in zip(axes, idx):
                p[MESH_AXES.index(a)] = i
            out.append(int(np.ravel_multi_index(p, self.shape)))
        return tuple(out)

    def _make_groups(self) -> None:
        import torch.distributed as dist
        for axes in dict.fromkeys(self.live_axes(a) for a in GROUP_AXES):
            if not axes:
                continue
            if math.prod(self.axis_size(a) for a in axes) == self._world:
                self._groups[axes] = dist.group.WORLD
                continue
            mine = self.members(axes)
            seen = set()
            for r in range(self._world):
                ranks = self.members(axes, r)
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if ranks == mine:
                    self._groups[axes] = g

    def group(self, axes: Iterable[str]):
        """The process group over ``axes`` (None when they span one
        rank: nothing to communicate)."""
        live = self.live_axes(axes)
        if not live:
            return None
        if live not in self._groups:
            raise KeyError(f"no process group over {live}: the mesh makes "
                           f"groups over {list(self._groups)}")
        return self._groups[live]

    def index(self, axes: Iterable[str]) -> int:
        """This rank's index in the group over ``axes`` (row-major)."""
        return self.members(axes).index(self.rank)

    def size(self, axes: Iterable[str]) -> int:
        return math.prod(self.axis_size(a) for a in self.live_axes(axes))

    # -- DeepSpeed-compatible size accessors ------------------------------
    @property
    def world_size(self) -> int:
        return self._world

    def axis_size(self, axis: str) -> int:
        return getattr(self.config, axis)

    @property
    def pp_world_size(self) -> int:
        return self.config.pipe

    @property
    def tp_world_size(self) -> int:
        return self.config.tensor

    @property
    def sp_world_size(self) -> int:
        return self.config.seq

    @property
    def ep_world_size(self) -> int:
        return self.config.expert

    @property
    def fsdp_world_size(self) -> int:
        return self.config.fsdp

    @property
    def hpz_world_size(self) -> int:
        return self.config.hpz

    @property
    def dp_world_size(self) -> int:
        """Gradient-reduction world size (reference dp group size)."""
        return math.prod(self.axis_size(a) for a in GRAD_REDUCE_AXES)

    @property
    def batch_shard_size(self) -> int:
        """Number of distinct micro-batch shards along the batch dim."""
        return math.prod(self.axis_size(a) for a in BATCH_AXES)

    # -- batch placement --------------------------------------------------
    def batch_slice(self, rows: int) -> slice:
        """This rank's rows of a global batch of ``rows``: the block of
        the batch dimension that JAX's ``batch_spec`` (sharded over
        ``BATCH_AXES``) places on this device."""
        shards = self.batch_shard_size
        if rows % shards:
            raise ValueError(
                f"batch dim {rows} not divisible by the {shards} batch "
                f"shards (mesh data x expert x fsdp x hpz); pad the batch or "
                f"adjust the mesh")
        per = rows // shards
        i = self.index(BATCH_AXES)
        return slice(i * per, (i + 1) * per)

    def seq_slice(self, length: int) -> slice:
        """This rank's tokens of a sequence of ``length``: the block of
        the sequence dimension that JAX's ``batch_spec`` shards over
        ``seq`` (``topology.py:152-160``)."""
        sp = self.sp_world_size
        if length % sp:
            raise ValueError(
                f"sequence length {length} not divisible by the {sp} seq "
                f"shards; pad the sequence or adjust the mesh")
        per = length // sp
        i = self.coords["seq"]
        return slice(i * per, (i + 1) * per)

    def __repr__(self) -> str:
        sizes = {a: self.axis_size(a) for a in MESH_AXES}
        return f"MeshTopology({sizes})"

