"""Communication facade over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py``.  The JAX package's
collectives run inside ``shard_map`` over a mesh axis name; here each
takes a ``torch.distributed`` process group, or None for the default
group, where JAX takes the axis name, and keeps JAX's semantics: tiled
gathers and scatters along ``axis``, untiled ones adding or removing an
axis of one entry a member, ``all_to_all(split_axis, concat_axis)``,
rooted ops that return the payload on the root and the input (reduce)
or zeros (gather) elsewhere, and every result a new tensor.  At one
member every collective is the single-member case: an all-reduce or a
tiled all-gather returns its input.

Backends.  :func:`init_distributed` joins the launcher's processes
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with the
backend the caller names, ``"nccl"`` by default: an NCCL join that
cannot happen raises, and nothing switches the backend quietly.  Over
``"gloo"`` CUDA tensors go to gloo as they are; an op it refuses raises.

Every collective is wrapped by :func:`timed_op`, which feeds the comms
logger (``utils/comms_logging.py``) the op's name and message size, as
JAX's does at trace time; here it counts every call.
"""

from __future__ import annotations

import datetime
import functools
import os
import threading
import time
import warnings
from typing import Optional, Sequence

import torch

from ..utils.logging import logger

_comms_logger = None  # lazily constructed CommsLogger


def configure_comms_logger(enabled: bool = True, verbose: bool = False,
                           debug: bool = False):
    global _comms_logger
    from ..utils.comms_logging import CommsLogger
    _comms_logger = CommsLogger(enabled=enabled, verbose=verbose, debug=debug)
    return _comms_logger


def get_comms_logger():
    return _comms_logger


def timed_op(fn):
    """Record the op's name and message size in the comms logger (JAX
    ``timed_op``).  Device time is the profiler's: the logger keeps
    counts and volumes."""

    @functools.wraps(fn)
    def wrapper(tensor, *args, **kwargs):
        if _comms_logger is not None and _comms_logger.enabled:
            _comms_logger.append_traced(fn.__name__, tensor)
        return fn(tensor, *args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def _dist_ready() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def group_size(group=None) -> int:
    """Members of ``group`` (None: the default group); 1 while no
    process group is initialised."""
    if not _dist_ready():
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def _global_rank(group, i: int) -> int:
    """The default group's rank of member ``i`` of ``group``."""
    import torch.distributed as dist
    if group is None:
        return i
    return dist.get_process_group_ranks(group)[i]


def _zeros_unless(cond: bool, t: torch.Tensor) -> torch.Tensor:
    return t if cond else torch.zeros_like(t)


class Pending:
    """A collective in flight (``async_op=True``): :meth:`wait` returns
    its result.  Ops over one member are done when they return one."""

    def __init__(self, out: torch.Tensor, work=None, then=None):
        self._out, self._work, self._then = out, work, then

    def then(self, fn) -> "Pending":
        """The same op with ``fn`` applied to its result."""
        prev = self._then
        return Pending(self._out, self._work,
                       fn if prev is None else (lambda x: fn(prev(x))))

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        out = self._out if self._then is None else self._then(self._out)
        self._then = None
        self._out = out
        return out


def _done(pending: Pending, async_op: bool):
    return pending if async_op else pending.wait()


_TORCH_OPS = {"sum": "SUM", "avg": "SUM", "mean": "SUM", "max": "MAX",
              "min": "MIN"}


def _reduce_op(op: str):
    import torch.distributed as dist
    return getattr(dist.ReduceOp, _TORCH_OPS[op.lower()])


# ---------------------------------------------------------------------------
# collectives (JAX :73-149, :320-414)
# ---------------------------------------------------------------------------

_REDUCE_OPS = ("sum", "SUM", "avg", "AVG", "mean", "max", "MAX", "min",
               "MIN")


def _all_reduce(tensor: torch.Tensor, group, op: str,
                async_op: bool = False):
    import torch.distributed as dist
    n = group_size(group)
    if n == 1:
        return _done(Pending(tensor), async_op)
    out = tensor.contiguous().clone()
    pending = Pending(out, dist.all_reduce(out, op=_reduce_op(op),
                                           group=group, async_op=async_op))
    if op.lower() in ("avg", "mean"):
        pending = pending.then(lambda out: out / n)
    return _done(pending, async_op)


@timed_op
def all_reduce(tensor: torch.Tensor, group=None, op: str = "sum",
               async_op: bool = False):
    """SUM / AVG / MAX / MIN all-reduce over ``group`` (with
    ``async_op`` a :class:`Pending`)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    return _all_reduce(tensor, group, op, async_op)


def _gather_leading(x: torch.Tensor, group, n: int,
                    async_op: bool = False) -> Pending:
    """[n * d0, ...]: the members' ``x`` ([d0, ...]) in member order."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        work = dist.all_gather_into_tensor(out, x, group=group,
                                           async_op=async_op)
    return Pending(out, work)


@timed_op
def all_gather(tensor: torch.Tensor, group=None, axis: int = 0,
               tiled: bool = True, async_op: bool = False):
    """Gather the members' tensors along ``axis`` (``tiled``) or stacked
    on a new axis ``axis`` (with ``async_op`` a :class:`Pending`)."""
    n = group_size(group)
    if n == 1:
        return _done(Pending(tensor if tiled else tensor.unsqueeze(axis)),
                     async_op)
    x = tensor.unsqueeze(axis) if not tiled else tensor
    axis = axis % x.dim()
    pending = _gather_leading(torch.movedim(x, axis, 0), group, n, async_op)
    if axis:
        pending = pending.then(
            lambda out: torch.movedim(out, 0, axis).contiguous())
    return _done(pending, async_op)


def _scatter_leading(x: torch.Tensor, group, n: int,
                     async_op: bool = False) -> Pending:
    """The sum over members of ``x`` ([n * c, ...]), this member's
    ``c`` rows."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        work = dist.reduce_scatter_tensor(out, x, group=group,
                                          async_op=async_op)
    return Pending(out, work)


@timed_op
def reduce_scatter(tensor: torch.Tensor, group=None, axis: int = 0,
                   tiled: bool = True, async_op: bool = False):
    """Reduce, then give each member its slice of ``axis`` (untiled:
    ``axis`` has one entry a member, and it is removed; with
    ``async_op`` a :class:`Pending`)."""
    n = group_size(group)
    if n == 1:
        return _done(Pending(tensor if tiled else tensor.squeeze(axis)),
                     async_op)
    axis = axis % tensor.dim()
    if tensor.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} "
                         f"({tensor.shape[axis]}) is not divisible by the "
                         f"group's {n} members")
    pending = _scatter_leading(torch.movedim(tensor, axis, 0), group, n,
                               async_op)
    if axis:
        pending = pending.then(
            lambda out: torch.movedim(out, 0, axis).contiguous())
    if not tiled:
        pending = pending.then(lambda out: out.squeeze(axis))
    return _done(pending, async_op)


@timed_op
def all_to_all(tensor: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """All-to-all (the Ulysses primitive): ``split_axis`` is split over
    the members, member i's piece j goes to member j, and the pieces
    received are joined along ``concat_axis`` in member order (untiled:
    ``split_axis`` has one entry a member and the pieces stack on a new
    ``concat_axis``)."""
    import torch.distributed as dist
    n = group_size(group)
    if n == 1:
        return tensor if tiled else torch.movedim(tensor, split_axis,
                                                  concat_axis)
    split_axis = split_axis % tensor.dim()
    if tensor.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} "
                         f"({tensor.shape[split_axis]}) is not divisible by "
                         f"the group's {n} members")
    stacked = torch.stack(tensor.chunk(n, dim=split_axis), 0).contiguous()
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked, group=group)
    recv = out.unbind(0)
    if tiled:
        return torch.cat(recv, dim=concat_axis)
    return torch.stack([r.squeeze(split_axis) for r in recv], concat_axis)


def _permute(tensor: torch.Tensor, group, perm: Sequence[tuple]
             ) -> torch.Tensor:
    import torch.distributed as dist
    n = group_size(group)
    me = axis_index(group)
    src = [s for s, d in perm if d == me]
    if n == 1:
        return _zeros_unless(bool(src), tensor)
    if len(src) > 1 or len({s for s, _ in perm}) < len(perm):
        raise ValueError(f"permute: {list(perm)} sends twice from or to "
                         "one member")
    # one all_to_all_single with uneven splits: the payload goes to the
    # member this one sends to, and the other splits are empty
    flat = tensor.contiguous().reshape(-1)
    send, recv = [0] * n, [0] * n
    for s, d in perm:
        if s == me:
            send[d] = flat.numel()
    if src:
        recv[src[0]] = flat.numel()
    out = torch.empty(sum(recv), dtype=flat.dtype, device=flat.device)
    dist.all_to_all_single(out, flat if any(send) else flat[:0],
                           output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return out.view_as(tensor) if src else torch.zeros_like(tensor)


@timed_op
def permute(tensor: torch.Tensor, group=None,
            perm: Sequence[tuple] = ((0, 0),)) -> torch.Tensor:
    """Point-to-point as a permutation of ``(src, dst)`` pairs of member
    indices (each member sends at most once and receives at most once);
    a member no pair sends to receives zeros.  Each payload crosses once,
    in one uneven ``all_to_all_single``."""
    return _permute(tensor, group, perm)


def send_recv_next(tensor: torch.Tensor, group=None, axis_size: int = 1,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Shift +1 along a ring of ``axis_size`` members.  Not logged as an
    op, as JAX's ppermute here is not; ``axis`` names the mesh axis the
    comms logger counts its bytes under (:func:`record_axis`)."""
    if axis is not None:
        record_axis(axis, tensor)
    return _permute(tensor, group,
                    [(i, (i + 1) % axis_size) for i in range(axis_size)])


def send_recv_prev(tensor: torch.Tensor, group=None, axis_size: int = 1,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Shift -1 along a ring of ``axis_size`` members (as
    :func:`send_recv_next`)."""
    if axis is not None:
        record_axis(axis, tensor)
    return _permute(tensor, group,
                    [(i, (i - 1) % axis_size) for i in range(axis_size)])


@timed_op
def broadcast(tensor: torch.Tensor, group=None, src: int = 0
              ) -> torch.Tensor:
    """Every member gets member ``src``'s tensor."""
    import torch.distributed as dist
    if group_size(group) == 1:
        return _zeros_unless(src == 0, tensor)
    out = tensor.contiguous().clone()
    dist.broadcast(out, _global_rank(group, src), group=group)
    return out


def axis_index(group=None) -> int:
    """This member's index in ``group``."""
    if not _dist_ready():
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return group_size(group)


@timed_op
def reduce(tensor: torch.Tensor, group=None, dst: int = 0,
           op: str = "sum") -> torch.Tensor:
    """Rooted reduce: member ``dst`` gets the reduction, the others keep
    their input."""
    red = all_reduce.__wrapped__(tensor, group, op)
    return red if axis_index(group) == dst else tensor


@timed_op
def gather(tensor: torch.Tensor, group=None, dst: int = 0,
           axis: int = 0) -> torch.Tensor:
    """Rooted gather: member ``dst`` gets the stacked tensors (a new axis
    at ``axis``), the others zeros."""
    g = all_gather.__wrapped__(tensor, group, axis, False)
    return _zeros_unless(axis_index(group) == dst, g)


@timed_op
def scatter(tensor: torch.Tensor, group=None, src: int = 0,
            axis: int = 0) -> torch.Tensor:
    """Rooted scatter: every member gets its ``axis`` slice of ``src``'s
    tensor."""
    n = group_size(group)
    full = broadcast.__wrapped__(tensor, group, src)
    if n == 1:
        return full
    if full.shape[axis] % n:
        raise ValueError(
            f"scatter: dim {axis} ({full.shape[axis]}) not divisible by "
            f"the group's {n} members")
    return full.chunk(n, dim=axis)[axis_index(group)].clone()


def inference_all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Tensor-parallel partial-sum reduction in inference."""
    return all_reduce(tensor, group)


def all_gather_into_tensor(tensor: torch.Tensor, group=None,
                           axis: int = 0) -> torch.Tensor:
    return all_gather(tensor, group, axis=axis)


all_gather_base = all_gather_into_tensor


def reduce_scatter_tensor(tensor: torch.Tensor, group=None,
                          axis: int = 0) -> torch.Tensor:
    return reduce_scatter(tensor, group, axis=axis)


reduce_scatter_base = reduce_scatter_tensor


def all_to_all_single(tensor: torch.Tensor, group=None, split_axis: int = 0,
                      concat_axis: int = 0) -> torch.Tensor:
    return all_to_all(tensor, group, split_axis, concat_axis)


def all_reduce_coalesced(tensors, group=None, op: str = "sum"):
    return [all_reduce(t, group, op) for t in tensors]


def all_gather_coalesced(tensors, group=None, axis: int = 0):
    return [all_gather(t, group, axis=axis) for t in tensors]


def reduce_scatter_coalesced(tensors, group=None, axis: int = 0):
    return [reduce_scatter(t, group, axis=axis) for t in tensors]


def new_group(ranks: Sequence[int]):
    """A process group over ``ranks`` (``torch.distributed.new_group``,
    which every rank of the default group calls with the same ranks);
    without a process group the only group is rank 0's, None."""
    ranks = sorted(int(r) for r in ranks)
    if _dist_ready():
        import torch.distributed as dist
        return dist.new_group(ranks)
    if ranks not in ([], [0]):
        raise ValueError(f"new_group({ranks}): no process group is "
                         "initialised, so this process is the only rank "
                         "(0); call init_distributed first")
    return None


def get_world_group():
    """The default group (None while no process group is initialised)."""
    if not _dist_ready():
        return None
    import torch.distributed as dist
    return dist.group.WORLD


# ---------------------------------------------------------------------------
# host-side control plane (JAX :154-296)
# ---------------------------------------------------------------------------

_initialized = False

#: the seconds a collective may wait before it fails, unless the caller
#: gives ``timeout``
DEFAULT_TIMEOUT_S = 300.0


def rank_device(local_rank: int, local_size: int) -> Optional[int]:
    """The card index a rank process takes: ``local_rank`` when the
    machine has a card for every local rank, else 0 (ranks share one
    card); None without a card."""
    if not torch.cuda.is_available():
        return None
    return local_rank if torch.cuda.device_count() >= local_size else 0


def init_distributed(dist_backend: str = "nccl",
                     timeout: Optional[float] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     coordinator_address: Optional[str] = None,
                     auto_mpi_discovery: bool = True) -> None:
    """Rendezvous of the launcher's processes (JAX ``init_distributed``).
    Reads ``WORLD_SIZE`` (or ``DS_TPU_NUM_PROCESSES``), ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` where the arguments do not say;
    one process needs no rendezvous, so world size 1 only marks the
    facade initialised.  More processes join a ``torch.distributed``
    process group over ``dist_backend`` (``"nccl"`` or ``"gloo"``) with
    a finite ``timeout`` (seconds, default :data:`DEFAULT_TIMEOUT_S`).
    A rank with a card first takes ``cuda:LOCAL_RANK``, or ``cuda:0``
    when the machine has fewer cards than local ranks
    (:func:`rank_device`); NCCL needs a card of its own per rank and
    raises without one, as it does without CUDA."""
    global _initialized
    if _initialized:
        return
    env_world = int(os.environ.get(
        "WORLD_SIZE", os.environ.get("DS_TPU_NUM_PROCESSES", "1")))
    world_size = world_size if world_size > 0 else env_world
    if world_size <= 1:
        _initialized = True
        return
    rank = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{addr}:{port}"
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_size = int(os.environ.get("LOCAL_SIZE", str(world_size)))
    card = rank_device(local_rank, local_size)
    if dist_backend == "nccl":
        if card is None:
            raise RuntimeError(
                f"init_distributed: backend 'nccl' at {coordinator_address} "
                f"(rank {rank} of {world_size}) needs a CUDA device and "
                "torch sees none; pass dist_backend='gloo' to run on the "
                "host")
        if torch.cuda.device_count() < local_size:
            raise RuntimeError(
                f"init_distributed: backend 'nccl' at {coordinator_address}"
                f" needs one card per local rank ({local_size} ranks, "
                f"{torch.cuda.device_count()} cards): NCCL refuses two "
                "ranks on one device; pass dist_backend='gloo'")
    elif dist_backend != "gloo":
        raise ValueError(f"init_distributed: backend {dist_backend!r} is "
                         "not 'nccl' or 'gloo'")
    if card is not None:
        torch.cuda.set_device(card)
    import torch.distributed as dist
    logger.info("init_distributed: %s coordinator=%s rank=%d world=%d",
                dist_backend, coordinator_address, rank, world_size)
    dist.init_process_group(
        backend=dist_backend, init_method=f"tcp://{coordinator_address}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=float(
            timeout if timeout is not None else DEFAULT_TIMEOUT_S)))
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def get_rank() -> int:
    """This process's rank (0 while no process group is initialised)."""
    return axis_index(None)


def get_world_size() -> int:
    """Processes in the default group."""
    return group_size(None)


def get_device_rank() -> int:
    """The index of this process's card (0 without one)."""
    return torch.cuda.current_device() if torch.cuda.is_available() else 0


def get_device_count() -> int:
    """Cards this process sees (1 on a machine without one: the host)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def barrier(group=None) -> None:
    """Host-level barrier over ``group`` (nothing to wait for at one
    process)."""
    if group_size(group) == 1:
        return
    import torch.distributed as dist
    dist.barrier(group=group)


def monitored_barrier(timeout: float = 300.0) -> float:
    """:func:`barrier` with a watchdog thread that warns every
    ``timeout`` seconds while it blocks (JAX ``monitored_barrier``).
    Returns the barrier's wall time in seconds."""
    t0 = time.time()
    done = threading.Event()
    interval = max(float(timeout), 1.0)

    def watchdog():
        while not done.wait(interval):
            logger.warning(
                "monitored_barrier: still blocked after %.1fs (timeout "
                "%.1fs) — a rank is hung, straggling, or the fabric is "
                "congested", time.time() - t0, timeout)

    w = threading.Thread(target=watchdog, daemon=True)
    w.start()
    try:
        barrier()
    finally:
        done.set()
    dt = time.time() - t0
    if dt > timeout:
        logger.info("monitored_barrier: barrier completed after %.1fs", dt)
    return dt


def record_axis(axis: str, tensor: torch.Tensor) -> None:
    """Count a model-parallel collective's message under its mesh axis
    (``tensor`` or ``seq``) in the comms logger, when it is on."""
    if _comms_logger is not None and _comms_logger.enabled:
        _comms_logger.record_axis(axis, tensor)


def record_bucket_plan(stats: dict) -> None:
    """Feed a collective scheduler's static bucket plan into the comms
    logger (a no-op while it is not configured)."""
    if _comms_logger is not None and _comms_logger.enabled:
        _comms_logger.record_bucket_plan(stats)


def log_summary(show_straggler: bool = False) -> str:
    """Log and return the comms-volume summary (JAX ``log_summary``)."""
    del show_straggler
    if _comms_logger is None:
        logger.warning("comms logger not configured; nothing to summarize")
        return ""
    text = _comms_logger.log_summary()
    logger.info("%s", text)
    return text


def destroy_process_group() -> None:
    """Tear down the process group (``torch.distributed.
    destroy_process_group`` once one is initialised)."""
    global _initialized
    if _dist_ready():
        import torch.distributed as dist
        dist.destroy_process_group()
    _initialized = False
