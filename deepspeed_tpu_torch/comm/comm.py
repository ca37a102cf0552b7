"""Communication facade at one process.

Counterpart of ``deepspeed_tpu/comm/comm.py``.  The JAX package's
collectives run inside ``shard_map`` over a mesh axis name; here each
takes a ``torch.distributed`` process group, or None for the default
group, where JAX takes the axis name.  This slice runs one process on one
card: every collective is the single-member case of JAX's semantics (an
all-reduce or a tiled all-gather returns its input, an untiled gather
adds a leading axis of one, a rooted op whose root is not rank 0 returns
zeros), and a group of more than one member raises
``NotImplementedError`` naming ROADMAP Queue 1 item 4, which brings
several ranks over ``torch.distributed``.

Every collective is wrapped by :func:`timed_op`, which feeds the comms
logger (``utils/comms_logging.py``) the op's name and message size, as
JAX's does at trace time; here it counts every call.  The host-side
control plane (:func:`init_distributed`, rank and world queries,
:func:`barrier`, :func:`monitored_barrier`) reads the launcher's
``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` as JAX's
does, and is a no-op at world size 1.
"""

from __future__ import annotations

import functools
import os
import threading
import time
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


def _one_rank(group, op: str) -> None:
    n = group_size(group)
    if n != 1:
        raise NotImplementedError(
            f"comm.{op} over a group of {n} ranks is not ported yet: the "
            "port's collectives run at one rank (ROADMAP Queue 1 item 4)")


def _zeros_unless(cond: bool, t: torch.Tensor) -> torch.Tensor:
    return t if cond else torch.zeros_like(t)


# ---------------------------------------------------------------------------
# collectives (JAX :73-149, :320-414)
# ---------------------------------------------------------------------------

_REDUCE_OPS = ("sum", "SUM", "avg", "AVG", "mean", "max", "MAX", "min",
               "MIN")


@timed_op
def all_reduce(tensor: torch.Tensor, group=None,
               op: str = "sum") -> torch.Tensor:
    """SUM / AVG / MAX / MIN all-reduce over ``group``."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    _one_rank(group, "all_reduce")
    return tensor


@timed_op
def all_gather(tensor: torch.Tensor, group=None, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Gather the members' tensors along ``axis`` (``tiled``) or stacked
    on a new axis ``axis``."""
    _one_rank(group, "all_gather")
    return tensor if tiled else tensor.unsqueeze(axis)


@timed_op
def reduce_scatter(tensor: torch.Tensor, group=None, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
    """Reduce, then give each member its slice of ``axis`` (untiled:
    ``axis`` has one entry a member, and it is removed)."""
    _one_rank(group, "reduce_scatter")
    return tensor if tiled else tensor.squeeze(axis)


@timed_op
def all_to_all(tensor: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """All-to-all (the Ulysses primitive): ``split_axis`` is split over
    the members and their pieces are joined along ``concat_axis``."""
    _one_rank(group, "all_to_all")
    if tiled:
        return tensor
    return torch.movedim(tensor, split_axis, concat_axis)


@timed_op
def permute(tensor: torch.Tensor, group=None,
            perm: Sequence[tuple] = ((0, 0),)) -> torch.Tensor:
    """Point-to-point as a permutation of ``(src, dst)`` pairs; a member
    no pair sends to receives zeros."""
    _one_rank(group, "permute")
    return _zeros_unless((0, 0) in {tuple(p) for p in perm}, tensor)


def send_recv_next(tensor: torch.Tensor, group=None,
                   axis_size: int = 1) -> torch.Tensor:
    """Shift +1 along a ring of ``axis_size`` members."""
    _one_rank(group, "send_recv_next")
    return tensor


def send_recv_prev(tensor: torch.Tensor, group=None,
                   axis_size: int = 1) -> torch.Tensor:
    """Shift -1 along a ring of ``axis_size`` members."""
    _one_rank(group, "send_recv_prev")
    return tensor


@timed_op
def broadcast(tensor: torch.Tensor, group=None, src: int = 0
              ) -> torch.Tensor:
    """Every member gets ``src``'s tensor."""
    _one_rank(group, "broadcast")
    return _zeros_unless(src == 0, tensor)


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
    return all_reduce.__wrapped__(tensor, group, op)


@timed_op
def gather(tensor: torch.Tensor, group=None, dst: int = 0,
           axis: int = 0) -> torch.Tensor:
    """Rooted gather: member ``dst`` gets the stacked tensors (a new axis
    at ``axis``), the others zeros."""
    _one_rank(group, "gather")
    return _zeros_unless(dst == 0, tensor.unsqueeze(axis))


@timed_op
def scatter(tensor: torch.Tensor, group=None, src: int = 0,
            axis: int = 0) -> torch.Tensor:
    """Rooted scatter: every member gets its ``axis`` slice of ``src``'s
    tensor."""
    _one_rank(group, "scatter")
    return _zeros_unless(src == 0, tensor)


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
    """A process group over ``ranks`` (``torch.distributed.new_group``
    once a process group is initialised); at one process the only group
    is rank 0's, the default group (None)."""
    ranks = [int(r) for r in ranks]
    if _dist_ready():
        import torch.distributed as dist
        return dist.new_group(ranks)
    if ranks not in ([], [0]):
        raise ValueError(f"new_group({ranks}): this process is the only "
                         "rank (0); several ranks need ROADMAP Queue 1 "
                         "item 4")
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


def init_distributed(dist_backend: str = "nccl",
                     timeout: Optional[float] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     coordinator_address: Optional[str] = None,
                     auto_mpi_discovery: bool = True) -> None:
    """Rendezvous of the launcher's processes (JAX ``init_distributed``).
    Reads ``WORLD_SIZE`` (or ``DS_TPU_NUM_PROCESSES``) when
    ``world_size`` is not given; one process needs no rendezvous, so
    world size 1 only marks the facade initialised.  More processes raise
    ``NotImplementedError`` (ROADMAP Queue 1 item 4)."""
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
    raise NotImplementedError(
        f"init_distributed over {world_size} processes (rank {rank}, "
        f"coordinator {coordinator_address}, backend {dist_backend}) is "
        "not ported yet: the port runs one process (ROADMAP Queue 1 item "
        "4)")


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


def barrier() -> None:
    """Host-level barrier over the default group (nothing to wait for at
    one process)."""
    if get_world_size() == 1:
        return
    _one_rank(None, "barrier")


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
