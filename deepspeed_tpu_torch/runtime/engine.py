"""Training engine for the port's one-GPU slice.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``__init__`` :141,
``_init_state`` :497, the train step :613-829, ``_shape_batch`` :930,
``train_batch`` :1094 with ``_resolve_batch`` :1081, ``forward`` /
``backward`` / ``step`` :1276-1340, ``eval_batch`` :1341,
``deepspeed_io`` :1360).  The JAX engine compiles the whole step into one
program; this one runs it eagerly, with the same numbers:

1. each step casts the fp32 masters to the compute dtype once (bf16, or
   fp32 with ``"bf16": {"enabled": false}``) and takes gradients with
   respect to that copy; with ZeRO++ quantised weights (stage 3 and
   ``zero_quantized_weights``) every leaf of two or more dimensions is
   first snapped to the blockwise int8 grid (the quantise and dequantise
   kernels, straight into the compute dtype; JAX ``engine.py:641-653``),
   and its gradient passes straight through;
2. each micro-batch's gradient is cast to fp32 and summed into a
   per-master accumulator, which is scaled by ``1 / gas`` at the step;
3. the global norm is taken over every accumulator and, with
   ``gradient_clipping`` c > 0, every one is scaled by
   ``min(1, c / (norm + 1e-6))``;
4. update k (0-based) applies the optimizer (AdamW, Lion or LAMB, each a
   fused kernel) at lr ``schedule(k)``;
5. ``train_batch`` reports the mean of the micro-batch losses.

A batch is a dict of leaves; ``attention_mask`` and ``positions`` pass
through to the model with ``input_ids`` and ``labels``.  Without a
batch, ``train_batch`` reads gas micro-batches from ``data_iter`` or
from the engine's ``training_dataloader`` (``training_data=``) as JAX's
``_resolve_batch`` does: an iterator is advanced, while the loader (an
iterable) is restarted by ``iter()`` on every call, so without shuffle
every step reads the loader's first gas batches (the JAX engine's
behaviour, kept; ROADMAP Queue 3).

The accumulators of the leaves the device optimizer steps are the
masters' ``.grad``, so :attr:`optimizer` is a plain
``torch.optim.Optimizer`` over those masters.  At one rank the ZeRO
partition is the identity: stages 1-3 change no number.  Features
outside the slice raise ``NotImplementedError`` from the config loader
or here.

Across ranks (JAX :96-138 ``_topology_from_config``, the step
:613-829): each rank process is one position of the process mesh
(``parallel/topology.py``; every free rank goes to ``fsdp`` from stage
1 and to ``data`` at stage 0, MiCS is ``data = free // mics`` with
``fsdp = mics``), the global batch's rows are split over the batch axes
(``MeshTopology.batch_slice``) and ``runtime/zero/partitioner.py``
gives each leaf its layouts.  Every micro-batch's gradient is summed
over ``GRAD_REDUCE_AXES`` on the wire in the compute dtype (JAX's psum
of the bf16 gradient) and added to an fp32 accumulator that holds the
rank's master piece: an all-reduce at stage 0, a reduce-scatter over
the master's axes (and an all-reduce over the others) from stage 1.
From stage 1 the fp32 masters and moments are the rank's
``master_spec`` shard and the fused kernel steps the shard; the compute
copy is all-gathered once per step in the compute dtype (stages 1 and 2
differ only in the memory the JAX engine's accumulators take, which
here are shards at both).  Stage 3 hands the model the
``param_spec`` pieces (over ``hpz`` alone under hpZ): each layer's
leaves are gathered just before the layer runs and freed after
(:class:`~.zero.partitioner.ParamGather`, inside the remat region, so a
recomputed forward gathers again), the gather's backward
reduce-scatters the gradient, and each piece's gradient is reduced
over the remaining axes and taken to the master layout.
Without a remat policy autograd keeps each layer's gathered weights for
its backward, as it keeps the layer's activations.  Every gradient is
divided by the batch shards (the loss is the mean over the batch axes,
as JAX's global mean when every rank holds as many tokens); the clipping
norm sums each shard once (a replicated leaf counts once); under fp16
the overflow flag is max-reduced, so every rank skips the same step;
``train_batch`` reports the loss averaged over the batch ranks.  qwZ at
stage 3 projects each leaf onto the int8 grid over the gathered leaf's
flat layout (JAX :635-649), then keeps the piece.  The qgZ flag (stage
2 or more) and ``comm_optimization`` route the gradients through
``runtime/comm/collective_scheduler.py`` under JAX's gates (:396-464);
its error-feedback residuals are :attr:`TrainState.comm_residuals` and
travel in the checkpoint.  Checkpoints across ranks: rank 0 gathers the
shards and writes the one-rank files, every rank reads them and keeps
its shard, so a checkpoint moves between rank counts.  ZeRO-Offload
across ranks raises (ROADMAP Queue 1 item 4).

Tensor and sequence parallelism (JAX :96-120, :318-339, :415-440,
:855-880): a transformer's leaf sharded over ``tensor`` by the
partitioner's logical-axis rules is held as the rank's tensor shard,
and every layout above applies inside it (the masters, moments and
accumulators are the shard's ZeRO pieces; the whole leaf is gathered
over ZeRO's group and then over ``tensor``).  The forward runs under
the step's :class:`~..parallel.tensor_parallel.ModelParallel` layout
(Megatron regions over ``tensor``; Ulysses or ring attention over
``seq``).  A batch leaf's sequence dimension is split over ``seq``
after the rows, and a causal LM's labels and their mask are built from
the whole sequence first.  Gradients are summed over
``GRAD_REDUCE_AXES``, which holds ``seq``; a leaf replicated over
``tensor`` needs no sum there (its gradient is the same on every tensor
rank: a region's entry sums what its heads or columns gave, and a
replicated kv projection's gradient is summed over ``tensor`` inside
the step).  The global norm counts a tensor-sharded leaf's squares over
``tensor`` and a replicated leaf once; the reported loss sums the seq
ranks' shares and averages the batch ranks'.

Checkpoints (JAX :1369-1567): :meth:`save_checkpoint` /
:meth:`load_checkpoint` write and read ``checkpoint/engine.py``'s
``torch.save`` files (or, with ``checkpoint.load_universal``, universal
atoms from either package); :meth:`get_fp32_state_dict` and
:meth:`save_16bit_model` export the masters.  A load copies into the
existing masters and moments (the optimizer holds them), zeroes the
gradient accumulators and drops the step's compute copy.  The engine
has no random stream (the slice has no dropout): an ``rng_key_data``
loaded from a JAX checkpoint is written back unchanged.  The LR schedule
reads the optimizer's own update count, as JAX's reads optax's
``count``: equal to ``global_steps`` unless a weights-only load started
a fresh optimizer.

ZeRO-Offload (JAX :378-395, :499-550, :815-830, :1252-1275,
:1399-1519, the accessors :1738-1751): with
``zero_optimization.offload_optimizer`` cpu or nvme,
``runtime/zero/offload.py`` picks the offloaded leaves (all, or the
largest first up to ``ratio``).  Their fp32 masters and moments live on
the host only; the device keeps their compute-dtype copy and their fp32
gradient accumulator, and the device optimizer covers the other leaves
(none: ``optimizer`` is None).  After the norm and clipping over every
leaf, :meth:`step` runs the host step (span ``train.offload_step``) at
the same lr: leaf by leaf, the gradient goes device -> host through one
pinned staging buffer the size of the largest offloaded leaf, the host
kernel steps the master, and the master comes back through the leaf's
accumulator to refresh the compute copy in place; ``offload_times``
holds the split of the last step.  The LR schedule then reads the host
optimizer's count when no leaf is on the device.  Checkpoints write
``offload_rank0.npz`` beside the ``torch.save`` files in JAX's format
(a module-only load re-syncs the host masters from the module); the
snapshot, :meth:`get_fp32_state_dict` and :meth:`save_16bit_model` read
the host masters.

The ``tpu`` model keys and ``activation_checkpointing`` (``policy``,
``cpu_checkpointing``) set the model config's remat policy before the
weights are built, as JAX ``_apply_model_overrides`` does.

Precision (JAX :178-186, :631-633): bf16 computes over fp32 masters;
pure bf16 (``bf16.master_weights`` false) keeps bf16 masters, which the
optimizer updates in place (the fused kernels' bf16 instances), and
``accumulate_grads_in_fp32`` false makes the accumulators bf16; fp16
keeps fp32 masters and computes in bf16, as the JAX engine does.  Under
fp16 every micro-batch's loss is multiplied by the loss scale before
its backward, the accumulated gradients are divided by ``gas * scale``,
and the global norm is read on the host before the update (one sync a
step): a non-finite norm skips the update, leaving masters, moments and
the optimizer's count as they are, and the dynamic scale follows JAX's
rule with hysteresis (:770-810).  The LR schedule reads the count of
applied updates, so a skip does not advance it; the host step of
ZeRO-Offload is skipped with it.  A skip is routine: the watchdog counts
it in ``ds_train_overflow_skip_total`` and self-healing leaves it be.

The rest of the JAX engine's API (:1569-1870): ``set_lr``, the
batch-size setters, ``set_gradient_accumulation_boundary`` (a forced
boundary averages over the micro-batches taken), ``train`` / ``eval``,
``destroy``, ``was_step_applied``, ``dump_state``, the config
accessors, ``random_ltd_*`` and the flops-profiler hook
(``flops_profiler.profile_step``: one more forward and backward of the
step's micro-batches under ``profiling/flops_profiler.py``'s counter,
its gradients discarded and nothing random drawn, so training is what
it would have been).

Self-healing and telemetry (JAX :946-1225): with
``fault_tolerance.self_healing`` a non-finite step rolls back to the
last good checkpoint or the host snapshot and skips the batch, and a
:class:`TransientFault` at dispatch retries the same batch; the
``comm.collective_failure``, ``train.nan_grad`` and ``train.slow_step``
sites fire in :meth:`train_batch`; the watchdog tracks input wait,
compile, step and checkpoint time and sees non-finite values and step
times; ``train.batch`` / ``train.step`` spans; the monitor writes the
loss and LR every step and the registry at ``steps_per_print``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..checkpoint.universal import leaf_paths
from ..models.base import Model
from ..ops.quantization import quantize_dequantize
from ..telemetry import get_tracer, trace_span
from ..telemetry import metrics as tm
from ..telemetry.flight_recorder import get_flight_recorder
from ..telemetry.state import state as telemetry_state
from ..telemetry.watchdog import get_watchdog
from ..parallel.topology import (BATCH_AXES, GRAD_REDUCE_AXES, MeshTopology,
                                 TopologyConfig)
from ..tree import tree_leaves, tree_map
from ..utils.logging import logger
from ..utils.timer import (TRAIN_BATCH_TIMER, SynchronizedWallClockTimer,
                           ThroughputTimer)
from .config import (ZERO_ONE_RANK_NOOPS, TrainingConfig, load_config,
                     optimizer_kind, warn_noop_keys)
from .dataloader import DeepSpeedDataLoader
from .fault_injection import (InjectedCollectiveFault, TransientFault,
                              get_fault_injector)
from .lr_schedules import LRScheduler, get_lr_schedule
from .optimizers import get_optimizer
from .zero.partitioner import (ParamGather, ZeroPartitioner, blocked_dims_of,
                               gather_shard, leaf_names_of, names_leaves,
                               scatter_sum)


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _nan_like(x):
    if isinstance(x, torch.Tensor):
        return torch.full_like(x, float("nan"))
    return np.full_like(x, np.nan)


def _as_tensor(src) -> torch.Tensor:
    """A tensor over ``src`` (numpy or torch) without a copy where one
    can be avoided."""
    if isinstance(src, torch.Tensor):
        return src
    arr = np.asarray(src)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr)
    return torch.from_numpy(arr)


def _host(t):
    return t.detach().to("cpu", copy=True) if isinstance(
        t, torch.Tensor) else t


def _register_host(owner, t: torch.Tensor) -> None:
    """Page-lock ``t``'s memory for the card's copies until ``owner`` is
    collected."""
    import weakref
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(t.data_ptr(),
                                  t.numel() * t.element_size(), 0)
    if err != cudart.cudaError.success:
        raise RuntimeError(f"cudaHostRegister of {t.numel()} elements "
                           f"failed: {err}")
    weakref.finalize(owner, _unregister_host, t)


def _unregister_host(t: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(t.data_ptr())


def _tree_with_paths(tree, fn, prefix: str = ""):
    """The same dict structure with ``fn((path, leaf))`` at every leaf,
    paths ``/``-joined as ``leaf_paths`` gives them."""
    if isinstance(tree, dict):
        return {k: _tree_with_paths(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn((prefix[:-1], tree))


#: ``activation_checkpointing.policy`` -> remat policy (JAX
#: ``engine.py:307-316``; another name passes through)
AC_POLICIES = {
    "full": "nothing_saveable",
    "nothing": "everything_saveable",
    "dots": "dots_saveable",
    "dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable",
    "offload_dots": "offload_dots",
}
#: ``cpu_checkpointing``: the active policy's host-offload variant
CPU_CHECKPOINTING = {
    "save_attn_out": "offload_attn_out",
    "dots_with_no_batch_dims_saveable": "offload_dots",
    "dots_saveable": "offload_dots",
}


@dataclasses.dataclass
class TrainState:
    """The training state in JAX ``TrainState``'s fields
    (``engine.py:71``), as :attr:`DeepSpeedEngine.state` gives it: a view
    of the engine's tensors (``params`` its masters, ``opt_state`` the
    device optimizer's per-parameter states), not a copy."""
    step: int
    params: Any
    opt_state: Any
    loss_scale: float
    good_steps: int
    skipped_steps: int
    hysteresis: int
    comm_residuals: Any = ()


#: the host optimizer's file beside a checkpoint's (JAX ``engine.py:1401``)
OFFLOAD_FILE = "offload_rank0.npz"

#: the JAX ``ZeroConfig`` defaults of the keys the accessors read
ZERO_DEFAULTS = {
    "contiguous_gradients": True, "reduce_scatter": True,
    "reduce_bucket_size": int(5e8), "allgather_partitions": True,
    "allgather_bucket_size": int(5e8), "overlap_comm": True,
    "sub_group_size": int(1e9), "stage3_max_live_parameters": int(1e9),
    "stage3_max_reuse_distance": int(1e9),
    "stage3_prefetch_bucket_size": int(5e7),
    "stage3_param_persistence_threshold": int(1e5),
    "stage3_model_persistence_threshold": int(2 ** 63 - 1),
    "stage3_gather_16bit_weights_on_model_save": False,
    "mics_hierarchical_params_gather": False,
    "round_robin_gradients": False, "memory_efficient_linear": True}
assert set(ZERO_DEFAULTS) == set(ZERO_ONE_RANK_NOOPS)

#: optimizers whose update is elementwise but for LAMB's per-leaf norms
#: (summed over the shards): the ones a shard can step
SHARDABLE_KINDS = ("adamw", "adam_l2", "lion", "lamb", "sgd", "adagrad")


def topology_from_config(config: TrainingConfig,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         groups: bool = True) -> MeshTopology:
    """The process mesh a config asks for (JAX ``_topology_from_config``,
    ``engine.py:96-138``): ``tpu.mesh``'s axes, seq and tensor from the
    enabled ``sequence_parallel`` / ``tensor_parallel`` sections where
    the mesh leaves them unset, hpz from the mesh or
    ``zero_hpz_partition_size``; without a data or fsdp axis every free
    rank (those the fixed axes leave) goes to ``fsdp`` from stage 1 and
    to ``data`` at stage 0, and MiCS (stage 3) is ``data = free //
    mics_shard_size`` with ``fsdp = mics_shard_size``.  ``groups=False``
    makes no process group (the layout alone, for any rank)."""
    from ..comm import comm
    mesh = dict(config.mesh)
    hpz = max(1, int(mesh.get("hpz", config.zero_hpz_partition_size)))
    sp, tp = config.sequence_parallel, config.tensor_parallel
    tcfg = TopologyConfig(
        data=mesh.get("data", -1), fsdp=mesh.get("fsdp", 1), hpz=hpz,
        seq=mesh.get("seq", sp.sp_size if sp.enabled else 1),
        tensor=mesh.get("tensor", tp.tp_size if tp.enabled else 1))
    n = comm.get_world_size() if world_size is None else int(world_size)
    if "data" not in mesh and "fsdp" not in mesh:
        fixed = hpz * tcfg.seq * tcfg.tensor
        if fixed == 0 or n % fixed != 0:
            raise ValueError(
                f"mesh axes pipe=1 expert=1 hpz={hpz} seq={tcfg.seq} "
                f"tensor={tcfg.tensor} (product {fixed}) do not divide "
                f"device count {n}")
        free = n // fixed
        mics = config.mics_shard_size
        if mics > 0 and config.zero_stage >= 3:
            if free % mics != 0:
                raise ValueError(f"mics_shard_size {mics} does not divide "
                                 f"the {free} free devices")
            tcfg = dataclasses.replace(tcfg, data=free // mics, fsdp=mics)
        elif config.zero_stage >= 1:
            tcfg = dataclasses.replace(tcfg, data=1, fsdp=free)
        else:
            tcfg = dataclasses.replace(tcfg, data=free, fsdp=1)
    return MeshTopology(tcfg, world_size=n, rank=rank, groups=groups)


class _Reduction:
    """A leaf's gradient reduction in flight: ``first`` (a started
    ``comm.Pending``), then an all-reduce over ``rest`` (a group, or
    None) and ``reshard`` (or nothing), run by :meth:`wait`."""

    def __init__(self, first, rest=None, reshard=None):
        self.first, self.rest, self.reshard = first, rest, reshard

    def wait(self) -> torch.Tensor:
        from ..comm import comm
        out = self.first.wait()
        if self.rest is not None:
            out = comm.all_reduce(out, self.rest)
        return self.reshard(out) if self.reshard is not None else out


def _whole_blocks(lay, shape) -> bool:
    """Whether every contiguous run of a piece cut by ``lay`` from a leaf
    of ``shape`` is whole quantisation blocks of the leaf's flat layout
    (a run is the chunk times the dims after it, and runs start at
    multiples of the whole dim times those)."""
    from ..ops.quantization import BLOCK
    if not lay.sharded:
        return True
    return math.prod(lay.local_shape(shape)[lay.dim:]) % BLOCK == 0


def _unflatten(tree, leaves: List[Any]):
    """``tree``'s dict structure over ``leaves`` (tree order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)



class DeepSpeedEngine:
    """Eager training engine.

    ``model`` follows :class:`~..models.base.Model`.  ``model_parameters``
    (a tree of floating tensors, e.g. a JAX tree bridged by
    ``checkpoint/from_jax.py``) seeds the masters; without it the engine
    calls ``model.init_params(0, device)``.  ``device`` None means the
    GPU and raises without one; ``"cpu"`` runs every kernel's plain
    version.  ``training_data`` (any indexable dataset) becomes
    :attr:`training_dataloader`, batched by ``collate_fn``."""

    def __init__(self, model: Model, config: Any = None,
                 model_parameters: Optional[Dict[str, Any]] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 device: DeviceLike = None, training_data: Any = None,
                 collate_fn: Optional[Callable] = None,
                 topology: Optional[MeshTopology] = None):
        self.config: TrainingConfig = load_config(config)
        from ..comm import comm
        comm.init_distributed()
        #: the process mesh (JAX ``self.topology``)
        self.topology = (topology if topology is not None
                         else topology_from_config(self.config))
        #: more than one rank: the ZeRO partition and the collectives act
        self._multi = self.topology.world_size > 1
        if self._multi and self.config.offload_optimizer.enabled:
            raise NotImplementedError(
                "ZeRO-Offload across ranks (a host optimizer and "
                "offload_rank{r}.npz per rank) is not in the port yet "
                "(ROADMAP Queue 1 item 4, rest)")
        self.config.resolve_batch_sizes(self.topology.batch_shard_size)
        self.device = resolve_device(device)
        if not isinstance(model, Model):
            raise TypeError("model must define init_params(seed, device) "
                            "and loss(params, batch)")
        self.module = model
        cfg = self.config
        # fp16 computes in bf16 (JAX engine.py:178-186)
        self.compute_dtype = (torch.float32
                              if cfg.precision_dtype == "float32"
                              else torch.bfloat16)
        self._fp16_enabled = cfg.fp16.enabled
        self.master_dtype = (torch.float32 if (
            cfg.bf16.master_weights or self._fp16_enabled
            or cfg.precision_dtype == "float32") else self.compute_dtype)
        self.acc_dtype = (torch.float32 if cfg.bf16.accumulate_grads_in_fp32
                          else self.compute_dtype)
        # one engine's matmul precision never leaks into the next
        torch.set_float32_matmul_precision(cfg.matmul_precision)
        warn_noop_keys(self.config)
        self._apply_model_overrides()

        if model_parameters is None:
            tree, copy = model.init_params(0, self.device), False
        else:
            # the engine updates its masters in place: never the caller's
            tree, copy = model_parameters, True
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor) or not t.is_floating_point():
                raise TypeError(f"parameters must be floating tensors, got "
                                f"{type(t).__name__}")
        #: each leaf's ``/``-joined tree path, in tree order
        self.param_paths = leaf_paths(tree)
        #: each leaf's whole shape, in tree order
        self.param_shapes = [tuple(t.shape) for t in tree_leaves(tree)]
        self.partitioner = ZeroPartitioner(
            self.topology, cfg.zero_stage,
            persistence_threshold=int(self._zero(
                "stage3_param_persistence_threshold")),
            blocked=blocked_dims_of(model), names=leaf_names_of(model))
        #: per leaf: this rank's tensor shard (the leaf the rest of the
        #: engine sees: its pieces of the master, moments and compute
        #: copy are cut from it, JAX's shard on this device)
        self._tlayouts = [self.partitioner.tensor_layout(t, p) for p, t in
                          zip(self.param_paths, tree_leaves(tree))]
        #: each leaf's tensor shard's shape
        self._local_shapes = [lay.local_shape(s) for lay, s in
                              zip(self._tlayouts, self.param_shapes)]
        #: the model-parallel layout a step's forward runs under (None
        #: without a tensor or seq axis)
        self._mp = self._model_parallel(model)
        #: the collective scheduler (None: exact per-leaf collectives)
        self.comm_scheduler = self._build_comm_scheduler()
        #: per leaf: this rank's piece of the master (and moments) and of
        #: the compute copy, inside its tensor shard
        self._mlayouts = [self.partitioner.master_layout(t, p) for p, t in
                          zip(self.param_paths, tree_leaves(tree))]
        self._playouts = [self.partitioner.param_layout(t, p) for p, t in
                          zip(self.param_paths, tree_leaves(tree))]
        #: stage 3 across ranks hands the model pieces (else whole leaves;
        #: a live scheduler reduces whole-leaf gradients, as JAX's)
        self._pieces = (self._multi and cfg.zero_stage >= 3
                        and self.comm_scheduler is None)
        #: ZeRO-Offload's host optimizer (JAX ``_maybe_enable_offload``)
        self.offload = None
        offloaded = set()
        if self.config.offload_optimizer.enabled:
            from .zero.offload import HostOffloadOptimizer
            self.offload = HostOffloadOptimizer(tree, self.config)
            # the fp32 masters of offloaded leaves live on the host only
            self.offload.init_masters(tree)
            offloaded = set(self.offload.offload_paths)
        #: per leaf in tree order: is its optimizer step on the host?
        self._offloaded = [p in offloaded for p in self.param_paths]

        def master(path_leaf):
            path, t = path_leaf
            if path in offloaded:
                # the device keeps the compute-dtype copy (the offload
                # memory win)
                return t.detach().to(self.device, self.compute_dtype)
            i = self.param_paths.index(path)
            lay, tlay = self._mlayouts[i], self._tlayouts[i]
            if lay.sharded or tlay.sharded:
                return lay.shard(tlay.shard(t.detach())).to(
                    self.device, self.master_dtype, copy=True).contiguous()
            return t.detach().to(self.device, self.master_dtype, copy=copy)
        #: the weights in the model's tree layout (across ranks: this
        #: rank's master shards): the masters (fp32, or
        #: bf16 under pure bf16), and for offloaded leaves their
        #: compute-dtype copy
        self.params = _tree_with_paths(tree, master)
        self._masters = tree_leaves(self.params)
        #: gradient accumulators, one per leaf, fp32 unless
        #: ``accumulate_grads_in_fp32`` is false (JAX engine.py:458,632),
        #: offloaded leaves too: their sum is cast to fp32 at the
        #: device -> host copy (the staging buffer)
        self._grads: List[torch.Tensor] = []
        for i, (p, off) in enumerate(zip(self._masters, self._offloaded)):
            g = torch.zeros(self._acc_shape(i), device=p.device,
                            dtype=self.acc_dtype)
            if not off and g.dtype == p.dtype and not self._multi:
                p.grad = g        # the device optimizer's step gets them too
            self._grads.append(g)
        if self.offload is not None:
            # tree index -> master index k
            self._host_index = {i: self.offload.offload_paths.index(p)
                                for i, p in enumerate(self.param_paths)
                                if p in offloaded}
        self._staging: Optional[torch.Tensor] = None
        #: the last offloaded step's split, seconds: ``device_wait`` (the
        #: forward and backward still running), ``d2h``, ``host_step``,
        #: ``h2d`` and ``nvme_wait``
        self.offload_times: Dict[str, float] = {}

        opt = self.config.optimizer
        base_lr = opt.params.lr
        if self.config.scheduler is not None:
            self._schedule = get_lr_schedule(self.config.scheduler.type,
                                             self.config.scheduler.params,
                                             base_lr)
        elif callable(lr_scheduler):
            self._schedule = lr_scheduler
        else:
            self._schedule = lambda step: base_lr
        self.lr_scheduler = LRScheduler(self._schedule)
        self._init_loss_scale()
        self._check_jax_builds(model)
        #: the leaves the device optimizer steps, in tree order
        self._device_index = [i for i, off in enumerate(self._offloaded)
                              if not off]
        #: the device optimizer over the leaves not offloaded; None when
        #: every leaf is (JAX masks them out of optax)
        self.optimizer = (get_optimizer(
            opt.type, opt.params,
            [self._masters[i] for i in self._device_index])
            if self._device_index else None)
        #: the optimizer's kind (``config.optimizer_kind``): the layout of
        #: its state in checkpoints and universal atoms
        self.optimizer_kind = optimizer_kind(
            opt.type, opt.params.adam_w_mode, opt.params.momentum)
        self._residuals = None
        if self._multi:
            self._init_ranks()

        self._params_c: Optional[Dict[str, Any]] = None
        self._pending = 0          # micro-batches accumulated this step
        #: set_gradient_accumulation_boundary's override (None: the count)
        self._ga_boundary: Optional[bool] = None
        self._last_step_applied = True
        self._train_mode = True
        self._eval_mode_warned = False
        self._destroyed = False
        self.global_steps = 0
        self.micro_steps = 0
        self.global_samples = 0
        self._last_grad_norm = 0.0
        #: a JAX engine's random stream, kept from a load and saved back
        self._rng_key_data: Optional[List[int]] = None
        self.training_dataloader = (
            self.deepspeed_io(training_data, collate_fn=collate_fn)
            if training_data is not None else None)

        # observability and fault tolerance (JAX engine.py:236-283)
        self.config.telemetry.apply()
        self.config.fault_injection.apply()
        # the last checkpoint this engine wrote, the host snapshot used
        # before one exists, and the consecutive-recovery count
        self._last_good_ckpt: Optional[Tuple[str, str]] = None
        self._state_snapshot: Optional[dict] = None
        self._rollback_streak = 0
        self._nan_site_warned = False
        self._monitor_write_warned = False
        self.timers = SynchronizedWallClockTimer(
            synchronize=(self.config.wall_clock_breakdown
                         and self.device.type == "cuda"))
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.config.steps_per_print)
        self.monitor = self._build_monitor()
        if self.config.comms_logger.enabled:
            # JAX engine.py:256-257 (one rank has no bucket plan to record)
            from .. import comm
            comm.configure_comms_logger(
                verbose=self.config.comms_logger.verbose)
        self.checkpoint_engine = self._build_checkpoint_engine()
        recorder = get_flight_recorder()
        recorder.set_config("runtime", self.config)
        recorder.record("engine.build", engine="train",
                        zero_stage=self.config.zero_stage,
                        micro_bs=self.train_micro_batch_size_per_gpu(),
                        gas=self.gradient_accumulation_steps())

    # ------------------------------------------------------------------
    # across ranks (JAX engine.py:96-138, :396-464, :613-829)
    # ------------------------------------------------------------------
    def _acc_shape(self, i: int) -> Tuple[int, ...]:
        """Leaf i's gradient accumulator: the whole leaf at one rank;
        across ranks the master's piece (every micro-batch's gradient is
        reduced before it is added)."""
        full = self.param_shapes[i]
        if not self._multi:
            return full
        return self._mlayouts[i].local_shape(self._local_shapes[i])

    def _init_ranks(self) -> None:
        """What only a run across ranks needs: the refusals of what waits
        for item 4, the optimizer checked for shards (LAMB's norms summed
        over them), the scheduler's residuals and stage 3's gather
        table."""
        if self.config.flops_profiler.enabled:
            raise NotImplementedError(
                "flops_profiler across ranks (a profiled pass over sharded "
                "weights) is not in the port yet (ROADMAP Queue 1 item 4)")
        kind = optimizer_kind(self.config.optimizer.type,
                              self.config.optimizer.params.adam_w_mode,
                              self.config.optimizer.params.momentum)
        if self.config.zero_stage >= 1 and kind not in SHARDABLE_KINDS:
            raise NotImplementedError(
                f"optimizer {kind!r} on ZeRO shards: its update is not "
                f"elementwise, and the port steps only {SHARDABLE_KINDS} "
                "on a shard (ROADMAP Queue 1 item 4)")
        if hasattr(self.optimizer, "norm_groups"):
            self.optimizer.norm_groups = {
                id(self._masters[i]): self.topology.group(self._shard_axes(i))
                for i in range(len(self._masters)) if self._shard_axes(i)}
        sched = self.comm_scheduler
        #: this rank's error-feedback residuals (JAX ``comm_residuals``'
        #: row), and the step's working copy
        self._residuals = (sched.init_residuals(self.device)
                           if sched is not None else None)
        self._step_residuals = self._residuals
        self._flat_acc = (torch.zeros(sched.padded_elems,
                                      dtype=self.acc_dtype,
                                      device=self.device)
                          if sched is not None and not sched.overlap
                          else None)
        #: the model gathers its stage-3 pieces layer by layer (a
        #: transformer's forward reads ``active_param_gather``)
        self._layerwise = names_leaves(self.module)
        self._play_by_path = dict(zip(self.param_paths, self._playouts))
        if self.config.comms_logger.enabled and sched is not None:
            from .. import comm
            comm.record_bucket_plan(sched.stats(
                self.gradient_accumulation_steps()))

    def _build_comm_scheduler(self):
        """The collective scheduler under JAX's gates: the config asks
        for it; a data or fsdp axis is larger than 1; no hpz, expert or
        pipe axis is.  The legacy qgZ flag means quantise on, error
        feedback off, overlap on."""
        cfg = self.config
        if not (cfg.comm_optimization.enabled or (
                cfg.zero_stage >= 2 and cfg.zero_quantized_gradients)):
            return None
        topo = self.topology
        if not topo.live_axes(("data", "fsdp")):
            logger.warning(
                "comm_optimization: no data/fsdp axis larger than 1 — "
                "nothing to reduce; scheduler disabled")
            return None
        if any(topo.axis_size(a) > 1 for a in ("expert", "hpz", "pipe")):
            logger.warning(
                "comm_optimization: expert/hpz/pipe meshes keep the "
                "compiler psum (their grad reduction is not a plain "
                "batch-axes sum); scheduler disabled")
            return None
        others = bool(topo.live_axes(("tensor", "seq")))
        if others and getattr(getattr(self.module, "cfg", None),
                              "scan_layers", False):
            # JAX :421-434: its partial-auto regions miscompile a scan over
            # layers, so it keeps the compiler psum; the port takes the
            # same path so both reduce alike
            logger.warning(
                "comm_optimization: tensor/seq meshes + tpu.scan_layers "
                "keep the compiler psum in the JAX package — set "
                "tpu.scan_layers=false to keep the scheduler; falling back "
                "to per-leaf collectives")
            return None
        if others and not cfg.comm_optimization.enabled:
            logger.warning(
                "zero_quantized_gradients: mesh has tensor/seq axes; "
                "enable comm_optimization explicitly for the quantized "
                "wire on such meshes — falling back to per-leaf "
                "collectives")
            return None
        comm_cfg = cfg.comm_optimization
        if not comm_cfg.enabled:
            # seed qgZ semantics: quantized per-micro-batch reduction,
            # no persistent error feedback
            comm_cfg = dataclasses.replace(comm_cfg, quantize=True,
                                           error_feedback=False,
                                           overlap=True)
        from .comm.collective_scheduler import CollectiveScheduler
        # a tensor-sharded leaf's gradient takes the direct exact sum (JAX
        # :155-160: its grad spec touches an auto axis)
        direct = [i for i, lay in enumerate(self._tlayouts) if lay.sharded]
        return CollectiveScheduler(topo, comm_cfg, self._local_shapes,
                                   acc_dtype=self.acc_dtype, direct=direct,
                                   full_shapes=self.param_shapes)

    def _model_parallel(self, model):
        """The forward's model-parallel layout over the tensor and seq
        axes (None when both are 1).  The seq axis splits the tokens of
        a transformer's batch; another model has none to split."""
        topo = self.topology
        if not topo.live_axes(("tensor", "seq")):
            return None
        from ..models.transformer import TransformerConfig
        if topo.sp_world_size > 1 and not isinstance(
                getattr(model, "cfg", None), TransformerConfig):
            raise NotImplementedError(
                f"a seq axis of {topo.sp_world_size} splits a transformer's "
                f"tokens; {type(model).__name__} has none to split (the "
                "port runs sequence parallelism for the transformer "
                "family)")
        from ..parallel.tensor_parallel import ModelParallel
        return ModelParallel.of(topo)

    def _shard_axes(self, i: int) -> Tuple[str, ...]:
        """The axes over which leaf i's master pieces differ: its ZeRO
        axes and ``tensor`` where it is tensor-sharded (a leaf's norm and
        LAMB's trust ratio sum over them)."""
        axes = self._mlayouts[i].axes if self._mlayouts[i].sharded else ()
        if self._tlayouts[i].sharded:
            axes = axes + ("tensor",)
        return axes

    def _whole(self, i: int, piece: torch.Tensor) -> torch.Tensor:
        """Leaf i whole from every rank's master-shaped piece (a gather
        over its ZeRO group, then over tensor: every rank calls it)."""
        topo = self.topology
        return gather_shard(gather_shard(piece, self._mlayouts[i], topo),
                            self._tlayouts[i], topo)

    @torch.no_grad()
    def _compute_params_ranks(self) -> Dict[str, Any]:
        from ..comm import comm
        """This step's compute copy across ranks: whole leaves gathered
        from the master shards in the compute dtype (stages 0-2, and under
        the collective scheduler), or at stage 3 the fp32 pieces of
        ``param_spec`` (the master's own storage where the two layouts
        agree).  qwZ snaps each whole fp32 leaf to the int8 grid first;
        where the piece is the master's and every contiguous run of it in
        the leaf's flat layout is whole 512-element blocks, the piece is
        snapped alone (the same blocks, so the same values) and nothing
        is gathered."""
        qwz = self.config.quantized_weights
        topo, cdt = self.topology, self.compute_dtype
        out = []
        for i, p in enumerate(self._masters):
            mlay, play = self._mlayouts[i], self._playouts[i]
            shape = self.param_shapes[i]
            tlay = self._tlayouts[i]
            if qwz and len(shape) >= 2:
                if (self._pieces and play == mlay and not tlay.sharded
                        and _whole_blocks(mlay, shape)):
                    c = quantize_dequantize(p.detach().float())
                else:
                    # the int8 grid runs over the whole leaf's flat layout
                    full = tlay.shard(quantize_dequantize(
                        self._whole(i, p.detach().float())))
                    c = (play.shard(full).contiguous() if self._pieces
                         else full.to(cdt).contiguous())
            elif not self._pieces:
                # started now, waited for below: the gathers overlap
                c = gather_shard(p.detach().to(cdt), mlay, topo,
                                 async_op=True)
            elif play == mlay and p.dtype == torch.float32:
                c = p.detach()
            else:
                full = gather_shard(p.detach().to(cdt), mlay, topo)
                c = play.shard(full).float().contiguous()
            out.append(c)
        out = [(c.wait() if isinstance(c, comm.Pending) else c
                ).requires_grad_() for c in out]
        return _unflatten(self.params, out)

    def _reduce_full(self, i: int, g: torch.Tensor) -> "_Reduction":
        """The sum over every gradient rank of a whole-leaf gradient,
        as this rank's master piece: a reduce-scatter over the master's
        axes, an all-reduce over the others (started; ``wait()`` gives
        it)."""
        lay = self._mlayouts[i]
        return _Reduction(
            scatter_sum(g, lay, self.topology, async_op=True),
            self.topology.group([a for a in GRAD_REDUCE_AXES
                                 if a not in lay.axes]))

    def _reduce_piece(self, i: int, g: torch.Tensor) -> "_Reduction":
        """Stage 3: a compute piece's gradient (already summed over its
        own axes by the gather's backward) summed over the others, as
        this rank's master piece (started; ``wait()`` gives it)."""
        from ..comm import comm
        play, mlay = self._playouts[i], self._mlayouts[i]
        rest = self.topology.group(
            [a for a in GRAD_REDUCE_AXES if a not in play.axes])
        if rest is not None:
            g = comm.all_reduce(g, rest, async_op=True)
        else:
            g = comm.Pending(g)
        if play == mlay:
            return _Reduction(g)
        return _Reduction(g, reshard=lambda x: mlay.shard(
            gather_shard(x, play, self.topology)).contiguous())

    def _backward_ranks(self, first: bool) -> None:
        """One micro-batch's gradients into the accumulators across
        ranks (:attr:`_acc_shape`)."""
        leaves = tree_leaves(self._params_c)
        local = [c.grad for c in leaves]
        for c in leaves:
            c.grad = None
        sched = self.comm_scheduler
        if sched is not None:
            from ..comm import comm
            seq = self.topology.group(("seq",))
            if seq is not None:
                # JAX's seq axis is automatic inside the scheduler's
                # region: the gradients it sees are summed over the seq
                # ranks' tokens already
                local = [(comm.all_reduce(g, seq, async_op=True)
                          if g is not None else None) for g in local]
                local = [g.wait() if g is not None else None for g in local]
            for i in sched.direct_idx:
                # a tensor shard's gradient: the exact direct sum
                if local[i] is None:
                    if first:
                        self._grads[i].zero_()
                    continue
                piece = self._mlayouts[i].shard(sched.reduce_direct(local[i]))
                if first:
                    self._grads[i].copy_(piece)
                else:
                    self._grads[i].add_(piece)
            flat = sched.flatten_local(
                [g.to(self.acc_dtype) if g is not None else None
                 for g in local], self.device)
            if first:
                self._begin_residuals()
            if not sched.overlap:
                if first:
                    self._flat_acc.copy_(flat)
                else:
                    self._flat_acc.add_(flat)
                return
            red = sched.reduce(flat, self._step_residuals,
                               float(self._loss_scale))
            for i, (acc, g) in enumerate(zip(self._grads,
                                             sched.combine(red))):
                if g is None:
                    continue
                piece = self._mlayouts[i].shard(g)
                if first:
                    acc.copy_(piece)
                else:
                    acc.add_(piece)
            return
        # each micro-batch's gradient is reduced on the wire in the compute
        # dtype, as XLA's psum of the bf16 gradient in JAX, then summed
        # into the fp32 accumulator as the master's piece
        cdt = self.compute_dtype
        reduce = self._reduce_piece if self._pieces else self._reduce_full
        # every leaf's reduction is started before the first is waited
        # for, so the collectives overlap
        steps = [reduce(i, g.to(cdt)) if g is not None else None
                 for i, g in enumerate(local)]
        for i, (acc, step) in enumerate(zip(self._grads, steps)):
            if step is None:
                if first:
                    acc.zero_()
                continue
            g = step.wait()
            if first:
                acc.copy_(g)
            else:
                acc.add_(g)

    def _reduced_grads(self) -> List[torch.Tensor]:
        """The step's gradients summed over the gradient ranks, each as
        this rank's master piece (not yet averaged)."""
        sched = self.comm_scheduler
        if sched is None or sched.overlap:
            return self._grads
        red = sched.reduce(self._flat_acc, self._step_residuals,
                           float(self._loss_scale))
        return [self._mlayouts[i].shard(g).contiguous() if g is not None
                else self._grads[i]
                for i, g in enumerate(sched.combine(red))]

    def _begin_residuals(self) -> None:
        """The step's working residuals: the committed ones, updated in
        place, or under fp16 a copy (an overflow step keeps the committed
        ones, JAX :743-752)."""
        if self._residuals is None:
            self._step_residuals = None
        elif self._fp16_enabled:
            self._step_residuals = self._residuals.clone()
        else:
            self._step_residuals = self._residuals

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm: each shard's squares summed once
        over the ranks that hold distinct shards, a replicated leaf's
        counted once."""
        if not self._multi:
            return torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        from ..comm import comm
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for i, g in enumerate(grads):
            by_axes.setdefault(self._shard_axes(i), []).append(
                torch.linalg.vector_norm(g.float()))
        total = None
        for axes, norms in by_axes.items():
            sq = torch.stack(norms).square().sum()
            grp = self.topology.group(axes) if axes else None
            if grp is not None:
                sq = comm.all_reduce(sq, grp)
            total = sq if total is None else total + sq
        return total.sqrt()

    def _mean_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the batch ranks (a loss): each seq rank
        holds its tokens' share of its rows' loss, so the seq ranks' are
        summed, not averaged."""
        if not self._multi:
            return x
        from ..comm import comm
        grp = self.topology.group(BATCH_AXES + ("seq",))
        if grp is None:
            return x
        return comm.all_reduce(x, grp) / self.topology.batch_shard_size

    def _local_rows(self, mb: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a global micro-batch, and across seq ranks
        its block of every leaf's sequence dimension (JAX
        ``_batch_leaf_sharding``, ``engine.py:855-868``).  The next-token
        labels and their mask cross the seq blocks, so they are built
        from the whole sequence first (``labels``, ``loss_mask``)."""
        if not self._multi:
            return mb
        rows = len(next(iter(mb.values())))
        sl = self.topology.batch_slice(rows)
        mb = {k: x[sl] for k, x in mb.items()}
        if self.topology.sp_world_size == 1:
            return mb
        if "labels" not in mb and "input_ids" in mb:
            ids = _as_tensor(mb["input_ids"])
            labels = torch.full_like(ids, -1)
            labels[:, :-1] = ids[:, 1:]
            mb["labels"] = labels
            if "attention_mask" in mb:
                am = _as_tensor(mb["attention_mask"])
                keep = torch.zeros_like(am)
                keep[:, :-1] = am[:, 1:]
                mb["loss_mask"] = keep
        return {k: (x[:, self.topology.seq_slice(x.shape[1])]
                    if np.ndim(x) >= 2 else x) for k, x in mb.items()}

    def _check_jax_builds(self, model: Model) -> None:
        """Refuse what the JAX engine refuses at build: its state
        shardings cannot hold ``optax.contrib.muon``'s partitioned state
        (any model), nor Adafactor's factored statistics beside a
        transformer's logically partitioned leaves; both raise
        ``ValueError`` there (ROADMAP Queue 3)."""
        from ..models.transformer import TransformerConfig
        kind = optimizer_kind(self.config.optimizer.type)
        if kind == "muon":
            raise ValueError(
                "optimizer 'muon': the JAX engine cannot build its state "
                "shardings over optax.contrib.muon's partitioned state, and "
                "the port refuses it as well (runtime.optimizers.Muon runs "
                "outside the engine)")
        if kind == "adafactor" and isinstance(getattr(model, "cfg", None),
                                              TransformerConfig):
            raise ValueError(
                "optimizer 'adafactor': the JAX engine cannot place "
                "optax.adafactor's factored statistics beside a "
                "transformer's partitioned parameters, and the port refuses "
                "it as well (runtime.optimizers.Adafactor runs outside the "
                "engine and on other models)")

    def _build_monitor(self):
        try:
            from ..monitor.monitor import MonitorMaster
            return MonitorMaster(self.config)
        except Exception as e:      # optional, but say why it is off
            logger.warning("monitor disabled (%s: %s) — training continues "
                           "without monitor writers", type(e).__name__, e)
            return None

    def _monitor_write(self, fn, *args) -> None:
        """One monitor write batch: a raising writer drops the batch
        (counted in ``ds_train_monitor_drop_total``, warned once) and
        never fails the step."""
        try:
            fn(*args)
        except Exception as e:
            tm.TRAIN_MONITOR_DROP.inc()
            if not self._monitor_write_warned:
                self._monitor_write_warned = True
                logger.warning(
                    "monitor write failed (%s: %s) — dropped; further "
                    "drops are counted in ds_train_monitor_drop_total "
                    "without logging", type(e).__name__, e)

    def _build_checkpoint_engine(self):
        from ..checkpoint.engine import TorchCheckpointEngine
        ckpt = self.config.checkpoint
        return TorchCheckpointEngine(async_save=ckpt.async_save,
                                     save_retries=ckpt.save_retries,
                                     save_backoff_s=ckpt.save_backoff_s)

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None,
                     collate_fn: Optional[Callable] = None
                     ) -> DeepSpeedDataLoader:
        """A loader over ``dataset`` in global micro-batches (JAX
        ``engine.py :1360``): the micro-batch times the batch shards, of
        which each rank takes its rows."""
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or (self.train_micro_batch_size_per_gpu()
                                      * self.topology.batch_shard_size),
            collate_fn=collate_fn)

    # ------------------------------------------------------------------
    # accessors (JAX engine.py:902-925)
    # ------------------------------------------------------------------
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def get_lr(self) -> List[float]:
        return [float(self._schedule(self.global_steps))]

    @property
    def loss_scale(self) -> float:
        return float(self._loss_scale)

    @property
    def skipped_steps(self) -> int:
        """Steps skipped on an fp16 overflow."""
        return self._skipped_steps

    def _init_loss_scale(self) -> None:
        """JAX ``_initial_loss_scale`` and the ``TrainState`` counters:
        1 outside fp16, a static ``loss_scale`` > 0, else ``2 **
        initial_scale_power`` (fp32, as JAX keeps it)."""
        fp16 = self.config.fp16
        if not self._fp16_enabled:
            scale = 1.0
        elif fp16.loss_scale > 0:
            scale = float(fp16.loss_scale)
        else:
            scale = float(2 ** fp16.initial_scale_power)
        self._loss_scale = np.float32(scale)
        self._good_steps = 0
        self._skipped_steps = 0
        self._hysteresis = int(fp16.hysteresis)

    def _scale_state(self) -> Dict[str, Any]:
        return {"loss_scale": float(self._loss_scale),
                "good_steps": self._good_steps,
                "skipped_steps": self._skipped_steps,
                "hysteresis": self._hysteresis}

    def _load_scale_state(self, st: Dict[str, Any]) -> None:
        if "loss_scale" in st:
            self._loss_scale = np.float32(st["loss_scale"])
        self._good_steps = int(st.get("good_steps", self._good_steps))
        self._skipped_steps = int(st.get("skipped_steps",
                                         self._skipped_steps))
        self._hysteresis = int(st.get("hysteresis", self._hysteresis))

    def _update_loss_scale(self, finite: bool) -> None:
        """The step's loss-scale bookkeeping (JAX engine.py:777-806): an
        applied step counts a good step, a skip zeroes them; dynamically,
        an overflow with hysteresis above 1 only decrements it, else
        halves the scale (floored at ``min_loss_scale``) and resets it;
        every ``loss_scale_window``-th good step in a row doubles the
        scale and resets hysteresis."""
        if finite:
            self._good_steps += 1
        else:
            self._good_steps = 0
            self._skipped_steps += 1
        fp16 = self.config.fp16
        if not (self._fp16_enabled and fp16.loss_scale == 0):
            return
        halve = not finite and self._hysteresis <= 1
        if not finite and not halve:
            self._hysteresis -= 1
        if halve:
            self._loss_scale = np.maximum(
                self._loss_scale / np.float32(2.0),
                np.float32(fp16.min_loss_scale))
            self._hysteresis = int(fp16.hysteresis)
        if finite and self._good_steps % fp16.loss_scale_window == 0:
            with np.errstate(over="ignore"):
                self._loss_scale = self._loss_scale * np.float32(2.0)
            self._hysteresis = int(fp16.hysteresis)

    @property
    def masters(self) -> List[torch.Tensor]:
        """The weights in tree order: the fp32 masters the device
        optimizer steps, and for offloaded leaves their compute-dtype
        copies (the fp32 masters are ``offload.masters``)."""
        return self._masters

    def _update_count(self) -> int:
        """The optimizer's update count (optax's ``count``), which the LR
        schedule reads as in JAX: the device optimizer's, or with every
        leaf offloaded the host optimizer's."""
        if self.optimizer is None:
            return self.offload.update_count()
        st = self.optimizer.state.get(self._masters[self._device_index[0]])
        return int(st["step"]) if st else 0

    def get_global_grad_norm(self) -> float:
        return self._last_grad_norm

    @property
    def state(self) -> TrainState:
        """The state in JAX ``TrainState``'s fields (``step`` counts
        skipped steps too, as JAX's does)."""
        return TrainState(
            step=self.global_steps, params=self.params,
            opt_state=(self.optimizer.state if self.optimizer is not None
                       else None),
            loss_scale=float(self._loss_scale), good_steps=self._good_steps,
            skipped_steps=self._skipped_steps, hysteresis=self._hysteresis,
            comm_residuals=(self._residuals if self._residuals is not None
                            else ()))

    def is_gradient_accumulation_boundary(self) -> bool:
        """Whether :meth:`step` applies the update; a boundary set with
        :meth:`set_gradient_accumulation_boundary` overrides the count."""
        if self._ga_boundary is not None:
            return self._ga_boundary
        return self._pending >= self.gradient_accumulation_steps()

    # ------------------------------------------------------------------
    # one step, in three calls
    # ------------------------------------------------------------------
    def _compute_params(self) -> Dict[str, Any]:
        """This step's compute-dtype copy of the masters, made once per
        step; gradients are taken with respect to it.  In fp32 a leaf's
        copy shares the master's storage (nothing changes it until the
        update, after the last backward), except under qwZ, where every
        leaf of two or more dimensions is a new, quantised tensor: its
        blocks run over the leaf's flat layout as the tree holds it
        (stacked ``[L, ...]`` leaves whole, norm scales included)."""
        if self._params_c is None and self._multi:
            self._params_c = self._compute_params_ranks()
        if self._params_c is None:
            qwz = self.config.quantized_weights

            def cast(p):
                if qwz and p.dim() >= 2:
                    c = quantize_dequantize(p.detach().float(),
                                            dtype=self.compute_dtype)
                else:
                    c = p.detach().to(self.compute_dtype)
                return c.requires_grad_()
            self._params_c = tree_map(cast, self.params)
        return self._params_c

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The loss of one micro-batch under the current masters, with
        its autograd graph (pass it to :meth:`backward`)."""
        self._check_not_destroyed()
        params = self._compute_params()
        batch = self._to_device(batch)
        from ..parallel.tensor_parallel import model_parallel
        with model_parallel(self._mp):
            if not self._pieces:
                return self.module.loss(params, batch)
            # stage 3 across ranks: the pieces, gathered where they are
            # used
            gather = ParamGather(self._play_by_path, self.topology,
                                 self.compute_dtype,
                                 stacked=bool(getattr(self.module.cfg,
                                                      "scan_layers", False))
                                 if self._layerwise else False)
            if not self._layerwise:
                return self.module.loss(gather.tree(params), batch)
            with gather.active():
                return self.module.loss(params, batch)

    __call__ = forward

    def _reported_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The micro-batch loss as JAX reports it: under fp16 the scaled
        loss divided by the scale (inf when the scaled loss
        overflowed)."""
        loss = loss.detach().float()
        if self._fp16_enabled:
            scale = float(self._loss_scale)
            loss = (loss * scale) / scale
        return loss

    def backward(self, loss: torch.Tensor) -> None:
        """Backpropagate one micro-batch's loss and add its gradient, in
        fp32, to the accumulators."""
        if self._params_c is None:
            raise RuntimeError("backward() needs the loss of a forward() "
                               "of this step")
        if self._fp16_enabled:
            # JAX's scaled loss, (loss * scale) in fp32
            loss = loss.float() * float(self._loss_scale)
        loss.backward()
        first = self._pending == 0
        if self._multi:
            self._backward_ranks(first)
            self._pending += 1
            self.micro_steps += 1
            return
        for g, c in zip(self._grads, tree_leaves(self._params_c)):
            if c.grad is None:          # a leaf the loss does not use
                if first:
                    g.zero_()
            elif first:
                g.copy_(c.grad)
            else:
                g.add_(c.grad)
            c.grad = None
        self._pending += 1
        self.micro_steps += 1

    def step(self) -> None:
        """At the gradient-accumulation boundary: average, clip and apply
        the update over the micro-batches taken (all gas of them, or as
        many as a forced boundary found); before it, do nothing (JAX
        ``step`` semantics).  Under fp16 a non-finite gradient norm skips
        the update (JAX ``lax.cond``)."""
        if not self.is_gradient_accumulation_boundary() or not self._pending:
            return
        grads = self._reduced_grads() if self._multi else self._grads
        sched = self.comm_scheduler
        # the scheduler divides by its world before the wire (JAX); the
        # per-leaf collectives sum, so the step divides by the shards
        shards = (self.topology.batch_shard_size
                  if self._multi and sched is None else 1)
        if self._fp16_enabled:
            # JAX's 1 / (gas * scale) in fp32 (0 when the product
            # overflows)
            with np.errstate(over="ignore"):
                inv = float(np.float32(1.0) / (
                    np.float32(self._pending) * self._loss_scale
                    * np.float32(shards)))
        else:
            inv = 1.0 / (self._pending * shards)
        for g in grads:
            g.mul_(inv)
        gnorm = self._global_norm(grads)
        # under fp16 the skip decision needs the norm before the update
        finite = (math.isfinite(float(gnorm)) if self._fp16_enabled
                  else True)
        if self._fp16_enabled and self._multi:
            # every rank skips the same step
            from ..comm import comm
            flag = torch.tensor([0.0 if finite else 1.0],
                                device=self.device)
            finite = float(comm.all_reduce(flag, None, "max")) == 0.0
        if sched is not None and self._residuals is not None and (
                finite or not self._fp16_enabled):
            # an overflow step's residuals would carry inf payloads
            self._residuals = self._step_residuals
        clip = self.config.gradient_clipping
        if clip > 0 and finite:
            scale = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        count = self._update_count()
        lr = self._schedule(count)
        if finite:
            if self.optimizer is not None:
                opt_lr = self._schedule(
                    count + type(self.optimizer).lr_count_offset)
                for group in self.optimizer.param_groups:
                    group["lr"] = opt_lr
                self.optimizer.step(
                    grads=[grads[i] for i in self._device_index])
            if self.offload is not None:
                # the host step at the applied lr of the device step
                with trace_span("train.offload_step"):
                    self._apply_offload_step(float(lr))
        self._update_loss_scale(finite)
        self._last_step_applied = finite
        micro_batches = self._pending
        self._params_c = None
        self._pending = 0
        self._last_lr = float(lr)
        self._last_grad_norm = float(gnorm)
        self.global_steps += 1
        self.global_samples += (self.train_micro_batch_size_per_gpu()
                                * micro_batches
                                * self.topology.batch_shard_size)
        self.lr_scheduler.step()

    def _staging_buffer(self) -> torch.Tensor:
        """One flat fp32 host buffer the size of the largest offloaded
        leaf, page-locked when the leaves are on the card: every gradient
        and every updated master crosses through it.  It is registered
        with ``cudaHostRegister`` rather than taken from PyTorch's pinned
        cache, which rounds a block up to a power of two (8 GB for
        Llama-2-7B's 5.77 GB MLP leaf)."""
        if self._staging is None:
            n = max(self._grads[i].numel() for i in self._host_index)
            self._staging = torch.empty(n, dtype=torch.float32)
            if self.device.type == "cuda":
                _register_host(self, self._staging)
        return self._staging

    @torch.no_grad()
    def _apply_offload_step(self, lr: float) -> None:
        """The host optimizer step over the offloaded leaves (JAX
        ``_apply_offload_step``): leaf by leaf, the reduced and clipped
        gradient goes device -> host through the fp32 staging buffer (the
        cast to fp32 of a bf16 sum happens there), the host kernel steps
        the master, and the master goes back through the staging buffer
        into the leaf's accumulator (free until the next backward) to
        refresh the compute-dtype copy in place."""
        times = dict.fromkeys(("device_wait", "d2h", "host_step", "h2d",
                               "nvme_wait"), 0.0)
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(self.device)
        times["device_wait"] = time.perf_counter() - t0
        staging = self._staging_buffer()
        order = sorted(self._host_index, key=self._host_index.get)
        swapper = self.offload.swapper
        wait0 = swapper.wait_s if swapper is not None else 0.0

        class _Staged:
            """Leaf k's gradient, staged on the host when it is read."""

            def __len__(self):
                return len(order)

            def __getitem__(_, k):
                t = time.perf_counter()
                g = self._grads[order[k]].reshape(-1)
                host = staging[:g.numel()]
                host.copy_(g)
                times["d2h"] += time.perf_counter() - t
                return host.numpy()

        def on_update(k, master):
            t = time.perf_counter()
            i = order[k]
            acc = self._grads[i].reshape(-1)
            host = staging[:acc.numel()]
            host.copy_(torch.from_numpy(master))    # into pinned memory
            acc.copy_(host)
            self._masters[i].copy_(acc.view(self._masters[i].shape))
            if cuda:
                torch.cuda.synchronize(self.device)
            times["h2d"] += time.perf_counter() - t

        t1 = time.perf_counter()
        self.offload.step(_Staged(), lr=lr, on_update=on_update)
        if swapper is not None:
            times["nvme_wait"] = swapper.wait_s - wait0
        times["host_step"] = (time.perf_counter() - t1 - times["d2h"]
                              - times["h2d"] - times["nvme_wait"])
        self.offload_times = times

    @torch.no_grad()
    def _refresh_offloaded(self) -> None:
        """Each offloaded leaf's compute-dtype copy from its host master."""
        for i, k in self._host_index.items():
            p = self._masters[i]
            p.copy_(torch.from_numpy(self.offload.masters[k]).view(p.shape))

    # ------------------------------------------------------------------
    # whole batches
    # ------------------------------------------------------------------
    def _micro_batches(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        """A global batch, [gas * micro, ...] or [gas, micro, ...] per
        leaf, -> gas micro-batch dicts (JAX ``_shape_batch``)."""
        gas = self.gradient_accumulation_steps()
        micro = (self.train_micro_batch_size_per_gpu()
                 * self.topology.batch_shard_size)
        shaped = {}
        for k, x in batch.items():
            x = x if isinstance(x, torch.Tensor) else np.asarray(x)
            if x.shape[0] == gas * micro:
                x = x.reshape((gas, micro) + tuple(x.shape[1:]))
            elif not (x.ndim >= 2 and tuple(x.shape[:2]) == (gas, micro)):
                raise ValueError(f"batch leaf {k!r} of shape "
                                 f"{tuple(x.shape)} does not split into "
                                 f"gas={gas} x micro={micro}")
            shaped[k] = x
        return [self._local_rows({k: x[i] for k, x in shaped.items()})
                for i in range(gas)]

    def _resolve_batch(self, batch: Optional[Dict[str, Any]],
                       data_iter) -> List[Dict[str, Any]]:
        """This step's gas micro-batches, from ``batch`` or, without one,
        from ``data_iter`` or the training dataloader (JAX
        ``_resolve_batch``: an iterable without ``__next__`` is restarted
        with ``iter()`` on every call)."""
        if batch is not None:
            return self._micro_batches(batch)
        source = data_iter if data_iter is not None \
            else self.training_dataloader
        if source is None:
            raise ValueError("no batch and no dataloader")
        it = source if hasattr(source, "__next__") else iter(source)
        micro = (self.train_micro_batch_size_per_gpu()
                 * self.topology.batch_shard_size)
        mbs = []
        for _ in range(self.gradient_accumulation_steps()):
            mb = next(it)
            for k, x in mb.items():
                if len(x) != micro:
                    raise ValueError(f"loader batch leaf {k!r} has "
                                     f"{len(x)} rows, the micro-batch is "
                                     f"{micro}")
            mbs.append(self._local_rows(mb))
        return mbs

    def train_batch(self, batch: Optional[Dict[str, Any]] = None,
                    data_iter=None) -> float:
        """gas micro-batches of forward and backward, then the update;
        returns the mean micro-batch loss.  The micro-batches come from
        ``batch`` or, without one, from ``data_iter`` or the training
        dataloader.  With ``fault_tolerance.self_healing`` a non-finite
        step rolls back and a transient fault retries (JAX
        ``train_batch``)."""
        if self._pending:
            raise RuntimeError("micro-batches from forward()/backward() are "
                               "pending; finish the step with step()")
        ft = self.config.fault_tolerance
        if not ft.self_healing:
            try:
                return self._train_batch_impl(
                    self._resolve_batch(batch, data_iter))
            except Exception as e:
                # crash forensics: a postmortem bundle before the
                # exception leaves the engine; never masks it
                get_flight_recorder().on_crash("train_batch", e)
                raise
        return self._train_batch_self_healing(batch, data_iter, ft)

    # -- self-healing (JAX engine.py:968-1079) ---------------------------
    def _train_batch_self_healing(self, batch, data_iter, ft) -> float:
        if self._last_good_ckpt is None and self._state_snapshot is None:
            # a rollback target exists before the first guarded step
            self._snapshot_state()
        # materialised once: a retry replays the same micro-batches
        mbs = self._resolve_batch(batch, data_iter)
        attempt = 0
        while True:
            try:
                loss = self._train_batch_impl(mbs)
            except TransientFault as e:
                # raised before any state changed: retry the same batch
                attempt += 1
                tm.TRAIN_RETRY.inc()
                get_flight_recorder().record(
                    "selfheal.retry", attempt=attempt,
                    error=f"{type(e).__name__}: {e}"[:200])
                if attempt > ft.max_retries:
                    get_flight_recorder().on_crash("train_batch", e)
                    raise
                logger.warning(
                    "self-healing: transient fault in train_batch (%s) "
                    "— retry %d/%d", e, attempt, ft.max_retries)
                time.sleep(ft.backoff_s * (2 ** (attempt - 1)))
                continue
            except Exception as e:
                get_flight_recorder().on_crash("train_batch", e)
                raise
            # an fp16 overflow skip is routine: only an applied step's
            # non-finite values roll back
            bad = self._last_step_applied and not (
                math.isfinite(loss) and math.isfinite(self._last_grad_norm))
            if not bad:
                self._rollback_streak = 0
                self._maybe_refresh_snapshot(ft)
                return loss
            # a non-finite applied step: the masters may hold NaN/inf —
            # roll back and skip this batch
            self._rollback_streak += 1
            tm.TRAIN_ROLLBACK.inc()
            bad_step = self.global_steps - 1
            get_flight_recorder().record(
                "selfheal.rollback", streak=self._rollback_streak,
                at_step=bad_step, loss=repr(loss))
            time.sleep(ft.backoff_s * (2 ** (self._rollback_streak - 1)))
            # restore first, also when giving up: the caller catches the
            # error with the engine at its last good state
            source = self._restore_last_good()
            if self._rollback_streak > ft.max_retries:
                err = RuntimeError(
                    f"self-healing: {self._rollback_streak} consecutive "
                    f"non-finite steps exceed "
                    f"fault_tolerance.max_retries={ft.max_retries}")
                get_flight_recorder().on_crash("train_batch", err)
                raise err
            logger.warning(
                "self-healing: non-finite step at global step %d — "
                "rolled back to %s and skipped the batch window "
                "(rollback %d/%d)", bad_step, source,
                self._rollback_streak, ft.max_retries)
            return loss         # the non-finite loss is surfaced

    def _snapshot_state(self) -> None:
        """A host copy of everything a rollback restores: masters,
        optimizer state, counters, the loss scale and the LR
        scheduler."""
        opt_state = self.optimizer.state if self.optimizer else {}
        self._state_snapshot = {
            "masters": [None if off else _host(p)
                        for p, off in zip(self._masters, self._offloaded)],
            "optimizer": [
                {k: _host(v) for k, v in opt_state[p].items()}
                if not off and opt_state.get(p) else None
                for p, off in zip(self._masters, self._offloaded)],
            "offload": (self.offload.state_dict()
                        if self.offload is not None else None),
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "rng_key_data": self._rng_key_data,
            **self._scale_state(),
        }

    def _maybe_refresh_snapshot(self, ft) -> None:
        if ft.snapshot_interval > 0 and \
                self.global_steps % ft.snapshot_interval == 0:
            self._snapshot_state()

    def _restore_last_good(self) -> str:
        """Roll back to the last good checkpoint (it outlives the
        process) or else the host snapshot, in place; returns which."""
        if self._last_good_ckpt is not None:
            save_dir, tag = self._last_good_ckpt
            try:
                self._load_checkpoint_impl(save_dir, tag, True, True, False)
                return f"checkpoint {tag}"
            except Exception as e:
                if self._state_snapshot is None:
                    raise
                logger.warning(
                    "self-healing: checkpoint rollback to %s failed (%s) — "
                    "falling back to the in-memory snapshot", tag, e)
        snap = self._state_snapshot
        if snap is None:
            raise RuntimeError("self-healing: no rollback target")
        self._copy_masters(snap["masters"])
        self._copy_optimizer_state(snap["optimizer"])
        if snap["offload"] is not None:
            self.offload.load_state_dict(snap["offload"])
            self._refresh_offloaded()
        self._finish_load(snap, True)
        return f"snapshot at step {snap['global_steps']}"

    def _train_batch_impl(self, mbs: List[Dict[str, Any]]) -> float:
        self._check_not_destroyed()
        # the fault sites, all before any state changes: a collective
        # failure is retry-safe; a NaN batch flows through the real step,
        # so recovery must really repair the masters
        fi = get_fault_injector()
        if fi.armed:
            fi.maybe_raise("comm.collective_failure",
                           InjectedCollectiveFault,
                           "injected collective failure at dispatch")
            if fi.has_site("train.nan_grad"):
                # a token-only batch has nothing to poison: the site is
                # skipped and not counted
                if not any(_is_float(x) for mb in mbs for x in mb.values()):
                    if not self._nan_site_warned:
                        self._nan_site_warned = True
                        logger.warning(
                            "fault injection: train.nan_grad is armed but "
                            "the batch has no floating-point leaf to "
                            "poison — site skipped (not counted)")
                elif fi.fire("train.nan_grad"):
                    mbs = [{k: _nan_like(x) if _is_float(x) else x
                            for k, x in mb.items()} for mb in mbs]

        if not self._train_mode and not self._eval_mode_warned:
            self._eval_mode_warned = True
            logger.warning(
                "train_batch called on an engine in eval() mode; the batch "
                "runs in the TRAIN regime (use eval_batch for eval-regime "
                "scoring)")
        self.timers(TRAIN_BATCH_TIMER).start()
        self.tput_timer.start()
        watchdog = get_watchdog()
        t_batch0 = None
        if telemetry_state.enabled:
            get_tracer().set_step(self.global_steps)
            t_batch0 = time.perf_counter()
        with trace_span("train.batch"):
            with trace_span("train.place_batch"), \
                    watchdog.track("input_wait"):
                mbs = [self._to_device(mb) for mb in mbs]
            # the first step builds the kernels: the watchdog's compile
            # phase, as the JAX engine's first step traces
            self._maybe_profile_flops(mbs)
            with trace_span("train.step"), watchdog.track(
                    "compile" if self.global_steps == 0 else "step"):
                losses = []
                for mb in mbs:
                    loss = self.forward(mb)
                    self.backward(loss)
                    losses.append(self._reported_loss(loss))
                self.step()
                loss = float(self._mean_over_batch(torch.stack(losses).mean()))
        step = self.global_steps - 1
        if fi.armed and fi.fire("train.slow_step"):
            # inside the measured window: the anomaly detector sees it
            # as it would a real straggler
            time.sleep(fi.site_value("train.slow_step", 100.0) / 1e3)
        if telemetry_state.enabled:
            # an fp16 overflow skip feeds the skip counter only; the
            # non-finite verdict is for steps the engine applied
            if not self._last_step_applied:
                watchdog.note_overflow_skip(step)
            else:
                if not math.isfinite(loss):
                    watchdog.note_nonfinite("loss", step, loss)
                if not math.isfinite(self._last_grad_norm):
                    watchdog.note_nonfinite("grad_norm", step,
                                            self._last_grad_norm)
        self.tput_timer.stop(
            report_speed=self.global_steps % self.config.steps_per_print == 0)
        self.timers(TRAIN_BATCH_TIMER).stop()
        if t_batch0 is not None:
            watchdog.observe_step_time(
                "train", (time.perf_counter() - t_batch0) * 1e3, step=step)
        if self.monitor is not None:
            self._monitor_write(self.monitor.write_events, [
                ("Train/Samples/train_loss", loss, self.global_samples),
                ("Train/Samples/lr", self._last_lr, self.global_samples)])
            if self.global_steps % self.config.steps_per_print == 0:
                self._monitor_write(self.monitor.write_registry_snapshot,
                                    self.global_samples)
        if self.config.wall_clock_breakdown and \
                self.global_steps % self.config.steps_per_print == 0:
            self.timers.log([TRAIN_BATCH_TIMER])
        return loss

    def eval_batch(self, batch: Dict[str, Any]) -> float:
        """The loss of ``batch`` under the current masters (across ranks:
        of this rank's rows, averaged over the batch ranks)."""
        with torch.no_grad():
            return float(self._mean_over_batch(
                self.forward(self._local_rows(batch))))

    # ------------------------------------------------------------------
    # the flops profiler (JAX engine.py:1227-1250)
    # ------------------------------------------------------------------
    def _maybe_profile_flops(self, mbs: List[Dict[str, Any]]) -> None:
        """At ``flops_profiler.profile_step``, count one forward and
        backward of this step's micro-batches (the gradients go nowhere,
        so the step that follows is the one it would have been; nothing
        random is drawn) and print the report (JAX
        ``_maybe_profile_flops``, which lowers the step instead)."""
        fp_cfg = self.config.flops_profiler
        if not fp_cfg.enabled or self.global_steps != fp_cfg.profile_step:
            return
        from ..profiling import FlopsProfiler
        prof = FlopsProfiler(params=self.params)
        leaves = tree_leaves(self._compute_params())
        prof.start_profile()
        try:
            for mb in mbs:
                loss = self.module.loss(self._params_c, mb)
                torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            prof.stop_profile()
        prof._duration = self.tput_timer.avg_step_time()
        #: the profiled step's profiler, kept for the caller to read
        self.flops_profile = prof
        prof.print_model_profile(
            profile_step=self.global_steps,
            module_depth=fp_cfg.module_depth,
            top_modules=fp_cfg.top_modules, detailed=fp_cfg.detailed,
            output_file=fp_cfg.output_file)

    # ------------------------------------------------------------------
    # checkpoints (JAX engine.py:1369-1567)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        save_latest: bool = True) -> bool:
        """Save the masters, the optimizer state and ``client_state`` (with
        the engine's counters and LR scheduler) under ``<save_dir>/<tag>``
        (default ``global_step<n>``).  With ``save_latest`` the async
        writer is drained and ``latest`` names the tag; without it the
        caller commits the pointer (``checkpoint_engine.wait()`` then
        ``write_latest``) and the write overlaps the next steps."""
        with get_watchdog().track("checkpoint"):
            return self._save_checkpoint_impl(save_dir, tag, client_state,
                                              save_latest)

    def _save_checkpoint_impl(self, save_dir, tag, client_state,
                              save_latest) -> bool:
        tag = tag or f"global_step{self.global_steps}"
        get_flight_recorder().record("checkpoint.save", dir=save_dir,
                                     tag=tag, global_step=self.global_steps)
        client_state = dict(client_state or {})
        client_state.update({
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "pipe_stages": 1,
        })
        if self._rng_key_data is not None:
            client_state["rng_key_data"] = list(self._rng_key_data)
        state = {"module": self.params, "optimizer": self.optimizer_kind,
                 "optimizer_state_dict": self._optimizer_state_dict(),
                 "loss_scale_state": self._scale_state()}
        if self._multi:
            # rank 0 writes the one-rank files from every rank's shards
            state["module"] = self._whole_tree(self._masters, host=True)
            residuals = self._whole_residuals()
            if residuals is not None:
                state["comm_residuals"] = residuals
            if self.topology.rank != 0:
                self._last_good_ckpt = (save_dir, tag)
                self._barrier()
                return True
        self.checkpoint_engine.save(save_dir, tag, state, client_state)
        if self.offload is not None:
            # the host masters and moments beside it, in JAX's npz
            os.makedirs(os.path.join(save_dir, tag), exist_ok=True)
            self.offload.save_npz(os.path.join(save_dir, tag,
                                               OFFLOAD_FILE))
        if save_latest:
            # latest last, after the writer drained: a crash before it
            # leaves latest naming the previous complete checkpoint
            self.checkpoint_engine.wait()
            self.checkpoint_engine.write_latest(save_dir, tag)
        # the freshest rollback target (a load waits for the writer)
        self._last_good_ckpt = (save_dir, tag)
        if self._multi:
            # the other ranks read what rank 0 wrote
            self.checkpoint_engine.wait()
            self._barrier()
        return True

    def _barrier(self) -> None:
        from ..comm import comm
        comm.barrier()

    def _whole_tree(self, pieces: List[torch.Tensor], host: bool = False):
        """The masters' tree with every leaf whole (an all-gather of each
        shard: every rank calls it); ``host`` moves them to the host on
        rank 0 and gives None leaves elsewhere."""
        out = []
        for i, t in enumerate(pieces):
            full = self._whole(i, t.detach())
            if host:
                full = full.cpu() if self.topology.rank == 0 else None
            out.append(full)
        return _unflatten(self.params, out)

    def _whole_residuals(self) -> Optional[torch.Tensor]:
        """JAX's [world, E] residuals on rank 0 (every rank calls it)."""
        sched = self.comm_scheduler
        if sched is None or self._residuals is None:
            return None
        from ..comm import comm
        full = comm.all_gather(self._residuals, sched.group, axis=0,
                               tiled=False)
        return full.cpu() if self.topology.rank == 0 else None

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False):
        """Load ``tag`` (default: the one ``latest`` names) in place;
        returns ``(tag, client_state)``, ``(None, {})`` when there is no
        checkpoint.  Without the optimizer states (or ``load_module_only``)
        only the masters load and the optimizer keeps its trajectory."""
        with get_watchdog().track("checkpoint"):
            return self._load_checkpoint_impl(
                load_dir, tag, load_optimizer_states,
                load_lr_scheduler_states, load_module_only)

    def _load_checkpoint_impl(self, load_dir, tag, load_optimizer_states,
                              load_lr_scheduler_states, load_module_only):
        get_flight_recorder().record("checkpoint.load", dir=load_dir,
                                     tag=tag or "")
        if self.config.checkpoint.load_universal:
            # a universal directory, or the <tag>_universal sibling that
            # ds_to_universal wrote beside the checkpoint
            from ..checkpoint.universal import (ATOMS_FILE,
                                                load_universal_into_engine)
            cand = None
            if os.path.exists(os.path.join(load_dir, ATOMS_FILE)):
                cand = load_dir
            else:
                t = tag or self.checkpoint_engine.read_latest(load_dir)
                if t is not None:
                    c = os.path.join(load_dir, f"{t}_universal")
                    if os.path.exists(os.path.join(c, ATOMS_FILE)):
                        cand = c
            if cand is None:
                raise FileNotFoundError(
                    f"checkpoint.load_universal: no universal atoms under "
                    f"{load_dir!r} — run ds_to_universal first")
            load_universal_into_engine(
                self, cand,
                load_optimizer_states=(load_optimizer_states
                                       and not load_module_only),
                load_lr_scheduler_states=load_lr_scheduler_states)
            return load_dir, {}
        tag = tag or self.checkpoint_engine.read_latest(load_dir)
        if tag is None:
            return None, {}
        module_only = load_module_only or not load_optimizer_states
        state, client_state = self.checkpoint_engine.load(
            load_dir, tag, module_only=module_only)
        module = state["module"]
        if self._multi and self._residuals is not None:
            self._load_residuals(state.get("comm_residuals"))
        if leaf_paths(module) != self.param_paths:
            raise ValueError(f"checkpoint {tag!r} holds another model's "
                             f"tree: {leaf_paths(module)[:4]}...")
        self._copy_masters(tree_leaves(module))
        if not module_only:
            if state["optimizer"] != self.optimizer_kind:
                raise ValueError(
                    f"checkpoint {tag!r} holds {state['optimizer']} state; "
                    f"this engine runs {self.optimizer_kind}")
            per_param = state["optimizer_state_dict"]["state"]
            self._copy_optimizer_state(
                [per_param.get(i) for i in range(len(self._masters))])
            client_state = {**state.get("loss_scale_state", {}),
                            **client_state}
        if self.offload is not None:
            off_path = os.path.join(load_dir, tag, OFFLOAD_FILE)
            if not module_only and os.path.exists(off_path):
                self.offload.load_npz(off_path)
            # else (a module-only load, or a checkpoint saved without
            # offload) the masters were re-synced from the module above,
            # so the next step does not push init-era masters back
        self._finish_load(client_state, load_lr_scheduler_states)
        return tag, client_state

    def _load_residuals(self, full) -> None:
        """This rank's row of a checkpoint's [world, E] residuals; zeros
        when the checkpoint has none or another plan's (JAX's plain load
        falls back to zeros)."""
        sched = self.comm_scheduler
        want = (sched.world, sched.padded_elems)
        if full is None or tuple(full.shape) != want:
            self._residuals.zero_()
            return
        row = self.topology.index(sched.manual_axes)
        self._residuals.copy_(_as_tensor(full)[row])

    def _optimizer_state_dict(self) -> Dict[str, Any]:
        """The device optimizer's state dict, its per-parameter states
        keyed by the leaf's index in tree order; ``offloaded`` lists the
        paths whose state is in the host optimizer's npz.  Across ranks
        every moment is gathered whole (every rank calls it)."""
        if self.optimizer is None:
            sd = {"state": {}, "param_groups": []}
        else:
            sd = self.optimizer.state_dict()
            sd["state"] = {self._device_index[j]: st
                           for j, st in sd["state"].items()}
            if self._multi:
                rank0 = self.topology.rank == 0

                def whole(i, v):
                    full = self._whole(i, v)
                    return full.cpu() if rank0 else None
                sd["state"] = {i: {
                    k: (whole(i, v) if isinstance(v, torch.Tensor)
                        and v.dim() else v)
                    for k, v in st.items()} for i, st in sd["state"].items()}
        if self.offload is not None:
            sd["offloaded"] = list(self.offload.offload_paths)
        return sd

    @torch.no_grad()
    def _copy_masters(self, sources: List[Any]) -> None:
        """Copy into the masters in place (the optimizer holds them); a
        None source leaves its master as it is."""
        for i, (p, src) in enumerate(zip(self._masters, sources)):
            if src is None:
                continue
            src = self._piece_of(i, _as_tensor(src), p)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"master of shape {tuple(p.shape)} cannot "
                                 f"load {tuple(src.shape)}")
            if self._offloaded[i]:
                master = self.offload.masters[self._host_index[i]]
                torch.from_numpy(master).copy_(src.reshape(-1))
            p.copy_(src)

    @torch.no_grad()
    def _copy_optimizer_state(self, states: List[Optional[dict]]) -> None:
        """Each master's optimizer state from ``states`` (``step`` and
        moments, in tree order), copied into the existing moments; None
        empties a master's state (a fresh optimizer)."""
        for i, (p, st) in enumerate(zip(self._masters, states)):
            if self._offloaded[i]:
                self._copy_host_state(self._host_index[i], st)
                continue
            if st is None:
                self.optimizer.state.pop(p, None)
                continue
            cur = self.optimizer.state[p]
            if not cur:
                self.optimizer._init_state(p, cur)
            for k, v in st.items():
                if k == "step":
                    cur["step"] = int(v)
                elif k in cur:
                    cur[k].copy_(self._piece_of(i, _as_tensor(v), cur[k]))
                else:
                    raise KeyError(f"optimizer state {k!r} is not "
                                   f"{type(self.optimizer).__name__}'s")

    def _piece_of(self, i: int, src: torch.Tensor,
                  like: torch.Tensor) -> torch.Tensor:
        """``src`` as leaf i's master piece: a whole leaf is cut to this
        rank's shard, a piece already of the shard's shape is kept."""
        if (self._multi and tuple(src.shape) == self.param_shapes[i]
                and tuple(like.shape) != tuple(src.shape)):
            return self._mlayouts[i].shard(self._tlayouts[i].shard(src))
        return src

    def _copy_host_state(self, k: int, st: Optional[dict]) -> None:
        """Master k's host optimizer state from ``st`` (``step`` and the
        slots it holds; a slot it lacks keeps its value); None keeps the
        state as it is (its npz, or none, carries it)."""
        if st is None:
            return
        off = self.offload
        size = off.masters[k].size
        if off.swapper is not None:
            cur = {name: off.swapper.fetch(f"l{k}_{name}", size)
                   for name in off.host_opt.SLOTS}
        else:
            cur = off.host_opt.state_for(k, size)
        for name, v in st.items():
            if name == "step":
                off.host_opt._steps[k] = int(v)
            elif name in cur:
                torch.from_numpy(cur[name]).copy_(
                    _as_tensor(v).reshape(-1))
            else:
                raise KeyError(f"optimizer state {name!r} is not "
                               f"{type(off.host_opt).__name__}'s")
        off.host_opt._steps.setdefault(k, 0)
        if off.swapper is not None:
            for name, buf in cur.items():
                off.swapper.writeback(f"l{k}_{name}", buf)
            off.swapper.flush()

    def _finish_load(self, client_state: dict, load_lr_scheduler_states,
                     default_steps: int = 0) -> None:
        """Counters, the loss scale, the LR scheduler and the kept random
        stream from a load's client state; the step starts clean."""
        cs = client_state
        self._load_scale_state(cs)
        self.global_steps = cs.get("global_steps", default_steps)
        self.global_samples = cs.get("global_samples", 0)
        self.micro_steps = cs.get("micro_steps", 0)
        if "rng_key_data" in cs:
            self._rng_key_data = cs["rng_key_data"]
        if load_lr_scheduler_states and "lr_scheduler" in cs:
            self.lr_scheduler.load_state_dict(cs["lr_scheduler"])
        # the compute copy was cast from the old masters
        self._params_c = None
        self._pending = 0
        for g in self._grads:
            g.zero_()

    def get_fp32_state_dict(self) -> Dict[str, Any]:
        """The masters as host numpy fp32 arrays, in the model's tree (an
        offloaded leaf's from its host master; a pure-bf16 master's
        values widened)."""
        if self._multi:
            return tree_map(
                lambda t: t.to("cpu", torch.float32).numpy(),
                self._whole_tree(self._masters))
        masters = iter(self._host_master_or_none(i)
                       for i in range(len(self._masters)))

        def fp32(p):
            host = next(masters)
            if host is not None:
                return host.reshape(tuple(p.shape)).copy()
            return p.detach().to("cpu", torch.float32, copy=True).numpy()
        return tree_map(fp32, self.params)

    def _host_master_or_none(self, i: int) -> Optional[np.ndarray]:
        if not self._offloaded[i]:
            return None
        return self.offload.masters[self._host_index[i]]

    def save_16bit_model(self, save_dir: str,
                         filename: str = "model_weights.npz") -> str:
        """bf16 weights for serving, as the JAX engine writes them: an
        npz of uint16 views under the flat ``.``-joined keys, beside a
        ``.dtypes.json`` naming each ``bfloat16``, so either package
        reads the other's file."""
        from ..checkpoint.zero_to_fp32 import flatten_state_dict
        flat = flatten_state_dict(self.get_fp32_state_dict())
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, filename)
        np.savez(path, **{
            k: torch.from_numpy(v).to(torch.bfloat16).view(torch.int16)
            .numpy().view(np.uint16) for k, v in flat.items()})
        with open(path + ".dtypes.json", "w") as f:
            json.dump({k: "bfloat16" for k in flat}, f)
        logger.info("saved 16-bit model -> %s", path)
        return path

    # ------------------------------------------------------------------
    # the rest of the public API (JAX engine.py:1354-1357, :1569-1870)
    # ------------------------------------------------------------------
    def set_lr(self, lr: float) -> None:
        """A constant schedule of ``lr`` from the next update on."""
        self._schedule = lambda step: lr

    def set_gradient_accumulation_boundary(self, is_boundary) -> None:
        """Force (True) or defer (False) the update of :meth:`step` on the
        forward / backward / step path; None returns to the count."""
        self._ga_boundary = None if is_boundary is None else bool(is_boundary)

    def set_train_batch_size(self, train_batch_size: int) -> None:
        """A new global batch at the same micro-batch: gas becomes
        ``train_batch_size / micro``, which must divide."""
        micro = self.config.train_micro_batch_size_per_gpu
        shards = self.topology.batch_shard_size
        if train_batch_size % (micro * shards) != 0:
            raise ValueError(f"train_batch_size {train_batch_size} != micro "
                             f"{micro} * gas * batch shards {shards}")
        self.config.train_batch_size = train_batch_size
        self.config.gradient_accumulation_steps = (
            train_batch_size // (micro * shards))
        self.tput_timer.batch_size = train_batch_size

    def set_train_micro_batch_size(self, micro_batch_size: int) -> None:
        """A new micro-batch at the same gas."""
        self.config.train_micro_batch_size_per_gpu = micro_batch_size
        self.config.train_batch_size = (
            micro_batch_size * self.config.gradient_accumulation_steps
            * self.topology.batch_shard_size)
        self.tput_timer.batch_size = self.config.train_batch_size

    def get_batch_info(self) -> Tuple[int, int, int]:
        return (self.train_batch_size(), self.train_micro_batch_size_per_gpu(),
                self.gradient_accumulation_steps())

    def was_step_applied(self) -> bool:
        """False when the last update was skipped on an fp16 overflow."""
        return self._last_step_applied

    def train(self, mode: bool = True) -> "DeepSpeedEngine":
        """Records the intent only, as in JAX: ``train_batch`` always runs
        the training regime (and warns once under ``eval()``), ``forward``
        and ``eval_batch`` the model's loss."""
        self._train_mode = bool(mode)
        return self

    def eval(self) -> "DeepSpeedEngine":
        return self.train(False)

    def zero_grad(self) -> None:
        """Nothing, as in JAX: the accumulators are zeroed by the first
        backward of each step."""

    def compile(self, *args, **kwargs) -> "DeepSpeedEngine":
        """Returns the engine, as JAX's does (its step is jitted at
        build; this one's kernels build at their first launch)."""
        return self

    def is_compiled(self) -> bool:
        return True

    def destroy(self) -> None:
        """Frees the engine's device state (masters, accumulators, the
        optimizer's state, the step's compute copy); every later call
        raises."""
        get_flight_recorder().record("engine.destroy", engine="train",
                                     global_steps=self.global_steps)
        if self.optimizer is not None:
            self.optimizer.state.clear()
            self.optimizer.param_groups.clear()
        self.params = self._masters = self._grads = None
        self._params_c = None
        self._staging = None
        self._destroyed = True
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _check_not_destroyed(self) -> None:
        if self._destroyed:
            raise RuntimeError(
                "engine destroyed: this DeepSpeedEngine was torn down by "
                "destroy(); build a new engine with "
                "deepspeed_tpu_torch.initialize")

    def dump_state(self) -> None:
        self._check_not_destroyed()
        logger.info(
            "engine state: step=%s lr=%.3e loss_scale=%s skipped=%s "
            "zero_stage=%s device=%s", self.global_steps, self.get_lr()[0],
            self.loss_scale, self.skipped_steps, self.config.zero_stage,
            self.device)

    def module_state_dict(self) -> Dict[str, Any]:
        return self.get_fp32_state_dict()

    def save_fp16_model(self, save_dir: str,
                        filename: str = "model_weights.npz") -> str:
        """The deprecated alias of :meth:`save_16bit_model`."""
        return self.save_16bit_model(save_dir, filename)

    def comm_stats(self) -> Optional[dict]:
        """The collective scheduler's static wire plan per step (JAX
        ``comm_stats``; None without a scheduler)."""
        if self.comm_scheduler is None:
            return None
        return self.comm_scheduler.stats(self.gradient_accumulation_steps())

    # -- config accessors (JAX names and values) -------------------------
    def _zero(self, key: str):
        return self.config.zero_settings.get(key, ZERO_DEFAULTS[key])

    def zero_optimization(self) -> bool:
        return self.config.zero_stage > 0

    def zero_optimization_stage(self) -> int:
        return self.config.zero_stage

    def zero_optimization_partition_gradients(self) -> bool:
        return self.config.zero_stage >= 2

    def zero_optimization_partition_weights(self) -> bool:
        return self.config.zero_stage >= 3

    def zero_allgather_bucket_size(self) -> int:
        return self._zero("allgather_bucket_size")

    def zero_allgather_partitions(self) -> bool:
        return self._zero("allgather_partitions")

    def zero_reduce_bucket_size(self) -> int:
        return self._zero("reduce_bucket_size")

    def zero_reduce_scatter(self) -> bool:
        return self._zero("reduce_scatter")

    def zero_contiguous_gradients(self) -> bool:
        return self._zero("contiguous_gradients")

    def zero_overlap_comm(self) -> bool:
        return self._zero("overlap_comm")

    def zero_sub_group_size(self) -> int:
        return self._zero("sub_group_size")

    def zero_max_live_parameters(self) -> int:
        return self._zero("stage3_max_live_parameters")

    def zero_max_reuse_distance(self) -> int:
        return self._zero("stage3_max_reuse_distance")

    def zero_prefetch_bucket_size(self) -> int:
        return self._zero("stage3_prefetch_bucket_size")

    def zero_param_persistence_threshold(self) -> int:
        return self._zero("stage3_param_persistence_threshold")

    def zero_model_persistence_threshold(self) -> int:
        return self._zero("stage3_model_persistence_threshold")

    def zero_gather_16bit_weights_on_model_save(self) -> bool:
        return self._zero("stage3_gather_16bit_weights_on_model_save")

    def zero_round_robin_gradients(self) -> bool:
        return self._zero("round_robin_gradients")

    def zero_hpz_partition_size(self) -> int:
        return self.config.zero_hpz_partition_size

    def zero_quantized_weights(self) -> bool:
        return self.config.zero_quantized_weights

    def zero_quantized_gradients(self) -> bool:
        return self.config.zero_quantized_gradients

    def mics_shard_size(self) -> int:
        return self.config.mics_shard_size

    def fp16_enabled(self) -> bool:
        return self.config.fp16.enabled

    def bfloat16_enabled(self) -> bool:
        return self.config.bf16.enabled

    def fp16_auto_cast(self) -> bool:
        return self.config.fp16.auto_cast

    def fp16_master_weights_and_gradients(self) -> bool:
        """False, as in JAX: fp16 keeps fp32 masters."""
        return False

    def dynamic_loss_scale(self) -> bool:
        return self.config.fp16.loss_scale == 0

    def initial_dynamic_scale(self) -> float:
        return 2.0 ** self.config.fp16.initial_scale_power

    def dynamic_loss_scale_args(self) -> Dict[str, Any]:
        c = self.config.fp16
        return {"init_scale": 2.0 ** c.initial_scale_power,
                "scale_window": c.loss_scale_window,
                "delayed_shift": c.hysteresis,
                "min_scale": c.min_loss_scale}

    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def gradient_predivide_factor(self) -> float:
        return self.config.gradient_predivide_factor

    def postscale_gradients(self) -> bool:
        return not self.config.prescale_gradients

    def communication_data_type(self) -> str:
        return self.config.communication_data_type or "bfloat16"

    def sparse_gradients_enabled(self) -> bool:
        return self.config.sparse_gradients

    def steps_per_print(self) -> int:
        return self.config.steps_per_print

    def wall_clock_breakdown(self) -> bool:
        return self.config.wall_clock_breakdown

    def optimizer_name(self) -> str:
        return self.config.optimizer.type

    def optimizer_params(self):
        return self.config.optimizer.params

    def scheduler_name(self) -> Optional[str]:
        return self.config.scheduler.type if self.config.scheduler else None

    def scheduler_params(self) -> Optional[Dict[str, Any]]:
        return self.config.scheduler.params if self.config.scheduler else None

    def elasticity_enabled(self) -> bool:
        return self.config.elasticity.enabled

    def autotuning_enabled(self) -> bool:
        return self.config.autotuning.enabled

    def flops_profiler_enabled(self) -> bool:
        return self.config.flops_profiler.enabled

    def flops_profiler_profile_step(self) -> int:
        return self.config.flops_profiler.profile_step

    def aio_config(self):
        return self.config.aio

    def data_efficiency_enabled(self) -> bool:
        return self.config.data_efficiency.enabled

    def data_efficiency_config(self):
        return self.config.data_efficiency

    def data_sampling_enabled(self) -> bool:
        return bool(self.config.data_efficiency.data_sampling.get(
            "enabled", False))

    def data_sampling_config(self) -> Dict[str, Any]:
        return self.config.data_efficiency.data_sampling

    def curriculum_learning_enabled(self) -> bool:
        return bool(self.config.data_efficiency.data_sampling.get(
            "curriculum_learning", {}).get("enabled", False))

    def curriculum_learning_config(self) -> Dict[str, Any]:
        return self.config.data_efficiency.data_sampling.get(
            "curriculum_learning", {})

    def random_ltd_enabled(self) -> bool:
        return bool(self.config.data_efficiency.data_routing.get(
            "random_ltd", {}).get("enabled", False))

    def random_ltd_config(self) -> Dict[str, Any]:
        return self.config.data_efficiency.data_routing.get("random_ltd", {})

    # ------------------------------------------------------------------
    # memory and the model's config (JAX engine.py:288-345, :1662-1751)
    # ------------------------------------------------------------------
    def memory_breakdown(self) -> List[Dict[str, Any]]:
        """Per-device memory statistics (JAX ``memory_breakdown``): the
        card's ``torch.cuda.memory_stats`` and the host's peak RSS."""
        from ..utils.memory import device_memory_report
        return [{"device": str(self.device),
                 **device_memory_report(self.device)}]

    def zero_cpu_offload(self) -> bool:
        return self.config.offload_optimizer.device in ("cpu", "nvme")

    def zero_offload_param(self):
        return self.config.offload_param

    def zero_offload_optimizer(self):
        return self.config.offload_optimizer

    def zero_has_nvme_offload(self) -> bool:
        return "nvme" in (self.config.offload_optimizer.device,
                          self.config.offload_param.device)

    def _apply_model_overrides(self) -> None:
        """The ``tpu`` model keys the config set, the
        ``activation_checkpointing`` section and
        ``sequence_parallel.mode``, onto the model's
        :class:`TransformerConfig` (JAX ``_apply_model_overrides``,
        ``engine.py:288-345``).  ``partition_activations`` keeps each
        layer boundary's residual as the rank's slice of its tokens over
        ``("seq", "tensor")`` (without those axes it changes nothing)."""
        model = self.module
        from ..models.transformer import TransformerConfig
        if not isinstance(getattr(model, "cfg", None), TransformerConfig):
            return
        overrides = dict(self.config.tpu)
        ac = self.config.activation_checkpointing
        if ac.policy is not None:
            overrides["remat_policy"] = AC_POLICIES.get(ac.policy, ac.policy)
            overrides["remat"] = True
        if ac.cpu_checkpointing:
            # the active policy's saved names go to pinned host memory;
            # policies that save nothing take the attention-output variant
            base = overrides.get("remat_policy", model.cfg.remat_policy)
            if base == "everything_saveable":
                raise ValueError(
                    "cpu_checkpointing requires recomputation boundaries, "
                    "but the active remat policy saves everything "
                    "(policy='nothing' / everything_saveable).  Drop one "
                    "of the two options.")
            overrides["remat_policy"] = CPU_CHECKPOINTING.get(
                base, "offload_attn_out")
            overrides["remat"] = True
        if ac.partition_activations:
            overrides["partition_activations"] = True
        sp = self.config.sequence_parallel
        if sp.enabled and sp.mode != "ulysses":
            overrides["sp_mode"] = sp.mode
        if self.config.sparse_gradients:
            # the embedding takes the sparse backward (JAX :340-343)
            overrides["sparse_gradients"] = True
        if overrides:
            import dataclasses
            model.cfg = dataclasses.replace(model.cfg, **overrides)

