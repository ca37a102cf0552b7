"""Ragged inference model over the shared transformer blocks.

Counterpart of ``deepspeed_tpu/inference/v2/model.py``.  The JAX package
compiles one program per step key (``(S, Q, P, fresh)`` for a logits
forward, plus the step kind for a sampling, chained or speculative step)
and donates the KV cache to it.  Here each step of a key is ONE
``torch.cuda.CUDAGraph`` on the card, captured at the key's first use
(or by ``precompile_step``) over static input buffers and replayed after
the host copies each step's arrays into them; on the CPU the same key
bookkeeping runs and the step body runs eagerly (``_call`` runs it
eagerly on the card too).  The KV cache is written IN PLACE
(``write_kv``'s indexed assignment into the cache tensor), so the steps
return only tokens, logits or a verdict; a step of the model-drafted
kinds writes the draft trunk's own pool as well (``draft_spec``: both
pools, ``draft_fill``: the draft pool alone).  With ``keyed_sampling``
(fixed when the engine is built) every sampling step also takes the base
key and each row's request uid and generation position, and each
sampled row draws from its own key (``sampling.sample_keyed``) instead
of the shared generator; its graphs are captured over those inputs and
draw nothing from a generator.  Attention,
norm, embedding and unembedding come from the ``modules`` registry: on
the card the hand-written kernels (a model they do not take raises), on
the CPU or when named the plain versions.  A config with
``moe_num_experts > 0`` (Mixtral) routes each layer's mlp through the
MoE layer (``moe/layer.py``, dropless), and ``quantize_weights`` turns
the projection weights into channelwise fp8 / fp6 / fp4 / int8 leaves,
which each step dequantises as it reads them (the dequantise kernel on
the card).
"""

from __future__ import annotations

import functools
import os
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...accelerator import DeviceLike, resolve_device
from ...models import transformer as T
from ...moe.layer import MoEConfig, moe_forward
from ...telemetry import metrics as tm
from ...telemetry.watchdog import get_watchdog
from ...telemetry.workload_trace import get_workload_trace
from ...ops.fp_quantizer import SUPPORTED_FORMATS, quantize_channelwise
from ...ops.kernel_loader import CountedGraph
from ...ops.paged_attention import (KVLayer, rope_write_kv, token_positions,
                                    write_kv)
from ...tree import tree_map
from .lattice import KEY_LENGTHS
from .modules import instantiate, resolve
from .ragged import KVCacheConfig, RaggedBatch
from .ragged.batch import MIN_SLOTS, _bucket
from .sampling import derive_row_keys, greedy, sample_dynamic, sample_keyed

#: op classes resolved through the registry, in the order they run
OP_CLASSES = ("embedding", "norm", "ragged_attention",
              "fresh_prefill_attention", "unembed")

_I32, _F32 = np.dtype(np.int32), np.dtype(np.float32)
_I64 = np.dtype(np.int64)


#: NVIDIA H100 SXM, bf16 dense (the data sheet's figure at 700 W)
H100_BF16_PEAK_FLOPS = 989e12


def serving_peak_flops() -> float:
    """Peak FLOP/s denominator of the serving MFU gauges:
    ``DS_PEAK_FLOPS`` wins, else the H100's bf16 dense peak (the card
    the port is built for); the JAX package reads its device table."""
    env = os.environ.get("DS_PEAK_FLOPS", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return H100_BF16_PEAK_FLOPS


def _leaves(tree, path=()):
    """(path, tensor) of every leaf of a param tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _input_specs(key, keyed: bool = False
                 ) -> List[Tuple[Tuple[int, ...], np.dtype]]:
    """(shape, dtype) of each array a step of ``key`` takes after the
    params and the KV cache, the generator left out (it stands before
    the three sampling rows).  A keyed model's sampling steps take the
    base key [2] and the rows' uids and positions just before the three
    sampling rows."""
    S, Q, P = key[:3]
    kind = _kind(key)
    batch = [((S, Q), _I32), ((S,), _I32), ((S,), _I32), ((S, P), _I32)]
    if kind in ("logits", "draft_fill"):
        return batch

    def rows(n):
        extra = ([((2,), _I64), ((n,), _I32), ((n,), _I32)] if keyed
                 else [])
        return extra + [((n,), _F32), ((n,), _I32), ((n,), _F32)]

    if kind in ("sample", "spec", "draft_spec"):
        return batch + rows(S)
    if kind == "chain":  # prev tokens and the gather replace token ids
        return [((key[5],), _I32), ((S,), _I32)] + batch[1:] + rows(S)
    if kind == "mixed":
        S_p, Q_p, P_p = key[5:8]
        pre = [((S_p, Q_p), _I32), ((S_p,), _I32), ((S_p,), _I32),
               ((S_p, P_p), _I32)]
        return batch + pre + rows(S + S_p)
    raise ValueError(f"no step graph for step key {key}")


def _kind(key) -> str:
    """A key's step kind: a bare ``(S, Q, P, fresh)`` is a logits
    forward."""
    return key[4] if len(key) > 4 else "logits"


def _stochastic(key) -> bool:
    # every sampling kind ends with greedy_only; a logits or draft_fill
    # step draws nothing
    return len(key) > 4 and key[-1] is False


def _stores(kv) -> tuple:
    """The KV stores a step writes: one, or the (target, draft) pair of
    a draft_spec step."""
    return kv if isinstance(kv, tuple) else (kv,)


class _StepGraph:
    """One step key on the card: static input tensors (outside the graph
    pool), the counted graph captured over them, and the KV store(s) it
    writes (the draft_spec kind writes two).  ``run`` copies a step's
    arrays into the inputs and replays; the tokens come back as a fresh
    tensor outside the pool, so a later replay of another key (whose
    intermediates may share the pool's memory) cannot overwrite them (a
    draft_fill step returns nothing).  It holds no reference to its model
    (the model's step cache holds it), so a dropped model frees its
    graphs and their pool at once."""

    def __init__(self, key, kv: KVLayer, device: torch.device,
                 shared: tuple, keyed: bool = False):
        self.kv = kv
        # a keyed step draws from its row keys, never from the generator
        self.stochastic = _stochastic(key) and not keyed
        self.inputs = [torch.zeros(shape, dtype=getattr(torch, dt.name),
                                   device=device)
                       for shape, dt in _input_specs(key, keyed)]
        pool, stream, self.generator = shared
        self.graph = CountedGraph(
            pool, self.generator if self.stochastic else None, stream)

    def load(self, inputs: Sequence) -> None:
        for dst, src in zip(self.inputs, inputs):
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(src)
            dst.copy_(src, non_blocking=True)

    def capture(self, body: Callable) -> None:
        """Capture ``body(kv, generator, *inputs)``, the key's step."""
        self.graph.capture(body, self.kv, self.generator, *self.inputs)

    def run(self, kv, generator: torch.Generator,
            inputs: Sequence) -> Optional[torch.Tensor]:
        ours, theirs = _stores(self.kv), _stores(kv)
        if len(ours) != len(theirs) or any(
                a is not b for a, b in zip(ours, theirs)):
            raise RuntimeError("this step graph was captured over another "
                               "KV cache")
        self.load(inputs)
        if self.stochastic:
            # the graph draws from the model's registered generator: start
            # it at the caller's state and hand the advance back
            self.generator.manual_seed(generator.initial_seed())
            self.generator.set_offset(generator.get_offset())
            self.graph.replay()
            generator.set_offset(self.generator.get_offset())
        else:
            self.graph.replay()
        out = self.graph.output
        return None if out is None else out.clone()


def quantize_layer_weights(layer: Dict[str, Any], fmt: str,
                           batch_dims: int = 0) -> Dict[str, Any]:
    """One layer's sub-tree (with ``batch_dims`` leading dims: 1 for a
    scan-stacked tree) with its ``attn`` and ``mlp`` ``w*`` matrices
    quantised channelwise into ``fmt`` (JAX ``quantize_weights``'
    ``q_block``): attention with scales per layer, the mlp with every
    dim before its ``[in, out]`` matrix kept (``per_leaf``: one expert's
    outlier must not coarsen the others).  Other leaves, and leaves
    already quantised, are returned as they are."""
    def q_block(block, per_leaf=False):
        out = {}
        for k, v in block.items():
            if (k.startswith("w") and isinstance(v, torch.Tensor)
                    and v.dim() >= 2 + batch_dims):
                bd = v.dim() - 2 if per_leaf else batch_dims
                out[k] = quantize_channelwise(v, fmt, batch_dims=bd)
            else:
                out[k] = v
        return out

    return dict(layer, attn=q_block(layer["attn"]),
                mlp=q_block(layer["mlp"], per_leaf=True))


class RaggedInferenceModel:
    """Ragged step over (params, kv cache, batch arrays), one CUDA graph
    per step key on the card.

    ``device`` None means the GPU and raises without one; the tests pass
    ``"cpu"``.  ``implementations`` pins an op class to a named
    implementation (e.g. ``{"ragged_attention": "dense_gather"}``);
    unnamed classes take the registry's highest-priority implementation
    that supports this model and device, and on the card never a plain
    version in a kernel's place (``NotImplementedError``).
    ``strict_shapes`` (set by ``InferenceEngineV2.precompile(strict=True)``)
    makes a step key outside the precompiled set raise instead of
    capturing on the request path."""

    def __init__(self, cfg: T.TransformerConfig, params: Dict[str, Any],
                 kv_config: Optional[KVCacheConfig] = None,
                 device: DeviceLike = None,
                 implementations: Optional[Dict[str, str]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        #: the routed MoE mlp of every layer (mixtral), None for the dense
        #: block; drop_tokens=False: serving must not drop capacity-overflow
        #: tokens
        self.moe_cfg: Optional[MoEConfig] = (
            MoEConfig(num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
                      activation=cfg.activation, drop_tokens=False)
            if cfg.moe_num_experts > 0 else None)
        #: the weight-only format ``quantize_weights`` applied (None: none)
        self.quantized_fmt: Optional[str] = None
        names = dict(implementations or {})
        unknown = set(names) - set(OP_CLASSES)
        if unknown:
            raise KeyError(f"unknown op classes {sorted(unknown)}")
        #: op class -> implementation name actually used (None: the op
        #: class has no implementation for this model, e.g. fresh
        #: prefill under ALiBi)
        self.implementations: Dict[str, Optional[str]] = {}
        for op in OP_CLASSES:
            try:
                self.implementations[op] = resolve(op, cfg, self.device,
                                                   names.get(op))
            except ValueError:
                if op != "fresh_prefill_attention" or op in names:
                    raise
                self.implementations[op] = None
        impl = {op: (instantiate(op, cfg, self.device, n)
                     if n is not None else None)
                for op, n in self.implementations.items()}
        self._embed = impl["embedding"]
        self._norm = impl["norm"]
        self._attention = impl["ragged_attention"]
        self._fresh_attention = impl["fresh_prefill_attention"]
        self._unembed = impl["unembed"]
        #: the caller fixed the cache geometry; otherwise the engine's
        #: ``kv_cache`` config sets it (and may size it from free memory)
        self.kv_config_explicit = kv_config is not None
        self.kv_config = kv_config or KVCacheConfig(
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.dims_per_head, dtype=cfg.dtype)
        self.strict_shapes = False
        #: step key -> its captured graph (None on the CPU, where the
        #: body runs eagerly): the keys this model can dispatch without
        #: a capture
        self._step_cache: Dict[tuple, Optional[_StepGraph]] = {}
        #: every key traffic dispatched, and how often
        self.dispatch_counts: Counter = Counter()
        #: host seconds spent capturing graphs (warm-up run included)
        self.capture_seconds = 0.0
        #: (pool, capture stream, generator) every graph shares
        self._graph_shared: Optional[tuple] = None
        #: the draft trunk of model-drafted speculation, set by the engine
        #: at build: the same family at ``spec_draft_layers`` layers, its
        #: params the target's own tensors (None: no draft trunk)
        self.draft_cfg: Optional[T.TransformerConfig] = None
        self.draft_params: Optional[Dict[str, Any]] = None
        #: keyed sampling, set by the engine at build before any capture:
        #: it adds the (base key, uids, positions) inputs to every
        #: sampling step
        self.keyed_sampling = False
        #: the mined bucket lattice (``lattice.BucketLattice``), set by
        #: the engine at build from ``serving.lattice``: the mixed step
        #: pads its token vector to its S tops (None: powers of two)
        self.lattice = None
        #: step keys added to the step cache by ``precompile_step`` and
        #: on the request path (a first dispatch: on the card a graph
        #: capture, which the workload trace records as a compile)
        self.precompile_captures = 0
        self.path_captures = 0
        # the dispatched steps' cost: an analytic estimate per key (the
        # JAX package reads XLA's cost analysis of each executable) and
        # the dispatched rows' work behind the rate gauges
        self._program_costs: Dict[tuple, Dict[str, float]] = {}
        self._flops_dispatched = 0.0
        self._bytes_dispatched = 0.0
        self._cost_t0: Optional[float] = None
        self._cost_gauges_bound = False
        self._weight_numel, self._weight_bytes = self._count_weights()

    # -- weight-only quantization --------------------------------------------
    def quantize_weights(self, fmt: str = "fp8_e4m3") -> None:
        """Quantize the per-layer projection weights channelwise into
        ``fmt`` storage (JAX ``model.py:210-262``; reference inference v2
        core_ops quantized GEMM): the ``w*`` leaves of each layer's
        ``attn`` and ``mlp`` (:func:`quantize_layer_weights`).  Norms,
        biases, the router ``gate``, embeddings and the lm head stay at
        full precision; leaves already quantised pass through.

        Rewrites ``self.params``; the same ``fmt`` again is a no-op,
        another raises, and an unknown one raises before anything
        changes.  Every captured step graph and the step cache are
        dropped: a graph captured over the full-precision leaves would
        replay against freed memory."""
        if fmt not in SUPPORTED_FORMATS:
            raise ValueError(f"unknown quantization format {fmt!r} "
                             f"(supported: {sorted(SUPPORTED_FORMATS)})")
        if self.quantized_fmt is not None:
            if self.quantized_fmt != fmt:
                raise ValueError(
                    f"model already quantized as {self.quantized_fmt!r}; "
                    f"cannot re-quantize as {fmt!r}")
            return
        layers = self.params["layers"]
        if self.cfg.scan_layers:        # the leading layers dim: per-layer
            layers = quantize_layer_weights(layers, fmt, batch_dims=1)
        else:
            layers = {k: quantize_layer_weights(lp, fmt, batch_dims=0)
                      for k, lp in layers.items()}
        self.params = dict(self.params, layers=layers)
        self.quantized_fmt = fmt
        self._step_cache.clear()
        self._program_costs.clear()
        self._weight_numel, self._weight_bytes = self._count_weights()

    # -- public steps --------------------------------------------------------
    def forward(self, batch: RaggedBatch, kv: KVLayer) -> torch.Tensor:
        """One ragged forward keyed ``(S, Q, P, fresh)``; returns fp32
        logits [S, V] (rows past the live sequences are padding).  ``kv``
        is updated in place."""
        return self._dispatch(self._normalize_key(batch.shape_key), kv,
                              None, self._batch_arrays(batch))

    @staticmethod
    def _batch_arrays(batch: RaggedBatch) -> tuple:
        return (batch.token_ids, batch.q_lens, batch.start_pos,
                batch.page_table)

    @staticmethod
    def _sample_arrays(temps, top_ks, top_ps) -> tuple:
        return (np.asarray(temps, np.float32), np.asarray(top_ks, np.int32),
                np.asarray(top_ps, np.float32))

    def _keyed_args(self, rng, row_uids, row_pos) -> tuple:
        """The keyed inputs that stand before the sampling rows: (base
        key, uids, positions) on a keyed model, none otherwise.  Rows
        nobody reads (padding, mid-prefill) may carry anything."""
        if not self.keyed_sampling:
            return ()
        if row_uids is None or row_pos is None:
            raise ValueError(
                "a keyed_sampling model needs row_uids and row_pos for "
                "every sampling step")
        base = (rng if isinstance(rng, torch.Tensor)
                else np.asarray(rng, np.int64))
        return (base, np.asarray(row_uids, np.int32),
                np.asarray(row_pos, np.int32))

    def _sample_inputs(self, rng, temps, top_ks, top_ps, row_uids,
                       row_pos) -> tuple:
        return (self._keyed_args(rng, row_uids, row_pos)
                + self._sample_arrays(temps, top_ks, top_ps))

    def _generator(self, rng) -> Optional[torch.Generator]:
        """The generator a step draws from: none on a keyed model (its
        base key is an input)."""
        return None if self.keyed_sampling else rng

    def sample_step(self, batch: RaggedBatch, kv: KVLayer, rng, temps,
                    top_ks, top_ps, greedy_only: bool, row_uids=None,
                    row_pos=None) -> torch.Tensor:
        """Forward + on-device sampling: returns tokens [S] int32 on the
        device (the [S, V] logits never leave it).  ``greedy_only`` is
        part of the key: an all-greedy step is plain argmax and never
        touches the generator.  ``rng`` is the generator, or on a keyed
        model the base key (int64 [2]) with each row's uid and
        generation position in ``row_uids`` / ``row_pos``."""
        key = self._normalize_key(batch.shape_key) + (
            "sample", bool(greedy_only))
        return self._dispatch(key, kv, self._generator(rng),
                              self._batch_arrays(batch)
                              + self._sample_inputs(rng, temps, top_ks,
                                                    top_ps, row_uids,
                                                    row_pos))

    def sample_step_mixed(self, dec_batch: RaggedBatch,
                          pre_batch: RaggedBatch, kv: KVLayer, rng, temps,
                          top_ks, top_ps, greedy_only: bool, row_uids=None,
                          row_pos=None) -> torch.Tensor:
        """Mixed SplitFuse step over TWO batch geometries: a decode
        segment [S_d, 1] and a prefill segment [S_p, Q], the KV cache
        written by the first before the second reads it.  Tokens come
        back as [S_d + S_p] (padded to the slot bucket) in segment
        order; the sampling arrays follow that order.  Keyed on both
        geometries and ``greedy_only``."""
        dk = self._normalize_key(dec_batch.shape_key)
        pk = self._normalize_key(pre_batch.shape_key)
        if dk[1] != 1:
            raise ValueError("segment A of a mixed step is decode-only")
        key = dk + ("mixed",) + pk + (bool(greedy_only),)
        return self._dispatch(key, kv, self._generator(rng),
                              self._batch_arrays(dec_batch)
                              + self._batch_arrays(pre_batch)
                              + self._sample_inputs(rng, temps, top_ks,
                                                    top_ps, row_uids,
                                                    row_pos))

    def chained_step(self, batch: RaggedBatch, kv: KVLayer,
                     prev_tokens: torch.Tensor, gather_idx, rng, temps,
                     top_ks, top_ps, greedy_only: bool, row_uids=None,
                     row_pos=None) -> torch.Tensor:
        """Decode step whose token ids are gathered ON THE DEVICE from
        the previous step's token array (``prev_tokens``, possibly still
        being computed): row i continues the sequence in row
        ``gather_idx[i]`` of the previous step.  No host sync on this
        path.  Keyed on the previous token array's length."""
        S, Q, P, _ = self._normalize_key(batch.shape_key)
        if Q != 1:
            raise ValueError("chained steps are decode-only")
        key = (S, 1, P, False, "chain", int(prev_tokens.shape[0]),
               bool(greedy_only))
        return self._dispatch(
            key, kv, self._generator(rng),
            (prev_tokens, np.asarray(gather_idx, np.int32))
            + self._batch_arrays(batch)[1:]
            + self._sample_inputs(rng, temps, top_ks, top_ps, row_uids,
                                  row_pos))

    def spec_step(self, batch: RaggedBatch, kv: KVLayer, rng, temps,
                  top_ks, top_ps, greedy_only: bool, row_uids=None,
                  row_pos=None) -> torch.Tensor:
        """Speculative verify: row s carries ``[last_committed, d_1..d_k]``
        (``q_lens[s] = 1 + k``, k may be 0) and one step runs the forward
        over every position and returns [S, 2] int32 on the device:
        (accepted drafts, the corrected or bonus token).  Keyed
        ``(S, Q, P, False, "spec", greedy_only)``.  On a keyed model
        position j of row s draws from generation index ``row_pos[s] +
        j``, so a committed block equals the same tokens drawn one step
        at a time."""
        key = self._normalize_key(batch.shape_key)[:3] + (
            False, "spec", bool(greedy_only))
        return self._dispatch(key, kv, self._generator(rng),
                              self._batch_arrays(batch)
                              + self._sample_inputs(rng, temps, top_ks,
                                                    top_ps, row_uids,
                                                    row_pos))

    def draft_spec_step(self, batch: RaggedBatch, kv_pair: tuple, rng,
                        temps, top_ks, top_ps, greedy_only: bool,
                        row_uids=None, row_pos=None) -> torch.Tensor:
        """Model-drafted speculative step: the draft trunk drafts k = Q-1
        greedy tokens over the draft pool (Q iterations of a Q=1
        forward) and the target verifies them, in one step.  The host
        gives each row's last committed token (``token_ids[:, 0]``; the
        rest of the row is ignored) and ``kv_pair`` = (target pool,
        draft pool).  Returns [S, 2+k] int32 on the device: accepted
        count, corrected token, then the k drafts."""
        key = self._normalize_key(batch.shape_key)[:3] + (
            False, "draft_spec", bool(greedy_only))
        return self._dispatch(key, tuple(kv_pair), self._generator(rng),
                              self._batch_arrays(batch)
                              + self._sample_inputs(rng, temps, top_ks,
                                                    top_ps, row_uids,
                                                    row_pos))

    def draft_fill_step(self, batch: RaggedBatch, draft_kv) -> None:
        """The draft pool's catch-up over committed history (prefill,
        decode steps that did not draft, prefix hits): one draft-trunk
        forward that writes the draft pool and returns nothing."""
        key = self._normalize_key(batch.shape_key)[:3] + (
            False, "draft_fill")
        self._dispatch(key, draft_kv, None, self._batch_arrays(batch))

    # -- step keys and graphs (JAX: _get_step, precompile_step) -------------
    def _normalize_key(self, key) -> tuple:
        """A model without a fresh-prefill path (ALiBi) ignores the fresh
        flag: key it as the False variant."""
        if self._fresh_attention is None and len(key) > 3 and key[3]:
            key = key[:3] + (False,) + tuple(key[4:])
        return tuple(key)

    def check_key(self, key) -> tuple:
        """``key`` (any sequence) as a normalised step key; ValueError
        when it is none this model forms: a wrong length or field, or a
        draft kind on a model without a draft trunk."""
        key = tuple(key)
        kind = _kind(key) if len(key) >= 4 else None
        if kind is None or len(key) != KEY_LENGTHS.get(str(kind)):
            raise ValueError(f"not a step key of this model: {key!r}")
        if kind in ("draft_spec", "draft_fill") and self.draft_cfg is None:
            raise ValueError(f"step key {key!r} needs the draft trunk, and "
                             "this model has none (spec_drafter model or "
                             "auto builds it)")
        dims = key[:3] + (key[5:8] if kind == "mixed" else ())
        flags = (key[3],) + ((key[8],) if kind == "mixed" else ()) + (
            (key[-1],) if kind not in ("logits", "draft_fill") else ())
        if kind == "chain":
            dims += (key[5],)
        if not all(isinstance(d, (int, np.integer))
                   and not isinstance(d, bool) and d > 0 for d in dims) \
                or not all(isinstance(f, bool) for f in flags):
            raise ValueError(f"not a step key of this model: {key!r}")
        return self._normalize_key(key)

    def _call(self, key, kv, generator, *inputs) -> Optional[torch.Tensor]:
        """The step body of ``key`` over tensors (eager)."""
        kind = _kind(key)
        if kind == "logits":
            with torch.no_grad():
                return self._step_impl(self.params, kv, *inputs,
                                       fresh=key[3])
        if kind == "draft_fill":
            with torch.no_grad():
                return self._draft_fill_step_impl(self.draft_params, kv,
                                                  *inputs)
        params = self.params
        if kind == "sample":
            fn = functools.partial(self._sample_step_impl, fresh=key[3],
                                   greedy_only=key[5])
        elif kind == "chain":
            fn = functools.partial(self._chained_step_impl,
                                   greedy_only=key[6])
        elif kind == "mixed":
            fn = functools.partial(self._mixed_sample_step_impl,
                                   fresh_p=key[8], greedy_only=key[9])
        elif kind == "spec":
            fn = functools.partial(self._spec_step_impl, greedy_only=key[5])
        elif kind == "draft_spec":
            fn = functools.partial(self._draft_spec_step_impl,
                                   greedy_only=key[5])
            params = {"target": self.params, "draft": self.draft_params}
        else:
            raise ValueError(f"unknown step kind in key {key}")
        with torch.no_grad():
            if self.keyed_sampling:
                # [..., base, uids, pos, temps, top_ks, top_ps]
                base, uids, pos = inputs[-6:-3]
                return fn(params, kv, *inputs[:-6], base, *inputs[-3:],
                          uids, pos)
            return fn(params, kv, *inputs[:-3], generator, *inputs[-3:])

    def _graph_resources(self) -> tuple:
        """(pool, capture stream, generator) that every graph of this
        model shares, made at the first capture: one memory pool, so 32
        layers' intermediates are not held once per key; one capture
        stream, as cuBLAS keeps a workspace for each stream it has run
        on; one generator that the stochastic graphs register, started
        at the caller's generator state at each replay
        (``_StepGraph.run``)."""
        if self._graph_shared is None:
            self._graph_shared = (torch.cuda.graph_pool_handle(),
                                  torch.cuda.Stream(device=self.device),
                                  torch.Generator(device=self.device))
        return self._graph_shared

    def _new_step(self, key, kv: KVLayer, inputs=None):
        """The step cache entry of a key first seen: on the card a graph
        captured over ``inputs`` (the first step's arrays; zeros when
        precompiling), on the CPU None."""
        if self.device.type == "cpu":
            return None
        t = time.perf_counter()
        graph = _StepGraph(key, kv, self.device, self._graph_resources(),
                           self.keyed_sampling)
        if inputs is not None:
            graph.load(inputs)
        graph.capture(functools.partial(self._call, key))
        self.capture_seconds += time.perf_counter() - t
        return graph

    def _dispatch(self, key, kv, generator: Optional[torch.Generator],
                  inputs: Sequence) -> Optional[torch.Tensor]:
        """Run one step of ``key`` (JAX: ``_get_step`` and the call of
        what it returns): replay its graph (captured here at the key's
        first use, which counts in ``path_captures`` and goes to the
        workload trace as a compile), or on the CPU its body eagerly.
        Every dispatch feeds the trace's key counts."""
        graph = self._step_cache.get(key, False)
        wt = get_workload_trace()
        if graph is False:
            if self.strict_shapes:
                get_watchdog().note_step_cache(hit=False, key=key)
                raise RuntimeError(
                    f"batch bucket {key} (S, Q, P, fresh[, kind, ...]) was "
                    "not precompiled: serving would capture its CUDA graph "
                    "on the request path.  Widen InferenceEngineV2."
                    "precompile(...) (sampling=True covers the sample and "
                    "chain steps) or disable strict_shapes.")
            self.path_captures += 1
            # a capture on the request path: a miss with its key (the
            # watchdog also sends the key to the workload trace and warns
            # on a storm of them)
            get_watchdog().note_step_cache(hit=False, key=key,
                                           compiled_on_path=True)
            graph = self._step_cache[key] = self._new_step(key, kv, inputs)
        else:
            get_watchdog().note_step_cache(hit=True)
        self.dispatch_counts[key] += 1
        if wt.active:
            wt.note_step_key(key)
        self._account_cost(key, inputs)
        if graph is None:
            return self._call(key, kv, generator, *(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                if isinstance(a, np.ndarray) else a for a in inputs))
        return graph.run(kv, generator, inputs)

    def precompile_step(self, key: tuple, kv) -> None:
        """Capture one step key's graph before serving (JAX: AOT-compile
        it).  ``kv`` is the store(s) the key's kind writes: the target
        pool, the draft pool (draft_fill) or the (target, draft) pair
        (draft_spec)."""
        key = self.check_key(key)
        if key not in self._step_cache:
            self.precompile_captures += 1
            self._step_cache[key] = self._new_step(key, kv)

    # -- the dispatched steps' cost -------------------------------------------
    def _count_weights(self) -> Tuple[int, int]:
        """(weights a token multiplies, bytes of all weights): every
        tensor but the embedding table, whose rows are gathered, unless
        the lm head is that table."""
        numel = nbytes = 0
        for name, t in _leaves(self.params):
            nbytes += t.numel() * t.element_size()
            if name != ("embed", "tokens") or self.cfg.tie_embeddings:
                numel += t.numel()
        return numel, nbytes

    def _program_cost(self, key) -> Dict[str, float]:
        """Analytic FLOPs and bytes of the program ``key`` captures, at
        its padded shapes (the per-key table; the JAX package reads
        XLA's cost analysis of the executable): 2 FLOPs per weight per
        row, plus QK^T and PV over the key's padded context (4·L·H·D per
        row and context token); the bytes read every weight once and the
        K and V of every page the key addresses.  A bound on one
        dispatch, not what it does: the rate gauges count
        ``_dispatched_cost``."""
        cost = self._program_costs.get(key)
        if cost is not None:
            return cost
        cfg, kv = self.cfg, self.kv_config
        kind = _kind(key)
        S, Q, P = int(key[0]), int(key[1]), int(key[2])
        if kind == "mixed":
            segs = [(S, 1, P), (int(key[5]), int(key[6]), int(key[7]))]
        else:
            segs = [(S, Q, P)]
        L = (self.draft_cfg.num_layers if kind == "draft_fill"
             and self.draft_cfg is not None else cfg.num_layers)
        scale = L / cfg.num_layers
        hd = cfg.num_heads * cfg.dims_per_head
        kv_token = kv.bytes_per_page / kv.page_size * scale
        flops = nbytes = 0.0
        for s, q, p in segs:
            rows, ctx = s * q, p * kv.page_size
            flops += (2.0 * self._weight_numel * scale * rows
                      + 4.0 * L * hd * rows * ctx)
            nbytes += s * ctx * kv_token
        nbytes += self._weight_bytes * scale
        cost = self._program_costs[key] = {"flops": flops, "bytes": nbytes}
        return cost

    def _dispatched_cost(self, key, inputs) -> Tuple[float, float]:
        """(FLOPs, bytes) of the work one dispatch of ``key`` does on
        ``inputs``: each live row's new tokens through every weight, QK^T
        and PV over each new token's causal (windowed) context, every
        weight read once and the K and V of each live row's context.
        Padding rows and pages past a row's context cost nothing, so the
        rates over wall time stay below the card's peaks.  The draft
        trunk of a ``draft_spec`` step is not counted."""
        cfg = self.cfg
        kind = _kind(key)
        if kind == "chain":       # (prev_tokens, gather_idx, q_lens, ...)
            segs = [inputs[2:4]]
        elif kind == "mixed":     # two (token_ids, q_lens, start_pos, table)
            segs = [inputs[1:3], inputs[5:7]]
        else:
            segs = [inputs[1:3]]
        L = (self.draft_cfg.num_layers if kind == "draft_fill"
             and self.draft_cfg is not None else cfg.num_layers)
        scale = L / cfg.num_layers
        hd = cfg.num_heads * cfg.dims_per_head
        kv = self.kv_config
        kv_token = kv.bytes_per_page / kv.page_size * scale
        tokens = attended = context = 0
        for q_lens, start_pos in segs:
            q = np.asarray(q_lens, np.int64)
            h = np.asarray(start_pos, np.int64)[q > 0]
            q = q[q > 0]
            tokens += int(q.sum())
            context += int((h + q).sum())
            if cfg.sliding_window is None:
                attended += int((q * h + q * (q + 1) // 2).sum())
            else:
                pos = h[:, None] + np.arange(1, int(q.max(initial=0)) + 1)
                attended += int(np.where(
                    np.arange(pos.shape[1]) < q[:, None],
                    np.minimum(pos, cfg.sliding_window), 0).sum())
        flops = (2.0 * self._weight_numel * scale * tokens
                 + 4.0 * L * hd * attended)
        return flops, self._weight_bytes * scale + context * kv_token

    def _account_cost(self, key, inputs) -> None:
        cost = self._program_cost(key)
        if self._cost_t0 is None:
            self._cost_t0 = time.perf_counter()
        flops, nbytes = self._dispatched_cost(key, inputs)
        self._flops_dispatched += flops
        self._bytes_dispatched += nbytes
        tm.FASTGEN_PROGRAM_FLOPS.set(cost["flops"])
        tm.FASTGEN_PROGRAM_BYTES.set(cost["bytes"])
        if not self._cost_gauges_bound:
            self._bind_cost_gauges()

    def _bind_cost_gauges(self) -> None:
        """Bind the rate gauges once costs exist: the window opens at the
        first dispatch (``reset_cost_window`` opens it again).  Through a
        weakref, so the registry keeps no discarded model alive."""
        self._cost_gauges_bound = True
        ref = weakref.ref(self)
        peak = serving_peak_flops()

        def rate(attr, scale=1.0):
            def _read(r=ref, a=attr, s=scale):
                m = r()
                if m is None or m._cost_t0 is None:
                    return 0.0
                wall = max(time.perf_counter() - m._cost_t0, 1e-9)
                return getattr(m, a) / wall / s
            return _read

        tm.FASTGEN_MFU.bind(rate("_flops_dispatched", peak))
        tm.FASTGEN_BYTES_PER_S.bind(rate("_bytes_dispatched"))
        # one shard (tp_degree 1): the per-shard pair reads the same
        tm.FASTGEN_SHARD_MFU.bind(rate("_flops_dispatched", peak))
        tm.FASTGEN_SHARD_BYTES_PER_S.bind(rate("_bytes_dispatched"))

    def reset_cost_window(self) -> None:
        """Open the MFU / bytes-per-s window again (the per-key table
        stays)."""
        self._flops_dispatched = 0.0
        self._bytes_dispatched = 0.0
        self._cost_t0 = None

    def cost_summary(self) -> Dict[str, Any]:
        """Per-key cost table and the window's totals and rates (the JAX
        model's ``cost_summary`` layout)."""
        wall = (max(time.perf_counter() - self._cost_t0, 1e-9)
                if self._cost_t0 is not None else 0.0)
        peak = serving_peak_flops()
        return {
            "programs": {repr(k): dict(v)
                         for k, v in self._program_costs.items()},
            "flops_dispatched": self._flops_dispatched,
            "bytes_dispatched": self._bytes_dispatched,
            "window_s": wall,
            "peak_flops": peak,
            "mfu": self._flops_dispatched / wall / peak if wall else 0.0,
            "bytes_per_s": self._bytes_dispatched / wall if wall else 0.0,
        }

    def reset_steps(self) -> None:
        """Drop every captured graph and the key bookkeeping (the model
        now serves another KV cache)."""
        self._step_cache.clear()
        self.dispatch_counts.clear()
        self.strict_shapes = False
        self.precompile_captures = self.path_captures = 0

    def _lm_head(self, params) -> torch.Tensor:
        cfg = self.cfg
        return (params["embed"]["tokens"].to(cfg.dtype).T
                if cfg.tie_embeddings
                else params["lm_head"].to(cfg.dtype))

    # -- step bodies (JAX: the traced step kinds) ---------------------------
    def _forward_hidden(self, params, kv, token_ids, q_lens, start_pos,
                        page_table, fresh: bool = False, cfg=None):
        """Embed -> layers -> final norm.  Returns x [S, Q, E]; ``kv``
        [L, pages+1, page, 2, K, D] (a tensor or ``KVPages``) is written
        in place.  ``cfg`` runs another trunk of the family (the draft
        trunk, fewer layers); None is the target."""
        cfg = cfg if cfg is not None else self.cfg
        S, Q = token_ids.shape
        x = self._embed(params["embed"]["tokens"].to(cfg.dtype), token_ids)
        pos = token_positions(start_pos, Q)
        if cfg.pos_emb == "learned":
            safe = torch.clamp(pos, max=cfg.max_seq_len - 1)
            x = x + params["embed"]["positions"].to(cfg.dtype)[safe]
        if cfg.embed_layernorm:  # BLOOM word_embeddings_layernorm
            x = self._norm(params["embed"]["norm"], x)
        sin, cos = (T.rope_table(cfg, pos) if cfg.pos_emb == "rope"
                    else (None, None))
        for i in range(cfg.num_layers):
            x = self._layer_body(x, T.layer_params(cfg, params, i), kv[i],
                                 sin=sin, cos=cos, q_lens=q_lens,
                                 start_pos=start_pos, page_table=page_table,
                                 fresh=fresh, cfg=cfg)
        return self._norm(params["final_norm"], x)

    def _step_impl(self, params, kv, token_ids, q_lens, start_pos,
                   page_table, fresh: bool = False) -> torch.Tensor:
        x = self._forward_hidden(params, kv, token_ids, q_lens, start_pos,
                                 page_table, fresh=fresh)
        logits = self._unembed(x, q_lens, self._lm_head(params))  # [S, V]
        bias = params.get("lm_head_bias")  # the phi family ships one
        if bias is not None:
            logits = logits + bias.to(self.cfg.dtype)
        return logits.float()

    def _assemble_logits(self, x2d, lm_head, bias=None) -> torch.Tensor:
        """[N, E] hidden rows -> [N, V] fp32 logits (the bias, when the
        family ships one, added in the compute dtype)."""
        logits = x2d @ lm_head
        if bias is not None:
            logits = logits + bias.to(self.cfg.dtype)
        return logits.float()

    def _sample_tokens(self, logits, rng, temps, top_ks, top_ps, row_uids,
                       row_pos, greedy_only: bool) -> torch.Tensor:
        """The sampling every sampling step kind shares: the argmax of a
        greedy-only key, one draw per row from its own key on a keyed
        model (``rng`` the base key), else ``sample_dynamic`` from the
        generator ``rng``."""
        if greedy_only:
            return greedy(logits)
        if row_uids is not None:
            keys = derive_row_keys(rng, row_uids, row_pos)
            return sample_keyed(logits, keys, temps, top_ks, top_ps)
        return sample_dynamic(logits, rng, temps, top_ks, top_ps)

    def _sample_step_impl(self, params, kv, token_ids, q_lens, start_pos,
                          page_table, rng, temps, top_ks, top_ps,
                          row_uids=None, row_pos=None, fresh: bool = False,
                          greedy_only: bool = False):
        logits = self._step_impl(params, kv, token_ids, q_lens, start_pos,
                                 page_table, fresh=fresh)
        return self._sample_tokens(logits, rng, temps, top_ks, top_ps,
                                   row_uids, row_pos, greedy_only)

    def _chained_step_impl(self, params, kv, prev_tokens, gather_idx,
                           q_lens, start_pos, page_table, rng, temps,
                           top_ks, top_ps, row_uids=None, row_pos=None,
                           greedy_only: bool = False):
        """Decode step whose token ids are gathered on the device from
        the previous step's tokens (the row mapping is host-known)."""
        token_ids = prev_tokens[gather_idx.long()][:, None]       # [S, 1]
        return self._sample_step_impl(params, kv, token_ids, q_lens,
                                      start_pos, page_table, rng, temps,
                                      top_ks, top_ps, row_uids, row_pos,
                                      fresh=False, greedy_only=greedy_only)

    def _spec_step_impl(self, params, kv, token_ids, q_lens, start_pos,
                        page_table, rng, temps, top_ks, top_ps,
                        row_uids=None, row_pos=None,
                        greedy_only: bool = False) -> torch.Tensor:
        """Verify drafted tokens.  Row layout ``token_ids[s] =
        [last_committed, d_1..d_k, pad...]``, ``q_lens[s] = 1 + k``.  The
        forward writes KV for every valid position (a rejected draft's
        slots are written again by the next step before any step reads
        them) and emits the model's own token at EVERY position: the
        argmax, or the row's draw with its parameters (keyed: position j
        draws from generation index ``row_pos + j``).
        Per row the accepted count is the leading run of drafts equal to
        the emission one position earlier, and the corrected (or bonus)
        token is the emission at that count.  Returns [S, 2] int32."""
        x = self._forward_hidden(params, kv, token_ids, q_lens, start_pos,
                                 page_table)
        S, Q, E = x.shape
        logits = self._assemble_logits(x.reshape(S * Q, E),
                                       self._lm_head(params),
                                       params.get("lm_head_bias"))
        sq_uids = sq_pos = None
        if row_uids is not None and not greedy_only:
            sq_uids = row_uids.repeat_interleave(Q)
            sq_pos = (row_pos[:, None] + torch.arange(
                Q, dtype=row_pos.dtype, device=x.device)[None, :]).reshape(-1)
        emitted = self._sample_tokens(
            logits, rng, temps.repeat_interleave(Q),
            top_ks.repeat_interleave(Q), top_ps.repeat_interleave(Q),
            sq_uids, sq_pos, greedy_only).reshape(S, Q)
        col = torch.arange(Q - 1, device=x.device)[None, :]
        ok = (emitted[:, :-1] == token_ids[:, 1:]) \
            & (col < (q_lens - 1)[:, None])
        accepts = torch.cumprod(ok.to(torch.int32), dim=1).sum(
            dim=1).to(torch.int32)
        corrected = torch.gather(emitted, 1, accepts[:, None].long())[:, 0]
        return torch.stack([accepts, corrected], dim=1)

    def _draft_spec_step_impl(self, params, kv, token_ids, q_lens,
                              start_pos, page_table, rng, temps, top_ks,
                              top_ps, row_uids=None, row_pos=None,
                              greedy_only: bool = False) -> torch.Tensor:
        """The draft loop and the verify in one step: ``params`` =
        {"target", "draft"}, ``kv`` = (target pool, draft pool).
        Iteration j of Q runs the draft trunk at Q=1 on the previous
        emission (iteration 0 on ``token_ids[:, 0]``) at position
        ``start_pos + j`` with q_len ``j < q_lens``, so a row with
        ``q_lens = 1 + r`` writes draft KV for all r + 1 of its input
        positions (after a full accept the draft pool covers every
        committed token); rows past their q_len write the null page.
        Drafts are the draft trunk's argmax; only the verify's emissions
        commit.  Returns [S, 2+k] int32 (k = Q-1): accepted count,
        corrected token, then the k drafts."""
        target_kv, draft_kv = kv
        dparams = params["draft"]
        Q = token_ids.shape[1]
        lm_head = self._lm_head(dparams)
        bias = dparams.get("lm_head_bias")
        tok, drafts = token_ids[:, 0], []
        for j in range(Q):
            x = self._forward_hidden(dparams, draft_kv, tok[:, None],
                                     (q_lens > j).to(torch.int32),
                                     start_pos + j, page_table,
                                     cfg=self.draft_cfg)
            tok = greedy(self._assemble_logits(x[:, 0, :], lm_head, bias))
            drafts.append(tok)
        # drafts[j] is d_{j+1}; the last iteration only writes d_{Q-1}'s
        # draft KV for the full-accept case
        tok_mat = torch.cat([token_ids[:, :1],
                             torch.stack(drafts[:Q - 1], dim=1)], dim=1)
        out = self._spec_step_impl(params["target"], target_kv, tok_mat,
                                   q_lens, start_pos, page_table, rng,
                                   temps, top_ks, top_ps, row_uids, row_pos,
                                   greedy_only=greedy_only)
        return torch.cat([out, tok_mat[:, 1:]], dim=1)

    def _draft_fill_step_impl(self, params, kv, token_ids, q_lens,
                              start_pos, page_table) -> None:
        """Draft-trunk forward that writes the draft pool at the batch's
        positions; no unembedding, no output."""
        self._forward_hidden(params, kv, token_ids, q_lens, start_pos,
                             page_table, cfg=self.draft_cfg)

    def _mixed_sample_step_impl(self, params, kv, d_tok, d_ql, d_sp, d_pt,
                                p_tok, p_ql, p_sp, p_pt, rng, temps,
                                top_ks, top_ps, row_uids=None, row_pos=None,
                                fresh_p: bool = False,
                                greedy_only: bool = False):
        logits_d = self._step_impl(params, kv, d_tok, d_ql, d_sp, d_pt,
                                   fresh=False)
        logits_p = self._step_impl(params, kv, p_tok, p_ql, p_sp, p_pt,
                                   fresh=fresh_p)
        tokens = self._sample_tokens(torch.cat([logits_d, logits_p]),
                                     rng, temps, top_ks, top_ps, row_uids,
                                     row_pos, greedy_only)
        # pad the token vector to the slot bucket, as the JAX step does
        # (its chained step keys on the exact previous-token length); a
        # mined lattice gives its own S tops
        n = tokens.shape[0]
        pad = (self.lattice.bucket_s(n) if self.lattice is not None
               else _bucket(n, MIN_SLOTS)) - n
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros(pad)])
        return tokens

    def _layer_body(self, x, lp, kv_layer, *, sin, cos, q_lens, start_pos,
                    page_table, fresh: bool = False, cfg=None):
        cfg = cfg if cfg is not None else self.cfg
        dtype = cfg.dtype
        h = self._norm(lp["norm1"], x)
        ap = lp["attn"]
        q = T.proj(h, T._wval(ap["wq"], dtype))
        k = T.proj(h, T._wval(ap["wk"], dtype))
        v = T.proj(h, T._wval(ap["wv"], dtype))
        if cfg.use_bias or cfg.qkv_bias:
            q = q + ap["bq"].to(dtype)
            k = k + ap["bk"].to(dtype)
            v = v + ap["bv"].to(dtype)
        use_fresh = fresh and self._fresh_attention is not None
        k_rot = k
        if cfg.pos_emb == "rope":
            q = T.apply_rope(q, sin, cos)
            if use_fresh:
                # the fresh path reads the rotated K directly: rotate
                # once and write unfused
                k_rot = T.apply_rope(k, sin, cos)
                write_kv(kv_layer, k_rot, v, page_table, start_pos, q_lens)
            else:
                rope_write_kv(kv_layer, k, v, sin, cos, page_table,
                              start_pos, q_lens)
        else:
            write_kv(kv_layer, k, v, page_table, start_pos, q_lens)
        if use_fresh:
            # pure prefill: every slot's context is its own new tokens;
            # padding-tail rows are garbage that only feeds rows the
            # logits gather ignores and KV the null page swallows
            attn = self._fresh_attention(q, k_rot, v)
        else:
            attn = self._attention(q, kv_layer, page_table, start_pos,
                                   q_lens)
        out = T.proj(attn, T._wval(ap["wo"], dtype), n_in=2)
        if cfg.use_bias:
            out = out + ap["bo"].to(dtype)
        if cfg.parallel_residual:
            h2 = self._norm(lp["norm2"], x)
            return x + out.to(x.dtype) + self._mlp(cfg, lp["mlp"],
                                                   h2).to(x.dtype)
        x = x + out.to(x.dtype)
        h = self._norm(lp["norm2"], x)
        return x + self._mlp(cfg, lp["mlp"], h).to(x.dtype)

    def _mlp(self, cfg, p, h) -> torch.Tensor:
        """The layer's mlp: the dense block, or the MoE layer, whose aux
        loss serving drops, as JAX does."""
        if self.moe_cfg is None:
            return T._mlp_block(cfg, p, h)
        return moe_forward(self.moe_cfg, p, h, is_training=False)[0]

    # -- KV requirements (engine contract) ----------------------------------
    def get_kv_requirements(self, seen_tokens: int, allocated_pages: int,
                            max_new_tokens: int, max_new_pages: int
                            ) -> Tuple[int, int]:
        """(tokens schedulable, pages needed) given page headroom."""
        page = self.kv_config.page_size
        capacity = allocated_pages * page - seen_tokens
        if max_new_tokens <= capacity:
            return max_new_tokens, 0
        need = -(-(max_new_tokens - capacity) // page)
        if need <= max_new_pages:
            return max_new_tokens, need
        tokens = capacity + max_new_pages * page
        return max(tokens, 0), max_new_pages
