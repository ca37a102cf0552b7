"""Universal checkpoints: the format both packages read.

Counterpart of ``deepspeed_tpu/checkpoint/universal.py`` (``ds_to_universal``
:45, ``load_universal_into_engine`` :109), and its files are the same: a
universal directory holds ``atoms.npz`` (fp32 params and the optimizer
state, one array an atom) and ``universal_meta.json`` (the step counters
and the source checkpoint's client state).  Neither needs Orbax or JAX to
read, so a JAX checkpoint reaches the port through the JAX
``ds_to_universal`` and a port checkpoint reaches JAX through this one.

Atom keys are the JAX package's: ``params/<path>`` (``/``-joined tree
paths) and ``opt_state/<optax path>``, the state layout of the optax
transform the JAX engine builds for the optimizer (JAX
``runtime/optimizers.py``): ``optax.adamw`` and ``optax.lamb`` keep
``count``, ``mu`` and ``nu`` in the chain's first state and one more
``count`` in the learning-rate schedule's (index 2 for AdamW, 3 for
LAMB, after the trust ratio); ``optax.lion`` keeps ``count`` and ``mu``,
and the schedule's ``count`` at 2.  The port's fused optimizers name the
same numbers ``exp_avg`` (``mu``), ``exp_avg_sq`` (``nu``) and ``step``
(``count``: every master's update count, one number in optax).  The
other optimizers of the factory (``runtime/optimizers.py``) map their
state onto their optax transforms' the same way (:data:`OPTAX_LAYOUT`,
read off the JAX states in the tests): SGD's trace, Adagrad's sums,
Adafactor's ``v_row`` / ``v_col`` / ``v`` (one-element placeholders as
optax keeps them), coupled-L2 Adam's moments at chain index 1, Muon's
two partitions (a 2-D leaf's ``mu`` under ``muon``, every other leaf's
``mu`` and ``nu`` under ``adam``, and the Newton-Schulz coefficients as
one more atom) and the 1-bit transforms' ``mu``, ``nu`` and ``error``.

A ZeRO-Offload checkpoint converts as the JAX package converts its
own: the JAX engine masks the offloaded leaves out of optax (state under
``0/inner_state/``, :data:`MASKED_PREFIX`) and ``ds_to_universal`` reads
the engine state alone, not ``offload_rank0.npz``.  So the offloaded
leaves' ``params`` atoms hold their compute-dtype copies (JAX writes the
raw bf16 bytes; this one their fp32 values) and they have no moment
atoms: the fp32 masters and the host moments stay in the npz.  Loading
such atoms into an offload engine sets its host masters from them and
keeps the host moments.

The meta holds ``step`` (every step taken, skipped ones too: the
update count plus ``skipped_steps``), ``loss_scale``, ``good_steps``,
``skipped_steps`` and ``hysteresis``, the engine's loss-scale state
from the checkpoint's optimizer file (outside fp16: scale 1, no skip,
``hysteresis`` the fp16 section's default 2, as JAX writes them); a
load restores them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..tree import tree_leaves
from ..utils.logging import logger
from .engine import read_checkpoint
from .zero_to_fp32 import _to_numpy

UNIVERSAL_DIR = "universal"
META_FILE = "universal_meta.json"
ATOMS_FILE = "atoms.npz"

#: the JAX engine's fp16 ``hysteresis`` default, which its meta carries
#: unchanged outside fp16
FP16_HYSTERESIS = 2

_MUON = "inner_states/muon/inner_state/"
_MUON_ADAM = "inner_states/adam/inner_state/"
#: optimizer kind -> ({port state: optax subtree}, the optax counts); a
#: Muon state's subtree depends on the leaf (:func:`_moment_keys`)
OPTAX_LAYOUT = {
    "adamw": ({"exp_avg": "0/mu", "exp_avg_sq": "0/nu"},
              ("0/count", "2/count")),
    "adam_l2": ({"exp_avg": "1/mu", "exp_avg_sq": "1/nu"},
                ("1/count", "2/count")),
    "lion": ({"exp_avg": "0/mu"}, ("0/count", "2/count")),
    "lamb": ({"exp_avg": "0/mu", "exp_avg_sq": "0/nu"},
             ("0/count", "3/count")),
    "adagrad": ({"sum_of_squares": "0/sum_of_squares"}, ("1/count",)),
    "sgd": ({}, ("1/count",)),
    "sgd_momentum": ({"momentum_buffer": "0/trace"}, ("1/count",)),
    "adafactor": ({"v_row": "0/v_row", "v_col": "0/v_col", "v": "0/v"},
                  ("0/count", "2/count")),
    "muon": ({"exp_avg": None, "exp_avg_sq": None},
             (f"{_MUON}0/count", f"{_MUON}2/count", f"{_MUON_ADAM}0/count",
              f"{_MUON_ADAM}2/count")),
    "onebitadam": ({"exp_avg": "mu", "exp_avg_sq": "nu", "error": "error"},
                   ("count",)),
    "onebitlamb": ({"exp_avg": "mu", "exp_avg_sq": "nu", "error": "error"},
                   ("count",)),
}
#: atoms a layout holds beside the leaves' state and the counts
OPTAX_CONSTANTS = {"muon": {f"{_MUON}0/ns_coeffs": np.asarray(
    (3.4445, -4.7750, 2.0315), np.float32)}}
#: the engine's loss-scale state (``loss_scale_state`` in a checkpoint's
#: optimizer file), the meta's keys
_SCALE_KEYS = ("loss_scale", "good_steps", "skipped_steps", "hysteresis")


def _moment_keys(kind: str, shape) -> Dict[str, str]:
    """{port state name: optax subtree} of one leaf of ``shape``."""
    moments = OPTAX_LAYOUT[kind][0]
    if kind != "muon":
        return moments
    if len(shape) == 2:
        return {"exp_avg": f"{_MUON}0/mu"}
    return {"exp_avg": f"{_MUON_ADAM}0/mu", "exp_avg_sq": f"{_MUON_ADAM}0/nu"}


def leaf_paths(tree, prefix: str = "", sep: str = "/") -> List[str]:
    """Each leaf's path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}{k}{sep}", sep)]
    return [prefix[:-len(sep)]]


def _layout(kind: str):
    if kind not in OPTAX_LAYOUT:
        raise ValueError(f"no optax layout for optimizer {kind!r}; "
                         f"known: {sorted(OPTAX_LAYOUT)}")
    return OPTAX_LAYOUT[kind]


#: where a masked optax chain (JAX ``_maybe_enable_offload``) keeps the
#: optimizer's state
MASKED_PREFIX = "0/inner_state/"


def ds_to_universal(ckpt_dir: str, tag: Optional[str] = None,
                    out_dir: Optional[str] = None) -> str:
    """Convert a port checkpoint (``tag``, or the one ``latest`` names)
    into the universal format under ``out_dir`` (default
    ``<ckpt_dir>/<tag>_universal``); returns that directory."""
    state, client_state, tag = read_checkpoint(ckpt_dir, tag)
    kind = state["optimizer"]
    _, counts = _layout(kind)
    module = state["module"]
    paths = leaf_paths(module)
    leaves = tree_leaves(module)
    per_param = state["optimizer_state_dict"]["state"]
    offloaded = set(state["optimizer_state_dict"].get("offloaded", ()))
    prefix = MASKED_PREFIX if offloaded else ""

    atoms: Dict[str, np.ndarray] = {}
    steps = set()
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        atoms[f"params/{path}"] = _to_numpy(leaf).astype(np.float32,
                                                         copy=False)
        if path in offloaded:
            continue
        st = per_param.get(i, {})
        steps.add(int(st.get("step", 0)))
        for name, sub in _moment_keys(kind, tuple(leaf.shape)).items():
            atoms[f"opt_state/{prefix}{sub}/{path}"] = (
                _to_numpy(st[name]) if name in st
                else _fresh_state(kind, name, tuple(leaf.shape)))
    if len(steps) > 1:
        raise ValueError(f"masters at different update counts {sorted(steps)}"
                         f": optax keeps one count")
    # every leaf offloaded: the masked optax count is the step count
    count = steps.pop() if steps else int(client_state.get("global_steps",
                                                           0))
    for c in counts:
        atoms[f"opt_state/{prefix}{c}"] = np.asarray(count, np.int32)
    for key, value in OPTAX_CONSTANTS.get(kind, {}).items():
        atoms[f"opt_state/{prefix}{key}"] = value

    out_dir = out_dir or os.path.join(ckpt_dir, f"{tag}_{UNIVERSAL_DIR}")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, ATOMS_FILE), **atoms)
    scale = {"loss_scale": 1.0, "good_steps": count, "skipped_steps": 0,
             "hysteresis": FP16_HYSTERESIS}
    scale.update(state.get("loss_scale_state", {}))
    meta = {"step": count + int(scale["skipped_steps"]), **scale,
            "source_tag": tag, "client_state": client_state}
    with open(os.path.join(out_dir, META_FILE), "w") as fh:
        json.dump(meta, fh)
    logger.info("universal checkpoint written: %s (%d atoms)", out_dir,
                len(atoms))
    return out_dir


def _state_shape(kind: str, name: str, shape) -> tuple:
    """The shape of state ``name`` of a leaf of ``shape``: the leaf's,
    but for Adafactor's (a factored leaf's ``v_row`` / ``v_col`` drop
    one of its two largest dims, a placeholder is one element)."""
    shape = tuple(shape)
    if kind != "adafactor":
        return shape
    from ..runtime.optimizers import factored_dims
    dims = factored_dims(shape)
    if (name == "v") == (dims is not None):
        return (1,)
    if name == "v":
        return shape
    drop = dims[1] if name == "v_row" else dims[0]
    return shape[:drop] + shape[drop + 1:]


def _fresh_state(kind: str, name: str, shape) -> np.ndarray:
    """A state the checkpoint lacks (no update yet), as optax's init
    holds it."""
    fill = 0.1 if kind == "adagrad" else 0.0
    return np.full(_state_shape(kind, name, shape), fill, np.float32)


def load_universal_into_engine(engine, universal_dir: str,
                               strict: bool = True,
                               load_optimizer_states: bool = True,
                               load_lr_scheduler_states: bool = True) -> None:
    """Restore a universal checkpoint written by either package into the
    port's engine, in place.  With ``strict``, an atom this engine's
    layout lacks and an atom missing from the file both raise
    ``KeyError``; a shape that differs raises ``ValueError`` (another
    model).  Without the optimizer states only the masters load, and
    the optimizer keeps its own trajectory (the JAX weights-only load)."""
    with np.load(os.path.join(universal_dir, ATOMS_FILE)) as z:
        atoms = {k: z[k] for k in z.files}
    with open(os.path.join(universal_dir, META_FILE)) as fh:
        meta = json.load(fh)

    kind = engine.optimizer_kind
    _, counts = _layout(kind)
    paths = engine.param_paths
    offloaded = engine._offloaded
    prefix = MASKED_PREFIX if any(offloaded) else ""
    shapes = [tuple(s) for s in engine.param_shapes]
    moments = [{name: prefix + sub for name, sub in
                _moment_keys(kind, shape).items()} for shape in shapes]
    counts = tuple(prefix + c for c in counts)
    known = {f"params/{p}" for p in paths}
    known |= {f"opt_state/{sub}/{p}" for p, mo, off in
              zip(paths, moments, offloaded) if not off
              for sub in mo.values()}
    known |= {f"opt_state/{c}" for c in counts}
    known |= {f"opt_state/{prefix}{k}" for k in OPTAX_CONSTANTS.get(kind, {})}
    unknown = sorted(set(atoms) - known)
    if strict and unknown:
        raise KeyError(f"universal checkpoint atoms {unknown[:4]} (of "
                       f"{len(unknown)}) are not in this engine's layout "
                       f"({engine.optimizer_kind})")

    def atom(key: str, shape) -> Optional[np.ndarray]:
        if key not in atoms:
            if strict:
                raise KeyError(f"universal checkpoint missing atom {key!r}")
            return None
        arr = atoms[key]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"atom {key!r} shape {arr.shape} != current {tuple(shape)}"
                f" — universal atoms are global (unsharded); a mismatch "
                f"means a different MODEL, not a different topology")
        return arr

    masters = engine.masters
    engine._copy_masters([atom(f"params/{p}", shape)
                          for p, shape in zip(paths, shapes)])
    if load_optimizer_states:
        count = atom(f"opt_state/{counts[0]}", ())
        states = []
        for p, m, mo, off, shape in zip(paths, masters, moments, offloaded,
                                        shapes):
            # an offloaded leaf has no moment atoms: its host moments stay
            st = {} if off else {
                name: atom(f"opt_state/{sub}/{p}",
                           _state_shape(kind, name, shape))
                for name, sub in mo.items()}
            if count is not None:
                st["step"] = int(count)
            states.append({k: v for k, v in st.items() if v is not None})
        engine._copy_optimizer_state(states)
    # the loss-scale state rides with the optimizer's, as in JAX
    scale = ({k: meta[k] for k in _SCALE_KEYS if k in meta}
             if load_optimizer_states else {})
    cs = {**scale, **meta.get("client_state", {})}
    engine._finish_load(cs, load_lr_scheduler_states,
                        default_steps=meta["step"])
    logger.info("universal checkpoint loaded from %s", universal_dir)

