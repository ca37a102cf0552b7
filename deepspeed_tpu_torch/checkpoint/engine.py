"""Checkpoint engines and the atomic-write helpers.

Counterpart of ``deepspeed_tpu/checkpoint/engine.py``.  The durability
contract is the JAX package's: every file is written atomically (a tmp
file in the same directory, fsync, rename), ``latest`` is written last,
so a crash at any point mid-save leaves ``latest`` naming the previous
complete checkpoint; an ``OSError`` (the ``ckpt.io_error`` fault site
raises one) is retried with doubling backoff and counted in
``ds_train_ckpt_retry_total``.

The JAX engine stores its state through Orbax; the port writes
``torch.save`` files instead, under the reference DeepSpeed's names::

    <save_dir>/latest                       the newest complete tag
    <save_dir>/<tag>/mp_rank_00_model_states.pt
        {"module": the fp32 master tree (nested dicts, the model's
                   layout and order)}
    <save_dir>/<tag>/zero_pp_rank_0_mp_rank_00_optim_states.pt
        {"optimizer": the optimizer's kind ("adamw", "lion", "lamb", ...),
         "optimizer_state_dict": torch's optimizer state dict (state by
                   master index in tree order: step, exp_avg, exp_avg_sq),
         "loss_scale_state": {loss_scale, good_steps, skipped_steps,
                   hysteresis} (the JAX TrainState's fp16 fields)}
    <save_dir>/<tag>/client_state.json      as the JAX engine writes it

Every file loads with ``torch.load(weights_only=True)``, and masters and
moments come back bit for bit.  With ``async_save`` (the JAX default)
:meth:`TorchCheckpointEngine.save` copies the state to host memory and
returns, while a writer thread persists the copy: the copy finishes
before the return because the next step updates the masters in place.
:meth:`~CheckpointEngine.wait` drains the writer (and raises what it
raised); the engine calls it before ``latest`` is written.
"""

from __future__ import annotations

import abc
import json
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime.fault_injection import (InjectedCheckpointFault,
                                       get_fault_injector)
from ..telemetry import metrics as tm
from ..utils.logging import logger

LATEST_FILE = "latest"
MODEL_FILE = "mp_rank_00_model_states.pt"
OPTIM_FILE = "zero_pp_rank_0_mp_rank_00_optim_states.pt"
CLIENT_FILE = "client_state.json"


def _atomic_write(path: str, write: Callable[[Any], None]) -> None:
    """Run ``write(f)`` on a tmp file beside ``path``, fsync it and
    rename it over ``path``: a reader never sees a torn file.  A failure
    removes the tmp file and leaves ``path`` as it was."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _atomic_write_bytes(path: str, data) -> None:
    """Write ``data``, one buffer or a sequence of buffers streamed
    without concatenation (serving snapshot bundles can be pool-sized),
    to ``path`` atomically.  Shared by ``latest``,
    ``client_state.json`` and the serving snapshot bundles."""
    segments = ((data,) if isinstance(data, (bytes, bytearray,
                                             memoryview)) else data)

    def write(f):
        for seg in segments:
            f.write(seg)
    _atomic_write(path, write)


def _atomic_write_text(path: str, text: str) -> None:
    _atomic_write_bytes(path, text.encode("utf-8"))


def with_retries(what: str, fn: Callable[[], Any], retries: int = 3,
                 backoff_s: float = 0.05) -> Any:
    """Run ``fn``, retrying an ``OSError`` up to ``retries`` times with
    doubling backoff (each retry counted in ``ds_train_ckpt_retry_total``
    and warned about); any other error propagates at once.  The
    checkpoint engine and the serving snapshot writer share it."""
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            tm.TRAIN_CKPT_RETRY.inc()
            warnings.warn(f"checkpoint {what} failed ({type(e).__name__}: "
                          f"{e}); retry {attempt + 1}/{retries} in "
                          f"{delay:.2f}s")
            time.sleep(delay)
            delay *= 2


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class CheckpointEngine(abc.ABC):
    #: transient-I/O retry policy (the ``checkpoint`` config section)
    save_retries: int = 3
    save_backoff_s: float = 0.05

    @abc.abstractmethod
    def save(self, save_dir: str, tag: str, state: Dict[str, Any],
             client_state: dict) -> None:
        ...

    @abc.abstractmethod
    def load(self, load_dir: str, tag: str,
             module_only: bool = False) -> Tuple[Dict[str, Any], dict]:
        ...

    def wait(self) -> None:
        """Block until an in-flight async save is persisted (a no-op for
        a synchronous engine).  Called before ``latest`` names the tag."""

    def _with_retries(self, what: str, fn: Callable[[], Any]) -> Any:
        return with_retries(what, fn, self.save_retries, self.save_backoff_s)

    def write_latest(self, save_dir: str, tag: str) -> None:
        path = os.path.join(save_dir, LATEST_FILE)

        def _write():
            get_fault_injector().maybe_raise(
                "ckpt.io_error", InjectedCheckpointFault,
                "injected I/O error writing latest")
            _atomic_write_text(path, tag)

        self._with_retries("write_latest", _write)

    def read_latest(self, load_dir: str) -> Optional[str]:
        # a stale latest.tmp.* (a writer died before the rename) is
        # ignored: only the renamed file is authoritative
        path = os.path.join(load_dir, LATEST_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            tag = f.read().strip()
        return tag or None


class TorchCheckpointEngine(CheckpointEngine):
    """``torch.save`` files in the reference DeepSpeed's layout (module
    docstring); the port's stand-in for the JAX ``OrbaxCheckpointEngine``.

    ``state`` is ``{"module": <master tree>, "optimizer": <kind>,
    "optimizer_state_dict": <torch optimizer state dict>,
    "loss_scale_state": <dict>}``; every key but ``module`` goes to the
    optimizer file.  The host
    copy reuses its buffers from one save to the next (pinned when the
    state lies on the card), so a periodic save allocates once."""

    def __init__(self, async_save: bool = True, save_retries: int = 3,
                 save_backoff_s: float = 0.05):
        self.async_save = bool(async_save)
        self.save_retries = int(save_retries)
        self.save_backoff_s = float(save_backoff_s)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[Tuple, torch.Tensor] = {}

    # -- host copies -------------------------------------------------------
    def _host_copy(self, state: Any) -> Any:
        """The state with every tensor copied to (reused) host buffers;
        returns once every copy has landed."""
        used: Dict[Tuple, torch.Tensor] = {}
        cuda = False

        def copy(obj, path):
            nonlocal cuda
            if isinstance(obj, dict):
                return {k: copy(v, path + (k,)) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(copy(v, path + (i,))
                                 for i, v in enumerate(obj))
            if not isinstance(obj, torch.Tensor):
                return obj
            key = path + (obj.dtype, tuple(obj.shape))
            buf = self._buffers.get(key)
            if buf is None:
                buf = torch.empty(obj.shape, dtype=obj.dtype,
                                  pin_memory=obj.is_cuda)
            used[key] = buf
            cuda |= obj.is_cuda
            buf.copy_(obj.detach(), non_blocking=obj.is_cuda)
            return buf

        out = copy(state, ())
        if cuda:
            torch.cuda.synchronize()
        self._buffers = used
        return out

    # -- save ----------------------------------------------------------------
    def save(self, save_dir: str, tag: str, state: Dict[str, Any],
             client_state: dict) -> None:
        path = os.path.abspath(os.path.join(save_dir, tag))
        os.makedirs(path, exist_ok=True)
        self.wait()                     # at most one save in flight
        host = self._host_copy(state)
        model = {"module": host["module"]}
        optim = {k: v for k, v in host.items() if k != "module"}
        payload = json.dumps(_jsonable(client_state))

        def _save_state():
            get_fault_injector().maybe_raise(
                "ckpt.io_error", InjectedCheckpointFault,
                "injected I/O error saving checkpoint state")
            for name, obj in ((MODEL_FILE, model), (OPTIM_FILE, optim)):
                _atomic_write(os.path.join(path, name),
                              lambda f, obj=obj: torch.save(obj, f))

        def _save_client():
            get_fault_injector().maybe_raise(
                "ckpt.io_error", InjectedCheckpointFault,
                "injected I/O error saving client state")
            _atomic_write_text(os.path.join(path, CLIENT_FILE), payload)

        def persist():
            self._with_retries("save", _save_state)
            self._with_retries("client_state", _save_client)
            logger.info("saved checkpoint %s%s", path,
                        " (async)" if self.async_save else "")

        if not self.async_save:
            persist()
            return

        def run():
            try:
                persist()
            except Exception as e:          # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run, name="ds-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- load ----------------------------------------------------------------
    def load(self, load_dir: str, tag: str,
             module_only: bool = False) -> Tuple[Dict[str, Any], dict]:
        """``({"module": ..., and without module_only the optimizer
        file's keys}, client_state)``, as host tensors mapped from the
        files."""
        self.wait()
        path = os.path.abspath(os.path.join(load_dir, tag))
        state = {"module": _torch_load(os.path.join(path, MODEL_FILE))[
            "module"]}
        if not module_only:
            state.update(_torch_load(os.path.join(path, OPTIM_FILE)))
        client_state = {}
        cs_path = os.path.join(path, CLIENT_FILE)
        if os.path.exists(cs_path):
            with open(cs_path) as f:
                client_state = json.load(f)
        logger.info("loaded checkpoint %s", path)
        return state, client_state


def _torch_load(path: str) -> Any:
    """A checkpoint file, memory-mapped (the copy into the engine reads
    it page by page) and with ``weights_only``."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def resolve_tag(ckpt_dir: str, tag: Optional[str]) -> str:
    """``tag``, or the one ``<ckpt_dir>/latest`` names."""
    if tag is not None:
        return tag
    latest = os.path.join(ckpt_dir, LATEST_FILE)
    if not os.path.exists(latest):
        raise FileNotFoundError(
            f"no tag given and no '{LATEST_FILE}' file in {ckpt_dir}")
    with open(latest) as f:
        return f.read().strip()


def read_checkpoint(ckpt_dir: str, tag: Optional[str] = None,
                    module_only: bool = False) -> Tuple[Dict[str, Any], dict,
                                                        str]:
    """``(state, client_state, tag)`` of a port checkpoint, read with
    torch alone (the offline tools' entry)."""
    tag = resolve_tag(ckpt_dir, tag)
    if not os.path.exists(os.path.join(ckpt_dir, tag, MODEL_FILE)):
        raise FileNotFoundError(
            f"checkpoint files not found under {os.path.join(ckpt_dir, tag)}")
    state, client_state = TorchCheckpointEngine(async_save=False).load(
        ckpt_dir, tag, module_only=module_only)
    return state, client_state, tag
