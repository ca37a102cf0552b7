"""Workload trace: what the serving traffic looked like, as a ledger.

Counterpart of ``deepspeed_tpu/telemetry/workload_trace.py``, with the
same record layout, so a ledger written by either package mines to the
same lattice (``inference/v2/lattice.py``).  A bounded, rotating,
append-only JSONL file of per-request FACTS, written by the
``FastGenScheduler`` at its drain and error points:

- ``{"kind": "meta", ...}``: one header per file (schema version, page
  size, vocab size, wall-clock time);
- ``{"kind": "request", ...}``: one line per ended request: arrival
  offset (seconds since the trace opened), prompt and generated lengths,
  the sampling parameters, the prompt's chained page digests, the outcome
  ("ok" or the ``RequestError`` code), TTFT / mean ITL / queue wait in ms,
  the speculation counts and the warm-prefix tokens by tier;
- ``{"kind": "keys", ...}``: how often each step key ran, counted in
  memory and written every :data:`KEY_FLUSH_EVERY` dispatches (no I/O
  per step);
- ``{"kind": "compile", ...}``: one line per step key captured ON the
  request path (the keys the precompiled lattice missed).

Content-free: token ids never enter the ledger.  A prompt appears as its
length and the prefix cache's chained blake2b page digests, which keep
the sharing structure between requests without the content.

Enabled by a path: ``DS_WORKLOAD_TRACE=/path/trace.jsonl`` (read when
the telemetry package is imported) or ``telemetry.workload_trace_path``
in the engine config.  Every record point returns after one attribute
read (``active``) when the trace is off.  When the file passes
``max_bytes`` (``workload_trace_max_mb`` / ``DS_WORKLOAD_TRACE_MAX_MB``,
default 32 MiB) it moves to ``<path>.1`` (one generation kept), so the
ledger holds at most about twice that on disk.  A write that fails
turns the trace off with one warning: the ledger never raises into a
serving step.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

TRACE_VERSION = 1
DEFAULT_MAX_BYTES = 32 << 20
#: dispatches between two ``keys`` records
KEY_FLUSH_EVERY = 2048


def _json_key(key) -> list:
    """A step key as a JSON list (ints, bools and strings)."""
    return [k if isinstance(k, (int, bool, str)) else repr(k)
            for k in key]


class WorkloadTrace:
    """Bounded rotating JSONL ledger of serving workload facts."""

    def __init__(self) -> None:
        #: the gate every record point reads first
        self.active = False
        self._lock = threading.RLock()
        self._path = ""
        self._max_bytes = DEFAULT_MAX_BYTES
        self._fh = None
        self._t0: Optional[float] = None    # monotonic epoch of the trace
        self._header: Optional[Dict[str, Any]] = None
        self._header_written = False
        self._key_counts: Dict[tuple, int] = {}
        self._key_obs = 0

    # -- lifecycle -----------------------------------------------------------
    def configure(self, path: str = "", max_mb: int = 0,
                  max_bytes: int = 0) -> None:
        """"" / 0 keep what is configured.  A new path closes the ledger
        open now and opens the new one (append mode; the epoch restarts).
        ``max_bytes`` sets the rotation bound below a MiB (tests)."""
        with self._lock:
            if max_mb:
                self._max_bytes = int(max_mb) << 20
            if max_bytes:
                self._max_bytes = int(max_bytes)
            if not path or path == self._path:
                return
            self._close_locked()
            self._path = path
            try:
                self._open_locked()
            except OSError:
                # a failed open must not keep the path: a retry with the
                # same path would otherwise return early and never open
                self._path = ""
                raise

    def close(self) -> None:
        """Flush the pending key counts and stop capturing."""
        with self._lock:
            self._close_locked()
            self._path = ""

    @contextlib.contextmanager
    def suspended(self):
        """Stop capturing for the block (the ledger stays open): a tool
        that drives a scheduler while it reads a ledger must not append
        its own traffic to it."""
        was = self.active
        self.active = False
        try:
            yield
        finally:
            # a close() or configure() inside the block wins
            self.active = was and self._fh is not None

    def _io_error_locked(self, where: str, exc: OSError) -> None:
        """A failed write turns capture off with one warning (and frees
        the path for a later ``configure``); it never raises into the
        serving step."""
        self.active = False
        self._path = ""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        warnings.warn(f"workload trace: {where} failed ({exc}); capture "
                      "disabled, configure workload_trace_path to retry")

    def _open_locked(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                    exist_ok=True)
        self._fh = open(self._path, "a")
        self._t0 = time.monotonic()
        self._header_written = False
        self.active = True

    def _close_locked(self) -> None:
        self.active = False
        if self._fh is not None:
            try:
                self._flush_keys_locked()
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    # -- record points -------------------------------------------------------
    def record_request(self, *, uid: int, arrival_mono: float,
                       prompt_len: int, gen_len: int,
                       digests: List[str], page_size: int,
                       vocab_size: int, temperature: float, top_k: int,
                       top_p: float, max_new_tokens: int, outcome: str,
                       ttft_ms: Optional[float],
                       itl_ms: Optional[float],
                       queue_wait_ms: Optional[float],
                       spec_drafted: int = 0,
                       spec_accepted: int = 0,
                       spec_drafter: str = "",
                       spec_ngram: Optional[List[int]] = None,
                       spec_model: Optional[List[int]] = None,
                       hit_device: int = 0,
                       hit_host: int = 0,
                       hit_disk: int = 0,
                       hit_remote: int = 0,
                       journey_ms: Optional[Dict[str, float]] = None
                       ) -> None:
        """One ended request: lengths, digests, parameters, latencies,
        the speculation counts (``spec_ngram`` / ``spec_model``: the
        (drafted, accepted) split by drafter, written as four scalar
        fields) and the warm-prefix tokens by tier of origin.  Never a
        token id.  ``journey_ms`` ({bucket: ms}, written as
        ``journey_<bucket>_ms``) is absent when journeys are off, as
        they always are in this package."""
        if not self.active:
            return
        rec = {
            "kind": "request",
            "uid": int(uid),
            "arrival_s": self._offset(arrival_mono),
            "prompt_len": int(prompt_len),
            "gen_len": int(gen_len),
            "digests": digests,
            "temperature": round(float(temperature), 6),
            "top_k": int(top_k),
            "top_p": round(float(top_p), 6),
            "max_new_tokens": int(max_new_tokens),
            "outcome": str(outcome),
            "ttft_ms": None if ttft_ms is None else round(ttft_ms, 3),
            "itl_ms": None if itl_ms is None else round(itl_ms, 3),
            "queue_wait_ms": (None if queue_wait_ms is None
                              else round(queue_wait_ms, 3)),
            "spec_drafted": int(spec_drafted),
            "spec_accepted": int(spec_accepted),
            "spec_drafter": str(spec_drafter),
            # scalars: the digests are the one list a request record holds
            "spec_ngram_drafted": int((spec_ngram or (0, 0))[0]),
            "spec_ngram_accepted": int((spec_ngram or (0, 0))[1]),
            "spec_model_drafted": int((spec_model or (0, 0))[0]),
            "spec_model_accepted": int((spec_model or (0, 0))[1]),
            "hit_device": int(hit_device),
            "hit_host": int(hit_host),
            "hit_disk": int(hit_disk),
            "hit_remote": int(hit_remote),
        }
        if journey_ms:
            for bucket, ms in journey_ms.items():
                rec[f"journey_{bucket}_ms"] = round(float(ms), 3)
        with self._lock:
            if not self.active:
                return
            try:
                if not self._header_written:
                    self._header = {"kind": "meta",
                                    "version": TRACE_VERSION,
                                    "page_size": int(page_size),
                                    "vocab_size": int(vocab_size),
                                    "time_unix": round(time.time(), 3)}
                    self._write_locked(self._header)
                    self._header_written = True
                self._write_locked(rec)
                self._fh.flush()    # requests are rare; a crash keeps them
            except OSError as e:
                self._io_error_locked("request write", e)

    def note_step_key(self, key: tuple) -> None:
        """One step dispatch: counted in memory, written as a ``keys``
        record every :data:`KEY_FLUSH_EVERY` dispatches."""
        if not self.active:
            return
        with self._lock:
            if not self.active:
                return
            self._key_counts[key] = self._key_counts.get(key, 0) + 1
            self._key_obs += 1
            if self._key_obs >= KEY_FLUSH_EVERY:
                try:
                    self._flush_keys_locked()
                except OSError as e:
                    self._io_error_locked("keys flush", e)

    def record_compile(self, key) -> None:
        """One step key captured on the request path, written at once
        (captures there are rare, and the lattice miner needs each)."""
        if not self.active:
            return
        with self._lock:
            if not self.active:
                return
            try:
                self._write_locked({"kind": "compile",
                                    "key": _json_key(key),
                                    "t_s": self._offset(time.monotonic())})
                self._fh.flush()
            except OSError as e:
                self._io_error_locked("compile write", e)

    def flush(self) -> None:
        """Write the pending key counts and flush the file."""
        with self._lock:
            if not self.active:
                return
            try:
                self._flush_keys_locked()
                self._fh.flush()
            except OSError as e:
                self._io_error_locked("flush", e)

    def tail_text(self, max_bytes: int = 256 << 10) -> Optional[str]:
        """The last ``max_bytes`` of the live ledger (whole lines), for
        the flight recorder's ``workload.jsonl`` artifact; None when the
        trace is off.  Reads across the rotation boundary, so a freshly
        rotated ledger still ships its previous generation's tail."""
        with self._lock:
            if not self.active:
                return None
            try:
                self._flush_keys_locked()
                self._fh.flush()
            except OSError as e:
                self._io_error_locked("tail flush", e)
                return None
            text = self._read_tail(self._path, max_bytes)
            if text is None:
                return None
            if len(text) < max_bytes:
                prev = self._read_tail(self._path + ".1",
                                       max_bytes - len(text))
                if prev:
                    text = prev + text
        return text

    @staticmethod
    def _read_tail(path: str, nbytes: int) -> Optional[str]:
        """Last ``nbytes`` of ``path`` starting at a whole line; None
        when unreadable."""
        try:
            with open(path) as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - nbytes))
                text = f.read()
        except OSError:
            return None
        if len(text) < size:  # started mid-line: drop the partial one
            text = text.split("\n", 1)[-1]
        return text

    # -- internals -----------------------------------------------------------
    def _offset(self, mono: float) -> float:
        return round(max(0.0, mono - (self._t0 or mono)), 6)

    def _flush_keys_locked(self) -> None:
        if not self._key_counts or self._fh is None:
            return
        counts = [[_json_key(k), n]
                  for k, n in sorted(self._key_counts.items(),
                                     key=lambda kv: -kv[1])]
        self._key_counts.clear()
        self._key_obs = 0
        self._write_locked({"kind": "keys",
                            "t_s": self._offset(time.monotonic()),
                            "counts": counts})

    def _write_locked(self, rec: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        if self._fh.tell() >= self._max_bytes:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """The ledger moves to ``<path>.1`` (replacing the generation
        before it) and a fresh file opens with the header again; the
        epoch stays, so arrival offsets stay on one axis.  An OSError
        reaches the record point, which turns capture off."""
        self._fh.close()
        os.replace(self._path, self._path + ".1")
        self._fh = open(self._path, "a")
        self._header_written = False
        if self._header is not None:
            self._write_locked(dict(self._header, rotated=True))
            self._header_written = True


#: the process-wide trace
_TRACE = WorkloadTrace()


def get_workload_trace() -> WorkloadTrace:
    return _TRACE


def maybe_configure_from_env() -> bool:
    """Honour ``DS_WORKLOAD_TRACE`` (a path) and
    ``DS_WORKLOAD_TRACE_MAX_MB``; an unwritable path warns and leaves
    capture off.  Returns whether a path was configured."""
    path = os.environ.get("DS_WORKLOAD_TRACE", "")
    max_mb = 0
    raw = os.environ.get("DS_WORKLOAD_TRACE_MAX_MB", "")
    if raw:
        try:
            max_mb = int(raw)
        except ValueError:
            warnings.warn(f"DS_WORKLOAD_TRACE_MAX_MB={raw!r} is not an "
                          "int: keeping the default rotation bound")
    if not (path or max_mb):
        return False
    try:
        _TRACE.configure(path, max_mb=max_mb)
    except OSError as e:
        warnings.warn(f"DS_WORKLOAD_TRACE={path!r}: ledger not opened "
                      f"({e}); continuing without workload capture")
        return False
    return bool(path)
