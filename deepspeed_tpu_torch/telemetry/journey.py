"""Request journeys: end-to-end per-request tracing across routers,
pools, handoffs and migrations.

Counterpart of ``deepspeed_tpu/telemetry/journey.py`` (plain Python, the
same segment taxonomy and record layout).  A :class:`Journey` is a
request-scoped trace context (a journey id plus a monotone segment log)
minted at ``submit()`` and carried through every boundary the request
crosses: router placement, the disaggregated handoff bundles, snapshot
bundles and pool migrations, so each component appends typed segments
to the context it received.

The segment log is a partition of wall time: ``mark(seg)`` closes the
interval [previous mark, now] as one typed segment and advances the
mark, so chains are gap-free and sum to the end-to-end latency by
construction.  Stamps are wall-clock (``time.time()``), the clock that
aligns across processes.  Completed journeys and exported fragments land
in the process-wide :class:`JourneyLog`.  Records are content-free:
stamps, durations, segment kinds, component labels and outcome codes,
never tokens.  With telemetry off ``mint`` returns None and every touch
point is a ``journey is not None`` check.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .state import state

#: the CLOSED segment taxonomy.
#: Producers mark only these kinds; consumers may hard-fail on an
#: unknown kind.
SEGMENT_KINDS = (
    "queue_wait",        # scheduler submit -> first admission
    "placement",         # pool submit -> router decision applied
    "page_fetch",        # cross-replica prefix-page fetch
    "tier_promote",      # host/disk tier promotion at prefix match
    "prefill",           # admission -> first committed token
    "first_token",       # the first-token delivery instant (~0 ms)
    "handoff_export",    # parked handoff-ready -> bundle serialized
    "handoff_transfer",  # bundle serialized -> import began
    "handoff_import",    # import began -> request restored
    "migrate",           # last mark on the dead/drained replica ->
                         # resubmission on the survivor
    "decode",            # first token -> last committed token
    "drain",             # last token -> ledger flush
)

#: ledger bucket per segment kind — the flattened
#: ``journey_<bucket>_ms`` scalar fields the workload ledger records
#: (digests stay the only list-shaped request field).
BUCKETS = {
    "queue_wait": "queue",
    "placement": "placement", "page_fetch": "placement",
    "prefill": "prefill", "first_token": "prefill",
    "handoff_export": "handoff", "handoff_transfer": "handoff",
    "handoff_import": "handoff",
    "tier_promote": "promote",
    "decode": "decode", "drain": "decode",
    "migrate": "migrate",
}
BUCKET_NAMES = ("queue", "placement", "prefill", "handoff", "promote",
                "decode", "migrate")

DEFAULT_CAPACITY = 512

#: per-process mint counter — jids must stay unique across the
#: resubmissions/restores that reuse a uid
_SEQ = itertools.count()


class Journey:
    """One request's segment log.  Not thread-safe per instance: a
    journey is only ever appended to by the component currently holding
    the request (ownership transfers with the request itself)."""

    __slots__ = ("jid", "uid", "t0", "segments", "closed", "_mark")

    def __init__(self, jid: str, uid: int, t0: Optional[float] = None):
        self.jid = jid
        self.uid = int(uid)
        self.t0 = time.time() if t0 is None else float(t0)
        #: list of {"seg", "t0", "ms", "at"} dicts, chained end-to-end
        self.segments: List[Dict[str, Any]] = []
        self.closed = False
        self._mark = self.t0

    def mark(self, seg: str, at: str = "",
             t: Optional[float] = None) -> None:
        """Close the open interval [previous mark, ``t`` or now] as one
        ``seg`` segment.  ``at`` labels the component (defaults to the
        stepper thread's component label); an explicit
        ``t`` lets import sites split transfer-vs-import at the instant
        the bundle arrived."""
        if self.closed:
            return
        now = time.time() if t is None else float(t)
        start = self._mark
        ms = max((now - start) * 1e3, 0.0)
        if not at:
            from .tracer import current_component
            at = current_component()
        self.segments.append({"seg": seg, "t0": start,
                              "ms": ms, "at": at})
        # advance by the RECORDED duration so the chain stays exactly
        # contiguous even when a wall-clock step lands in the past
        self._mark = start + ms / 1e3

    def total_ms(self) -> float:
        return (self._mark - self.t0) * 1e3

    def bucket_ms(self) -> Dict[str, float]:
        """The flattened TTFT decomposition: segment durations summed
        into the ledger buckets (every bucket present, 0.0 default)."""
        out = {b: 0.0 for b in BUCKET_NAMES}
        for s in self.segments:
            out[BUCKETS.get(s["seg"], "decode")] += s["ms"]
        return {b: round(v, 3) for b, v in out.items()}

    # -- bundle serialization (handoff / snapshot / migration) --------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "jid": self.jid, "uid": self.uid,
            "t0": round(self.t0, 6),
            "segments": [{"seg": s["seg"], "t0": round(s["t0"], 6),
                          "ms": round(s["ms"], 3), "at": s["at"]}
                         for s in self.segments],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Journey":
        j = cls(str(d.get("jid", "?")), int(d.get("uid", 0)),
                t0=float(d.get("t0", 0.0)))
        for s in d.get("segments", ()):
            j.segments.append({"seg": str(s.get("seg", "?")),
                               "t0": float(s.get("t0", 0.0)),
                               "ms": float(s.get("ms", 0.0)),
                               "at": str(s.get("at", ""))})
        if j.segments:
            last = j.segments[-1]
            j._mark = last["t0"] + last["ms"] / 1e3
        return j


def mint(uid: int) -> Optional[Journey]:
    """Mint a journey for a request entering ``submit()`` — or None
    when telemetry is off.  Disabled path: one attribute read; every
    downstream touch point is gated on ``req.journey is not None``."""
    if not state.enabled:
        return None
    return Journey("%x-%x-%x" % (int(uid), os.getpid(), next(_SEQ)),
                   uid)


# -- reconstruction helpers ---------------------------------------------------
def chain_gaps(rec: Dict[str, Any], eps_ms: float = 1.0) -> List[str]:
    """Contiguity findings for one journey dict (empty = gap-free):
    every segment must start where the previous one ended, the first
    at the journey's ``t0``."""
    out: List[str] = []
    prev_end = float(rec.get("t0", 0.0))
    for s in rec.get("segments", ()):
        delta_ms = (float(s["t0"]) - prev_end) * 1e3
        if abs(delta_ms) > eps_ms:
            out.append(f"{s['seg']}: starts {round(delta_ms, 3)}ms "
                       "away from the previous segment's end")
        prev_end = float(s["t0"]) + float(s["ms"]) / 1e3
    return out


def stitch(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge journey dicts sharing one jid (a completed record plus
    the fragments exported along the way, possibly scraped from
    different processes) into one chronological segment chain —
    duplicate segments (a fragment is a prefix of its completion)
    dedup by (seg, t0)."""
    if not records:
        return {"jid": None, "segments": []}
    seen = set()
    segments: List[Dict[str, Any]] = []
    outcome = None
    for rec in records:
        if rec.get("outcome") is not None:
            outcome = rec["outcome"]
        for s in rec.get("segments", ()):
            key = (s["seg"], round(float(s["t0"]), 6))
            if key in seen:
                continue
            seen.add(key)
            segments.append(dict(s))
    segments.sort(key=lambda s: float(s["t0"]))
    return {
        "jid": records[0].get("jid"),
        "uid": records[0].get("uid"),
        "t0": min(float(r.get("t0", 0.0)) for r in records),
        "outcome": outcome,
        "segments": segments,
        "sources": len(records),
    }


class JourneyLog:
    """Process-wide bounded rings of completed journeys and exported
    fragments, the source of the postmortem ``journeys.json``
    artifact."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        # RLock: a postmortem dump on the main thread may interrupt a
        # publish holding this
        self._lock = threading.RLock()
        self._completed: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))
        self._fragments: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))

    # -- producer side -------------------------------------------------------
    def publish(self, journey: Optional[Journey], outcome: str) -> None:
        """Flush a finished journey (idempotent: the first flush closes
        it; migration/handoff copies that already closed are skipped)."""
        if journey is None or journey.closed:
            return
        journey.closed = True
        rec = journey.to_dict()
        rec["outcome"] = outcome
        from . import metrics as tm
        tm.JOURNEY_FLUSHED.inc()
        for s in rec["segments"]:
            tm.JOURNEY_SEGMENT_MS.observe(s["ms"])
        with self._lock:
            self._completed.append(rec)
        from .flight_recorder import get_flight_recorder
        get_flight_recorder().record(
            "journey.flush", uid=rec["uid"], jid=rec["jid"],
            outcome=outcome, segments=len(rec["segments"]),
            total_ms=round(journey.total_ms(), 3))

    def publish_fragment(self, journey: Optional[Journey],
                         where: str) -> None:
        """Record the segment log AS EXPORTED at a process/pool
        boundary — the journey itself travels on inside the bundle;
        the fragment keeps the exporting side's view reconstructable
        even if the importer dies.  A fragment whose jid never
        completes anywhere is an ORPHAN."""
        if journey is None:
            return
        rec = journey.to_dict()
        rec["where"] = where
        from . import metrics as tm
        tm.JOURNEY_FRAGMENTS.inc()
        with self._lock:
            self._fragments.append(rec)
        from .flight_recorder import get_flight_recorder
        get_flight_recorder().record(
            "journey.fragment", uid=rec["uid"], jid=rec["jid"],
            where=where, segments=len(rec["segments"]))

    # -- consumer side -------------------------------------------------------
    def completed(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._completed)

    def fragments(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._fragments)

    def lookup(self, uid: int) -> Dict[str, Any]:
        """Everything this process knows about one uid."""
        with self._lock:
            comp = [r for r in self._completed if r["uid"] == uid]
            frag = [r for r in self._fragments if r["uid"] == uid]
        return {"uid": uid, "completed": comp, "fragments": frag}

    def orphans(self) -> List[str]:
        """jids with an exported fragment but no completion — requests
        that crossed a boundary and never finished anywhere."""
        with self._lock:
            done = {r["jid"] for r in self._completed}
            return sorted({r["jid"] for r in self._fragments}
                          - done)

    def dominant_segment(self, top_frac: float = 0.1
                         ) -> Optional[Dict[str, Any]]:
        """Attribution for the slowest ``top_frac`` of recent completed
        journeys: which segment kind dominates their time?  Feeds the
        SLO evaluator's page verdict ("page: latency, dominated by
        handoff_transfer")."""
        recs = self.completed()
        if not recs:
            return None
        # index tiebreaker: equal totals must never fall through to
        # comparing the record dicts themselves
        totals = sorted(
            (sum(s["ms"] for s in r["segments"]), i, r)
            for i, r in enumerate(recs))
        n = max(1, int(len(totals) * top_frac))
        slow = [r for _, _, r in totals[-n:]]
        by_seg: Dict[str, float] = {}
        for r in slow:
            for s in r["segments"]:
                by_seg[s["seg"]] = by_seg.get(s["seg"], 0.0) + s["ms"]
        total = sum(by_seg.values())
        if total <= 0.0:
            return None
        seg = max(by_seg, key=by_seg.get)
        return {"seg": seg, "share": round(by_seg[seg] / total, 4),
                "slow_journeys": len(slow)}

    def tail_json(self) -> Optional[Dict[str, Any]]:
        """The postmortem ``journeys.json`` document, or None when the
        process recorded no journeys (the artifact is skipped, like the
        ledger tail)."""
        with self._lock:
            comp = list(self._completed)
            frag = list(self._fragments)
        if not comp and not frag:
            return None
        return {"completed": comp, "fragments": frag}

    def resize(self, capacity: int) -> None:
        with self._lock:
            cap = max(int(capacity), 1)
            self._completed = collections.deque(self._completed,
                                                maxlen=cap)
            self._fragments = collections.deque(self._fragments,
                                                maxlen=cap)

    def clear(self) -> None:
        with self._lock:
            self._completed.clear()
            self._fragments.clear()


#: process-wide singleton
_LOG = JourneyLog()


def get_journey_log() -> JourneyLog:
    return _LOG
