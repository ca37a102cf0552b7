"""Prefix-affinity request router.

Counterpart of ``deepspeed_tpu/serving/router.py``.  Replicas publish a
bounded top-K slice of their prefix cache's chained page-digest index
(``PrefixCache.export_digests``: hex digests, never page contents).  The
router hashes an incoming prompt's full pages with the same chained
blake2b (``PrefixCache.chain``) and sends the request to the replica
whose hints hold the LONGEST leading run of its digests: that replica
already holds the pages, so it prefills only the uncached suffix.  Cold
prompts go to the least-backlogged replica; ties break by label, so
routing is deterministic under equal state.

A digest commits to every token of the pages before it, so a match of
length k is exact evidence of that k-page prefix.  Hints go stale
between publishes; staleness costs warmth, never correctness.
``pin(root_digest, label)`` overrides affinity for one digest group (the
rebalance action).  Policies: ``affinity`` (default), ``least_backlog``
(ignores hints), ``round_robin`` (ignores hints and backlogs).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..inference.v2.ragged.prefix_cache import PrefixCache

POLICIES = ("affinity", "least_backlog", "round_robin")


@dataclasses.dataclass
class RouteDecision:
    """One placement verdict: the chosen replica, how many leading
    prompt pages its published hints matched (0 = cold placement), and
    why (``affinity`` / ``pin`` / ``backlog`` / ``round_robin``)."""
    label: str
    matched_pages: int = 0
    reason: str = "backlog"
    #: cross-replica page fetch hint: when affinity lost to
    #: least-backlog, the peer that DID match — the chosen replica can
    #: stream the matched committed pages from it instead of
    #: recomputing the prefill
    fetch_from: Optional[str] = None
    #: the leading cumulative digest chain (hex, root first) the peer
    #: matched — exactly what ``StateManager.export_prefix`` consumes
    fetch_digests: List[str] = dataclasses.field(default_factory=list)


class PrefixAffinityRouter:
    """Route prompts to the replica already holding their prefix."""

    def __init__(self, page_size: int, top_k: int = 64,
                 policy: str = "affinity",
                 fetch_backlog_margin: int = -1):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.page_size = int(page_size)
        self.top_k = int(top_k)
        self.policy = policy
        #: when >= 0, an affinity match whose replica is backlogged more
        #: than ``margin`` requests past the least-loaded replica LOSES
        #: the placement: the request goes to least-backlog carrying a
        #: ``fetch_from`` hint, so the matched pages stream over instead
        #: of being recomputed.  -1 keeps the pure affinity-first rule
        self.fetch_backlog_margin = int(fetch_backlog_margin)
        self._lock = threading.RLock()
        #: label -> published digest hints (set for O(1) chain walk)
        self._hints: Dict[str, set] = {}
        #: root digest (hex) -> pinned label (rebalance overrides)
        self._pins: Dict[str, str] = {}
        #: root digest -> Counter(label) of affinity placements — the
        #: heat map rebalancing reads to find the hottest group
        self._heat: Dict[str, Counter] = {}
        self._rr = 0

    # -- hint publication ----------------------------------------------------
    def publish(self, label: str, digests: Sequence[str]) -> None:
        """Replace ``label``'s published hint slice (most recent first,
        as ``export_digests`` returns it; order is irrelevant to the
        chain walk, the bound is what matters)."""
        with self._lock:
            self._hints[label] = set(digests[:self.top_k])

    def forget(self, label: str) -> None:
        """Drop a removed/dead replica: its hints, pins, and heat."""
        with self._lock:
            self._hints.pop(label, None)
            self._pins = {d: lb for d, lb in self._pins.items()
                          if lb != label}
            for c in self._heat.values():
                c.pop(label, None)

    def pin(self, root_digest: str, label: str) -> None:
        """Force every prompt of one digest group (same first full
        page) onto ``label`` — the rebalance re-homing action."""
        with self._lock:
            self._pins[root_digest] = label

    def unpin(self, root_digest: str) -> None:
        with self._lock:
            self._pins.pop(root_digest, None)

    # -- the placement rule --------------------------------------------------
    def prompt_digests(self, prompt) -> List[str]:
        """The prompt's cumulative full-page digest chain as hex —
        EXACTLY the scheme the prefix cache indexes under
        (:meth:`~..inference.v2.ragged.prefix_cache.PrefixCache.chain`),
        so router matches and cache hits agree by construction."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        ps = self.page_size
        out: List[str] = []
        d = b""
        for i in range(len(prompt) // ps):
            d = PrefixCache.chain(d, prompt[i * ps:(i + 1) * ps])
            out.append(d.hex())
        return out

    def _match_len(self, digests: List[str], hints: set) -> int:
        n = 0
        for d in digests:
            if d not in hints:
                break
            n += 1
        return n

    def decide(self, prompt, backlogs: Dict[str, int]) -> RouteDecision:
        """Place one prompt among the live replicas (``backlogs`` maps
        every live label to its current request backlog).  Raises on an
        empty pool — the caller owns spawn-on-empty semantics."""
        if not backlogs:
            raise ValueError("no live replicas to route to")
        labels = sorted(backlogs)
        if self.policy == "round_robin":
            with self._lock:
                label = labels[self._rr % len(labels)]
                self._rr += 1
            return RouteDecision(label, 0, "round_robin")
        # hash OUTSIDE the lock: the chain is O(prompt) blake2b work
        # over no shared state, and holding the lock across it would
        # serialize every concurrent decide()/publish() on it
        digests = (self.prompt_digests(prompt)
                   if self.policy == "affinity" else [])
        with self._lock:
            if digests:
                pinned = self._pins.get(digests[0])
                if pinned in backlogs:
                    self._note_heat(digests[0], pinned)
                    return RouteDecision(
                        pinned,
                        self._match_len(digests,
                                        self._hints.get(pinned, set())),
                        "pin")
                best, best_match = None, 0
                for label in labels:
                    m = self._match_len(digests,
                                        self._hints.get(label, set()))
                    if m > best_match or (m == best_match and m > 0
                                          and best is not None
                                          and backlogs[label]
                                          < backlogs[best]):
                        best, best_match = label, m
                if best is not None and best_match > 0:
                    least = min(labels,
                                key=lambda lb: (backlogs[lb], lb))
                    if (self.fetch_backlog_margin >= 0
                            and least != best
                            and backlogs[best] - backlogs[least]
                            > self.fetch_backlog_margin):
                        # affinity loses to least-backlog:
                        # place on the idle replica, but hand it the
                        # matched peer + digest chain so the pool can
                        # FETCH the pages instead of recomputing them
                        self._note_heat(digests[0], least)
                        return RouteDecision(
                            least, 0, "backlog", fetch_from=best,
                            fetch_digests=digests[:best_match])
                    self._note_heat(digests[0], best)
                    return RouteDecision(best, best_match, "affinity")
            label = min(labels, key=lambda lb: (backlogs[lb], lb))
            if digests:
                self._note_heat(digests[0], label)
            return RouteDecision(label, 0, "backlog")

    def _note_heat(self, root: str, label: str) -> None:
        self._heat.setdefault(root, Counter())[label] += 1

    def hottest_group(self, label: str) -> Optional[str]:
        """The root digest most often routed to ``label`` (None when
        nothing was) — the rebalance victim-group selector."""
        with self._lock:
            best, best_n = None, 0
            for root, counts in self._heat.items():
                n = counts.get(label, 0)
                if n > best_n:
                    best, best_n = root, n
            return best


def fetch_remote_hints(target: str, top_k: int = 64,
                       timeout_s: float = 2.0) -> Dict:
    """Scrape one replica's ``/snapshot?digests=1`` affinity hint (the
    subprocess mode's hint source: a ``tools/fleet_replica`` child
    publishes its engine's hints at build, ``telemetry/server.py``).
    Returns ``{"page_size", "digests"}``; raises on an unreachable
    replica."""
    import json
    import urllib.request
    t = target if target.startswith(("http://", "https://")) \
        else "http://" + target
    url = f"{t.rstrip('/')}/snapshot?digests=1&top_k={int(top_k)}"
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read().decode())
