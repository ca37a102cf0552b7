"""Fleet federation: N replica registries as ONE view.

Counterpart of ``deepspeed_tpu/telemetry/federation.py`` (plain Python,
``urllib`` and a thread pool, the same merge).  Each serving replica is a
process with its own metrics registry on its own (ephemeral) port.  A
controller (a replica-pool autoscaler, ``python -m
deepspeed_tpu_torch.tools.fleetctl``, or a Prometheus scraping
``/fleet``) needs them merged, and the merge rules follow from the metric
kinds:

- **counters sum** — lifetime totals are additive across replicas;
- **gauges keep per-replica series** plus min/max/sum rollups (a
  fleet-mean MFU hides the one replica at 0; the rollups don't);
- **histograms merge EXACTLY** — every replica's log-bucketed
  histograms share the same fixed geometric boundaries (minted once in
  :mod:`.registry`), so bucket counts add as integers and
  merged-then-percentile is bit-equal to a single registry observing
  the union of all replicas' samples
  (:func:`~.registry.percentile_from_counts` is the one shared
  implementation).

Sources are either HTTP targets (a replica's ``/snapshot?raw=1``
endpoint — the structured :meth:`~.registry.MetricsRegistry
.raw_snapshot` body) or in-process :class:`MetricsRegistry` objects
(same-process pools, tests).

**Degradation is coherent**: a replica that stops answering is flagged
``stale`` with its age, and its LAST-GOOD snapshot stays in the merge —
fleet counters remain monotone through a replica kill instead of
dropping by the dead replica's lifetime contribution.  (A replica that
legitimately restarts re-reports from zero; sums dip exactly once, as
they should.)

Exposed as ``ds_fleet_*`` Prometheus text and JSON on the local
server's ``/fleet`` endpoint; targets configured via
``telemetry.fleet_targets`` (shared ``apply_settings``) or
``DS_FLEET_TARGETS="r0=host:port,r1=host:port"`` (labels optional).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from .registry import percentile_from_counts

#: a replica is stale once its last successful scrape is older than this
DEFAULT_STALE_AFTER_S = 10.0
#: per-target HTTP scrape timeout
SCRAPE_TIMEOUT_S = 2.0


class _Replica:
    __slots__ = ("label", "url", "registry", "last_raw", "last_ok",
                 "last_err", "scrapes", "failures", "prev_raw",
                 "prev_ok")

    def __init__(self, label: str, url: Optional[str] = None,
                 registry=None):
        self.label = label
        self.url = url
        self.registry = registry
        self.last_raw: Optional[Dict[str, Any]] = None
        self.last_ok = 0.0          # monotonic stamp of last success
        self.last_err = ""
        self.scrapes = 0
        self.failures = 0
        #: the success BEFORE last_raw (captured at scrape time, so
        #: replica_rates is a pure read any number of consumers share)
        self.prev_raw: Optional[Dict[str, Any]] = None
        self.prev_ok = 0.0


def _normalize_url(target: str) -> str:
    t = target.strip()
    if not t.startswith(("http://", "https://")):
        t = "http://" + t
    return t.rstrip("/")


class Federation:
    """Scrape-and-merge over a set of replica metric sources."""

    def __init__(self, stale_after_s: float = DEFAULT_STALE_AFTER_S):
        self.stale_after_s = float(stale_after_s)
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}

    # -- membership ----------------------------------------------------------
    def add_http(self, label: str, target: str) -> None:
        """Register a replica by HTTP target (``host:port`` or URL)."""
        with self._lock:
            self._replicas[label] = _Replica(
                label, url=_normalize_url(target))

    def add_registry(self, label: str, registry) -> None:
        """Attach an in-process registry (same-process pools, tests)."""
        with self._lock:
            self._replicas[label] = _Replica(label, registry=registry)

    def remove(self, label: str) -> None:
        with self._lock:
            self._replicas.pop(label, None)

    def clear(self) -> None:
        with self._lock:
            self._replicas.clear()

    def labels(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def configure_targets(self, targets: str) -> None:
        """Comma-separated ``[label=]host:port`` list (config/env form).
        Unlabeled entries get ``r0``, ``r1``, ... by position.  Replaces
        the current membership."""
        entries = [t.strip() for t in targets.split(",") if t.strip()]
        with self._lock:
            self._replicas.clear()
            for i, entry in enumerate(entries):
                if "=" in entry:
                    label, _, target = entry.partition("=")
                    label = label.strip()
                else:
                    label, target = f"r{i}", entry
                self._replicas[label] = _Replica(
                    label, url=_normalize_url(target))

    # -- scraping ------------------------------------------------------------
    def _fetch(self, rep: _Replica) -> Dict[str, Any]:
        if rep.registry is not None:
            return rep.registry.raw_snapshot()
        with urllib.request.urlopen(rep.url + "/snapshot?raw=1",
                                    timeout=SCRAPE_TIMEOUT_S) as r:
            return json.loads(r.read().decode())

    def scrape(self) -> Dict[str, Any]:
        """Scrape every replica and return the merged fleet view (see
        module docstring for the merge/staleness rules).  The HTTP
        fetches run OUTSIDE the lock (a slow replica must not stall a
        concurrent caller); the replica-state updates and the merge run
        inside it — every `/fleet` request on the ThreadingHTTPServer
        is a full scrape, and two interleaving threads must not corrupt
        the prev/last snapshot pair replica_rates reads."""
        with self._lock:
            reps = list(self._replicas.values())

        def fetch_one(rep):
            try:
                raw = self._fetch(rep)
                if not isinstance(raw, dict) or "counters" not in raw:
                    raise ValueError("not a raw snapshot body "
                                     "(needs /snapshot?raw=1)")
                return rep, raw, None
            except Exception as e:  # noqa: BLE001 — any replica may die
                return rep, None, f"{type(e).__name__}: {e}"

        if len(reps) <= 1:
            results = [fetch_one(r) for r in reps]
        else:
            # concurrent fetches: k blackholed replicas must cost one
            # scrape ~SCRAPE_TIMEOUT_S total, not k timeouts in series
            # (every /fleet request and every fleet time-series sample
            # pays this latency)
            with ThreadPoolExecutor(
                    max_workers=min(len(reps), 16)) as pool:
                results = list(pool.map(fetch_one, reps))
        now = time.monotonic()
        with self._lock:
            for rep, raw, err in results:
                rep.scrapes += 1
                if err is not None:
                    rep.failures += 1
                    rep.last_err = err
                    continue
                if rep.last_raw is not None and rep.last_ok < now:
                    rep.prev_raw = rep.last_raw
                    rep.prev_ok = rep.last_ok
                rep.last_raw = raw
                rep.last_ok = now
                rep.last_err = ""
            return self._merge(reps, now)

    def _merge(self, reps: List[_Replica], now: float) -> Dict[str, Any]:
        counters: Dict[str, float] = {}
        gauges: Dict[str, Dict[str, Any]] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        replicas: Dict[str, Dict[str, Any]] = {}
        notes: List[str] = []
        live = stale = 0
        for rep in sorted(reps, key=lambda r: r.label):
            age = (now - rep.last_ok) if rep.last_ok else None
            is_stale = age is None or age > self.stale_after_s
            live += not is_stale
            stale += is_stale
            replicas[rep.label] = {
                "target": rep.url or "<in-process>",
                "stale": bool(is_stale),
                "age_s": round(age, 3) if age is not None else None,
                "error": rep.last_err or None,
                "scrapes": rep.scrapes,
                "failures": rep.failures,
            }
            raw = rep.last_raw
            if raw is None:
                continue        # never scraped successfully: no data
            for name, v in raw.get("counters", {}).items():
                counters[name] = counters.get(name, 0) + v
            for name, v in raw.get("gauges", {}).items():
                g = gauges.setdefault(
                    name, {"per_replica": {}, "min": None, "max": None,
                           "sum": 0.0})
                g["per_replica"][rep.label] = v
                g["min"] = v if g["min"] is None else min(g["min"], v)
                g["max"] = v if g["max"] is None else max(g["max"], v)
                g["sum"] += v
            for name, h in raw.get("hists", {}).items():
                m = hists.get(name)
                if m is None:
                    hists[name] = {"bounds": list(h["bounds"]),
                                   "counts": list(h["counts"]),
                                   "count": int(h["count"]),
                                   "sum": float(h["sum"])}
                    continue
                if m["bounds"] != list(h["bounds"]):
                    # never merge across mismatched boundaries — the
                    # exactness claim is the whole point
                    notes.append(
                        f"{name}: bucket boundaries differ on "
                        f"{rep.label} — excluded from the merge")
                    continue
                m["counts"] = [a + b for a, b in
                               zip(m["counts"], h["counts"])]
                m["count"] += int(h["count"])
                m["sum"] += float(h["sum"])
        self._record_fleet_gauges(live, stale)
        return {"unix": time.time(), "replicas": replicas,
                "live": live, "stale": stale, "notes": notes,
                "counters": counters, "gauges": gauges, "hists": hists}

    @staticmethod
    def _record_fleet_gauges(live: int, stale: int) -> None:
        from . import metrics as tm
        tm.FLEET_REPLICAS_LIVE.set(live)
        tm.FLEET_REPLICAS_STALE.set(stale)

    # -- derived views -------------------------------------------------------
    def merged_raw(self) -> Dict[str, Any]:
        """One scrape as a ``raw_snapshot``-shaped dict — the adapter
        that lets a :class:`~.timeseries.TimeSeries` ring sample the
        FLEET instead of the local registry (fleet-level burn rates).
        Gauges flatten to their across-replica sum (counter-like uses:
        queue depths, running counts); per-replica detail lives in
        :meth:`scrape`."""
        view = self.scrape()
        return {
            "counters": view["counters"],
            "gauges": {n: g["sum"] for n, g in view["gauges"].items()},
            "hists": view["hists"],
        }

    def snapshot_json(self) -> Dict[str, Any]:
        """The `/fleet?json=1` body: the merged view with histograms
        ALSO flattened to percentiles (raw bucket counts stay in
        ``hists`` for exact re-merging up another level)."""
        view = self.scrape()
        flat: Dict[str, float] = dict(view["counters"])
        for name, h in view["hists"].items():
            flat[f"{name}_p50"] = percentile_from_counts(
                h["bounds"], h["counts"], h["count"], 50)
            flat[f"{name}_p90"] = percentile_from_counts(
                h["bounds"], h["counts"], h["count"], 90)
            flat[f"{name}_p99"] = percentile_from_counts(
                h["bounds"], h["counts"], h["count"], 99)
            flat[f"{name}_count"] = h["count"]
        view["merged"] = flat
        return view

    def prometheus_text(self) -> str:
        """The `/fleet` text exposition: every merged metric re-minted
        under the ``ds_fleet_`` prefix (``ds_fastgen_ttft_ms`` →
        ``ds_fleet_fastgen_ttft_ms``), gauges as labeled per-replica
        series plus ``_min/_max/_sum`` rollups."""
        view = self.scrape()
        lines: List[str] = []

        def fleet_name(name: str) -> str:
            return "ds_fleet_" + (name[3:] if name.startswith("ds_")
                                  else name)

        lines.append(f"# HELP ds_fleet_replicas_live replicas answering "
                     f"scrapes (of {len(view['replicas'])})")
        lines.append("# TYPE ds_fleet_replicas_live gauge")
        lines.append(f"ds_fleet_replicas_live {view['live']}")
        lines.append("# TYPE ds_fleet_replicas_stale gauge")
        lines.append(f"ds_fleet_replicas_stale {view['stale']}")
        for label, st in sorted(view["replicas"].items()):
            lines.append(
                f'ds_fleet_replica_up{{replica="{label}"}} '
                f'{0 if st["stale"] else 1}')
        for name, v in sorted(view["counters"].items()):
            fn = fleet_name(name)
            lines.append(f"# TYPE {fn} counter")
            lines.append(f"{fn} {v}")
        for name, g in sorted(view["gauges"].items()):
            fn = fleet_name(name)
            lines.append(f"# TYPE {fn} gauge")
            for label, v in sorted(g["per_replica"].items()):
                lines.append(f'{fn}{{replica="{label}"}} {v}')
            lines.append(f"{fn}_min {g['min']}")
            lines.append(f"{fn}_max {g['max']}")
            lines.append(f"{fn}_sum {g['sum']}")
        for name, h in sorted(view["hists"].items()):
            fn = fleet_name(name)
            lines.append(f"# TYPE {fn} histogram")
            cum = 0
            for b, c in zip(h["bounds"], h["counts"]):
                cum += c
                lines.append(f'{fn}_bucket{{le="{b:g}"}} {cum}')
            lines.append(f'{fn}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{fn}_sum {h['sum']}")
            lines.append(f"{fn}_count {h['count']}")
        return "\n".join(lines) + "\n"

    def replica_rates(self, counter: str) -> Dict[str, Optional[float]]:
        """Per-replica increase/s of one counter between the last two
        successful scrapes of each replica — the imbalance signal the
        SLO evaluator's ``balance`` objective reads.  A PURE read (the
        scrape-time prev/last snapshot pair is the state), so any
        number of consumers — multiple balance objectives, fleetctl,
        diagnostics — see the same rates.  Replicas without two
        successful scrapes map to None."""
        with self._lock:
            reps = list(self._replicas.values())
        out: Dict[str, Optional[float]] = {}
        for rep in reps:
            cur = (rep.last_raw or {}).get("counters", {}).get(counter)
            prev = (rep.prev_raw or {}).get("counters", {}).get(counter)
            dt = rep.last_ok - rep.prev_ok
            if cur is None or prev is None or rep.prev_ok == 0.0 \
                    or dt <= 0:
                out[rep.label] = None
            else:
                out[rep.label] = max(0.0, (cur - prev) / dt)
        return out


#: process-wide singleton (the local server's /fleet endpoint)
_FEDERATION = Federation()


def get_federation() -> Federation:
    return _FEDERATION


def maybe_configure_from_env() -> bool:
    """Honor ``DS_FLEET_TARGETS`` as soon as telemetry is imported."""
    import os
    targets = os.environ.get("DS_FLEET_TARGETS", "")
    if not targets:
        return False
    _FEDERATION.configure_targets(targets)
    return True
