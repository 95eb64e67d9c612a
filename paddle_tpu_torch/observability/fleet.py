"""Fleet observability: federation, placement audit, per-replica SLO burn —
the port's copy of paddle_tpu/observability/fleet.py.

The :class:`~paddle_tpu_torch.serving.router.ReplicaRouter` makes N
engines one serving surface; this module makes them one TELEMETRY surface
without giving up per-replica attribution:

- **Scoped sources** — each replica's step thread runs under a
  :meth:`Registry.scoped(replica=name) <paddle_tpu_torch.observability.
  metrics.Registry.scoped>` view, so every engine instrument lands in a
  ``{replica=...}`` series of the ONE process registry.
  :func:`filter_snapshot` carves a per-replica snapshot back out — the
  same JSON snapshot format :func:`~.exposition.snapshot` emits, which
  is also what :func:`http_source` fetches from a remote process's
  ``/snapshot.json`` (a multi-process fleet federates through the
  identical code path).
- **Merging** — :func:`merge_snapshots`: counters sum across replicas,
  histogram buckets merge bucket-wise (quantiles then come from
  :func:`~.exposition.quantile` over the merged maps — exact, since the
  bounds are identical by construction), gauges stay per-replica-labeled
  (a queue depth does not sum into anything meaningful). Served as
  ``/fleet/metrics`` (Prometheus text), ``/fleet/replicas.json`` (the
  per-replica state table ``obs_dump --fleet`` renders), and
  ``/fleet/placements.json`` (the placement audit ring) on both the obs
  HTTP server and the serving front door.
- **Placement audit** — every router placement decision (candidate
  affinity scores, loads, the chosen replica, the reason) lands in a
  bounded ring (``FLAGS_obs_fleet_placements_capacity``) and as a
  flight-recorder event, so "why did this request land there" is
  answerable after the fact.
- **SLO burn-rate** — :func:`check_slo` computes per-replica TTFT/TPOT
  attainment from the replica-labeled histograms; burn rate is
  ``(1 - attainment) / (1 - target)`` against
  ``FLAGS_obs_fleet_slo_target`` — above 1.0 the replica is burning its
  error budget. Entering breach emits an ``slo_breach`` flight event +
  counter; with ``FLAGS_obs_fleet_slo_advisory`` on, the router's
  :meth:`check` demotes a burning replica to ``suspect`` (observability
  closing the loop into placement).

Stdlib-only and PEP 562-lazy in the package (its flags are defined
eagerly in ``observability/__init__`` so ``set_flags`` sees them before
this module ever loads). Names, flags, label sets, flight events and
JSON shapes equal the reference's, so one scraper or one
``tools/obs_dump.py`` reads either package.
"""
from __future__ import annotations

import collections
import json
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..framework.flags import get_flag, watch_flag
from . import state
from .catalog import instrument as _instrument
from .exposition import (fraction_at_or_below, quantile,
                         render_snapshot_prometheus, snapshot)
from .metrics import get_registry

__all__ = ["FleetAggregator", "PlacementLog", "filter_snapshot",
           "merge_snapshots", "http_source", "get_aggregator",
           "get_placement_log", "replica_slo", "check_slo",
           "replicas_payload", "placements_payload", "fleet_metrics_text"]

_M_SLO_ATTAIN = _instrument("serving_fleet_slo_attainment")
_M_SLO_BREACH = _instrument("serving_fleet_slo_breaches_total")
_M_SCRAPES = _instrument("serving_fleet_scrapes_total")
_M_TS_FALLBACK = _instrument("obs_ts_window_fallbacks_total")


# -- snapshot federation ----------------------------------------------------
def filter_snapshot(snap: Dict, **labels) -> Dict:
    """The sub-snapshot whose series carry all of ``labels`` (a
    replica's share of the process registry under fleet scoping). Family
    exemplars are process-global and would ride into every replica's
    share, so they are dropped here — the fleet merge never consumes
    them."""
    want = {k: str(v) for k, v in labels.items()}
    metrics = []
    for fam in snap.get("metrics", []):
        series = [s for s in fam.get("series", [])
                  if all(s.get("labels", {}).get(k) == v
                         for k, v in want.items())]
        if series:
            metrics.append({"name": fam["name"], "kind": fam["kind"],
                            "help": fam.get("help", ""), "series": series})
    return {"version": 1, "unix_time": snap.get("unix_time", time.time()),
            "scope": want, "metrics": metrics}


def merge_snapshots(snaps: Dict[str, Dict]) -> Dict:
    """Merge per-source snapshots into one fleet snapshot: counters sum
    and histogram buckets merge bucket-wise across sources (their
    ``replica`` label drops — the fleet total owns the series), gauges
    keep one series per source with ``replica`` stamped (defaulting to
    the source name for unscoped remote snapshots). A histogram whose
    bounds disagree with the fleet's (version skew across processes)
    stays separate under its source's replica label rather than merging
    apples into oranges."""
    fams: Dict[str, Dict] = {}
    order: List[str] = []
    for src in sorted(snaps):
        for fam in (snaps[src] or {}).get("metrics", []):
            name, kind = fam["name"], fam["kind"]
            f = fams.get(name)
            if f is None:
                f = fams[name] = {"name": name, "kind": kind,
                                  "help": fam.get("help", ""),
                                  "series": {}}
                order.append(name)
            if f["kind"] != kind:
                continue
            for s in fam.get("series", []):
                _merge_series(f["series"], kind, src, s)
    metrics = [{"name": n, "kind": fams[n]["kind"],
                "help": fams[n]["help"],
                "series": list(fams[n]["series"].values())}
               for n in order]
    return {"version": 1, "unix_time": time.time(),
            "fleet": sorted(snaps), "metrics": metrics}


def _merge_series(out: Dict[Tuple, Dict], kind: str, src: str,
                  s: Dict) -> None:
    labels = dict(s.get("labels", {}))
    if kind == "gauge":
        labels.setdefault("replica", src)
        row = {"labels": labels, "value": float(s.get("value", 0.0))}
        if s.get("updated"):
            row["updated"] = True
        out[tuple(sorted(labels.items()))] = row
        return
    labels.pop("replica", None)
    key = tuple(sorted(labels.items()))
    cur = out.get(key)
    if kind == "counter":
        v = float(s.get("value", 0.0))
        if cur is None:
            out[key] = {"labels": labels, "value": v}
        else:
            cur["value"] += v
        return
    bounds = [float(b) for b in s.get("bounds", [])]
    row = {"labels": labels, "bounds": bounds,
           "counts": list(s.get("counts", [])),
           "sum": float(s.get("sum", 0.0)), "count": int(s.get("count", 0))}
    if cur is None:
        out[key] = row
    elif cur["bounds"] == bounds and len(cur["counts"]) == \
            len(row["counts"]):
        cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                               row["counts"])]
        cur["sum"] += row["sum"]
        cur["count"] += row["count"]
    else:
        row["labels"] = dict(labels, replica=src)
        out[tuple(sorted(row["labels"].items()))] = row


def http_source(url: str, timeout: float = 5.0) -> Callable[[], Dict]:
    """A snapshot source reading a REMOTE process's ``/snapshot.json``
    (the obs HTTP server's JSON format — identical to the in-process
    one, so :func:`merge_snapshots` federates either transparently)."""
    base = url.rstrip("/")

    def fetch() -> Dict:
        import urllib.request

        with urllib.request.urlopen(f"{base}/snapshot.json",
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    return fetch


# -- placement audit ring ---------------------------------------------------
class PlacementLog:
    """Bounded ring of router placement decisions: who won a
    request, what every candidate's affinity score and load looked
    like, and why — the audit trail behind /fleet/placements.json."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None \
            else int(get_flag("obs_fleet_placements_capacity"))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self.recorded = 0

    def record(self, **fields) -> None:
        if not state.enabled():
            return
        entry = {"t": time.time(), **fields}
        with self._lock:
            self._ring.append(entry)
            self.recorded += 1

    def entries(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = collections.deque(self._ring,
                                           maxlen=int(capacity))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.recorded = 0


# -- per-replica SLO burn-rate ---------------------------------------------
def _find_child(fam, **labels):
    """A family's child for an exact label set WITHOUT creating it
    (``labels()`` is get-or-create; a read path must not mint empty
    series for replicas that never observed anything)."""
    want = {k: str(v) for k, v in labels.items()}
    for child in fam.series():
        if child.labels == want:
            return child
    return None


# (replica, slo) -> currently in breach; entering breach (False->True)
# is the edge that emits the flight event + counter
_breach_state: Dict[Tuple[str, str], bool] = {}


def replica_slo(name: str, registry=None) -> Dict[str, Optional[float]]:
    """One replica's TTFT/TPOT attainment + burn rate from its
    replica-labeled histograms. ``None`` fields where it has no
    observations yet. Burn rate is the worst of the two SLOs."""
    reg = registry or get_registry()
    target = min(float(get_flag("obs_fleet_slo_target")), 0.9999)
    out: Dict[str, Optional[float]] = {"ttft_attainment": None,
                                       "tpot_attainment": None,
                                       "burn_rate": None}
    burns = []
    for slo, metric, flag in (("ttft", "serving_ttft_seconds",
                               "obs_slo_ttft_ms"),
                              ("tpot", "serving_tpot_seconds",
                               "obs_slo_tpot_ms")):
        child = _find_child(reg.histogram(metric), replica=name)
        if child is None or not child.count:
            continue
        with child._lock:
            counts = list(child.counts)
        att = fraction_at_or_below(child.bounds, counts,
                                   float(get_flag(flag)) / 1e3)
        if att is None:
            continue
        out[f"{slo}_attainment"] = att
        burns.append((1.0 - att) / (1.0 - target))
    if burns:
        out["burn_rate"] = max(burns)
    return out


def _windowed_burn(store, metric: str, name: str, thr_s: float,
                   target: float, min_n: int):
    """(attainment, burn, window) over the fast window, confirmed by
    the slow window (SRE multi-window: fast catches the spike, slow —
    clamped to available history on a young process — confirms it is
    sustained). ``None`` when ring history or window traffic is too
    thin to judge — the caller falls back to cumulative, counted."""
    fast_s = float(get_flag("obs_ts_fast_window_s"))
    fast = store.windowed_burn(metric, thr_s, target, fast_s,
                               replica=name)
    if fast is None or fast["count"] < min_n:
        return None
    slow = store.windowed_burn(metric, thr_s, target,
                               float(get_flag("obs_ts_slow_window_s")),
                               clamp=True, replica=name)
    burn_slow = slow["burn"] if slow is not None else fast["burn"]
    return {"attainment": fast["attainment"], "burn": fast["burn"],
            "breach": fast["burn"] > 1.0 and burn_slow > 1.0,
            "window_s": fast_s}


def check_slo(names, registry=None) -> Set[str]:
    """One fleet SLO tick over ``names`` (the router's replicas):
    refresh the per-replica attainment gauges, emit ``slo_breach``
    flight events + counters on entering breach, and return the set of
    replicas currently burning their budget. The burn is
    WINDOWED (fast window catches, slow window confirms — a replica
    degrading after an hour of good traffic no longer dilutes its
    breach into the lifetime average); when the time-series ring is too
    short the lifetime computation answers instead, counted as
    ``obs_ts_window_fallbacks_total{query="slo"}``. The router's
    :meth:`check` feeds this back as an advisory suspect signal when
    ``FLAGS_obs_fleet_slo_advisory`` is on."""
    if not state.enabled():
        return set()
    from . import flight_recorder as _flight
    from . import timeseries as _ts

    reg = registry or get_registry()
    store = _ts.get_store()
    target = min(float(get_flag("obs_fleet_slo_target")), 0.9999)
    min_n = int(get_flag("obs_fleet_slo_min_requests"))
    burning: Set[str] = set()
    for name in names:
        for slo, metric, flag in (("ttft", "serving_ttft_seconds",
                                   "obs_slo_ttft_ms"),
                                  ("tpot", "serving_tpot_seconds",
                                   "obs_slo_tpot_ms")):
            thr_s = float(get_flag(flag)) / 1e3
            win = _windowed_burn(store, metric, name, thr_s, target,
                                 min_n)
            if win is not None:
                att, burn = win["attainment"], win["burn"]
                breach = win["breach"]
                window_s = win["window_s"]
            else:
                child = _find_child(reg.histogram(metric), replica=name)
                if child is None or child.count < min_n:
                    _breach_state.pop((name, slo), None)
                    continue
                _M_TS_FALLBACK.inc(query="slo")
                with child._lock:
                    counts = list(child.counts)
                att = fraction_at_or_below(child.bounds, counts, thr_s)
                if att is None:
                    continue
                burn = (1.0 - att) / (1.0 - target)
                breach = burn > 1.0
                window_s = None
            _M_SLO_ATTAIN.set(att, replica=name, slo=slo)
            if breach:
                burning.add(name)
                if not _breach_state.get((name, slo)):
                    _M_SLO_BREACH.inc(replica=name, slo=slo)
                    _flight.record("slo_breach", replica=name, slo=slo,
                                   attainment=round(att, 4),
                                   burn_rate=round(burn, 3),
                                   target=target,
                                   window_s=window_s)
            _breach_state[(name, slo)] = breach
    return burning


# -- the aggregator ---------------------------------------------------------
class FleetAggregator:
    """Federates N registry snapshots into one fleet view.

    Sources are ``name -> callable returning a snapshot dict``. An
    attached :class:`~paddle_tpu_torch.serving.router.ReplicaRouter` (held
    weakly — the aggregator is a process singleton, the router is not)
    contributes one in-process scoped source per replica automatically;
    :func:`http_source` adds remote processes through the same format.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Dict]] = {}
        self._router_ref: Optional[Callable] = None

    # -- sources -----------------------------------------------------------
    def attach_router(self, router) -> None:
        self._router_ref = weakref.ref(router)

    def detach_router(self, router=None) -> None:
        if router is None or self.router() is router:
            self._router_ref = None

    def router(self):
        return self._router_ref() if self._router_ref is not None else None

    def add_source(self, name: str, fn: Callable[[], Dict]) -> None:
        with self._lock:
            self._sources[name] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def clear_sources(self) -> None:
        with self._lock:
            self._sources.clear()

    def replica_names(self) -> List[str]:
        """Replica names in view: the attached router's, else every
        value of a ``replica`` label in the registry (a fleet observed
        from its metrics alone)."""
        router = self.router()
        if router is not None:
            return list(router.replicas)
        names: Set[str] = set()
        for fam in get_registry().families():
            for child in fam.series():
                r = child.labels.get("replica")
                if r is not None:
                    names.add(r)
        return sorted(names)

    def snapshots(self) -> Dict[str, Dict]:
        """One snapshot per source: every replica in view (the attached
        router's, else whoever stamped a ``replica`` label) as a scoped
        carve-out of the process registry, plus every explicit source
        (a failing remote source contributes an empty snapshot rather
        than failing the whole scrape)."""
        out: Dict[str, Dict] = {}
        names = self.replica_names()
        if names:
            full = snapshot(get_registry())
            for name in names:
                out[name] = filter_snapshot(full, replica=name)
        with self._lock:
            sources = dict(self._sources)
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception:
                out[name] = {"version": 1, "metrics": [],
                             "error": "source_unavailable"}
        return out

    # -- merged views ------------------------------------------------------
    def merged(self, snaps: Optional[Dict[str, Dict]] = None) -> Dict:
        return merge_snapshots(self.snapshots() if snaps is None
                               else snaps)

    def prometheus(self) -> str:
        _M_SCRAPES.inc(endpoint="metrics")
        return render_snapshot_prometheus(self.merged())

    def fleet_counter_value(self, name: str,
                            snaps: Optional[Dict[str, Dict]] = None,
                            **labels) -> float:
        """The fleet-aggregated value of one counter (summed across
        every label set matching ``labels``)."""
        want = {k: str(v) for k, v in labels.items()}
        total = 0.0
        for fam in self.merged(snaps).get("metrics", []):
            if fam["name"] != name or fam["kind"] != "counter":
                continue
            for s in fam["series"]:
                if all(s["labels"].get(k) == v for k, v in want.items()):
                    total += float(s["value"])
        return total

    def fleet_quantile(self, name: str, q: float) -> Optional[float]:
        """A quantile over the fleet-merged buckets of one histogram
        (exposition.quantile over the merged maps)."""
        for fam in self.merged().get("metrics", []):
            if fam["name"] != name or fam["kind"] != "histogram":
                continue
            for s in fam["series"]:
                if not s["labels"]:
                    return quantile(s["bounds"], s["counts"], q)
        return None

    # -- dashboard payloads -------------------------------------------------
    def replicas_payload(self) -> Dict:
        """The ``/fleet/replicas.json`` document ``obs_dump --fleet``
        renders: one row per replica (state, disagg role, streams,
        queue/slots, tokens, p95 TTFT/TPOT, cache hit rate, SLO burn)
        + fleet totals."""
        from . import timeseries as _ts

        _M_SCRAPES.inc(endpoint="replicas")
        reg = get_registry()
        router = self.router()
        now = router._now() if router is not None else None
        rows = []
        for name in self.replica_names():
            row: Dict = {"replica": name}
            if router is not None:
                rep = router.replicas.get(name)
                if rep is not None:
                    with router._lock:
                        row.update({
                            "state": rep.state,
                            "role": rep.role,
                            "hb_age_s": round(max(0.0, now - rep.hb), 3),
                            "streams": len(rep.owned),
                            "dispatches": rep.dispatches,
                            "steps": rep.steps,
                            "load": round(sum(rep.load.values()), 1),
                        })
            row.update(self._replica_metrics(reg, name))
            row["slo"] = replica_slo(name, reg)
            # per-replica tok/s trend from the time-series ring —
            # the sparkline column obs_dump --fleet renders
            row["spark"] = [round(v, 1) for v in _ts.get_store()
                            .rate_series("serving_tokens_total", n=12,
                                         replica=name)]
            rows.append(row)
        doc = {"version": 1, "unix_time": time.time(),
               "router": router is not None, "replicas": rows,
               "totals": {
                   "replicas": len(rows),
                   "tokens": sum(r.get("tokens", 0) for r in rows),
                   "streams": sum(r.get("streams", 0) for r in rows),
               }}
        if router is not None:
            states = router.states()
            doc["totals"]["healthy"] = \
                sum(1 for s in states.values() if s == "healthy")
            doc["totals"]["live_streams"] = router.live_streams()
        return doc

    @staticmethod
    def _replica_metrics(reg, name: str) -> Dict:
        """One replica's engine-side readings straight from its scoped
        series (no cross-thread engine access)."""
        out: Dict = {}

        def val(metric, kind="counter"):
            fam = (reg.counter(metric) if kind == "counter"
                   else reg.gauge(metric))
            child = _find_child(fam, replica=name)
            return child.value if child is not None else None

        tokens = val("serving_tokens_total")
        if tokens is not None:
            out["tokens"] = int(tokens)
        q = val("serving_queue_depth", "gauge")
        if q is not None:
            out["queue_depth"] = int(q)
        slots = val("serving_active_slots", "gauge")
        if slots is not None:
            out["active_slots"] = int(slots)
        hits = val("serving_prefix_cache_hits_total")
        misses = val("serving_prefix_cache_misses_total")
        if hits is not None or misses is not None:
            total = (hits or 0.0) + (misses or 0.0)
            if total > 0:
                out["cache_hit_rate"] = round((hits or 0.0) / total, 3)
        for key, metric, q_ in (("ttft_p95_ms", "serving_ttft_seconds",
                                 0.95),
                                ("tpot_p95_ms", "serving_tpot_seconds",
                                 0.95),
                                ("tok_s_p50", "serving_tokens_per_second",
                                 0.5)):
            child = _find_child(reg.histogram(metric), replica=name)
            if child is None or not child.count:
                continue
            with child._lock:
                counts = list(child.counts)
            v = quantile(child.bounds, counts, q_)
            if v is not None:
                out[key] = round(v * 1e3, 2) if key.endswith("_ms") \
                    else round(v, 1)
        return out

    def placements_payload(self) -> Dict:
        _M_SCRAPES.inc(endpoint="placements")
        log = get_placement_log()
        return {"version": 1, "unix_time": time.time(),
                "recorded": log.recorded,
                "placements": log.entries()}


_default_aggregator = FleetAggregator()
_default_placement_log = PlacementLog()

watch_flag("obs_fleet_placements_capacity",
           lambda v: _default_placement_log.set_capacity(int(v)))


def get_aggregator() -> FleetAggregator:
    return _default_aggregator


def get_placement_log() -> PlacementLog:
    return _default_placement_log


# -- endpoint bodies (shared by the obs server and the front door) ----------
def fleet_metrics_text() -> str:
    return get_aggregator().prometheus()


def replicas_payload() -> Dict:
    return get_aggregator().replicas_payload()


def placements_payload() -> Dict:
    return get_aggregator().placements_payload()
