"""Time-series layer: metrics history, windowed alerting, anomaly watchers
— the port's copy of paddle_tpu/observability/timeseries.py.

Every other telemetry surface is point-in-time: cumulative
counters, last-value gauges, since-process-start histogram quantiles.
:func:`~.fleet.check_slo`'s burn rate over the whole process lifetime
means a replica that degrades after an hour of good traffic dilutes its
breach into invisibility. This module adds the missing axis — TIME:

- **Ring-buffer TSDB** — :class:`TimeSeriesStore` keeps a bounded ring
  of registry snapshots (the exact :func:`~.exposition.snapshot` JSON
  shape, so a federated :func:`~.fleet.merge_snapshots` fleet view
  samples through the identical parser). Sampling rides the engine /
  router step tick via :func:`step_tick` — throttled by
  ``FLAGS_obs_ts_interval_s``, capacity live-resizable through
  ``FLAGS_obs_ts_capacity`` (watch_flag), near-zero when obs is off.
- **Windowed queries** — :meth:`~TimeSeriesStore.delta`,
  :meth:`~TimeSeriesStore.rate`, and windowed histogram quantiles
  (:meth:`~TimeSeriesStore.window_quantile`) computed from BUCKET-COUNT
  DELTAS between the newest sample and the newest sample at least
  ``window`` old. Bucket deltas are integer count differences, so the
  windowed quantile is EXACT under the fleet merge semantics: quantile
  over (merged counts at t1 - merged counts at t0) equals
  :func:`~.exposition.quantile` on a registry that only ever saw that
  window's traffic (test-enforced both single-replica and fleet-union).
- **Multi-window burn-rate alerts** — :class:`AlertEngine` evaluates
  declarative :class:`AlertSpec` rows. SRE-style burn alerts fire only
  when BOTH the fast and the slow window burn (fast catches the spike,
  slow confirms it is sustained); anomaly watchers (spec-acceptance
  collapse, prefix-hit-rate drop, offload stall spike, shed-rate spike,
  disagg relay degradation, per-replica tok/s divergence vs the fleet
  median) are windowed threshold specs over the same store. Edges
  (firing / cleared) land as flight events +
  ``obs_alerts_total{alert,state}`` counters, and ``/alerts.json``
  serves the table on both the obs HTTP server and the front door.
- **History persistence** — each tick appends the derived-signal vector
  to a bounded in-memory tail and (``FLAGS_obs_ts_dir``) a bounded
  JSONL ring; the tail embeds into flight-recorder post-mortems so a
  crash dump shows the TRAJECTORY into the failure, not just the final
  snapshot.

Stdlib-only and PEP 562-lazy in the package (flags are defined eagerly
in ``observability/__init__`` so ``set_flags`` sees them first). Alert
names, flags, flight events and JSON shapes equal the reference's.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..framework.flags import get_flag, watch_flag
from . import state
from .catalog import instrument as _instrument
from .exposition import fraction_at_or_below, quantile, snapshot
from .metrics import get_registry

__all__ = ["Sample", "TimeSeriesStore", "AlertSpec", "AlertEngine",
           "default_specs", "get_store", "get_alert_engine", "step_tick",
           "tick", "alerts_payload", "history_payload", "reset"]

_M_SAMPLES = _instrument("obs_ts_samples_total")
_M_RING = _instrument("obs_ts_ring_size")
_M_ALERTS = _instrument("obs_alerts_total")


# -- samples ----------------------------------------------------------------
class Sample:
    """One parsed registry snapshot: scalar values per (name, labelset)
    for counters/gauges, (counts, sum, count) per histogram series."""

    __slots__ = ("t", "counters", "gauges", "hists")

    def __init__(self, t: float):
        self.t = t
        self.counters: Dict[Tuple[str, Tuple], float] = {}
        self.gauges: Dict[Tuple[str, Tuple], float] = {}
        self.hists: Dict[Tuple[str, Tuple],
                         Tuple[Tuple[int, ...], float, int]] = {}

    @classmethod
    def parse(cls, snap: Dict, t: float,
              bounds_out: Optional[Dict] = None) -> "Sample":
        out = cls(t)
        for fam in snap.get("metrics", []):
            name, kind = fam.get("name"), fam.get("kind")
            for s in fam.get("series", []):
                key = (name, tuple(sorted(
                    (s.get("labels") or {}).items())))
                if kind == "counter":
                    out.counters[key] = float(s.get("value", 0.0))
                elif kind == "gauge":
                    out.gauges[key] = float(s.get("value", 0.0))
                elif kind == "histogram":
                    out.hists[key] = (
                        tuple(int(c) for c in s.get("counts", [])),
                        float(s.get("sum", 0.0)),
                        int(s.get("count", 0)))
                    if bounds_out is not None:
                        bounds_out[key] = [float(b)
                                           for b in s.get("bounds", [])]
        return out


def _match(key: Tuple[str, Tuple], name: str, want: Dict[str, str]) -> bool:
    if key[0] != name:
        return False
    if not want:
        return True
    have = dict(key[1])
    return all(have.get(k) == v for k, v in want.items())


# -- the store --------------------------------------------------------------
class TimeSeriesStore:
    """Bounded ring of :class:`Sample` rows over a snapshot source
    (default: the process registry; a federated source — e.g.
    ``lambda: merge_snapshots(agg.snapshots())`` — works identically).

    Query ``now`` defaults to the NEWEST sample's timestamp, so
    synthetic-clock tests and live serving read through one code path.
    Counter resets (a series' value moving backwards) are handled the
    Prometheus way: the post-reset value stands in for the delta.
    """

    def __init__(self, capacity: Optional[int] = None,
                 source: Optional[Callable[[], Dict]] = None,
                 now_fn: Callable[[], float] = time.time):
        cap = capacity if capacity is not None \
            else int(get_flag("obs_ts_capacity"))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._bounds: Dict[Tuple[str, Tuple], List[float]] = {}
        self._source = source
        self._now = now_fn
        self.sampled = 0

    # -- writes -------------------------------------------------------------
    def sample(self, snap: Optional[Dict] = None,
               t: Optional[float] = None) -> Sample:
        if snap is None:
            snap = self._source() if self._source is not None \
                else snapshot(get_registry())
        row = Sample.parse(snap, self._now() if t is None else t,
                           bounds_out=self._bounds)
        with self._lock:
            self._ring.append(row)
            self.sampled += 1
            n = len(self._ring)
        # .labels() is direct child access: the sampler may run on a
        # replica-scoped step thread, and its own bookkeeping must stay
        # one process-global series, not fan out per replica
        _M_SAMPLES.labels().inc()
        _M_RING.labels().set(float(n))
        return row

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = collections.deque(self._ring,
                                           maxlen=max(2, int(capacity)))
            n = len(self._ring)
        _M_RING.labels().set(float(n))       # a shrink evicts immediately

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._bounds.clear()
            self.sampled = 0

    # -- sample selection ---------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def samples(self) -> List[Sample]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> Optional[Sample]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def _window_pair(self, window: float, now: Optional[float],
                     clamp: bool) -> Optional[Tuple[Sample, Sample]]:
        """(baseline, latest): the newest sample at least ``window``
        older than ``now`` vs the newest sample. ``clamp`` falls back to
        the OLDEST sample when history is shorter than the window (a
        young process's slow window covers what exists)."""
        with self._lock:
            if len(self._ring) < max(
                    2, int(get_flag("obs_ts_min_samples"))):
                return None
            rows = list(self._ring)
        latest = rows[-1]
        cutoff = (latest.t if now is None else now) - window
        base = None
        for row in rows[:-1]:
            if row.t <= cutoff:
                base = row
            else:
                break
        if base is None:
            if not clamp:
                return None
            base = rows[0]
        if base.t >= latest.t:
            return None
        return base, latest

    # -- windowed queries ---------------------------------------------------
    def delta(self, name: str, window: float, now: Optional[float] = None,
              clamp: bool = False, **labels) -> Optional[float]:
        """Counter increase over the window, summed across every series
        whose labels are a superset of ``labels``. ``None`` only when
        history is too short; 0.0 when the metric simply never moved."""
        pair = self._window_pair(window, now, clamp)
        if pair is None:
            return None
        base, latest = pair
        want = {k: str(v) for k, v in labels.items()}
        total = 0.0
        for key, cur in latest.counters.items():
            if not _match(key, name, want):
                continue
            prev = base.counters.get(key)
            d = cur if prev is None or cur < prev else cur - prev
            total += d
        return total

    def rate(self, name: str, window: float, now: Optional[float] = None,
             clamp: bool = False, **labels) -> Optional[float]:
        """Per-second counter rate over the window (delta / covered
        seconds — the actually-covered span, not the nominal window)."""
        pair = self._window_pair(window, now, clamp)
        if pair is None:
            return None
        d = self.delta(name, window, now=now, clamp=clamp, **labels)
        span = pair[1].t - pair[0].t
        return None if d is None or span <= 0 else d / span

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        latest = self.latest()
        if latest is None:
            return None
        want = {k: str(v) for k, v in labels.items()}
        for key, v in latest.gauges.items():
            if _match(key, name, want):
                return v
        return None

    def hist_delta(self, name: str, window: float,
                   now: Optional[float] = None, clamp: bool = False,
                   **labels) -> Optional[Tuple[List[float], List[int],
                                               float, int]]:
        """(bounds, bucket-count deltas, sum delta, count delta) over
        the window, merged bucket-wise across matching series (exact:
        bounds are identical by construction, and a merged fleet series
        differences the merged integer counts)."""
        pair = self._window_pair(window, now, clamp)
        if pair is None:
            return None
        base, latest = pair
        want = {k: str(v) for k, v in labels.items()}
        bounds: Optional[List[float]] = None
        counts: Optional[List[int]] = None
        dsum, dcount = 0.0, 0
        for key, (cur_counts, cur_sum, cur_n) in latest.hists.items():
            if not _match(key, name, want):
                continue
            b = self._bounds.get(key)
            if b is None:
                continue
            if bounds is None:
                bounds = b
                counts = [0] * len(cur_counts)
            elif b != bounds or len(cur_counts) != len(counts):
                continue
            prev = base.hists.get(key)
            if prev is None or prev[2] > cur_n:
                pc, ps = (0,) * len(cur_counts), 0.0
                pn = 0
            else:
                pc, ps, pn = prev
            for i, c in enumerate(cur_counts):
                counts[i] += max(0, c - (pc[i] if i < len(pc) else 0))
            dsum += cur_sum - ps
            dcount += cur_n - pn
        if bounds is None:
            return None
        return bounds, counts, dsum, dcount

    def window_quantile(self, name: str, q: float, window: float,
                        now: Optional[float] = None, clamp: bool = False,
                        **labels) -> Optional[float]:
        hd = self.hist_delta(name, window, now=now, clamp=clamp, **labels)
        if hd is None or hd[3] <= 0:
            return None
        return quantile(hd[0], hd[1], q)

    def window_fraction_at_or_below(
            self, name: str, threshold: float, window: float,
            now: Optional[float] = None, clamp: bool = False,
            **labels) -> Optional[float]:
        hd = self.hist_delta(name, window, now=now, clamp=clamp, **labels)
        if hd is None or hd[3] <= 0:
            return None
        return fraction_at_or_below(hd[0], hd[1], threshold)

    def rate_series(self, name: str, n: int = 12,
                    **labels) -> List[float]:
        """Per-second rates between the last ``n+1`` consecutive
        samples — the sparkline feed."""
        with self._lock:
            rows = list(self._ring)[-(n + 1):]
        want = {k: str(v) for k, v in labels.items()}
        out: List[float] = []
        for prev, cur in zip(rows, rows[1:]):
            span = cur.t - prev.t
            if span <= 0:
                continue
            total = 0.0
            for key, v in cur.counters.items():
                if not _match(key, name, want):
                    continue
                p = prev.counters.get(key)
                total += v if p is None or v < p else v - p
            out.append(total / span)
        return out

    def windowed_burn(self, metric: str, threshold_s: float,
                      target: float, window: float,
                      now: Optional[float] = None, clamp: bool = False,
                      **labels) -> Optional[Dict[str, float]]:
        """Windowed SLO burn: attainment of ``value <= threshold_s``
        over the window's bucket deltas, burn = (1 - att)/(1 - target).
        ``None`` when history or window traffic is missing."""
        hd = self.hist_delta(metric, window, now=now, clamp=clamp,
                             **labels)
        if hd is None or hd[3] <= 0:
            return None
        att = fraction_at_or_below(hd[0], hd[1], threshold_s)
        if att is None:
            return None
        return {"attainment": att,
                "burn": (1.0 - att) / (1.0 - target),
                "count": float(hd[3])}


# -- alert specs ------------------------------------------------------------
class AlertSpec:
    """One declarative alert row.

    kinds:
      - ``rate_above``: sum of per-second rates of ``metrics`` (each a
        name or ``(name, labels)``) over the window > ``threshold``.
      - ``ratio_below``: rate(``num``) / sum(rate(d) for d in ``den``)
        < ``threshold``, judged only while the denominator rate is at
        least ``min_den_rate`` (no traffic, no anomaly).
      - ``burn_rate``: per-replica SLO burn over the fast window AND
        the slow window both > 1 (SRE multi-window: fast catches, slow
        confirms) with at least FLAGS_obs_fleet_slo_min_requests
        window samples.
      - ``divergence``: a replica's windowed rate of ``metric`` falls
        below ``frac`` x the fleet median while the median is at least
        ``min_median`` (the lone cold replica in a busy fleet).
    """

    __slots__ = ("name", "kind", "params", "window", "slow_window",
                 "per_replica", "advisory", "description")

    def __init__(self, name: str, kind: str, params: Dict,
                 window: Optional[float] = None,
                 slow_window: Optional[float] = None,
                 per_replica: bool = False, advisory: bool = False,
                 description: str = ""):
        self.name = name
        self.kind = kind
        self.params = dict(params)
        self.window = window
        self.slow_window = slow_window
        self.per_replica = per_replica
        self.advisory = advisory
        self.description = description

    def fast_s(self) -> float:
        return float(self.window if self.window is not None
                     else get_flag("obs_ts_fast_window_s"))

    def slow_s(self) -> float:
        return float(self.slow_window if self.slow_window is not None
                     else get_flag("obs_ts_slow_window_s"))


def default_specs() -> List[AlertSpec]:
    """The serving health watchers on by default: one burn alert + the
    derived-signal anomalies."""
    return [
        AlertSpec(
            "slo_burn", "burn_rate", {"slos": ("ttft", "tpot")},
            per_replica=True, advisory=True,
            description="per-replica TTFT/TPOT error-budget burn > 1 "
                        "over the fast AND slow windows"),
        AlertSpec(
            "spec_accept_collapse", "ratio_below",
            {"num": "serving_spec_accepted_total",
             "den": ["serving_spec_proposed_total"],
             "threshold": 0.2, "min_den_rate": 2.0},
            description="draft-token acceptance rate collapsed — the "
                        "spec speedup is gone, drafts burn compute"),
        AlertSpec(
            "prefix_hit_drop", "ratio_below",
            {"num": "serving_prefix_cache_hits_total",
             "den": ["serving_prefix_cache_hits_total",
                     "serving_prefix_cache_misses_total"],
             "threshold": 0.1, "min_den_rate": 1.0},
            description="prefix-cache hit rate dropped — prefill cost "
                        "reverted to cold"),
        AlertSpec(
            "offload_stall_spike", "rate_above",
            {"metrics": ["serving_kv_offload_stall_seconds_total"],
             "threshold": 0.5},
            description="restores blocked on inline h2d transfers — "
                        "the prefetch tier stopped hiding the latency"),
        AlertSpec(
            "shed_rate", "rate_above",
            {"metrics": ["serving_shed_total",
                         "serving_router_shed_total"],
             "threshold": 0.5},
            description="admission/router sheds per second spiked — "
                        "sustained overload, not a blip"),
        AlertSpec(
            "disagg_relay_degraded", "rate_above",
            {"metrics": [("serving_disagg_handoffs_total",
                          {"outcome": "relay_full"}),
                         ("serving_disagg_handoffs_total",
                          {"outcome": "missing"})],
             "threshold": 0.2},
            description="prefill->decode handoffs degrading to "
                        "re-prefill (relay_full / missing)"),
        AlertSpec(
            "replica_tok_s_divergence", "divergence",
            {"metric": "serving_tokens_total", "frac": 0.25,
             "min_median": 1.0},
            per_replica=True, advisory=True,
            description="one replica's token rate diverged below the "
                        "fleet median — dead or degraded under load"),
    ]


# -- the alert engine -------------------------------------------------------
class AlertEngine:
    """Evaluates specs against a store; tracks firing state per
    (alert, instance) and emits edges (flight events + counters)."""

    def __init__(self, store: Optional[TimeSeriesStore] = None,
                 specs: Optional[Sequence[AlertSpec]] = None):
        self._store = store
        self._lock = threading.Lock()
        self.specs: List[AlertSpec] = list(
            default_specs() if specs is None else specs)
        self._active: Dict[Tuple[str, str], float] = {}
        self._last: List[Dict] = []
        self.edges: Dict[Tuple[str, str], int] = {}

    def store(self) -> TimeSeriesStore:
        return self._store if self._store is not None else get_store()

    def add_spec(self, spec: AlertSpec) -> None:
        with self._lock:
            self.specs.append(spec)

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._last = []
            self.edges.clear()

    def edge_count(self, alert: str, edge: str) -> int:
        return self.edges.get((alert, edge), 0)

    # -- signal evaluation --------------------------------------------------
    def _replicas(self, metric: str) -> List[str]:
        latest = self.store().latest()
        if latest is None:
            return []
        names: Set[str] = set()
        source = latest.hists if metric.endswith("_seconds") \
            else latest.counters
        for (name, labels) in source:
            if name != metric:
                continue
            for k, v in labels:
                if k == "replica":
                    names.add(v)
        return sorted(names)

    def _eval_rate_above(self, spec: AlertSpec,
                         now: Optional[float]) -> List[Dict]:
        store, total, seen = self.store(), 0.0, False
        for m in spec.params["metrics"]:
            name, labels = (m, {}) if isinstance(m, str) else m
            r = store.rate(name, spec.fast_s(), now=now, **labels)
            if r is not None:
                total += r
                seen = True
        thr = float(spec.params["threshold"])
        if not seen:
            return [self._row(spec, "", None, thr)]
        return [self._row(spec, "", total, thr, firing=total > thr)]

    def _eval_ratio_below(self, spec: AlertSpec,
                          now: Optional[float]) -> List[Dict]:
        store = self.store()
        den = 0.0
        den_seen = False
        for name in spec.params["den"]:
            r = store.rate(name, spec.fast_s(), now=now)
            if r is not None:
                den += r
                den_seen = True
        thr = float(spec.params["threshold"])
        if not den_seen or den < float(spec.params["min_den_rate"]):
            return [self._row(spec, "", None, thr)]
        num = store.rate(spec.params["num"], spec.fast_s(), now=now) or 0.0
        ratio = num / den
        return [self._row(spec, "", ratio, thr, firing=ratio < thr)]

    def _eval_burn_rate(self, spec: AlertSpec,
                        now: Optional[float]) -> List[Dict]:
        store = self.store()
        target = min(float(get_flag("obs_fleet_slo_target")), 0.9999)
        min_n = int(get_flag("obs_fleet_slo_min_requests"))
        rows = []
        slos = {"ttft": ("serving_ttft_seconds", "obs_slo_ttft_ms"),
                "tpot": ("serving_tpot_seconds", "obs_slo_tpot_ms")}
        names: Set[str] = set()
        for slo in spec.params.get("slos", ("ttft", "tpot")):
            names.update(self._replicas(slos[slo][0]))
        for replica in sorted(names):
            worst = None
            for slo in spec.params.get("slos", ("ttft", "tpot")):
                metric, flag = slos[slo]
                thr_s = float(get_flag(flag)) / 1e3
                fast = store.windowed_burn(metric, thr_s, target,
                                           spec.fast_s(), now=now,
                                           replica=replica)
                if fast is None or fast["count"] < min_n:
                    continue
                slow = store.windowed_burn(metric, thr_s, target,
                                           spec.slow_s(), now=now,
                                           clamp=True, replica=replica)
                burn_slow = slow["burn"] if slow is not None \
                    else fast["burn"]
                burning = fast["burn"] > 1.0 and burn_slow > 1.0
                if worst is None or fast["burn"] > worst[0]:
                    worst = (fast["burn"], burning)
            if worst is None:
                rows.append(self._row(spec, replica, None, 1.0))
            else:
                rows.append(self._row(spec, replica, worst[0], 1.0,
                                      firing=worst[1]))
        return rows

    def _eval_divergence(self, spec: AlertSpec,
                         now: Optional[float]) -> List[Dict]:
        store = self.store()
        metric = spec.params["metric"]
        names = self._replicas(metric)
        if len(names) < 2:
            return []
        rates = {}
        for replica in names:
            r = store.rate(metric, spec.fast_s(), now=now,
                           replica=replica)
            if r is not None:
                rates[replica] = r
        if len(rates) < 2:
            return [self._row(spec, r, None, 0.0) for r in names]
        med = statistics.median(rates.values())
        frac = float(spec.params["frac"])
        rows = []
        for replica, r in sorted(rates.items()):
            if med < float(spec.params["min_median"]):
                rows.append(self._row(spec, replica, r, 0.0))
                continue
            thr = frac * med
            rows.append(self._row(spec, replica, r, thr,
                                  firing=r < thr))
        return rows

    def _row(self, spec: AlertSpec, instance: str,
             value: Optional[float], threshold: float,
             firing: bool = False) -> Dict:
        return {"alert": spec.name, "instance": instance,
                "kind": spec.kind,
                "state": "firing" if firing
                else ("ok" if value is not None else "no_data"),
                "value": None if value is None else round(value, 6),
                "threshold": round(threshold, 6),
                "window_s": spec.fast_s(),
                "advisory": spec.advisory,
                "description": spec.description}

    # -- the tick -----------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """One evaluation pass: every spec's rows, with firing/cleared
        EDGES emitted exactly once per transition."""
        from . import flight_recorder as _flight

        handlers = {"rate_above": self._eval_rate_above,
                    "ratio_below": self._eval_ratio_below,
                    "burn_rate": self._eval_burn_rate,
                    "divergence": self._eval_divergence}
        with self._lock:
            rows: List[Dict] = []
            for spec in self.specs:
                try:
                    rows.extend(handlers[spec.kind](spec, now))
                except Exception:
                    rows.append(self._row(spec, "", None, 0.0))
            t = time.time() if now is None else now
            firing_keys = {(r["alert"], r["instance"]): r for r in rows
                           if r["state"] == "firing"}
            for key, row in firing_keys.items():
                since = self._active.get(key)
                if since is None:
                    self._active[key] = t
                    self._edge(key, "firing", row, _flight, t)
                row["since"] = self._active[key]
            for key in [k for k in self._active if k not in firing_keys]:
                del self._active[key]
                self._edge(key, "cleared", None, _flight, t)
            self._last = rows
            return rows

    def _edge(self, key: Tuple[str, str], edge: str,
              row: Optional[Dict], _flight, t: float) -> None:
        alert, instance = key
        self.edges[(alert, edge)] = self.edges.get((alert, edge), 0) + 1
        # direct child access: an evaluation running on a replica-scoped
        # step thread must not scatter the alert ledger across replicas
        _M_ALERTS.labels(alert=alert, state=edge).inc()
        fields = {"alert": alert, "instance": instance}
        if row is not None:
            fields.update(value=row["value"], threshold=row["threshold"],
                          window_s=row["window_s"])
        _flight.record(f"alert_{edge}", **fields)

    def firing(self) -> List[Dict]:
        with self._lock:
            return [r for r in self._last if r["state"] == "firing"]

    def burning_replicas(self) -> Set[str]:
        """Replica instances of ADVISORY alerts currently firing — the
        router demotion feed (healthy -> suspect, same gate as SLO)."""
        return {r["instance"] for r in self.firing()
                if r["advisory"] and r["instance"]}

    def last_rows(self) -> List[Dict]:
        with self._lock:
            return list(self._last)


# -- history persistence ----------------------------------------------------
class _HistoryLog:
    """Bounded derived-signal history: an in-memory tail (always) and a
    JSONL ring under ``FLAGS_obs_ts_dir`` (when set) that compacts back
    to the cap once the file doubles it."""

    def __init__(self):
        cap = int(get_flag("obs_ts_history_tail"))
        self._lock = threading.Lock()
        self._tail: collections.deque = collections.deque(maxlen=cap)
        self._lines = 0
        self._path: Optional[str] = None

    def append(self, entry: Dict) -> None:
        with self._lock:
            self._tail.append(entry)
            d = str(get_flag("obs_ts_dir"))
            if not d:
                return
            try:
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, f"obs_ts-{os.getpid()}.jsonl")
                if path != self._path:
                    self._path, self._lines = path, 0
                with open(path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
                self._lines += 1
                cap = self._tail.maxlen or 1
                if self._lines > 2 * cap:
                    with open(path, "w") as f:
                        for row in self._tail:
                            f.write(json.dumps(row) + "\n")
                    self._lines = len(self._tail)
            except OSError:
                pass

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        with self._lock:
            rows = list(self._tail)
        return rows if n is None else rows[-n:]

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._tail = collections.deque(self._tail,
                                           maxlen=max(2, int(capacity)))

    def clear(self) -> None:
        with self._lock:
            self._tail.clear()
            self._lines = 0
            self._path = None


# -- module singletons + the step tick --------------------------------------
_default_store: Optional[TimeSeriesStore] = None
_default_engine: Optional[AlertEngine] = None
_default_history = _HistoryLog()
_tick_lock = threading.Lock()
_last_tick = [0.0]


def get_store() -> TimeSeriesStore:
    global _default_store
    if _default_store is None:
        _default_store = TimeSeriesStore()
    return _default_store


def get_alert_engine() -> AlertEngine:
    global _default_engine
    if _default_engine is None:
        _default_engine = AlertEngine()
    return _default_engine


def get_history() -> _HistoryLog:
    return _default_history


def _resize_store(v) -> None:
    if _default_store is not None:
        _default_store.set_capacity(int(v))


watch_flag("obs_ts_capacity", _resize_store)
watch_flag("obs_ts_history_tail",
           lambda v: _default_history.set_capacity(int(v)))


def tick(now: Optional[float] = None) -> None:
    """One full sampler tick: sample the registry, evaluate alerts,
    append the derived-signal vector to the history. Never raises —
    telemetry must not take the serving step down with it."""
    try:
        store = get_store()
        row = store.sample(t=now)
        rows = get_alert_engine().evaluate(now=row.t)
        signals = {}
        for r in rows:
            key = r["alert"] if not r["instance"] \
                else f"{r['alert']}[{r['instance']}]"
            signals[key] = r["value"]
        tok_s = store.rate("serving_tokens_total", float(
            get_flag("obs_ts_fast_window_s")), now=row.t)
        if tok_s is not None:
            signals["tok_s"] = round(tok_s, 3)
        _default_history.append({
            "t": row.t,
            "signals": signals,
            "firing": sorted(r["alert"] if not r["instance"]
                             else f"{r['alert']}[{r['instance']}]"
                             for r in rows if r["state"] == "firing")})
    except Exception:
        try:
            from . import flight_recorder as _flight
            _flight.record("ts_tick_error")
        except Exception:
            pass


def step_tick(now: Optional[float] = None) -> None:
    """The engine/router hook: throttled by ``FLAGS_obs_ts_interval_s``,
    contention-free (a busy concurrent sampler means this step skips),
    near-zero when obs is off."""
    if not state.enabled():
        return
    t = time.time() if now is None else now
    if t - _last_tick[0] < float(get_flag("obs_ts_interval_s")):
        return
    if not _tick_lock.acquire(blocking=False):
        return
    try:
        if t - _last_tick[0] < float(get_flag("obs_ts_interval_s")):
            return
        _last_tick[0] = t
        tick(now=now)
    finally:
        _tick_lock.release()


# -- endpoint / post-mortem payloads ----------------------------------------
def alerts_payload(evaluate: bool = True) -> Dict:
    """The ``/alerts.json`` document (obs server + front door):
    evaluated fresh by default so a scrape never reads stale edges."""
    engine = get_alert_engine()
    rows = engine.evaluate() if evaluate else engine.last_rows()
    store = get_store()
    return {"version": 1, "unix_time": time.time(),
            "window_fast_s": float(get_flag("obs_ts_fast_window_s")),
            "window_slow_s": float(get_flag("obs_ts_slow_window_s")),
            "samples": store.sampled, "ring_size": len(store),
            "firing": sorted({r["alert"] for r in rows
                              if r["state"] == "firing"}),
            "alerts": rows}


def history_payload(n: int = 32) -> Dict:
    """The post-mortem embed: the last ``n`` derived-signal vectors +
    the final alert table — the trajectory INTO the failure."""
    return {"entries": _default_history.tail(n),
            "alerts": get_alert_engine().last_rows()}


def reset() -> None:
    """Test hook: drop every sample, alert state and history entry."""
    if _default_store is not None:
        _default_store.clear()
    if _default_engine is not None:
        _default_engine.clear()
        _default_engine.specs = default_specs()
    _default_history.clear()
    _last_tick[0] = 0.0
