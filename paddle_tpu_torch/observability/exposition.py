"""Exposition: Prometheus text format + one-shot JSON snapshot — the
port's copy of paddle_tpu/observability/exposition.py.

Prometheus text exposition format 0.0.4 (the format every scraper
understands): HELP/TYPE headers, escaped label values, histograms as
cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional, Sequence

from .metrics import Registry, get_registry

__all__ = ["render_prometheus", "render_snapshot_prometheus", "snapshot",
           "dump_snapshot", "load_snapshot", "snapshot_rows", "quantile",
           "fraction_at_or_below"]


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n") \
        .replace('"', '\\"')


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _hist_state(child):
    """Consistent (counts, sum, count) triple: read under the child's
    lock, or a scrape racing observe() could see a bucket incremented but
    not yet the total — a non-monotone histogram that breaks
    histogram_quantile/rate on the Prometheus side."""
    with child._lock:
        return list(child.counts), child.sum, child.count


def merged_hist_state(fam):
    """Elementwise-summed ``(counts, sum, count)`` across every child of
    one histogram family (all children share the family's bounds by
    construction). This is the family-wide reading consumers like the
    SLO gauges and exemplar quantiles need under replica scoping,
    where observations land in ``{replica=...}`` children and the
    labelless child stays empty."""
    counts = [0] * (len(fam.bounds) + 1)
    total_sum = 0.0
    total = 0
    for child in fam.series():
        c, s, n = _hist_state(child)
        for i, v in enumerate(c):
            counts[i] += v
        total_sum += s
        total += n
    return counts, total_sum, total


def quantile(bounds: Sequence[float], counts: Sequence[int],
             q: float) -> Optional[float]:
    """Estimate the q-quantile of a histogram from its buckets.

    ``counts`` has one entry per bucket (``len(bounds) + 1``, the last
    being +Inf). Within a bucket the position is interpolated on a LOG
    scale — the registry's buckets are log-spaced, so log interpolation
    is exact for log-uniform mass where linear interpolation (the
    Prometheus ``histogram_quantile`` default) skews high. The first
    bucket interpolates linearly from 0; a quantile landing in +Inf
    returns the largest finite bound. ``None`` on an empty histogram.
    """
    total = sum(counts)
    if total <= 0 or not bounds:
        return None
    target = min(1.0, max(0.0, q)) * total
    cum = 0
    for i, n in enumerate(counts):
        cum += n
        if n > 0 and cum >= target:
            if i >= len(bounds):          # +Inf bucket: no upper edge
                return float(bounds[-1])
            frac = 1.0 - (cum - target) / n
            hi = float(bounds[i])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            if lo > 0 and hi > lo:
                return lo * (hi / lo) ** frac
            return lo + (hi - lo) * frac
    return float(bounds[-1])


def fraction_at_or_below(bounds: Sequence[float], counts: Sequence[int],
                         threshold: float) -> Optional[float]:
    """Estimated fraction of observations <= ``threshold`` (the SLO
    attainment readout), log-interpolated inside the bucket the
    threshold falls in. ``None`` on an empty histogram."""
    total = sum(counts)
    if total <= 0:
        return None
    cum = 0.0
    for i, n in enumerate(counts):
        lo = float(bounds[i - 1]) if i > 0 else 0.0
        hi = float(bounds[i]) if i < len(bounds) else math.inf
        if threshold >= hi:
            cum += n
            continue
        if threshold > lo and n:
            if lo > 0 and math.isfinite(hi):
                frac = math.log(threshold / lo) / math.log(hi / lo)
            elif math.isfinite(hi):
                frac = (threshold - lo) / (hi - lo)
            else:
                frac = 0.0
            cum += n * frac
        break
    return min(1.0, cum / total)


def render_prometheus(registry: Optional[Registry] = None) -> str:
    reg = registry or get_registry()
    out = []
    for fam in reg.families():
        series = fam.series()
        out.append(f"# HELP {fam.name} {_escape(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for child in series:
            ls = child.labels
            if fam.kind in ("counter", "gauge"):
                out.append(f"{fam.name}{_label_str(ls)} {_fmt(child.value)}")
            else:
                counts, total_sum, total = _hist_state(child)
                cum = 0
                for bound, n in zip(child.bounds, counts):
                    cum += n
                    le = 'le="%s"' % _fmt(bound)
                    out.append(
                        f"{fam.name}_bucket{_label_str(ls, le)} {cum}")
                inf = 'le="+Inf"'
                out.append(
                    f"{fam.name}_bucket{_label_str(ls, inf)} {total}")
                out.append(f"{fam.name}_sum{_label_str(ls)} "
                           f"{_fmt(total_sum)}")
                out.append(f"{fam.name}_count{_label_str(ls)} {total}")
    return "\n".join(out) + "\n"


def render_snapshot_prometheus(snap: Dict) -> str:
    """Prometheus text from a snapshot DICT rather than a live registry
    — the federation path: :class:`~.fleet.FleetAggregator` merges
    per-replica snapshots (in-process, or the same JSON format fetched
    over HTTP from other processes) and exposes the merged dict as
    ``/fleet/metrics`` through here."""
    out = []
    for fam in snap.get("metrics", []):
        name, kind = fam["name"], fam["kind"]
        out.append(f"# HELP {name} {_escape(fam.get('help', ''))}")
        out.append(f"# TYPE {name} {kind}")
        for s in fam.get("series", []):
            ls = s.get("labels", {})
            if kind in ("counter", "gauge"):
                out.append(f"{name}{_label_str(ls)} {_fmt(s['value'])}")
                continue
            counts = s.get("counts", [])
            bounds = s.get("bounds", [])
            cum = 0
            for bound, n in zip(bounds, counts):
                cum += n
                le = 'le="%s"' % _fmt(bound)
                out.append(f"{name}_bucket{_label_str(ls, le)} {cum}")
            total = s.get("count", sum(counts))
            inf = 'le="+Inf"'
            out.append(f"{name}_bucket{_label_str(ls, inf)} {total}")
            out.append(f"{name}_sum{_label_str(ls)} "
                       f"{_fmt(s.get('sum', 0.0))}")
            out.append(f"{name}_count{_label_str(ls)} {total}")
    return "\n".join(out) + "\n"


def snapshot(registry: Optional[Registry] = None) -> Dict:
    """One-shot JSON-serializable view of every series. Histogram
    families that attached exemplars (request_trace TTFT/TPOT) carry
    them under ``exemplars`` — a snapshot file or crash post-mortem
    then links its own p99 to a request_id without the live process."""
    reg = registry or get_registry()
    metrics = []
    for fam in reg.families():
        fam_out = {"name": fam.name, "kind": fam.kind, "help": fam.help,
                   "series": []}
        if fam._overflow_observations:
            fam_out["overflow_observations"] = fam._overflow_observations
        for child in fam.series():
            s = {"labels": child.labels}
            if fam.kind in ("counter", "gauge"):
                s["value"] = child.value
                if fam.kind == "gauge" and getattr(child, "updated", False):
                    s["updated"] = True
            else:
                counts, total_sum, total = _hist_state(child)
                s["bounds"] = list(child.bounds)
                s["counts"] = counts
                s["sum"] = total_sum
                s["count"] = total
            fam_out["series"].append(s)
        if fam.kind == "histogram":
            exs = _family_exemplars(fam)
            if exs:
                fam_out["exemplars"] = exs
        metrics.append(fam_out)
    return {"version": 1, "unix_time": time.time(), "pid": os.getpid(),
            "metrics": metrics}


def _family_exemplars(fam):
    """Bucket exemplars of one histogram family (empty list when the
    metric never attached any — only the request-trace call sites do)."""
    from .request_trace import get_exemplar_store

    try:
        return get_exemplar_store().exemplars(fam.name, fam.bounds)
    except Exception:
        return []


def dump_snapshot(path: str, registry: Optional[Registry] = None) -> str:
    """Write :func:`snapshot` as JSON; returns the path."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=1)
    return path


def load_snapshot(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def snapshot_rows(snap: Dict):
    """``(name, kind, labels_str, value_str)`` per TOUCHED series of a
    snapshot dict (zero counters/empty histograms/never-set gauges are
    hidden; a gauge explicitly set to 0 is shown) — the one renderer
    behind tools/obs_dump.py's table and the hapi MetricsLogger log
    lines (histograms show count + mean)."""
    rows = []
    for fam in snap["metrics"]:
        for s in fam["series"]:
            lbl = ",".join(f"{k}={v}" for k, v
                           in sorted(s.get("labels", {}).items()))
            if fam["kind"] == "histogram":
                cnt = s.get("count", 0)
                if not cnt:
                    continue
                mean = s.get("sum", 0.0) / cnt
                val = f"count={cnt} mean={mean:.6g}"
                bounds, counts = s.get("bounds"), s.get("counts")
                if bounds and counts:
                    qs = (quantile(bounds, counts, q)
                          for q in (0.5, 0.95, 0.99))
                    val += "".join(
                        f" p{p}={v:.6g}" for p, v in
                        zip((50, 95, 99), qs) if v is not None)
                rows.append((fam["name"], fam["kind"], lbl, val))
            else:
                # Zero counters were never incremented; zero gauges are
                # shown when they were explicitly set (0% attainment is
                # the reading an operator most needs to see).
                if not s.get("value") and not s.get("updated"):
                    continue
                rows.append((fam["name"], fam["kind"], lbl,
                             f"{s['value']:g}"))
    return rows
