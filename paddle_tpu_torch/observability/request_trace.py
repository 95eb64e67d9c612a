"""Per-request distributed tracing: timelines, exemplars, SLO audit — the
port's copy of paddle_tpu/observability/request_trace.py.

The aggregate layer (metrics) answers "what is p99 TTFT"; this module
answers the question that follows — "WHICH request was the p99, and
where did its time go". Three pieces:

- **RequestContext / RequestTracer** — a request_id is minted at
  ``LLMEngine.add_request`` and follows the request through slots,
  preemptions, and re-admissions. Every lifecycle transition lands as a
  structured timeline event (``queued -> admitted -> prefill ->
  first_token -> decode ticks -> preempt/resume -> finish``) with
  monotone timestamps; finished timelines are retained in a bounded
  ring (``FLAGS_obs_requests_capacity``, oldest evicted) with a
  per-request summary (queue_ms / ttft_ms / decode tok/s / tokens /
  preemptions).
- **Exemplars** — extreme TTFT/TPOT histogram observations carry their
  request_id (one exemplar per histogram bucket, latest observation
  wins — the OpenMetrics exemplar model). A p99 reading is no longer a
  dead end: :func:`exemplar_for_quantile` maps a quantile to the bucket
  it falls in and returns the request_id to pull from the trace ring
  (``/request/<id>.json`` on the exposition server).
- **SLO audit log** — a request finishing over ``FLAGS_obs_slo_ttft_ms``
  / ``FLAGS_obs_slo_tpot_ms`` auto-dumps its full timeline into a
  bounded in-memory audit ring (``FLAGS_obs_audit_capacity``), and to
  one JSONL file per process under ``FLAGS_obs_audit_dir`` when set —
  capped at the same capacity so a pathological workload can never fill
  a disk with audit entries.

Near-zero when ``FLAGS_obs_enabled`` is off: no context objects are
created, no ring is written, and every public mutation is one global
read + an early return. Stdlib-only (the package contract).
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..framework.flags import get_flag, watch_flag
from . import state
from .catalog import instrument as _instrument
from .exposition import _hist_state, merged_hist_state

__all__ = ["RequestContext", "RequestTracer", "ExemplarStore",
           "get_request_tracer", "get_exemplar_store",
           "observe_with_exemplar", "exemplar_for_quantile",
           "requests_payload"]

# FLAGS_obs_requests_capacity / obs_request_events_max /
# obs_audit_capacity / obs_audit_dir are defined in the package
# __init__ (this module is lazily loaded; the flags must register up
# front so set_flags sees them).

_M_TRACES = _instrument("serving_request_traces_total")
_M_QUEUE_SECONDS = _instrument("serving_request_queue_seconds")
_M_AUDITS = _instrument("serving_request_slo_audits_total")
_M_EXEMPLARS = _instrument("serving_request_exemplars_total")
_M_EVENTS_DROPPED = _instrument("serving_request_events_dropped_total")

# lifecycle kinds that must never fall to the per-request event cap
_LIFECYCLE = frozenset((
    "queued", "admitted", "resumed", "prefill", "first_token",
    "preempt", "finish", "failover"))


class RequestContext:
    """One request's structured timeline + derived summary."""

    __slots__ = ("request_id", "events", "meta", "summary", "dropped",
                 "_t0_perf")

    def __init__(self, request_id, t_perf: float, meta: Optional[Dict]):
        self.request_id = request_id
        self.events: List[Dict] = []
        self.meta = dict(meta or {})
        self.summary: Optional[Dict] = None
        self.dropped = 0
        self._t0_perf = t_perf           # perf anchor for the request span

    def _first(self, kind: str) -> Optional[float]:
        for ev in self.events:
            if ev["kind"] == kind:
                return ev["t"]
        return None

    def _count(self, kind: str) -> int:
        return sum(1 for ev in self.events if ev["kind"] == kind)

    def timeline(self) -> Dict:
        """The full JSON document served by ``/request/<id>.json``."""
        out = {"request_id": self.request_id, "events": list(self.events),
               "meta": dict(self.meta),
               "finished": self.summary is not None}
        if self.dropped:
            out["events_dropped"] = self.dropped
        if self.summary is not None:
            out["summary"] = dict(self.summary)
        return out

    def summarize(self, t_end: float) -> Dict:
        """Derive the per-request summary from the recorded events."""
        t_q = self.events[0]["t"] if self.events else t_end
        t_admit = self._first("admitted")
        t_first = self._first("first_token")
        # the finish event's explicit count is authoritative (the engine
        # retires a request BEFORE its step records the final decode
        # tick); live requests sum their ticks. One scan handles
        # failover continuity: a finish BEFORE a failover hop is the old
        # owner's cut (drain migration), not the stream's terminal — its
        # count and reason reset, and the surviving leg's finish counts
        # only its own tokens, so the pre-hop delivered total rides in
        # on the failover event itself.
        tokens = reason = None
        fo_delivered = 0
        for ev in self.events:
            kind = ev["kind"]
            if kind == "failover":
                fo_delivered = int(ev.get("delivered", 0))
                tokens = reason = None
            elif kind == "finish":
                if "tokens" in ev:
                    tokens = int(ev["tokens"])
                if "reason" in ev:
                    reason = str(ev["reason"])
        if tokens is not None:
            tokens += fo_delivered
        else:
            tokens = sum(int(ev.get("tokens", 0)) for ev in self.events
                         if ev["kind"] in ("decode", "first_token"))
        # prompt tokens served from the prefix cache at the FIRST slot
        # admission (re-admissions after preemption restore or recompute
        # — the initial hit is the one that shaped TTFT)
        cached = next((int(ev["cached_tokens"]) for ev in self.events
                       if ev["kind"] in ("admitted", "resumed")
                       and "cached_tokens" in ev), 0)
        # how the request's last swap-in restore met the offload tier:
        # "hit" = payload was prefetch-staged on device, "stall"
        # = it paid the h2d inline; None when it never swapped in
        offload = next((str(ev["offload"]) for ev in reversed(self.events)
                        if ev["kind"] in ("admitted", "resumed")
                        and ev.get("offload") is not None), None)
        s = {
            "request_id": self.request_id,
            "reason": reason,
            "cached_tokens": cached,
            "offload": offload,
            "queued_unix": t_q,
            "finished_unix": t_end,
            "duration_ms": (t_end - t_q) * 1e3,
            "tokens": tokens,
            "preemptions": self._count("preempt"),
            "failovers": self._count("failover"),
            "queue_ms": (t_admit - t_q) * 1e3
            if t_admit is not None else None,
            "ttft_ms": (t_first - t_q) * 1e3
            if t_first is not None else None,
            "tpot_ms": None,
            "decode_tps": None,
        }
        if t_first is not None and tokens > 1 and t_end > t_first:
            s["tpot_ms"] = (t_end - t_first) * 1e3 / (tokens - 1)
            s["decode_tps"] = (tokens - 1) / (t_end - t_first)
        s.update({k: v for k, v in self.meta.items()
                  if k not in s})
        return s


class RequestTracer:
    """Live request contexts + a bounded ring of finished timelines."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None \
            else int(get_flag("obs_requests_capacity"))
        self._lock = threading.Lock()
        self._live: Dict = {}
        self._done: collections.deque = collections.deque(maxlen=cap)
        self._audit: collections.deque = collections.deque(
            maxlen=int(get_flag("obs_audit_capacity")))
        self._audit_written = 0
        # rid -> rid forwarding for failover-resumed streams:
        # READS (get) chase the chain to the surviving timeline, WRITES
        # stay keyed by the current owner's rid only — a zombie owner's
        # late events and its ghost-cancel finish fall into the
        # unknown-rid no-op, never onto the live timeline
        self._alias: Dict = {}
        # cached: get_flag takes the global flags lock — too expensive
        # for every decode tick (watch_flag keeps it fresh, same pattern
        # as the ring capacities)
        self._events_max = int(get_flag("obs_request_events_max"))

    # -- recording --------------------------------------------------------
    def _now(self):
        # one pair per event: monotone interval + epoch-comparable stamp
        from .tracing import _T0_PERF, _T0_WALL

        p = time.perf_counter()
        return p, _T0_WALL + (p - _T0_PERF)

    def _ctx(self, rid) -> Optional[RequestContext]:
        # unknown rids no-op: a request submitted while observability was
        # off (or already finished) must not grow a ghost live context
        # from a straggling decode tick
        return self._live.get(rid)

    def submit(self, rid, **meta) -> None:
        """Mint the request's context at ``engine.add_request``."""
        if not state.enabled():
            return
        p, w = self._now()
        with self._lock:
            ctx = RequestContext(rid, p, meta)
            ctx.events.append({"t": w, "kind": "queued", **meta})
            self._live[rid] = ctx

    def record(self, rid, kind: str, **fields) -> None:
        """Append one timeline event (no-op while disabled). Decode
        ticks beyond ``FLAGS_obs_request_events_max`` are dropped and
        counted; lifecycle events always land."""
        if not state.enabled():
            return
        _p, w = self._now()
        with self._lock:
            ctx = self._ctx(rid)
            if ctx is None:
                return
            if kind not in _LIFECYCLE and len(ctx.events) >= \
                    self._events_max:
                ctx.dropped += 1
                _M_EVENTS_DROPPED.inc()
                return
            ctx.events.append({"t": w, "kind": str(kind), **fields})

    def annotate(self, rid, **meta) -> None:
        """Attach metadata to a live request's summary without adding a
        timeline event — the replica router stamps ``replica=<name>``
        here so ``obs_dump --requests`` can show placement. Unknown or
        finished rids no-op (same contract as :meth:`record`)."""
        if not state.enabled():
            return
        with self._lock:
            ctx = self._ctx(rid)
            if ctx is not None:
                ctx.meta.update(meta)

    def admitted(self, rid, **fields) -> None:
        """Record a slot admission — ``admitted`` the first time,
        ``resumed`` after a preemption (the id follows the request
        through slots). The first admission observes the queue-wait
        histogram."""
        if not state.enabled():
            return
        _p, w = self._now()
        with self._lock:
            ctx = self._ctx(rid)
            if ctx is None:
                return
            first = ctx._first("admitted") is None
            kind = "admitted" if first else "resumed"
            ctx.events.append({"t": w, "kind": kind, **fields})
            t_q = ctx.events[0]["t"]
        if first:
            _M_QUEUE_SECONDS.observe(max(0.0, w - t_q))

    def _resolve(self, rid):
        """Chase the failover alias chain (bounded; caller holds the
        lock). A pre-failover exemplar or ``/request/<id>.json`` fetch
        by the ORIGINAL rid lands on the surviving timeline."""
        for _ in range(16):
            nxt = self._alias.get(rid)
            if nxt is None:
                return rid
            rid = nxt
        return rid

    def _pop_ctx(self, rid) -> Optional[RequestContext]:
        """Remove ``rid``'s context from the live table, or — when its
        owner already closed it (drain migration finishes the old leg
        with reason ``drained`` BEFORE the router resumes it; a tiny
        resumed leg can finish before the router stamps the hop) — from
        the done ring. Caller holds the lock."""
        ctx = self._live.pop(rid, None)
        if ctx is not None:
            return ctx
        for c in reversed(self._done):
            if c.request_id == rid:
                self._done.remove(c)
                return c
        return None

    def reassign(self, old_rid, new_rid, **fields) -> bool:
        """Failover continuation: the stream that lived on
        ``old_rid`` resumed as ``new_rid`` on another replica. The
        ORIGINAL timeline absorbs a structured ``failover`` event (the
        router passes ``from``/``to``/``delivered``), adopts the resumed
        leg's events (its redundant ``queued`` drops, its ``admitted``
        becomes ``resumed``), and moves under ``new_rid`` so the
        survivor's future events land on the ONE timeline; ``old_rid``
        forwards there for reads. Returns False when the original trace
        was never seen (obs enabled mid-flight) — the resumed leg then
        keeps its own context."""
        if not state.enabled():
            return False
        _p, w = self._now()
        with self._lock:
            ctx = self._pop_ctx(old_rid)
            if ctx is None:
                return False
            ctx.summary = None            # live again until the new leg ends
            ctx.events.append({"t": w, "kind": "failover", **fields})
            # the grafted timeline now answers to the NEW rid everywhere
            # (finish() and the done-ring scan match on request_id); the
            # first leg's id survives in meta and via the read alias
            ctx.meta.setdefault("origin_request_id", ctx.request_id)
            ctx.request_id = new_rid
            fresh = self._pop_ctx(new_rid)
            finished = fresh is not None and fresh.summary is not None
            if fresh is not None:
                self._fold(ctx, fresh)
            self._alias[old_rid] = new_rid
            if len(self._alias) > 4096:   # bound the forwarding table
                self._alias.pop(next(iter(self._alias)))
            if finished:
                # the resumed leg already finished (races the router's
                # post-dispatch stamp): close the grafted timeline now
                ctx.summary = ctx.summarize(fresh.summary["finished_unix"])
                self._done.append(ctx)
            else:
                self._live[new_rid] = ctx
        return True

    @staticmethod
    def _fold(ctx: RequestContext, fresh: RequestContext) -> None:
        """Adopt the resumed leg's context into the surviving timeline:
        its mint event is redundant (the failover hop records the move),
        its first slot admission is a resume, and a second first_token
        is just a decode tick when the original already saw one."""
        have_first = ctx._first("first_token") is not None
        for ev in fresh.events:
            kind = ev.get("kind")
            if kind == "queued":
                continue
            if kind == "admitted":
                ev = dict(ev, kind="resumed")
            elif kind == "first_token" and have_first:
                ev = dict(ev, kind="decode")
            ctx.events.append(ev)
        ctx.dropped += fresh.dropped
        ctx.meta.update(fresh.meta)

    def finish(self, rid, **fields) -> Optional[Dict]:
        """Close the request: append ``finish``, derive the summary,
        move the timeline to the retention ring, and audit it when it
        breached an SLO target. Returns the summary."""
        if not state.enabled():
            # a context minted while enabled must not pin itself in the
            # live table forever after a disable() — drop it silently.
            # The truthiness check keeps the never-enabled path at one
            # attribute read, no lock.
            if self._live:
                with self._lock:
                    self._live.pop(rid, None)
            return None
        _p, w = self._now()
        with self._lock:
            ctx = self._live.pop(rid, None)
            if ctx is None:
                return None
            ctx.events.append({"t": w, "kind": "finish", **fields})
            ctx.summary = ctx.summarize(w)
            self._done.append(ctx)
        _M_TRACES.inc()
        self._emit_request_span(ctx, w)
        self._maybe_audit(ctx)
        return ctx.summary

    def _emit_request_span(self, ctx: RequestContext, t_end: float) -> None:
        """One completed ``serving.request`` span per finished request —
        its ``request_id`` arg is what lets Perfetto filter a single
        request's lifetime out of the Chrome trace."""
        from . import tracing

        p1 = time.perf_counter()
        tracing.get_tracer().record(
            "serving.request", ctx._t0_perf, p1,
            {"request_id": ctx.request_id,
             "tokens": ctx.summary.get("tokens", 0),
             "preemptions": ctx.summary.get("preemptions", 0)},
            depth=0)

    # -- SLO audit --------------------------------------------------------
    def _maybe_audit(self, ctx: RequestContext) -> None:
        s = ctx.summary
        reasons = []
        ttft_slo = float(get_flag("obs_slo_ttft_ms"))
        tpot_slo = float(get_flag("obs_slo_tpot_ms"))
        if s.get("ttft_ms") is not None and s["ttft_ms"] > ttft_slo:
            reasons.append("ttft")
        if s.get("tpot_ms") is not None and s["tpot_ms"] > tpot_slo:
            reasons.append("tpot")
        if not reasons:
            return
        entry = {"t": s["finished_unix"], "request_id": ctx.request_id,
                 "reasons": reasons,
                 "slo": {"ttft_ms": ttft_slo, "tpot_ms": tpot_slo},
                 "timeline": ctx.timeline()}
        # the file-line budget is only spent on actual writes: a job
        # that breaches with obs_audit_dir unset must still have its
        # full budget when the operator sets the dir to start capturing
        has_dir = bool(str(get_flag("obs_audit_dir")))
        with self._lock:
            self._audit.append(entry)
            write = has_dir and \
                self._audit_written < int(get_flag("obs_audit_capacity"))
            if write:
                self._audit_written += 1
        for r in reasons:
            _M_AUDITS.inc(reason=r)
        if write:
            self._write_audit(entry)

    def _write_audit(self, entry: Dict) -> None:
        """Append one JSONL audit line; best-effort (a full disk must
        not take the serving loop down with it)."""
        d = str(get_flag("obs_audit_dir"))
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"request_audit-{os.getpid()}.jsonl")
            with open(path, "a") as f:
                json.dump(entry, f, default=repr)
                f.write("\n")
        except OSError:
            pass

    # -- reading ----------------------------------------------------------
    def get(self, rid) -> Optional[Dict]:
        """Full timeline document for one request id (live or retained);
        ``None`` when it was never seen or already evicted."""
        with self._lock:
            rid = self._resolve(rid)
            ctx = self._live.get(rid)
            if ctx is None:
                for c in reversed(self._done):
                    if c.request_id == rid:
                        ctx = c
                        break
            return ctx.timeline() if ctx is not None else None

    def requests(self, sort: str = "ttft",
                 limit: Optional[int] = None) -> List[Dict]:
        """Per-request summaries, worst first. ``sort``: ``ttft`` /
        ``tpot`` / ``queue`` / ``tokens`` / ``finished`` (recency).
        Live (unfinished) requests ride along with partial summaries."""
        _p, w = self._now()
        with self._lock:
            rows = [dict(c.summary) for c in self._done]
            for c in self._live.values():
                row = c.summarize(w)
                row["finished_unix"] = None
                row["live"] = True
                rows.append(row)
        keys = {"ttft": "ttft_ms", "tpot": "tpot_ms", "queue": "queue_ms",
                "tokens": "tokens", "finished": "finished_unix"}
        key = keys.get(sort, "ttft_ms")
        rows.sort(key=lambda r: (r.get(key) is not None,
                                 r.get(key) or 0.0), reverse=True)
        # non-positive limits mean "no limit" — a negative slice would
        # silently drop the WORST rows, the ones the table is for
        return rows[:limit] if limit is not None and limit > 0 else rows

    def audit_entries(self) -> List[Dict]:
        with self._lock:
            return list(self._audit)

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def clear(self) -> None:
        with self._lock:
            self._live.clear()
            self._done.clear()
            self._audit.clear()
            self._alias.clear()
            self._audit_written = 0

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._done = collections.deque(self._done,
                                           maxlen=int(capacity))

    def set_audit_capacity(self, capacity: int) -> None:
        with self._lock:
            self._audit = collections.deque(self._audit,
                                            maxlen=int(capacity))


class ExemplarStore:
    """Per-histogram-bucket exemplars: the latest observation landing in
    each bucket keeps its request_id (OpenMetrics exemplar semantics).
    Bounded by construction — one slot per bucket per metric."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {bucket_index: {"value", "request_id", "unix_time"}}
        self._store: Dict[str, Dict[int, Dict]] = {}

    def observe(self, name: str, bounds, value: float, rid) -> None:
        if not state.enabled():
            return
        i = bisect.bisect_left(bounds, value)
        with self._lock:
            self._store.setdefault(name, {})[i] = {
                "value": float(value), "request_id": rid,
                "unix_time": time.time()}
        _M_EXEMPLARS.inc()

    def exemplars(self, name: str, bounds=None) -> List[Dict]:
        """All exemplars of one metric, bucket-ordered, with the bucket's
        ``le`` bound attached when ``bounds`` is given."""
        with self._lock:
            items = sorted(self._store.get(name, {}).items())
        out = []
        for i, ex in items:
            ex = dict(ex)
            if bounds is not None:
                ex["le"] = float(bounds[i]) if i < len(bounds) else "+Inf"
            out.append(ex)
        return out

    def bucket_exemplar(self, name: str, index: int) -> Optional[Dict]:
        with self._lock:
            ex = self._store.get(name, {}).get(index)
            return dict(ex) if ex is not None else None

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


_default_tracer = RequestTracer()
_default_exemplars = ExemplarStore()

# a later set_flags({...}) must resize the live ring / refresh the
# cached tick cap, not be silently inert (same contract as the span ring)
watch_flag("obs_requests_capacity",
           lambda v: _default_tracer.set_capacity(int(v)))
watch_flag("obs_request_events_max",
           lambda v: setattr(_default_tracer, "_events_max", int(v)))
watch_flag("obs_audit_capacity",
           lambda v: _default_tracer.set_audit_capacity(int(v)))


def get_request_tracer() -> RequestTracer:
    return _default_tracer


def get_exemplar_store() -> ExemplarStore:
    return _default_exemplars


def observe_with_exemplar(hist, value: float, rid) -> None:
    """Observe ``value`` on a labelless histogram family AND attach the
    bucket exemplar carrying ``rid`` — the call sites that make p99
    readings retrievable (engine TTFT/TPOT)."""
    if not state.enabled():
        return
    hist.observe(value)
    _default_exemplars.observe(hist.name, hist.bounds, value, rid)


def exemplar_for_quantile(hist, q: float) -> Optional[Dict]:
    """The exemplar of the bucket a quantile falls in: reads the live
    histogram's bucket counts, locates the ``q``-quantile bucket (the
    same walk :func:`exposition.quantile` does), and returns that
    bucket's exemplar — falling back to the nearest populated bucket
    above, then below (an adjacent observation is still the right
    request to look at). ``None`` on an empty histogram or when the
    metric never attached exemplars. Given a family, the bucket counts
    are merged across ALL its children — under a replica-scoped router
    the observations live in ``{replica=...}`` series, and the
    exemplar store is bucket-indexed per metric NAME, so the merged
    walk is the one that matches it."""
    if callable(getattr(hist, "series", None)):
        counts, _sum, total = merged_hist_state(hist)
    else:
        counts, _sum, total = _hist_state(hist)
    if not total:
        return None
    target = min(1.0, max(0.0, q)) * total
    cum = 0
    idx = len(counts) - 1
    for i, n in enumerate(counts):
        cum += n
        if n > 0 and cum >= target:
            idx = i
            break
    name = hist.name
    for j in list(range(idx, len(counts))) + list(range(idx - 1, -1, -1)):
        ex = _default_exemplars.bucket_exemplar(name, j)
        if ex is not None:
            return ex
    return None


def requests_payload(sort: str = "ttft",
                     limit: Optional[int] = None) -> Dict:
    """The ``/requests.json`` document: summaries (worst first), the
    TTFT/TPOT exemplars with quantile pointers, and the audit tail."""
    from .metrics import get_registry

    reg = get_registry()
    exemplars = {}
    quantiles = {}
    for name in ("serving_ttft_seconds", "serving_tpot_seconds"):
        fam = reg.histogram(name)
        exs = _default_exemplars.exemplars(name, fam.bounds)
        if exs:
            exemplars[name] = exs
        ex99 = exemplar_for_quantile(fam, 0.99)
        if ex99 is not None:
            quantiles[name] = {"p99": ex99}
    return {
        "version": 1,
        "unix_time": time.time(),
        "pid": os.getpid(),
        "sort": sort,
        "requests": _default_tracer.requests(sort=sort, limit=limit),
        "live": _default_tracer.live_count(),
        "exemplars": exemplars,
        "exemplar_quantiles": quantiles,
        "audit": _default_tracer.audit_entries(),
    }
