"""Span tracer: ``trace_span`` + ring-buffer retention + Chrome-trace
export — the port's copy of paddle_tpu/observability/tracing.py.

Spans are host-side wall-clock intervals with thread-local nesting (each
thread keeps its own open-span stack), retained in a bounded ring
(``FLAGS_obs_trace_capacity``; oldest evicted) and exported as
chrome://tracing / Perfetto "X" (complete) events.

While an on-demand device capture is live (:mod:`.profiling`), an open
``trace_span`` also opens ``torch.profiler.record_function(name)``, so
the host spans enclose the kernels in the device trace.

The profiler-ledger hook: a closing ``trace_span`` feeds the innermost
active ``Profiler``'s host-event ledger of ``paddle_tpu_torch.profiler``,
looked up through ``sys.modules`` only (tracing never imports it). The
port has no ``profiler`` package yet (ROADMAP A11), so until it lands the
hook finds nothing and reads nothing.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ..framework.flags import get_flag, watch_flag
from . import state

__all__ = ["Span", "SpanTracer", "trace_span", "get_tracer",
           "export_chrome_trace", "set_thread_attrs"]

# Thread-local attrs stamped onto every span recorded FROM this thread:
# the replica router's scoped step threads set {"replica": name}
# here (via metrics.ScopedView.activate), so serving.step and every
# nested span in a Chrome-trace export is attributable to its replica.
# Explicit span attrs win on a key collision.
_tls_attrs = threading.local()


def set_thread_attrs(attrs: Optional[Dict[str, str]]) -> None:
    """Install (or clear, with ``None``) the calling thread's ambient
    span attrs."""
    _tls_attrs.attrs = dict(attrs) if attrs else None

# perf_counter gives monotonic high-resolution intervals; anchor it once
# against the wall clock so exported timestamps are epoch-comparable
_T0_PERF = time.perf_counter()
_T0_WALL = time.time()

# While an on-demand device capture is live (observability.profiling),
# this holds a callable name -> context manager
# (torch.profiler.record_function) so host spans land inside the device
# trace. None the rest of the time —
# trace_span pays one global read for the correlation hook.
_ANNOTATION_FACTORY = None


def _set_annotation_factory(fn) -> None:
    global _ANNOTATION_FACTORY
    _ANNOTATION_FACTORY = fn


def _json_safe(v):
    """Span-arg values must survive json.dump: JSON scalars and plain
    containers pass through (containers recursively sanitized), anything
    else (numpy scalars, arrays, objects) is stringified."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


class Span:
    __slots__ = ("name", "t0", "t1", "tid", "depth", "attrs")

    def __init__(self, name, t0, t1, tid, depth, attrs):
        self.name = name
        self.t0 = t0                 # perf_counter seconds
        self.t1 = t1
        self.tid = tid
        self.depth = depth
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class SpanTracer:
    """Ring of completed spans + per-thread open-span stacks."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None \
            else int(get_flag("obs_trace_capacity"))
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._tls = threading.local()
        # tid -> that thread's live open-span stack (the same list object
        # the thread mutates): lets the flight recorder answer "what was
        # in flight" at crash time without touching other threads
        self._stacks: Dict[int, List[str]] = {}

    # -- recording --------------------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
            self._stacks[threading.get_ident()] = st
        return st

    def open_spans(self) -> Dict[int, List[str]]:
        """tid -> names of spans currently OPEN on that thread (outermost
        first). Finished threads drop out once their stack empties."""
        return {tid: list(st) for tid, st in list(self._stacks.items())
                if st}

    def record(self, name: str, t0: float, t1: float,
               attrs: Optional[Dict] = None, depth: Optional[int] = None):
        """Append one completed span (deque append is GIL-atomic)."""
        ambient = getattr(_tls_attrs, "attrs", None)
        if ambient:
            merged = dict(ambient)
            if attrs:
                merged.update(attrs)
            attrs = merged
        self._ring.append(Span(
            name, t0, t1, threading.get_ident(),
            len(self._stack()) if depth is None else depth, attrs or {}))

    def spans(self) -> List[Span]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def set_capacity(self, capacity: int) -> None:
        self._ring = collections.deque(self._ring, maxlen=capacity)

    # -- export -----------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """chrome://tracing / Perfetto JSON object ("X" complete events;
        ts/dur in microseconds since the process trace epoch)."""
        pid = os.getpid()
        events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": "paddle_tpu_torch"}}]
        for s in self.spans():
            # keep EVERY span arg: values that aren't JSON scalars (a
            # numpy int riding in from an instrumented call site) are
            # stringified rather than dropped — and rather than aborting
            # the whole export at json.dump time; a user arg literally
            # named "depth" wins over the synthetic nesting field
            args = {k: _json_safe(v) for k, v in s.attrs.items()}
            args.setdefault("depth", s.depth)
            events.append({
                "name": s.name, "ph": "X", "cat": "obs",
                "pid": pid, "tid": s.tid,
                "ts": (s.t0 - _T0_PERF) * 1e6,
                "dur": s.duration * 1e6,
                "args": args,
            })
        return {"traceEvents": events,
                "metadata": {"trace_epoch_unix_s": _T0_WALL}}

    def export_chrome_trace(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_default_tracer = SpanTracer()

# the default ring is sized at import; a later
# paddle.set_flags({'obs_trace_capacity': N}) must resize it, not be
# silently inert (same class of fix as state's obs_enabled watcher)
watch_flag("obs_trace_capacity",
           lambda v: _default_tracer.set_capacity(int(v)))


def get_tracer() -> SpanTracer:
    return _default_tracer


def export_chrome_trace(path: str) -> str:
    """Write the default tracer's ring as a Chrome-trace JSON file."""
    return _default_tracer.export_chrome_trace(path)


class trace_span:  # noqa: N801 — context manager, lowercase like the verb
    """``with trace_span("serving.prefill", bucket=64): ...``

    Near-zero when disabled (one enabled() check, no clock reads). The
    span records even when the body raises — a failing step is exactly
    the span you want on the timeline.
    """

    __slots__ = ("name", "attrs", "_t0", "_stack", "_ann")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._t0 = None
        self._stack = None
        self._ann = None

    def __enter__(self):
        # reset every entry: a reused instance must not inherit a stale
        # start time (or stack) from a previous — possibly enabled — use
        self._t0 = None
        self._stack = None
        self._ann = None
        if not state.enabled():
            return self
        tr = _default_tracer
        self._stack = tr._stack()
        self._stack.append(self.name)
        if _ANNOTATION_FACTORY is not None:
            # a device capture is live (observability.profiling): mirror
            # the span as a torch.profiler.record_function range so the
            # device trace shows which kernels ran under which host phase
            try:
                self._ann = _ANNOTATION_FACTORY(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:
            return False
        t1 = time.perf_counter()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
            self._ann = None
        stack = self._stack
        depth = len(stack) - 1
        if stack and stack[-1] == self.name:
            stack.pop()
        attrs = self.attrs if exc_type is None \
            else dict(self.attrs, error=exc_type.__name__)
        _default_tracer.record(self.name, self._t0, t1, attrs, depth=depth)
        _feed_profiler_ledger(self.name, self._t0, t1)
        self._t0 = None
        return False


def _feed_profiler_ledger(name: str, t0: float, t1: float) -> None:
    """One annotation feeds both: a closing span lands in the innermost
    active Profiler's host ledger (sys.modules lookup only — importing the
    profiler from here would pull torch into this stdlib-only package).
    The port's ``profiler`` package comes with ROADMAP A11; until then
    the lookup finds nothing."""
    prof = sys.modules.get("paddle_tpu_torch.profiler")
    if prof is not None and getattr(prof, "_ACTIVE", None):
        try:
            prof._ACTIVE[-1]._ledger.add(name, t0, t1)
        except Exception:
            pass          # a torn-down profiler must not break the span
