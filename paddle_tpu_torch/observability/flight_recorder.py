"""Crash flight recorder — the last N structured events + a post-mortem;
the port's copy of paddle_tpu/observability/flight_recorder.py.

When a job dies at 3am the registry's gauges die with it; what the
operator needs is the ordered tail of WHAT HAPPENED: step markers,
compiles, rollbacks, preemptions, flag flips, stragglers, and which
spans were still open. This module keeps a bounded ring of structured
events (``FLAGS_obs_flight_capacity``, oldest evicted) and dumps a JSON
post-mortem — events + a full metrics snapshot + open spans + the
goodput report — on the paths that matter:

- **unhandled exception** escaping ``ResilientTrainLoop.run``
  (``distributed/resilience/train_loop.py``; and, after :func:`install`,
  any ``sys.excepthook`` exception);
- **watchdog timeout**, after the emergency hooks have flushed their
  checkpoint (so the dump records the emergency save too);
- the **SIGTERM emergency path** of the resilience runtime.

Auto-dumps go to ``FLAGS_obs_postmortem_dir`` (empty = auto-dump off;
explicit :meth:`FlightRecorder.dump` paths always work) and never raise:
a failing dump must not mask the crash it is recording. Pretty-print a
dump with ``python -m paddle_tpu_torch.tools.obs_dump --postmortem <file>``
(or the JAX package's ``tools/obs_dump.py``: both read either dump).

Recording is near-zero when ``FLAGS_obs_enabled`` is off (one global
read) and O(1) when on (dict build + deque append).
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ..framework.flags import (define_flag, get_flag, watch_all_flags,
                               watch_flag)
from . import state
from .catalog import instrument as _instrument

__all__ = ["FlightRecorder", "get_recorder", "record", "dump",
           "maybe_dump", "install", "uninstall"]

define_flag("obs_flight_capacity", 512,
            "flight-recorder ring retention (structured events; oldest "
            "evicted)")
define_flag("obs_postmortem_dir", "",
            "directory for automatic post-mortem JSON dumps on crash / "
            "watchdog timeout / SIGTERM; empty disables auto-dumps")

_M_DUMPS = _instrument("flight_recorder_dumps_total")


class FlightRecorder:
    """Bounded ring of ``{"t", "kind", ...}`` events + the dump logic."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None \
            else int(get_flag("obs_flight_capacity"))
        self._ring: collections.deque = collections.deque(maxlen=cap)
        self._seq_lock = threading.Lock()
        self._seq = 0

    # -- recording --------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one structured event (no-op while disabled). Fields
        must be JSON-friendly scalars/lists — ids are fine here (the ring
        is bounded evidence, not a metric label set)."""
        if not state.enabled():
            return
        ev = {"t": time.time(), "kind": str(kind)}
        ev.update(fields)
        self._ring.append(ev)          # deque append is GIL-atomic

    def events(self) -> List[Dict]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def set_capacity(self, capacity: int) -> None:
        self._ring = collections.deque(self._ring, maxlen=int(capacity))

    # -- post-mortem ------------------------------------------------------
    def postmortem(self, trigger: str = "manual",
                   error: Optional[BaseException] = None) -> Dict:
        """The full post-mortem document: ring events, every thread's
        open spans (what was in flight), a metrics snapshot, and the
        goodput report."""
        from . import exposition, goodput, tracing

        out = {
            "version": 1,
            "unix_time": time.time(),
            "pid": os.getpid(),
            "trigger": trigger,
            "events": self.events(),
            "open_spans": {str(tid): names for tid, names in
                           tracing.get_tracer().open_spans().items()},
            "metrics": exposition.snapshot(),
        }
        if error is not None:
            out["error"] = {"type": type(error).__name__,
                            "message": str(error)[:2000]}
        try:
            out["goodput"] = goodput.get_tracker().report()
        except Exception:            # a broken tracker must not block dumps
            pass
        try:
            # which requests were in flight (and which were slow) when
            # the process died — live rows ride with partial summaries
            from . import request_trace

            rp = request_trace.requests_payload()
            if rp["requests"] or rp["audit"]:
                out["requests"] = rp
        except Exception:          # a broken tracer must not block dumps
            pass
        try:
            # the numerics stats table + the last NaN-provenance verdict
            # (which layer went bad first) ride the post-mortem too
            from . import numerics

            npay = numerics.payload()
            if npay["rows"] or npay["provenance"]:
                out["numerics"] = npay
        except Exception:          # a broken probe must not block dumps
            pass
        try:
            # the derived-signal history tail + last alert table: the
            # TRAJECTORY into the failure, not just the final snapshot
            from . import timeseries

            tpay = timeseries.history_payload()
            if tpay["entries"] or tpay["alerts"]:
                out["timeseries"] = tpay
        except Exception:          # a broken sampler must not block dumps
            pass
        return out

    def dump(self, path: Optional[str] = None, trigger: str = "manual",
             error: Optional[BaseException] = None) -> Optional[str]:
        """Write the post-mortem JSON. ``path=None`` derives a unique
        name under ``FLAGS_obs_postmortem_dir`` (returns ``None`` when
        that flag is empty — auto-dumps are opt-in)."""
        if path is None:
            d = str(get_flag("obs_postmortem_dir"))
            if not d:
                return None
            with self._seq_lock:
                self._seq += 1
                seq = self._seq
            path = os.path.join(
                d, f"postmortem-{os.getpid()}-{seq}.json")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            # default=repr: an event field that slipped in as a numpy
            # scalar must not abort the one dump that matters
            json.dump(self.postmortem(trigger=trigger, error=error), f,
                      indent=1, default=repr)
        _M_DUMPS.inc(trigger=trigger)
        return path


_default_recorder = FlightRecorder()

# a later set_flags({'obs_flight_capacity': N}) must resize the live
# ring, not be silently inert (same contract as the span ring)
watch_flag("obs_flight_capacity",
           lambda v: _default_recorder.set_capacity(int(v)))

# flag flips are incident evidence (an operator toggling FLAGS_ft_* or
# SLO targets mid-incident): every set_flags change lands in the ring
watch_all_flags(lambda name, value: _default_recorder.record(
    "flag_change", flag=name, value=repr(value)))


def get_recorder() -> FlightRecorder:
    return _default_recorder


def record(kind: str, **fields) -> None:
    """Append one event to the default recorder."""
    _default_recorder.record(kind, **fields)


def dump(path: Optional[str] = None, trigger: str = "manual",
         error: Optional[BaseException] = None) -> Optional[str]:
    return _default_recorder.dump(path, trigger=trigger, error=error)


def maybe_dump(trigger: str,
               error: Optional[BaseException] = None) -> Optional[str]:
    """The crash-path dump: writes only when observability is enabled AND
    ``FLAGS_obs_postmortem_dir`` is set, and NEVER raises — the dump is
    a side effect of a failure already in progress."""
    if not state.enabled():
        return None
    try:
        return _default_recorder.dump(trigger=trigger, error=error)
    except Exception as e:
        sys.stderr.write(
            f"[paddle_tpu_torch obs] post-mortem dump failed: {e!r}\n")
        return None


_prev_excepthook = None


def install(postmortem_dir: Optional[str] = None) -> None:
    """Chain into ``sys.excepthook`` so ANY unhandled exception records
    an event and writes a post-mortem before the normal traceback.
    Idempotent; ``postmortem_dir`` optionally sets the auto-dump flag."""
    global _prev_excepthook
    if postmortem_dir:
        from ..framework.flags import set_flags

        set_flags({"obs_postmortem_dir": postmortem_dir})
    if _prev_excepthook is not None:
        return
    _prev_excepthook = sys.excepthook

    def hook(exc_type, exc, tb):
        _default_recorder.record("unhandled_exception",
                                 error=exc_type.__name__,
                                 message=str(exc)[:2000])
        maybe_dump("exception", error=exc)
        (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    sys.excepthook = hook


def uninstall() -> None:
    global _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
