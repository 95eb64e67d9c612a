"""Goodput accounting — what fraction of wall-clock actually trained; the
port's copy of paddle_tpu/observability/goodput.py (the flight recorder's
post-mortem embeds its report; ``ResilientTrainLoop`` feeds its train
buckets).

A fleet operator's first question is not "what is happening right now"
(the metrics registry answers that) but "of the last N hours, how many
produced optimizer steps?". This module classifies run wall-clock into
buckets:

    productive_step   committed train-step attempts
    compile           to_static trace+compile (jit guard-cache misses)
    checkpoint_save   atomic checkpoint commits
    checkpoint_load   load_latest_valid on resume
    data_wait         consumer blocked on the input pipeline
    rollback_retry    rolled-back step attempts (NaN / loss spike)
    resume            non-load resume work (state restore, loader replay)
    idle              wall-clock nothing accounted for

fed by the SAME call sites that already emit the histograms
(``ResilientTrainLoop``, ``jit.to_static``, ``io.DataLoader``): each
accounts its measured duration here as it observes it, so goodput can
never disagree with the histograms. :meth:`GoodputTracker.report`
normalizes over ``max(wall, accounted)`` — bucket fractions always sum
to 1.0 even when accounted sections overlap (e.g. a to_static compile
inside a step attempt).

The straggler exchange (:func:`exchange_step_times`) publishes each
host's recent step time through a rendezvous store with a
``gather(key, rank, world_size, value)`` method and flags hosts whose step time exceeds
``FLAGS_obs_straggler_factor`` x the cross-host median — the cheap
always-on version of the reference's comm-task-manager slow-rank dumps.

Everything is near-zero when ``FLAGS_obs_enabled`` is off: ``account``
is one global read + return.
"""
from __future__ import annotations

import threading
import time
from statistics import median
from typing import Dict, List, Optional, Tuple

from ..framework.flags import define_flag, get_flag
from . import state
from .catalog import instrument as _instrument

__all__ = ["BUCKETS", "GoodputTracker", "get_tracker", "account",
           "goodput_section", "exchange_step_times"]

# every bucket report() emits; all but "idle" are accountable
BUCKETS = ("productive_step", "compile", "checkpoint_save",
           "checkpoint_load", "data_wait", "rollback_retry", "resume",
           "idle")

define_flag("obs_straggler_factor", 1.5,
            "a host is flagged as a straggler when its exchanged step "
            "time exceeds this factor x the cross-host median")

_M_RATIO = _instrument("goodput_ratio")
_M_TIME = _instrument("goodput_time_seconds_total")
_M_STRAGGLERS = _instrument("goodput_stragglers_total")


class GoodputTracker:
    """Accumulates seconds per bucket against a run-start timestamp."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._acc: Dict[str, float] = {b: 0.0 for b in BUCKETS
                                       if b != "idle"}

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Zero every bucket and forget the run start (test isolation)."""
        with self._lock:
            self._t0 = None
            for b in self._acc:
                self._acc[b] = 0.0

    def start(self) -> None:
        """Zero and stamp the run start (wall-clock epoch for idle)."""
        self.reset()
        with self._lock:
            self._t0 = time.perf_counter()

    def ensure_started(self) -> None:
        """Stamp the run start if not already running — the idempotent
        hook the train loop calls so pre-step wall-clock counts as idle
        instead of vanishing."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.perf_counter()

    # -- accounting -------------------------------------------------------
    def account(self, bucket: str, seconds: float) -> None:
        """Attribute ``seconds`` of wall-clock to ``bucket``. No-op while
        observability is disabled."""
        if not state.enabled():
            return
        if bucket not in self._acc:
            raise ValueError(f"unknown goodput bucket {bucket!r} "
                             f"(accountable: {tuple(self._acc)})")
        seconds = max(0.0, float(seconds))
        with self._lock:
            if self._t0 is None:
                # auto-start: the first accounted interval began the run
                self._t0 = time.perf_counter() - seconds
            self._acc[bucket] += seconds
        _M_TIME.inc(seconds, bucket=bucket)

    # -- readout ----------------------------------------------------------
    def report(self) -> Dict:
        """Bucket seconds + fractions (summing to 1.0) + goodput ratio.

        ``total`` is ``max(wall, sum(accounted))``: overlapping accounted
        sections can exceed wall-clock, and normalizing over the max
        keeps the fractions a true partition. Refreshes the
        ``goodput_ratio`` gauge when enabled."""
        with self._lock:
            acc = dict(self._acc)
            t0 = self._t0
        wall = 0.0 if t0 is None else max(0.0, time.perf_counter() - t0)
        accounted = sum(acc.values())
        total = max(wall, accounted)
        acc["idle"] = max(0.0, total - accounted)
        if total > 0:
            fractions = {b: acc[b] / total for b in BUCKETS}
        else:
            fractions = {b: 0.0 for b in BUCKETS}
        ratio = fractions["productive_step"]
        if state.enabled():
            _M_RATIO.set(ratio)
        return {
            "wall_seconds": wall,
            "total_seconds": total,
            "goodput_ratio": ratio,
            "badput_seconds": total - acc["productive_step"],
            "seconds": {b: acc[b] for b in BUCKETS},
            "fractions": fractions,
        }


_default_tracker = GoodputTracker()


def get_tracker() -> GoodputTracker:
    return _default_tracker


def account(bucket: str, seconds: float) -> None:
    """Attribute seconds to a bucket on the default tracker."""
    _default_tracker.account(bucket, seconds)


class goodput_section:  # noqa: N801 — context manager, lowercase like trace_span
    """``with goodput_section("checkpoint_save"): ...`` — times the body
    and accounts it. Near-zero when disabled (no clock reads)."""

    __slots__ = ("bucket", "_tracker", "_t0")

    def __init__(self, bucket: str, tracker: Optional[GoodputTracker] = None):
        self.bucket = bucket
        self._tracker = tracker
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter() if state.enabled() else None
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is not None:
            (self._tracker or _default_tracker).account(
                self.bucket, time.perf_counter() - self._t0)
            self._t0 = None
        return False


def exchange_step_times(store, rank: int, world_size: int,
                        step_seconds: float, round_id: int,
                        k: Optional[float] = None,
                        prefix: str = "goodput/steptime",
                        ) -> Tuple[List[float], List[int]]:
    """Publish this host's step time and flag stragglers.

    Every participating host calls with the same ``round_id`` (e.g. the
    checkpoint index). ``round_id`` is required and must be fresh per
    exchange: store keys persist, so reusing a round would hand fast
    ranks the PREVIOUS round's values instead of blocking for the new
    ones. The store's :meth:`TCPStore.gather` blocks until
    all ``world_size`` values exist. A rank whose time exceeds
    ``k x median`` (default ``FLAGS_obs_straggler_factor``) is a
    straggler: each host bumps ``goodput_stragglers_total`` and lands a
    structured ``straggler`` event in the flight recorder, so a
    post-mortem shows WHO was slow, not just that someone was.

    Returns ``(times_by_rank, straggler_ranks)``.
    """
    if k is None:
        k = float(get_flag("obs_straggler_factor"))
    raw = store.gather(f"{prefix}/{round_id}", rank, world_size,
                       repr(float(step_seconds)))
    times = [float(v) for v in raw]
    med = median(times)
    stragglers = [r for r, t in enumerate(times) if med > 0 and t > k * med]
    if stragglers and state.enabled():
        _M_STRAGGLERS.inc(len(stragglers))
        from . import flight_recorder
        flight_recorder.record(
            "straggler", rank=rank, ranks=stragglers, round=round_id,
            median_seconds=med, times=times, factor=k)
    return times, stragglers
