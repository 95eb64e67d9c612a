"""Communication / step watchdog — hang detection with teardown; the
port's copy of paddle_tpu/distributed/watchdog.py.

Parity: the reference's CommTaskManager
(paddle/phi/core/distributed/comm_task_manager.h:37) runs a background
thread over enqueued NCCL comm tasks; a task that exceeds its timeout
triggers ErrorHandlingMode::TearDown — the process aborts so the
launcher-level watcher can restart the job.

The observable "comm task" granularity here is the blocking host call —
a step's device-to-host readback, a replica's engine step, a store
rendezvous. The watchdog guards those: a monitor thread scans in-flight
guarded regions, and one that exceeds its timeout logs a diagnostic and
(in ``tear_down`` mode) kills the process with a distinctive exit code.
The serving router guards each replica step with :class:`guarded`; the
HTTP front door's drain runs the emergency hooks.

    wd = CommWatchdog(timeout=120.0)
    with wd.task("readback-step3"):
        toks = out.cpu()                  # blocking sync

Not ported yet: the elastic-restart feed (the reference's
``distributed/launch --np M:N`` dead-pod watcher that restarts the job
after a teardown), which comes with the port's launcher (ROADMAP A10).
Metric names, flight-event fields and the exit code equal the
reference's.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

from ..observability import flight_recorder as _flight
from ..observability import state as _obs_state
from ..observability.catalog import instrument as _instrument

__all__ = ["CommWatchdog", "install", "uninstall", "current", "guarded",
           "register_emergency_hook", "unregister_emergency_hook",
           "run_emergency_hooks"]

_M_HEARTBEAT = _instrument("watchdog_heartbeat_age_seconds")
_M_TIMEOUTS = _instrument("watchdog_timeouts_total")

TEARDOWN_EXIT_CODE = 77     # distinctive: "watchdog killed me"

_global: Optional["CommWatchdog"] = None

# Emergency hooks: run when ANY watchdog sees a timeout, BEFORE a
# tear_down exit — the last chance to flush an emergency checkpoint
# (the train loop's emergency checkpoint registers here). Hooks are
# called from the monitor thread and must not raise (raises are swallowed
# with a stderr note so a broken hook can't mask the teardown).
_emergency_hooks: list = []


def register_emergency_hook(fn: Callable[[str, float], None]):
    """Register ``fn(task_name, elapsed)`` to run on watchdog timeout,
    before any teardown. Returns ``fn`` so it can be unregistered."""
    _emergency_hooks.append(fn)
    return fn


def unregister_emergency_hook(fn) -> None:
    try:
        _emergency_hooks.remove(fn)
    except ValueError:
        pass


def _run_emergency_hooks(name: str, elapsed: float,
                         budget: float = 60.0) -> None:
    """Run hooks on a helper thread with a hard time budget: an emergency
    checkpoint that itself hangs (e.g. a device readback on the very
    runtime that wedged) must not block the tear_down exit — hang
    detection that can hang is worse than no checkpoint."""
    def run_all():
        for fn in list(_emergency_hooks):
            try:
                fn(name, elapsed)
            except Exception as e:
                sys.stderr.write(
                    f"[paddle_tpu_torch watchdog] emergency hook {fn!r} "
                    f"raised {e!r}\n")
                sys.stderr.flush()

    if not _emergency_hooks:
        return
    t = threading.Thread(target=run_all, daemon=True)
    t.start()
    t.join(budget)
    if t.is_alive():
        sys.stderr.write(
            f"[paddle_tpu_torch watchdog] emergency hooks still running "
            f"after {budget:.0f}s budget — proceeding without them\n")
        sys.stderr.flush()


def run_emergency_hooks(name: str, elapsed: float = 0.0,
                        budget: float = 60.0) -> None:
    """Run the registered emergency hooks outside a watchdog timeout —
    the serving front door's graceful drain flushes state through the
    SAME hook registry the train loop's SIGTERM/watchdog paths use
    (one place to register "save my work before the process exits"),
    with the same hard time budget."""
    _run_emergency_hooks(name, elapsed, budget)


class _Task:
    __slots__ = ("name", "start", "timeout")

    def __init__(self, name: str, timeout: float):
        self.name = name
        self.start = time.monotonic()   # immune to wall-clock steps
        self.timeout = timeout


class CommWatchdog:
    """Background monitor over guarded blocking regions.

    mode:
      - ``"tear_down"`` (reference ErrorHandlingMode::TearDown): print a
        diagnostic and ``os._exit(TEARDOWN_EXIT_CODE)`` — the launcher's
        dead-pod detection owns recovery;
      - ``"log"``: report via ``on_timeout`` (default: stderr) and keep
        running — the reference's NoHandling with logging.
    """

    def __init__(self, timeout: float = 300.0, mode: str = "tear_down",
                 on_timeout: Optional[Callable[[str, float], None]] = None,
                 poll: float = 0.2, hook_budget: float = 60.0):
        if mode not in ("tear_down", "log"):
            raise ValueError(f"mode={mode!r}: 'tear_down' or 'log'")
        self.hook_budget = hook_budget
        self.timeout = timeout
        self.mode = mode
        self.on_timeout = on_timeout
        self.poll = poll
        self._tasks: Dict[int, _Task] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._fired = []               # (name, elapsed) of timeouts seen
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- guarding ---------------------------------------------------------
    def task(self, name: str, timeout: Optional[float] = None):
        """Context manager marking one blocking region as watched."""
        wd = self

        class _Guard:
            def __enter__(g):
                g._t = _Task(name, wd.timeout if timeout is None
                             else timeout)
                with wd._lock:
                    wd._tasks[id(g._t)] = g._t
                return g._t

            def __exit__(g, *exc):
                with wd._lock:
                    wd._tasks.pop(id(g._t), None)
                return False

        return _Guard()

    # -- monitor ----------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.poll):
            now = time.monotonic()
            overdue = None
            oldest = None
            with self._lock:
                for t in self._tasks.values():
                    if oldest is None or t.start < oldest:
                        oldest = t.start
                    if now - t.start > t.timeout:
                        overdue = t
                        break
                if overdue is not None:
                    self._tasks.pop(id(overdue), None)
            if _obs_state.enabled():
                # heartbeat age: how long the oldest guarded blocking
                # region has been in flight (0 = nothing blocked)
                _M_HEARTBEAT.set(0.0 if oldest is None else now - oldest)
            if overdue is None:
                continue
            elapsed = now - overdue.start
            self._fired.append((overdue.name, elapsed))
            _M_TIMEOUTS.inc()
            _flight.record("watchdog_timeout", task=overdue.name,
                           elapsed=round(elapsed, 3),
                           timeout=overdue.timeout, mode=self.mode)
            msg = (f"[paddle_tpu_torch watchdog] task '{overdue.name}' "
                   f"exceeded {overdue.timeout:.0f}s "
                   f"(elapsed {elapsed:.0f}s) — ")
            # emergency checkpoint window: runs in BOTH modes, before a
            # tear_down exit (reference analogue: comm task dump before
            # TearDown aborts the process)
            _run_emergency_hooks(overdue.name, elapsed, self.hook_budget)
            # post-mortem AFTER the hooks: the dump then records the
            # emergency checkpoint the hooks just flushed
            _flight.maybe_dump("watchdog")
            if self.mode == "tear_down":
                sys.stderr.write(msg + "tearing down for restart\n")
                sys.stderr.flush()
                os._exit(TEARDOWN_EXIT_CODE)
            if self.on_timeout is not None:
                try:
                    self.on_timeout(overdue.name, elapsed)
                except Exception as e:   # a raising alert hook must not
                    sys.stderr.write(     # kill the monitor thread
                        msg + f"on_timeout raised {e!r}\n")
                    sys.stderr.flush()
            else:
                sys.stderr.write(msg + "continuing (log mode)\n")
                sys.stderr.flush()

    def stop(self):
        self._stop.set()
        self._thread.join(2)


def install(wd: Optional[CommWatchdog] = None, **kw) -> CommWatchdog:
    """Install a process-wide watchdog; :class:`guarded` regions use it."""
    global _global
    if _global is not None:
        _global.stop()
    _global = wd or CommWatchdog(**kw)
    return _global


def uninstall():
    global _global
    if _global is not None:
        _global.stop()
    _global = None


def current() -> Optional[CommWatchdog]:
    return _global


class guarded:
    """Guard a region under the INSTALLED watchdog (no-op when absent) —
    the hook the router's replica steps use."""

    def __init__(self, name: str):
        self.name = name
        self._cm = None

    def __enter__(self):
        wd = _global
        if wd is not None:
            self._cm = wd.task(self.name)
            self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            return self._cm.__exit__(*exc)
        return False
