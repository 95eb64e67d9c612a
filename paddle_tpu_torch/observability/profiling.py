"""On-demand device profiling: windowed ``torch.profiler`` captures — the
port's copy of paddle_tpu/observability/profiling.py.

The always-on layer (metrics + spans) tells you a step is slow; the
question that follows — "what did the DEVICE actually execute" — needs
a real profiler trace, which is far too heavy to leave running. This
module is the control plane for capturing one on demand, windowed to a
step count, from a live job:

- ``GET /control/profile?steps=N`` on the exposition server (or
  :func:`request_capture` in-process, or ``SIGUSR2`` after
  :func:`install_sigusr2`) ARMS a capture;
- the capture starts at the next step boundary (``step_tick`` is wired
  into ``LLMEngine.step``) and stops after ``N`` steps, so the trace
  covers whole steps, never a torn window. A capture is one
  ``torch.profiler.profile(activities=[CPU, CUDA])`` (CPU only without
  a card) entered at the starting tick and left at the stopping one;
  its Chrome trace is written to ``<dir>/trace.json`` and the profile
  object stays readable in-process (:meth:`ProfileController.last_profile`);
- while a capture is live, ``trace_span`` additionally opens
  ``torch.profiler.record_function(name)`` so the host-side spans
  enclose the kernels in the device trace — Perfetto shows which
  kernels ran under which engine phase;
- each completed capture lands in the flight recorder
  (``profile_capture`` event) and bumps ``obs_profile_captures_total``.

``step_tick`` costs one attribute read when idle — the hot loops call
it unconditionally. torch is imported only when a capture actually
starts (the package's no-heavy-deps contract holds until then).

The control plane itself is deliberately OUTSIDE the
``FLAGS_obs_enabled`` gate: a capture is an explicit operator action
and works on a job running with observability off. What needs the flag
ON is the telemetry AROUND the capture — the
``obs_profile_captures_total`` bump, the ``profile_capture`` flight
event, and the host-span → ``record_function`` correlation (a disabled
``trace_span`` never runs its body, so the device trace shows raw ops
with no host phases). For correlated traces, enable observability
before arming.
"""
from __future__ import annotations

import os
import signal
import tempfile
import threading
import time
from typing import Dict, Optional

from ..framework.flags import get_flag
from . import tracing
from .catalog import instrument as _instrument

__all__ = ["ProfileController", "get_controller",
           "get_profile_controller", "request_capture", "step_tick",
           "install_sigusr2", "uninstall_sigusr2"]

# FLAGS_obs_profile_dir / obs_profile_default_steps are defined in the
# package __init__ (this module is lazily loaded; the flags must
# register up front so set_flags sees them).

_M_CAPTURES = _instrument("obs_profile_captures_total")

class ProfileController:
    """Arm/step/stop state machine for windowed device captures.

    ``_pending`` is the instance's idle fast path: hot loops read it
    (one attribute load) before touching the lock. ``_sig_armed`` is
    the SIGUSR2 deferral flag — the signal handler must not take the
    non-reentrant lock (the main thread may already hold it inside
    step_tick), so it only sets flags and the next step boundary arms
    the capture on the handler's behalf."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = False
        self._sig_armed = False
        self._steps_left = 0
        self._armed_n = 0
        self._active = False
        self._dir: Optional[str] = None
        self._started_unix: Optional[float] = None
        self._seq = 0
        self._last: Optional[Dict] = None
        self._prof = None
        self._last_prof = None

    # -- control ----------------------------------------------------------
    def request(self, steps: Optional[int] = None,
                out_dir: Optional[str] = None) -> Dict:
        """Arm a capture spanning ``steps`` step boundaries. Returns a
        status dict (also the ``/control/profile`` response body). A
        second request while one is armed/active is rejected — two
        overlapping profiler sessions would abort the first."""
        n = int(steps) if steps is not None else int(
            get_flag("obs_profile_default_steps"))
        if n <= 0:
            return {"ok": False, "bad_request": True,
                    "error": f"steps must be > 0, got {n}"}
        with self._lock:
            if self._active or self._steps_left > 0:
                return {"ok": False, "error": "capture already in flight",
                        "status": self._status_locked()}
            self._steps_left = n
            self._armed_n = n
            self._seq += 1
            self._dir = self._derive_dir(out_dir)
            self._pending = True
            return {"ok": True, "armed_steps": n, "dir": self._dir,
                    "status": self._status_locked()}

    def _derive_dir(self, out_dir: Optional[str]) -> str:
        if out_dir:
            return out_dir
        flag = str(get_flag("obs_profile_dir"))
        if flag:
            return os.path.join(flag, f"capture-{self._seq}")
        return os.path.join(
            tempfile.gettempdir(),
            f"paddle_tpu_torch_profile-{os.getpid()}-{self._seq}")

    def step_tick(self) -> None:
        """One engine/train step boundary. Starts the armed capture,
        counts down, stops at zero. Called with ``_pending`` true only."""
        if self._sig_armed:
            # a SIGUSR2 landed since the last boundary: arm the default
            # window HERE, outside signal context (see __init__ docstring)
            self._sig_armed = False
            self.request()
        with self._lock:
            if not self._active:
                if self._steps_left <= 0:
                    self._pending = False
                    return
                self._start_locked()
                return
            self._steps_left -= 1
            if self._steps_left <= 0:
                self._stop_locked()
                self._pending = False

    def stop(self) -> Dict:
        """Force-stop (an idle job whose armed capture never saw a
        step, or an operator cutting a window short)."""
        with self._lock:
            if self._active:
                self._stop_locked()
            self._steps_left = 0
            self._sig_armed = False
            self._pending = False
            return self._status_locked()

    def last_profile(self):
        """The ``torch.profiler.profile`` of the last completed capture
        (its ``events()`` / ``key_averages()`` read in-process), or
        None."""
        return self._last_prof

    def status(self) -> Dict:
        with self._lock:
            return self._status_locked()

    def _status_locked(self) -> Dict:
        out = {"active": self._active, "steps_left": self._steps_left,
               "dir": self._dir, "last_capture": self._last}
        if self._sig_armed:
            out["sig_armed"] = True
        return out

    # -- capture plumbing (lock held) -------------------------------------
    def _start_locked(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self._dir, exist_ok=True)
            self._prof = profile(activities=acts)
            self._prof.start()
        except Exception as e:            # no backend / second profiler
            self._prof = None
            self._steps_left = 0
            self._last = {"ok": False, "error": repr(e), "dir": self._dir}
            from . import flight_recorder

            flight_recorder.record("profile_capture_failed",
                                   dir=self._dir, error=repr(e))
            return
        self._active = True
        self._started_unix = time.time()
        # host spans correlate with device ops only while capturing:
        # trace_span wraps its body in a record_function via this hook
        tracing._set_annotation_factory(_annotation)

    def _stop_locked(self) -> None:
        tracing._set_annotation_factory(None)
        steps = self._armed_n
        prof, self._prof = self._prof, None
        trace = os.path.join(self._dir, "trace.json")
        try:
            prof.stop()
            dur = time.time() - (self._started_unix or time.time())
            prof.export_chrome_trace(trace)
        except Exception as e:
            self._active = False
            self._last = {"ok": False, "error": repr(e), "dir": self._dir}
            return
        self._active = False
        self._last_prof = prof
        self._last = {"ok": True, "dir": self._dir, "trace": trace,
                      "seconds": dur, "unix_time": time.time()}
        _M_CAPTURES.inc()
        from . import flight_recorder

        flight_recorder.record("profile_capture", dir=self._dir,
                               seconds=round(dur, 6), steps=steps)


def _annotation(name: str):
    import torch

    return torch.profiler.record_function(name)


_default_controller = ProfileController()


def get_controller() -> ProfileController:
    return _default_controller


# the name the package re-exports (observability.get_profile_controller;
# `get_controller` alone would shadow poorly next to tracing.get_tracer)
get_profile_controller = get_controller


def request_capture(steps: Optional[int] = None,
                    out_dir: Optional[str] = None) -> Dict:
    """Arm a windowed device capture on the default controller."""
    return _default_controller.request(steps=steps, out_dir=out_dir)


def step_tick() -> None:
    """The per-step hook: near-zero while nothing is armed (one
    attribute read on the default controller), drives the capture
    window when something is."""
    if not _default_controller._pending:
        return
    _default_controller.step_tick()


_prev_sigusr2 = None


def install_sigusr2() -> bool:
    """``kill -USR2 <pid>`` arms a default-window capture — the
    no-HTTP-access escape hatch. Main-thread only (signal module
    contract); returns False where that fails."""
    global _prev_sigusr2
    if _prev_sigusr2 is not None:
        return True

    def handler(_signum, _frame):
        # flags only: the handler runs between bytecodes on the main
        # thread, which may hold the controller lock (step_tick holds
        # it across the profiler's start/stop) — request() here would
        # deadlock.
        # The next step boundary arms the window instead.
        _default_controller._sig_armed = True
        _default_controller._pending = True

    try:
        _prev_sigusr2 = signal.signal(signal.SIGUSR2, handler)
        return True
    except (ValueError, OSError, AttributeError):
        return False


def uninstall_sigusr2() -> None:
    global _prev_sigusr2
    if _prev_sigusr2 is not None:
        signal.signal(signal.SIGUSR2, _prev_sigusr2)
        _prev_sigusr2 = None
