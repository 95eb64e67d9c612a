"""Observability enablement state + FLAGS_obs_* registration — the port's
copy of paddle_tpu/observability/state.py.

Deliberately tiny and stdlib-only: every instrumented hot path (the
serving step, the decode dispatch) checks :func:`enabled` — when
observability is off that check must cost one module-global read, and
importing this package must never pull torch or any other heavy
dependency (guarded by tests/test_torch_observability.py).
"""
from __future__ import annotations

from ..framework.flags import define_flag, watch_flag

# FLAGS_obs_* environment overrides are applied by define_flag at import.
_ENABLED_DEFAULT = define_flag(
    "obs_enabled", False,
    "master switch for the metrics registry + span tracer; instrumented "
    "call sites become near-zero-cost no-ops when off")
define_flag("obs_port", 9464,
            "default port for the Prometheus exposition HTTP server "
            "(start_http_server); 0 = OS-assigned ephemeral port")
define_flag("obs_host", "127.0.0.1",
            "bind address for the exposition HTTP server")
define_flag("obs_trace_capacity", 4096,
            "ring-buffer retention for completed spans (oldest evicted)")
define_flag("obs_max_series", 256,
            "per-family label-set cardinality cap; overflowing series "
            "collapse into one {overflow=\"true\"} series")

# The hot-path switch. A plain module global (not a flag lookup: get_flag
# takes a lock) — enable()/disable() keep the flag registry in sync for
# get_flags() visibility, and a flag watcher keeps THIS global in sync
# when users flip the flag through paddle.set_flags instead.
_ENABLED = bool(_ENABLED_DEFAULT)


def _on_flag_change(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


watch_flag("obs_enabled", _on_flag_change)


def enabled() -> bool:
    """True when instrumentation is live. The single hot-path check."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True
    _sync_flag(True)


def disable() -> None:
    global _ENABLED
    _ENABLED = False
    _sync_flag(False)


def _sync_flag(value: bool) -> None:
    from ..framework.flags import set_flags

    try:
        set_flags({"obs_enabled": value})
    except ValueError:          # registry torn down mid-interpreter-exit
        pass
