"""paddle_tpu_torch.observability — always-on metrics + span tracing; the
port's copy of paddle_tpu/observability.

Cheap always-on counters/gauges/histograms with Prometheus exposition, a
span tracer with Chrome-trace export, per-request timelines, a crash
flight recorder, roofline gauges, on-demand ``torch.profiler`` captures
and int8 numerics probes — all near-zero cost until ``FLAGS_obs_enabled``
(or :func:`enable`) turns them on.

    import paddle_tpu_torch.observability as obs

    obs.enable()
    reqs = obs.counter("myapp_requests_total", "requests served")
    lat = obs.histogram("myapp_latency_seconds", "request latency")
    with obs.trace_span("request", route="/gen"):
        ...
        reqs.inc(); lat.observe(dt)
    srv = obs.MetricsServer(port=0)  # GET :<srv.port>/metrics, /trace.json
    obs.export_chrome_trace("trace.json")   # chrome://tracing

Names, flags, label sets, bucket edges, event names and JSON shapes equal
the reference's, so one dashboard or one ``tools/obs_dump.py`` reads
either package. Stdlib-only on purpose: importing it never pulls torch
(``perf``, ``profiling`` and ``numerics`` import it inside the functions
that need it), so instrumented modules can depend on it
unconditionally. ``fleet`` (the router's federated views, placement
audit and per-replica SLO burn) and ``timeseries`` (the metrics history
ring, windowed alerts and ``/alerts.json``) load lazily.
"""
from __future__ import annotations

from . import catalog  # noqa: F401
from .state import disable, enable, enabled  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, Registry, counter, gauge, get_registry,
    histogram, log_buckets, time_buckets,
)
from .tracing import (  # noqa: F401
    Span, SpanTracer, export_chrome_trace, get_tracer, trace_span,
)
from .exposition import (  # noqa: F401
    dump_snapshot, load_snapshot, render_prometheus, snapshot,
)
from .http_server import (  # noqa: F401
    MetricsServer, start_http_server, stop_http_server,
)
from . import flight_recorder, goodput, perf  # noqa: F401
from .goodput import (  # noqa: F401
    GoodputTracker, goodput_section,
)
from .flight_recorder import FlightRecorder  # noqa: F401

# request_trace / profiling / numerics are PEP 562 lazy: they are only
# needed by the serving engine, the HTTP control plane and the numerics
# probes (which import the submodules directly), and loading them here
# would eat the package's import-cost budget for every instrumented
# module that wants plain counters. Their flags live HERE so set_flags /
# obs_dump --flags see them before any of the modules load.
from ..framework.flags import define_flag as _define_flag  # noqa: E402

_define_flag("obs_requests_capacity", 256,
             "finished per-request timeline retention ring (oldest "
             "evicted); live requests are always tracked")
_define_flag("obs_request_events_max", 512,
             "per-request timeline event cap — decode ticks beyond it "
             "are dropped (counted), the lifecycle events always record")
_define_flag("obs_audit_capacity", 64,
             "bounded retention for SLO-breach audit entries (ring AND "
             "the per-process JSONL file cap)")
_define_flag("obs_audit_dir", "",
             "directory for the SLO-breach audit JSONL "
             "(request_audit-<pid>.jsonl); empty keeps the audit "
             "in-memory only")
_define_flag("obs_profile_dir", "",
             "output directory for on-demand torch.profiler captures; "
             "empty derives paddle_tpu_torch_profile-<pid>-<n> under the "
             "system temp dir")
_define_flag("obs_profile_default_steps", 5,
             "steps one capture spans when the trigger names no count "
             "(SIGUSR2, /control/profile without ?steps=)")
_define_flag("obs_numerics", False,
             "numerics observatory: on-device tensor stats + int8 "
             "quant-error probes + the per-layer NaN-provenance ladder "
             "(observability.numerics). With it off the probe sites add "
             "no device op; requires the master FLAGS_obs_enabled "
             "switch too")
_define_flag("obs_numerics_capacity", 512,
             "bounded retention for landed numerics stat vectors "
             "(oldest evicted; the provenance walk and the obs_dump "
             "stats table read this ring)")
_define_flag("obs_fleet_placements_capacity", 256,
             "bounded retention for router placement-audit entries "
             "(/fleet/placements.json ring; oldest evicted)")
_define_flag("obs_fleet_slo_target", 0.99,
             "fleet SLO attainment target; a replica's burn rate is "
             "(1 - attainment) / (1 - target) — above 1.0 it is "
             "burning its error budget")
_define_flag("obs_fleet_slo_min_requests", 20,
             "minimum per-replica histogram samples before the fleet "
             "SLO burn-rate check judges a replica (avoids flapping "
             "on a cold replica's first requests)")
_define_flag("obs_fleet_slo_advisory", False,
             "let a replica's SLO burn feed the router health check "
             "as an advisory suspect signal (healthy -> suspect only; "
             "liveness still decides dead)")
_define_flag("obs_ts_interval_s", 1.0,
             "minimum seconds between time-series samples on the "
             "engine/router step tick (0 samples every step — chaos "
             "and demos only)")
_define_flag("obs_ts_capacity", 512,
             "time-series ring capacity in samples (oldest evicted; "
             "live-resizable via watch_flag)")
_define_flag("obs_ts_min_samples", 2,
             "minimum ring samples before any windowed query answers "
             "(below it, callers fall back to cumulative — counted)")
_define_flag("obs_ts_fast_window_s", 60.0,
             "fast alert window: windowed rates/quantiles and the "
             "burn-rate alert's spike-catching window")
_define_flag("obs_ts_slow_window_s", 600.0,
             "slow alert window: the burn-rate alert's confirmation "
             "window (clamped to available history on young processes)")
_define_flag("obs_ts_dir", "",
             "directory for the derived-signal history JSONL ring "
             "(obs_ts-<pid>.jsonl); empty keeps the history in-memory "
             "only (the post-mortem tail embeds either way)")
_define_flag("obs_ts_history_tail", 120,
             "bounded retention for derived-signal history entries "
             "(in-memory tail AND the JSONL ring's compaction cap)")

_LAZY_SUBMODULES = ("request_trace", "profiling", "numerics", "fleet",
                    "timeseries")
_LAZY_NAMES = {
    "RequestContext": "request_trace", "RequestTracer": "request_trace",
    "exemplar_for_quantile": "request_trace",
    "get_exemplar_store": "request_trace",
    "get_request_tracer": "request_trace",
    "requests_payload": "request_trace",
    "ProfileController": "profiling",
    "get_profile_controller": "profiling",
    "request_capture": "profiling",
    "tensor_stats": "numerics",
    "record_quant_error": "numerics",
    "FleetAggregator": "fleet",
    "PlacementLog": "fleet",
    "get_aggregator": "fleet",
    "get_placement_log": "fleet",
    "merge_snapshots": "fleet",
    "filter_snapshot": "fleet",
    "TimeSeriesStore": "timeseries",
    "AlertEngine": "timeseries",
    "AlertSpec": "timeseries",
    "get_store": "timeseries",
    "get_alert_engine": "timeseries",
    "alerts_payload": "timeseries",
    "history_payload": "timeseries",
}


def __getattr__(name):
    import importlib
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    mod = _LAZY_NAMES.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "enabled", "enable", "disable",
    "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "get_registry",
    "log_buckets", "time_buckets",
    "Span", "SpanTracer", "trace_span", "get_tracer",
    "export_chrome_trace",
    "render_prometheus", "snapshot", "dump_snapshot", "load_snapshot",
    "MetricsServer", "start_http_server", "stop_http_server",
    "catalog", "goodput", "perf", "flight_recorder",
    "GoodputTracker", "goodput_section", "FlightRecorder",
    "request_trace", "RequestContext", "RequestTracer",
    "get_request_tracer", "get_exemplar_store", "exemplar_for_quantile",
    "requests_payload",
    "profiling", "ProfileController", "get_profile_controller",
    "request_capture",
    "numerics", "tensor_stats", "record_quant_error",
    "fleet", "FleetAggregator", "PlacementLog", "get_aggregator",
    "get_placement_log", "merge_snapshots", "filter_snapshot",
    "timeseries", "TimeSeriesStore", "AlertEngine", "AlertSpec",
    "get_store", "get_alert_engine", "alerts_payload", "history_payload",
]
