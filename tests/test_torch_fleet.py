"""The port's fleet observability (paddle_tpu_torch.observability.fleet)
held to the JAX package's on the CPU: the same registry operations,
snapshots and clocks through both give equal outputs.

- ``filter_snapshot`` / ``merge_snapshots`` over replica-scoped series:
  counters conserve the fleet sum, histograms merge bucket-wise (merged
  quantiles equal the quantiles of the union's traffic), gauges stay
  replica-labeled, skewed bounds stay apart;
- the aggregator: explicit sources, a failing source, the registry-scan
  fallback for replica names, the Prometheus and replicas views;
- the placement audit ring (bounded, gated off with observability);
- ``check_slo`` at its breach edge, with its min-samples floor, its
  windowed burn and its counted cumulative fallback; ``replica_slo``;
- ``MetricsServer``'s ``/fleet/metrics``, ``/fleet/replicas.json``,
  ``/fleet/placements.json`` and ``/alerts.json`` pages, and
  ``http_source`` federating a remote server's snapshot.

Each test runs one script through both packages' modules and compares
what they return (:func:`both`); the time-series and watchdog tests use
the same pair."""
import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.framework import flags as jflags
from paddle_tpu_torch.framework import flags as tflags

# the flags the fleet and time-series scripts move (restored afterwards)
FLAGS = ("obs_ts_interval_s", "obs_ts_capacity", "obs_ts_min_samples",
         "obs_ts_fast_window_s", "obs_ts_slow_window_s", "obs_ts_dir",
         "obs_ts_history_tail", "obs_fleet_placements_capacity",
         "obs_fleet_slo_target", "obs_fleet_slo_min_requests",
         "obs_fleet_slo_advisory", "obs_slo_ttft_ms", "obs_slo_tpot_ms")


def _ns(obs, flags):
    from importlib import import_module

    base = obs.__name__
    return SimpleNamespace(
        obs=obs, flags=flags, fleet=obs.fleet, ts=obs.timeseries,
        exposition=import_module(base + ".exposition"),
        flight=obs.flight_recorder,
        http=import_module(base + ".http_server"),
        name=base.split(".")[0])


PKGS = (_ns(jobs, jflags), _ns(tobs, tflags))


def _reset(p):
    p.obs.get_registry().reset()
    p.obs.get_tracer().clear()
    p.flight.get_recorder().clear()
    p.obs.request_trace.get_request_tracer().clear()
    p.obs.request_trace.get_exemplar_store().clear()
    p.fleet.get_placement_log().clear()
    p.fleet._breach_state.clear()
    p.fleet.get_aggregator().clear_sources()
    p.fleet.get_aggregator().detach_router()
    p.ts.reset()


@pytest.fixture
def pair():
    """Both packages enabled over zeroed registries, rings and alert
    state; their flags restored and observability off afterwards."""
    saved = [(p, {f: p.flags.get_flag(f) for f in FLAGS}) for p in PKGS]
    for p in PKGS:
        _reset(p)
        p.obs.enable()
    try:
        yield PKGS
    finally:
        for p, vals in saved:
            p.obs.disable()
            p.flags.set_flags(vals)
            _reset(p)


_CLOCKS = ("unix_time", "pid")


def masked(doc):
    """``doc`` through JSON with its wall-clock fields and pid dropped
    (flight events keep their kind and fields, not their time)."""
    doc = json.loads(json.dumps(doc, default=str))

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()
                    if k not in _CLOCKS and not (k == "t" and "kind" in x)}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(doc)


def both(script, *args):
    """``script(p, *args)`` through each package; returns the two
    results, masked, JAX first."""
    return [masked(script(p, *args)) for p in PKGS]


def events(p):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in p.flight.get_recorder().events()]


BOUNDS = [0.01, 0.05, 0.1, 0.5, 1.0, 5.0]


def _families(p, *names):
    """The named families of the registry's snapshot, by name (each
    package's registry also holds families of modules the other never
    loads, registered in the order a process first used them)."""
    snap = p.exposition.snapshot(p.obs.get_registry())
    return sorted((f for f in snap["metrics"] if f["name"] in names),
                  key=lambda f: f["name"])


def _untimed(entries):
    """Placement-audit entries without their wall-clock stamp."""
    return [{k: v for k, v in e.items() if k != "t"} for e in entries]


def _scoped_traffic(p, seed):
    """Seeded per-replica traffic into one registry: a counter, a gauge,
    a histogram and one family with skewed bounds."""
    reg = p.obs.get_registry()
    rng = np.random.default_rng(seed)
    c = reg.counter("t_fleet_tokens_total")
    g = reg.gauge("t_fleet_queue_depth")
    h = reg.histogram("t_fleet_ttft_seconds", buckets=BOUNDS)
    union = []
    for i, name in enumerate(("r0", "r1", "r2")):
        with reg.scoped(replica=name):
            c.inc(int(rng.integers(1, 50)))
            g.set(float(i + 1))
            vals = [float(v) for v in
                    rng.uniform(0.001, 6.0, size=int(rng.integers(5, 30)))]
            union.extend(vals)
            for v in vals:
                h.observe(v)
    skew = reg.histogram("t_fleet_skew_seconds", buckets=[0.1, 1.0])
    skew.observe(0.5, replica="r0")
    return union


def _merge_script(p):
    union = _scoped_traffic(p, 5)
    reg = p.obs.get_registry()
    full = p.exposition.snapshot(reg)
    per = {n: p.fleet.filter_snapshot(full, replica=n)
           for n in ("r0", "r1", "r2")}
    merged = p.fleet.merge_snapshots(per)
    ref = reg.histogram("t_fleet_union_seconds", buckets=BOUNDS)
    for v in union:
        ref.observe(v)
    fam = next(f for f in merged["metrics"]
               if f["name"] == "t_fleet_ttft_seconds")
    counts = fam["series"][0]["counts"]
    quant = {q: (p.exposition.quantile(BOUNDS, counts, q),
                 p.exposition.quantile(BOUNDS, ref.labels().counts, q))
             for q in (0.1, 0.5, 0.9, 0.99)}
    agg = p.fleet.get_aggregator()
    return {"per": per, "merged": merged, "quantiles": quant,
            "names": agg.replica_names(),
            "tokens": agg.fleet_counter_value("t_fleet_tokens_total"),
            "p50": agg.fleet_quantile("t_fleet_ttft_seconds", 0.5),
            "text": agg.prometheus()}


def test_filter_and_merge_equal_reference(pair):
    j, t = both(_merge_script)
    assert t == j
    for got, want in t["quantiles"].values():
        assert got == want             # merged == union, exactly
    fams = {f["name"]: f for f in t["merged"]["metrics"]}
    assert fams["t_fleet_tokens_total"]["series"][0]["labels"] == {}
    assert sorted(s["labels"]["replica"] for s in
                  fams["t_fleet_queue_depth"]["series"]) == ["r0", "r1",
                                                             "r2"]
    assert t["names"] == ["r0", "r1", "r2"]


def _sources_script(p):
    agg = p.fleet.get_aggregator()
    snap = {"version": 1, "metrics": [{
        "name": "t_fleet_src_total", "kind": "counter",
        "series": [{"labels": {}, "value": 4.0}]}]}
    agg.add_source("a", lambda: snap)
    agg.add_source("b", lambda: (_ for _ in ()).throw(OSError("down")))
    try:
        return {"snaps": agg.snapshots(),
                "value": agg.fleet_counter_value("t_fleet_src_total"),
                "text": agg.prometheus(),
                "scrapes": _families(p, "serving_fleet_scrapes_total")}
    finally:
        agg.clear_sources()


def test_aggregator_sources_equal_reference(pair):
    j, t = both(_sources_script)
    assert t == j
    assert t["snaps"]["b"]["error"] == "source_unavailable"
    assert t["value"] == 4.0 and "t_fleet_src_total 4" in t["text"]


def _placement_script(p):
    log = p.fleet.PlacementLog(capacity=3)
    for i in range(5):
        log.record(rid=i, chosen="r0", reason="affinity",
                   candidates=[{"replica": "r0", "affinity": i}])
    out = {"ring": _untimed(log.entries()), "recorded": log.recorded}
    p.obs.disable()
    log.record(rid=99, chosen="r0", reason="affinity")
    p.obs.enable()
    out["gated"] = _untimed(log.entries())
    log.set_capacity(2)
    out["shrunk"] = _untimed(log.entries())
    p.flags.set_flags({"obs_fleet_placements_capacity": 2})
    glob = p.fleet.get_placement_log()
    for i in range(4):
        glob.record(rid=i, chosen=f"r{i % 2}", reason="least_loaded")
    pay = p.fleet.placements_payload()
    pay["placements"] = _untimed(pay["placements"])
    out["payload"] = pay
    out["events"] = events(p)
    return out


def test_placement_log_equal_reference(pair):
    j, t = both(_placement_script)
    assert t == j
    assert [e["rid"] for e in t["ring"]] == [2, 3, 4]
    assert t["gated"] == t["ring"]
    assert [e["rid"] for e in t["payload"]["placements"]] == [2, 3]


def _slo_script(p):
    reg = p.obs.get_registry()
    h = reg.histogram("serving_ttft_seconds")
    ts = p.ts
    min_n = int(p.flags.get_flag("obs_fleet_slo_min_requests"))
    out = {}
    # below the floor: terrible but not judged
    for _ in range(min_n - 1):
        h.observe(9.0, replica="r0")
        h.observe(0.01, replica="r1")
    out["thin"] = sorted(p.fleet.check_slo(["r0", "r1"]))
    # at the floor (cumulative: the ring is empty, counted)
    h.observe(9.0, replica="r0")
    h.observe(0.01, replica="r1")
    out["edge"] = sorted(p.fleet.check_slo(["r0", "r1"]))
    out["again"] = sorted(p.fleet.check_slo(["r0", "r1"]))
    out["slo"] = {n: p.fleet.replica_slo(n) for n in ("r0", "r1", "r2")}
    # a burn exactly at the budget is not a breach: attainment 0.99 at
    # the default target (99 inside, 1 outside) burns 1.0
    for _ in range(99):
        h.observe(0.01, replica="r2")
    h.observe(9.0, replica="r2")
    out["at_budget"] = sorted(p.fleet.check_slo(["r2"]))
    # windowed: a long healthy lifetime, then a burning window
    p.flags.set_flags({"obs_ts_fast_window_s": 10.0,
                       "obs_ts_slow_window_s": 60.0})
    for _ in range(6000):
        h.observe(0.005, replica="r3")
    ts.get_store().sample(t=0.0)
    for _ in range(30):
        h.observe(5.0, replica="r3")
    ts.get_store().sample(t=100.0)
    out["windowed"] = sorted(p.fleet.check_slo(["r3"]))
    ts.reset()
    p.fleet._breach_state.clear()
    out["diluted"] = sorted(p.fleet.check_slo(["r3"]))
    out["snap"] = _families(p, "serving_fleet_slo_breaches_total",
                            "serving_fleet_slo_attainment",
                            "obs_ts_window_fallbacks_total",
                            "serving_ttft_seconds")
    out["events"] = events(p)
    return out


def test_check_slo_edges_equal_reference(pair):
    j, t = both(_slo_script)
    assert t == j
    assert t["thin"] == [] and t["edge"] == ["r0"] == t["again"]
    assert t["at_budget"] == []
    assert t["windowed"] == ["r3"] and t["diluted"] == []
    fams = {f["name"]: f for f in t["snap"]}
    breaches = fams["serving_fleet_slo_breaches_total"]["series"]
    assert sum(s["value"] for s in breaches) == 2   # r0 once, r3 once
    assert [e["kind"] for e in t["events"]].count("slo_breach") == 2


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def _server_script(p):
    reg = p.obs.get_registry()
    c = reg.counter("serving_tokens_total")
    h = reg.histogram("serving_ttft_seconds")
    for name, n in (("r0", 7), ("r1", 5)):
        c.inc(n, replica=name)
        for v in (0.01, 0.2, 3.0)[:n % 4]:
            h.observe(v, replica=name)
    p.fleet.get_placement_log().record(rid=1, chosen="r0",
                                       reason="affinity")
    srv = p.http.MetricsServer(port=0)
    base = f"http://{srv.host}:{srv.port}"
    try:
        pages = {path: _get(base + path) for path in (
            "/fleet/metrics", "/fleet/replicas.json",
            "/fleet/placements.json", "/alerts.json")}
        # a second server's snapshot, federated over HTTP
        agg = p.fleet.get_aggregator()
        agg.add_source("remote", p.fleet.http_source(base))
        remote = agg.fleet_counter_value("serving_tokens_total")
        agg.clear_sources()
    finally:
        srv.close()
    out = {k: (code, json.loads(body) if k.endswith(".json") else body)
           for k, (code, body) in pages.items()}
    pay = out["/fleet/placements.json"][1]
    pay["placements"] = _untimed(pay["placements"])
    out["remote"] = remote
    return out


def test_metrics_server_fleet_pages_equal_reference(pair):
    j, t = both(_server_script)
    assert t == j
    code, text = t["/fleet/metrics"]
    assert code == 200 and "serving_tokens_total 12" in text
    rows = {r["replica"]: r for r in t["/fleet/replicas.json"][1]["replicas"]}
    assert rows["r0"]["tokens"] == 7 and rows["r1"]["tokens"] == 5
    assert t["/fleet/placements.json"][1]["placements"][0]["chosen"] == "r0"
    assert t["/alerts.json"][0] == 200
    # the remote source carries both replicas' series again
    assert t["remote"] == 24


def test_masked_drops_only_clocks():
    doc = {"unix_time": 1.0, "pid": 2, "x": [{"kind": "a", "t": 3.0,
                                              "v": 1}, {"t": 4.0}]}
    assert masked(doc) == {"x": [{"kind": "a", "v": 1}, {"t": 4.0}]}
