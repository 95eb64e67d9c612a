"""The port's time-series layer (paddle_tpu_torch.observability.timeseries)
held to the JAX package's on the CPU: the same samples, flags and
explicit ``now``s through both give equal outputs.

- the bounded ring and its live resize; ``delta``/``rate`` with label
  filters and counter resets;
- windowed quantiles from bucket-count deltas, exact against a registry
  that saw only the window's traffic, single replica and fleet union;
- ``AlertEngine``: the shed-rate alert's firing and cleared edges (once a
  transition), ``no_data`` on an empty ring, per-replica burn alerts,
  the tok/s divergence watcher; ``alerts_payload``, ``history_payload``
  and ``MetricsServer``'s ``/alerts.json``;
- the derived-signal history's JSONL ring and the flight recorder's
  post-mortem ``timeseries`` section;
- ``step_tick``: a no-op while observability is off, throttled by
  ``FLAGS_obs_ts_interval_s`` against explicit clocks, and skipping —
  never waiting — while another thread samples; ``tick`` never raises."""
import json
import os
import urllib.request

import numpy as np

from test_torch_fleet import both, events, masked, pair  # noqa: F401

BOUNDS = [0.01, 0.05, 0.1, 0.5, 1.0, 5.0]


def _counter_snap(series):
    """{name: {label_tuple_or_None: value}} -> a snapshot-shaped dict."""
    metrics = []
    for name, by_labels in series.items():
        rows = [{"labels": dict(labels or ()), "value": v}
                for labels, v in by_labels.items()]
        metrics.append({"name": name, "kind": "counter", "series": rows})
    return {"version": 1, "metrics": metrics}


def _families(p, *names):
    snap = p.exposition.snapshot(p.obs.get_registry())
    return sorted((f for f in snap["metrics"] if f["name"] in names),
                  key=lambda f: f["name"])


def _ring_script(p):
    ts = p.ts
    store = ts.get_store()
    p.flags.set_flags({"obs_ts_capacity": 6})
    for i in range(20):
        store.sample(_counter_snap({"t_ring_total": {None: float(i)}}),
                     t=float(i))
    out = {"len": len(store), "sampled": store.sampled,
           "latest": store.latest().t}
    p.flags.set_flags({"obs_ts_capacity": 3})
    out["kept"] = [s.t for s in store.samples()]
    s2 = ts.TimeSeriesStore(capacity=8)
    for t, v in ((0.0, 5.0), (10.0, 11.0), (20.0, 17.0)):
        s2.sample(_counter_snap({"t_d_total": {None: v}}), t=t)
    out["delta"] = [s2.delta("t_d_total", 15.0), s2.delta("t_d_total", 5.0),
                    s2.rate("t_d_total", 15.0),
                    s2.delta("t_absent_total", 5.0),
                    ts.TimeSeriesStore(capacity=8).delta("t_d_total", 5.0)]
    s2.sample(_counter_snap({"t_d_total": {None: 3.0}}), t=30.0)
    out["reset"] = s2.delta("t_d_total", 5.0)
    s3 = ts.TimeSeriesStore(capacity=8)

    def mk(a, b):
        return _counter_snap({"t_l_total": {(("replica", "r0"),): a,
                                            (("replica", "r1"),): b}})

    s3.sample(mk(0.0, 0.0), t=0.0)
    s3.sample(mk(4.0, 10.0), t=10.0)
    out["labels"] = [s3.delta("t_l_total", 5.0),
                     s3.delta("t_l_total", 5.0, replica="r0"),
                     s3.delta("t_l_total", 5.0, replica="r1"),
                     s3.rate_series("t_l_total", n=4, replica="r1")]
    out["metrics"] = _families(p, "obs_ts_samples_total",
                               "obs_ts_ring_size")
    return out


def test_ring_delta_rate_equal_reference(pair):
    j, t = both(_ring_script)
    assert t == j
    assert t["len"] == 6 and t["sampled"] == 20
    assert t["kept"] == [17.0, 18.0, 19.0]
    assert t["delta"][:2] == [12.0, 6.0] and t["delta"][3:] == [0.0, None]
    assert t["reset"] == 3.0 and t["labels"][:3] == [14.0, 4.0, 10.0]


def _quantile_script(p):
    reg = p.obs.get_registry()
    ts, exp, fleet = p.ts, p.exposition, p.fleet
    rng = np.random.default_rng(3)
    out = {}
    # one replica
    h = reg.histogram("t_ts_exact_seconds", buckets=BOUNDS)
    store = ts.TimeSeriesStore(capacity=8,
                               source=lambda: exp.snapshot(reg))
    for v in rng.uniform(0.001, 6.0, size=40):
        h.observe(float(v))
    store.sample(t=0.0)
    window = [float(v) for v in rng.uniform(0.001, 6.0, size=55)]
    for v in window:
        h.observe(v)
    store.sample(t=10.0)
    ref = reg.histogram("t_ts_exact_ref_seconds", buckets=BOUNDS)
    for v in window:
        ref.observe(v)
    out["single"] = [(store.window_quantile("t_ts_exact_seconds", q, 5.0),
                      exp.quantile(BOUNDS, ref.labels().counts, q))
                     for q in (0.1, 0.5, 0.9, 0.99)]
    out["frac"] = (store.window_fraction_at_or_below(
        "t_ts_exact_seconds", 0.5, 5.0),
        exp.fraction_at_or_below(BOUNDS, ref.labels().counts, 0.5))
    # the fleet union
    hf = reg.histogram("t_ts_fleet_seconds", buckets=BOUNDS)
    names = ("r0", "r1", "r2")

    def merged():
        full = exp.snapshot(reg)
        return fleet.merge_snapshots(
            {n: fleet.filter_snapshot(full, replica=n) for n in names})

    fstore = ts.TimeSeriesStore(capacity=8, source=merged)
    for n in names:
        with reg.scoped(replica=n):
            for v in rng.uniform(0.001, 6.0, size=int(rng.integers(5, 30))):
                hf.observe(float(v))
    fstore.sample(t=0.0)
    union = []
    for n in names:
        vals = [float(v) for v in
                rng.uniform(0.001, 6.0, size=int(rng.integers(5, 30)))]
        union.extend(vals)
        with reg.scoped(replica=n):
            for v in vals:
                hf.observe(v)
    fstore.sample(t=10.0)
    fref = reg.histogram("t_ts_fleet_ref_seconds", buckets=BOUNDS)
    for v in union:
        fref.observe(v)
    out["union"] = [(fstore.window_quantile("t_ts_fleet_seconds", q, 5.0),
                     exp.quantile(BOUNDS, fref.labels().counts, q))
                    for q in (0.5, 0.9, 0.99)]
    out["hist_delta"] = list(fstore.hist_delta("t_ts_fleet_seconds", 5.0))
    return out


def test_window_quantiles_exact_and_equal_reference(pair):
    j, t = both(_quantile_script)
    assert t == j
    for got, want in t["single"] + t["union"] + [t["frac"]]:
        assert got == want


def _alert_script(p, tmp):
    ts, reg = p.ts, p.obs.get_registry()
    store, engine = ts.get_store(), ts.get_alert_engine()
    out = {"empty": engine.evaluate(now=0.0)}
    p.flags.set_flags({"obs_ts_fast_window_s": 4.0})

    def shed(v):
        return _counter_snap({"serving_shed_total": {None: v}})

    store.sample(shed(0.0), t=0.0)
    store.sample(shed(10.0), t=5.0)          # 2 sheds/s
    out["firing"] = engine.evaluate(now=5.0)
    engine.evaluate(now=5.0)                 # still firing: no re-edge
    store.sample(shed(10.0), t=10.0)
    store.sample(shed(10.0), t=15.0)
    out["cleared"] = engine.evaluate(now=15.0)
    out["edges"] = [engine.edge_count("shed_rate", e)
                    for e in ("firing", "cleared")]
    # per-replica burn and the divergence watcher
    ts.reset()
    p.flags.set_flags({"obs_ts_fast_window_s": 10.0,
                       "obs_ts_slow_window_s": 60.0})
    h = reg.histogram("serving_ttft_seconds")
    for _ in range(50):
        h.observe(0.005, replica="r0")
        h.observe(0.005, replica="r1")
    store.sample(t=0.0)
    for _ in range(30):
        h.observe(5.0, replica="r0")
        h.observe(0.005, replica="r1")
    store.sample(t=100.0)
    out["burn"] = engine.evaluate(now=100.0)
    out["burning"] = sorted(engine.burning_replicas())
    ts.reset()

    def tok(a, b, c):
        return _counter_snap({"serving_tokens_total": {
            (("replica", "r0"),): a, (("replica", "r1"),): b,
            (("replica", "r2"),): c}})

    store.sample(tok(100.0, 100.0, 100.0), t=0.0)
    store.sample(tok(100.0, 400.0, 380.0), t=10.0)   # r0 froze
    out["diverge"] = engine.evaluate(now=10.0)
    out["diverge_burning"] = sorted(engine.burning_replicas())
    store.sample(tok(100.0, 400.0, 380.0), t=120.0)  # an idle fleet
    out["idle"] = engine.evaluate(now=120.0)
    out["payload"] = ts.alerts_payload(evaluate=False)
    # history: the JSONL ring, the tail and the post-mortem section
    ts.reset()
    p.flags.set_flags({"obs_ts_dir": str(tmp), "obs_ts_history_tail": 4,
                       "obs_ts_fast_window_s": 4.0})
    shed_c = reg.counter("serving_shed_total")
    for i in range(12):
        shed_c.inc(5)
        ts.tick(now=float(i))
    path = os.path.join(str(tmp), f"obs_ts-{os.getpid()}.jsonl")
    with open(path) as f:
        out["jsonl"] = [json.loads(x) for x in f.read().strip()
                        .splitlines()]
    out["tail"] = ts.get_history().tail()
    out["history"] = ts.history_payload(n=2)
    out["postmortem"] = p.flight.get_recorder().postmortem()["timeseries"]
    out["alerts_total"] = _families(p, "obs_alerts_total")
    out["events"] = [e for e in events(p) if e["kind"].startswith("alert")]
    return out


def test_alert_engine_and_history_equal_reference(pair, tmp_path):
    j = _alert_script(pair[0], tmp_path / "jax")
    t = _alert_script(pair[1], tmp_path / "torch")
    j, t = masked(j), masked(t)
    assert t == j
    assert all(r["state"] == "no_data" for r in t["empty"]
               if r["alert"] != "slo_burn")
    row = next(r for r in t["firing"] if r["alert"] == "shed_rate")
    assert row["state"] == "firing" and row["value"] == 2.0
    assert t["edges"] == [1, 1]
    burn = {r["instance"]: r for r in t["burn"] if r["alert"] == "slo_burn"}
    assert burn["r0"]["state"] == "firing" and burn["r1"]["state"] == "ok"
    assert t["burning"] == ["r0"] and t["diverge_burning"] == ["r0"]
    assert len(t["jsonl"]) <= 8 and len(t["tail"]) == 4
    assert [e["t"] for e in t["tail"]] == [8.0, 9.0, 10.0, 11.0]
    assert t["jsonl"][-1] == t["tail"][-1]
    assert t["postmortem"]["entries"] == t["tail"][-4:]
    assert any("shed_rate" in e["firing"] for e in t["tail"])


def _server_script(p):
    p.flags.set_flags({"obs_ts_fast_window_s": 4.0})
    store = p.ts.get_store()
    store.sample(_counter_snap({"serving_shed_total": {None: 0.0}}), t=0.0)
    store.sample(_counter_snap({"serving_shed_total": {None: 10.0}}),
                 t=5.0)
    srv = p.http.MetricsServer(port=0)
    try:
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/alerts.json",
                timeout=30) as r:
            doc = json.loads(r.read())
    finally:
        srv.close()
    # the page evaluates at the wall clock: a firing row's start is one
    for row in doc["alerts"]:
        row["since"] = row.get("since") is not None
    return doc


def test_alerts_json_page_equal_reference(pair):
    j, t = both(_server_script)
    assert t == j
    assert t["ring_size"] == 2 and "shed_rate" in t["firing"]


def _tick_script(p):
    ts = p.ts
    store = ts.get_store()
    out = {}
    p.obs.disable()
    ts.step_tick(now=1.0)
    out["off"] = len(store)
    p.obs.enable()
    p.flags.set_flags({"obs_ts_interval_s": 10.0})
    ts._last_tick[0] = float("-inf")
    seen = []
    for now in (100.0, 105.0, 109.9, 110.0, 115.0, 125.0):
        ts.step_tick(now=now)
        seen.append(len(store))
    out["throttled"] = seen
    # a sampler already running on another thread: skip, never wait
    ts._tick_lock.acquire()
    try:
        ts.step_tick(now=500.0)
    finally:
        ts._tick_lock.release()
    out["busy"] = len(store)
    p.flags.set_flags({"obs_ts_interval_s": 0.0})
    for i in range(5):
        ts.step_tick(now=600.0 + i)
    out["every"] = len(store)
    out["times"] = [s.t for s in store.samples()]
    return out


def test_step_tick_throttle_equal_reference(pair):
    j, t = both(_tick_script)
    assert t == j
    assert t["off"] == 0
    assert t["throttled"] == [1, 1, 1, 2, 2, 3]
    assert t["busy"] == 3 and t["every"] == 8


def test_tick_never_raises(pair, monkeypatch):
    for p in pair:
        def boom():
            raise RuntimeError("sampler exploded")

        monkeypatch.setattr(p.ts, "get_store", boom)
        p.ts.tick()
        assert "ts_tick_error" in [e["kind"] for e in events(p)]
