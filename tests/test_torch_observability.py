"""The port's observability core (paddle_tpu_torch.observability) held to
the JAX package's (paddle_tpu.observability) on the CPU.

- the same scripted operations through both packages give equal
  ``snapshot()`` documents and ``render_prometheus()`` text (timestamps
  masked), equal Chrome-trace span trees, the same label-cap collapse and
  histogram edge behaviour, equal request timelines and summaries, equal
  flight-recorder events and equal numerics stat vectors;
- the catalog equals the reference's row for row, and a port-side
  catalog contract: every metric name a port module instruments is
  registered, and the rows no port module instruments yet are exactly
  the waiting set named below, keyed by ROADMAP queue item;
- the flags: ``set_flags`` all-or-nothing, watchers firing, the rings
  resizing, the obs flags equal the reference's;
- observability off is a no-op; the package imports without torch and
  under the reference's 50 ms budget; the exposition server's routes;
  the analytic decode FLOPs."""
import ast
import importlib
import json
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax.numpy as jnp
import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.framework import flags as jflags
from paddle_tpu_torch.framework import flags as tflags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def _reset(pkg):
    pkg.get_registry().reset()
    pkg.get_tracer().clear()
    pkg.flight_recorder.get_recorder().clear()
    pkg.request_trace.get_request_tracer().clear()
    pkg.request_trace.get_exemplar_store().clear()
    pkg.numerics.clear()


@pytest.fixture
def both_on():
    """Both packages enabled over zeroed registries and empty rings;
    disabled again afterwards so other tests see the default-off state."""
    for pkg in (jobs, tobs):
        _reset(pkg)
        pkg.enable()
    try:
        yield
    finally:
        for pkg in (jobs, tobs):
            pkg.disable()
            _reset(pkg)


def _masked(doc):
    """A snapshot with its timestamps and pid masked."""
    doc = json.loads(json.dumps(doc))
    doc.pop("unix_time", None)
    doc.pop("pid", None)
    for fam in doc.get("metrics", []):
        for ex in fam.get("exemplars", []):
            ex.pop("unix_time", None)
    return doc


def _script(pkg):
    """The same metric operations through one package, on a fresh
    registry: counters with and without labels, gauges set to 0 and
    moved, histograms at and around their bucket edges, a family past its
    label-cardinality cap."""
    reg = pkg.Registry()
    c = reg.counter("t_requests_total", "requests served")
    c.inc()
    c.inc(2.5)
    c.inc(route="/gen")
    c.inc(3, route="/gen")
    c.inc(route='we"ird\\lab\nel')
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("t_depth", "queue depth")
    g.set(0)
    g2 = reg.gauge("t_never_set", "untouched")
    assert g2.name == "t_never_set"
    g.inc(4)
    g.dec(1.5)
    g.set(7, slot="a")
    h = reg.histogram("t_latency_seconds", "latency")
    bounds = h.bounds
    for v in (0.0, bounds[0], bounds[0] * 1.0001, bounds[3], bounds[-1],
              bounds[-1] * 2, 1e9):
        h.observe(v)
    h.observe(0.5, phase="decode")
    hb = reg.histogram("t_tokens_per_second", "tps",
                       buckets=pkg.log_buckets(1.0, 1e5, 3))
    for v in (1.0, 10.0, 99.9, 1e5, 1e6):
        hb.observe(v)
    capped = reg.counter("t_capped_total", "capped family")
    capped._max_series = 3
    for i in range(7):
        capped.inc(rid=str(i))
    scoped = reg.scoped(replica="r0")
    scoped.counter("t_scoped_total", "scoped").inc(2)
    with scoped:
        c.inc(5)
    return reg


def test_scripted_metrics_snapshot_and_prometheus_equal_reference(both_on):
    jreg, treg = _script(jobs), _script(tobs)
    assert _masked(tobs.snapshot(treg)) == _masked(jobs.snapshot(jreg))
    assert tobs.render_prometheus(treg) == jobs.render_prometheus(jreg)
    snap = tobs.snapshot(treg)
    fam = {f["name"]: f for f in snap["metrics"]}
    # the cap: 3 series (the labelless one among them), then everything
    # lands in the overflow one
    capped = fam["t_capped_total"]
    labels = [s["labels"] for s in capped["series"]]
    assert {"overflow": "true"} in labels
    assert capped["overflow_observations"] == 5   # the labelless one counts
    # le is an inclusive upper bound: a value on a bound lands in it
    lat = next(s for s in fam["t_latency_seconds"]["series"]
               if not s["labels"])
    assert lat["counts"][0] == 2 and lat["counts"][1] == 1
    assert lat["counts"][-1] == 2 and lat["count"] == 7
    rows = dict(((n, l), v) for n, _k, l, v in
                tobs.exposition.snapshot_rows(snap))
    assert rows[("t_depth", "")] == "2.5"


def _span_tree(pkg):
    return [(e["name"], e["args"]) for e in
            pkg.get_tracer().chrome_trace()["traceEvents"] if e["ph"] == "X"]


def _span_script(pkg):
    with pkg.trace_span("serving.step"):
        with pkg.trace_span("serving.prefill", bucket=64, batch=2,
                            request_ids=[0, 1]):
            pass
        with pkg.trace_span("serving.decode", slots=2, steps=4,
                            prefix_bucket=np.int64(32)):
            with pkg.trace_span("inner"):
                pass
        with pytest.raises(KeyError):
            with pkg.trace_span("serving.readback"):
                raise KeyError("x")
    span = pkg.trace_span("reused")
    with span:
        pass
    pkg.disable()
    with span:
        pass
    pkg.enable()


def test_span_trees_and_chrome_export_equal_reference(both_on, tmp_path):
    for pkg in (jobs, tobs):
        _span_script(pkg)
    tree = _span_tree(tobs)
    assert tree == _span_tree(jobs)
    assert [n for n, _a in tree] == ["serving.prefill", "inner",
                                     "serving.decode", "serving.readback",
                                     "serving.step", "reused"]
    assert tree[3][1] == {"error": "KeyError", "depth": 1}
    assert tree[2][1]["prefix_bucket"] == "32"
    path = tobs.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert doc["traceEvents"][0]["args"]["name"] == "paddle_tpu_torch"
    assert {e["name"] for e in doc["traceEvents"]} >= {"serving.step"}


# rows whose help text the port words for itself, because the label values
# the port emits differ from the reference's (kind and labels stay equal)
OWN_HELP = {"moe_gmm_fused_dispatch_total"}


def test_catalog_equals_reference_row_for_row():
    from paddle_tpu.observability import catalog as jcat
    from paddle_tpu_torch.observability import catalog as tcat

    assert list(tcat.CATALOG) == list(jcat.CATALOG)
    for name, row in tcat.CATALOG.items():
        want = jcat.CATALOG[name]
        if name in OWN_HELP:
            assert row[:2] == want[:2] and row[2] != want[2], name
        else:
            assert row == want, name
    assert "padded" in tcat.CATALOG["moe_gmm_fused_dispatch_total"][2]
    assert tcat.BUCKETS == jcat.BUCKETS
    assert tcat.SPANS == jcat.SPANS


# rows of the catalog no port module instruments yet, by the ROADMAP queue
# item that brings them; the set shrinks with each slice
WAITING = {
    "A10": {"moe_overlap_bypass_total"},
    "A11": {"jit_cache_hits_total", "jit_cache_misses_total",
            "jit_compile_seconds", "dataloader_batches_total",
            "dataloader_batch_wait_seconds",
            "dataloader_result_queue_depth"},
}


def _port_metric_literals():
    """Every string literal passed to counter(/gauge(/histogram(/
    instrument( calls under paddle_tpu_torch/ (the reference's AST scan,
    tests/test_obs_efficiency.py)."""
    names = {}
    for root, _dirs, files in os.walk(PORT):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fun = node.func
                attr = fun.attr if isinstance(fun, ast.Attribute) \
                    else fun.id if isinstance(fun, ast.Name) else None
                if attr is None or attr.lstrip("_") not in (
                        "counter", "gauge", "histogram", "instrument"):
                    continue
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    names.setdefault(node.args[0].value, path)
    return names


def test_port_catalog_contract_no_unregistered_and_named_waiting_set():
    from paddle_tpu_torch.observability.catalog import CATALOG

    used = _port_metric_literals()
    unregistered = {n: p for n, p in used.items() if n not in CATALOG}
    assert not unregistered, unregistered
    waiting = set().union(*WAITING.values())
    assert sum(len(v) for v in WAITING.values()) == len(waiting)
    assert set(CATALOG) - set(used) == waiting


def test_obs_flags_equal_reference_but_the_fleet_and_timeseries_ones():
    # load every module that defines a flag, in both packages; the fleet
    # and time-series flags are ported too, so the sets are equal whole
    for pkg in (jobs, tobs):
        for mod in ("request_trace", "profiling", "numerics", "perf",
                    "flight_recorder", "goodput", "fleet", "timeseries"):
            getattr(pkg, mod)
    jent = jflags.flag_entries("obs_")
    tent = tflags.flag_entries("obs_")
    assert any(k.startswith("obs_fleet_") for k in tent)
    assert any(k.startswith("obs_ts_") for k in tent)
    assert sorted(tent) == sorted(jent)
    assert {k: v[1] for k, v in tent.items()} == \
        {k: v[1] for k, v in jent.items()}


def test_set_flags_all_or_nothing_watchers_and_ring_resizes(both_on):
    seen, every = [], []
    tflags.watch_flag("obs_trace_capacity", seen.append)
    tflags.watch_all_flags(lambda n, v: every.append((n, v)))
    tracer = tobs.get_tracer()
    cap = tracer._ring.maxlen
    with pytest.raises(ValueError):
        tflags.set_flags({"obs_trace_capacity": 7, "no_such_flag": 1})
    assert tflags.get_flag("obs_trace_capacity") == cap and not seen
    with pytest.raises(ValueError):
        tflags.set_flags({"obs_trace_capacity": 7,
                          "obs_requests_capacity": "many"})
    assert tflags.get_flag("obs_trace_capacity") == cap
    rt = tobs.request_trace.get_request_tracer()
    fr = tobs.flight_recorder.get_recorder()
    nm = tobs.numerics
    try:
        tflags.set_flags({"FLAGS_obs_trace_capacity": 7,
                          "obs_flight_capacity": 5,
                          "obs_requests_capacity": 4,
                          "obs_numerics_capacity": 3,
                          "obs_request_events_max": 9})
        assert seen == [7] and ("obs_trace_capacity", 7) in every
        assert tracer._ring.maxlen == 7 and fr._ring.maxlen == 5
        assert rt._done.maxlen == 4 and nm._RING.maxlen == 3
        assert rt._events_max == 9
        # the flag flip itself is incident evidence in the flight ring
        kinds = [e["kind"] for e in fr.events()]
        assert "flag_change" in kinds
        # an idempotent re-set fires the name watcher, not the global one
        n = len(every)
        tflags.set_flags({"obs_trace_capacity": 7})
        assert seen == [7, 7] and len(every) == n
        # the master switch follows its flag both ways
        tflags.set_flags({"obs_enabled": False})
        assert not tobs.enabled()
        tobs.enable()
        assert tflags.get_flag("obs_enabled") is True
    finally:
        tflags.set_flags({"obs_trace_capacity": cap,
                          "obs_flight_capacity": 512,
                          "obs_requests_capacity": 256,
                          "obs_numerics_capacity": 512,
                          "obs_request_events_max": 512})
        tflags._watchers["obs_trace_capacity"].remove(seen.append)
        tflags._global_watchers.pop()


def test_disabled_observability_is_a_noop():
    _reset(tobs)
    assert not tobs.enabled()
    c = tobs.counter("t_off_total")
    g = tobs.gauge("t_off_gauge")
    h = tobs.histogram("t_off_seconds")
    c.inc(5, k="v")
    g.set(3)
    h.observe(1.0)
    with tobs.trace_span("off"):
        pass
    tobs.flight_recorder.record("off_event", x=1)
    rt = tobs.request_trace.get_request_tracer()
    rt.submit(1, prompt_tokens=3)
    rt.record(1, "decode", tokens=1)
    assert rt.finish(1, tokens=1) is None
    tobs.numerics.record_stats("site", object())   # never touched
    assert c.labels().value == 0 and not g.labels().updated
    assert h.labels().count == 0 and not tobs.get_tracer().spans()
    assert not tobs.flight_recorder.get_recorder().events()
    assert rt.live_count() == 0 and not tobs.numerics.entries()
    assert tobs.perf.update_hbm_gauges() == {}


def _request_script(pkg):
    """The engine's request-trace calls for three requests: a preempted
    one, a shed one and one finishing in its first step."""
    rt = pkg.request_trace
    tr = rt.get_request_tracer()
    ttft = pkg.get_registry().histogram("serving_ttft_seconds")
    tr.submit(0, prompt_tokens=5, max_new_tokens=4, tenant="a")
    tr.admitted(0, slot=0, context_tokens=5, cached_tokens=0)
    tr.record(0, "prefill", bucket=8, batch=1, chunk_start=0, chunk=5)
    tr.record(0, "first_token")
    rt.observe_with_exemplar(ttft, 0.004, 0)
    tr.record(0, "decode", tokens=1)
    tr.record(0, "preempt", slot=0, generated=2, swapped=False)
    tr.admitted(0, slot=1, context_tokens=7, cached_tokens=0)
    tr.record(0, "decode", tokens=2)
    tr.finish(0, tokens=4, reason="finished")
    tr.submit(1, prompt_tokens=3, max_new_tokens=2, tenant="b")
    tr.finish(1, tokens=0, reason="shed", shed_reason="queue_full")
    tr.submit(2, prompt_tokens=3, max_new_tokens=1, tenant="a")
    tr.admitted(2, slot=0, context_tokens=3, cached_tokens=0)
    rt.observe_with_exemplar(ttft, 2.5, 2)
    tr.finish(2, tokens=1, reason="finished")
    tr.record(2, "decode", tokens=1)          # after finish: a no-op
    return rt.requests_payload(sort="finished")


def _masked_requests(doc):
    doc = json.loads(json.dumps(doc, default=repr))
    for k in ("unix_time", "pid"):
        doc.pop(k)
    for row in doc["requests"]:
        for k in list(row):
            if k.endswith(("_unix", "_ms")) or k == "decode_tps":
                row[k] = row[k] is not None
    for exs in doc["exemplars"].values():
        for ex in exs:
            ex.pop("unix_time")
    for q in doc["exemplar_quantiles"].values():
        q["p99"].pop("unix_time")
    doc["audit"] = [e["request_id"] for e in doc["audit"]]
    return doc


def test_request_timelines_and_exemplars_equal_reference(both_on):
    want = _masked_requests(_request_script(jobs))
    got = _masked_requests(_request_script(tobs))
    assert got == want
    assert want["exemplar_quantiles"]["serving_ttft_seconds"]["p99"][
        "request_id"] == 2
    kinds = [e["kind"] for e in
             tobs.request_trace.get_request_tracer().get(0)["events"]]
    assert kinds == ["queued", "admitted", "prefill", "first_token",
                     "decode", "preempt", "resumed", "decode", "finish"]
    spans = [s.name for s in tobs.get_tracer().spans()]
    assert spans == ["serving.request"] * 3


def test_flight_recorder_postmortem_and_goodput_equal_reference(both_on,
                                                                tmp_path):
    docs = []
    for pkg in (jobs, tobs):
        # one sampler tick at a fixed clock: the post-mortem embeds the
        # time-series tail in both packages
        pkg.timeseries.reset()
        pkg.timeseries.tick(now=1000.0)
        fr = pkg.flight_recorder
        fr.record("preemption", req_id=3, generated=2, swapped=True)
        fr.record("serving_step_recovered", error="SimulatedCrash: x",
                  recoveries=1, salvaged=0)
        pkg.goodput.get_tracker().reset()
        pkg.goodput.account("compile", 0.5)
        pkg.counter("t_pm_total").inc()
        with pkg.trace_span("serving.step"):
            doc = fr.get_recorder().postmortem(
                trigger="manual", error=RuntimeError("boom"))
        path = fr.dump(str(tmp_path / f"{pkg.__name__}.json"))
        assert json.load(open(path))["trigger"] == "manual"
        docs.append(doc)
        pkg.goodput.get_tracker().reset()
    j, t = docs
    strip = [{k: v for k, v in e.items() if k != "t"} for e in j["events"]]
    assert [{k: v for k, v in e.items() if k != "t"}
            for e in t["events"]] == strip
    assert list(t["open_spans"].values()) == [["serving.step"]]
    assert t["error"] == j["error"]
    assert t["goodput"]["seconds"]["compile"] == 0.5
    # both embed the time-series tail their sampler wrote
    assert set(t) == set(j) and "timeseries" in t
    assert t["timeseries"] == j["timeseries"]
    assert [e["t"] for e in t["timeseries"]["entries"]] == [1000.0]
    for pkg in (jobs, tobs):
        pkg.timeseries.reset()
    names = {f["name"] for f in t["metrics"]["metrics"]}
    assert "t_pm_total" in names and "flight_recorder_dumps_total" in names


def test_numerics_stat_vectors_equal_reference(both_on):
    from paddle_tpu.kernels.quant_matmul import quantize_kv as jq
    import torch
    from paddle_tpu_torch.kernels.quant_matmul import quantize_kv as tq

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32) * 40
    x[0, 0, 0] = np.nan
    x[1, 2, 3] = 300.0
    k = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 4, 2, 8)).astype(np.float32) * 3
    want = np.asarray(jobs.numerics.tensor_stats(jnp.asarray(x)))
    got = tobs.numerics.tensor_stats(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for pkg, quant, arr in ((jobs, jq, jnp.asarray),
                            (tobs, tq, torch.from_numpy)):
        pkg.numerics.enable()
        try:
            pairs = [(arr(a),) + tuple(quant(arr(a))) + (-1,)
                     for a in (k, v)]
            pkg.numerics.record_quant_error("kv_int8", pairs)
            pkg.numerics.record_stats("x", arr(x), layer=2)
            pkg.numerics.flush()
        finally:
            pkg.numerics.disable()
    je = jobs.numerics.entries()
    te = tobs.numerics.entries()
    assert [(e["site"], e["layer"]) for e in te] == \
        [(e["site"], e["layer"]) for e in je] == [("kv_int8", -1), ("x", 2)]
    for a, b in zip(te, je):
        for f in tobs.numerics.STAT_FIELDS:
            if b[f] is None:
                assert a[f] is None
            else:
                assert a[f] == pytest.approx(b[f], rel=1e-5, abs=1e-7)
    gauge = tobs.get_registry().gauge("numerics_quant_error")
    assert gauge.labels(site="kv_int8").value == pytest.approx(
        je[0]["quant_err"], rel=1e-5)
    assert tobs.numerics.rows()[0]["site"] == "kv_int8"


def test_decode_flops_and_perf_helpers():
    import torch
    from paddle_tpu_torch.models import llama as tl

    cfg = tl.tiny_llama(vocab=32, hidden=16, layers=2, heads=4, kv_heads=2,
                        ffn=24)
    h, d = 16, 4
    per_layer = h * 4 * d + 2 * h * 2 * d + 4 * d * h + 3 * h * 24
    assert tobs.perf.matmul_params(cfg) == 2 * per_layer + h * 32
    want = 3 * (2 * (2 * per_layer + h * 32) * 5 + 4 * 4 * d * 2 * 40)
    assert tobs.perf.decode_flops(cfg, rows=5, steps=3,
                                  attn_tokens=40) == want
    assert tobs.perf.peak_flops("cpu") == 1e12
    assert tobs.perf.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tobs.perf.hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tobs.perf.mfu(2e12, 4.0, "cpu") == 0.5
    assert tobs.perf.mfu(None, 1.0) is None
    batch = {"ids": torch.zeros((2, 8), dtype=torch.long),
             "mask": torch.ones((2, 8), dtype=torch.bool),
             "x": [torch.zeros(3), np.zeros((4,), np.int32)]}
    assert tobs.perf.token_count(batch) == 20
    if not torch.cuda.is_available():
        assert tobs.perf.hbm_stats() == {}


FLEET_PAGES = ("/fleet/metrics", "/fleet/replicas.json",
               "/fleet/placements.json", "/alerts.json")


def test_metrics_server_routes(both_on):
    srv = tobs.MetricsServer(port=0)
    base = f"http://127.0.0.1:{srv.port}"

    def get(path, root=base):
        try:
            with urllib.request.urlopen(root + path, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    try:
        tobs.counter("t_srv_total", "served").inc(3)
        with tobs.trace_span("serving.step"):
            pass
        tr = tobs.request_trace.get_request_tracer()
        tr.submit(7, prompt_tokens=2)
        tr.finish(7, tokens=0, reason="finished")
        code, text = get("/metrics")
        assert code == 200 and "t_srv_total 3" in text
        code, body = get("/snapshot.json")
        assert code == 200 and json.loads(body)["version"] == 1
        code, body = get("/trace.json")
        names = [e["name"] for e in json.loads(body)["traceEvents"]]
        assert "serving.step" in names and "serving.request" in names
        code, body = get("/requests.json?sort=tokens&limit=5")
        assert code == 200 and json.loads(body)["requests"][0][
            "request_id"] == 7
        code, body = get("/request/7.json")
        assert code == 200 and json.loads(body)["finished"]
        assert get("/request/99.json")[0] == 404
        assert get("/healthz") == (200, "ok")
        # the fleet and alert views serve the reference server's payloads
        jsrv = jobs.MetricsServer(port=0)
        pages = []
        try:
            for pkg, port in ((jobs, jsrv.port), (tobs, srv.port)):
                pkg.fleet.get_aggregator().detach_router()
                pkg.timeseries.reset()
                pkg.counter("serving_tokens_total").inc(5, replica="r0")
                pkg.counter("serving_tokens_total").inc(2, replica="r1")
                pages.append({path: get(path, f"http://127.0.0.1:{port}")
                              for path in FLEET_PAGES})
        finally:
            jsrv.close()
        jp, tp = pages
        assert tp["/fleet/metrics"] == jp["/fleet/metrics"]
        assert "serving_tokens_total 7" in tp["/fleet/metrics"][1]
        for path in FLEET_PAGES[1:]:
            assert tp[path][0] == jp[path][0] == 200
            tdoc, jdoc = json.loads(tp[path][1]), json.loads(jp[path][1])
            tdoc.pop("unix_time"), jdoc.pop("unix_time")
            assert tdoc == jdoc, path
        assert get("/fleet/nowhere")[0] == 404
        code, body = get("/control/profile?steps=2")
        assert code == 200 and json.loads(body)["armed_steps"] == 2
        assert get("/control/profile?steps=1")[0] == 409
        assert get("/control/profile?steps=x")[0] == 400
        code, body = get("/control/profile?stop=1")
        assert code == 200 and not json.loads(body)["status"]["active"]
        assert get("/nowhere")[0] == 404
    finally:
        srv.close()
        tobs.profiling.get_controller().stop()


def test_profiler_window_records_spans_on_the_cpu(both_on, tmp_path):
    prof = tobs.profiling
    out = prof.request_capture(steps=2, out_dir=str(tmp_path / "cap"))
    assert out["ok"] and prof.get_controller().status()["steps_left"] == 2
    for _ in range(4):
        prof.step_tick()
        with tobs.trace_span("serving.step"):
            sum(range(100))
    ctl = prof.get_controller()
    last = ctl.status()["last_capture"]
    assert last["ok"] and os.path.exists(last["trace"])
    names = [e.name for e in ctl.last_profile().events()]
    assert names.count("serving.step") == 2
    assert tobs.get_registry().counter(
        "obs_profile_captures_total").labels().value == 1
    evs = [e for e in tobs.flight_recorder.get_recorder().events()
           if e["kind"] == "profile_capture"]
    assert len(evs) == 1 and evs[0]["steps"] == 2
    assert not ctl._pending and tobs.tracing._ANNOTATION_FACTORY is None


def test_package_imports_without_torch_under_50ms():
    """Re-importing the package fresh (parents already loaded) costs under
    the reference's 50 ms budget, and pulls no torch (checked in a fresh
    process by tests/test_torch_boundaries.py as well). The cost is the
    import's CPU time, the best of three: wall time on a loaded test
    machine measures the scheduler, not the import."""
    def reimport():
        saved = {m: sys.modules.pop(m) for m in list(sys.modules)
                 if m.startswith("paddle_tpu_torch.observability")}
        try:
            t0 = time.process_time()
            importlib.import_module("paddle_tpu_torch.observability")
            return time.process_time() - t0
        finally:
            for m in list(sys.modules):
                if m.startswith("paddle_tpu_torch.observability"):
                    del sys.modules[m]
            sys.modules.update(saved)

    dt = min(reimport() for _ in range(3))
    assert dt < 0.05, f"observability import took {dt * 1e3:.1f} ms"
