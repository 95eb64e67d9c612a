"""The port's serving engine with observability on, held to the JAX
engine's on the CPU, step for step.

Both engines run the same requests with both packages' observability on
and both engine modules' ``time`` patched to one fake clock (a second a
step, as tests/test_torch_admission.py does). After every step the two
give equal counter values (the ``*_seconds_total`` ones aside: they
count host seconds) and histogram counts, equal gauges (all but MFU, the
HBM ones and the quant error, checked on their own), equal flight events
(less their times), equal per-request timeline event names and equal
span names and nesting — across ragged, mega and bucketed decode,
recompute preemption, sheds, deadlines and cancels, the prefix cache
with chunked prefill, sync and async swap/offload, a ``ResilientEngine``
crash, speculative waves, int8 weights (``weight_only``) and int8 KV,
where ``numerics_quant_error{site="kv_int8"}`` matches within 1e-5
relative.

Also: the MFU gauge under an injected step time equals the analytic count
(``observability.perf.decode_flops``, cross-checked against
``chip_smoke.py``'s own count); a CPU ``torch.profiler`` window records
``serving.step`` ranges; with observability off ``step()`` runs nothing
but its one check before ``_step_inner()`` and the numerics sites add no
device op."""
import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import AdmissionConfig as JaxAdmissionConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ResilientEngine as JaxResilient
from paddle_tpu.serving import ShedError as JaxShedError
from paddle_tpu.serving import engine as jeng
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import (AdmissionConfig, LLMEngine,
                                      ResilientEngine, ShedError)
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
GEOMETRY = dict(max_slots=2, block_size=8, max_model_len=64,
                prompt_buckets=[8, 32])
# gauges held apart: MFU (host-counted FLOPs against XLA's cost analysis),
# the HBM ones (no such counters on the CPU) and the quant error
# (compared within its tolerance)
SKIP_GAUGES = {"serving_mfu", "hbm_used_bytes", "hbm_peak_bytes",
               "numerics_quant_error"}
# both engines tick the time-series sampler at the end of a step, but its
# throttle reads the host's wall clock (FLAGS_obs_ts_interval_s), so the
# obs_ts_* series depend on how long each package's steps take: they are
# held apart here and compared against explicit clocks in
# test_torch_timeseries.py
TS_PREFIX = "obs_ts_"


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _reset(pkg):
    pkg.get_registry().reset()
    pkg.get_tracer().clear()
    pkg.flight_recorder.get_recorder().clear()
    pkg.request_trace.get_request_tracer().clear()
    pkg.request_trace.get_exemplar_store().clear()
    pkg.numerics.clear()


# the request tracer's SLO audit reads the host clock, not the engines'
# fake one: targets far out of reach keep it out of the comparison
SLO = {"obs_slo_ttft_ms": 1e9, "obs_slo_tpot_ms": 1e9}


@pytest.fixture
def obs_on():
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu_torch.framework import flags as tflags

    saved = [(f, {k: f.get_flag(k) for k in SLO}) for f in (jflags, tflags)]
    for pkg, f in ((jobs, jflags), (tobs, tflags)):
        pkg.enable()
        f.set_flags(SLO)
        _reset(pkg)
    try:
        yield
    finally:
        for pkg in (jobs, tobs):
            pkg.numerics.disable()
            pkg.disable()
            _reset(pkg)
        for f, vals in saved:
            f.set_flags(vals)


class _FakeTime:
    """The ``time`` module with a ``perf_counter`` that reads ``now``."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _key(labels):
    return tuple(sorted(labels.items()))


def _state(pkg, n_ids):
    """Everything compared after a step."""
    counters, hists, gauges = {}, {}, {}
    for fam in pkg.snapshot()["metrics"]:
        if fam["name"].startswith(TS_PREFIX):
            continue
        for s in fam["series"]:
            k = (fam["name"], _key(s["labels"]))
            if fam["kind"] == "counter":
                if s["value"] and not fam["name"].endswith("_seconds_total"):
                    counters[k] = s["value"]
            elif fam["kind"] == "histogram":
                if s["count"]:
                    hists[k] = s["count"]
            elif s.get("updated") and fam["name"] not in SKIP_GAUGES:
                gauges[k] = s["value"]
    flight = [json.loads(json.dumps({k: v for k, v in e.items() if k != "t"},
                                    default=repr))
              for e in pkg.flight_recorder.get_recorder().events()]
    tracer = pkg.request_trace.get_request_tracer()
    timelines = {}
    for rid in range(n_ids):
        doc = tracer.get(rid)
        if doc is not None:
            timelines[rid] = [e["kind"] for e in doc["events"]]
    spans = [(s.name, s.depth) for s in pkg.get_tracer().spans()]
    return {"counters": counters, "histograms": hists, "gauges": gauges,
            "flight": flight, "timelines": timelines, "spans": spans}


def _quant_errs(pkg):
    pkg.numerics.flush()
    return sorted(e["quant_err"] for e in pkg.numerics.entries()
                  if e["quant_err"] is not None)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(n)).tolist() for n in lens]


def _drive(make, pkg, clock, script, prompts, shed_error, resilient=None,
           numerics=False):
    """Step a fresh engine through ``script`` (step index -> actions:
    ("add", prompt index, kwargs) or ("cancel", add index[, reason])),
    the clock a second ahead after every step; the state after each."""
    clock.now = 1000.0
    _reset(pkg)
    eng = make()
    runner = resilient(eng) if resilient is not None else eng
    ids, states, qerr = [], [], []
    idx, last = 0, max(script)
    while idx <= last or runner.has_work():
        for act in script.get(idx, []):
            if act[0] == "add":
                try:
                    ids.append(runner.add_request(prompts[act[1]],
                                                  **act[2]))
                except shed_error as e:
                    ids.append(e.req_id)
            else:
                eng.cancel_request(ids[act[1]], *act[2:])
        runner.step()
        clock.now += 1.0
        if numerics:
            qerr.append(_quant_errs(pkg))
        states.append(_state(pkg, eng._next_id))
        idx += 1
        assert idx < 200, "the engine never drained"
    return states, qerr, eng


def _both(model, monkeypatch, script, prompts, kw, jkw=None, tkw=None,
          resilient=False, numerics=False, injector=None):
    jcfg, jp, tcfg, tp = model
    clock = _FakeTime()
    monkeypatch.setattr(jeng, "time", clock)
    monkeypatch.setattr(teng, "time", clock)
    if numerics:
        jobs.numerics.enable()
        tobs.numerics.enable()
    out = []
    for pkg, E, params, cfg, extra, faults, res, shed in (
            (jobs, JaxEngine, jp, jcfg, jkw or {}, jfaults, JaxResilient,
             JaxShedError),
            (tobs, LLMEngine, tp, tcfg, dict(tkw or {}, device="cpu"),
             tfaults, ResilientEngine, ShedError)):
        def make(E=E, params=params, cfg=cfg, extra=extra, faults=faults):
            k = dict(kw, **extra)
            if injector is not None:
                k["injector"] = faults.FaultInjector(injector)
            return E(params, cfg, **k)
        out.append(_drive(make, pkg, clock, script, prompts, shed,
                          res if resilient else None, numerics))
    (jstates, jq, _), (tstates, tq, teng_) = out
    assert len(tstates) == len(jstates)
    for i, (t, j) in enumerate(zip(tstates, jstates)):
        for part in t:
            assert t[part] == j[part], f"step {i}: {part}"
    for i, (t, j) in enumerate(zip(tq, jq)):
        assert len(t) == len(j), f"step {i}: quant-error landings"
        np.testing.assert_allclose(t, j, rtol=1e-5, err_msg=f"step {i}")
    return tstates, tq, teng_


LONG = dict(max_new_tokens=12)
SCENARIOS = {
    # more requests than slots, chained calls, a sampled request
    "ragged": (dict(decode_kernel="ragged", decode_steps=2),
               {0: [("add", 0, LONG), ("add", 1, dict(max_new_tokens=6)),
                    ("add", 2, dict(max_new_tokens=5, temperature=0.8,
                                    top_k=5))],
                3: [("add", 3, dict(max_new_tokens=4, eos_token_id=7))]}),
    "bucketed_preempt": (
        dict(decode_kernel="bucketed", decode_steps=2, num_blocks=5,
             prompt_buckets=[8]),
        {0: [("add", 0, dict(max_new_tokens=16)),
             ("add", 1, dict(max_new_tokens=16)),
             ("add", 2, dict(max_new_tokens=8))]}),
    # two slots; a queue of 3 sheds the 4th and 5th adds; request 2
    # expires queued, request 0 in its slot; a queued request is drained,
    # an in-slot one cancelled, then cancelled again (a counted no-op)
    "lifecycle": (
        dict(decode_kernel="bucketed", decode_steps=2,
             admission="max_queue"),
        {0: [("add", 0, dict(max_new_tokens=24, deadline_s=4.5)),
             ("add", 1, LONG), ("add", 2, dict(max_new_tokens=4,
                                                deadline_s=2.5)),
             ("add", 3, LONG), ("add", 4, LONG)],
         1: [("add", 4, LONG)],
         2: [("cancel", 5, "drained")], 5: [("cancel", 1)],
         9: [("cancel", 1)]}),
    "prefix_chunks": (
        dict(decode_kernel="bucketed", prefix_cache=True, prefill_chunk=8,
             prefix_cache_host_bytes=1 << 20, num_blocks=9),
        {0: [("add", 5, dict(max_new_tokens=6))],
         2: [("add", 6, dict(max_new_tokens=6))],
         6: [("add", 5, dict(max_new_tokens=4))]}),
    "swap_sync": (
        dict(decode_kernel="bucketed", num_blocks=5, prompt_buckets=[8],
             kv_swap_bytes=1 << 20, kv_offload="sync"),
        {0: [("add", i, dict(max_new_tokens=16)) for i in range(3)]}),
    "swap_async": (
        dict(decode_kernel="bucketed", num_blocks=5, prompt_buckets=[8],
             kv_swap_bytes=1 << 20, kv_offload="async"),
        {0: [("add", i, dict(max_new_tokens=16)) for i in range(3)]}),
}
PROMPT_LENS = (7, 5, 6, 4, 6, 20, 22)


def _with_prefixes(prompts):
    # prompts 5 and 6 share their first two blocks (a cache hit)
    prompts[6][:16] = prompts[5][:16]
    return prompts


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_telemetry_equals_jax_step_for_step(model, monkeypatch,
                                                   obs_on, name):
    kw, script = SCENARIOS[name]
    kw = dict(GEOMETRY, **kw)
    jkw = tkw = None
    if kw.get("admission") == "max_queue":
        kw.pop("admission")
        jkw = dict(admission=JaxAdmissionConfig(max_queue=3))
        tkw = dict(admission=AdmissionConfig(max_queue=3))
    prompts = _with_prefixes(_prompts(3, PROMPT_LENS))
    states, _, eng = _both(model, monkeypatch, script, prompts, kw, jkw, tkw)
    final = states[-1]
    names = {n for n, _l in final["counters"]}
    assert {"serving_admissions_total", "serving_tokens_total",
            "serving_decode_kernel_total",
            "serving_decode_recompiles_total"} <= names
    spans = {n for n, _d in final["spans"]}
    assert {"serving.step", "serving.prefill", "serving.decode",
            "serving.readback", "serving.request"} <= spans
    kinds = {k for tl_ in final["timelines"].values() for k in tl_}
    assert {"queued", "admitted", "prefill", "first_token",
            "finish"} <= kinds
    if name in ("bucketed_preempt", "swap_sync", "swap_async"):
        assert ("serving_preemptions_total", ()) in final["counters"]
        assert "resumed" in kinds and "preempt" in kinds
    if name.startswith("swap"):
        assert final["counters"][("serving_kv_swap_out_total", ())] >= 1
        assert final["counters"][("serving_kv_swap_in_total", ())] >= 1
        assert any(e["kind"] == "kv_swap_in" for e in final["flight"])
    if name == "lifecycle":
        c = final["counters"]
        assert c[("serving_shed_total", (("reason", "queue_full"),))] >= 1
        assert c[("serving_deadline_exceeded_total", ())] >= 1
        assert c[("serving_cancel_noop_total", ())] >= 1
        assert {"request_shed", "deadline_exceeded", "drained",
                "client_disconnected"} <= {e["kind"] for e in final["flight"]}
    if name == "prefix_chunks":
        c = final["counters"]
        assert c[("serving_prefix_cache_hits_total", ())] >= 1
        assert c[("serving_prefill_tokens_skipped_total", ())] >= 16
        assert ("serving_prefix_cache_blocks", ()) in final["gauges"]
    # the host counters stay, and the metrics mirror them
    assert final["counters"][("serving_decode_kernel_total",
                              (("path", eng.decode_paths.most_common(1)[0][
                                  0]),))] == eng.decode_paths.most_common(
                                      1)[0][1]


def test_mega_telemetry_equals_jax(model, monkeypatch, obs_on):
    # the tiny model's head_dim 8 is outside the CUDA kernel's screen; the
    # plain version takes any head_dim, so let the screen pass here
    monkeypatch.setattr(teng, "mega_supported", lambda *a, **k: (True, "ok"))
    states, _, eng = _both(
        model, monkeypatch,
        {0: [("add", 0, LONG), ("add", 1, LONG), ("add", 2, LONG)]},
        _prompts(4, (7, 5, 6)),
        dict(GEOMETRY, decode_kernel="mega", decode_steps=2))
    c = states[-1]["counters"]
    assert c[("serving_decode_kernel_total", (("path", "mega"),))] == \
        eng.decode_paths["mega"]


def test_resilient_crash_telemetry_equals_jax(model, monkeypatch, obs_on):
    states, _, eng = _both(
        model, monkeypatch,
        {0: [("add", i, dict(max_new_tokens=10)) for i in range(3)]},
        _prompts(5, (7, 5, 6)),
        dict(GEOMETRY, decode_kernel="bucketed", decode_steps=2,
             num_blocks=6, kv_swap_bytes=1 << 20),
        resilient=True,
        injector="slow_step@2,readback_fail@4,pool_squeeze@5")
    final = states[-1]
    assert final["counters"][("serving_engine_recoveries_total", ())] == 1
    kinds = [e["kind"] for e in final["flight"]]
    assert {"serving_step_recovered", "injected_readback_fail",
            "injected_slow_step", "injected_pool_squeeze"} <= set(kinds)


def test_spec_waves_telemetry_equals_jax(model, monkeypatch, obs_on):
    jcfg, jp, tcfg, tp = model
    states, _, eng = _both(
        model, monkeypatch,
        {0: [("add", 0, LONG), ("add", 1, LONG)]}, _prompts(6, (7, 5)),
        dict(GEOMETRY, decode_kernel="bucketed", spec_tokens=3),
        jkw=dict(draft_params=jp, draft_config=jcfg),
        tkw=dict(draft_params=tp, draft_config=tcfg))
    final = states[-1]
    spans = {n for n, _d in final["spans"]}
    assert {"serving.spec_draft", "serving.spec_verify"} <= spans
    assert final["counters"][("serving_spec_proposed_total", ())] == \
        eng.spec_proposed
    assert final["gauges"][("serving_spec_acceptance_rate", ())] == 1.0


def test_int8_kv_quant_error_equals_jax(model, monkeypatch, obs_on):
    """int8 pools with FLAGS_obs_numerics on: every landing's relative
    reconstruction error (prefill waves and decode writebacks) equals the
    JAX engine's within 1e-5 relative, and so does the gauge."""
    states, qerr, eng = _both(
        model, monkeypatch,
        {0: [("add", 0, LONG), ("add", 1, dict(max_new_tokens=6))],
         2: [("add", 2, dict(max_new_tokens=5))]},
        _prompts(7, (7, 5, 6)),
        dict(GEOMETRY, decode_kernel="ragged", decode_steps=2,
             kv_dtype="int8"), numerics=True)
    assert sum(len(q) for q in qerr[:1]) >= 1 and len(qerr[-1]) >= 4
    want = jobs.get_registry().gauge("numerics_quant_error").labels(
        site="kv_int8").value
    got = tobs.get_registry().gauge("numerics_quant_error").labels(
        site="kv_int8").value
    assert 0 < got < 0.05
    assert got == pytest.approx(want, rel=1e-5)
    c = states[-1]["counters"]
    assert c[("numerics_events_total", (("site", "kv_int8"),))] == \
        len(qerr[-1])


def test_int8_weights_quant_error_and_telemetry_equal_jax(model,
                                                          monkeypatch,
                                                          obs_on):
    jcfg, jp, tcfg, tp = model
    for pkg in (jobs, tobs):
        pkg.numerics.enable()
    jq = jl.quantize_params(jp)
    tq = tl.quantize_params(tp)
    for pkg in (jobs, tobs):
        pkg.numerics.flush()
    want = jobs.numerics.latest("weight_only")
    got = tobs.numerics.latest("weight_only")
    for f in tobs.numerics.STAT_FIELDS:
        assert got[f] == pytest.approx(want[f], rel=1e-5, abs=1e-7), f
    assert 0 < got["quant_err"] < 0.05
    for pkg in (jobs, tobs):
        pkg.numerics.disable()
    _both((jcfg, jq, tcfg, tq), monkeypatch,
          {0: [("add", 0, LONG), ("add", 1, LONG)]}, _prompts(8, (7, 5)),
          dict(GEOMETRY, decode_kernel="ragged", decode_steps=2))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", ["ragged", "bucketed"])
def test_mfu_gauge_equals_the_analytic_count(model, monkeypatch, obs_on,
                                             kernel):
    """With each step made to take 0.5 s of the fake clock, the MFU gauge
    is the decode call's counted FLOPs over 0.5 s x the CPU's nominal
    1 TFLOP/s — and the count equals chip_smoke.py's own."""
    _, _, tcfg, tp = model
    clock = _FakeTime()
    monkeypatch.setattr(teng, "time", clock)
    eng = LLMEngine(tp, tcfg, device="cpu", decode_kernel=kernel,
                    decode_steps=2, **GEOMETRY)
    for p in _prompts(9, (7, 13)):
        eng.add_request(p, max_new_tokens=12)
    inner = eng._step_inner

    def slow_inner():
        out = inner()
        clock.now += 0.5
        return out

    eng._step_inner = slow_inner
    walks = []
    dispatch = eng._dispatch_decode

    def recording_dispatch(active):
        # the lengths the kernels walk: the host's, plus decode_steps for
        # slots behind the unread call in flight
        prev = eng._inflight
        snap = {s for s, _ in prev["snapshot"]} if prev else set()
        walks.append([int(eng.lengths[i])
                      + (eng.decode_steps if i in snap else 0)
                      for i in active])
        return dispatch(active)

    eng._dispatch_decode = recording_dispatch
    smoke = _chip_smoke()
    gauge = tobs.get_registry().gauge("serving_mfu")
    seen = 0
    while eng.has_work():
        walks.clear()
        eng.step()
        flops = eng._last_decode_flops
        if flops is None:
            assert not walks
            continue
        if kernel == "ragged":
            assert flops == smoke.analytic_decode_flops(
                tcfg, rows=eng.N, steps=eng.decode_steps,
                walk_lens=walks[0], block_size=eng.bs)
        assert gauge.labels().value == pytest.approx(
            flops / (0.5 * 1e12), rel=1e-12)
        seen += 1
    assert seen >= 3


def test_cpu_profiler_window_records_serving_steps(model, obs_on, tmp_path):
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", decode_steps=2, **GEOMETRY)
    for p in _prompts(10, (7, 5)):
        eng.add_request(p, max_new_tokens=10)
    eng.step()
    out = tobs.request_capture(steps=2, out_dir=str(tmp_path / "cap"))
    assert out["ok"]
    for _ in range(4):
        eng.step()
    ctl = tobs.get_profile_controller()
    last = ctl.status()["last_capture"]
    assert last["ok"] and os.path.getsize(last["trace"]) > 0
    names = [e.name for e in ctl.last_profile().events()]
    assert names.count("serving.step") == 2
    assert "serving.decode" in names and "serving.readback" in names
    trace = json.load(open(last["trace"]))
    assert any(e.get("name") == "serving.step"
               for e in trace["traceEvents"])
    assert tobs.get_registry().counter(
        "obs_profile_captures_total").labels().value == 1
    assert [e["kind"] for e in tobs.flight_recorder.get_recorder().events()
            ].count("profile_capture") == 1


def test_step_with_observability_off_is_one_check(model, monkeypatch):
    """Off, ``step()`` runs the idle profiler tick and one enabled()
    check, then returns ``_step_inner()``'s own result: no clock read,
    no span, no metric."""
    _, _, tcfg, tp = model
    assert not tobs.enabled()
    eng = LLMEngine(tp, tcfg, device="cpu", **GEOMETRY)
    sentinel = object()
    eng._step_inner = lambda: sentinel

    class NoClock:
        def perf_counter(self):
            raise AssertionError("clock read with observability off")

    def no_span(*a, **k):
        raise AssertionError("span opened with observability off")

    monkeypatch.setattr(teng, "time", NoClock())
    monkeypatch.setattr(teng, "trace_span", no_span)
    checks = []
    real = tobs.enabled
    monkeypatch.setattr(teng._obs, "enabled",
                        lambda: checks.append(1) or real())
    assert eng.step() is sentinel and checks == [1]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_numerics_sites_add_no_device_op_when_off(model, obs_on):
    """int8 pools: a prefill wave and a decode call run the same torch ops
    with FLAGS_obs_numerics off as with observability off entirely; on,
    the probes add theirs."""
    _, _, tcfg, tp = model

    def ops():
        eng = LLMEngine(tp, tcfg, device="cpu", kv_dtype="int8", seed=1,
                        decode_kernel="ragged", decode_steps=2, **GEOMETRY)
        eng.add_request([1, 2, 3, 4, 5], max_new_tokens=6)
        with _Ops() as rec:
            eng.step()
            eng.step()
        return rec.ops

    on_no_numerics = ops()
    tobs.disable()
    off = ops()
    tobs.enable()
    tobs.numerics.enable()
    with_probes = ops()
    assert on_no_numerics == off
    assert len(with_probes) > len(off)
