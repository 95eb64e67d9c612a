"""The port's admission control (paddle_tpu_torch.serving.admission) and
request lifecycle (shedding, deadlines, cancellation, terminal reasons)
held to the JAX package's on the CPU.

- ``AdmissionController``: the same decision and the same
  ``retry_after`` as the JAX controller at every point of a scripted
  sequence on one virtual clock — every shed reason, a pool-pressure
  shed that does not charge the rate bucket, per-tenant buckets;
- ``LLMEngine(admission=...)``: the same ids shed for the same reasons
  as the JAX engine and the same streams for the admitted ones; an
  oversize prompt raises before an id is minted; the proactive-spill
  threshold follows the shed threshold;
- deadlines and ``cancel_request``: with ``time.perf_counter`` of both
  engine modules patched to one fake clock that advances a second a
  step, a queued and an in-slot deadline, cancelling a queued request,
  an in-slot request behind a chained call and a finished one
  (``cancel_noops``) give the same per-step lists, finish reasons,
  results and ledgers as the JAX engine."""
import dataclasses
import time
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from conftest import assert_blocks_balanced
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import AdmissionConfig as JaxAdmissionConfig
from paddle_tpu.serving import AdmissionController as JaxController
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ShedError as JaxShedError
from paddle_tpu.serving import engine as jeng
from paddle_tpu_torch.framework.flags import get_flag
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import (AdmissionConfig, AdmissionController,
                                      LLMEngine, Request, ShedError)
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
GEOMETRY = dict(max_slots=2, block_size=8, max_model_len=64,
                prompt_buckets=[8, 32])


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt(rng, n):
    return rng.integers(1, 64, size=n).tolist()


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
# (seconds to advance, tenant, prompt length, max_new_tokens, queue depth,
#  free fraction)
SCRIPT = [(0.0, "a", 10, 6, 0, 1.0), (0.0, "a", 10, 6, 1, 1.0),
          (0.0, "a", 4, 4, 1, 1.0), (0.0, "b", 10, 10, 1, 1.0),
          (0.0, "a", 10, 10, 3, 1.0), (0.0, "b", 10, 10, 2, 0.1),
          (0.0, "b", 10, 10, 2, 0.1), (0.3, "a", 2, 2, 1, 1.0),
          (1.0, "a", 10, 6, 0, 0.1), (0.5, "b", 5, 5, 2, 1.0),
          (4.0, "a", 40, 30, 1, 1.0), (0.0, "c", 1, 1, 0, 1.0),
          (2.5, "b", 10, 10, 1, 0.3), (0.0, "a", 10, 6, 2, 1.0)]


@pytest.mark.parametrize("cfg", [
    dict(max_queue=3, rate_tokens_per_s=8.0, burst_tokens=24.0,
         shed_free_frac=0.25),
    dict(max_queue=2, rate_tokens_per_s=5.0),
    dict(max_queue=16, shed_free_frac=0.5)])
def test_controller_decisions_and_retry_after_equal_jax(cfg):
    clock = [0.0]
    jctl = JaxController(JaxAdmissionConfig(**cfg), now_fn=lambda: clock[0])
    tctl = AdmissionController(AdmissionConfig(**cfg),
                               now_fn=lambda: clock[0])
    seen = []
    for dt, tenant, n, new, depth, frac in SCRIPT:
        clock[0] += dt
        kw = dict(prompt=[1] * n, max_new_tokens=new, tenant=tenant)
        want = jctl.check(JaxRequest(req_id=0, **kw), depth, frac)
        got = tctl.check(Request(req_id=0, **kw), depth, frac)
        assert got == want
        seen.append(got)
        for t in ("a", "b", "c", "d"):
            for cost in (1, 20, 1000):
                assert tctl.retry_after(t, cost) \
                    == jctl.retry_after(t, cost)
    assert tctl.sheds == Counter(r for r in seen if r is not None)
    if cfg["max_queue"] == 3:
        assert set(seen) == {None, "queue_full", "pool_pressure",
                             "rate_limited"}
    assert tctl.spill_free_frac(0.1) == jctl.spill_free_frac(0.1)


def test_pool_pressure_does_not_charge_the_bucket():
    clock = [0.0]
    ctl = AdmissionController(
        AdmissionConfig(max_queue=16, rate_tokens_per_s=1.0,
                        burst_tokens=20.0, shed_free_frac=0.5),
        now_fn=lambda: clock[0])
    req = Request(req_id=0, prompt=[1] * 10, max_new_tokens=10)  # cost 20
    for _ in range(5):
        assert ctl.check(req, queue_depth=1, free_frac=0.1) \
            == "pool_pressure"
    assert ctl.check(req, queue_depth=1, free_frac=1.0) is None
    assert ctl.check(req, queue_depth=1, free_frac=1.0) == "rate_limited"
    assert ctl.sheds == {"pool_pressure": 5, "rate_limited": 1}
    assert ctl.retry_after("default", 20) == pytest.approx(20.0)


# ---------------------------------------------------------------------------
# the engine's admission, against the JAX engine
# ---------------------------------------------------------------------------
def _admit_script(eng, Shed, clock, prompts, script):
    """``script``: per entry (seconds to advance, prompt index,
    max_new_tokens, tenant, steps to run after). Returns each add's id or
    ("shed", id, reason), every step's list and the results."""
    adds, steps = [], []
    for dt, i, new, tenant, n_steps in script:
        clock[0] += dt
        try:
            adds.append(eng.add_request(prompts[i], max_new_tokens=new,
                                        tenant=tenant))
        except Shed as e:
            adds.append(("shed", e.req_id, e.reason))
        for _ in range(n_steps):
            steps.append(eng.step())
    while eng.has_work():
        steps.append(eng.step())
    return adds, steps, dict(eng.results), dict(eng.finish_reasons)


@pytest.mark.parametrize("cfg", [
    dict(max_queue=2),
    dict(max_queue=8, rate_tokens_per_s=10.0, burst_tokens=30.0),
    dict(max_queue=8, shed_free_frac=0.5)])
def test_engine_sheds_equal_jax(model, cfg):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(2)
    prompts = [_prompt(rng, int(n)) for n in rng.integers(4, 9, size=6)]
    script = [(0.0, 0, 12, "a", 0), (0.0, 1, 8, "a", 0),
              (0.0, 2, 8, "b", 0), (0.0, 3, 6, "a", 1),
              (0.5, 4, 6, "a", 2), (3.0, 5, 6, "b", 0),
              (0.0, 0, 4, "a", 0)]
    res = []
    for E, A, C, S, params, c, kw in (
            (JaxEngine, JaxAdmissionConfig, JaxController, JaxShedError,
             jp, jcfg, {}),
            (LLMEngine, AdmissionConfig, AdmissionController, ShedError,
             tp, tcfg, dict(device="cpu"))):
        clock = [0.0]
        eng = E(params, c, num_blocks=4, **GEOMETRY,
                admission=C(A(**cfg), now_fn=lambda: clock[0]), **kw)
        res.append(_admit_script(eng, S, clock, prompts, script))
    assert res[1] == res[0]
    adds, _, results, reasons = res[1]
    sheds = [a for a in adds if isinstance(a, tuple)]
    assert sheds, "the script was meant to shed"
    for _, rid, _ in sheds:
        assert reasons[rid] == "shed" and rid not in results
    assert set(reasons) == set(range(len(script)))


def test_oversize_prompt_mints_no_id_and_queue_full_sheds(model):
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", max_slots=1, block_size=8,
                    max_model_len=64, prompt_buckets=[8],
                    admission=AdmissionConfig(max_queue=2))
    for n, new in ((60, 5), (8, 57)):               # past max_model_len
        with pytest.raises(ValueError):
            eng.add_request([1] * n, max_new_tokens=new)
    # a relay key is carried by the request (this engine has no relay
    # pool, so it prefills as usual) and is admitted like any other
    keep = [eng.add_request([1, 2, 3, 4], max_new_tokens=3,
                            relay_key=3 if i == 0 else None)
            for i in range(2)]
    assert eng.queue[0].relay_key == 3
    assert keep == [0, 1] and eng.finish_reasons == {}
    with pytest.raises(ShedError) as ei:
        eng.add_request([5, 6, 7], max_new_tokens=3)
    assert ei.value.reason == "queue_full" and ei.value.req_id == 2
    out = eng.run()
    assert eng.finish_reasons == {0: "finished", 1: "finished", 2: "shed"}
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert eng.admission.sheds == {"queue_full": 1}


def test_spill_threshold_follows_the_shed_threshold(model):
    _, _, tcfg, tp = model
    flag = float(get_flag("serve_kv_offload_spill_free_frac"))
    eng = LLMEngine(tp, tcfg, device="cpu", **GEOMETRY,
                    admission=AdmissionConfig(shed_free_frac=0.3))
    assert eng._spill_free_frac == max(flag, 0.6)
    eng = LLMEngine(tp, tcfg, device="cpu", **GEOMETRY,
                    admission=AdmissionConfig())
    assert eng._spill_free_frac == flag


# ---------------------------------------------------------------------------
# deadlines and cancellation on one fake clock
# ---------------------------------------------------------------------------
class _FakeTime:
    """The ``time`` module with a ``perf_counter`` that reads ``now``."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _lifecycle(eng, clock, script, n_prompts, seed):
    """Step ``eng`` through ``script`` (step index -> list of actions:
    ("add", prompt index, kwargs) or ("cancel", add index)), the clock a
    second ahead after every step. Returns the per-step lists, ledgers,
    finish reasons, results, ``cancel_noops`` and the ids."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(rng, int(n))
               for n in rng.integers(4, 14, size=n_prompts)]
    ids, steps, ledgers, idx = [], [], [], 0
    last = max(script)
    while idx <= last or eng.has_work():
        for act in script.get(idx, []):
            if act[0] == "add":
                ids.append(eng.add_request(prompts[act[1]], **act[2]))
            else:
                eng.cancel_request(ids[act[1]], *act[2:])
        steps.append(eng.step())
        ledgers.append(eng.block_accounting())
        if isinstance(eng, LLMEngine):
            assert_blocks_balanced(eng)
        clock.now += 1.0
        idx += 1
    return (steps, ledgers, dict(eng.finish_reasons), dict(eng.results),
            eng.cancel_noops, ids)


LONG = dict(max_new_tokens=24)
SCRIPTS = {
    # two slots busy; the third waits past its 2.5 s and expires queued
    "queued_deadline": {0: [("add", 0, LONG), ("add", 1, LONG),
                            ("add", 2, dict(max_new_tokens=4,
                                            deadline_s=2.5))]},
    # admitted at once, expires mid-decode with its partial tokens
    "in_slot_deadline": {0: [("add", 0, dict(max_new_tokens=24,
                                             deadline_s=4.5)),
                             ("add", 1, dict(max_new_tokens=10))]},
    # cancel the queued third request (a custom reason)
    "cancel_queued": {0: [("add", 0, LONG), ("add", 1, LONG),
                          ("add", 2, LONG)],
                      2: [("cancel", 2, "drained")]},
    # cancel request 0 while its chained call is unread in flight
    "cancel_in_slot_chained": {0: [("add", 0, LONG), ("add", 1, LONG)],
                               3: [("cancel", 0)]},
    # cancel a request that already finished: a counted no-op
    "cancel_finished": {0: [("add", 0, dict(max_new_tokens=2)),
                            ("add", 1, LONG)],
                        5: [("cancel", 0)], 6: [("cancel", 0)]},
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_deadlines_and_cancels_equal_jax(model, monkeypatch, name):
    jcfg, jp, tcfg, tp = model
    clock = _FakeTime()
    monkeypatch.setattr(jeng, "time", clock)
    monkeypatch.setattr(teng, "time", clock)
    script = SCRIPTS[name]
    res = []
    for E, params, c, kw in ((JaxEngine, jp, jcfg, {}),
                             (LLMEngine, tp, tcfg, dict(device="cpu"))):
        clock.now = 1000.0
        eng = E(params, c, decode_steps=2, **GEOMETRY, **kw)
        if name == "cancel_in_slot_chained" and E is LLMEngine:
            marks = []
            inner = eng.cancel_request

            def cancel(rid, *a, inner=inner, eng=eng):
                snap = eng._inflight["snapshot"] if eng._inflight else []
                marks.append(rid in [r for _s, r in snap])
                return inner(rid, *a)

            eng.cancel_request = cancel
        res.append(_lifecycle(eng, clock, script, 3, seed=11))
    assert res[1] == res[0]
    steps, ledgers, reasons, results, noops, ids = res[1]
    streamed = {}
    for step in steps:
        for rid, tok in step:
            streamed.setdefault(rid, []).append(tok)
    for rid in ids:
        assert streamed.get(rid, []) == results[rid]   # exactly once
    assert set(reasons) == set(ids)
    a = ledgers[-1]
    assert a["free"] == a["total"]
    if name == "queued_deadline":
        assert reasons[ids[2]] == "deadline_exceeded"
        assert results[ids[2]] == []
    elif name == "in_slot_deadline":
        assert reasons[ids[0]] == "deadline_exceeded"
        assert 0 < len(results[ids[0]]) < 24
    elif name == "cancel_queued":
        assert reasons[ids[2]] == "drained" and results[ids[2]] == []
    elif name == "cancel_in_slot_chained":
        assert marks == [True], "the cancel was meant to hit a chained call"
        assert reasons[ids[0]] == "client_disconnected"
        assert 0 < len(results[ids[0]]) < 24
        assert reasons[ids[1]] == "finished"
    else:
        assert reasons[ids[0]] == "finished" and noops == 2
