"""The port's fault injector (paddle_tpu_torch.distributed.resilience),
its engine under injected faults and its ``ResilientEngine``, held to the
JAX package's on the CPU.

- ``FaultInjector``: the same schedules, validation, one-shot firing and
  seeded ``random_schedule`` as the JAX injector; ``poison`` and
  ``poison_layer`` give the JAX results on the same numpy trees;
- each serving fault kind alone, then the mixed chaos of the JAX suite
  (crashes, squeezes, expired deadlines, sheds, swap): both engines under
  ``ResilientEngine`` emit the same list at every step and end with the
  same ``finish_reasons``, ``recoveries`` and block ledgers, the ledger
  balanced at every step;
- the crash budget re-raises; tokens committed before a crash are
  delivered once; an error that is not a ``SimulatedCrash`` propagates."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from conftest import assert_blocks_balanced
from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import AdmissionConfig as JaxAdmissionConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ResilientEngine as JaxResilient
from paddle_tpu.serving import ShedError as JaxShedError
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.framework.flags import get_flag
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import (AdmissionConfig, LLMEngine,
                                      ResilientEngine, ShedError)
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


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------
def test_serving_kinds_and_flags_match_jax():
    assert tfaults.SERVING_FAULT_KINDS == jfaults.SERVING_FAULT_KINDS
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert get_flag("ft_fault_schedule") == ""
    assert get_flag("ft_fault_seed") == 0


def _drive(inj):
    """Ask an injector the same questions in the same order; its answers
    and its audit log."""
    answers = [inj.pending]
    for step in range(12):
        answers.append(inj.fires("readback_fail", step))
        answers.append(inj.take_arg("nan_inject", step))
        answers.append(inj.fires("pool_squeeze", step))
        answers.append(inj.fires("readback_fail", step))   # one-shot
        if step % 3 == 0:
            answers.append(inj.take(step))
        answers.append(inj.storage_hook(step) is None)
    return answers, inj.fired, inj.pending


@pytest.mark.parametrize("schedule", [
    "readback_fail@2,pool_squeeze@2,nan_inject:1@4,crash@3",
    "readback_fail@5,readback_fail@5,storage_fail@6,nan_inject@9",
    [("slow_step", 1), ("offload_crash", 3), ("spec_verify_fail", 3)]])
def test_injector_answers_equal_jax(schedule):
    assert _drive(tfaults.FaultInjector(schedule)) \
        == _drive(jfaults.FaultInjector(schedule))


@pytest.mark.parametrize("bad", ["readback_fial@3", "crash:2@4",
                                 "nan_inject:x@1", "crash@x"])
def test_bad_schedules_raise_as_jax(bad):
    with pytest.raises(ValueError):
        jfaults.FaultInjector(bad)
    with pytest.raises(ValueError):
        tfaults.FaultInjector(bad)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_random_schedule_equals_jax(seed):
    kw = dict(seed=seed, n_steps=60,
              kinds=tfaults.SERVING_FAULT_KINDS, rate=0.3, min_step=2)
    assert tfaults.FaultInjector.random_schedule(**kw).pending \
        == jfaults.FaultInjector.random_schedule(**kw).pending


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((3, 4, 4)).astype(
                np.float32),
                "norm": rng.standard_normal((3, 4)).astype(np.float32),
                "ids": np.arange(3, dtype=np.int32)},
            "steps": [np.int32(5), rng.standard_normal(2).astype(
                np.float32)]}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch(v) for v in tree]
    return torch.as_tensor(np.asarray(tree))


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("kind", ["nan_grad", "inf_grad"])
def test_poison_and_poison_layer_equal_jax(kind):
    tree = _tree(1)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    _assert_trees_equal(
        _np(tfaults.FaultInjector.poison(_torch(tree), kind)),
        _np(jfaults.FaultInjector.poison(jtree, kind)))
    for layer in (0, 2):
        _assert_trees_equal(
            _np(tfaults.FaultInjector.poison_layer(_torch(tree), layer,
                                                   kind)),
            _np(jfaults.FaultInjector.poison_layer(jtree, layer, kind)))
    src = _torch(tree)
    tfaults.FaultInjector.poison_layer(src, 1, kind)
    _assert_trees_equal(_np(src), _np(tree))          # a copy, not in place
    for layer in (3, -1):
        with pytest.raises(ValueError):
            jfaults.FaultInjector.poison_layer(jtree, layer, kind)
        with pytest.raises(ValueError):
            tfaults.FaultInjector.poison_layer(_torch(tree), layer, kind)


# ---------------------------------------------------------------------------
# the engine under faults, against the JAX engine
# ---------------------------------------------------------------------------
def _chaos(E, R, S, F, params, cfg, schedule, submissions, engine_kw,
           per_step=2, check=None):
    """``submissions`` ((prompt, kwargs) pairs) added ``per_step`` a step
    to an engine with ``F(schedule)`` under ``R``; sheds are recorded by
    id. Returns every step's emitted list, the ledger after each step,
    the finish reasons, the recoveries, the results and the engine."""
    eng = E(params, cfg, injector=F(schedule), **engine_kw)
    reng = R(eng)
    pending = list(submissions)
    steps, ledgers = [], []
    while reng.has_work() or pending:
        for prompt, kw in pending[:per_step]:
            try:
                eng.add_request(prompt, **kw)
            except S:
                pass
        pending = pending[per_step:]
        steps.append(reng.step())
        ledgers.append(eng.block_accounting())
        if check is not None:
            check(eng)
    return (steps, ledgers, dict(eng.finish_reasons), reng.recoveries,
            dict(eng.results), eng)


def _both(model, schedule, submissions, engine_kw, self_draft=False,
          per_step=2):
    jcfg, jp, tcfg, tp = model
    jkw = dict(engine_kw)
    tkw = dict(engine_kw, device="cpu")
    if "admission" in engine_kw:
        jkw["admission"] = JaxAdmissionConfig(
            **dataclasses.asdict(engine_kw["admission"]))
    if self_draft:
        jkw.update(draft_params=jp, draft_config=jcfg)
        tkw.update(draft_params=tp, draft_config=tcfg)
    want = _chaos(JaxEngine, JaxResilient, JaxShedError,
                  jfaults.FaultInjector, jp, jcfg, schedule, submissions,
                  jkw, per_step)
    got = _chaos(LLMEngine, ResilientEngine, ShedError,
                 tfaults.FaultInjector, tp, tcfg, schedule, submissions,
                 tkw, per_step, check=assert_blocks_balanced)
    return want, got


def _submissions(seed, n, deadline_every=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, n + 1):
        kw = {"max_new_tokens": int(rng.integers(6, 16))}
        if deadline_every and i % deadline_every == 0:
            kw["deadline_s"] = 0.0
        out.append((rng.integers(1, 64, size=int(rng.integers(3, 14)))
                    .tolist(), kw))
    return out


# each serving fault kind alone: (schedule, engine arguments, self-draft)
ALONE = {
    "readback_fail": ("readback_fail@3", dict(decode_steps=2), False),
    "slow_step": ("slow_step@2", dict(decode_steps=2), False),
    "pool_squeeze": ("pool_squeeze@2", dict(num_blocks=8,
                                            kv_swap_bytes=1 << 20), False),
    "spec_verify_fail": ("spec_verify_fail@3", dict(spec_tokens=3), True),
    "offload_crash": ("offload_crash@4",
                      dict(num_blocks=5, kv_swap_bytes=1 << 20,
                           kv_offload="async", decode_steps=2), False),
}


@pytest.mark.parametrize("kind", tfaults.SERVING_FAULT_KINDS)
def test_each_serving_fault_alone_equals_jax(model, kind):
    schedule, kw, self_draft = ALONE[kind]
    want, got = _both(model, schedule, _submissions(6, 4),
                      dict(GEOMETRY, **kw), self_draft=self_draft)
    steps, ledgers, reasons, recoveries, results, eng = got
    assert steps == want[0]
    assert ledgers == want[1]
    assert reasons == want[2] and recoveries == want[3]
    assert results == want[4]
    assert eng.injector.fired == [(kind, int(schedule.split("@")[1]))]
    crashes = kind in ("readback_fail", "spec_verify_fail", "offload_crash")
    assert recoveries == (1 if crashes else 0)
    if kind == "pool_squeeze":
        assert any(a["squeezed"] for a in ledgers)
    streamed = {}
    for step in steps:
        for rid, tok in step:
            streamed.setdefault(rid, []).append(tok)
    assert streamed == results                         # exactly once
    assert set(reasons.values()) == {"finished"}
    a = ledgers[-1]
    assert a["free"] == a["total"] and a["in_flight"] == 0


def test_mixed_chaos_equals_jax(model):
    """The JAX suite's acceptance mix (tests/test_serving_resilience.py's
    mixed chaos): crashes + squeezes + expired deadlines + sheds + swap;
    every request in exactly one terminal state."""
    schedule = ("readback_fail@4,pool_squeeze@3,slow_step@2,"
                "readback_fail@9,pool_squeeze@8")
    kw = dict(GEOMETRY, num_blocks=5, kv_swap_bytes=1 << 20,
              admission=AdmissionConfig(max_queue=3))
    want, got = _both(model, schedule, _submissions(9, 10, 4), kw)
    steps, ledgers, reasons, recoveries, results, eng = got
    assert (steps, ledgers, reasons, recoveries, results) == want[:5]
    assert len(reasons) == 10 == eng._next_id
    assert set(reasons.values()) == {"finished", "shed",
                                     "deadline_exceeded"}
    assert recoveries == 2 and eng.admission.sheds["queue_full"] >= 1
    assert len(eng.free_blocks) == eng.nb - 1
    assert eng.swap_pool.bytes_used == 0


def test_crash_budget_reraises(model):
    _, _, tcfg, tp = model
    inj = tfaults.FaultInjector(",".join(f"readback_fail@{s}"
                                         for s in range(1, 8)))
    eng = LLMEngine(tp, tcfg, device="cpu", injector=inj,
                    **dict(GEOMETRY, max_slots=1, prompt_buckets=[8]))
    eng.add_request([3, 4, 5, 6, 7, 8], max_new_tokens=4)
    reng = ResilientEngine(eng, max_recoveries=2)
    with pytest.raises(tfaults.SimulatedCrash):
        while reng.has_work():
            reng.step()
    assert reng.recoveries == 3               # 2 recovered + the re-raise


def test_salvaged_tokens_are_delivered_once(model):
    """A step that raises AFTER a readback in it committed tokens: the
    recovery returns exactly those tokens, and re-admission never emits
    them again."""
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", decode_steps=2, **GEOMETRY)
    ids = [eng.add_request(p, max_new_tokens=8)
           for p, _ in _submissions(10, 2)]
    reng = ResilientEngine(eng)
    streamed = {rid: [] for rid in ids}
    inner = eng._process
    armed = [False]

    def crash_after_commit(rec):
        out = inner(rec)
        if armed[0]:
            raise tfaults.SimulatedCrash("post-commit crash")
        return out

    eng._process = crash_after_commit
    for rid, tok in reng.step():              # warm: a call in flight
        streamed[rid].append(tok)
    armed[0] = True
    salvaged = reng.step()
    armed[0] = False
    assert reng.recoveries == 1 and salvaged
    for rid, tok in salvaged:
        streamed[rid].append(tok)
    while reng.has_work():
        for rid, tok in reng.step():
            streamed[rid].append(tok)
    for rid in ids:
        assert streamed[rid] == reng.results[rid]
        assert len(reng.results[rid]) == 8
    assert_blocks_balanced(eng)


def test_other_errors_are_not_recovered(model):
    """Only SimulatedCrash counts as a crashed step by default: any other
    error (a CUDA fault, a failed launch) propagates untouched."""
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", **GEOMETRY)
    eng.add_request([1, 2, 3], max_new_tokens=4)
    reng = ResilientEngine(eng)
    assert reng.recoverable == (tfaults.SimulatedCrash,)

    def device_fault(rec):
        raise RuntimeError("CUDA error: an illegal memory access")

    eng._process = device_fault
    with pytest.raises(RuntimeError, match="illegal memory access"):
        while reng.has_work():
            reng.step()
    assert reng.recoveries == 0
