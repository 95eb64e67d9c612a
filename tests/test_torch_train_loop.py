"""The port's ResilientTrainLoop (paddle_tpu_torch.distributed.resilience
.train_loop) held to the JAX package's on the CPU, around the tiny llama's
train step on the same numpy-made weights and batches (the reference's
tests/test_resilience.py and test_obs_efficiency.py loop cases).

- each fault schedule gives the reference's event list (kind, step,
  reason, retry, first_bad), accepted losses within 2e-5 relative and
  the same loader position: NaN/Inf gradients, a persistent bad batch,
  a loss spike, a crash with a corrupt newest checkpoint, a storage
  failure, SIGTERM and watchdog emergency saves, a targeted nan_inject
  whose provenance names the layer;
- the per-step key contract: ``fold_in`` equals ``jax.random.fold_in``,
  a retry and a resumed replay of a step get the same key, two steps
  different ones;
- the loop's telemetry: train_mfu from the host FLOP count, tokens/s,
  goodput, the crash and SIGTERM post-mortems;
- the functional-step contract the rollback relies on."""
import dataclasses
import functools
import glob
import json
import os
import signal

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.distributed import resilience as jres
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.distributed.resilience import atomic_ckpt as tac
from paddle_tpu_torch.distributed.resilience import train_loop as tloop
from paddle_tpu_torch.framework.flags import set_flags as tset_flags
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import moe as tmoe
from paddle_tpu_torch.observability import perf as tperf
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=16,
             ffn=64)
LR = 1e-3


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    js = jl.init_train_state(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js.params), device="cpu")
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, 64, (2, 16)).astype(np.int32)
               for _ in range(40)]
    jstep = jax.jit(lambda s, t: jl.train_step(s, t, jcfg, lr=LR))
    tstep = functools.partial(tl.train_step, config=tcfg, lr=LR)
    return dict(jcfg=jcfg, tcfg=tcfg, js=js, tparams=tparams,
                jbatches=[jnp.asarray(b) for b in batches],
                tbatches=[torch.from_numpy(b) for b in batches],
                jstep=jstep, tstep=tstep)


def _tstate(m):
    """A fresh port TrainState over the shared weights (adamw moments)."""
    from paddle_tpu_torch.optimizer.functional import init_moments

    flat, structure = tac.flatten(m["tparams"])
    p = tac.unflatten(structure, [t.clone() for t in flat])
    mu, nu = init_moments(p)
    return tl.TrainState(p, mu, nu, torch.zeros((), dtype=torch.int32))


def _loops(m, schedule=None, wrap=None, jstep=None, **kw):
    """(reference loop, port loop) over the same state, batches and fault
    schedule (a fresh injector each)."""
    out = []
    for pkg, step, state, batches in (
            (jres, jstep or m["jstep"], m["js"], m["jbatches"]),
            (tres, m["tstep"], _tstate(m), m["tbatches"])):
        if wrap is not None:
            step = wrap(step)
        inj = None if schedule is None else pkg.FaultInjector(schedule)
        data = pkg.ResumableIterator(lambda e, b=batches: iter(b))
        kw2 = dict(kw)
        if "ckpt_dir" in kw2:
            kw2["ckpt_dir"] = os.path.join(kw2["ckpt_dir"], pkg.__name__)
        out.append(pkg.ResilientTrainLoop(step, state, data, injector=inj,
                                          **kw2))
    return out


_KEYS = ("kind", "step", "reason", "retry", "first_bad", "tag", "fault",
         "layer")


def _events(loop):
    return [{k: e[k] for k in _KEYS if k in e} for e in loop.events]


def _assert_same(jl_, tl_):
    assert _events(tl_) == _events(jl_)
    np.testing.assert_allclose(tl_._loss_window, jl_._loss_window,
                               rtol=2e-5)
    assert tl_.data.state_dict() == jl_.data.state_dict()
    assert (tl_.step, tl_.total_retries, tl_.skipped_batches) \
        == (jl_.step, jl_.total_retries, jl_.skipped_batches)


def _params_close(tstate, jstate, steps):
    """Parameters of the two packages after ``steps`` committed steps: an
    element whose f32 gradient is noise around 0 (|g| near AdamW's eps)
    may move by up to 2 x lr a step in either framework
    (tests/test_torch_train.py), so elements are held to that."""
    for a, b in zip(tac.flatten(tstate.params)[0],
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * LR * steps)


@pytest.mark.parametrize("schedule,steps,kw", [
    ("nan_grad@5", 12, {}),
    ("inf_grad@3,nan_grad@7", 10, {}),
    ([("nan_grad", 3)] * 5, 6, dict(max_retries_per_batch=2,
                                    spike_factor=1e9)),
    ([("nan_grad", 2)] * 4, 5, dict(max_retries_per_batch=1,
                                    max_total_retries=2,
                                    spike_factor=1e9)),
], ids=["nan_grad", "inf_then_nan", "persistent_skip", "budget"])
def test_fault_schedules_equal_reference(model, schedule, steps, kw):
    jloop, tloop_ = _loops(model, schedule, **kw)
    js, ts = jloop.run(steps), tloop_.run(steps)
    _assert_same(jloop, tloop_)
    _params_close(ts, js, tloop_.step)


def test_loss_spike_rolls_back_as_reference(model):
    def spiking(step):
        calls = {"n": 0}

        def fn(state, batch):
            calls["n"] += 1
            new_state, loss = step(state, batch)
            if calls["n"] == 9:             # transient spike, one attempt
                return new_state, loss + 1e6
            return new_state, loss
        return fn

    jloop, tloop_ = _loops(model, wrap=spiking, warmup=3)
    jloop.run(10)
    tloop_.run(10)
    _assert_same(jloop, tloop_)
    assert any(e["kind"] == "rollback" and e["reason"] == "loss_spike"
               for e in tloop_.events)


def test_crash_corrupt_newest_auto_resume_equals_reference(model, tmp_path):
    """The acceptance scenario of the reference: NaN grad at step 5, crash
    at step 9, the newest checkpoint corrupted; the relaunched loops
    resume from step 6 and end where uninterrupted runs end."""
    total = 14
    clean_j, clean_t = _loops(model)
    cj, ct = clean_j.run(total), clean_t.run(total)
    crashed = _loops(model, "nan_grad@5,crash@9", ckpt_dir=str(tmp_path),
                     ckpt_every=2)
    for loop in crashed:
        with pytest.raises(Exception) as exc:
            loop.run(total)
        assert type(exc.value).__name__ == "SimulatedCrash"
        newest = loop.ckpt_dir and sorted(
            os.listdir(loop.ckpt_dir))[-1]
        with open(os.path.join(loop.ckpt_dir, newest, "a00000.bin"),
                  "r+b") as f:
            f.write(b"garbage!")
    assert _events(crashed[1]) == _events(crashed[0])
    resumed = _loops(model, ckpt_dir=str(tmp_path), ckpt_every=2)
    rj, rt = resumed[0].run(total), resumed[1].run(total)
    assert resumed[1].resumed_from == resumed[0].resumed_from == 6
    _assert_same(*resumed)
    assert resumed[1].data.state_dict() == {"epoch": 0, "index": total}
    _params_close(rt, rj, total)
    # bit-exact against the port's own uninterrupted run
    for a, b in zip(tac.flatten(rt)[0], tac.flatten(ct)[0]):
        assert torch.equal(a, b)
    _params_close(ct, cj, total)


def test_storage_failure_keeps_previous_checkpoint(model, tmp_path):
    loops = _loops(model, "storage_fail@4", ckpt_dir=str(tmp_path),
                   ckpt_every=2)
    for loop in loops:
        loop.run(6)
    _assert_same(*loops)
    steps = [[s for s, _ in pkg.list_checkpoints(loop.ckpt_dir)]
             for pkg, loop in zip((jres.atomic_ckpt, tac), loops)]
    assert steps[0] == steps[1] == [2, 6]
    assert any(e["kind"] == "checkpoint_failed" for e in loops[1].events)


def test_sigterm_triggers_emergency_save_and_resume(model, tmp_path):
    def preempting(batches):
        def src(epoch):
            for i, b in enumerate(batches):
                if epoch == 0 and i == 5:   # preemption notice mid-epoch
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b
        return src

    got = []
    for pkg, step, state, batches in (
            (jres, model["jstep"], model["js"], model["jbatches"]),
            (tres, model["tstep"], _tstate(model), model["tbatches"])):
        d = str(tmp_path / pkg.__name__)
        loop = pkg.ResilientTrainLoop(
            step, state, pkg.ResumableIterator(preempting(batches)),
            ckpt_dir=d)
        loop.run(20)
        assert loop.step < 20
        manifest = pkg.validate_checkpoint(pkg.list_checkpoints(d)[-1][1])
        assert manifest["meta"]["tag"] == "emergency-sigterm"
        resumed = pkg.ResilientTrainLoop(
            step, state, pkg.ResumableIterator(lambda e, b=batches: iter(b)),
            ckpt_dir=d)
        resumed.run(20)
        got.append((_events(loop), manifest["meta"]["loader"],
                    _events(resumed), resumed.data.state_dict()))
    assert got[1] == got[0]


def test_watchdog_timeout_fires_emergency_checkpoint(model, tmp_path):
    from paddle_tpu_torch.distributed.watchdog import CommWatchdog

    wd = CommWatchdog(timeout=0.15, mode="log", poll=0.03)
    try:
        loop = tres.ResilientTrainLoop(
            model["tstep"], _tstate(model), model["tbatches"],
            ckpt_dir=str(tmp_path), watchdog=wd, hang_seconds=0.6,
            injector=tres.FaultInjector("collective_timeout@2"))
        loop.run(4)
    finally:
        wd.stop()
    assert any(e["kind"] == "watchdog_emergency" for e in loop.events)
    assert any(e["kind"] == "checkpoint_saved"
               and e.get("tag") == "emergency-watchdog"
               for e in loop.events)
    assert wd._fired


@pytest.fixture
def numerics_on():
    for pkg in (jobs, tobs):
        pkg.get_registry().reset()
        pkg.flight_recorder.get_recorder().clear()
        pkg.numerics.clear()
        pkg.enable()
        pkg.numerics.enable()
    try:
        yield
    finally:
        for pkg in (jobs, tobs):
            pkg.numerics.disable()
            pkg.numerics.clear()
            pkg.disable()
            pkg.get_registry().reset()


def test_nan_inject_provenance_names_the_layer_as_reference(model,
                                                            numerics_on):
    # the reference reads its numerics gate when jax traces: a step jitted
    # after the switch carries the ladder
    jcfg = model["jcfg"]
    jstep = jax.jit(lambda s, t: jl.train_step(s, t, jcfg, lr=LR))
    loops = _loops(model, "nan_inject:1@2,nan_grad@4", jstep=jstep)
    for loop in loops:
        loop.run(6)
    _assert_same(*loops)
    rb = [e for e in loops[1].events if e["kind"] == "rollback"]
    assert rb[0]["first_bad"] == "llama.layer:1"
    assert "first_bad" not in rb[1]       # an untargeted NaN names nobody
    for pkg in (jobs, tobs):
        assert pkg.numerics.payload()["provenance"] == "llama.layer:1"
        assert any(e["kind"] == "rollback"
                   and e.get("first_bad") == "llama.layer:1"
                   for e in pkg.flight_recorder.get_recorder().events())


# ---------------------------------------------------------------------------
# per-step keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_prng_key_and_fold_in_equal_jax(seed):
    base = jax.random.PRNGKey(seed) if seed < 2**32 else None
    key = tloop.prng_key(seed)
    if base is not None:
        assert key.tolist() == np.asarray(base).tolist()
    for step in (0, 1, 5, 1000, 2**31 + 1):
        want = np.asarray(jax.random.fold_in(jnp.asarray(
            key.numpy()), step)).tolist()
        assert tloop.fold_in(key, step).tolist() == want


def test_retry_and_resumed_replay_get_the_same_key(model, tmp_path):
    seen = []

    def step(state, batch, key):
        seen.append(tuple(key.tolist()))
        return model["tstep"](state, batch)

    d = str(tmp_path)
    base = tloop.prng_key(11)
    loop = tres.ResilientTrainLoop(
        step, _tstate(model), model["tbatches"], ckpt_dir=d, ckpt_every=2,
        rng_key=base, injector=tres.FaultInjector("nan_grad@1,crash@3"))
    with pytest.raises(tres.SimulatedCrash):
        loop.run(5)
    first = list(seen)
    # attempts: step 0, step 1 (poisoned), step 1 retry, step 2
    assert first[1] == first[2] and len(set(first)) == 3
    seen.clear()
    resumed = tres.ResilientTrainLoop(step, _tstate(model),
                                      model["tbatches"], ckpt_dir=d,
                                      rng_key=tloop.prng_key(99))
    resumed.run(5)
    assert resumed.resumed_from == 2
    assert torch.equal(resumed.rng_key, base)    # the key is checkpointed
    assert seen[0] == tuple(tloop.fold_in(base, 2).tolist())
    assert seen[0] == first[3]                   # the replay of step 2
    assert len(set(first + seen)) == 5
    g1, g2 = (tloop.generator_for(tloop.fold_in(base, 2)) for _ in range(2))
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4,
                                                               generator=g2))
    path = tac.list_checkpoints(d)[-1][1]
    manifest = tac.validate_checkpoint(path)
    assert manifest["treedef"].startswith("PyTreeDef({'rng': *, 'state':")


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
@pytest.fixture
def obs_on():
    from paddle_tpu_torch.observability import flight_recorder, goodput

    tobs.get_registry().reset()
    goodput.get_tracker().reset()
    flight_recorder.get_recorder().clear()
    tobs.enable()
    try:
        yield
    finally:
        tobs.disable()
        tset_flags({"obs_postmortem_dir": ""})
        tobs.get_registry().reset()
        goodput.get_tracker().reset()
        flight_recorder.get_recorder().clear()


def test_train_mfu_counts_known_steps_on_the_host(model, obs_on):
    cfg = model["tcfg"]
    loop = tres.ResilientTrainLoop(model["tstep"], _tstate(model),
                                   model["tbatches"])
    loop.run(2)
    want = tl.flops_per_token(cfg, 15) * 2 * 15
    assert loop._flops == want
    reg = tobs.get_registry()
    assert reg.gauge("train_mfu").labels().value > 0
    assert loop.tokens_per_batch == 32
    assert reg.gauge("train_tokens_per_second").labels().value > 0
    mcfg = tmoe.tiny_moe()
    batch = torch.zeros((4, 33), dtype=torch.int32)
    assert tperf.train_step_flops(
        functools.partial(tmoe.train_step, config=mcfg, lr=LR), batch) \
        == tmoe.flops_per_token(mcfg, 32) * 4 * 32


def test_unknown_step_sets_no_mfu_unless_given_flops(obs_on):
    def step_fn(state, batch):
        w = state["w"] - 0.001 * batch["ids"].sum()
        return {"w": w}, torch.abs(w).sum()

    batches = [{"ids": torch.full((2, 8), i + 1, dtype=torch.int32)}
               for i in range(4)]
    reg = tobs.get_registry()
    loop = tres.ResilientTrainLoop(step_fn, {"w": torch.ones(())}, batches)
    loop.run(4)
    assert loop._flops is None
    assert reg.gauge("train_mfu").labels().value == 0
    assert loop.tokens_per_batch == 16
    assert reg.gauge("train_tokens_per_second").labels().value > 0
    loop = tres.ResilientTrainLoop(step_fn, {"w": torch.ones(())}, batches,
                                   flops_per_step=1e6)
    loop.run(4)
    assert reg.gauge("train_mfu").labels().value > 0
    rep = tobs.goodput.get_tracker().report()
    assert rep["seconds"]["productive_step"] > 0


def _toy_loop(tmp_path, injector, n=16):
    def step_fn(state, batch):
        w = state["w"] - 0.1 * batch.mean()
        return {"w": w}, torch.abs(w).sum()

    batches = [torch.full((2,), 0.1 * (i + 1)) for i in range(n)]
    return tres.ResilientTrainLoop(
        step_fn, {"w": torch.ones((2,))}, batches,
        ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=3, rng_key=None,
        injector=injector)


def test_chaos_crash_writes_postmortem_and_goodput(tmp_path, obs_on):
    tset_flags({"obs_postmortem_dir": str(tmp_path / "pm")})
    loop = _toy_loop(tmp_path, tres.FaultInjector("nan_grad@2, crash@5"))
    with pytest.raises(tres.SimulatedCrash):
        loop.run(16)
    dumps = glob.glob(str(tmp_path / "pm" / "postmortem-*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["trigger"] == "exception"
    assert doc["error"]["type"] == "SimulatedCrash"
    kinds = [e["kind"] for e in doc["events"]]
    assert "rollback" in kinds and "exception" in kinds
    assert "step" in kinds and "checkpoint" in kinds
    gp = doc["goodput"]
    assert abs(sum(gp["fractions"].values()) - 1.0) < 0.01
    assert gp["seconds"]["rollback_retry"] > 0
    assert gp["seconds"]["checkpoint_save"] > 0
    assert gp["goodput_ratio"] > 0
    reg = tobs.get_registry()
    assert reg.counter("train_rollbacks_total").labels(
        reason="non_finite_loss").value == 1
    assert reg.counter("train_checkpoints_total").labels(
        tag="periodic").value == 1
    assert reg.histogram("train_checkpoint_save_seconds").labels().count \
        == 1


def test_sigterm_path_dumps_postmortem_and_counts_emergency(tmp_path,
                                                            obs_on):
    tset_flags({"obs_postmortem_dir": str(tmp_path / "pm")})
    loop = _toy_loop(tmp_path, None, n=8)
    done = []

    def on_event(ev):
        if ev["kind"] == "checkpoint_saved" and not done:
            done.append(1)
            loop._sigterm = True        # what the signal handler sets
    loop.on_event = on_event
    loop.run(8)
    dumps = glob.glob(str(tmp_path / "pm" / "postmortem-*.json"))
    assert dumps and json.load(open(dumps[0]))["trigger"] == "sigterm"
    reg = tobs.get_registry()
    assert reg.counter("train_emergency_saves_total").labels().value == 1
    resumed = _toy_loop(tmp_path, None, n=8)
    resumed.run(8)
    assert reg.histogram("train_checkpoint_load_seconds").labels().count \
        == 1


# ---------------------------------------------------------------------------
# the functional-step contract
# ---------------------------------------------------------------------------
def test_train_steps_leave_their_input_state_as_it_was(model):
    """Rollback keeps the last accepted state by reference: the llama and
    MoE steps return new tensors and leave their input untouched."""
    st = _tstate(model)
    before = [t.clone() for t in tac.flatten(st)[0]]
    model["tstep"](st, model["tbatches"][0])
    assert all(torch.equal(a, b) for a, b in zip(tac.flatten(st)[0],
                                                 before))
    mcfg = tmoe.tiny_moe(vocab=64, hidden=32, layers=1, heads=2,
                         experts=4)
    ms = tmoe.init_train_state(mcfg, 0, device="cpu")
    before = [t.clone() for t in tac.flatten(ms)[0]]
    tmoe.train_step(ms, torch.randint(0, 64, (2, 9)), mcfg, lr=LR)
    assert all(torch.equal(a, b) for a, b in zip(tac.flatten(ms)[0],
                                                 before))


def test_an_in_place_step_breaks_rollback():
    """Why the loop takes functional steps only: a step that updates its
    input in place (as the layer-wise and streaming steps do) has already
    changed the state a rollback returns to, so a retried NaN ends away
    from the clean run."""
    def inplace(state, batch):
        state["w"].sub_(0.1 * batch.mean())
        return state, torch.abs(state["w"]).sum()

    def functional(state, batch):
        w = state["w"] - 0.1 * batch.mean()
        return {"w": w}, torch.abs(w).sum()

    batches = [torch.full((2,), 0.1 * (i + 1)) for i in range(6)]
    finals = {}
    for name, fn in (("inplace", inplace), ("functional", functional)):
        for sched in ("", "nan_grad@2"):
            loop = tres.ResilientTrainLoop(
                fn, {"w": torch.ones(2)}, list(batches),
                injector=tres.FaultInjector(sched))
            finals[name, sched] = loop.run(4)["w"].clone()
    assert torch.equal(finals["functional", ""],
                       finals["functional", "nan_grad@2"])
    assert not torch.equal(finals["inplace", ""],
                           finals["inplace", "nan_grad@2"])
