"""The port's replica router (paddle_tpu_torch.serving.router) held to the
JAX package's on the CPU, on the same tiny f32 model.

- a replica killed mid-stream: every orphaned stream resumes on the
  survivor from ``prompt + delivered`` and equals an uninterrupted run
  of one engine and the JAX router's streams under the same kill (f32
  and f32 with int8 K/V);
- every minted id lands in exactly one terminal reason;
- placement: a shared block-aligned prefix sticks to the warm replica
  (affinity hit), disjoint prompts count a miss;
- the circuit breaker under an injected clock, ``check()`` driven by
  hand: a frozen heartbeat walks healthy -> suspect -> dead (one level a
  tick), the zombie's late tokens are deduped, a fresh pulse after the
  re-probe delay earns one half-open probe that closes the circuit; a
  killed replica walks the same way back through ``revive_replica``;
- drain steers new traffic away and leaves zero orphaned blocks;
  stragglers past the drain budget migrate through the resume path;
- cancelling a terminal id is a counted no-op, on the router and on the
  engine.

A replica is parked at a known point of a stream by a step hook
(:class:`Gate`) rather than raced with sleeps; no assertion reads a
wall-clock threshold. The model, the engine constructors, :class:`Gate` and
:class:`Hold` here serve the front-door and disaggregated tests too."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

import paddle_tpu_torch.observability as tobs
from conftest import assert_blocks_balanced
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ReplicaRouter as JaxRouter
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine, ReplicaRouter
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
GEOMETRY = dict(max_slots=2, block_size=8, max_model_len=64,
                prompt_buckets=[8, 48])


def make_model():
    """(jcfg, jparams, tcfg, tparams): one f32 tiny llama in both
    packages, the port's weights copied from the JAX package's."""
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def tengine(tp, tcfg, **kw):
    """A port engine on the CPU at the fleet tests' geometry."""
    return LLMEngine(tp, tcfg, device="cpu", **{**GEOMETRY, **kw})


def jengine(jp, jcfg, **kw):
    """The JAX package's engine at the same geometry."""
    return JaxEngine(jp, jcfg, **{**GEOMETRY, **kw})


def prompts(seed, n, size=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=size).tolist() for _ in range(n)]


class Gate:
    """A router ``step_hook`` (either package's router) that parks the
    step thread of the first replica found owning a live stream with at
    least ``min_tokens`` delivered tokens — stream ``rid`` only when
    given, replicas in ``replicas`` only when given — until
    :meth:`release`. A parked replica still takes its ops (submits and
    cancels land in its engine's queue, as between two steps) but steps
    nothing, so no caller waits on it. Assign ``router`` before starting
    it."""

    def __init__(self, min_tokens: int = 2, rid=None, replicas=None):
        self.router = None
        self.min_tokens = min_tokens
        self.rid = rid
        self.replicas = replicas
        self.victim = None
        self._parked = threading.Event()
        self._go = threading.Event()

    def __call__(self, name, _engine):
        router = self.router
        if router is None or self.victim is not None:
            return
        if self.replicas is not None and name not in self.replicas:
            return
        with router._lock:
            if self.victim is not None:
                return
            for rec in router._streams.values():
                if (self.rid is None or rec.rid == self.rid) \
                        and rec.replica == name \
                        and not rec.done.is_set() \
                        and len(rec.delivered) >= self.min_tokens:
                    self.victim = name
                    break
            else:
                return
        self._parked.set()
        rep = router.replicas[name]
        deadline = time.monotonic() + 120
        while not self._go.wait(0.001) and time.monotonic() < deadline:
            rep._run_ops()

    def wait(self, timeout: float = 120.0) -> str:
        """The parked replica's name, once one is parked."""
        assert self._parked.wait(timeout), "no replica reached the gate"
        return self.victim

    def release(self) -> None:
        self._go.set()


class Hold:
    """Wraps every replica's step (either package's router): while held,
    a replica takes its ops — submits are acked and registered — but
    steps nothing. Submitting under it keeps a replica from emitting a
    token before the submitter has registered the stream (the JAX
    router drops such a token)."""

    def __init__(self, router):
        self._held = threading.Event()
        for rep in router.replicas.values():
            step = rep.stepper.step

            def held(rep=rep, step=step):
                while self._held.is_set():
                    rep._run_ops()
                    time.sleep(0.001)
                return step()

            rep.stepper.step = held

    def submit(self, router, prompts, **kw):
        """Router ids of ``prompts``, all submitted while held."""
        self._held.set()
        try:
            return [router.submit(list(p), **kw) for p in prompts]
        finally:
            self._held.clear()


def wait_for(pred, timeout: float = 120.0) -> None:
    """Block until ``pred()`` holds (a condition, polled; the timeout
    only bounds a hang)."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.001)


@pytest.fixture(scope="module")
def model():
    return make_model()


def _router(engines, gate=None, cls=ReplicaRouter, **kw):
    r = cls(engines, names=[f"r{i}" for i in range(len(engines))],
            step_hook=gate, **kw)
    if gate is not None:
        gate.router = r
    return r.start()


def _owner(router, rid):
    with router._lock:
        return router._streams[rid].replica


def _drained_clean(eng):
    acct = eng.block_accounting()
    return (acct["free"] + acct["cached"] == acct["total"]
            and acct["backed"] == 0 and acct["squeezed"] == 0)


def _kill_mid_stream(router, gate, ps, max_new, hold=None):
    """Submit ``ps`` (under ``hold`` when given), kill the replica the
    gate parks, return every stream and the victim's name."""
    rids = (hold.submit(router, ps, max_new_tokens=max_new) if hold
            else [router.submit(list(p), max_new_tokens=max_new)
                  for p in ps])
    victim = gate.wait()
    router.kill_replica(victim)
    gate.release()
    return [router.wait(rid, timeout=120) for rid in rids], victim


# ---------------------------------------------------------------------------
# failover + exactly-once resume
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["f32", "f32_int8kv"])
def test_failover_resume_equals_uninterrupted_and_jax_router(model,
                                                             variant):
    jcfg, jp, tcfg, tp = model
    ekw = {"kv_dtype": "int8"} if variant == "f32_int8kv" else {}
    ps = prompts(3, 3)
    ref = tengine(tp, tcfg, **ekw)
    ref_ids = [ref.add_request(list(p), max_new_tokens=20) for p in ps]
    ref_out = ref.run()
    want = [ref_out[i] for i in ref_ids]

    outs = {}
    for name, cls, build, params, cfg in (
            ("torch", ReplicaRouter, tengine, tp, tcfg),
            ("jax", JaxRouter, jengine, jp, jcfg)):
        gate = Gate(min_tokens=2, rid=0)
        router = cls([build(params, cfg, **ekw) for _ in range(2)],
                     names=["r0", "r1"], step_hook=gate)
        gate.router = router
        hold = Hold(router)
        router.start()
        try:
            outs[name], victim = _kill_mid_stream(router, gate, ps, 20,
                                                  hold)
            assert router.failovers >= 1 and router.resumed_streams >= 1
            assert set(router.finish_reasons.values()) == {"finished"}
            survivor = [n for n in router.replicas if n != victim][0]
            assert_blocks_balanced(router.replicas[survivor].raw)
        finally:
            gate.release()
            router.stop()
    assert outs["torch"] == want
    assert outs["jax"] == want


def test_every_minted_id_exactly_one_terminal_reason(model):
    _, _, tcfg, tp = model
    gate = Gate(min_tokens=2, rid=0)
    router = _router([tengine(tp, tcfg) for _ in range(2)], gate)
    try:
        ps = prompts(5, 4, size=5)
        rids = [router.submit(list(p), max_new_tokens=12) for p in ps]
        victim = gate.wait()
        # a client cancel in flight, then the kill
        router.cancel(rids[3])
        router.kill_replica(victim)
        gate.release()
        for rid in rids:
            router.wait(rid, timeout=120)
        assert set(router.finish_reasons) == set(rids)
        assert set(router.finish_reasons.values()) <= {
            "finished", "shed", "deadline_exceeded",
            "client_disconnected", "drained"}
        assert all(router.finish_reasons[r] == "finished"
                   for r in rids[:3])
        assert len(router.results[rids[0]]) == 12
    finally:
        gate.release()
        router.stop()


# ---------------------------------------------------------------------------
# prefix-affinity placement
# ---------------------------------------------------------------------------
def test_affinity_hit_on_shared_prefix_miss_on_disjoint(model):
    _, _, tcfg, tp = model
    tobs.get_registry().reset()
    tobs.enable()
    router = _router([tengine(tp, tcfg) for _ in range(2)])
    try:
        rng = np.random.default_rng(11)
        # two full 8-token blocks of shared prefix: the affinity scorer
        # sees block-aligned keys only, as the radix cache does
        shared = rng.integers(1, 64, size=16).tolist()
        r1 = router.submit(shared + [7, 8], max_new_tokens=4)
        router.wait(r1, timeout=60)
        first = _owner(router, r1)
        misses0 = router.affinity_misses
        r2 = router.submit(shared + [9, 10, 11], max_new_tokens=4)
        router.wait(r2, timeout=60)
        assert _owner(router, r2) == first
        assert router.affinity_hits >= 1
        r3 = router.submit(rng.integers(1, 64, size=18).tolist(),
                           max_new_tokens=4)
        router.wait(r3, timeout=60)
        assert router.affinity_misses > misses0
        router.check()
        reg = tobs.get_registry()
        fam = reg.counter("serving_router_affinity_total")
        assert fam.labels(outcome="hit").value >= 1
        assert fam.labels(outcome="miss").value >= 1
        assert reg.gauge("serving_router_healthy_replicas").labels() \
            .value == 2
        text = tobs.render_prometheus()
        assert 'serving_router_dispatch_total{replica="r0"}' in text
        placed = tobs.fleet.get_placement_log().entries()
        assert {e["reason"] for e in placed} >= {"affinity",
                                                 "least_loaded"}
    finally:
        router.stop()
        tobs.disable()
        tobs.get_registry().reset()


# ---------------------------------------------------------------------------
# circuit breaker under an injected clock
# ---------------------------------------------------------------------------
def _tick(router, clock, dt):
    """Advance the injected clock, wait until every live unfrozen
    replica has stamped the new time, and run one health tick."""
    clock[0] += dt
    wait_for(lambda: all(rep.hb == clock[0] for rep in
                         router.replicas.values()
                         if rep.alive() and not rep.hb_frozen))
    return router.check()


def test_circuit_breaker_zombie_dedup_and_halfopen_probe(model):
    _, _, tcfg, tp = model
    clock = [0.0]
    ps = prompts(17, 1)
    ref = tengine(tp, tcfg)
    refid = ref.add_request(list(ps[0]), max_new_tokens=24)
    ref_out = ref.run()[refid]

    gate = Gate(min_tokens=2, rid=0)
    router = _router([tengine(tp, tcfg) for _ in range(2)], gate,
                     now_fn=lambda: clock[0], suspect_s=2.0, dead_s=6.0,
                     halfopen_s=3.0)
    try:
        rid = router.submit(list(ps[0]), max_new_tokens=24)
        stuck = gate.wait()
        rep = router.replicas[stuck]
        # a wedged step: the thread is parked and its pulse goes stale
        rep.hb_frozen = True
        # age demotes one level a tick, however far the clock jumped
        assert _tick(router, clock, 7.0)[stuck] == "suspect"
        assert _tick(router, clock, 0.0)[stuck] == "dead"
        # the orphan resumed on the survivor, parity intact
        assert router.wait(rid, timeout=120) == ref_out
        assert router.finish_reasons[rid] == "finished"
        assert router.failovers == 1
        # the zombie wakes and decodes its ghost copy: deduped, never
        # delivered twice
        gate.release()
        wait_for(lambda: not rep.raw.has_work())
        assert router.dedup_drops >= 1
        assert router.results[rid] == ref_out
        # recovery: a fresh pulse after the re-probe delay earns ONE
        # half-open probe; a finished probe closes the circuit
        rep.hb_frozen = False
        assert _tick(router, clock, 3.5)[stuck] == "half_open"
        other = [n for n in router.replicas if n != stuck][0]
        pr = router.submit([1, 2, 3, 4], max_new_tokens=3)
        assert _owner(router, pr) == stuck
        router.wait(pr, timeout=60)
        assert router.states() == {stuck: "healthy", other: "healthy"}
    finally:
        gate.release()
        router.stop()


def test_killed_replica_revives_through_halfopen(model):
    _, _, tcfg, tp = model
    clock = [0.0]
    gate = Gate(min_tokens=1, rid=0)
    router = _router([tengine(tp, tcfg) for _ in range(2)], gate,
                     now_fn=lambda: clock[0], suspect_s=2.0, dead_s=6.0,
                     halfopen_s=3.0)
    try:
        ps = prompts(19, 2)
        _outs, victim = _kill_mid_stream(router, gate, ps, 10)
        assert router.states()[victim] == "dead"
        router.revive_replica(victim)
        rep = router.replicas[victim]
        assert _drained_clean(rep.raw) or rep.raw.has_work()
        assert _tick(router, clock, 1.0)[victim] == "dead"
        assert _tick(router, clock, 3.0)[victim] == "half_open"
        pr = router.submit([5, 6, 7], max_new_tokens=3)
        assert _owner(router, pr) == victim
        router.wait(pr, timeout=60)
        assert router.states()[victim] == "healthy"
        assert router.finish_reasons[pr] == "finished"
        wait_for(lambda: not rep.raw.has_work())
        assert _drained_clean(rep.raw)
    finally:
        gate.release()
        router.stop()


# ---------------------------------------------------------------------------
# per-replica drain
# ---------------------------------------------------------------------------
def test_drain_steers_traffic_and_leaves_zero_orphaned_blocks(model):
    _, _, tcfg, tp = model
    gate = Gate(min_tokens=1, rid=0)
    router = _router([tengine(tp, tcfg) for _ in range(2)], gate)
    try:
        ps = prompts(29, 2)
        rid = router.submit(list(ps[0]), max_new_tokens=8)
        busy = gate.wait()
        router.begin_drain(busy)
        other = [n for n in router.replicas if n != busy][0]
        r2 = router.submit(list(ps[1]), max_new_tokens=4)
        assert _owner(router, r2) == other
        gate.release()
        router.wait(rid, timeout=60)
        router.wait(r2, timeout=60)
        assert router.finish_reasons[rid] == "finished"
        assert _owner(router, rid) == busy       # finished in place
        wait_for(lambda: router.check()[busy] == "drained")
        assert _drained_clean(router.replicas[busy].raw)
        assert router.drain_all(timeout=60)
        for rep in router.replicas.values():
            assert _drained_clean(rep.raw)
    finally:
        gate.release()
        router.stop()


def test_drain_stragglers_migrate_via_resume(model):
    _, _, tcfg, tp = model
    ps = prompts(31, 1)
    ref = tengine(tp, tcfg)
    refid = ref.add_request(list(ps[0]), max_new_tokens=24)
    ref_out = ref.run()[refid]
    # drain budget 0: a stream in flight at the first tick is a straggler
    gate = Gate(min_tokens=2, rid=0)
    router = _router([tengine(tp, tcfg) for _ in range(2)], gate,
                     drain_s=0.0)
    try:
        rid = router.submit(list(ps[0]), max_new_tokens=24)
        busy = gate.wait()
        router.begin_drain(busy)
        router.check()                 # queues the straggler's cut
        gate.release()
        assert router.wait(rid, timeout=120) == ref_out
        assert router.finish_reasons[rid] == "finished"
        assert router.resumed_streams == 1
        assert _owner(router, rid) != busy
        wait_for(lambda: router.check()[busy] == "drained")
        assert router.replicas[busy].raw.finish_reasons[
            min(router.replicas[busy].raw.finish_reasons)] == "drained"
        assert _drained_clean(router.replicas[busy].raw)
    finally:
        gate.release()
        router.stop()


# ---------------------------------------------------------------------------
# counted no-op cancels
# ---------------------------------------------------------------------------
def test_cancel_terminal_ids_are_counted_noops(model):
    _, _, tcfg, tp = model
    router = _router([tengine(tp, tcfg) for _ in range(2)])
    try:
        rid = router.submit([1, 2, 3], max_new_tokens=3)
        out = router.wait(rid, timeout=60)
        router.cancel(rid)                    # terminal: router no-op
        router.cancel(rid, reason="drained")
        assert router.finish_reasons[rid] == "finished"
        assert router.results[rid] == out
        # a cancel the router forwards after the engine finished (the
        # race) lands on the engine's counted no-op
        owner = router.replicas[_owner(router, rid)]
        erid = max(owner.raw.finish_reasons)
        owner.enqueue(("cancel", erid, "client_disconnected"))
        wait_for(lambda: owner.raw.cancel_noops == 1)
        assert owner.raw.finish_reasons[erid] == "finished"
    finally:
        router.stop()
    eng = tengine(tp, tcfg)
    rid = eng.add_request([1, 2, 3], max_new_tokens=3)
    eng.run()
    before = dict(eng.results)
    eng.cancel_request(rid)
    eng.cancel_request(rid, reason="drained")
    assert eng.cancel_noops == 2 and eng.results == before
    eng.cancel_request(999)                   # never minted
    live = eng.add_request([4, 5, 6], max_new_tokens=2)
    eng.run()
    assert eng.cancel_noops == 3
    assert eng.finish_reasons[live] == "finished"
    assert 999 not in eng.finish_reasons
    assert _drained_clean(eng)
