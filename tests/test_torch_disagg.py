"""The port's disaggregated prefill/decode serving (``LLMEngine(role=,
relay=)``, ``Request.relay_key``, the router's role-aware placement and
handoff resume) held to the JAX package's on the CPU, on the same tiny f32
model.

- a prefill + decode pair behind the router streams equal to one
  colocated engine and to the JAX pair (f32, and f32 with int8 K/V);
  every stream hands off once, the relay drains to zero, the handoff
  bytes are Σ ⌈nᵢ/bs⌉ blocks of every pool entry, and every decode-side
  admission counts ``outcome="restored"``;
- the relayed payload (and its int8 scales) restores bit-exact: the
  decode slot's pool blocks equal the prefill slot's;
- killing the decode replica, then the prefill replica, mid-flight still
  ends every stream equal to the colocated run;
- placement respects roles; a full relay degrades to a re-prefill with
  equal streams (``relay_full`` then ``missing``);
- ``Request(relay_key=...)`` is accepted; the constructor validates
  ``role``/``relay`` as the JAX engine does."""
import pytest
import torch

import paddle_tpu_torch.observability as tobs
from conftest import assert_blocks_balanced
from paddle_tpu.serving import ReplicaRouter as JaxRouter
from paddle_tpu.serving.kv_swap import HostKVPool as JaxHostKVPool
from paddle_tpu_torch.serving import HostKVPool, ReplicaRouter
from test_torch_router import (GEOMETRY, Gate, Hold, jengine, make_model,
                         prompts, tengine)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BS = GEOMETRY["block_size"]


@pytest.fixture(scope="module")
def model():
    return make_model()


@pytest.fixture
def obs_on():
    tobs.get_registry().reset()
    tobs.enable()
    try:
        yield tobs.fleet.get_aggregator()
    finally:
        tobs.disable()
        tobs.get_registry().reset()


def _pair(build, params, cfg, roles, pool_cls=HostKVPool, cls=ReplicaRouter,
          relay_bytes=1 << 30, gate=None, hold=False, **ekw):
    relay = pool_cls(relay_bytes, kind="relay")
    engines = [build(params, cfg, role=role, relay=relay, **ekw)
               for role in roles.values()]
    router = cls(engines, names=list(roles), step_hook=gate)
    if gate is not None:
        gate.router = router
    held = Hold(router) if hold else None
    router.start()
    return (router, relay, engines, held) if hold else \
        (router, relay, engines)


def _colocated(tp, tcfg, ps, max_new, **ekw):
    ref = tengine(tp, tcfg, **ekw)
    ids = [ref.add_request(list(p), max_new_tokens=max_new) for p in ps]
    out = ref.run()
    return [out[i] for i in ids]


@pytest.mark.parametrize("variant", ["f32", "f32_int8kv"])
def test_pair_equals_colocated_and_jax_pair(model, obs_on, variant):
    jcfg, jp, tcfg, tp = model
    ekw = {"kv_dtype": "int8"} if variant == "f32_int8kv" else {}
    ps = prompts(3, 4) + prompts(4, 1, size=19)
    want = _colocated(tp, tcfg, ps, 12, **ekw)
    roles = {"p0": "prefill", "d0": "decode"}
    outs = {}
    for name, cls, build, params, cfg, pool in (
            ("torch", ReplicaRouter, tengine, tp, tcfg, HostKVPool),
            ("jax", JaxRouter, jengine, jp, jcfg, JaxHostKVPool)):
        # submitted while held: the JAX router drops a first token the
        # prefill replica emits before its stream is registered
        router, relay, (p_eng, d_eng), hold = _pair(
            build, params, cfg, roles, pool_cls=pool, cls=cls, hold=True,
            **ekw)
        try:
            rids = hold.submit(router, ps, max_new_tokens=12)
            outs[name] = [router.wait(r, timeout=120) for r in rids]
            assert set(router.finish_reasons.values()) == {"finished"}
            assert router.handoff_resumes == len(ps)
            assert router.resumed_streams == 0
            assert p_eng.handoffs == len(ps) and d_eng.handoffs == 0
            assert len(relay) == 0
            if name == "torch":
                # each prompt's blocks, every pool entry, once
                per_block = sum(t[:, :1].numel() * t.element_size()
                                for t in p_eng.pools.values())
                assert p_eng.handoff_bytes == per_block * sum(
                    -(-len(p) // BS) for p in ps)
                assert set(p_eng.finish_reasons.values()) == {"handoff"}
                for eng in (p_eng, d_eng):
                    assert_blocks_balanced(eng)
        finally:
            router.stop()
    assert outs["torch"] == want
    assert outs["jax"] == want
    agg = obs_on
    n = len(ps)
    assert agg.fleet_counter_value("serving_disagg_handoffs_total",
                                   outcome="ok") == n
    assert agg.fleet_counter_value("serving_disagg_handoffs_total",
                                   outcome="restored") == n
    assert agg.fleet_counter_value("serving_disagg_handoffs_total",
                                   outcome="missing") == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_relayed_blocks_restore_bit_exact(model, kv_dtype):
    _, _, tcfg, tp = model
    relay = HostKVPool(1 << 30, kind="relay")
    pre = tengine(tp, tcfg, role="prefill", relay=relay, kv_dtype=kv_dtype)
    dec = tengine(tp, tcfg, role="decode", relay=relay, kv_dtype=kv_dtype)
    prompt = prompts(8, 1, size=21)[0]
    nb = -(-len(prompt) // BS)
    held = {}
    handoff = pre._handoff

    def spy(slot):
        # the prefill slot's blocks, read just before they are relayed
        blks = [int(b) for b in pre.table[slot, :nb]]
        held.update({n: t[:, blks].clone() for n, t in pre.pools.items()})
        handoff(slot)

    pre._handoff = spy
    erid = pre.add_request(list(prompt), max_new_tokens=6)
    first = [tok for _ in range(4) for _rid, tok in pre.step()]
    assert pre.finish_reasons[erid] == "handoff" and len(first) == 1
    ent = relay.get(erid)
    assert ent.n_tokens == len(prompt) and ent.n_blocks == nb
    assert sorted(ent.data) == sorted(held)
    for n, t in ent.data.items():
        assert torch.equal(t, held[n]), n
    rid = dec.add_request(list(prompt) + first, max_new_tokens=5,
                          relay_key=erid)
    dec.step()                       # the restore (no prefill) + decode
    assert len(relay) == 0 and dec.slot_req[0].req_id == rid
    blks = [int(b) for b in dec.table[0, :nb]]
    for n, t in dec.pools.items():
        # the relayed positions; the decode step has since appended the
        # first token's K/V after them
        got = t[:, blks].flatten(1, 2)[:, :len(prompt)]
        assert torch.equal(got, held[n].flatten(1, 2)[:, :len(prompt)]), n
    out = dec.run()[rid]
    want = _colocated(tp, tcfg, [prompt], 6, kv_dtype=kv_dtype)[0]
    assert first + out == want
    assert_blocks_balanced(dec)
    assert_blocks_balanced(pre)


@pytest.mark.parametrize("kill", ["decode", "prefill"])
def test_replica_kill_recovers_equal_to_colocated(model, kill):
    _, _, tcfg, tp = model
    ps = prompts(7, 6, size=20)
    want = _colocated(tp, tcfg, ps, 16)
    roles = {"p0": "prefill", "p1": "prefill", "d0": "decode",
             "d1": "decode"}
    if kill == "decode":
        gate = Gate(min_tokens=3, replicas={"d0", "d1"})
    else:
        # chunked prefill on the prefill replicas: one parks mid-prefill,
        # owning a stream it has not handed off yet
        gate = Gate(min_tokens=0, replicas={"p0", "p1"})
    router, relay, _ = _pair(tengine, tp, tcfg, roles, gate=gate,
                             prefill_chunk=8)
    try:
        rids = [router.submit(list(p), max_new_tokens=16) for p in ps]
        victim = gate.wait()
        router.kill_replica(victim)
        gate.release()
        outs = [router.wait(r, timeout=120) for r in rids]
        assert outs == want
        assert set(router.finish_reasons.values()) == {"finished"}
        assert router.failovers >= 1
        if kill == "decode":
            # failed-over streams re-prefill and hand off again
            assert router.handoff_resumes > len(ps)
        assert len(relay) == 0
    finally:
        gate.release()
        router.stop()


def test_placement_respects_roles(model, obs_on):
    _, _, tcfg, tp = model
    router, relay, (p_eng, d_eng) = _pair(
        tengine, tp, tcfg, {"p0": "prefill", "d0": "decode"})
    try:
        rids = [router.submit(list(p), max_new_tokens=8)
                for p in prompts(1, 3, size=5)]
        for rid in rids:
            router.wait(rid, timeout=120)
            assert router.finish_reasons[rid] == "finished"
        assert p_eng.handoffs == len(rids) and d_eng.handoffs == 0
        with router._lock:
            assert all(router._streams[r].replica == "d0" for r in rids)
        # the decode engine never prefilled: every admission a restore
        assert obs_on.fleet_counter_value(
            "serving_disagg_handoffs_total", outcome="restored") == 3
        assert len(relay) == 0
    finally:
        router.stop()


def test_relay_full_degrades_to_reprefill(model, obs_on):
    _, _, tcfg, tp = model
    ps = prompts(5, 3)
    want = _colocated(tp, tcfg, ps, 10)
    router, relay, (p_eng, d_eng) = _pair(
        tengine, tp, tcfg, {"p0": "prefill", "d0": "decode"},
        relay_bytes=1)
    try:
        outs = [router.wait(router.submit(list(p), max_new_tokens=10),
                            timeout=120) for p in ps]
    finally:
        router.stop()
    assert outs == want
    assert relay.refusals == len(ps) and len(relay) == 0
    agg = obs_on
    assert agg.fleet_counter_value("serving_disagg_handoffs_total",
                                   outcome="relay_full") == len(ps)
    assert agg.fleet_counter_value("serving_disagg_handoffs_total",
                                   outcome="missing") == len(ps)
    assert agg.fleet_counter_value("serving_disagg_handoffs_total",
                                   outcome="restored") == 0
    assert p_eng.handoffs == len(ps)


def test_relay_key_accepted_and_role_validation_as_jax(model):
    jcfg, jp, tcfg, tp = model
    # no relay on the engine: the key is carried and ignored
    eng = tengine(tp, tcfg)
    rid = eng.add_request([1, 2, 3], max_new_tokens=3, relay_key=7)
    assert eng.queue[-1].relay_key == 7
    assert len(eng.run()[rid]) == 3
    # a relay without the entry: a full prefill of the same context
    relay = HostKVPool(1 << 20, kind="relay")
    eng = tengine(tp, tcfg, role="decode", relay=relay)
    rid = eng.add_request([1, 2, 3], max_new_tokens=3, relay_key=7)
    assert eng.run()[rid] == _colocated(tp, tcfg, [[1, 2, 3]], 3)[0]
    for kw in (dict(role="both2"), dict(relay=HostKVPool(1)),
               dict(role="prefill")):
        with pytest.raises(ValueError) as got:
            tengine(tp, tcfg, **kw)
        if "relay" in kw:
            kw = dict(relay=JaxHostKVPool(1))
        with pytest.raises(ValueError) as ref:
            jengine(jp, jcfg, **kw)
        assert str(got.value) == str(ref.value)


def test_first_token_emitted_before_registration_reaches_the_stream(
        model, obs_on, monkeypatch):
    """A prefill replica emits a stream's first token in the step right
    after it acks the submit; when the submitting thread registers the
    stream only after that step (forced here: its wait returns late), the
    token is held for the stream, so the handoff still restores the
    relayed K/V (no ``missing``) and the stream equals the colocated
    one."""
    import time

    from paddle_tpu_torch.serving import router as trouter
    _, _, tcfg, tp = model
    ps = prompts(12, 3)
    want = _colocated(tp, tcfg, ps, 8)
    wait = trouter._Future.wait

    def late(fut, timeout):
        value = wait(fut, timeout)
        time.sleep(0.1)               # the replica steps meanwhile
        return value

    monkeypatch.setattr(trouter._Future, "wait", late)
    router, relay, (p_eng, _d) = _pair(tengine, tp, tcfg,
                                       {"p0": "prefill", "d0": "decode"})
    try:
        outs = [router.wait(router.submit(list(p), max_new_tokens=8),
                            timeout=120) for p in ps]
    finally:
        router.stop()
    assert outs == want and len(relay) == 0
    assert obs_on.fleet_counter_value("serving_disagg_handoffs_total",
                                      outcome="restored") == len(ps)
    assert obs_on.fleet_counter_value("serving_disagg_handoffs_total",
                                      outcome="missing") == 0
    assert not router.replicas["p0"].early
