"""The port's swap and offload tiers (paddle_tpu_torch.serving.kv_swap,
serving.offload, ``LLMEngine(kv_swap_bytes=..., kv_offload=...)``) and
its flag registry (paddle_tpu_torch.framework.flags) on the CPU:

- HostKVPool: the incremental ``swapped_blocks`` count against a walk of
  the entries, the reservation protocol, counted refusals when full;
- a pool squeezed into preempt-swap: async and sync streams are equal to
  each other and to the JAX engine's (f32 and int8 pools; bf16 async
  against sync), the ledger ``free + backed + cached + squeezed +
  in_flight == total`` balances at every step with blocks riding an
  unlanded spill, and drains to all-free with no reservation left;
- ``FLAGS_serve_kv_offload_sync`` and ``kv_offload``; prefetch hits
  against inline stalls; ``force_land`` of a spill still in flight;
  proactive spills that land host-clean so a reclaim frees them with no
  inline copy."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu_torch.framework.flags import get_flag, get_flags, set_flags
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving.kv_swap import HostKVPool
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
SQUEEZED = dict(max_slots=2, block_size=8, max_model_len=64, num_blocks=5,
                prompt_buckets=[8], kv_swap_bytes=1 << 20)
FLAGS = ["serve_kv_offload_sync", "serve_kv_offload_prefetch_depth",
         "serve_kv_offload_staging_bytes", "serve_kv_offload_spill_free_frac",
         "serve_kv_offload_spill_batch"]


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture
def flags_guard():
    """Snapshot/restore the serve_kv_offload_* flags a test flips."""
    saved = {n: get_flag(n) for n in FLAGS}
    yield
    set_flags(saved)


def _prompt(rng, n):
    return rng.integers(1, 64, size=n).tolist()


def _balanced(eng):
    """The 5-term ledger, no block id counted twice (custody blocks
    included), and the swap tier's incremental count against a walk."""
    a = eng.block_accounting()
    assert a["free"] + a["backed"] + a["cached"] + a["squeezed"] \
        + a["in_flight"] == a["total"], a
    used = [int(eng.table[i, j]) for i in range(eng.N)
            for j in range(int(eng.n_alloc[i]))]
    held = ([b for t in eng.offload._spills.values() for b in t.blocks]
            if eng.offload is not None else [])
    ids = list(eng.free_blocks) + used + held
    assert len(ids) == len(set(ids)), "duplicate block ids"
    assert 0 not in ids, "trash block leaked into the allocator"
    if eng.swap_pool is not None:
        assert eng.swap_pool.swapped_blocks == sum(
            e.n_blocks for e in eng.swap_pool._entries.values())
    return a


# ---------------------------------------------------------------------------
# HostKVPool
# ---------------------------------------------------------------------------
def _entry(nbytes, n_blocks=1):
    return {"k": torch.zeros((1, n_blocks, max(1, nbytes // n_blocks)),
                             dtype=torch.int8)}


def test_swapped_blocks_incremental_matches_walk():
    pool = HostKVPool(1 << 20)

    def check():
        assert pool.swapped_blocks == sum(
            e.n_blocks for e in pool._entries.values())

    check()
    pool.put("a", _entry(64, 2), n_tokens=16)
    check()
    pool.put("b", _entry(128, 4), n_tokens=32)
    check()
    pool.put("a", _entry(256, 3), n_tokens=24)      # replace
    check()
    assert pool.swapped_blocks == 7 and pool.bytes_used == 128 + 255
    assert pool.pop("b") is not None
    check()
    pool.discard("a")
    check()
    assert pool.swapped_blocks == 0 and pool.bytes_used == 0
    assert not HostKVPool(8).put("x", _entry(64), n_tokens=8)


def test_reservation_protocol_guards_capacity():
    pool = HostKVPool(100)
    assert pool.reserve("a", 60) and pool.reserved_bytes == 60
    # a direct put respects the outstanding reservation
    assert not pool.put("b", _entry(60), n_tokens=8)
    assert pool.refusals == 1
    assert not pool.reserve("c", 60)
    assert pool.commit("a", _entry(60), n_tokens=8)
    assert pool.reserved_bytes == 0 and pool.bytes_used == 60
    assert pool.reserve("d", 30)
    pool.unreserve("d")
    assert pool.reserved_bytes == 0
    # a put under a key holding its OWN reservation credits it (an inline
    # reclaim racing its in-flight proactive spill)
    pool2 = HostKVPool(100, kind="prefix")
    assert pool2.reserve(("pfx", 9), 80)
    assert pool2.put(("pfx", 9), _entry(80), n_tokens=8)
    assert pool2.refusals == 0
    assert pool2.commit(("pfx", 9), _entry(80), n_tokens=8)
    assert pool2.reserved_bytes == 0 and pool2.bytes_used == 80
    assert len(pool2) == 1


def test_host_full_refusals_are_counted():
    pool = HostKVPool(8, kind="prefix")
    assert not pool.put(("pfx", 1), _entry(64), n_tokens=8)
    assert not pool.reserve(("pfx", 2), 64)
    assert pool.refusals == 2 and pool.bytes_used == 0
    swap = HostKVPool(8)
    assert not swap.put("r", _entry(64), n_tokens=8)
    assert swap.refusals == 1
    with pytest.raises(ValueError, match="kind"):
        HostKVPool(8, kind="disk")


# ---------------------------------------------------------------------------
# async == sync == JAX, and the in-flight ledger
# ---------------------------------------------------------------------------
def _swap_run(tcfg, tp, mode, prompts, kv_dtype=None):
    eng = LLMEngine(tp, tcfg, kv_dtype=kv_dtype, kv_offload=mode,
                    device="cpu", **SQUEEZED)
    ids = [eng.add_request(list(p), max_new_tokens=16) for p in prompts]
    streamed = {i: [] for i in ids}
    saw_inflight = False
    while eng.has_work():
        for rid, tok in eng.step():
            streamed[rid].append(tok)
        saw_inflight |= _balanced(eng)["in_flight"] > 0
    eng.drain_offload()
    assert _balanced(eng)["in_flight"] == 0
    assert len(eng.free_blocks) == eng.nb - 1
    assert len(eng.swap_pool) == 0 and eng.swap_pool.reserved_bytes == 0
    for i in ids:
        assert streamed[i] == eng.results[i]        # exactly once
    return [eng.results[i] for i in ids], eng, saw_inflight


@pytest.mark.parametrize("dtype,kv_dtype", [("f32", None), ("f32", "int8"),
                                            ("bf16", None),
                                            ("bf16", "int8")])
def test_async_equals_sync_greedy_parity(model, dtype, kv_dtype):
    """A pool squeezed into preempt-swap: async and sync streams are equal
    (payload and scales move verbatim), the async leg had blocks riding
    an unlanded spill across a step boundary, and in f32 both equal the
    JAX engine's swap streams."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng, 8), _prompt(rng, 7)]
    if dtype == "bf16":
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
        tp = {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in tp.items()}
    sync, eng_s, _ = _swap_run(tcfg, tp, "sync", prompts, kv_dtype)
    asyn, eng_a, saw_inflight = _swap_run(tcfg, tp, "async", prompts,
                                          kv_dtype)
    assert asyn == sync and all(len(s) == 16 for s in sync)
    for eng in (eng_s, eng_a):
        assert eng.offload.prefetch_hits + eng.offload.stalls >= 1
        assert eng.swap_fallbacks == 0
    assert saw_inflight, "async leg never parked blocks behind a d2h"
    if dtype == "f32":
        jeng = JaxEngine(jp, jcfg, kv_dtype=kv_dtype,
                         decode_kernel="bucketed", **SQUEEZED)
        jids = [jeng.add_request(list(p), max_new_tokens=16)
                for p in prompts]
        jout = jeng.run()
        assert sync == [jout[j] for j in jids]


def test_swap_restores_the_spilled_bytes(model):
    """One swap-out and swap-in round trip, sync and async: the restored
    blocks hold the spilled bytes of every pool entry, scales included."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(12)
    for mode in ("sync", "async"):
        eng = LLMEngine(tp, tcfg, kv_dtype="int8", kv_offload=mode,
                        device="cpu", **dict(SQUEEZED, num_blocks=12))
        rid = eng.add_request(_prompt(rng, 13), max_new_tokens=12)
        for _ in range(3):
            eng.step()
        while eng._inflight is not None:
            eng._process_inflight()
        slot = next(i for i in range(eng.N) if eng.slot_req[i] is not None)
        req = eng.slot_req[slot]
        n_keep = len(req.prompt) + len(req.generated) \
            + len(eng.slot_out[slot]) - 1
        old = torch.as_tensor(eng.table[slot, :-(-n_keep // eng.bs)])
        before = {k: p[:, old].clone() for k, p in eng.pools.items()}
        eng._free_slot(slot, requeue=True)
        eng.drain_offload()
        for p in eng.pools.values():       # the freed blocks are reused
            p[:, old] = 0
        eng._admit()
        slot = next(i for i in range(eng.N) if eng.slot_req[i] is not None)
        assert eng.slot_req[slot].req_id == rid
        assert eng.lengths[slot] == n_keep
        new = torch.as_tensor(eng.table[slot, :len(old)])
        for k, p in eng.pools.items():
            assert torch.equal(p[:, new], before[k]), k
        assert len(eng.run()[rid]) == 12


def test_sync_flag_forces_sync_mode(model, flags_guard):
    _, _, tcfg, tp = model
    kw = dict(max_slots=1, block_size=8, max_model_len=64,
              prompt_buckets=[8], device="cpu")
    set_flags({"serve_kv_offload_sync": True})
    assert get_flags("serve_kv_offload_sync") == {
        "FLAGS_serve_kv_offload_sync": True}
    eng = LLMEngine(tp, tcfg, kv_swap_bytes=1 << 20, **kw)
    assert eng.offload is not None and eng.offload.sync
    set_flags({"FLAGS_serve_kv_offload_sync": False})
    assert not LLMEngine(tp, tcfg, kv_swap_bytes=1 << 20, **kw).offload.sync
    # an explicit constructor mode wins over the flag
    set_flags({"serve_kv_offload_sync": True})
    assert not LLMEngine(tp, tcfg, kv_swap_bytes=1 << 20,
                         kv_offload="async", **kw).offload.sync
    # no host tier: no offload engine at all
    assert LLMEngine(tp, tcfg, **kw).offload is None
    with pytest.raises(ValueError, match="kv_offload"):
        LLMEngine(tp, tcfg, kv_swap_bytes=1, kv_offload="bogus", **kw)
    with pytest.raises(ValueError, match="unknown flag"):
        set_flags({"serve_kv_offload_nothing": 1})


def test_prefetch_hit_vs_stall_counters(model, flags_guard):
    _, _, tcfg, tp = model
    rng = np.random.default_rng(4)
    prompts = [_prompt(rng, 8), _prompt(rng, 7)]

    def run(depth):
        set_flags({"serve_kv_offload_prefetch_depth": depth})
        _, eng, _ = _swap_run(tcfg, tp, "async", prompts)
        assert eng.offload.prefetch_hits + eng.offload.stalls >= 1
        return eng.offload

    off_hit = run(depth=4)
    assert off_hit.prefetch_hits >= 1
    off_stall = run(depth=0)
    assert off_stall.prefetch_hits == 0 and off_stall.stalls >= 1
    assert off_stall.stall_seconds > 0.0


def test_force_land_serves_admission_midflight(model):
    """An admission that arrives while the victim's spill is still in
    flight lands it inline (a counted stall) and restores — never
    recomputes, never reads a half-committed entry."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(5)
    eng = LLMEngine(tp, tcfg, max_slots=2, block_size=8, max_model_len=64,
                    prompt_buckets=[8], kv_swap_bytes=1 << 20,
                    kv_offload="async", device="cpu")
    rid = eng.add_request(_prompt(rng, 8), max_new_tokens=12)
    for _ in range(3):
        eng.step()
    while eng._inflight is not None:
        eng._process_inflight()
    slot = next(i for i in range(eng.N) if eng.slot_req[i] is not None)
    n_out = len(eng.slot_out[slot])
    eng._free_slot(slot, requeue=True)
    assert eng.offload.pending(rid) and eng.offload.held_blocks > 0
    _balanced(eng)
    before = eng.offload.stalls
    eng._admit()
    assert not eng.offload.pending(rid)
    assert eng.offload.stalls > before and eng.swap_fallbacks == 0
    out = eng.run()
    assert len(out[rid]) == 12
    assert out[rid][:n_out] == eng.results[rid][:n_out]
    assert _balanced(eng)["in_flight"] == 0


def test_proactive_spill_lands_and_reclaim_frees_instantly(model,
                                                           flags_guard):
    """Under pool pressure the offload tick spills refcount-0 cached blocks
    in the background (the node keeps its block); a later reclaim frees
    the device block with no inline copy, and a warm re-send restores the
    prefix and streams what the cold run streamed."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(7)
    shared = _prompt(rng, 16)        # 2 full blocks to cache
    set_flags({"serve_kv_offload_spill_free_frac": 1.0})  # always pressed
    eng = LLMEngine(tp, tcfg, max_slots=2, block_size=8, max_model_len=64,
                    num_blocks=9, prompt_buckets=[8, 32], prefix_cache=True,
                    prefix_cache_host_bytes=1 << 20, kv_offload="async",
                    device="cpu")
    cold = eng.add_request(list(shared), max_new_tokens=4)
    eng.run()
    pc = eng.prefix_cache
    assert pc.device_blocks >= 2          # adopted at finish
    eng.add_request(_prompt(rng, 5), max_new_tokens=2)
    eng.run()
    eng.drain_offload()
    assert eng.offload.proactive_spills >= 1
    clean = [nd for nd in pc._iter_nodes() if nd.host_clean]
    assert clean, "no spill landed as host_clean dual residency"
    _balanced(eng)
    fetched = []
    clean_blocks = [nd.block for nd in clean]
    host_before = pc.host_blocks
    freed = pc.reclaim(pc.evictable_blocks,
                       lambda blks: fetched.append(blks)
                       or eng._fetch_blocks(blks))
    assert len(freed) >= len(clean)
    assert pc.host_blocks >= host_before + len(clean)
    assert not set(clean_blocks) & set(sum(fetched, []))  # no inline copy
    eng.free_blocks.extend(freed)
    _balanced(eng)
    warm = eng.add_request(list(shared), max_new_tokens=4)
    out = eng.run()
    assert out[warm] == out[cold]
    assert eng.offload.prefetch_hits + eng.offload.stalls >= 1
    assert pc.hits >= 1
    _balanced(eng)
