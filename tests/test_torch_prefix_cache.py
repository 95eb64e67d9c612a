"""The port's prefix cache and chunked prefill
(paddle_tpu_torch.serving.prefix_cache, ``LLMEngine(prefix_cache=...,
prefill_chunk=...)``) held to the JAX LLMEngine on the CPU: the same
numpy-made weights and prompts through both, greedy streams equal token
for token and the cache's host counters equal — cache hits, partial
hits, chunked prefill, int8 pools, eviction that spills to the host tier
and restores, multi-turn adoption at finish — and the block ledger
``free + backed + cached + squeezed + in_flight == total`` at every step,
draining to ``free + cached == total``."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BS = 8
SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
BASE = dict(max_slots=2, block_size=BS, max_model_len=128,
            prompt_buckets=[8, 32])


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _ledger_ok(eng):
    a = eng.block_accounting()
    assert a["free"] + a["backed"] + a["cached"] + a["squeezed"] \
        + a["in_flight"] == a["total"], a
    pc = eng.prefix_cache
    if pc is not None:
        # the O(1) incremental counts agree with a full-trie walk
        nodes = list(pc._iter_nodes())
        assert pc.device_blocks == sum(nd.block is not None for nd in nodes)
        assert pc.evictable_blocks == sum(
            nd.block is not None and nd.refcount == 0 for nd in nodes)
        assert pc.host_blocks == sum(nd.block is None for nd in nodes)
    return a


def _serve(eng, waves, check=True):
    """Each wave's (prompt, max_new_tokens) requests added, then stepped
    until drained (the ledger checked every step): the streams in
    order."""
    outs = []
    for wave in waves:
        ids = [eng.add_request(list(p), max_new_tokens=n) for p, n in wave]
        while eng.has_work():
            eng.step()
            if check:
                _ledger_ok(eng)
        outs += [eng.results[i] for i in ids]
    return outs


def _both(model, waves, **kw):
    """``waves`` through the JAX engine and the port's, built alike: the
    port's engine and its streams, which must equal the JAX engine's,
    whose prefix-cache counters the port's must equal too."""
    jcfg, jp, tcfg, tp = model
    cfg = dict(BASE, **kw)
    jeng = JaxEngine(jp, jcfg, decode_kernel="bucketed", **cfg)
    want = _serve(jeng, waves, check=False)
    eng = LLMEngine(tp, tcfg, device="cpu", **cfg)
    got = _serve(eng, waves)
    assert got == want
    if eng.prefix_cache is not None:
        jpc, pc = jeng.prefix_cache, eng.prefix_cache
        assert (pc.hits, pc.misses, pc.tokens_skipped, pc.host_blocks,
                pc.device_blocks) == (jpc.hits, jpc.misses,
                                      jpc.tokens_skipped, jpc.host_blocks,
                                      jpc.device_blocks)
    return eng, got


def _cold(model, prompt, n, **kw):
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", **dict(BASE, **kw))
    rid = eng.add_request(list(prompt), max_new_tokens=n)
    return eng.run()[rid]


def test_cache_hit_streams_equal_jax_and_cold(model):
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 64, size=20).tolist()
    eng, (out1, out2) = _both(model, [[(prompt, 8)], [(prompt, 8)]],
                              prefix_cache=True)
    assert out1 == out2 == _cold(model, prompt, 8)
    pc = eng.prefix_cache
    # 20 tokens: 2 full blocks cached (the 3rd holds the suffix tail)
    assert (pc.hits, pc.misses, pc.tokens_skipped) == (1, 1, 2 * BS)


def test_partial_prefix_hit_equals_jax(model):
    rng = np.random.default_rng(1)
    head = rng.integers(1, 64, size=BS).tolist()
    a = head + rng.integers(1, 64, size=7).tolist()
    b = head + rng.integers(1, 64, size=9).tolist()
    eng, _ = _both(model, [[(a, 6)], [(b, 6)]], prefix_cache=True)
    assert eng.prefix_cache.hits == 1
    assert eng.prefix_cache.tokens_skipped == BS


@pytest.mark.parametrize("cache", [False, True])
def test_chunked_prefill_equals_jax_and_oneshot(model, cache):
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 64, size=n).tolist() for n in (20, 31, 9)]
    eng, got = _both(model, [[(p, 7) for p in prompts]], prefill_chunk=8,
                     prefix_cache=cache)
    assert got == [_cold(model, p, 7) for p in prompts]
    a = _ledger_ok(eng)
    assert a["free"] + a["cached"] == a["total"]


def test_int8_kv_cache_hit_equals_jax(model):
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, 64, size=20).tolist()
    eng, (out1, out2) = _both(model, [[(prompt, 8)], [(prompt, 8)]],
                              prefix_cache=True, kv_dtype="int8",
                              prefill_chunk=8)
    assert out1 == out2 == _cold(model, prompt, 8, kv_dtype="int8")
    assert eng.prefix_cache.hits == 1


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_eviction_spill_restore_equals_jax(model, mode):
    """One slot and 8 usable blocks: filler traffic evicts the first
    prompt's cached blocks to the host tier; its re-send restores them
    and streams what the cold run streams (the JAX engine's async tier
    is the oracle for both modes)."""
    rng = np.random.default_rng(3)
    pa = rng.integers(1, 64, size=20).tolist()
    fill = [rng.integers(1, 64, size=24).tolist() for _ in range(2)]
    _, _, tcfg, tp = model
    waves = [[(pa, 6)], [(fill[0], 6)], [(fill[1], 6)], [(pa, 6)]]
    kw = dict(max_slots=1, max_model_len=64, num_blocks=8,
              prefix_cache=True, prefix_cache_host_bytes=1 << 20)
    if mode == "async":
        eng, out = _both(model, waves, **kw)
    else:
        eng = LLMEngine(tp, tcfg, device="cpu", kv_offload="sync",
                        **dict(BASE, **kw))
        out = _serve(eng, waves)
        _, want = _both(model, waves, **kw)
        assert out == want
    assert out[3] == out[0] == _cold(model, pa, 6, max_model_len=64)
    pc = eng.prefix_cache
    assert pc.evictions["spill"] >= 1 and pc.hits >= 1
    assert eng.offload.prefetch_hits + eng.offload.stalls >= 1
    _ledger_ok(eng)


def test_eviction_drops_without_host_tier(model):
    rng = np.random.default_rng(4)
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", **dict(
        BASE, max_slots=1, max_model_len=64, num_blocks=10,
        prefix_cache=True))
    for _ in range(4):
        _serve(eng, [[(rng.integers(1, 64, size=20).tolist(), 6)]])
        a = _ledger_ok(eng)
    assert eng.prefix_cache.host_blocks == 0 and eng.offload is None
    assert eng.prefix_cache.evictions["drop"] >= 1
    assert a["free"] + a["cached"] == a["total"] and a["backed"] == 0


def test_multi_turn_adoption_at_finish_equals_jax(model):
    """A finished request's decode-grown full blocks enter the trie: the
    next turn (prompt + answer + follow-up) matches past the prompt."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 64, size=14).tolist()
    answer = _cold(model, prompt, 12)
    turn2 = prompt + answer + rng.integers(1, 64, size=5).tolist()
    eng, out = _both(model, [[(prompt, 12)], [(turn2, 6)]],
                     prefix_cache=True)
    assert out == [answer, _cold(model, turn2, 6)]
    # K/V were valid through len(prompt+answer)-1 = 25 -> 3 full blocks
    assert eng.prefix_cache.tokens_skipped >= 3 * BS


def test_chunked_prefill_interleaves_decode(model):
    """While one slot chunk-prefills a long prompt, the other slot's
    decode keeps emitting — the step is never monopolized."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(7)
    short = rng.integers(1, 64, size=6).tolist()
    long_p = rng.integers(1, 64, size=32).tolist()
    eng = LLMEngine(tp, tcfg, device="cpu", prefill_chunk=8, **BASE)
    r0 = eng.add_request(short, max_new_tokens=24)
    eng.step()
    eng.step()
    r1 = eng.add_request(long_p, max_new_tokens=4)
    interleaved = 0
    for _ in range(64):
        toks = eng.step()
        if eng._chunks and any(rid == r0 for rid, _ in toks):
            interleaved += 1
        if r1 in eng.results:
            break
    out = eng.run()
    assert interleaved >= 1, \
        "no decode tokens emitted during the chunked prefill"
    assert out[r1] == _cold(model, long_p, 4)
    assert out[r0] == _cold(model, short, 24)


def test_chunk_size_rounds_and_validates(model):
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", prefill_chunk=9, **BASE)
    assert eng.prefill_chunk == 16                    # a block multiple
    with pytest.raises(ValueError, match="prefill_chunk"):
        LLMEngine(tp, tcfg, device="cpu", prefill_chunk=256, **BASE)


def test_ledger_balances_under_pressure_equals_jax(model):
    """Tiny pool + cache + chunking + preemption: the ledger balances at
    every step, drains to free + cached with nothing pinned, and the
    streams equal the JAX engine's."""
    rng = np.random.default_rng(9)
    head = rng.integers(1, 64, size=BS).tolist()
    wave = [(head + rng.integers(1, 64, size=int(rng.integers(2, 10)))
             .tolist(), int(rng.integers(6, 14))) for _ in range(5)]
    eng, out = _both(model, [wave], max_model_len=64, num_blocks=7,
                     prefix_cache=True, prefill_chunk=8)
    a = _ledger_ok(eng)
    assert a["free"] + a["cached"] == a["total"] and a["backed"] == 0
    assert not any(nd.refcount for nd in eng.prefix_cache._iter_nodes())
    assert all(len(s) >= 1 for s in out) and eng.prefix_cache.hits >= 1


def test_bf16_warm_and_chunked_streams_equal_cold(model):
    """bf16: the suffix form's scores accumulate in f32 while the cold
    prefill runs B1's plain version; the greedy streams agree."""
    _, _, tcfg, tp = model
    cfg16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    p16 = {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(torch.bfloat16))
           for k, v in tp.items()}
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 64, size=20).tolist()
    cold = LLMEngine(p16, cfg16, device="cpu", **BASE)
    rid = cold.add_request(prompt, max_new_tokens=8)
    ref = cold.run()[rid]
    eng = LLMEngine(p16, cfg16, device="cpu", prefix_cache=True,
                    prefill_chunk=8, **BASE)
    out = _serve(eng, [[(prompt, 8)], [(prompt, 8)]])
    assert out == [ref, ref] and eng.prefix_cache.hits == 1


def test_spec_draft_prefills_the_same_pieces(model):
    """Speculative decoding over the cache and chunks: the draft (here the
    target itself) prefills the same suffix pieces, so its K/V cover
    every position and the greedy streams are the plain ones."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(11)
    head = rng.integers(1, 64, size=2 * BS).tolist()
    prompts = [head + rng.integers(1, 64, size=n).tolist() for n in (5, 13)]
    eng = LLMEngine(tp, tcfg, device="cpu", prefix_cache=True,
                    prefill_chunk=8, draft_params=tp, draft_config=tcfg,
                    spec_tokens=3, **BASE)
    out = _serve(eng, [[(prompts[0], 10)], [(prompts[1], 10)]])
    assert out == [_cold(model, p, 10) for p in prompts]
    assert eng.spec_waves >= 1 and eng.spec_accepted >= 1
    assert eng.prefix_cache.hits == 1
