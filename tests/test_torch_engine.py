"""The port's serving engine (paddle_tpu_torch.serving) held to the JAX
LLMEngine on the CPU: the same numpy-made weights and prompts, more
requests than slots, and a block pool small enough to force recompute
preemptions. Greedy streams must be equal token for token."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import engine as jeng
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
ENGINE = dict(max_slots=2, block_size=8, max_model_len=64, num_blocks=6,
              prompt_buckets=[8, 32])


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(k)).tolist()
            for k in rng.integers(3, 20, size=n)]


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_streams_equal_jax_engine(model, decode_steps, monkeypatch):
    jcfg, jp, tcfg, tp = model
    prompts = _prompts()
    jax_eng = JaxEngine(jp, jcfg, decode_steps=decode_steps,
                        decode_kernel="bucketed", **ENGINE)
    jids = [jax_eng.add_request(p, max_new_tokens=16) for p in prompts]
    want = jax_eng.run()

    eng = LLMEngine(tp, tcfg, decode_steps=decode_steps, device="cpu",
                    **ENGINE)
    preempted = []
    free_slot = eng._free_slot

    def counting_free_slot(slot, requeue=False):
        preempted.append(requeue)
        return free_slot(slot, requeue)

    monkeypatch.setattr(eng, "_free_slot", counting_free_slot)
    ids = [eng.add_request(p, max_new_tokens=16) for p in prompts]
    streamed = {i: [] for i in ids}
    while eng.has_work():
        for rid, tok in eng.step():
            streamed[rid].append(tok)
        acct = eng.block_accounting()
        assert acct["free"] + acct["backed"] == acct["total"]
    assert any(preempted), "the pool was meant to force a preemption"
    for i, j in zip(ids, jids):
        assert eng.results[i] == want[j]
        assert streamed[i] == eng.results[i]
    assert eng.block_accounting() == {
        "total": 6, "free": 6, "backed": 0, "cached": 0, "squeezed": 0,
        "in_flight": 0, "host_spilled_blocks": 0, "swapped_host_blocks": 0}


def test_sampled_requests_stay_in_vocab_and_respect_eos(model):
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, decode_steps=3, device="cpu", seed=1, **ENGINE)
    p = _prompts(seed=4, n=3)
    ids = [eng.add_request(p[0], max_new_tokens=10, temperature=0.8,
                           top_k=5),
           eng.add_request(p[1], max_new_tokens=10, temperature=1.0,
                           top_p=0.9),
           eng.add_request(p[2], max_new_tokens=10)]
    out = eng.run()
    for i in ids:
        assert len(out[i]) == 10
        assert all(0 <= t < tcfg.vocab_size for t in out[i])
    greedy = out[ids[2]]
    eng2 = LLMEngine(tp, tcfg, decode_steps=3, device="cpu", **ENGINE)
    rid = eng2.add_request(p[2], max_new_tokens=10, eos_token_id=greedy[3])
    assert eng2.run()[rid] == greedy[:greedy.index(greedy[3]) + 1]


def _logits(seed, n=6, vocab=64):
    return np.random.default_rng(seed).standard_normal(
        (n, vocab)).astype(np.float32) * 3


def test_sample_rows_top_k1_and_tiny_top_p_are_greedy():
    lg = torch.as_tensor(_logits(0))
    n = lg.shape[0]
    gen = torch.Generator().manual_seed(0)
    greedy = lg.argmax(-1).int()
    ones = torch.ones(n)
    got_k = teng._sample_rows(lg, gen, ones, torch.ones(n, dtype=torch.int32),
                              ones, True, True, False)
    got_p = teng._sample_rows(lg, gen, ones, torch.zeros(n, dtype=torch.int32),
                              torch.full((n,), 1e-6), True, False, True)
    assert torch.equal(got_k, greedy) and torch.equal(got_p, greedy)
    mixed = teng._sample_rows(lg, gen, torch.zeros(n),
                              torch.zeros(n, dtype=torch.int32), ones)
    assert torch.equal(mixed, greedy)


def test_top_k_top_p_masks_equal_jax(monkeypatch):
    """The masked logits the port samples from equal the JAX engine's
    (captured at its categorical draw) for the same logits and knobs."""
    captured = []

    def capture(key, lg, axis=-1):
        captured.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    logits = _logits(1)
    temps = np.array([0.7, 1.0, 1.3, 0.5, 1.0, 2.0], np.float32)
    top_ks = np.array([0, 3, 10, 1, 64, 5], np.int32)
    top_ps = np.array([0.5, 1.0, 0.9, 1.0, 0.3, 0.99], np.float32)
    for use_k, use_p in ((True, False), (False, True), (True, True)):
        captured.clear()
        jeng._sample_rows(jnp.asarray(logits), jax.random.PRNGKey(0),
                          jnp.asarray(temps), jnp.asarray(top_ks),
                          jnp.asarray(top_ps), True, use_k, use_p)
        got = teng._filter_logits(torch.as_tensor(logits),
                                  torch.as_tensor(temps),
                                  torch.as_tensor(top_ks),
                                  torch.as_tensor(top_ps), use_k, use_p)
        want = captured[0]
        np.testing.assert_array_equal(got.numpy() <= -1e29, want <= -1e29)
        live = want > -1e29
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-6)


def test_top_p_one_row_masks_nothing_where_jax_masks_its_tail(monkeypatch):
    """A known divergence, pinned on the port's side: in a batch that
    samples with top_p < 1, a row with top_p = 1.0 keeps every token in
    the port, while the JAX engine drops a sorted token once the f32
    cumsum before it reaches 1.0, which a peaked row at Llama-3's vocab
    of 128,256 does well before its tail. The reference's own docstring
    says "top_p>=1 → disabled", so the port keeps its behaviour; the
    tokens the reference drops hold a mass below f32's resolution of 1."""
    captured = []

    def capture(key, lg, axis=-1):
        captured.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    vocab = 128256
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, vocab)) * 3).astype(np.float32)
    logits[0, rng.choice(vocab, 5, replace=False)] += 20.0   # peaked row
    temps = np.ones(2, np.float32)
    top_ks = np.zeros(2, np.int32)
    top_ps = np.array([1.0, 0.9], np.float32)
    jeng._sample_rows(jnp.asarray(logits), jax.random.PRNGKey(0),
                      jnp.asarray(temps), jnp.asarray(top_ks),
                      jnp.asarray(top_ps), True, False, True)
    jax_drop = captured[0] <= -1e29
    port_drop = teng._filter_logits(
        torch.as_tensor(logits), torch.as_tensor(temps),
        torch.as_tensor(top_ks), torch.as_tensor(top_ps), False,
        True).numpy() <= -1e29
    assert not port_drop[0].any()
    assert jax_drop[0].sum() > 10_000
    p = np.exp(logits[0].astype(np.float64) - logits[0].max())
    p /= p.sum()
    assert p[jax_drop[0]].sum() < 1e-6
    # the top_p = 0.9 row is masked by both (the same nucleus)
    assert port_drop[1].any() and jax_drop[1].any()
    assert abs(int(port_drop[1].sum()) - int(jax_drop[1].sum())) <= 2


def test_unported_arguments_raise(model):
    _, _, tcfg, tp = model
    for kw, err, match in ((dict(kv_dtype="fp8"), ValueError, "kv_dtype"),
                           (dict(kv_offload="bogus", kv_swap_bytes=1),
                            ValueError, "kv_offload"),
                           (dict(role="prefill"), ValueError,
                            "requires a relay pool"),
                           (dict(relay=object()), ValueError,
                            "HostKVPool"),
                           (dict(role="colocated"), ValueError, "role"),
                           (dict(mesh=object()), TypeError,
                            "DeviceMesh")):
        with pytest.raises(err, match=match):
            LLMEngine(tp, tcfg, device="cpu", **kw)
    # the ported host-tier and prefix arguments construct
    eng = LLMEngine(tp, tcfg, device="cpu", prefix_cache=True,
                    prefill_chunk=16, prefix_cache_host_bytes=1 << 20,
                    kv_swap_bytes=1 << 20, kv_offload="sync")
    assert eng.prefix_cache is not None and eng.offload.sync
    # so do admission control, the fault injector and the bucketed decode
    from paddle_tpu_torch.distributed.resilience import FaultInjector
    from paddle_tpu_torch.serving import AdmissionConfig
    eng = LLMEngine(tp, tcfg, device="cpu", kv_dtype=None,
                    prefix_cache=False, decode_kernel="bucketed",
                    admission=AdmissionConfig(max_queue=4),
                    injector=FaultInjector("slow_step@1"))
    assert eng.admission.config.max_queue == 4
    # the reference Request's fields exist (ROADMAP fault C1) and are
    # live: the deadline, the tenant and the relay key (carried, and
    # ignored by an engine with no relay pool)
    rid = eng.add_request([1, 2, 3], deadline_s=30.0, tenant="batch",
                          max_new_tokens=2)
    assert eng.queue[-1].t_deadline is not None
    rid7 = eng.add_request([1, 2, 3], relay_key=7, max_new_tokens=2)
    assert eng.queue[-1].relay_key == 7
    eng.add_request([1, 2, 3], deadline_s=None, tenant="default",
                    relay_key=None, max_new_tokens=2)
    # the disaggregated roles construct (ROADMAP A7)
    from paddle_tpu_torch.serving import HostKVPool
    relay = HostKVPool(1 << 20, kind="relay")
    for role in ("prefill", "decode", "both"):
        e = LLMEngine(tp, tcfg, device="cpu", role=role, relay=relay)
        assert e.role == role and e.relay is relay
    out = eng.run()
    assert len(out[rid]) == 2 and eng.decode_paths["bucketed"]
    assert out[rid7] == out[rid]
    assert eng.injector.fired == [("slow_step", 1)]
    with pytest.raises(TypeError):
        LLMEngine(tp, tcfg, device="cpu", no_such_argument=1)
    with pytest.raises(ValueError):
        LLMEngine(tp, tcfg, device="cpu", decode_kernel="fast")
