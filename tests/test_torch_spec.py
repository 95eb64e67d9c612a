"""Speculative decoding in the port (paddle_tpu_torch) held to the JAX
package on the CPU, mirroring tests/test_spec_decode.py:

- ``models.llama.draft_config`` and the fixed-batch cache forward
  ``forward_with_cache(logits_all=True)`` against the JAX package's (and
  against consuming the piece token by token);
- B5's multi-step form: the plain ``mega_decode_loop_plain`` against the
  JAX ``mega_decode_loop`` (Pallas in interpret mode) for a dense, a tied
  and an int8 head, int8 weights, an eos and a budget that end rows
  mid-loop and an inactive row — tokens and states exact, rings within
  1e-5;
- the batched verify ``engine._spec_verify`` against the JAX engine's:
  the greedy grid exact, the pools within 1e-5 (f32) or one int8 step;
- engine streams, f32 and int8 pools: the port's speculative engine ==
  its plain engine == the JAX speculative engine, with a self-draft, a
  smaller draft and a zero-acceptance draft, through the ragged and the
  mega draft paths, with the host counters equal to the JAX engine's;
  eos mid-wave, a sampled request in the mix (the wave falls back), the
  constructor's validation and ``spec=False``.

The CUDA kernel of the multi-step form is held to the plain version in
test_torch_kernels_cuda.py. bf16 streams are not compared: the verify's
prefill-shaped products round differently from the decode path's, and a
near-tie argmax flips (ROADMAP C; the JAX package's own bf16 case fails
the same way).
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.kernels.mega_decode import mega_decode_loop as jax_loop
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import engine as jeng
from paddle_tpu_torch.kernels import mega_decode as tmd
from paddle_tpu_torch.kernels.quant_matmul import quantize_kv
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
BS = 8
ENGINE = dict(max_slots=2, block_size=BS, max_model_len=128,
              prompt_buckets=[8, 32])
COUNTERS = ("spec_waves", "spec_proposed", "spec_accepted",
            "spec_committed", "spec_draft_steps", "spec_verify_calls")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(jcfg, key):
    """(JAX params, the port's copy) of one config, f32."""
    jp = jl.init_params(jcfg, jax.random.PRNGKey(key))
    return jp, tl.params_from_numpy(_numpy(jp), device="cpu")


def _configs(**over):
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32,
                               **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    jp, tp = _pair(jcfg, 0)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def small_draft(model):
    jcfg, _, tcfg, _ = model
    jd, td = jl.draft_config(jcfg, num_layers=1), \
        tl.draft_config(tcfg, num_layers=1)
    jp, tp = _pair(jd, 7)
    return jd, jp, td, tp


# ---------------------------------------------------------------------------
# the model pieces
# ---------------------------------------------------------------------------
_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
           "num_heads", "num_kv_heads", "head_dim", "max_seq_len",
           "rope_theta", "rms_eps", "tie_embeddings")


@pytest.mark.parametrize("kw", [
    {}, dict(num_layers=1),
    dict(num_layers=16, hidden_size=2048, intermediate_size=8192,
         num_heads=32, num_kv_heads=8, head_dim=64)])
def test_draft_config_matches_jax(kw):
    """The draft's fields equal the JAX package's, for the tiny model and
    Llama-3-8B (the last case: Llama-3.2-1B's published widths)."""
    for jt, tt in ((jl.tiny_llama(**SIZES), tl.tiny_llama(**SIZES)),
                   (jl.llama3_8b(), tl.llama3_8b())):
        want, got = jl.draft_config(jt, **kw), tl.draft_config(tt, **kw)
        assert {f: getattr(got, f) for f in _FIELDS} \
            == {f: getattr(want, f) for f in _FIELDS}
        assert got.dtype == tt.dtype


def test_forward_with_cache_logits_all_matches_jax_and_stepwise(model):
    """Scoring a 4-token piece in one forward equals the JAX package's
    and consuming it one token at a time (1e-5)."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 64, size=(2, 6)).astype(np.int32)
    piece = rng.integers(1, 64, size=(2, 4)).astype(np.int32)
    jc = jl.init_kv_cache(jcfg, 2, 32)
    _, jc = jl.forward_with_cache(jp, jnp.asarray(prompt), jc, jcfg)
    want, _ = jl.forward_with_cache(jp, jnp.asarray(piece), jc, jcfg,
                                    logits_all=True)
    cache = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    _, cache = tl.forward_with_cache(tp, torch.as_tensor(prompt), cache, tcfg)
    got, after = tl.forward_with_cache(tp, torch.as_tensor(piece), cache,
                                       tcfg, logits_all=True)
    assert got.shape == (2, 4, 64) and after["pos"] == 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    step = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    _, step = tl.forward_with_cache(tp, torch.as_tensor(prompt), step, tcfg)
    for j in range(4):
        lg, step = tl.forward_with_cache(tp, torch.as_tensor(piece[:, j:j + 1]),
                                         step, tcfg)
        np.testing.assert_allclose(got[:, j].numpy(), lg.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# B5's multi-step form
# ---------------------------------------------------------------------------
def _loop_models(head):
    """(jcfg, JAX params, tcfg, port params) for the head form: "dense",
    "tied", "int8" (int8 weights and head) or "w8" (int8 weights, dense
    head)."""
    jcfg, tcfg = _configs(tie_embeddings=head == "tied")
    jp = jl.init_params(jcfg, jax.random.PRNGKey(5))
    if head in ("int8", "w8"):
        jp = jl.quantize_params(jp, include_lm_head=head == "int8")
    return jcfg, jp, tcfg, tl.params_from_numpy(_numpy(jp), device="cpu")


def _loop_inputs(seed, k):
    """Three rows: a walk of 5 positions, an empty one (inactive) and a
    full table; [L, NB, 4, 2, 8] pools; a zeroed k-row ring."""
    rng = np.random.default_rng(seed)
    N, L, Hkv, D, bs, mb = 3, 2, 2, 8, 4, 4
    nb = N * mb + 1
    walk = np.array([5, 0, mb * bs - k], np.int32)
    return dict(
        pools=[rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32)
               for _ in range(2)],
        ring=np.zeros((L, N, k, Hkv, D), np.float32),
        table=rng.permutation(np.arange(1, nb)).reshape(N, mb)
        .astype(np.int32),
        walk=walk, last0=rng.integers(1, 64, size=N).astype(np.int32),
        active=np.array([1, 1, 0], np.int32))


def _run_port_loop(tp, tcfg, inp, k, budgets, eos):
    rk, rv = (torch.as_tensor(inp["ring"].copy()) for _ in range(2))
    last0 = torch.as_tensor(inp["last0"])
    return tmd.mega_decode_loop(
        tp, tcfg, x0=tp["embed"][last0.long()], n_steps=k,
        block_table=torch.as_tensor(inp["table"]),
        walk_lens=torch.as_tensor(inp["walk"]),
        lens=torch.as_tensor(inp["walk"]),
        active=torch.as_tensor(inp["active"]).bool(), last0=last0,
        budgets=torch.as_tensor(budgets), eos_ids=torch.as_tensor(eos),
        ring_k=rk, ring_v=rv, k_pool=torch.as_tensor(inp["pools"][0]),
        v_pool=torch.as_tensor(inp["pools"][1]))


@pytest.mark.parametrize("head", ["dense", "tied", "int8", "w8"])
def test_plain_loop_matches_jax_mega_decode_loop(head):
    """k = 4 greedy steps: row 0 stops at its eos (picked from a first
    run so it fires mid-loop), row 1 at a budget of 2, row 2 is
    inactive. Emitted tokens and the final last/lens/done/budgets equal
    the JAX kernel's exactly; the rings within 1e-5."""
    k = 4
    jcfg, jp, tcfg, tp = _loop_models(head)
    inp = _loop_inputs(11, k)
    budgets = np.array([k, 2, k], np.int32)
    free = _run_port_loop(tp, tcfg, inp, k, budgets,
                          np.full(3, -1, np.int32))[0].numpy()
    # an eos for row 0 that first appears at step 1 or later
    later = [s for s in range(1, k) if free[s, 0] not in free[:s, 0]]
    eos = np.array([free[later[0], 0] if later else -1, -1, -1], np.int32)
    got = _run_port_loop(tp, tcfg, inp, k, budgets, eos)
    want = jax_loop(
        jp, jcfg, x0=jp["embed"][jnp.asarray(inp["last0"])], n_steps=k,
        block_table=jnp.asarray(inp["table"]),
        walk_lens=jnp.asarray(inp["walk"]), lens=jnp.asarray(inp["walk"]),
        active=jnp.asarray(inp["active"]).astype(bool),
        last0=jnp.asarray(inp["last0"]), budgets=jnp.asarray(budgets),
        eos_ids=jnp.asarray(eos), ring_k=jnp.asarray(inp["ring"]),
        ring_v=jnp.asarray(inp["ring"]), k_pool=jnp.asarray(inp["pools"][0]),
        v_pool=jnp.asarray(inp["pools"][1]))
    names = ("emitted", "last", "lens", "done", "budgets")
    for g, w, what in zip(got[:5], want[:5], names):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=what)
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    emitted = got[0].numpy()
    assert np.all(emitted[:, 2] == -1)                    # inactive
    assert np.all(emitted[2:, 1] == -1) and got[3][1]     # budget spent
    if later:                                             # eos mid-loop
        assert got[3][0] and np.all(emitted[later[0] + 1:, 0] == -1)


# ---------------------------------------------------------------------------
# the batched verify
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", [None, "int8"])
def test_spec_verify_matches_jax(model, kv):
    """Three slots (one inactive, one whose piece runs past
    max_model_len): the greedy grid equals the JAX verify's; the pools it
    writes agree within 1e-5, or for int8 pools within one int8 step and
    1e-5 on the scales."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(4)
    k, N, nbk, L = 4, 3, 4, 2
    nb = N * nbk + 1
    kp, vp = (rng.standard_normal((L, nb, BS, 2, 8)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(np.arange(1, nb)).reshape(N, nbk).astype(np.int32)
    lens = np.array([9, 30, 5], np.int32)
    active = np.array([True, True, False])
    last = rng.integers(1, 64, size=N).astype(np.int32)
    draft = rng.integers(0, 64, size=(k, N)).astype(np.int32)
    draft[2:, 0] = -1                                    # a row's -1 pads
    pools = {"k": torch.as_tensor(kp), "v": torch.as_tensor(vp)}
    if kv:
        qk, sk = quantize_kv(pools["k"])
        qv, sv = quantize_kv(pools["v"])
        pools = {"k": qk, "v": qv, "ks": sk, "vs": sv}
    jpools = {n: jnp.asarray(t.numpy()) for n, t in pools.items()}
    want, jout = jeng._spec_verify(
        jp, jnp.asarray(table), jnp.asarray(last), jnp.asarray(draft),
        jnp.asarray(lens), jnp.asarray(active), jpools, config=jcfg,
        n_spec=k, kv_int8=bool(kv), max_model_len=32)
    got = teng._spec_verify(
        tp, torch.as_tensor(table), torch.as_tensor(last),
        torch.as_tensor(draft), torch.as_tensor(lens),
        torch.as_tensor(active), pools, config=tcfg, n_spec=k,
        max_model_len=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name, t in pools.items():
        w = np.asarray(jout[name])
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32) - w).max() <= 1, name
        else:
            np.testing.assert_allclose(t.numpy(), w, atol=1e-5, rtol=0,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# engine streams
# ---------------------------------------------------------------------------
def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=n).tolist() for n in sizes]


def _run(engine_cls, params, cfg, prompts, n_new, req=None, **kw):
    eng = engine_cls(params, cfg, **dict(ENGINE, **kw))
    ids = [eng.add_request(p, max_new_tokens=n, **(req or {}))
           for p, n in zip(prompts, n_new)]
    out = eng.run()
    return [out[i] for i in ids], eng


def _draft(name, model, small_draft):
    """(JAX draft params, config, the port's draft params, config)."""
    jcfg, jp, tcfg, tp = model
    if name == "self":
        return jp, jcfg, tp, tcfg
    if name == "small":
        jd, jdp, td, tdp = small_draft
        return jdp, jd, tdp, td
    jadv, tadv = _pair(jcfg, 99)                 # agrees with ~1/64
    return jadv, jcfg, tadv, tcfg


PROMPTS = _prompts(0, (1, 5, 11, 20, 3))
N_NEW = (9, 12, 6, 11, 14)


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("draft", ["self", "small", "adversarial"])
def test_spec_streams_equal_plain_and_jax(model, small_draft, draft, kv,
                                          monkeypatch):
    """Greedy streams: the port's speculative engine (ragged draft and,
    with the screen passed, the mega draft: one multi-step call a wave)
    == its plain engine == the JAX speculative engine; the spec counters
    equal the JAX engine's. A zero-acceptance draft still commits one
    token a wave."""
    jcfg, jp, tcfg, tp = model
    jdp, jd, tdp, td = _draft(draft, model, small_draft)
    spec = dict(kv_dtype=kv, spec_tokens=4)
    want, jeng_ = _run(JaxEngine, jp, jcfg, PROMPTS, N_NEW,
                       draft_params=jdp, draft_config=jd, **spec)
    base, _ = _run(LLMEngine, tp, tcfg, PROMPTS, N_NEW, kv_dtype=kv,
                   device="cpu")
    got, eng = _run(LLMEngine, tp, tcfg, PROMPTS, N_NEW, draft_params=tdp,
                    draft_config=td, device="cpu", **spec)
    assert got == base == want
    assert {c: getattr(eng, c) for c in COUNTERS} \
        == {c: getattr(jeng_, c) for c in COUNTERS}
    assert eng.spec_waves > 0 and not eng.decode_paths
    assert dict(eng.spec_draft_paths) == {"ragged": eng.spec_waves}
    assert eng.spec_committed == sum(N_NEW) - len(PROMPTS)
    assert eng.spec_verify_calls <= eng.spec_committed
    if draft == "self" and kv is None:
        # (over int8 target pools the self-draft's own pools are f32)
        assert eng.spec_accepted == eng.spec_proposed
    if draft == "adversarial":
        assert eng.spec_accepted <= 0.2 * eng.spec_proposed
    # the mega paths (the tiny model's head_dim 8 is outside the CUDA
    # kernel's screen; the plain versions take it)
    monkeypatch.setattr(teng, "mega_supported", lambda *a, **k: (True, "ok"))
    mega, meng = _run(LLMEngine, tp, tcfg, PROMPTS, N_NEW, draft_params=tdp,
                      draft_config=td, decode_kernel="mega", device="cpu",
                      **spec)
    assert mega == want
    assert dict(meng.spec_draft_paths) == {"mega": meng.spec_waves}
    assert not meng.mega_fallbacks


def test_draft_screen_refusal_counted_and_streams_unchanged(model,
                                                            small_draft,
                                                            monkeypatch):
    """A mega pick whose draft the multi-step screen refuses runs the
    draft ragged and counts ``draft_<reason>`` once a wave."""
    jcfg, jp, tcfg, tp = model
    _, _, td, tdp = small_draft
    want, _ = _run(LLMEngine, tp, tcfg, PROMPTS[:3], N_NEW[:3], device="cpu")

    def screen(params, config, **kw):
        return (False, "head_width") if kw.get("multi_step") \
            else (True, "ok")
    monkeypatch.setattr(teng, "mega_supported", screen)
    got, eng = _run(LLMEngine, tp, tcfg, PROMPTS[:3], N_NEW[:3],
                    draft_params=tdp, draft_config=td, decode_kernel="mega",
                    device="cpu")
    assert got == want
    assert dict(eng.spec_draft_paths) == {"ragged": eng.spec_waves}
    assert eng.mega_fallbacks == {"draft_head_width": eng.spec_waves}


def test_spec_with_eos_matches_plain_and_jax(model):
    """An eos emitted mid-wave ends the commit there, as step-wise
    decoding does."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts(11, (6, 9))
    base, _ = _run(LLMEngine, tp, tcfg, prompts, (12, 12), device="cpu")
    req = dict(eos_token_id=int(base[0][5]))
    plain, _ = _run(LLMEngine, tp, tcfg, prompts, (12, 12), req,
                    device="cpu")
    got, eng = _run(LLMEngine, tp, tcfg, prompts, (12, 12), req,
                    draft_params=tp, draft_config=tcfg, device="cpu")
    want, _ = _run(JaxEngine, jp, jcfg, prompts, (12, 12), req,
                   draft_params=jp, draft_config=jcfg)
    assert got == plain == want
    assert got[0][-1] == req["eos_token_id"] and len(got[0]) < 12
    assert eng.spec_waves > 0


def test_sampled_mix_falls_back_and_recovers(model):
    """A sampled request in the mix sends its waves down the normal path
    (the greedy slot beside it goes stale); everything finishes, the
    streams equal the plain engine's — the sampled one too, since the
    draft's prefill draws nothing — and a fresh admission re-engages."""
    _, _, tcfg, tp = model
    prompts = _prompts(12, (5, 7, 6))

    def drive(**kw):
        eng = LLMEngine(tp, tcfg, device="cpu", **dict(ENGINE, **kw))
        a = eng.add_request(prompts[0], max_new_tokens=8)
        b = eng.add_request(prompts[1], max_new_tokens=6, temperature=0.9,
                            top_k=8)
        eng.run()
        waves = eng.spec_waves
        c = eng.add_request(prompts[2], max_new_tokens=8)
        out = eng.run()
        return [out[a], out[b], out[c]], waves, eng
    want, _, _ = drive()
    got, waves_before, eng = drive(draft_params=tp, draft_config=tcfg)
    assert got == want and len(got[1]) == 6
    assert waves_before == 0 and eng.spec_waves > 0
    assert eng.decode_paths["ragged"] > 0


def test_spec_validation_errors_and_spec_off(model):
    """Constructor contract: a draft without its config, a vocabulary
    mismatch and spec_tokens < 1 raise; ``spec=False`` (or no draft)
    creates no draft pools and runs no spec wave."""
    _, _, tcfg, tp = model
    kw = dict(ENGINE, device="cpu")
    with pytest.raises(ValueError, match="draft_config"):
        LLMEngine(tp, tcfg, draft_params=tp, **kw)
    bad = dataclasses.replace(tcfg, vocab_size=32)
    with pytest.raises(ValueError, match="vocab"):
        LLMEngine(tp, tcfg, draft_params=tp, draft_config=bad, **kw)
    with pytest.raises(ValueError, match="spec_tokens"):
        LLMEngine(tp, tcfg, draft_params=tp, draft_config=tcfg,
                  spec_tokens=0, **kw)
    base, beng = _run(LLMEngine, tp, tcfg, PROMPTS[:3], N_NEW[:3],
                      device="cpu")
    off, oeng = _run(LLMEngine, tp, tcfg, PROMPTS[:3], N_NEW[:3],
                     draft_params=tp, draft_config=tcfg, spec=False,
                     device="cpu")
    assert off == base
    assert set(oeng.pools) == set(beng.pools) == {"k", "v"}
    assert oeng.draft_params is None and oeng.spec_waves == 0
    assert oeng.decode_paths == beng.decode_paths
    _, seng = _run(LLMEngine, tp, tcfg, PROMPTS[:1], N_NEW[:1],
                   draft_params=tp, draft_config=tcfg, kv_dtype="int8",
                   device="cpu")
    # the draft's pools stay in its dtype beside int8 target pools
    assert seng.pools["dk"].dtype == torch.float32
    assert set(seng.pools) == {"k", "v", "ks", "vs", "dk", "dv"}
