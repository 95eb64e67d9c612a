"""The port's bucketed decode (``LLMEngine(decode_kernel="bucketed")``,
the dense-gather path) held to the JAX engine's on the CPU.

With the same numpy-made weights and prompts, each ``step()`` emits the
same (req_id, token) list as the JAX engine's bucketed path: at
decode_steps 1 and 4 through recompute preemption, with int8 pools, with
the prefix cache and chunked prefill, and with a speculative draft that
runs on the bucketed path. ``_prefix_blocks`` picks the same bucket at
every dispatch. In bf16 one call of the dense program writes the same
K/V rows as the JAX program's, within bf16 rounding."""
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


def _recording(eng, name):
    """Wrap ``eng.<name>`` to record every return value."""
    seen, inner = [], getattr(eng, name)

    def wrapped(*a, **k):
        seen.append(inner(*a, **k))
        return seen[-1]

    setattr(eng, name, wrapped)
    return seen


def _run_both(model, prompts, max_new=16, **kw):
    """The same requests through both engines' bucketed paths: each
    engine's per-step emitted lists, its recorded ``_prefix_blocks``
    picks and the port engine."""
    jcfg, jp, tcfg, tp = model
    self_draft = kw.pop("self_draft", False)
    jkw, tkw = dict(kw), dict(kw)
    if self_draft:
        jkw.update(draft_params=jp, draft_config=jcfg)
        tkw.update(draft_params=tp, draft_config=tcfg)
    engines = (JaxEngine(jp, jcfg, decode_kernel="bucketed", **ENGINE,
                         **jkw),
               LLMEngine(tp, tcfg, decode_kernel="bucketed", device="cpu",
                         **ENGINE, **tkw))
    res = []
    preempted = []
    free_slot = engines[1]._free_slot

    def counting_free_slot(slot, requeue=False, **k):
        preempted.append(requeue)
        return free_slot(slot, requeue, **k)

    engines[1]._free_slot = counting_free_slot
    engines[1].preempted = preempted
    for eng in engines:
        picks = _recording(eng, "_prefix_blocks")
        for p in prompts:
            eng.add_request(p, max_new_tokens=max_new)
        steps = []
        while eng.has_work():
            steps.append(eng.step())
        res.append((steps, picks))
    return res[0], res[1], engines[1]


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_bucketed_steps_equal_jax_engine(model, decode_steps):
    """Recompute preemption included (a 6-block pool for 5 requests):
    the same per-step lists, the same bucket at every dispatch."""
    (want, jpicks), (got, tpicks), eng = _run_both(
        model, _prompts(), decode_steps=decode_steps)
    assert any(eng.preempted), "the pool was meant to force a preemption"
    assert got == want
    assert tpicks == jpicks and len(tpicks) == sum(eng.decode_paths.values())
    assert set(eng.decode_paths) <= {"bucketed", "dense"}
    a = eng.block_accounting()
    assert a["free"] == a["total"] and eng._inflight is None


def test_bucketed_int8_pools_equal_jax_engine(model):
    (want, jpicks), (got, tpicks), eng = _run_both(
        model, _prompts(seed=4), decode_steps=2, kv_dtype="int8")
    assert eng.pools["k"].dtype == torch.int8
    assert got == want and tpicks == jpicks


def test_bucketed_prefix_cache_chunks_equal_jax_engine(model):
    """Two prompts share a 16-token prefix; chunked prefill of 8."""
    rng = np.random.default_rng(5)
    head = rng.integers(1, 64, size=16).tolist()
    prompts = [head + rng.integers(1, 64, size=n).tolist()
               for n in (5, 9, 3)] + _prompts(seed=6, n=2)
    (want, jpicks), (got, tpicks), eng = _run_both(
        model, prompts, max_new=10, decode_steps=2, prefix_cache=True,
        prefill_chunk=8)
    assert got == want and tpicks == jpicks
    assert eng.prefix_cache.hits >= 1


def test_bucketed_spec_draft_equal_jax_engine(model):
    """The target as its own draft: every wave's draft runs on the
    bucketed path over the verify's table width."""
    (want, _), (got, _), eng = _run_both(
        model, _prompts(seed=7, n=3), max_new=12, self_draft=True,
        spec_tokens=3)
    assert got == want
    assert eng.spec_waves >= 1
    assert dict(eng.spec_draft_paths) == {"bucketed": eng.spec_waves}


def test_bucket_reaches_full_width_as_dense(model):
    """A context near max_model_len: the bucket reaches the table's full
    width and the dispatch is counted ``dense``, as the JAX engine
    labels it."""
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, decode_kernel="bucketed", device="cpu",
                    decode_steps=2, **dict(ENGINE, num_blocks=None))
    rid = eng.add_request(_prompts(seed=8, n=1)[0][:3] * 10,
                          max_new_tokens=30)
    out = eng.run()
    assert len(out[rid]) == 30
    assert eng.decode_paths["dense"] >= 1 and eng.decode_paths["bucketed"]


def test_auto_never_picks_bucketed_on_the_cpu(model):
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, device="cpu", **ENGINE)
    eng.add_request([1, 2, 3], max_new_tokens=4)
    eng.run()
    assert dict(eng.decode_paths) == {"ragged": eng.decode_paths["ragged"]}


def test_bf16_dense_call_writes_the_jax_rows():
    """One 3-step call of the dense program in bf16 on the same inputs:
    the K/V rows it writes back equal the JAX program's within bf16
    rounding, the untouched rows exactly."""
    cfg_kw = dict(vocab=64, hidden=64, layers=2, heads=4, kv_heads=2,
                  seq=128, ffn=128)
    jcfg = dataclasses.replace(jl.tiny_llama(**cfg_kw), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tl.tiny_llama(**cfg_kw), dtype=torch.bfloat16)
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16),
        jl.init_params(jcfg, jax.random.PRNGKey(1)))
    npp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tp = jax.tree_util.tree_map(
        lambda t: t.to(torch.bfloat16),
        tl.params_from_numpy(npp, device="cpu"))
    rng = np.random.default_rng(0)
    L, NB, bs, Hkv, D = 2, 12, 8, 2, 16
    pool = rng.standard_normal((L, NB, bs, Hkv, D)).astype(np.float32)
    vpool = rng.standard_normal((L, NB, bs, Hkv, D)).astype(np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    lens = np.array([27, 13], np.int32)
    last = np.array([5, 9], np.int32)
    jout = jeng._paged_decode(
        jp, jnp.asarray(last), jnp.asarray(lens), jnp.zeros(2, bool),
        jnp.full(2, 8, jnp.int32), jax.random.PRNGKey(0),
        jnp.ones(2, bool), jnp.asarray(table),
        {"k": jnp.asarray(pool, jnp.bfloat16),
         "v": jnp.asarray(vpool, jnp.bfloat16)},
        jnp.zeros(2), jnp.zeros(2, jnp.int32), jnp.ones(2),
        jnp.full(2, -1, jnp.int32), config=jcfg, n_steps=3,
        sample_flags=(False, False, False))
    tpools = {"k": torch.as_tensor(pool).to(torch.bfloat16),
              "v": torch.as_tensor(vpool).to(torch.bfloat16)}
    t = torch.as_tensor
    _, _, tlens, _, _ = teng._paged_decode(
        tp, t(last), t(lens), torch.zeros(2, dtype=torch.bool),
        torch.full((2,), 8, dtype=torch.int32), None,
        torch.ones(2, dtype=torch.bool), t(table), tpools, torch.zeros(2),
        torch.zeros(2, dtype=torch.int32), torch.ones(2),
        torch.full((2,), -1, dtype=torch.int32), config=tcfg,
        n_steps=3, sample_flags=(False, False, False),
        bucketed=True)
    assert tlens.tolist() == np.asarray(jout[2]).tolist() == [30, 16]
    for name in ("k", "v"):
        want = np.asarray(jout[6][name], np.float32)
        got = tpools[name].float().numpy()
        # rows the call wrote: positions lens .. lens+2 of each slot
        written = np.zeros(want.shape[:3], bool)
        for n in range(2):
            for j in range(3):
                pos = int(lens[n]) + j
                written[:, table[n, pos // bs], pos % bs] = True
        np.testing.assert_array_equal(got[~written], want[~written])
        scale = np.abs(want[written]).max()
        assert np.abs(got[written] - want[written]).max() <= 2e-2 * scale
