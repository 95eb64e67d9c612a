"""The port's mega decode kernel (paddle_tpu_torch.kernels.mega_decode)
and the engine's mega path held to the JAX package on the CPU, mirroring
tests/test_mega_decode.py: the plain ``mega_decode_step`` against the JAX
``mega_decode_step`` (Pallas in interpret mode) on the same numpy-made
weights and inputs, the eligibility screen's reasons, greedy streams of
the mega engine against the ragged one and the JAX mega engine (with
recompute preemption), the counted fallback, and ``"auto"`` on the CPU.
The CUDA kernel is held to the plain version in test_torch_kernels_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.kernels.mega_decode import mega_decode_step as jax_mega_step
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu_torch.kernels import mega_decode as tmd
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
ENGINE = dict(max_slots=2, block_size=8, max_model_len=64, num_blocks=6,
              prompt_buckets=[8, 32])
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models(name):
    jdt, tdt = DTYPES[name]
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jdt)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=tdt)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt),
                                jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    return _models("f32")


def _step_inputs(seed, t):
    """One step's inputs for 3 slots: walk lengths 5, 0 (an empty prefix)
    and the full table, current lengths 2 past them, [L, NB, 4, 2, 8]
    pools and a 4-step ring of random rows."""
    rng = np.random.default_rng(seed)
    N, L, S, Hkv, D, bs, mb = 3, 2, 4, 2, 8, 4, 4
    nb = N * mb + 1
    walk = np.array([5, 0, mb * bs], np.int32)
    arrays = dict(
        x0=rng.standard_normal((N, 32)).astype(np.float32),
        k_pool=rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32),
        v_pool=rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32),
        ring_k=rng.standard_normal((L, N, S, Hkv, D)).astype(np.float32),
        ring_v=rng.standard_normal((L, N, S, Hkv, D)).astype(np.float32))
    ints = dict(block_table=rng.permutation(np.arange(1, nb))
                .reshape(N, mb).astype(np.int32),
                walk_lens=walk, lens=walk + 2)
    return dict(t=t), arrays, ints


@pytest.mark.parametrize("t", [0, 2])
@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_plain_step_matches_jax_mega_decode_step(name, tol, t):
    """The hidden state and both rings after one step of all layers: f32
    within 1e-5 (absolute; values are O(1)), bf16 within 2e-2 of the
    largest magnitude (the two frameworks round the same bf16 products
    from sums taken in another order). Ring rows of other steps stay."""
    jcfg, jp, tcfg, tp = _models(name)
    jdt, tdt = DTYPES[name]
    static, arrays, ints = _step_inputs(7 + t, t)
    want = jax_mega_step(
        jp, jcfg, **static, **{k: jnp.asarray(v, jdt)
                               for k, v in arrays.items()},
        **{k: jnp.asarray(v) for k, v in ints.items()})
    got = tmd.mega_decode_step(
        tp, tcfg, **static, **{k: torch.as_tensor(v).to(tdt)
                               for k, v in arrays.items()},
        **{k: torch.as_tensor(v) for k, v in ints.items()})
    for g, w, what in zip(got, want, ("x", "ring_k", "ring_v")):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, what
        if name == "f32":
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=what)
        else:
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), what
    ring_in = torch.as_tensor(arrays["ring_k"]).to(tdt)
    keep = [s for s in range(ring_in.shape[2]) if s != t]
    assert torch.equal(got[1][:, :, keep], ring_in[:, :, keep])


def test_mega_supported_reasons(model):
    """The screen passes the tiny f32 model only where the CUDA kernel's
    limits allow it, and names each refusal."""
    _, _, tcfg, tp = model
    kw = dict(n_slots=2, n_steps=3, block_size=8, kv_int8=False)
    # head_dim 8 is outside the kernel's (64, 128)
    assert tmd.mega_supported(tp, tcfg, **kw) == (False, "head_dim")
    cfg = dataclasses.replace(tl.tiny_llama(hidden=256, heads=4, kv_heads=2,
                                            ffn=512), dtype=torch.float32)
    params = tl.init_params(cfg, seed=0, device="cpu")
    assert tmd.mega_supported(params, cfg, **kw) == (True, "ok")

    # a mapping of mesh dim sizes (a DeviceMesh is read the same way:
    # tests/test_torch_tp_serving.py)
    assert tmd.mega_supported(params, cfg, mesh={"tp": 2}, **kw) \
        == (False, "mesh")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmd.mega_supported(params, cfg, mesh=object(), **kw)
    q8 = {"q": torch.zeros(1, dtype=torch.int8), "s": torch.ones(1)}
    lay = params["layers"]
    mixed = dict(params, layers=dict(lay, wq=q8))
    assert tmd.mega_supported(mixed, cfg, **kw) == (False, "mixed_weights")
    # int8 weights (quantize_params' layout) and int8 pools are taken
    int8 = tl.quantize_params(params)
    assert tmd.mega_supported(int8, cfg, **kw) == (True, "ok")
    assert tmd.mega_supported(params, cfg, **dict(kw, kv_int8=True)) \
        == (True, "ok")
    # the multi-step form (the speculative draft) screens its head too
    assert tmd.mega_supported(params, cfg, multi_step=True, **kw) \
        == (True, "ok")
    assert tmd.mega_supported(int8, cfg, multi_step=True, **kw) \
        == (True, "ok")
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    assert tmd.mega_supported(params, tied, multi_step=True, **kw) \
        == (True, "ok")
    half = dict(params, embed=params["embed"].to(torch.bfloat16))
    assert tmd.mega_supported(half, cfg, multi_step=True, **kw) \
        == (False, "head_dtype")
    odd_vocab = dataclasses.replace(cfg, vocab_size=250)
    odd = dict(params, embed=params["embed"][:250],
               lm_head=params["lm_head"][:, :250])
    assert tmd.mega_supported(odd, odd_vocab, multi_step=True, **kw) \
        == (False, "head_width")
    assert tmd.mega_supported(odd, dataclasses.replace(
        odd_vocab, tie_embeddings=True), multi_step=True, **kw) == (True, "ok")
    assert tmd.mega_supported(params, cfg, multi_step=True,
                              **dict(kw, n_steps=0)) == (False, "steps")
    assert tmd.mega_supported(params, cfg, **dict(kw, n_slots=9)) \
        == (False, "slots")
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    assert tmd.mega_supported(params, bf16, **kw) == (False, "dtype")
    wide = dataclasses.replace(cfg, num_heads=18, num_kv_heads=2)
    assert tmd.mega_supported(params, wide, **kw) == (False, "group")
    odd = dataclasses.replace(cfg, intermediate_size=500)
    assert tmd.mega_supported(params, odd, **kw) == (False, "width")
    assert tmd._smem_bytes(4, 128, 8) <= tmd.SMEM_LIMIT


def _prompts(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(k)).tolist()
            for k in rng.integers(3, 20, size=n)]


def _port_streams(tp, tcfg, kernel, prompts, decode_steps, monkeypatch):
    eng = LLMEngine(tp, tcfg, decode_steps=decode_steps, decode_kernel=kernel,
                    device="cpu", **ENGINE)
    preempted = []
    free_slot = eng._free_slot

    def counting_free_slot(slot, requeue=False):
        preempted.append(requeue)
        return free_slot(slot, requeue)

    monkeypatch.setattr(eng, "_free_slot", counting_free_slot)
    ids = [eng.add_request(p, max_new_tokens=16) for p in prompts]
    out = eng.run()
    assert any(preempted), "the pool was meant to force a preemption"
    assert eng.block_accounting() == {
        "total": 6, "free": 6, "backed": 0, "cached": 0, "squeezed": 0,
        "in_flight": 0, "host_spilled_blocks": 0, "swapped_host_blocks": 0}
    return [out[i] for i in ids], eng


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_mega_streams_equal_ragged_and_jax_mega(model, decode_steps,
                                                monkeypatch):
    """Greedy streams, f32, more requests than slots and a pool small
    enough to preempt: the port's mega engine, its ragged engine and the
    JAX engine's mega path (interpret mode) agree token for token."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts()
    jax_eng = JaxEngine(jp, jcfg, decode_steps=decode_steps,
                        decode_kernel="mega", **ENGINE)
    jids = [jax_eng.add_request(p, max_new_tokens=16) for p in prompts]
    jout = jax_eng.run()
    want = [jout[j] for j in jids]
    # the tiny model's head_dim 8 is outside the CUDA kernel's screen; the
    # plain version takes any head_dim, so let the screen pass here
    monkeypatch.setattr(teng, "mega_supported", lambda *a, **k: (True, "ok"))
    mega, eng = _port_streams(tp, tcfg, "mega", prompts, decode_steps,
                              monkeypatch)
    ragged, _ = _port_streams(tp, tcfg, "ragged", prompts, decode_steps,
                              monkeypatch)
    assert dict(eng.decode_paths) == {"mega": eng.decode_paths["mega"]}
    assert not eng.mega_fallbacks
    assert mega == ragged == want


def test_mega_fallback_counted_never_silent(model, monkeypatch):
    """A mega pick the screen refuses decodes through the ragged path and
    is counted by reason — and the streams are unchanged."""
    _, _, tcfg, tp = model
    prompts = _prompts(seed=2, n=3)
    ref, _ = _port_streams(tp, tcfg, "ragged", prompts, 3, monkeypatch)
    monkeypatch.setattr(teng, "mega_supported",
                        lambda *a, **k: (False, "smem"))
    out, eng = _port_streams(tp, tcfg, "mega", prompts, 3, monkeypatch)
    calls = eng.decode_paths["ragged"]
    assert calls >= 1 and eng.decode_paths["mega"] == 0
    assert eng.mega_fallbacks == {"smem": calls}
    assert out == ref


def test_auto_on_the_cpu_never_picks_mega(model, monkeypatch):
    """``"auto"`` picks mega only on the card (at <= 4 slots): on the CPU
    it decodes through the ragged path, screen or no screen, and counts
    no fallback."""
    _, _, tcfg, tp = model
    monkeypatch.setattr(teng, "mega_supported", lambda *a, **k: (True, "ok"))
    eng = LLMEngine(tp, tcfg, device="cpu", **ENGINE)
    assert eng.decode_kernel == "auto" and eng._decode_path() == "ragged"
    eng.add_request(list(range(1, 6)), max_new_tokens=4)
    eng.run()
    assert dict(eng.decode_paths) == {"ragged": eng.decode_paths["ragged"]}
    assert not eng.mega_fallbacks
