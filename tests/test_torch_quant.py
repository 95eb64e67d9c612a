"""The port's int8 quantization (paddle_tpu_torch.kernels.quant_matmul,
llama.quantize_params) and the plain version of B4's int8 branch held to
the JAX package on the CPU, on the same numpy-made inputs:

- the quantizers exactly (int8 values and scales equal);
- the dequantizers, ``weight_only_matmul``, ``attn_qk`` and ``attn_pv``
  within 1e-5 (f32; values are O(1));
- ``params_from_numpy`` on an int8 tree (int8 and bf16 leaves untouched);
- the plain ragged decode over int8 pools against the JAX
  ``ragged_decode_partial`` (Pallas in interpret mode) within 1e-5.

The CUDA kernels are held to the plain versions in
test_torch_kernels_cuda.py.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.kernels import quant_matmul as jqm
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.models import llama as tl
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the module (the package's __init__ shadows it with its function)
jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if a.dtype == jnp.bfloat16 else np.asarray(a)


def _t2n(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_equals_jax_exactly(dtype):
    """Per-entry int8 K/V: int8 values and f32 scales equal, an all-zero
    entry included (its scale 0, its values 0)."""
    x = _rand(0, (3, 5, 2, 16))
    x[1, 2, 0] = 0.0
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jq, js = jqm.quantize_kv(jnp.asarray(x, jdt))
    tq, ts = tqm.quantize_kv(torch.as_tensor(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape,axis", [((4, 16, 24), 1), ((4, 24, 16), 2),
                                        ((3, 4, 16, 24), 2),
                                        ((3, 4, 24, 16), 3)])
def test_quantize_grouped_equals_jax_exactly(shape, axis, monkeypatch):
    """Grouped per-channel int8 (the expert weights, stacked or not):
    values and scales equal; with the slice size cut to one leading index
    the sliced path gives the same leaf."""
    w = _rand(1, shape, 0.1)
    want = jqm.quantize_grouped(jnp.asarray(w), axis)
    for slice_elems in (tqm._SLICE_ELEMS, 1):
        monkeypatch.setattr(tqm, "_SLICE_ELEMS", slice_elems)
        got = tqm.quantize_grouped(torch.as_tensor(w), axis)
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("slice_elems", [None, 1])
def test_quantize_params_equals_jax_exactly(slice_elems, monkeypatch):
    """llama.quantize_params: every matrix and the head as {int8, bf16
    scales} equal to the JAX package's (clip to [-128, 127]); norms and
    the embedding untouched; also with leading-axis slices."""
    if slice_elems is not None:
        monkeypatch.setattr(tqm, "_SLICE_ELEMS", slice_elems)
    cfg = jl.tiny_llama(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2,
                        ffn=64)
    jp = jl.init_params(cfg, jax.random.PRNGKey(3))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    want = jl.quantize_params(jp)
    got = tl.quantize_params(tp)
    for k in tl._QUANT_KEYS:
        g, w = got["layers"][k], want["layers"][k]
        assert g["q"].dtype == torch.int8 and g["s"].dtype == torch.bfloat16
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(w["q"]))
        np.testing.assert_array_equal(_t2n(g["s"]), _np(w["s"]))
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(),
                                  np.asarray(want["lm_head"]["q"]))
    np.testing.assert_array_equal(_t2n(got["lm_head"]["s"]),
                                  _np(want["lm_head"]["s"]))
    assert got["embed"] is tp["embed"]
    assert got["layers"]["attn_norm"] is tp["layers"]["attn_norm"]
    assert "lm_head" not in tl.quantize_params(
        {k: v for k, v in tp.items() if k != "lm_head"})
    assert torch.equal(tl.quantize_params(tp, include_lm_head=False)
                       ["lm_head"], tp["lm_head"])


def test_dequantize_and_wmat_match_jax():
    """dequantize_channels / _grouped / _kv and llama._wmat within 1e-5."""
    w = _rand(2, (4, 16, 24), 0.1)
    jg = jqm.quantize_grouped(jnp.asarray(w), 1)
    tg = tqm.quantize_grouped(torch.as_tensor(w), 1)
    np.testing.assert_allclose(
        tqm.dequantize_grouped(tg, 1, torch.float32).numpy(),
        np.asarray(jqm.dequantize_grouped(jg, 1, jnp.float32)), atol=1e-5)
    x = _rand(3, (6, 2, 16))
    jq, js = jqm.quantize_kv(jnp.asarray(x))
    tq, ts = tqm.quantize_kv(torch.as_tensor(x))
    np.testing.assert_allclose(
        tqm.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jqm.dequantize_kv(jq, js, jnp.float32)), atol=1e-5)
    np.testing.assert_allclose(
        tqm.dequantize_channels(tq, ts, -1).numpy(),
        np.asarray(jqm.dequantize_channels(jq, js, -1)), atol=1e-5)
    p = {"wq": _rand(4, (2, 16, 8))}
    jw = jl.quantize_params({"layers": {"wq": jnp.asarray(p["wq"])}})
    tw = tl.quantize_params({"layers": {"wq": torch.as_tensor(p["wq"])}})
    np.testing.assert_allclose(
        tl._wmat(tw["layers"], "wq", torch.float32).numpy(),
        np.asarray(jl._wmat(jw["layers"], "wq", jnp.float32)), atol=1e-5)
    np.testing.assert_allclose(
        tl._wmat({"wq": torch.as_tensor(p["wq"])}, "wq",
                 torch.float32).numpy(), p["wq"], atol=0)
    assert tqm.mixed_dot_supported()
    assert tqm.is_quantized_weight(tw["layers"]["wq"])
    assert not tqm.is_quantized_weight(torch.as_tensor(p["wq"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_only_matmul_matches_jax(dtype):
    """int8 leaves: f32 sums, per-channel scale, one rounding to the out
    dtype — within 1e-5 of the largest magnitude in f32, and one bf16
    step (2^-8 relative) in bf16; dense leaves as ``x @ w``."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    w = _rand(5, (32, 24), 0.2)
    x = _rand(6, (3, 5, 32))
    jw = jl.quantize_params({"layers": {"wq": jnp.asarray(w)}})["layers"]
    tw = tl.quantize_params({"layers": {"wq": torch.as_tensor(w)}})["layers"]
    for jleaf, tleaf in ((jw["wq"], tw["wq"]),
                         (jnp.asarray(w), torch.as_tensor(w))):
        want = _np(jqm.weight_only_matmul(jnp.asarray(x, jdt), jleaf, jdt))
        got = tqm.weight_only_matmul(torch.as_tensor(x).to(tdt), tleaf, tdt)
        assert got.dtype == tdt and got.shape == want.shape
        tol = 1e-5 if dtype == "f32" else 2 ** -8
        np.testing.assert_allclose(_t2n(got), want,
                                   atol=tol * np.abs(want).max())


@pytest.mark.parametrize("int8", [True, False])
def test_attn_qk_pv_match_jax(int8):
    """The decode contractions over gathered (int8) prefixes within
    1e-5: scores with the K scale, PV with the V scale folded into the
    probabilities (dense pools: the probabilities rounded to the out
    dtype first)."""
    N, P, Hkv, G, D = 2, 12, 2, 3, 16
    qg = _rand(7, (N, Hkv, G, D))
    k = _rand(8, (N, P, Hkv, D))
    v = _rand(9, (N, P, Hkv, D))
    p = np.abs(_rand(10, (N, Hkv, G, P)))
    if int8:
        jk, jks = jqm.quantize_kv(jnp.asarray(k))
        jv, jvs = jqm.quantize_kv(jnp.asarray(v))
        tk, tks = tqm.quantize_kv(torch.as_tensor(k))
        tv, tvs = tqm.quantize_kv(torch.as_tensor(v))
    else:
        jk, jks, jv, jvs = jnp.asarray(k), None, jnp.asarray(v), None
        tk, tks, tv, tvs = torch.as_tensor(k), None, torch.as_tensor(v), None
    np.testing.assert_allclose(
        tqm.attn_qk(torch.as_tensor(qg), tk, tks).numpy(),
        np.asarray(jqm.attn_qk(jnp.asarray(qg), jk, jks)), atol=1e-5)
    np.testing.assert_allclose(
        tqm.attn_pv(torch.as_tensor(p), tv, tvs,
                    out_dtype=torch.float32).numpy(),
        np.asarray(jqm.attn_pv(jnp.asarray(p), jv, jvs,
                               out_dtype=jnp.float32)), atol=1e-5)


def test_params_from_numpy_carries_int8_leaves():
    """A JAX int8 tree crosses over: q stays int8, s stays bf16, and
    ``dtype=`` casts only the dense leaves."""
    cfg = jl.tiny_llama(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2,
                        ffn=64)
    jq = jl.quantize_params(jl.init_params(cfg, jax.random.PRNGKey(4)))
    tree = jax.tree_util.tree_map(np.asarray, jq)
    got = tl.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    for k in tl._QUANT_KEYS:
        g, w = got["layers"][k], tree["layers"][k]
        assert g["q"].dtype == torch.int8 and g["s"].dtype == torch.bfloat16
        np.testing.assert_array_equal(g["q"].numpy(), w["q"])
        np.testing.assert_array_equal(_t2n(g["s"]), w["s"].astype(np.float32))
    assert got["embed"].dtype == torch.bfloat16
    assert got["layers"]["attn_norm"].dtype == torch.bfloat16
    assert got["lm_head"]["q"].dtype == torch.int8
    # int8 trees move between devices leaf by leaf
    assert all(t.device.type == "cpu" for _p, t in
               __import__("paddle_tpu_torch.serving.engine",
                          fromlist=["_tensors"])._tensors(got))


def _int8_walk_inputs(seed, bs=4, mb=4):
    """3 slots over [L=2, NB, bs, Hkv=2, D=8] int8 pools with f32 scales:
    lengths 0, a partial block and the full table."""
    rng = np.random.default_rng(seed)
    N, L, Hkv, D, G = 3, 2, 2, 8, 2
    nb = N * mb + 1
    kp = rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32)
    qk, sk = jqm.quantize_kv(jnp.asarray(kp))
    qv, sv = jqm.quantize_kv(jnp.asarray(vp))
    q = rng.standard_normal((N, Hkv * G, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, nb)).reshape(N, mb).astype(np.int32)
    lens = np.array([0, bs + 2, mb * bs], np.int32)
    return [np.asarray(a) for a in (q, qk, qv, table, lens, sk, sv)]


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_int8_ragged_matches_jax(layer):
    """The plain ragged partial over int8 pools against the JAX kernel
    (interpret mode): acc, m, l within 1e-5; a length-0 slot gives
    (0, -1e30, 0)."""
    q, kp, vp, table, lens, ks, vs = _int8_walk_inputs(11)
    want = jpa.ragged_decode_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), layer=layer, ks_pool=jnp.asarray(ks),
        vs_pool=jnp.asarray(vs))
    got = tpa.ragged_decode_partial(
        *(torch.as_tensor(a) for a in (q, kp, vp, table, lens)), layer=layer,
        ks_pool=torch.as_tensor(ks), vs_pool=torch.as_tensor(vs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    assert torch.all(got[0][0] == 0) and torch.all(got[2][0] == 0)
    assert torch.all(got[1][0] == -1e30)
    cache = tpa.PagedKVCache(*(torch.as_tensor(a)
                               for a in (kp, vp, table, lens)))
    jcache = jpa.PagedKVCache(*(jnp.asarray(a) for a in (kp, vp, table,
                                                         lens)))
    np.testing.assert_allclose(
        tpa.ragged_paged_decode(torch.as_tensor(q), cache, layer,
                                torch.as_tensor(ks),
                                torch.as_tensor(vs)).numpy(),
        np.asarray(jpa.ragged_paged_decode(jnp.asarray(q), jcache, layer,
                                           jnp.asarray(ks), jnp.asarray(vs))),
        atol=1e-5)
