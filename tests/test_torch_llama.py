"""The port's Llama model (paddle_tpu_torch.models.llama) held to the JAX
reference (paddle_tpu.models.llama) on the CPU: the same numpy-made
weights and tokens go through both packages."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=64, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=128)


def _configs(jdt, tdt):
    return (dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jdt),
            dataclasses.replace(tl.tiny_llama(**SIZES), dtype=tdt))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs(jnp.float32, torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def test_params_from_numpy_round_trip(weights):
    """Keys, shapes and dtypes carry over; values are bit-identical in f32
    and rounded once in bf16 (also from a bf16 JAX tree)."""
    _, tree = weights
    tp = tl.params_from_numpy(tree, device="cpu")
    assert set(tp) == {"embed", "layers", "final_norm", "lm_head"}
    assert set(tp["layers"]) == set(tree["layers"])
    for k in ("embed", "final_norm", "lm_head"):
        assert tuple(tp[k].shape) == tree[k].shape
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), tree[k])
    for k, a in tree["layers"].items():
        assert tuple(tp["layers"][k].shape) == a.shape
        np.testing.assert_array_equal(tp["layers"][k].numpy(), a)
    tb = tl.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tb["layers"].values())
    jb = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    tb2 = tl.params_from_numpy(jb, device="cpu")
    assert tb2["lm_head"].dtype == torch.bfloat16
    assert torch.equal(tb2["lm_head"], tb["lm_head"])
    assert tl.num_params(tp) == jl.num_params(weights[0])


def test_init_params_matches_reference_shapes():
    jcfg, tcfg = _configs(jnp.float32, torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tl.init_params(tcfg, seed=1, device="cpu", dtype=torch.bfloat16)
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    for k, a in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == a.shape
        assert tp["layers"][k].dtype == torch.bfloat16
    assert torch.all(tp["final_norm"] == 1)
    again = tl.init_params(tcfg, seed=1, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])


def test_forward_logits_match_reference_f32(weights):
    jp, tree = weights
    jcfg, tcfg = _configs(jnp.float32, torch.float32)
    toks = np.random.default_rng(0).integers(0, 64, (2, 24)).astype(np.int32)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    got = tl.forward(tl.params_from_numpy(tree, device="cpu"),
                     torch.as_tensor(toks), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_forward_logits_match_reference_bf16(weights):
    """bf16 compute: the two frameworks round at different places (the
    reference's non-flash attention keeps its scores in bf16, the port
    scores in f32), so logits agree to a few bf16 ulps of their ~3.5
    magnitude — 5e-2, not the f32 bound."""
    jp, tree = weights
    jcfg, tcfg = _configs(jnp.bfloat16, torch.bfloat16)
    toks = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks), jcfg))
    got = tl.forward(tl.params_from_numpy(tree, device="cpu"),
                     torch.as_tensor(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)


def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        tl._rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5).numpy(),
        np.asarray(jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6, rtol=0)
    cj, sj = jl._rope_tables(8, 16, 500000.0)
    ct, st = tl._rope_tables(8, 16, 500000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(
        tl._apply_rope(torch.as_tensor(x), ct, st).numpy(),
        np.asarray(jl._apply_rope(jnp.asarray(x), cj, sj)), atol=1e-6)
    # per-row positions: row b starts at offset[b]
    offset = np.array([0, 5], np.float32)
    freq = 500000.0 ** (-np.arange(0, 16, 2, dtype=np.float32) / 16)
    ang = (offset[:, None] + np.arange(8, dtype=np.float32))[..., None] \
        * freq
    cos, sin = np.cos(ang), np.sin(ang)
    np.testing.assert_allclose(
        tl._apply_rope_at(torch.as_tensor(x), torch.as_tensor(cos),
                          torch.as_tensor(sin)).numpy(),
        np.asarray(jl._apply_rope_at(jnp.asarray(x), jnp.asarray(cos),
                                     jnp.asarray(sin))), atol=1e-6)
