"""The port's FlashAttention-2 forward (paddle_tpu_torch.kernels.
pallas_attention) held to the JAX Pallas kernel, which runs in interpret
mode on the CPU. On CPU tensors the port runs its plain version; the CUDA
kernel is held to that plain version in test_torch_kernels_cuda.py."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax.numpy as jnp

from paddle_tpu.kernels.pallas_attention import flash_attention_fwd as jflash
from paddle_tpu_torch.kernels import pallas_attention as tpa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _inputs(seed, B, S, Hq, Hkv, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype)
                 for shape in ((B, S, Hq, D), (B, S, Hkv, D),
                               (B, S, Hkv, D)))


def _lse_reference(q, k, causal):
    """log-sum-exp of each query row's scaled scores, in float64."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    kk = np.repeat(k.astype(np.float64), G, axis=2)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) / math.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    mx = s.max(-1, keepdims=True)
    return (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [128, 256])
def test_plain_matches_pallas_kernel(S, causal):
    q, k, v = _inputs(S + causal, 1, S, 4, 2, 128)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal))
    out, lse = tpa.flash_attention_fwd(torch.as_tensor(q),
                                       torch.as_tensor(k),
                                       torch.as_tensor(v), causal)
    assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)
    assert tuple(lse.shape) == (1, 4, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _lse_reference(q, k, causal),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("S,Hq,Hkv,D,causal", [
    (100, 2, 1, 128, True), (200, 2, 2, 128, False),
    (100, 2, 2, 64, True), (200, 4, 2, 64, False)])
def test_plain_matches_pallas_kernel_at_edges(S, Hq, Hkv, D, causal):
    """The edges of the Hopper kernel's tiles the plain version stands for
    on the CPU: ragged S (100 and 200, not a multiple of its 128-row tiles
    or the 64-row ones before), Hq = Hkv (DeepSeekMoE's 16/16) and D = 64
    (the spec draft's), against the JAX kernel in interpret mode; f32
    within 1e-4, lse against a float64 reference."""
    q, k, v = _inputs(S + 10 * Hq + D, 1, S, Hq, Hkv, D)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal))
    out, lse = tpa.flash_attention_fwd(torch.as_tensor(q),
                                       torch.as_tensor(k),
                                       torch.as_tensor(v), causal)
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _lse_reference(q, k, causal),
                               atol=1e-4, rtol=0)


def test_plain_gqa_maps_query_head_to_kv_head_by_division():
    """Query head h reads kv head h // G: zeroing kv head 1 must change
    exactly query heads 2 and 3 (the repeat-interleave convention)."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(7, 1, 16, 4, 2, 64))
    base, _ = tpa.flash_attention_fwd(q, k, v)
    v2 = v.clone()
    v2[:, :, 1] = 0
    out, _ = tpa.flash_attention_fwd(q, k, v2)
    changed = (out - base).abs().amax(dim=(0, 1, 3)) > 0
    assert changed.tolist() == [False, False, True, True]


def test_wrapper_rejects_unsupported_device_and_shapes():
    q, k, v = (torch.as_tensor(a) for a in _inputs(3, 1, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        tpa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        tpa.flash_attention_fwd(q, k[:, :, :, :8], v)
