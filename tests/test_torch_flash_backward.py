"""The port's FlashAttention-2 backward (paddle_tpu_torch.kernels.
pallas_attention: flash_attention_bwd and the differentiable
flash_attention) held to the JAX package's custom_vjp, whose Pallas
kernels run in interpret mode on the CPU. On CPU tensors the port runs its
plain versions; the CUDA kernels (B2, B3) are held to those plain versions
in test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.kernels.pallas_attention import flash_attention_fwd as jflash
from paddle_tpu_torch.kernels import pallas_attention as tpa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _inputs(seed, B, S, Hq, Hkv, D, dtype=np.float32):
    """q, k, v and an output gradient, made with numpy."""
    rng = np.random.default_rng(seed)
    return tuple((0.5 * rng.standard_normal(shape)).astype(dtype)
                 for shape in ((B, S, Hq, D), (B, S, Hkv, D),
                               (B, S, Hkv, D), (B, S, Hq, D)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1), (6, 2)])
@pytest.mark.parametrize("S", [128, 256])
def test_plain_backward_matches_pallas_vjp(S, hq, hkv, causal):
    """dq, dk, dv of the plain backward against jax.vjp of the JAX flash
    attention (its _dq_kernel and _dkv_kernel): the GQA groups (8, 1) and
    (6, 2) catch a query head read from kv head h % Hkv instead of h // G.
    f32, tolerance atol 5e-5 / rtol 5e-4 as tests/test_flash_gqa.py."""
    q, k, v, do = _inputs(S + hq + causal, 2, S, hq, hkv, 128)
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    out, lse = tpa.flash_attention_fwd(tq, tk, tv, causal)
    got = tpa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradcheck_f64(causal):
    """The differentiable function's backward is the derivative of its
    forward: torch.autograd.gradcheck in f64 (the plain versions compute
    in f64 for f64 inputs), GQA 4 query heads over 2 kv heads."""
    q, k, v, _ = _inputs(11, 1, 16, 4, 2, 8, np.float64)
    args = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tpa.flash_attention.apply(a, b, c, causal), args)


def test_flash_attention_apply_matches_forward_and_backward():
    """flash_attention.apply returns the forward's output, and its
    gradients are flash_attention_bwd's."""
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(5, 2, 24, 4, 2, 16))
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = tpa.flash_attention.apply(qa, ka, va, True)
    ref, lse = tpa.flash_attention_fwd(q, k, v, True)
    assert torch.equal(out.detach(), ref)
    out.backward(do)
    for got, want in zip((qa.grad, ka.grad, va.grad),
                         tpa.flash_attention_bwd(q, k, v, ref, lse, do,
                                                 True)):
        assert torch.equal(got, want)


def test_backward_wrapper_rejects_bad_shapes_and_dtypes():
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(3, 1, 8, 4, 2, 16))
    out, lse = tpa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):          # dout of the wrong shape
        tpa.flash_attention_bwd(q, k, v, out, lse, do[:, :4])
    with pytest.raises(ValueError):          # lse of the wrong shape
        tpa.flash_attention_bwd(q, k, v, out, lse[:, :2], do)
    with pytest.raises(ValueError):          # k/v do not divide q's heads
        tpa.flash_attention_bwd(q[:, :, :3], k, v, out[:, :, :3],
                                lse[:, :3], do[:, :, :3])
    with pytest.raises(TypeError):           # dout in another dtype
        tpa.flash_attention_bwd(q, k, v, out, lse, do.double())
    with pytest.raises(ValueError):          # not a CPU or CUDA tensor
        tpa.flash_attention_bwd(*(t.to("meta")
                                  for t in (q, k, v, out, lse, do)))
    B, S, H, _ = q.shape
    delta = torch.empty(B, H, S)
    with pytest.raises(ValueError):          # out of the wrong shape
        tpa.flash_dq(q, k, v, do, lse, delta, out=out[:, :4])
    with pytest.raises(TypeError):           # out in another dtype
        tpa.flash_dq(q, k, v, do, lse, delta, out=out.double())
    with pytest.raises(ValueError):          # a Delta buffer of the wrong shape
        tpa.flash_dq(q, k, v, do, lse, delta[:, :2], out=out)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_dq_given_out_fills_delta(causal):
    """flash_dq given the forward's ``out`` (the card's fused-Delta form)
    writes Delta = rowsum(out * dout) into its ``delta`` buffer and returns
    the dq of the explicit-Delta form; flash_attention_bwd's gradients are
    the same either way."""
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(9, 2, 40, 6, 2, 16))
    out, lse = tpa.flash_attention_fwd(q, k, v, causal)
    want_delta = tpa._delta(out, do)
    delta = torch.full_like(want_delta, float("nan"))
    dq = tpa.flash_dq(q, k, v, do, lse, delta, causal, out=out)
    assert torch.equal(delta, want_delta)
    assert torch.equal(dq, tpa.flash_dq(q, k, v, do, lse, want_delta,
                                        causal))
    dk, dv = tpa.flash_dkv(q, k, v, do, lse, delta, causal)
    for got, want in zip((dq, dk, dv), tpa.flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal)):
        assert torch.equal(got, want)
