"""The port's CUDA kernels held to their plain PyTorch versions on the card.

These tests need an NVIDIA Hopper card and skip without one. They import
neither jax nor paddle_tpu, so on the card they run without the
repository's conftest (which sets up jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import pallas_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,causal,D", [(100, True, 128), (128, False, 128),
                                        (200, True, 64), (257, False, 64)])
def test_flash_kernel_matches_plain(dev, dtype, tol, S, causal, D):
    """Ragged S (not a multiple of the 64-row tile) and GQA (8 query heads
    over 2 kv heads) included."""
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((2, S, 8, D), (2, S, 2, D), (2, S, 2, D)))
    before = _build.launch_counts["flash_fwd"]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,G,d,lens", [
    (64, 4, 128, [0, 1, 64, 1000]),
    (16, 8, 64, [0, 128, 63, 1024]),
    (32, 1, 128, [0, 65, 191, 1000])])
def test_ragged_kernel_matches_plain(dev, dtype, bs, G, d, lens):
    """Lengths 0, 1, one exact block or tile, and long partial walks up to
    the full table; block sizes 16, 32 and 64 under the kernel's
    64-position tile; G of 1, 4 and 8; layer 1 of a two-layer pool."""
    rng = np.random.default_rng(7)
    L, hkv, mb = 2, 2, 1024 // bs
    NB = 4 * mb + 1
    g = torch.Generator(device=dev).manual_seed(0)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:4 * mb]
                            .reshape(4, mb).astype(np.int32), device=dev)
    kp = torch.randn(L, NB, bs, hkv, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(L, NB, bs, hkv, d, generator=g, device=dev).to(dtype)
    q = torch.randn(4, G * hkv, d, generator=g, device=dev).to(dtype)
    acc, m, l = tpa.ragged_decode_partial(q, kp, vp, table, lens, layer=1)
    racc, rm, rl = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens, 1)
    torch.cuda.synchronize()
    assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == -1e30)
    if dtype == torch.float32:
        for got, want in ((acc, racc), (m, rm), (l, rl)):
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * max(1.0, want.abs().max().item())
    out = acc[1:] / l[1:, ..., None]
    ref = racc[1:] / rl[1:, ..., None]
    assert (out - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
