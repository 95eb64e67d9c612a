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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,causal,D,hq,hkv", [
    (100, True, 128, 8, 2), (128, False, 128, 8, 1), (200, True, 64, 6, 2),
    (257, False, 64, 4, 4), (300, True, 128, 6, 2)])
def test_flash_backward_kernels_match_plain(dev, dtype, tol, S, causal, D,
                                            hq, hkv):
    """B2 (dQ) and B3 (dK/dV) against their plain versions, each gradient
    within ``tol`` of its largest magnitude: ragged S, GQA groups of 4, 8,
    3 and 1 (a query head read from kv head h % Hkv instead of h // G
    fails the (8, 1) and (6, 2) cases)."""
    g = torch.Generator(device=dev).manual_seed(S + hq)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((2, S, hq, D), (2, S, hkv, D),
                                 (2, S, hkv, D), (2, S, hq, D)))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    before = (_build.launch_counts["flash_dq"],
              _build.launch_counts["flash_dkv"])
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (_build.launch_counts["flash_dq"],
            _build.launch_counts["flash_dkv"]) == (before[0] + 1,
                                                   before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)


def test_flash_attention_gradients_are_the_derivative(dev):
    """The kernels' f32 gradients against torch.autograd through a dense
    f32 attention (repeated K/V, softmax), within 1e-3 relative."""
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   for shape in ((2, 256, 6, 128), (2, 256, 2, 128),
                                 (2, 256, 2, 128), (2, 256, 6, 128)))
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention.apply(*args, True).backward(do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kk, vv = (t.repeat_interleave(3, dim=2) for t in ref[1:])
    s = torch.einsum("bshd,bthd->bhst", ref[0], kk) / 128 ** 0.5
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool,
                                  device=dev).tril(), float("-inf"))
    torch.einsum("bhst,bthd->bshd", s.softmax(-1), vv).backward(do)
    for a, b in zip(args, ref):
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 1e-3 * b.grad.abs().max().item()


@pytest.mark.parametrize("policy,fwd_per_layer", [("full", 2), ("attn", 1)])
def test_remat_policies_launch_b1_as_their_policy_says(dev, policy,
                                                       fwd_per_layer):
    """A bf16 train step of a 2-layer model on the card: B2 and B3 launch
    once a layer; B1 twice under "full" (again in the backward pass) and
    once under "attn" (its outputs kept); both give the loss of no remat
    and its bf16 grads within 1e-2 of each leaf's largest magnitude (the
    embedding's scatter-add may sum in another order)."""
    import dataclasses
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.optimizer.functional import tree_leaves
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=64,
                            max_seq_len=256, remat=False)
    params = llama.init_params(cfg, seed=0, device=dev,
                               dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, 512, (2, 257), generator=g, device=dev)
    loss0, grads0 = llama.loss_and_grads(params, toks, cfg)
    _build.launch_counts.clear()
    loss, grads = llama.loss_and_grads(
        params, toks, dataclasses.replace(cfg, remat=True,
                                          remat_policy=policy))
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {
        "flash_fwd": fwd_per_layer * 2, "flash_dq": 2, "flash_dkv": 2}
    assert loss.item() == loss0.item()
    for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert (a.float() - b.float()).abs().max().item() \
            <= 1e-2 * b.float().abs().max().item()
