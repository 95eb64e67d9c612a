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


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (6, 2), (8, 2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [1, 63, 64, 100, 129, 1000, 1024, 2048])
def test_flash_sm90_edges_match_plain(dev, S, causal, hq, hkv, D):
    """B1's bf16 Hopper kernel (128-row query and K/V tiles) against its
    plain version within 2e-2: S below, at and past one tile, ragged in
    the last tile and whole; GQA groups of 1, 3 and 4; D 64 and 128. Two
    calls agree bit for bit."""
    g = torch.Generator(device=dev).manual_seed(S + 7 * hq + D)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               .to(torch.bfloat16)
               for shape in ((1, S, hq, D), (1, S, hkv, D), (1, S, hkv, D)))
    before = _build.launch_counts["flash_fwd"]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    again, lse2 = tfa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == before + 2
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 2e-2
    assert torch.equal(out, again) and torch.equal(lse, lse2)


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
    before = _build.launch_counts["ragged_decode"]
    acc, m, l = tpa.ragged_decode_partial(q, kp, vp, table, lens, layer=1)
    racc, rm, rl = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens, 1)
    torch.cuda.synchronize()
    assert _build.launch_counts["ragged_decode"] == before + 1
    assert torch.all(acc[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(m[0] == -1e30)
    if dtype == torch.float32:
        for got, want in ((acc, racc), (m, rm), (l, rl)):
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * max(1.0, want.abs().max().item())
    out = acc[1:] / l[1:, ..., None]
    ref = racc[1:] / rl[1:, ..., None]
    assert (out - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


# Edge shapes of B4's split walk (csrc/ragged_decode.cu: 32-position tiles,
# 64 for f32 queries, dealt in equal ranges over a persistent grid, each
# block's range in four pairs' sub-ranges): (lengths, block size, G, D). One long slot (2000 positions and the
# full 2048-position table) spread over the whole grid; 64 short slots, more
# walks than blocks; lengths on tile edges (31, 32, 33, 63, 64, 65) and
# 0; block sizes 16, 32 and 64; G of 1, 4 and 8; D 64 and 128.
_SPLIT_EDGES = {
    "n1_2000": ([2000], 64, 4, 128),
    "n1_full": ([2048], 16, 8, 64),
    "short64": ([int(x) for x in np.random.default_rng(5).integers(
        0, 129, size=64)], 32, 4, 128),
    "tile_edges": ([31, 32, 33, 0, 63, 64, 65, 1], 16, 1, 128),
    "mixed": ([2000, 1, 0, 777, 128, 1500, 33, 64], 64, 8, 64),
}


def _split_case(dev, name, pools, qdtype, seed):
    lens, bs, G, d = _SPLIT_EDGES[name]
    rng = np.random.default_rng(seed)
    N, hkv, mb = len(lens), 2, 2048 // bs
    need = [-(-x // bs) for x in lens]
    nb = sum(need) + 1
    table = np.zeros((N, mb), np.int32)
    ids, at = rng.permutation(np.arange(1, nb)), 0
    for i, k in enumerate(need):
        table[i, :k] = ids[at:at + k]
        at += k
    g = torch.Generator(device=dev).manual_seed(seed)
    kp = torch.randn(2, nb, bs, hkv, d, generator=g, device=dev)
    vp = torch.randn(2, nb, bs, hkv, d, generator=g, device=dev)
    scales = {}
    if pools == "int8":
        kp, vp, ks, vs = _int8_pools(kp, vp)
        scales = dict(ks_pool=ks, vs_pool=vs)
    else:
        kp, vp = kp.to(qdtype), vp.to(qdtype)
    q = torch.randn(N, G * hkv, d, generator=g, device=dev).to(qdtype)
    return (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev)), scales


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pools", ["dense", "int8"])
@pytest.mark.parametrize("name", list(_SPLIT_EDGES))
def test_ragged_split_edges_match_plain(dev, name, pools, qdtype):
    """B4 at its split walk's edge shapes, both pool forms, bf16 and f32
    queries, layer 1 of two, against its plain version: dense bf16 pools
    within 1e-2 of the normalized output's largest magnitude; f32 pools
    and int8 pools (exact rows, unrounded probabilities) acc, m and l
    within 1e-5 of their largest magnitude. One launch a call; two calls
    agree bit for bit; a length-0 slot gives (0, -1e30, 0)."""
    args, scales = _split_case(dev, name, pools, qdtype, seed=len(name))
    key = "ragged_decode_int8" if pools == "int8" else "ragged_decode"
    before = _build.launch_counts[key]
    got = [t.clone() for t in tpa.ragged_decode_partial(*args, layer=1,
                                                        **scales)]
    again = tpa.ragged_decode_partial(*args, layer=1, **scales)
    want = tpa.ragged_decode_partial_plain(*args, 1, **scales)
    torch.cuda.synchronize()
    assert _build.launch_counts[key] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    empty = args[4] == 0
    assert torch.all(got[0][empty] == 0) and torch.all(got[2][empty] == 0)
    assert torch.all(got[1][empty] == -1e30)
    if pools == "dense" and qdtype == torch.bfloat16:
        live = ~empty
        out = got[0][live] / got[2][live][..., None]
        ref = want[0][live] / want[2][live][..., None]
        assert (out - ref).abs().max().item() \
            <= 1e-2 * ref.abs().max().item()
    else:
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() \
                <= 1e-5 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("dtype,pool", [(1, 1), (1, 2), (0, 0), (0, 2)])
def test_ragged_schedule_matches_mirror(dev, dtype, pool):
    """The kernel's own split of the walks (``ptt_ragged_decode_schedule``
    at the grid the form launches) equals ``tpa.ragged_schedule``."""
    import ctypes
    grid = _build.kernel("ptt_ragged_decode_grid", [ctypes.c_int] * 3)(
        dtype, pool, 128)
    assert grid > 0
    fn = _build.kernel("ptt_ragged_decode_schedule",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
    for lens, _bs, _g, _d in _SPLIT_EDGES.values():
        lens_c = (ctypes.c_int * len(lens))(*lens)
        cap = 8 * (grid + 64 * 8)
        rows = (ctypes.c_int * (7 * cap))()
        tile = tpa.RAGGED_TILE if dtype == 1 else tpa.RAGGED_TILE_F32
        n = fn(lens_c, len(lens), 8, 32, 64, tile, grid, rows, cap)
        got = [tuple(rows[7 * i:7 * i + 7]) for i in range(n)]
        assert got == tpa.ragged_schedule(lens, 8, 32, 64, tile, grid)


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


def _bwd_inputs(dev, B, S, hq, hkv, D, causal, seed):
    """bf16 q, k, v, dout and the forward's out and lse."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for shape in ((B, S, hq, D), (B, S, hkv, D),
                                 (B, S, hkv, D), (B, S, hq, D)))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    return q, k, v, do, out, lse


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (6, 2), (8, 2), (24, 8)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [1, 63, 64, 100, 129, 1000, 2048])
def test_flash_bwd_sm90_edges_match_plain(dev, S, causal, hq, hkv, D):
    """B2 and B3's bf16 Hopper kernels (64-row K/V and query tiles, 128-row
    dQ items, Delta computed in B2) against their plain versions, each
    gradient within 2e-2 of its largest magnitude (the bf16 roundings of
    P and dS; the magnitude floored at 1e-2, since S=1 leaves dq and dk
    zero up to rounding): S below, at and past one tile, ragged and
    whole; GQA groups of 1, 3 and 4 (a query head read from kv head
    h % Hkv fails (6, 2) and (8, 2)); D 64 and 128. One launch of each a
    call."""
    q, k, v, do, out, lse = _bwd_inputs(dev, 1, S, hq, hkv, D, causal,
                                        S + 7 * hq + D)
    before = (_build.launch_counts["flash_dq"],
              _build.launch_counts["flash_dkv"])
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (_build.launch_counts["flash_dq"],
            _build.launch_counts["flash_dkv"]) == (before[0] + 1,
                                                   before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * max(b.float().abs().max().item(), 1e-2), \
            (name, err)


@pytest.mark.parametrize("S,causal,hq,hkv,D", [
    (100, True, 8, 2, 128), (1000, False, 6, 2, 64), (2048, True, 24, 8, 128)])
def test_flash_dq_fused_delta_matches_given_delta(dev, S, causal, hq, hkv,
                                                  D):
    """B2 given ``out`` computes Delta = rowsum(out * dout) itself: the
    Delta it writes equals ``_delta``'s within f32 summation order
    (1e-5 of the largest), and its dq equals the dq of the explicit-Delta
    form within bf16 tolerance (2e-2 of the largest)."""
    q, k, v, do, out, lse = _bwd_inputs(dev, 2, S, hq, hkv, D, causal, S)
    want_delta = tfa._delta(out, do)
    delta = torch.full_like(want_delta, float("nan"))
    dq = tfa.flash_dq(q, k, v, do, lse, delta, causal, out=out)
    want = tfa.flash_dq(q, k, v, do, lse, want_delta, causal)
    torch.cuda.synchronize()
    scale = want_delta.abs().max().item()
    assert (delta - want_delta).abs().max().item() <= 1e-5 * scale
    err = (dq.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_repeat_calls_bit_equal(dev, causal):
    """No atomics: two calls of flash_attention_bwd on the same inputs
    give bit-equal dq, dk and dv (the llama-2.6b step's heads, S=1000)."""
    q, k, v, do, out, lse = _bwd_inputs(dev, 2, 1000, 24, 8, 128, causal, 3)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


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


def _mega_inputs(dev, dtype, D, G, N, seed=0, L=2, hkv=2, bs=16, mb=8, S=4,
                 hidden=1024, ffn=2048, vocab=128):
    """A small model (hidden 1024, ffn 2048, L layers: wide enough that
    every GEMV phase splits its tiles' rows into several k-ranges) with D
    and G as asked, its [L, NB, bs, hkv, D] pools, a ring whose first
    steps hold earlier rows, and walk lengths 100, 0, a full table, 37,
    ... (the first N)."""
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                            intermediate_size=ffn, num_layers=L,
                            num_heads=hkv * G, num_kv_heads=hkv,
                            head_dim=D, max_seq_len=256, dtype=dtype)
    params = llama.init_params(cfg, seed=seed, device=dev, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    nb = N * mb + 1
    pools = [torch.randn(L, nb, bs, hkv, D, generator=g, device=dev)
             .to(dtype) for _ in range(2)]
    rings = [torch.randn(L, N, S, hkv, D, generator=g, device=dev)
             .to(dtype) for _ in range(2)]
    table = torch.as_tensor(rng.permutation(np.arange(1, nb))
                            .reshape(N, mb).astype(np.int32), device=dev)
    walk = torch.as_tensor(([100, 0, mb * bs, 37] * 2)[:N],
                           dtype=torch.int32, device=dev)
    x0 = torch.randn(N, hidden, generator=g, device=dev).to(dtype)
    return cfg, params, x0, table, walk, pools, rings


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D,G,N", [(128, 4, 4), (64, 1, 1), (128, 1, 4),
                                   (64, 4, 1), (128, 4, 8), (64, 8, 6)])
def test_mega_kernel_matches_plain(dev, dtype, tol, D, G, N):
    """B5, one step of all layers, against its plain version: the hidden
    state and the ring rows it wrote, each within ``tol`` of its largest
    magnitude (bf16: the kernel's f32 sums run in another order than
    cuBLAS's, so a bf16 rounding may land one ulp apart); rows of other
    steps untouched. Step 2 of a 4-step ring. N up to 4 runs the kernel
    built for 4 rows, 5 to 8 the one built for 8."""
    from paddle_tpu_torch.kernels import mega_decode as tmd
    cfg, params, x0, table, walk, (kp, vp), (rk, rv) = _mega_inputs(
        dev, dtype, D, G, N)
    lens = walk + 2
    t = 2
    before = _build.launch_counts["mega_decode"]
    xh, rk1, rv1 = tmd.mega_decode_step(
        params, cfg, x0=x0, t=t, block_table=table, walk_lens=walk,
        lens=lens, ring_k=rk.clone(), ring_v=rv.clone(), k_pool=kp,
        v_pool=vp)
    ref, rk2, rv2 = tmd.mega_decode_step_plain(
        params, cfg, x0=x0, t=t, block_table=table, walk_lens=walk,
        lens=lens, ring_k=rk.clone(), ring_v=rv.clone(), k_pool=kp,
        v_pool=vp)
    torch.cuda.synchronize()
    assert _build.launch_counts["mega_decode"] == before + 1
    assert xh.dtype == dtype and xh.shape == x0.shape
    for got, want in ((xh, ref), (rk1, rk2), (rv1, rv2)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()
    keep = [s for s in range(rk.shape[2]) if s != t]
    assert torch.equal(rk1[:, :, keep], rk[:, :, keep])
    assert torch.equal(rv1[:, :, keep], rv[:, :, keep])


def test_mega_engine_launches_once_a_step_and_streams_equal_ragged(dev):
    """A mega engine on the card (f32, decisive argmax) emits the ragged
    engine's greedy streams, with one mega_decode launch a decode step and
    no ragged_decode launch."""
    from paddle_tpu_torch.serving import LLMEngine
    cfg, params, *_ = _mega_inputs(dev, torch.float32, 128, 4, 4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=n).tolist() for n in (5, 40, 17)]
    streams = {}
    for kernel in ("ragged", "mega"):
        eng = LLMEngine(params, cfg, max_slots=2, block_size=16,
                        max_model_len=128, prompt_buckets=[64],
                        decode_steps=4, decode_kernel=kernel, device=dev)
        ids = [eng.add_request(p, max_new_tokens=9) for p in prompts]
        _build.launch_counts.clear()
        out = eng.run()
        torch.cuda.synchronize()
        streams[kernel] = [out[i] for i in ids]
        assert sum(eng.decode_paths.values()) \
            == eng.decode_paths[kernel] > 0
        if kernel == "mega":
            assert not eng.mega_fallbacks
            assert _build.launch_counts["mega_decode"] \
                == 4 * eng.decode_paths["mega"]
            assert _build.launch_counts["ragged_decode"] == 0
    assert streams["mega"] == streams["ragged"]


# ---------------------------------------------------------------------------
# B9 (gather_gmm) and B10 (gmm, tgmm): the MoE grouped GEMMs
# ---------------------------------------------------------------------------

# group sizes over 300 rows: empty groups (0 and 3), a one-row group, a
# skewed one, boundaries inside 128-row tiles, and 69 tail rows
_GS = [0, 130, 1, 0, 100]


def _rel(a, b):
    return (a.float() - b.float()).abs().max().item() \
        / max(b.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_kernel_matches_plain(dev, dtype, tol, transpose_rhs):
    """B10 gmm against its plain version on [300, 200] rows (a reduction
    not a multiple of the 32-deep stage) and 136 columns (a partial
    column tile); rows past sum(gs) come out exactly zero."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    g = torch.Generator(device=dev).manual_seed(11)
    M, K, N = 300, 200, 136
    lhs = torch.randn(M, K, generator=g, device=dev).to(dtype)
    rhs = torch.randn((5, N, K) if transpose_rhs else (5, K, N),
                      generator=g, device=dev).to(dtype)
    gs = torch.tensor(_GS, dtype=torch.int32, device=dev)
    before = _build.launch_counts["gmm"]
    out = md.gmm(lhs, rhs, gs, transpose_rhs)
    ref = md.gmm_plain(lhs, rhs, gs, transpose_rhs)
    torch.cuda.synchronize()
    assert _build.launch_counts["gmm"] == before + 1
    assert out.dtype == dtype and out.shape == (M, N)
    assert torch.all(out[sum(_GS):] == 0)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype,out_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 1e-2)])
def test_tgmm_kernel_matches_plain(dev, dtype, out_dtype, tol):
    """B10 tgmm against its plain version: lhs^T [136, 300] (the view of
    an [m, k] tensor) and rhs [300, 200]; the empty groups' blocks are
    exactly zero, the tail rows belong to no group."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    g = torch.Generator(device=dev).manual_seed(12)
    M, K, N = 300, 136, 200
    lhs = torch.randn(M, K, generator=g, device=dev).to(dtype)
    rhs = torch.randn(M, N, generator=g, device=dev).to(dtype)
    gs = torch.tensor(_GS, dtype=torch.int32, device=dev)
    before = _build.launch_counts["tgmm"]
    out = md.tgmm(lhs.t(), rhs, gs, out_dtype=out_dtype)
    ref = md.tgmm_plain(lhs.t(), rhs, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _build.launch_counts["tgmm"] == before + 1
    assert out.dtype == out_dtype and out.shape == (5, K, N)
    assert torch.all(out[0] == 0) and torch.all(out[3] == 0)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D,G,N,hidden,ffn", [
    (128, 3, 2, 1056, 2080), (64, 3, 7, 1056, 2080), (128, 8, 5, 1024, 2048),
    (64, 4, 3, 160, 96), (128, 1, 8, 4096, 1056)])
def test_mega_hopper_edges(dev, dtype, tol, int8, D, G, N, hidden, ffn):
    """B5's Hopper design at its edges: widths that are multiples of 32
    but not of a 256-column (bf16) or 512-column (int8) tile, so the last
    tile of a phase has boxes past its matrix (zero-filled, or not
    loaded); a hidden width of 160 (fewer units than blocks: most blocks
    hold nothing) and of 4096 (a phase split into many k-ranges); G 1, 3,
    4, 8; N 2-8 (both instantiations); walks of 0, part of and a whole
    table; with ``int8`` both int8 weights and int8 pools. Held to the
    plain version as the dense test holds it, and two launches on the
    same inputs give the same bits."""
    from paddle_tpu_torch.kernels import mega_decode as tmd
    from paddle_tpu_torch.models import llama
    cfg, params, x0, table, walk, (kp, vp), (rk, rv) = _mega_inputs(
        dev, dtype, D, G, N, hidden=hidden, ffn=ffn)
    pools = dict(k_pool=kp, v_pool=vp)
    if int8:
        params = llama.quantize_params(params)
        qk, qv, ks, vs = _int8_pools(kp, vp)
        pools = dict(k_pool=qk, v_pool=qv, ks_pool=ks, vs_pool=vs)
    kw = dict(x0=x0, t=3, block_table=table, walk_lens=walk, lens=walk + 3,
              **pools)
    name = "mega_decode_int8" if int8 else "mega_decode"
    before = _build.launch_counts[name]
    runs = [tmd.mega_decode_step(params, cfg, ring_k=rk.clone(),
                                 ring_v=rv.clone(), **kw) for _ in range(2)]
    ref = tmd.mega_decode_step_plain(params, cfg, ring_k=rk.clone(),
                                     ring_v=rv.clone(), **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 2
    for got, want in zip(runs[0], ref):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head,vocab", [("tied", 1000), ("int8", 1056),
                                        ("dense", 2080)])
def test_mega_loop_at_the_head_limit(dev, dtype, head, vocab):
    """The multi-step form at the hidden width 4096 the screen allows for
    its head (the head's input rows staged in two chunks), a vocabulary
    that is not a multiple of the head's tile, the three heads, a row
    inactive, one ending at its budget and one at an eos mid-wave. f32:
    the emitted tokens and the final state equal the plain version's;
    bf16: the first step's ring rows within 2e-2 and valid tokens. Two
    launches give the same bits."""
    import dataclasses
    from paddle_tpu_torch.kernels import mega_decode as tmd
    from paddle_tpu_torch.models import llama
    N, k = 4, 4
    cfg, params, x0, table, walk, pools, _ = _mega_inputs(
        dev, dtype, 128, 4, N, L=1, hidden=4096, ffn=1056, vocab=vocab)
    if head == "tied":
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
        params = {kk: v for kk, v in params.items() if kk != "lm_head"}
    if head == "int8":
        params = llama.quantize_params(params)
    assert tmd.mega_supported(params, cfg, n_slots=N, n_steps=k,
                              block_size=16, kv_int8=False,
                              multi_step=True) == (True, "ok")
    budgets, eos = [k, 2, k, k], [-1] * N
    first = tmd.mega_decode_loop_plain(params, cfg, **_loop_args(
        params, cfg, x0, table, walk, pools, k, budgets, eos))[0]
    eos[-1] = int(first[1, -1])

    def args():   # row 2 is inactive
        return _loop_args(params, cfg, x0, table, walk, pools, k, budgets,
                          eos)
    runs = [tmd.mega_decode_loop(params, cfg, **args()) for _ in range(2)]
    want = tmd.mega_decode_loop_plain(params, cfg, **args())
    torch.cuda.synchronize()
    got = runs[0]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert bool(((got[0] >= -1) & (got[0] < vocab)).all())
    assert bool((got[0][:, 2] == -1).all())
    if dtype == torch.float32:
        for g, w in zip(got[:5], want[:5]):
            assert torch.equal(g.long().cpu(), w.long().cpu())
        for g, w in zip(got[5:], want[5:]):
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    else:
        for g, w in zip(got[5:], want[5:]):
            err = (g[:, :, 0].float() - w[:, :, 0].float()).abs().max()
            assert err.item() <= 2e-2 * w[:, :, 0].float().abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("skew", [False, True])
def test_gather_gmm_kernel_matches_plain(dev, dtype, tol, skew):
    """B9 against its plain version over the tile-padded layout of a
    random top-3 routing of 50 tokens to 4 experts (skewed: expert 0 takes
    most), h = 136, n = 264: every row, padding and tail included."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import moe_fused as mf
    g = torch.Generator(device=dev).manual_seed(13)
    T, h, n, E, k = 50, 136, 264, 4, 3
    x = torch.randn(T, h, generator=g, device=dev).to(dtype)
    rhs = torch.randn(E, h, n, generator=g, device=dev).to(dtype)
    logits = torch.randn(T, E, generator=g, device=dev)
    if skew:
        logits[:, 0] += 3.0
    r = md.routing_from_logits(logits, k)
    inv2d = mf._inverse_permutation(r.order).reshape(T, k)
    ws = r.weights.reshape(-1)[r.order]
    tok_pad, _, _, _, gs_pad = mf._pad_layout(
        r.gs, r.tok, ws, r.flat_e[r.order], inv2d, E)
    gid = mf._tile_gids(gs_pad, tok_pad.shape[0], 128)
    before = _build.launch_counts["gather_gmm"]
    out = mf.gather_gmm(x, tok_pad, rhs, gid)
    ref = mf.gather_gmm_plain(x, tok_pad, rhs, gid)
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_gmm"] == before + 1
    assert out.dtype == dtype and out.shape == (tok_pad.shape[0], n)
    assert _rel(out, ref) <= tol


# Edge shapes of the Hopper kernels (grouped_gemm_sm90.cuh): (M, K, N, gs).
# "wrap": a reduction of 33 64-deep stages (not a multiple of 64), so the
# stage ring's barriers wrap several times and the last stage is ragged,
# and 32 x 11 = 352 output tiles, more than 2 x 132, so every persistent
# block takes several; "n1408": a multiple of 128 columns but not of 256;
# "n136": a 128-wide tile with 8 live columns, and a first row tile that
# spans groups 0, 1, 3 and 4 around an empty group 2. Each has tail rows.
_SM90_GMM = {
    "wrap": (4096, 2056, 2816, [700, 0, 13, 1200, 87, 900, 600, 500]),
    "n1408": (1000, 200, 1408, [3, 60, 0, 200, 5, 1, 500]),
    "n136": (300, 136, 136, [40, 30, 0, 20, 100]),
}


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("shape", list(_SM90_GMM))
def test_gmm_sm90_edges_match_plain(dev, shape, transpose_rhs):
    """B10 gmm's bf16 kernel against its plain version at the edge shapes
    above, unpadded groups (tiles spanning three or more groups, an empty
    group, tail rows written as exact zeros), within 1e-2 of the plain
    result's largest magnitude; two calls agree bit for bit."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    M, K, N, sizes = _SM90_GMM[shape]
    g = torch.Generator(device=dev).manual_seed(21)
    E = len(sizes)
    lhs = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    rhs = torch.randn((E, N, K) if transpose_rhs else (E, K, N), generator=g,
                      device=dev).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = _build.launch_counts["gmm"]
    out = md.gmm(lhs, rhs, gs, transpose_rhs)
    again = md.gmm(lhs, rhs, gs, transpose_rhs)
    ref = md.gmm_plain(lhs, rhs, gs, transpose_rhs)
    torch.cuda.synchronize()
    assert _build.launch_counts["gmm"] == before + 2
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.all(out[sum(sizes):] == 0)
    assert _rel(out, ref) <= 1e-2
    assert torch.equal(out, again)


# Edge shapes of tgmm's Hopper kernel: (M, K, N, gs), K and N the output's
# [E, K, N]. "ragged": group boundaries off 64 and off 8 (a group's last
# 64-row stage holds the next group's rows, which must add nothing), empty
# groups, 250 rows past sum(gs), K = 136 (a second K tile of 8 rows) and N
# = 1408 (128-wide tiles); "one": one group holds every row, K = 1408,
# N = 136; "wrap": K = N = 2048 over 8 groups, 1024 output tiles (more than
# 2 x 132), reductions of up to 19 stages that wrap the stage ring.
_SM90_TGMM = {
    "ragged": (1000, 136, 1408, [3, 61, 0, 77, 9, 500, 0, 100]),
    "one": (700, 1408, 136, [0, 700, 0]),
    "wrap": (4096, 2048, 2048, [700, 0, 13, 1200, 87, 900, 600, 500]),
}


@pytest.mark.parametrize("out_dtype,tol", [(torch.bfloat16, 1e-2),
                                           (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", list(_SM90_TGMM))
def test_tgmm_sm90_edges_match_plain(dev, shape, out_dtype, tol):
    """B10 tgmm's bf16 kernel against its plain version at the edge shapes
    above, within ``tol`` of the plain result's largest magnitude; empty
    groups' blocks are exact zeros; two calls agree bit for bit."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    M, K, N, sizes = _SM90_TGMM[shape]
    g = torch.Generator(device=dev).manual_seed(23)
    lhs = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    rhs = torch.randn(M, N, generator=g, device=dev).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = _build.launch_counts["tgmm"]
    out = md.tgmm(lhs.t(), rhs, gs, out_dtype=out_dtype)
    again = md.tgmm(lhs.t(), rhs, gs, out_dtype=out_dtype)
    ref = md.tgmm_plain(lhs.t(), rhs, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _build.launch_counts["tgmm"] == before + 2
    assert out.dtype == out_dtype and out.shape == (len(sizes), K, N)
    for e, n in enumerate(sizes):
        if n == 0:
            assert torch.all(out[e] == 0)
    assert _rel(out, ref) <= tol
    assert torch.equal(out, again)


@pytest.mark.parametrize("rhs_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", ["wrap", "n1408"])
def test_gather_gmm_sm90_edges_match_plain(dev, shape, rhs_dtype):
    """B9 (bf16 rhs, and int8 rhs widened in the kernel) against its plain
    version over the tile-padded layout of a skewed top-2 routing to 8
    experts: "wrap", 2048 tokens, h = 2056 (33 ragged 64-deep stages) and
    n = 2816, more than 2 x 132 output tiles; "n1408", 300 tokens, h = 200,
    n = 1408 (128-wide tiles). Within 1e-2 of the plain result's largest
    magnitude; two calls agree bit for bit."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import moe_fused as mf
    T, h, n = {"wrap": (2048, 2056, 2816), "n1408": (300, 200, 1408)}[shape]
    E, k = 8, 2
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(T, h, generator=g, device=dev).to(torch.bfloat16)
    if rhs_dtype == torch.int8:
        rhs = torch.randint(-127, 128, (E, h, n), generator=g, device=dev,
                            dtype=torch.int8)
    else:
        rhs = torch.randn(E, h, n, generator=g, device=dev).to(rhs_dtype)
    logits = torch.randn(T, E, generator=g, device=dev)
    logits[:, 0] += 2.0
    r = md.routing_from_logits(logits, k)
    inv2d = mf._inverse_permutation(r.order).reshape(T, k)
    tok_pad, _, _, _, gs_pad = mf._pad_layout(
        r.gs, r.tok, r.weights.reshape(-1)[r.order], r.flat_e[r.order],
        inv2d, E)
    gid = mf._tile_gids(gs_pad, tok_pad.shape[0], 128)
    name = "gather_gmm_int8" if rhs_dtype == torch.int8 else "gather_gmm"
    before = _build.launch_counts[name]
    out = mf.gather_gmm(x, tok_pad, rhs, gid)
    again = mf.gather_gmm(x, tok_pad, rhs, gid)
    ref = mf.gather_gmm_plain(x, tok_pad, rhs, gid)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 2
    if shape == "wrap":
        assert tok_pad.shape[0] // 128 * (n // 256) > 2 * 132
    assert out.dtype == torch.bfloat16 and out.shape == (tok_pad.shape[0], n)
    assert _rel(out, ref) <= 1e-2
    assert torch.equal(out, again)


@pytest.mark.parametrize("dispatch", ["fused", "gmm"])
def test_moe_ffn_on_card_matches_cpu(dev, dispatch):
    """The routed FFN (f32, T=96, h=64, E=8, top-2, f=32) on the card and
    on the CPU from the same inputs: values and the gradients of x, the
    router and the three expert weights within 1e-5 of each one's largest
    magnitude. The fused form runs its padded pipeline on both: B9 and
    one gmm forward, two gmm and two tgmm backward on the card."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import moe_fused as mf
    rng = np.random.default_rng(5)
    T, h, E, f, k = 96, 64, 8, 32, 2
    arrays = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((T, h), 1.0), ((h, E), 0.3), ((E, h, f), 0.1), ((E, h, f), 0.1),
        ((E, f, h), 0.1), ((T, h), 1.0))]
    fn = (md.dropless_moe_ffn_fused if dispatch == "fused"
          else md.dropless_moe_ffn)
    res = {}
    for where in ("cuda", "cpu"):
        x, rw, eg, eu, ed, ct = (torch.tensor(a, device=where)
                                 .requires_grad_(True) for a in arrays)
        _build.launch_counts.clear()
        mf.fused_paths.clear()
        r = md.fused_routing(x, rw, k)
        y = fn(x, r.weights, r.idx, eg, eu, ed, routing=r)
        grads = torch.autograd.grad((y * ct.detach()).sum(),
                                    (x, rw, eg, eu, ed))
        res[where] = [y.detach().cpu()] + [t.cpu() for t in grads]
        if where == "cuda":
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            if dispatch == "fused":
                assert dict(mf.fused_paths) == {"padded": 1}
                assert counts == {"gather_gmm": 1, "gmm": 3, "tgmm": 2}
            else:
                assert counts == {"gmm": 4, "tgmm": 2}
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# int8 branches: B4 and B5 over int8 pools and int8 weights, B9's int8 rhs
# ---------------------------------------------------------------------------

def _int8_pools(kp, vp):
    """int8 pools and their f32 scale pools from dense ones."""
    from paddle_tpu_torch.kernels.quant_matmul import quantize_kv
    qk, sk = quantize_kv(kp)
    qv, sv = quantize_kv(vp)
    return qk, qv, sk, sv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,G,d,lens", [
    (64, 4, 128, [0, 1, 64, 1000]),
    (16, 8, 64, [0, 128, 63, 1024]),
    (32, 1, 128, [0, 65, 191, 1000])])
def test_ragged_int8_kernel_matches_plain(dev, dtype, bs, G, d, lens):
    """B4's int8 branch against its plain version on int8 pools with f32
    scales (``quantize_kv`` of random pools), the cases of the dense test:
    acc, m and l within 1e-5 of their largest magnitude for bf16 and f32
    queries alike — bf16 queries and int8 rows are exact in f32 and the
    int8 walk rounds no probability, so only the order of the f32 sums
    differs."""
    rng = np.random.default_rng(8)
    L, hkv, mb = 2, 2, 1024 // bs
    NB = 4 * mb + 1
    g = torch.Generator(device=dev).manual_seed(1)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:4 * mb]
                            .reshape(4, mb).astype(np.int32), device=dev)
    kp, vp, ks, vs = _int8_pools(
        torch.randn(L, NB, bs, hkv, d, generator=g, device=dev),
        torch.randn(L, NB, bs, hkv, d, generator=g, device=dev))
    q = torch.randn(4, G * hkv, d, generator=g, device=dev).to(dtype)
    before = _build.launch_counts["ragged_decode_int8"]
    got = tpa.ragged_decode_partial(q, kp, vp, table, lens, layer=1,
                                    ks_pool=ks, vs_pool=vs)
    want = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens, 1, ks, vs)
    torch.cuda.synchronize()
    assert _build.launch_counts["ragged_decode_int8"] == before + 1
    assert torch.all(got[0][0] == 0) and torch.all(got[2][0] == 0)
    assert torch.all(got[1][0] == -1e30)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() \
            <= 1e-5 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("w_int8,kv_int8", [(True, False), (False, True),
                                            (True, True)])
@pytest.mark.parametrize("D,G,N", [(128, 4, 4), (64, 8, 6), (64, 1, 1)])
def test_mega_int8_kernel_matches_plain(dev, dtype, tol, w_int8, kv_int8,
                                        D, G, N):
    """B5's int8 branches against its plain version: int8 weights
    (``llama.quantize_params``; each column's scale on its complete f32
    sum, split-K phases included at hidden 1024), int8 pools with f32
    scales, and both; the hidden state and the ring rows written, each
    within ``tol`` of its largest magnitude, as the dense test."""
    from paddle_tpu_torch.kernels import mega_decode as tmd
    from paddle_tpu_torch.models import llama
    cfg, params, x0, table, walk, (kp, vp), (rk, rv) = _mega_inputs(
        dev, dtype, D, G, N)
    if w_int8:
        params = llama.quantize_params(params)
    pools = dict(k_pool=kp, v_pool=vp)
    if kv_int8:
        qk, qv, ks, vs = _int8_pools(kp, vp)
        pools = dict(k_pool=qk, v_pool=qv, ks_pool=ks, vs_pool=vs)
    t = 2
    kw = dict(x0=x0, t=t, block_table=table, walk_lens=walk, lens=walk + 2,
              **pools)
    before = _build.launch_counts["mega_decode_int8"]
    xh, rk1, rv1 = tmd.mega_decode_step(params, cfg, ring_k=rk.clone(),
                                        ring_v=rv.clone(), **kw)
    ref, rk2, rv2 = tmd.mega_decode_step_plain(params, cfg, ring_k=rk.clone(),
                                               ring_v=rv.clone(), **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["mega_decode_int8"] == before + 1
    assert xh.dtype == dtype and rk1.dtype == dtype
    for got, want in ((xh, ref), (rk1, rk2), (rv1, rv2)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item()
    keep = [s for s in range(rk.shape[2]) if s != t]
    assert torch.equal(rk1[:, :, keep], rk[:, :, keep])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("skew", [False, True])
def test_gather_gmm_int8_kernel_matches_plain(dev, dtype, tol, skew):
    """B9's int8 branch (int8 rhs widened inside the kernel) against its
    plain version over the padded layout of a top-3 routing of 50 tokens
    to 4 experts, h = 136 (a partial 32-deep stage), n = 272 (a partial
    column tile; int8 rows need n a multiple of 16)."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import moe_fused as mf
    g = torch.Generator(device=dev).manual_seed(14)
    T, h, n, E, k = 50, 136, 272, 4, 3
    x = torch.randn(T, h, generator=g, device=dev).to(dtype)
    rhs = torch.randint(-127, 128, (E, h, n), generator=g, device=dev,
                        dtype=torch.int8)
    logits = torch.randn(T, E, generator=g, device=dev)
    if skew:
        logits[:, 0] += 3.0
    r = md.routing_from_logits(logits, k)
    inv2d = mf._inverse_permutation(r.order).reshape(T, k)
    tok_pad, _, _, _, gs_pad = mf._pad_layout(
        r.gs, r.tok, r.weights.reshape(-1)[r.order], r.flat_e[r.order],
        inv2d, E)
    gid = mf._tile_gids(gs_pad, tok_pad.shape[0], 128)
    before = _build.launch_counts["gather_gmm_int8"]
    out = mf.gather_gmm(x, tok_pad, rhs, gid)
    ref = mf.gather_gmm_plain(x, tok_pad, rhs, gid)
    torch.cuda.synchronize()
    assert _build.launch_counts["gather_gmm_int8"] == before + 1
    assert out.dtype == dtype and out.shape == (tok_pad.shape[0], n)
    assert _rel(out, ref) <= tol


def test_int8_engines_on_card_match_cpu(dev):
    """int8 weights (``quantize_params``) and int8 pools: ragged and mega
    engines on the card and a ragged engine on the CPU, from the same
    weights (f32, D = 128), emit equal greedy streams; the ragged engine
    launches B4's int8 branch once a layer a step, the mega engine B5's
    once a step and no B4."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import LLMEngine
    cfg, params, *_ = _mega_inputs(dev, torch.float32, 128, 4, 4)
    q = llama.quantize_params(params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 128, size=n).tolist() for n in (5, 40, 17)]
    streams = {}
    for where, kernel in (("cuda", "ragged"), ("cuda", "mega"),
                          ("cpu", "ragged")):
        p = {k: ({kk: ({a: b.to(where) for a, b in vv.items()}
                       if isinstance(vv, dict) else vv.to(where))
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(where)) for k, v in q.items()}
        eng = LLMEngine(p, cfg, max_slots=2, block_size=16,
                        max_model_len=128, prompt_buckets=[64],
                        decode_steps=4, decode_kernel=kernel,
                        kv_dtype="int8", device=where)
        ids = [eng.add_request(pr, max_new_tokens=9) for pr in prompts]
        _build.launch_counts.clear()
        out = eng.run()
        streams[(where, kernel)] = [out[i] for i in ids]
        assert not eng.mega_fallbacks
        assert sum(eng.decode_paths.values()) \
            == eng.decode_paths[kernel] > 0
        if where == "cuda":
            torch.cuda.synchronize()
            calls = eng.decode_paths[kernel]
            if kernel == "mega":
                assert _build.launch_counts["mega_decode_int8"] == 4 * calls
                assert _build.launch_counts["ragged_decode_int8"] == 0
            else:
                assert _build.launch_counts["ragged_decode_int8"] \
                    == 4 * calls * cfg.num_layers
    assert streams[("cuda", "mega")] == streams[("cuda", "ragged")] \
        == streams[("cpu", "ragged")]


def test_int8_moe_ffn_on_card_matches_cpu(dev):
    """The fused routed FFN with int8 experts (``quantize_grouped``), f32,
    on the card (B9's int8 branch, gmm on the widened down weight) and on
    the CPU: values and x's gradient within 1e-5 of their largest
    magnitude; the int8 leaves get no gradient."""
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import moe_fused as mf
    from paddle_tpu_torch.kernels.quant_matmul import quantize_grouped
    rng = np.random.default_rng(6)
    T, h, E, f, k = 96, 64, 8, 32, 2
    arrays = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((T, h), 1.0), ((h, E), 0.3), ((E, h, f), 0.1), ((E, h, f), 0.1),
        ((E, f, h), 0.1), ((T, h), 1.0))]
    res = {}
    for where in ("cuda", "cpu"):
        x, rw, eg, eu, ed, ct = (torch.tensor(a, device=where)
                                 for a in arrays)
        x.requires_grad_(True)
        qg, qu, qd = (quantize_grouped(eg, 1), quantize_grouped(eu, 1),
                      quantize_grouped(ed, 2))
        _build.launch_counts.clear()
        r = md.fused_routing(x, rw, k)
        y = md.dropless_moe_ffn_fused(x, r.weights, r.idx, qg, qu, qd,
                                      routing=r)
        (dx,) = torch.autograd.grad((y * ct).sum(), (x,))
        res[where] = [y.detach().cpu(), dx.cpu()]
        if where == "cuda":
            torch.cuda.synchronize()
            assert _build.launch_counts["gather_gmm_int8"] == 1
            assert not any(t.requires_grad for w in (qg, qu, qd)
                           for t in w.values())
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _rel(a, b) <= 1e-5


# ---------------------------------------------------------------------------
# B5's multi-step form (the speculative draft wave) and B6-B8 (the
# paged-cache API)
# ---------------------------------------------------------------------------
def _loop_args(params, cfg, x0, table, walk, pools, k, budgets, eos):
    N = x0.shape[0]
    L, hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    dev = x0.device
    last0 = torch.arange(N, dtype=torch.int32, device=dev) * 7 + 3
    active = torch.tensor([n != 2 for n in range(N)], device=dev)
    return dict(x0=params["embed"][last0.long()].to(cfg.dtype), n_steps=k,
                block_table=table, walk_lens=walk, lens=walk.clone(),
                active=active, last0=last0,
                budgets=torch.as_tensor(budgets, device=dev),
                eos_ids=torch.as_tensor(eos, device=dev),
                ring_k=torch.zeros(L, N, k, hkv, D, dtype=cfg.dtype,
                                   device=dev),
                ring_v=torch.zeros(L, N, k, hkv, D, dtype=cfg.dtype,
                                   device=dev),
                k_pool=pools[0], v_pool=pools[1])


def _loop_model(dev, dtype, head, D, G, N):
    """_mega_inputs' model with the head asked for: "dense", "tied" (the
    embedding is the head) or "int8" (``quantize_params``: int8 layer
    weights and head)."""
    import dataclasses
    from paddle_tpu_torch.models import llama
    cfg, params, x0, table, walk, pools, _ = _mega_inputs(dev, dtype, D, G,
                                                          N)
    if head == "tied":
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
        params = {k: v for k, v in params.items() if k != "lm_head"}
    if head == "int8":
        params = llama.quantize_params(params)
    return cfg, params, x0, table, walk, pools


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head,D,G,N", [
    ("dense", 128, 4, 4), ("tied", 64, 8, 6), ("int8", 128, 4, 4),
    ("dense", 64, 1, 1), ("tied", 128, 4, 8)])
def test_mega_loop_kernel_matches_plain(dev, dtype, head, D, G, N):
    """B5's multi-step form, 4 steps, against mega_decode_loop_plain: row
    1 spends a budget of 2 mid-loop, row 2 (where N > 2) is inactive and
    the last row stops at an eos taken from the plain run's step 1. f32:
    the emitted tokens and the final last/lens/done/budgets equal the
    plain version's, the rings within 1e-4 of their largest magnitude.
    bf16 (the logits round to bf16, where near-ties are common, so later
    steps may take another token): the first step's ring rows within
    2e-2 and its tokens, which the kernel feeds back, valid."""
    from paddle_tpu_torch.kernels import mega_decode as tmd
    cfg, params, x0, table, walk, pools = _loop_model(dev, dtype, head, D,
                                                      G, N)
    k = 4
    budgets = [k, 2] + [k] * (N - 2) if N > 1 else [k]
    eos = [-1] * N
    first = tmd.mega_decode_loop_plain(
        params, cfg, **_loop_args(params, cfg, x0, table, walk, pools, k,
                                  budgets, eos))[0]
    if N > 3:
        eos[-1] = int(first[1, -1])
    args = _loop_args(params, cfg, x0, table, walk, pools, k, budgets, eos)
    name = "mega_decode_loop_int8" if head == "int8" else "mega_decode_loop"
    before = _build.launch_counts[name]
    got = tmd.mega_decode_loop(params, cfg, **args)
    want = tmd.mega_decode_loop_plain(
        params, cfg, **_loop_args(params, cfg, x0, table, walk, pools, k,
                                  budgets, eos))
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    V = cfg.vocab_size
    assert got[0].shape == (k, N) and got[0].dtype == torch.int32
    assert bool(((got[0] >= -1) & (got[0] < V)).all())
    if dtype == torch.float32:
        for g, w in zip(got[:5], want[:5]):
            assert torch.equal(g.long().cpu(), w.long().cpu())
        for g, w in zip(got[5:], want[5:]):
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
        if N > 1:
            assert bool(got[3][1]) and int(got[4][1]) == 0
    else:
        for g, w in zip(got[5:], want[5:]):
            err = (g[:, :, 0].float() - w[:, :, 0].float()).abs().max()
            assert err.item() <= 2e-2 * w[:, :, 0].float().abs().max().item()
    if N > 2:
        assert bool((got[0][:, 2] == -1).all())      # the inactive row


def test_spec_engine_mega_draft_on_card_matches_ragged(dev):
    """A speculative engine on the card (f32, a 1-layer draft of the
    target's widths) emits the plain engine's greedy streams through the
    mega draft (one multi-step launch a spec wave, no single-step launch
    inside the waves) and through the ragged one."""
    import dataclasses
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import LLMEngine
    cfg, params, *_ = _mega_inputs(dev, torch.float32, 128, 4, 4)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams = llama.init_params(dcfg, seed=1, device=dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=n).tolist() for n in (5, 40, 17)]
    kw = dict(max_slots=2, block_size=16, max_model_len=128,
              prompt_buckets=[64], decode_steps=4, device=dev)
    base = LLMEngine(params, cfg, decode_kernel="ragged", **kw)
    ids = [base.add_request(p, max_new_tokens=9) for p in prompts]
    out = base.run()
    want = [out[i] for i in ids]
    for kernel in ("mega", "ragged"):
        eng = LLMEngine(params, cfg, decode_kernel=kernel,
                        draft_params=dparams, draft_config=dcfg,
                        spec_tokens=4, **kw)
        ids = [eng.add_request(p, max_new_tokens=9) for p in prompts]
        _build.launch_counts.clear()
        out = eng.run()
        torch.cuda.synchronize()
        assert [out[i] for i in ids] == want
        assert dict(eng.spec_draft_paths) == {kernel: eng.spec_waves}
        assert not eng.mega_fallbacks and not eng.decode_paths
        if kernel == "mega":
            assert _build.launch_counts["mega_decode_loop"] \
                == eng.spec_waves
            assert _build.launch_counts["mega_decode"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("five_d", [False, True])
def test_paged_append_kernels_match_plain(dev, dtype, five_d):
    """B7 and B8 write exactly what their plain versions write (in place,
    4-D and 5-D pools, a runtime layer), idle slots and pad blocks on the
    trash block 0."""
    from paddle_tpu_torch.kernels import paged_attention as tpa
    g = torch.Generator(device=dev).manual_seed(5)
    L, NB, BS, hkv, D, N = 3, 40, 16, 8, 128, 6
    shape = ((L,) if five_d else ()) + (NB, BS, hkv, D)
    layer = 2 if five_d else 0
    kp, vp = (torch.randn(shape, generator=g, device=dev).to(dtype)
              for _ in range(2))
    k_new, v_new = (torch.randn(N, hkv, D, generator=g, device=dev)
                    for _ in range(2))      # cast to the pools' dtype
    blk = torch.tensor([3, 0, 17, 39, 8, 0], dtype=torch.int32, device=dev)
    off = torch.tensor([0, 5, 15, 7, 1, 5], dtype=torch.int32, device=dev)
    k_new[5], v_new[5] = k_new[1], v_new[1]     # the trash block's writes
    pools = [kp.clone(), vp.clone()]
    ref = [kp.clone(), vp.clone()]
    before = _build.launch_counts["paged_append_token"]
    tpa.paged_append_token(*pools, k_new, v_new, blk, off, layer=layer)
    tpa.paged_append_token_plain(*ref, k_new, v_new, blk, off, layer)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_append_token"] == before + 1
    assert torch.equal(pools[0], ref[0]) and torch.equal(pools[1], ref[1])
    kb, vb = (torch.randn(5, BS, hkv, D, generator=g, device=dev).to(dtype)
              for _ in range(2))
    ids = torch.tensor([11, 0, 2, 39, 0], dtype=torch.int32, device=dev)
    kb[4], vb[4] = kb[1], vb[1]
    before = _build.launch_counts["paged_append_blocks"]
    tpa.paged_append_blocks(*pools, kb, vb, ids, layer=layer)
    tpa.paged_append_blocks_plain(*ref, kb, vb, ids, layer)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_append_blocks"] == before + 1
    assert torch.equal(pools[0], ref[0]) and torch.equal(pools[1], ref[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bs,G,D", [(64, 4, 128), (16, 3, 64), (32, 8, 128),
                                    (64, 1, 64)])
def test_paged_decode_kernel_matches_plain(dev, dtype, tol, bs, G, D):
    """B6 against its plain version: lengths 0 (the result is 0), 1, one
    exact block and long partial walks, G of 1, 3, 4 and 8, layer 1 of a
    two-layer pool; per slot, f32 within 1e-5 of that slot's largest
    magnitude, bf16 within 2e-2."""
    from paddle_tpu_torch.kernels import paged_attention as tpa
    rng = np.random.default_rng(9)
    L, hkv, mb, N = 2, 2, 1024 // bs, 5
    NB = N * mb + 1
    g = torch.Generator(device=dev).manual_seed(1)
    lens = torch.tensor([0, 1, bs, 1000, 313], dtype=torch.int32, device=dev)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))
                            .reshape(N, mb).astype(np.int32), device=dev)
    kp, vp = (torch.randn(L, NB, bs, hkv, D, generator=g, device=dev)
              .to(dtype) for _ in range(2))
    q = torch.randn(N, G * hkv, D, generator=g, device=dev).to(dtype)
    cache = tpa.PagedKVCache(kp, vp, table, lens)
    before = _build.launch_counts["paged_decode_attention"]
    out = tpa.paged_decode_attention(q, cache, layer=1)
    ref = tpa.paged_decode_attention_plain(q, cache, layer=1)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_decode_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert bool((out[0] == 0).all())
    err = (out.float() - ref.float()).abs().flatten(1).amax(1)[1:]
    assert bool((err <= tol * ref.float().abs().flatten(1).amax(1)[1:]).all())


# Edge shapes of B6's split walk (csrc/paged_decode.cu: B4's schedule of
# 32-position tiles, 64 for f32, in two passes): (lengths, block size, G,
# D). (s4)'s lengths at Llama-3-8B's heads; one slot of 2000 positions
# spread over the grid; 64 short slots, more walks than blocks; lengths on
# and beside tile edges (31-33, 63-65), 0 and past the table (clamped).
_PAGED_EDGES = {
    "s4": ([0, 1, 64, 2000, 777, 128, 1500, 33], 64, 4, 128),
    "n1_2000": ([2000], 64, 4, 128),
    "short64": ([int(x) for x in np.random.default_rng(5).integers(
        0, 129, size=64)], 32, 3, 128),
    "tile_edges": ([31, 32, 33, 0, 63, 64, 65, 1, 5000], 16, 8, 64),
    "g1": ([2000, 1, 0, 777, 128, 1500, 33, 64], 64, 1, 64),
}


def _paged_case(dev, name, dtype, seed):
    lens, bs, G, d = _PAGED_EDGES[name]
    rng = np.random.default_rng(seed)
    N, hkv, mb = len(lens), 8 if name == "s4" else 2, 2048 // bs
    need = [max(1, -(-min(x, mb * bs) // bs)) for x in lens]
    nb = sum(need) + 1
    table = np.zeros((N, mb), np.int32)
    ids, at = rng.permutation(np.arange(1, nb)), 0
    for i, k in enumerate(need):
        table[i, :k] = ids[at:at + k]
        at += k
    g = torch.Generator(device=dev).manual_seed(seed)
    kp, vp = (torch.randn(2, nb, bs, hkv, d, generator=g, device=dev)
              .to(dtype) for _ in range(2))
    q = torch.randn(N, G * hkv, d, generator=g, device=dev).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, tpa.PagedKVCache(kp, vp, torch.as_tensor(table, device=dev),
                               lens)


def _per_slot_ok(out, ref, lens, tol):
    live = lens > 0
    err = (out.float() - ref.float()).abs().flatten(1).amax(1)[live]
    return bool((out[~live] == 0).all()) and bool(
        (err <= tol * ref.float().abs().flatten(1).amax(1)[live]).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", list(_PAGED_EDGES))
def test_paged_decode_split_edges_match_plain(dev, name, dtype, tol):
    """B6 at its split walk's edge shapes, layer 1 of two, against its
    plain version: per slot within the tolerance of
    test_paged_decode_kernel_matches_plain (f32 1e-5, bf16 2e-2 of the
    slot's largest magnitude), a zero-length slot exactly 0. One counted
    call a call; two calls agree bit for bit."""
    q, cache = _paged_case(dev, name, dtype, seed=len(name))
    before = _build.launch_counts["paged_decode_attention"]
    out = tpa.paged_decode_attention(q, cache, layer=1)
    again = tpa.paged_decode_attention(q, cache, layer=1)
    ref = tpa.paged_decode_attention_plain(q, cache, layer=1)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_decode_attention"] == before + 2
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, again)
    assert _per_slot_ok(out, ref, cache.lengths, tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_back_to_back_calls_equal(dev, dtype):
    """500 back-to-back calls on one stream (pass 2 of each bf16 call
    launched dependent on its pass 1, the next call's pass 1 after it) all
    equal the first, bit for bit: the passes' maxima, parts and flags are
    reused call after call."""
    q, cache = _paged_case(dev, "s4", dtype, seed=3)
    first = tpa.paged_decode_attention(q, cache, layer=0)
    outs = [tpa.paged_decode_attention(q, cache, layer=0)
            for _ in range(500)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    ref = tpa.paged_decode_attention_plain(q, cache, layer=0)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert _per_slot_ok(first, ref, cache.lengths, tol)


@pytest.mark.parametrize("cold", [False, True])
def test_paged_append_blocks_cold_and_warm_bit_equal(dev, cold):
    """B8 at the (s4) shape (32 blocks of [64, 8, 128] bf16 into
    [4, 512, 64, 8, 128] pools) equals its plain version bit for bit,
    warm (one source set every call) and cold (eight source sets and
    destinations in turn, more bytes than L2 holds), pad blocks on the
    trash block 0 (their rows equal, so the duplicate writes' order does
    not matter)."""
    g = torch.Generator(device=dev).manual_seed(11)
    rng = np.random.default_rng(11)
    kp, vp = (torch.randn(4, 512, 64, 8, 128, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    want = [kp.clone(), vp.clone()]
    before = _build.launch_counts["paged_append_blocks"]
    sets = []
    for _ in range(8 if cold else 1):
        kb, vb = (torch.randn(32, 64, 8, 128, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        ids = rng.permutation(np.arange(1, 512))[:32].astype(np.int32)
        ids[[5, 20]] = 0
        kb[20], vb[20] = kb[5], vb[5]
        sets.append((kb, vb, torch.as_tensor(ids, device=dev)))
    n = len(sets)
    for i in range(3 * n):
        kb, vb, ids = sets[i % n]
        tpa.paged_append_blocks(kp, vp, kb, vb, ids, layer=i % 4)
        tpa.paged_append_blocks_plain(*want, kb, vb, ids, i % 4)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_append_blocks"] == before + 3 * n
    assert torch.equal(kp, want[0]) and torch.equal(vp, want[1])


@pytest.mark.parametrize("five_d", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("N", [1, 8, 64, 256, 1000])
def test_paged_append_token_edges_match_plain(dev, N, D, dtype, five_d):
    """B7 at its grid's edges (one slot; (s4)'s 8; 64, 256 and 1000
    slots, one block a slot; rows of 1, 2 and 4 KB: a block of 64 or 128
    vectors, or two of 128), layer 1 of three or a 4-D pool: bit-equal to
    its plain version, with a quarter of the slots on one trash position
    (block 0, offset 3), each with its own row: that position takes one of
    its writers' rows whole (the last one's, as on the TPU), and every
    other element equals the plain version's."""
    rng = np.random.default_rng(N + D)
    g = torch.Generator(device=dev).manual_seed(N + D)
    NB, BS, hkv = 160, 16, 8
    layer = 1 if five_d else 0
    shape = ((3,) if five_d else ()) + (NB, BS, hkv, D)
    kp, vp = (torch.randn(shape, generator=g, device=dev).to(dtype)
              for _ in range(2))
    new = [torch.randn(N, hkv, D, generator=g, device=dev).to(dtype)
           for _ in range(2)]
    pos = rng.permutation((NB - 1) * BS)[:N] + BS    # blocks 1 .. NB-1
    blk, off = pos // BS, pos % BS
    trash = rng.permutation(N)[:N // 4]
    blk[trash], off[trash] = 0, 3
    blk, off = (torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (blk, off))
    got, want = [kp.clone(), vp.clone()], [kp.clone(), vp.clone()]
    before = _build.launch_counts["paged_append_token"]
    tpa.paged_append_token(*got, *new, blk, off, layer=layer)
    tpa.paged_append_token_plain(*want, *new, blk, off, layer)
    torch.cuda.synchronize()
    assert _build.launch_counts["paged_append_token"] == before + 1
    for a, b, rows in zip(got, want, new):
        a5, b5 = tpa._as5d(a)[layer], tpa._as5d(b)[layer]
        if len(trash):
            assert torch.equal(a5[0, 3], rows[trash.max()])
            a5[0, 3] = b5[0, 3]
        assert torch.equal(a, b)


def test_paged_append_token_after_torch_ops(dev):
    """B7 launched right after torch ops on the same stream that write
    its inputs (cuBLAS GEMMs for the new rows, an elementwise op for the
    offsets, last: predecessors that never signal a dependent launch)
    writes what its plain version writes from the same tensors."""
    g = torch.Generator(device=dev).manual_seed(3)
    N, hkv, D, BS = 8, 8, 128, 64
    kp, vp = (torch.randn(4, 64, BS, hkv, D, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    x = torch.randn(N, 32768, generator=g, device=dev).to(torch.bfloat16)
    wk, wv = (torch.randn(32768, hkv * D, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    table = torch.arange(1, 1 + N * 7, dtype=torch.int32,
                         device=dev).reshape(N, 7)
    lens = torch.tensor([0, 1, 64, 400, 77, 128, 150, 33],
                        dtype=torch.int32, device=dev)
    got, want = [kp.clone(), vp.clone()], [kp.clone(), vp.clone()]
    torch.cuda.synchronize()
    for step in range(3):
        blk = table.gather(1, ((lens + step) // BS).long()[:, None])[:, 0]
        k_new = (x @ wk).view(N, hkv, D)
        v_new = (x @ wv).view(N, hkv, D)
        off = (lens + step) % BS
        tpa.paged_append_token(*got, k_new, v_new, blk, off, layer=step)
        torch.cuda.synchronize()
        tpa.paged_append_token_plain(*want, k_new, v_new, blk, off, step)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_append_then_attend_chain_back_to_back(dev, dtype):
    """The API's decode sequence (B7 appends at (s4)'s lengths, B6 attends
    at lengths + 1), 500 times back to back over 4 pool layers with a new
    row each time: each B6 output is bit-equal to the same call made
    after a synchronize, and slot 0 (length 0 to 1) returns its appended
    V row: B6's wait sees B7's stores."""
    rng = np.random.default_rng(17)
    g = torch.Generator(device=dev).manual_seed(17)
    N, G, hkv, D, BS, MB, L, calls = 8, 4, 8, 128, 64, 32, 4, 500
    table = torch.as_tensor(rng.permutation(np.arange(1, N * MB + 1))
                            .reshape(N, MB).astype(np.int32), device=dev)
    lens = torch.tensor([0, 1, 64, 2000, 777, 128, 1500, 33],
                        dtype=torch.int32, device=dev)
    kp, vp = (torch.randn(L, N * MB + 1, BS, hkv, D, generator=g,
                          device=dev).to(dtype) for _ in range(2))
    q = torch.randn(N, G * hkv, D, generator=g, device=dev).to(dtype)
    k_rows, v_rows = (torch.randn(calls, N, hkv, D, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
    blk = table.gather(1, (lens // BS).long()[:, None])[:, 0]
    off = lens % BS
    cache = tpa.PagedKVCache(kp, vp, table, lens + 1)
    torch.cuda.synchronize()
    outs = []
    for i in range(calls):
        tpa.paged_append_token(kp, vp, k_rows[i], v_rows[i], blk, off,
                               layer=i % L)
        outs.append(tpa.paged_decode_attention(q, cache, layer=i % L))
    torch.cuda.synchronize()
    for i in range(calls):
        tpa.paged_append_token(kp, vp, k_rows[i], v_rows[i], blk, off,
                               layer=i % L)
        torch.cuda.synchronize()
        again = tpa.paged_decode_attention(q, cache, layer=i % L)
        torch.cuda.synchronize()
        assert torch.equal(outs[i], again), i
        assert torch.equal(outs[i][0].view(hkv, G, D),
                           v_rows[i][0][:, None].expand(hkv, G, D)), i
    ref = tpa.paged_decode_attention_plain(q, cache, layer=(calls - 1) % L)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert _per_slot_ok(outs[-1], ref, cache.lengths, tol)


# ---------------------------------------------------------------------------
# the host-streamed and layer-wise train steps (optimizer/offload.py)
# ---------------------------------------------------------------------------
def _small_llama_numpy(L=3, h=256, nq=2, nkv=1, f=512, V=512, seed=0):
    """A small f32 llama with the flash kernels' head dimension (128), its
    weights made with numpy, and a zero layer-wise second-moment tree."""
    import dataclasses
    from paddle_tpu_torch.models import llama as tl
    cfg = dataclasses.replace(
        tl.tiny_llama(vocab=V, hidden=h, layers=L, heads=nq, kv_heads=nkv,
                      seq=128, ffn=f), head_dim=h // nq, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    d = h // nq

    def rnd(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2] if
                                                     len(shape) > 1 else 1)
                ).astype(np.float32)

    tree = {"embed": rnd(V, h), "final_norm": np.ones(h, np.float32),
            "lm_head": rnd(h, V),
            "layers": {"attn_norm": np.ones((L, h), np.float32),
                       "wq": rnd(L, h, nq * d), "wk": rnd(L, h, nkv * d),
                       "wv": rnd(L, h, nkv * d), "wo": rnd(L, nq * d, h),
                       "mlp_norm": np.ones((L, h), np.float32),
                       "w_gate": rnd(L, h, f), "w_up": rnd(L, h, f),
                       "w_down": rnd(L, f, h)}}

    def nu_of(a, stacked):
        if a.ndim - stacked >= 2:
            return {"vr": np.zeros(a.shape[:-1], np.float32),
                    "vc": np.zeros(a.shape[:-2] + a.shape[-1:], np.float32)}
        return {"v": np.zeros(a.shape, np.float32)}

    nu = {k: ({kk: nu_of(vv, 1) for kk, vv in v.items()} if k == "layers"
              else nu_of(v, 0)) for k, v in tree.items()}
    return cfg, tree, nu


def _rel_close(got, want, rel):
    for a, b in zip(_leaves(got), _leaves(want)):
        a, b = a.float().cpu(), b.float().cpu()
        assert (a - b).abs().max().item() <= rel * b.abs().max().item()


def _leaves(tree):
    """The tensors of a nested dict, or of lists of them."""
    from paddle_tpu_torch.optimizer.functional import tree_leaves
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return tree_leaves(tree)


def test_streaming_step_on_card_equals_layerwise(dev):
    """Three host-streamed steps on the card against three layer-wise
    steps on the card from the same numpy weights (f32, 3 layers, heads
    of 128): losses within 2e-5 relative, parameters and second moments
    within 1e-4 of each leaf's largest magnitude. Between steps every
    layer leaf lies in pinned host memory, in blocks of exactly the
    layers' bytes (each leaf rounded up to 256), and the device holds no
    layer."""
    from paddle_tpu_torch.optimizer import offload as to
    cfg, tree, nu = _small_llama_numpy()
    lw = to.layerwise_state_from_numpy(tree, nu, device=dev)
    st = to.streaming_state_from_layerwise(
        to.layerwise_state_from_numpy(tree, nu, device=dev))
    step_l = to.make_layerwise_train_step(cfg, lr=1e-2)
    step_s = to.make_streaming_train_step(cfg, lr=1e-2, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=g,
                         device=dev)
    want = sum(-(-t.numel() * t.element_size() // 256) * 256
               for t in _leaves([st.layers, st.nu_layers]))
    for _ in range(3):
        lw, loss_l = step_l(lw, toks)
        st, loss_s = step_s(st, toks)
        layer_leaves = _leaves([st.layers, st.nu_layers])
        assert all(t.device.type == "cpu" and t.is_pinned()
                   for t in layer_leaves)
        assert to.pinned_bytes([st.layers, st.nu_layers]) == want
        assert abs(loss_s.item() - loss_l.item()) <= 2e-5 * abs(loss_l.item())
    back = to.layerwise_state_from_streaming(st)
    _rel_close(back.params, lw.params, 1e-4)
    _rel_close(back.nu, lw.nu, 1e-4)


def test_offload_step_on_card_keeps_moments_pinned(dev):
    """Two offload steps (adamw, gradients and moments through pinned host
    memory) against llama.train_step on the card from the same weights:
    losses within 2e-5 relative, parameters within 1e-4 of each leaf's
    largest magnitude; the moments lie in pinned host memory between
    steps."""
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.optimizer import functional as tf
    from paddle_tpu_torch.optimizer import offload as to
    cfg, tree, _ = _small_llama_numpy(L=2)
    params = tl.params_from_numpy(tree, device=dev)
    mu, nu = tf.init_moments(params, "adamw")
    ref = tl.TrainState(params, mu, nu,
                        torch.zeros((), dtype=torch.int32, device=dev))
    st = tl.TrainState(tl.params_from_numpy(tree, device=dev),
                       to.host_put(mu, dev), to.host_put(nu, dev),
                       torch.zeros((), dtype=torch.int32, device=dev))
    step = to.make_offload_train_step(tl, cfg, offload_moments=True)
    g = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=g,
                         device=dev)
    for _ in range(2):
        st, loss = step(st, toks)
        ref, rloss = tl.train_step(ref, toks, cfg)
        assert all(t.device.type == "cpu" and t.is_pinned()
                   for t in _leaves([st.mu, st.nu]))
        assert abs(loss.item() - rloss.item()) <= 2e-5 * abs(rloss.item())
    torch.cuda.synchronize()
    _rel_close(st.params, ref.params, 1e-4)
