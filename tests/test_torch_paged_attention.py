"""The port's ragged paged-decode walk (paddle_tpu_torch.kernels.
paged_attention) held to the JAX Pallas kernel (interpret mode on the
CPU) on acc, m and l, mirroring tests/test_paged_attention_ragged.py:
mixed lengths (0, 1, exact block, partial last block, full table), shared
history blocks, and layer selection in [L, NB, BS, Hkv, D] pools. The
CUDA kernel is held to the plain version in test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax.numpy as jnp

from paddle_tpu.kernels.paged_attention import PagedKVCache as JaxCache
from paddle_tpu.kernels.paged_attention import paged_attention as jax_paged
from paddle_tpu.kernels.paged_attention import ragged_decode_partial as jax_ragged
from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BS, HKV, G, D, MB = 4, 2, 2, 16, 4


def _mk(seed, n_slots, lens, layers=1):
    rng = np.random.default_rng(seed)
    nb = n_slots * MB + 1
    kp = rng.standard_normal((layers, nb, BS, HKV, D)).astype(np.float32)
    vp = rng.standard_normal((layers, nb, BS, HKV, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, nb)).reshape(n_slots, MB)
    q = rng.standard_normal((n_slots, G * HKV, D)).astype(np.float32)
    return q, kp, vp, table.astype(np.int32), np.asarray(lens, np.int32)


def _both(q, kp, vp, table, lens, layer=0):
    want = jax_ragged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), layer=layer)
    got = tpa.ragged_decode_partial(
        torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(table), torch.as_tensor(lens), layer=layer)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_partials_close(want, got):
    for w, g, name in zip(want, got, ("acc", "m", "l")):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("lens", [[1, BS, 2 * BS + 3, MB * BS],
                                  [0, 3, BS + 1, 2 * BS]])
def test_partials_match_pallas_kernel(lens):
    """Mixed lengths: 0 (the combine identity), 1, an exact block, a
    partial last block and the full table."""
    want, got = _both(*_mk(len(lens) + lens[0], 4, lens))
    _assert_partials_close(want, got)
    if lens[0] == 0:
        acc, m, l = got
        assert np.all(acc[0] == 0) and np.all(l[0] == 0)
        assert np.all(m[0] == np.float32(-1e30))


def test_partials_with_shared_history_blocks():
    """Two slots pin the SAME physical history blocks (a prefix-cache hit
    shape) and diverge in their private tails."""
    q, kp, vp, table, lens = _mk(3, 2, [2 * BS + 2, 3 * BS + 1])
    table[1, :2] = table[0, :2]
    _assert_partials_close(*_both(q, kp, vp, table, lens))


def test_partials_select_the_layer_plane():
    q, kp, vp, table, lens = _mk(4, 2, [BS + 2, 3 * BS], layers=3)
    want, got = _both(q, kp, vp, table, lens, layer=2)
    _assert_partials_close(want, got)
    other = _both(q, kp, vp, table, lens, layer=1)[1]
    assert not np.allclose(other[0], got[0])


def test_normalized_decode_matches_reference_paged_attention():
    q, kp, vp, table, lens = _mk(5, 4, [1, BS, 2 * BS + 3, MB * BS])
    want = jax_paged(jnp.asarray(q), JaxCache(
        jnp.asarray(kp[0]), jnp.asarray(vp[0]), jnp.asarray(table),
        jnp.asarray(lens)))
    cache = tpa.PagedKVCache(torch.as_tensor(kp[0]), torch.as_tensor(vp[0]),
                             torch.as_tensor(table), torch.as_tensor(lens))
    got = tpa.ragged_paged_decode(torch.as_tensor(q), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        tpa.paged_attention(torch.as_tensor(q), cache).numpy(),
        np.asarray(want), atol=1e-5)


def test_unported_forms_raise():
    q, kp, vp, table, lens = (torch.as_tensor(a)
                              for a in _mk(6, 2, [1, 2]))
    # int8 pools are ported; without their scale pools they raise
    with pytest.raises(ValueError, match="ks_pool/vs_pool"):
        tpa.ragged_decode_partial(q, kp.to(torch.int8), vp.to(torch.int8),
                                  table, lens)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpa.ragged_decode_partial(q, kp, vp, table, lens, mesh=object())
    with pytest.raises(ValueError):
        tpa.ragged_decode_partial(q.to("meta"), kp, vp, table, lens)


# ---------------------------------------------------------------------------
# the kernel's split walk (csrc/ragged_decode.cu): its schedule, mirrored in
# tpa.ragged_schedule, and its ordered merge of a walk's parts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n,hkv,tile,grid", [
    (0, 1, 8, 32, 132), (1, 8, 8, 32, 132), (2, 64, 8, 32, 132),
    (3, 5, 2, 64, 7), (4, 3, 1, 4, 192), (5, 17, 4, 32, 1),
    (6, 8, 8, 64, 192), (7, 2, 8, 32, 131)])
def test_schedule_covers_each_position_once(seed, n, hkv, tile, grid):
    """Every (slot, kv head) walk is cut into parts on tile boundaries, one
    a block, in consecutive blocks; the parts cover each of the slot's
    positions exactly once (a length-0 slot: one empty tile); no block
    takes more than ceil(total / grid) tiles."""
    mb, bs = 32, 64
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, mb * bs + 100, size=n)
    lens[0] = 0 if n > 1 else lens[0]
    rows = tpa.ragged_schedule(lens.tolist(), hkv, mb, bs, tile, grid)
    true = [min(int(x), mb * bs) for x in lens]
    tiles = [max(1, -(-x // tile)) for x in true]
    per = -(-hkv * sum(tiles) // grid)
    load = np.zeros(grid, int)
    walks = {}
    for b, s, hk, ta, tb, t, parts in rows:
        assert 0 <= b < grid and 0 <= ta < tb <= t == tiles[s]
        load[b] += tb - ta
        walks.setdefault((s, hk), []).append((b, ta, tb, parts))
    assert load.max() <= per and load.sum() == hkv * sum(tiles)
    assert sorted(walks) == [(s, hk) for s in range(n) for hk in range(hkv)]
    for (s, hk), ps in walks.items():
        assert ps[0][1] == 0 and ps[-1][2] == tiles[s]
        for a, b in zip(ps, ps[1:]):
            assert b[0] == a[0] + 1 and b[1] == a[2]
        assert all(p[3] == len(ps) for p in ps)
        covered = np.zeros(true[s], int)
        for _b, ta, tb, _p in ps:
            covered[ta * tile:min(tb * tile, true[s])] += 1
        assert np.all(covered == 1)


def _split_inputs(pools, seed=9):
    """Five slots (lengths 0, 1, one block, a partial block, the full
    table) over two-layer pools: f32, f32 holding bf16 values, or int8
    with f32 scales (``quantize_kv``); f32 queries."""
    from paddle_tpu_torch.kernels.quant_matmul import quantize_kv
    q, kp, vp, table, _ = _mk(seed, 5, [1] * 5, layers=2)
    lens = np.array([0, 1, BS, 2 * BS + 3, MB * BS], np.int32)
    if pools == "bf16 data":
        q, kp, vp = (np.asarray(torch.as_tensor(a).bfloat16().float())
                     for a in (q, kp, vp))
    ks = vs = None
    if pools == "int8":
        qk, ks = quantize_kv(torch.as_tensor(kp))
        qv, vs = quantize_kv(torch.as_tensor(vp))
        kp, vp, ks, vs = (t.numpy() for t in (qk, qv, ks, vs))
    return q, kp, vp, table, lens, ks, vs


@pytest.mark.parametrize("pools", ["f32", "bf16 data", "int8"])
@pytest.mark.parametrize("tile,grid", [(4, 7), (4, 3), (8, 5), (32, 132)])
def test_split_merge_matches_unsplit_and_pallas(pools, tile, grid):
    """The plain walk cut into the schedule's parts and merged in part
    order equals the unsplit plain walk and the JAX kernel (Pallas,
    interpret mode) within f32 1e-5, layer 1 of two; tiles of 4 and 8
    positions split these short walks into parts."""
    q, kp, vp, table, lens, ks, vs = _split_inputs(pools)
    tq = [torch.as_tensor(a) for a in (q, kp, vp, table, lens)]
    scales = {} if ks is None else dict(ks_pool=torch.as_tensor(ks),
                                        vs_pool=torch.as_tensor(vs))
    rows = tpa.ragged_schedule(lens.tolist(), HKV, MB, BS, tile, grid)
    if tile < 32:
        assert max(r[6] for r in rows) >= 2
    split = tpa.ragged_decode_partial_split_plain(*tq, 1, tile=tile,
                                                  grid=grid, **scales)
    whole = tpa.ragged_decode_partial_plain(*tq, 1, **scales)
    jscales = {} if ks is None else dict(ks_pool=jnp.asarray(ks),
                                         vs_pool=jnp.asarray(vs))
    want = jax_ragged(*(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
                      layer=1, **jscales)
    for got, ref, w, name in zip(split, whole, want, ("acc", "m", "l")):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert torch.all(split[0][0] == 0) and torch.all(split[2][0] == 0)
    assert torch.all(split[1][0] == -1e30)


def test_split_merge_bf16_pools_within_the_kernels_tolerance():
    """bf16 pools round each part's probabilities to bf16 against that
    part's own maximum (as the kernel's tiles and the TPU kernel's do), so
    the split walk differs from the unsplit one at bf16's precision: the
    normalized output within 1e-2 of its largest magnitude, the
    tolerance chip_smoke.py holds the bf16 kernel to."""
    q, kp, vp, table, lens, _, _ = _split_inputs("f32")
    tq = [torch.as_tensor(a) for a in (q, kp, vp, table, lens)]
    tq = [t.bfloat16() if t.is_floating_point() else t for t in tq]
    split = tpa.ragged_decode_partial_split_plain(*tq, 1, tile=4, grid=7)
    whole = tpa.ragged_decode_partial_plain(*tq, 1)
    out = split[0][1:] / split[2][1:, ..., None]
    ref = whole[0][1:] / whole[2][1:, ..., None]
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()
    torch.testing.assert_close(split[1], whole[1], atol=1e-5, rtol=0)


def test_merge_parts_is_the_flash_decoding_combine():
    """merge_parts of (acc, m, l) states, one of them empty (the identity
    (0, -1e30, 0)), equals the softmax-weighted sum over their union."""
    rng = np.random.default_rng(3)
    s = torch.as_tensor(rng.standard_normal((2, 12)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((2, 12, 5)), dtype=torch.float32)

    def state(lo, hi):
        if lo == hi:
            return (torch.zeros(2, 5), torch.full((2,), -1e30),
                    torch.zeros(2))
        m = s[:, lo:hi].amax(-1)
        p = torch.exp(s[:, lo:hi] - m[:, None])
        return torch.einsum("nt,ntd->nd", p, v[:, lo:hi]), m, p.sum(-1)
    acc, m, l = tpa.merge_parts([state(0, 5), state(5, 5), state(5, 12)])
    ref = torch.einsum("nt,ntd->nd", torch.softmax(s, -1), v)
    torch.testing.assert_close(acc / l[:, None], ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(m, s.amax(-1))
