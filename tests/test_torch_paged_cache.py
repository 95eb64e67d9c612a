"""The port's paged-cache API (paddle_tpu_torch.kernels.paged_attention:
``paged_cache_init``, ``paged_append``, B7 ``paged_append_token``, B8
``paged_append_blocks``, B6 ``paged_decode_attention``) held to the JAX
package on the CPU, its Pallas kernels in interpret mode, on the same
numpy-made inputs. The appends must be exact on 4-D and 5-D pools; B6
within 1e-5 (f32), with 0 for a zero-length slot. The CUDA kernels are
held to these plain versions in test_torch_kernels_cuda.py.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax.numpy as jnp

from paddle_tpu_torch.kernels import paged_attention as tpa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the module (paddle_tpu.kernels re-exports its function of the same name)
jpa = importlib.import_module("paddle_tpu.kernels.paged_attention")

N, BS, HKV, D, MB = 3, 4, 2, 8, 4


def _pools(rng, layers):
    nb = N * MB + 1
    shape = ((layers,) if layers else ()) + (nb, BS, HKV, D)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _table(rng):
    return rng.permutation(np.arange(1, N * MB + 1)).reshape(N, MB) \
        .astype(np.int32)


def test_cache_init_and_append_match_jax():
    """``paged_cache_init``'s layout and ``paged_append`` (one token a
    sequence at its length) against the JAX package's, three appends
    deep, crossing a block boundary."""
    want = jpa.paged_cache_init(N, N * MB, BS, HKV, D, MB, dtype=jnp.float32)
    got = tpa.paged_cache_init(N, N * MB, BS, HKV, D, MB,
                               dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.block_table.numpy(),
                                  np.asarray(want.block_table))
    rng = np.random.default_rng(0)
    lens = np.array([0, 3, 7], np.int32)
    want = want._replace(lengths=jnp.asarray(lens))
    got = got._replace(lengths=torch.as_tensor(lens))
    for _ in range(3):
        k, v = (rng.standard_normal((N, HKV, D)).astype(np.float32)
                for _ in range(2))
        want = jpa.paged_append(want, jnp.asarray(k), jnp.asarray(v))
        got = tpa.paged_append(got, torch.as_tensor(k), torch.as_tensor(v))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("layers,layer", [(0, 0), (3, 2)])
def test_append_token_and_blocks_match_jax(layers, layer):
    """B7 and B8 write exactly what the JAX kernels write, in place, on
    [NB, BS, Hkv, D] and [L, NB, BS, Hkv, D] pools (the token append's
    idle slot and the block append's pad blocks on the trash block 0)."""
    rng = np.random.default_rng(1 + layers)
    kp, vp = _pools(rng, layers)
    k_new, v_new = (rng.standard_normal((N, HKV, D)).astype(np.float32)
                    for _ in range(2))
    blk = np.array([5, 0, 9], np.int32)
    off = np.array([1, 3, 0], np.int32)
    want = jpa.paged_append_token(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(k_new), jnp.asarray(v_new),
                                  jnp.asarray(blk), jnp.asarray(off),
                                  layer=layer)
    tk, tv = torch.as_tensor(kp.copy()), torch.as_tensor(vp.copy())
    got = tpa.paged_append_token(tk, tv, torch.as_tensor(k_new),
                                 torch.as_tensor(v_new), torch.as_tensor(blk),
                                 torch.as_tensor(off), layer=layer)
    assert got[0] is tk and got[1] is tv          # in place, shape kept
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    kb, vb = (rng.standard_normal((4, BS, HKV, D)).astype(np.float32)
              for _ in range(2))
    ids = np.array([7, 0, 2, 0], np.int32)        # pad blocks -> trash
    # the two pad blocks carry the same rows, so the trash block's result
    # does not depend on the order of the duplicate writes
    kb[3], vb[3] = kb[1], vb[1]
    want = jpa.paged_append_blocks(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kb), jnp.asarray(vb),
                                   jnp.asarray(ids), layer=layer)
    tk, tv = torch.as_tensor(kp.copy()), torch.as_tensor(vp.copy())
    got = tpa.paged_append_blocks(tk, tv, torch.as_tensor(kb),
                                  torch.as_tensor(vb), torch.as_tensor(ids),
                                  layer=layer)
    assert got[0] is tk and got[1] is tv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("layers,layer", [(0, 0), (2, 1)])
def test_decode_attention_matches_jax(G, layers, layer):
    """B6's plain version against the JAX kernel (interpret mode) within
    1e-5: lengths 0 (the result is 0, not paged_attention's mean over
    masked rows), 1 block exactly, and the full table; G = 3 (the chip
    test's group) and 4."""
    rng = np.random.default_rng(10 * G + layers)
    kp, vp = _pools(rng, layers)
    table = _table(rng)
    lens = np.array([0, BS, MB * BS], np.int32)
    q = rng.standard_normal((N, G * HKV, D)).astype(np.float32)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jpa.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(table),
                                         jnp.asarray(lens)), layer=layer))
    got = tpa.paged_decode_attention(
        torch.as_tensor(q), tpa.PagedKVCache(
            torch.as_tensor(kp), torch.as_tensor(vp), torch.as_tensor(table),
            torch.as_tensor(lens)), layer=layer).numpy()
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got[0] == 0)
    # the dense-gather reference agrees wherever the length is > 0
    ref = tpa.paged_attention(torch.as_tensor(q), tpa.PagedKVCache(
        torch.as_tensor(kp if not layers else kp[layer]),
        torch.as_tensor(vp if not layers else vp[layer]),
        torch.as_tensor(table), torch.as_tensor(lens))).numpy()
    np.testing.assert_allclose(got[1:], ref[1:], atol=1e-5, rtol=0)


def test_api_path_bf16():
    """The chip test's path at a small size, bf16 pools: decode attention
    against the dense-gather oracle, then a token append against
    ``paged_append`` and a block append against a plain scatter — the
    appends bit-equal, the attention within bf16 rounding."""
    rng = np.random.default_rng(3)
    G = 3
    kp, vp = (torch.as_tensor(a).to(torch.bfloat16) for a in _pools(rng, 0))
    table = torch.as_tensor(_table(rng))
    lens = torch.as_tensor(rng.integers(3, MB * BS - 1, size=N)
                           .astype(np.int32))
    q = torch.randn(N, G * HKV, D, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    cache = tpa.PagedKVCache(kp, vp, table, lens)
    out = tpa.paged_decode_attention(q, cache).float()
    ref = tpa.paged_attention(q, cache).float()
    assert (out - ref).abs().max().item() <= 2e-2
    k_new = torch.randn(N, HKV, D).to(torch.bfloat16)
    v_new = torch.randn(N, HKV, D).to(torch.bfloat16)
    cref = tpa.paged_append(tpa.PagedKVCache(kp.clone(), vp.clone(), table,
                                             lens), k_new, v_new)
    blk = table.long().gather(1, (lens.long() // BS)[:, None])[:, 0].int()
    kp2, vp2 = tpa.paged_append_token(kp.clone(), vp.clone(), k_new, v_new,
                                      blk, (lens % BS).int())
    assert torch.equal(kp2, cref.k_pool) and torch.equal(vp2, cref.v_pool)
    kb = torch.randn(2, BS, HKV, D).to(torch.bfloat16)
    bids = torch.tensor([4, 9], dtype=torch.int32)
    kp3, _ = tpa.paged_append_blocks(kp.clone(), vp.clone(), kb, kb, bids)
    want = kp.clone()
    want[bids.long()] = kb
    assert torch.equal(kp3, want)


def test_decode_attention_wrapper_checks():
    """Bad inputs fail loudly before any kernel: a device the port does
    not run on raises, as does a pool too small for its table."""
    with pytest.raises(ValueError, match="cannot back"):
        tpa.paged_cache_init(2, 3, BS, HKV, D, 2, device="cpu")
    q = torch.zeros(1, HKV, D).to("meta")
    cache = tpa.PagedKVCache(*(torch.zeros(1).to("meta") for _ in range(4)))
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_decode_attention(q, cache)


# B6's split walk (csrc/paged_decode.cu: the walks' 32-position tiles dealt
# over a persistent grid, pass 1 the parts' maxima, pass 2 the parts' sums
# at the walk's maximum, merged in part order): lengths 0, 1, on and
# beside tile edges, the whole table and past it (clamped).
_EDGE_LENS = [0, 1, 31, 32, 33, 63, 64, 65, 96, 200]
_EDGE_BS, _EDGE_MB = 16, 6


@pytest.mark.parametrize("G,D", [(1, 64), (3, 128), (4, 64), (8, 128)])
def test_decode_split_plain_matches_plain_and_jax(G, D):
    """``paged_decode_attention_split_plain`` (the kernel's schedule and
    merge, at grids that cut walks into parts and one that leaves them
    whole) equals ``paged_decode_attention_plain`` within 1e-6 and the
    JAX Pallas kernel (interpret mode) within 1e-5, f32; a zero-length
    slot is 0."""
    rng = np.random.default_rng(G * D)
    n, hkv = len(_EDGE_LENS), 2
    nb = n * _EDGE_MB + 1
    kp, vp = (rng.standard_normal((2, nb, _EDGE_BS, hkv, D))
              .astype(np.float32) for _ in range(2))
    table = rng.permutation(np.arange(1, nb)).reshape(n, _EDGE_MB) \
        .astype(np.int32)
    lens = np.array(_EDGE_LENS, np.int32)
    q = rng.standard_normal((n, G * hkv, D)).astype(np.float32)
    cache = tpa.PagedKVCache(torch.as_tensor(kp), torch.as_tensor(vp),
                             torch.as_tensor(table), torch.as_tensor(lens))
    plain = tpa.paged_decode_attention_plain(torch.as_tensor(q), cache, 1)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jpa.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(table),
                                         jnp.asarray(lens)), layer=1))
    for grid in (3, 7, 132):
        got = tpa.paged_decode_attention_split_plain(
            torch.as_tensor(q), cache, 1, grid=grid)
        assert torch.all(got[0] == 0)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_decode_split_plain_bf16_rounds_p_at_the_global_max():
    """bf16 pools: the split form rounds p against each walk's global
    maximum, as the one-shot softmax does, so it matches the plain version
    to bf16 output rounding however the grid cuts the walks."""
    rng = np.random.default_rng(4)
    n, hkv, G, D = len(_EDGE_LENS), 2, 4, 64
    nb = n * _EDGE_MB + 1
    kp, vp = (torch.as_tensor(rng.standard_normal((nb, _EDGE_BS, hkv, D))
                              .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    table = torch.as_tensor(rng.permutation(np.arange(1, nb))
                            .reshape(n, _EDGE_MB).astype(np.int32))
    cache = tpa.PagedKVCache(kp, vp, table,
                             torch.as_tensor(np.array(_EDGE_LENS, np.int32)))
    q = torch.as_tensor(rng.standard_normal((n, G * hkv, D))
                        .astype(np.float32)).to(torch.bfloat16)
    plain = tpa.paged_decode_attention_plain(q, cache).float()
    for grid in (2, 5, 132):
        got = tpa.paged_decode_attention_split_plain(q, cache, grid=grid)
        assert got.dtype == torch.bfloat16
        # one bf16 rounding of the output apart (2^-8 relative)
        assert torch.all((got.float() - plain).abs()
                         <= 2 ** -8 * plain.abs() + 1e-6)


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
@pytest.mark.parametrize("tile", [32, 64])
def test_decode_schedule_covers_each_position_once(grid, tile):
    """The kernel's schedule deals every position under each slot's
    (clamped) length to exactly one part of its walk, every walk of every
    kv head (a zero-length slot one empty tile), the parts of a walk in
    consecutive blocks, no block past the grid."""
    hkv, mb, bs = 3, _EDGE_MB, _EDGE_BS
    cap = mb * bs
    rows = tpa.ragged_schedule(_EDGE_LENS, hkv, mb, bs, tile, grid)
    covered = {}
    for b, n, hk, ta, tb, t, nparts in rows:
        assert 0 <= b < grid and 0 <= ta < tb <= t
        covered.setdefault((n, hk), []).append((b, ta, tb, nparts))
    assert set(covered) == {(n, hk) for n in range(len(_EDGE_LENS))
                            for hk in range(hkv)}
    for (n, hk), parts in covered.items():
        length = min(_EDGE_LENS[n], cap)
        seen = np.zeros(max(length, 1), int)
        for b, ta, tb, nparts in parts:
            seen[ta * tile:min(length, tb * tile)] += 1
            assert nparts == len(parts)
        assert np.all(seen[:length] == 1)
        blocks = [b for b, *_ in parts]
        assert blocks == list(range(blocks[0], blocks[0] + len(blocks)))


def _decode_inputs(N=3, G=4, D=64, hkv=2, dtype=torch.bfloat16, L=2):
    g = torch.Generator().manual_seed(0)
    kp, vp = (torch.randn(L, 2 * N + 1, 16, hkv, D, generator=g).to(dtype)
              for _ in range(2))
    q = torch.randn(N, G * hkv, D, generator=g).to(dtype)
    table = torch.arange(1, 2 * N + 1, dtype=torch.int32).reshape(N, 2)
    return q, kp, vp, table, torch.full((N,), 20, dtype=torch.int32)


# Inputs B6's kernel does not take, each with the error the wrapper raises
# (the same before the wrapper's one-expression check as after it).
_DECODE_BAD = {
    "f16": (lambda q, kp, vp, t, n: (q.half(), kp.half(), vp.half(), t, n),
            TypeError, "bf16 or f32"),
    "pool_dtype": (lambda q, kp, vp, t, n: (q, kp.float(), vp, t, n),
                   TypeError, "bf16 or f32"),
    "head_dim": (lambda q, kp, vp, t, n: (q[..., :32].contiguous(),
                                          kp[..., :32].contiguous(),
                                          vp[..., :32].contiguous(), t, n),
                 ValueError, "head_dim 64 or 128"),
    "group": (lambda q, kp, vp, t, n: (q.repeat(1, 3, 1), kp, vp, t, n),
              ValueError, "query heads a kv head"),
    "pools_differ": (lambda q, kp, vp, t, n: (q, kp, vp[:, :-1].contiguous(),
                                              t, n),
                     ValueError, "do not match"),
    "table_int64": (lambda q, kp, vp, t, n: (q, kp, vp, t.long(), n),
                    ValueError, "int32"),
    "lengths_shape": (lambda q, kp, vp, t, n: (q, kp, vp, t, n[:-1]),
                      ValueError, "int32"),
    "table_strided": (lambda q, kp, vp, t, n: (q, kp, vp, t.t().contiguous()
                                               .t(), n),
                      ValueError, "not contiguous"),
    "pool_offset": (lambda q, kp, vp, t, n: (
        q, kp.flatten()[4:4 + vp[:, 1:].numel()].view(vp[:, 1:].shape),
        vp[:, 1:].contiguous(), t, n), ValueError, "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(_DECODE_BAD))
def test_decode_fits_refuses_what_explain_raises(case):
    """B6's wrapper checks through one cheap expression (``_decode_fits``)
    and raises from ``_decode_explain``: for each input the kernel does
    not take, the first is False and the second raises its error; for
    good inputs the first is True and the second passes."""
    good = _decode_inputs()
    assert tpa._decode_fits(*good, 1)
    tpa._decode_explain(*good, 1)
    make, exc, words = _DECODE_BAD[case]
    q, kp, vp, table, lengths = make(*good)
    assert not tpa._decode_fits(q, kp, vp, table, lengths, 1)
    with pytest.raises(exc, match=words):
        tpa._decode_explain(q, kp, vp, table, lengths, 1)


def test_decode_slot_limit_names_paged_decode_attention():
    """Past 511 slots B6's wrapper refuses the call in its own name."""
    q, kp, vp, table, lengths = _decode_inputs(N=512)
    assert not tpa._decode_fits(q, kp, vp, table, lengths, 0)
    with pytest.raises(ValueError, match="paged_decode_attention takes at "
                                         "most 511 slots a call, got 512"):
        tpa._decode_explain(q, kp, vp, table, lengths, 0)
    assert not tpa._decode_fits(*_decode_inputs(), 2)   # layer out of range
    with pytest.raises(ValueError, match="layer 2 out of range"):
        tpa._decode_explain(*_decode_inputs(), 2)


@pytest.mark.parametrize("five_d", [False, True])
def test_append_fits_matches_the_append_checks(five_d):
    """The append wrappers' one-expression check: True for tensors the
    kernels take as they are, False where a cast, a copy or an error is
    due (the checks ``_check_pools`` and ``_index_check`` raise for the
    last)."""
    g = torch.Generator().manual_seed(1)
    shape = ((3,) if five_d else ()) + (9, 4, 2, 8)
    kp, vp = (torch.randn(shape, generator=g).to(torch.bfloat16)
              for _ in range(2))
    kb, vb = (torch.randn(2, 4, 2, 8, generator=g).to(torch.bfloat16)
              for _ in range(2))
    ids = torch.tensor([3, 0], dtype=torch.int32)
    layer = 2 if five_d else 0
    assert tpa._append_fits(kp, vp, kb, vb, ids, None, layer)
    kn, vn = kb[:, 0].contiguous(), vb[:, 0].contiguous()
    assert tpa._append_fits(kp, vp, kn, vn, ids, ids, layer)
    assert not tpa._append_fits(kp, vp, kb.float(), vb, ids, None, layer)
    assert not tpa._append_fits(kp, vp, kb, vb, ids.long(), None, layer)
    assert not tpa._append_fits(kp, vp, kb, vb, ids[:1], None, layer)
    assert not tpa._append_fits(kp, vp, kb, vb, ids, None, layer + 1)
    strided = kb.transpose(1, 2).contiguous().transpose(1, 2)
    assert not tpa._append_fits(kp, vp, strided, vb, ids, None, layer)
    assert not tpa._append_fits(kp, vp, kn, vn, ids, None, layer)
    with pytest.raises(ValueError, match="out of range"):
        tpa._check_pools("paged_append_blocks", kp, vp, kb, (2,),
                         layer=layer + 1)
    narrow = kb[..., :4].contiguous()
    assert not tpa._append_fits(kp, vp, narrow, narrow, ids, None, layer)
    with pytest.raises(ValueError, match="do not match"):
        tpa._check_pools("paged_append_blocks", kp, vp, narrow, (2,),
                         layer=layer)
    with pytest.raises(ValueError, match="indices must be int32"):
        tpa._index_check("paged_append_blocks", ids.long(), 2, kp.device)


# The API's decode sequence at a small size: B7 appends one row a slot at
# its length, then B6 attends at lengths + 1. Slot 0 goes from length 0 to
# 1, slot 1's append opens its second block (offset 0), slots 2 and 3
# append mid-block.
_CHAIN_LENS = [0, BS, 6, 13]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("layers,layer", [(0, 0), (2, 1)])
def test_append_then_attend_chain_matches_jax(layers, layer, dtype, tol):
    """The port's append-then-attend chain (``paged_append_token``, then
    ``paged_decode_attention`` at ``lengths + 1``) against the JAX
    package's kernels (interpret mode) on the same numpy inputs, on 4-D
    and 5-D pools: the appended pools equal exactly, B6 per slot within
    1e-5 (f32) or 2e-2 (bf16, phase 2's rule) of the slot's largest
    magnitude, and the appended row is read (slot 0 attends to it
    alone, so its output is its V row)."""
    n, G = len(_CHAIN_LENS), 2
    rng = np.random.default_rng(30 + layers)
    nb = n * MB + 1
    shape = ((layers,) if layers else ()) + (nb, BS, HKV, D)
    kp, vp = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(np.arange(1, nb)).reshape(n, MB).astype(np.int32)
    lens = np.array(_CHAIN_LENS, np.int32)
    k_new, v_new = (rng.standard_normal((n, HKV, D)).astype(np.float32)
                    for _ in range(2))
    q = rng.standard_normal((n, G * HKV, D)).astype(np.float32)
    blk = table[np.arange(n), lens // BS]
    off = lens % BS
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jx(a):
        return jnp.asarray(a).astype(jdt)

    def tx(a):
        return torch.as_tensor(a).to(tdt)
    jk, jv = jpa.paged_append_token(jx(kp), jx(vp), jx(k_new), jx(v_new),
                                    jnp.asarray(blk), jnp.asarray(off),
                                    layer=layer)
    want = jpa.paged_decode_attention(jx(q), jpa.PagedKVCache(
        jk, jv, jnp.asarray(table), jnp.asarray(lens + 1)), layer=layer)
    tk, tv = tx(kp), tx(vp)
    tpa.paged_append_token(tk, tv, tx(k_new), tx(v_new),
                           torch.as_tensor(blk), torch.as_tensor(off),
                           layer=layer)
    got = tpa.paged_decode_attention(tx(q), tpa.PagedKVCache(
        tk, tv, torch.as_tensor(table), torch.as_tensor(lens) + 1),
        layer=layer)
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == q.shape
    err = np.abs(got - want).reshape(n, -1).max(1)
    assert np.all(err <= tol * np.abs(want).reshape(n, -1).max(1))
    v0 = tx(v_new).float().numpy()[0]                  # [Hkv, D]
    np.testing.assert_allclose(got[0].reshape(HKV, G, D),
                               np.broadcast_to(v0[:, None], (HKV, G, D)),
                               atol=tol * np.abs(v0).max(), rtol=0)
