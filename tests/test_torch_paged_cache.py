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
