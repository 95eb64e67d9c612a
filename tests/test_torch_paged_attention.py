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
    with pytest.raises(NotImplementedError, match="A10"):
        tpa.ragged_decode_partial(q, kp, vp, table, lens, mesh=object())
    with pytest.raises(ValueError):
        tpa.ragged_decode_partial(q.to("meta"), kp, vp, table, lens)
