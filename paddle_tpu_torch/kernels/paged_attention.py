"""Paged KV-cache decode attention — the port of
paddle_tpu/kernels/paged_attention.

The pool layout is the JAX package's: token-major ``[NB, BS, Hkv, D]``
per layer, stacked to ``[L, NB, BS, Hkv, D]`` by the serving engine, with
a ``[N, MB]`` int32 block table per slot and ``[N]`` int32 lengths.

- :func:`ragged_decode_partial` walks each slot's block table up to its
  true length with an online softmax and returns the flash-decoding
  partial state (acc, m, l). On CUDA tensors it launches the hand-written
  kernel ``csrc/ragged_decode.cu``; on CPU tensors it runs the plain
  PyTorch version :func:`ragged_decode_partial_plain`.
- :func:`ragged_paged_decode` normalizes that state into the attention
  output.
- :func:`paged_attention` is the dense-gather reference (the JAX
  package's XLA path), kept as the plain oracle.

Not ported yet: int8 pools (``ks_pool``/``vs_pool``, ROADMAP A4) and the
tensor-parallel ``mesh`` form (ROADMAP A10) — both raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 8          # query heads per kv head the kernel takes


class PagedKVCache(NamedTuple):
    k_pool: torch.Tensor       # [NB, BS, Hkv, D] (or [L, NB, BS, Hkv, D])
    v_pool: torch.Tensor
    block_table: torch.Tensor  # [N, MB] int32 pool block ids
    lengths: torch.Tensor      # [N] int32 token counts


def _as5d(pool):
    return pool if pool.dim() == 5 else pool[None]


def ragged_decode_partial_plain(q, k_pool, v_pool, block_table, lengths,
                                layer: int = 0):
    """The plain PyTorch version of :func:`ragged_decode_partial`: gather
    every slot's blocks at full table width, mask positions at or past the
    length, and reduce in f32. Probabilities are rounded to the pool dtype
    before the PV product, as the kernels do."""
    N, Hq, D = q.shape
    kp, vp = _as5d(k_pool)[layer], _as5d(v_pool)[layer]
    BS, Hkv = kp.shape[1], kp.shape[2]
    G = Hq // Hkv
    MB = block_table.shape[1]
    tbl = block_table.long()
    k = kp[tbl].reshape(N, MB * BS, Hkv, D).float()
    v = vp[tbl].reshape(N, MB * BS, Hkv, D)
    qg = q.float().reshape(N, Hkv, G, D)
    s = torch.einsum("nhgd,nthd->nhgt", qg, k) * (1.0 / math.sqrt(D))
    valid = (torch.arange(MB * BS, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                   # [N, Hkv, G]
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("nhgt,nthd->nhgd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def _check_cuda(q, kp, vp, block_table, lengths, layer):
    dev = q.device
    for name, t in (("k_pool", kp), ("v_pool", vp),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"ragged_decode_partial: {name} on {t.device}, "
                             f"q on {dev}")
    N, Hq, D = q.shape
    L, NB, BS, Hkv, Dk = kp.shape
    if vp.shape != kp.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"pools {tuple(kp.shape)}/{tuple(vp.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"ragged_decode_partial takes bf16 or f32 q and "
                        f"pools of one dtype, got {q.dtype}, {kp.dtype}, "
                        f"{vp.dtype}")
    if D not in (64, 128):
        raise ValueError(f"ragged_decode_partial: head_dim {D} not in "
                         "(64, 128)")
    if Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"ragged_decode_partial: {Hq // Hkv} query heads "
                         f"per kv head exceeds {_MAX_GROUP}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_table.dim() != 2 or block_table.shape[0] != N \
            or lengths.shape != (N,):
        raise ValueError("block_table must be int32 [N, MB] and lengths "
                         "int32 [N]")
    if not all(t.is_contiguous() for t in (q, kp, vp, block_table, lengths)):
        raise ValueError("ragged_decode_partial needs contiguous inputs")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("ragged_decode_partial copies pool rows 16 bytes at "
                         "a time: the pools must be 16-byte aligned")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} pool layers")


def ragged_decode_partial(q, k_pool, v_pool, block_table, lengths, *,
                          layer: int = 0, ks_pool=None, vs_pool=None,
                          mesh=None):
    """Ragged block-walk decode attention over each slot's TRUE length,
    in partial (flash-decoding) form. q: [N, Hq, D]; pools
    [L, NB, BS, Hkv, D] or [NB, BS, Hkv, D] (bf16/f32); block_table
    [N, MB] int32; lengths [N] int32, read on the device. Returns
    ``(acc [N, Hkv, G, D], m [N, Hkv, G], l [N, Hkv, G])`` in f32; a
    length-0 slot returns (0, -1e30, 0)."""
    if ks_pool is not None or vs_pool is not None \
            or k_pool.dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV pools are not ported yet (ROADMAP queue A4)")
    if mesh is not None:
        raise NotImplementedError(
            "the tensor-parallel mesh form is not ported yet "
            "(ROADMAP queue A10)")
    if q.device.type == "cpu":
        return ragged_decode_partial_plain(q, k_pool, v_pool, block_table,
                                           lengths, layer)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_partial: unsupported device "
                         f"{q.device}")
    kp, vp = _as5d(k_pool), _as5d(v_pool)
    _check_cuda(q, kp, vp, block_table, lengths, layer)
    N, Hq, D = q.shape
    L, NB, BS, Hkv, _ = kp.shape
    G = Hq // Hkv
    fn = _build.kernel("ptt_ragged_decode", [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    acc = torch.empty((N, Hkv, G, D), dtype=torch.float32, device=q.device)
    m = torch.empty((N, Hkv, G), dtype=torch.float32, device=q.device)
    l = torch.empty((N, Hkv, G), dtype=torch.float32, device=q.device)
    if N == 0:
        return acc, m, l         # an empty grid is no launch
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(kp), _build.ptr(vp),
                 _build.ptr(block_table), _build.ptr(lengths),
                 _build.ptr(acc), _build.ptr(m), _build.ptr(l),
                 N, int(layer), NB, BS, Hkv, G, D, block_table.shape[1],
                 _DTYPES[q.dtype], 1.0 / math.sqrt(D),
                 _build.stream_handle(q))
    _build.check(err, "ragged_decode")
    _build.launch_counts["ragged_decode"] += 1
    return acc, m, l


def ragged_paged_decode(q, cache: PagedKVCache, layer: int = 0):
    """Normalized ragged decode attention: q [N, Hq, D] -> [N, Hq, D],
    attending each slot's first ``cache.lengths[n]`` positions of pool
    plane ``layer``. Zero-length slots return 0."""
    N, Hq, D = q.shape
    acc, m, l = ragged_decode_partial(q, cache.k_pool, cache.v_pool,
                                      cache.block_table, cache.lengths,
                                      layer=layer)
    out = acc / l.clamp_min(1e-30)[..., None]
    out = torch.where((l > 0)[..., None], out, torch.zeros_like(out))
    return out.reshape(N, Hq, D).to(q.dtype)


def paged_attention(q, cache: PagedKVCache):
    """Dense-gather decode attention (the reference path): q [B, Hq, D]
    -> [B, Hq, D] over 4D pools, keys past each length masked. A
    length-0 row attends uniformly to masked keys, as the JAX reference
    does."""
    B, Hq, D = q.shape
    NB, BS, Hkv = cache.k_pool.shape[:3]
    MB = cache.block_table.shape[1]
    G = Hq // Hkv
    tbl = cache.block_table.long()
    k = cache.k_pool[tbl].reshape(B, MB * BS, Hkv, D)
    v = cache.v_pool[tbl].reshape(B, MB * BS, Hkv, D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) / math.sqrt(D)
    valid = (torch.arange(MB * BS, device=q.device)[None, :]
             < cache.lengths.long()[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p.float(), v.float())
    return out.reshape(B, Hq, D).to(q.dtype)
