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

int8 pools carry per-entry f32 scale pools ``ks_pool``/``vs_pool``
[L, NB, BS, Hkv] (``quant_matmul.quantize_kv``), required with them. The
int8 walk follows the JAX kernel's arithmetic: the score is (q . k) in
f32 times the softmax scale times the K scale; ``l`` sums the unscaled
probabilities; the probabilities are not rounded, and the PV product is
(p * V scale) . v in f32.

Not ported yet: the tensor-parallel ``mesh`` form (ROADMAP A10), which
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_INT8 = 2          # the kernel's pool dtype code for int8 pools
_MAX_GROUP = 8          # query heads per kv head the kernel takes


class PagedKVCache(NamedTuple):
    k_pool: torch.Tensor       # [NB, BS, Hkv, D] (or [L, NB, BS, Hkv, D])
    v_pool: torch.Tensor
    block_table: torch.Tensor  # [N, MB] int32 pool block ids
    lengths: torch.Tensor      # [N] int32 token counts


def _as5d(pool):
    return pool if pool.dim() == 5 else pool[None]


def _as4d(scales):
    return scales if scales.dim() == 4 else scales[None]


def _scale_pools(k_pool, ks_pool, vs_pool):
    """The f32 scale pools of int8 pools as [L, NB, BS, Hkv] (None, None
    for bf16/f32 pools); int8 pools without both raise."""
    if k_pool.dtype != torch.int8:
        if ks_pool is not None or vs_pool is not None:
            raise ValueError("ks_pool/vs_pool scale only int8 pools, got "
                             f"{k_pool.dtype} pools")
        return None, None
    if ks_pool is None or vs_pool is None:
        raise ValueError("int8 pools require ks_pool/vs_pool scales")
    return _as4d(ks_pool), _as4d(vs_pool)


def ragged_decode_partial_plain(q, k_pool, v_pool, block_table, lengths,
                                layer: int = 0, ks_pool=None, vs_pool=None):
    """The plain PyTorch version of :func:`ragged_decode_partial`: gather
    every slot's blocks at full table width, mask positions at or past the
    length, and reduce in f32. bf16/f32 pools: probabilities are rounded
    to the pool dtype before the PV product, as the kernels do. int8 pools
    (with their f32 scale pools): scores times the K scale, ``l`` over the
    unscaled probabilities, and PV as (p * V scale) . v in f32."""
    N, Hq, D = q.shape
    ks4, vs4 = _scale_pools(k_pool, ks_pool, vs_pool)
    kp, vp = _as5d(k_pool)[layer], _as5d(v_pool)[layer]
    BS, Hkv = kp.shape[1], kp.shape[2]
    G = Hq // Hkv
    MB = block_table.shape[1]
    tbl = block_table.long()
    k = kp[tbl].reshape(N, MB * BS, Hkv, D).float()
    v = vp[tbl].reshape(N, MB * BS, Hkv, D)
    qg = q.float().reshape(N, Hkv, G, D)
    s = torch.einsum("nhgd,nthd->nhgt", qg, k) * (1.0 / math.sqrt(D))
    if ks4 is not None:
        ks = ks4[layer][tbl].reshape(N, MB * BS, Hkv).float()
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    valid = (torch.arange(MB * BS, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                   # [N, Hkv, G]
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    if vs4 is not None:
        vs = vs4[layer][tbl].reshape(N, MB * BS, Hkv).float()
        pv = p * vs.permute(0, 2, 1)[:, :, None, :]
    else:
        pv = p.to(v.dtype).float()
    acc = torch.einsum("nhgt,nthd->nhgd", pv, v.float())
    return acc, m, l


def _check_cuda(q, kp, vp, block_table, lengths, layer, ks, vs):
    dev = q.device
    named = (("k_pool", kp), ("v_pool", vp), ("block_table", block_table),
             ("lengths", lengths))
    if ks is not None:
        named += (("ks_pool", ks), ("vs_pool", vs))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"ragged_decode_partial: {name} on {t.device}, "
                             f"q on {dev}")
    N, Hq, D = q.shape
    L, NB, BS, Hkv, Dk = kp.shape
    if vp.shape != kp.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"pools {tuple(kp.shape)}/{tuple(vp.shape)} do not "
                         f"match q {tuple(q.shape)}")
    pool_dt = torch.int8 if ks is not None else q.dtype
    if q.dtype not in _DTYPES or kp.dtype != pool_dt or vp.dtype != pool_dt:
        raise TypeError(f"ragged_decode_partial takes bf16 or f32 q and "
                        f"pools of q's dtype or int8, got {q.dtype}, "
                        f"{kp.dtype}, {vp.dtype}")
    if ks is not None and (ks.dtype != torch.float32
                           or vs.dtype != torch.float32
                           or tuple(ks.shape) != tuple(kp.shape[:4])
                           or vs.shape != ks.shape):
        raise ValueError(f"scale pools {tuple(ks.shape)} {ks.dtype} / "
                         f"{tuple(vs.shape)} {vs.dtype} must be f32 "
                         f"{tuple(kp.shape[:4])}")
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
    if not all(t.is_contiguous() for _n, t in named + (("q", q),)):
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
    [L, NB, BS, Hkv, D] or [NB, BS, Hkv, D] (q's dtype, or int8 with
    f32 scale pools ``ks_pool``/``vs_pool`` [L, NB, BS, Hkv] or
    [NB, BS, Hkv]); block_table [N, MB] int32; lengths [N] int32, read on
    the device. Returns ``(acc [N, Hkv, G, D], m [N, Hkv, G],
    l [N, Hkv, G])`` in f32; a length-0 slot returns (0, -1e30, 0)."""
    ks4, vs4 = _scale_pools(k_pool, ks_pool, vs_pool)
    if mesh is not None:
        raise NotImplementedError(
            "the tensor-parallel mesh form is not ported yet "
            "(ROADMAP queue A10)")
    if q.device.type == "cpu":
        return ragged_decode_partial_plain(q, k_pool, v_pool, block_table,
                                           lengths, layer, ks4, vs4)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_partial: unsupported device "
                         f"{q.device}")
    kp, vp = _as5d(k_pool), _as5d(v_pool)
    _check_cuda(q, kp, vp, block_table, lengths, layer, ks4, vs4)
    N, Hq, D = q.shape
    L, NB, BS, Hkv, _ = kp.shape
    G = Hq // Hkv
    fn = _build.kernel("ptt_ragged_decode", [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    null = ctypes.c_void_p(0)
    acc = torch.empty((N, Hkv, G, D), dtype=torch.float32, device=q.device)
    m = torch.empty((N, Hkv, G), dtype=torch.float32, device=q.device)
    l = torch.empty((N, Hkv, G), dtype=torch.float32, device=q.device)
    if N == 0:
        return acc, m, l         # an empty grid is no launch
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(kp), _build.ptr(vp),
                 null if ks4 is None else _build.ptr(ks4),
                 null if vs4 is None else _build.ptr(vs4),
                 _build.ptr(block_table), _build.ptr(lengths),
                 _build.ptr(acc), _build.ptr(m), _build.ptr(l),
                 N, int(layer), NB, BS, Hkv, G, D, block_table.shape[1],
                 _DTYPES[q.dtype],
                 _POOL_INT8 if ks4 is not None else _DTYPES[q.dtype],
                 1.0 / math.sqrt(D), _build.stream_handle(q))
    name = "ragged_decode_int8" if ks4 is not None else "ragged_decode"
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return acc, m, l


def ragged_paged_decode(q, cache: PagedKVCache, layer: int = 0,
                        ks_pool=None, vs_pool=None, mesh=None):
    """Normalized ragged decode attention: q [N, Hq, D] -> [N, Hq, D],
    attending each slot's first ``cache.lengths[n]`` positions of pool
    plane ``layer`` (int8 pools with their scale pools). Zero-length slots
    return 0."""
    N, Hq, D = q.shape
    acc, m, l = ragged_decode_partial(q, cache.k_pool, cache.v_pool,
                                      cache.block_table, cache.lengths,
                                      layer=layer, ks_pool=ks_pool,
                                      vs_pool=vs_pool, mesh=mesh)
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
