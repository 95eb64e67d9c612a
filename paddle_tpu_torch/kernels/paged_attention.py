"""Paged KV-cache decode attention and appends — the port of
paddle_tpu/kernels/paged_attention.

The pool layout is the JAX package's: token-major ``[NB, BS, Hkv, D]``
per layer, stacked to ``[L, NB, BS, Hkv, D]`` by the serving engine, with
a ``[N, MB]`` int32 block table per slot and ``[N]`` int32 lengths.

- :func:`ragged_decode_partial` walks each slot's block table up to its
  true length with an online softmax and returns the flash-decoding
  partial state (acc, m, l). On CUDA tensors it launches the hand-written
  kernel ``csrc/ragged_decode.cu``, which splits the walks over a
  persistent grid (:func:`ragged_schedule` is its schedule,
  :func:`ragged_decode_partial_split_plain` its split form in plain
  PyTorch); on CPU tensors it runs the plain PyTorch version
  :func:`ragged_decode_partial_plain`.
- :func:`ragged_paged_decode` normalizes that state into the attention
  output.
- :func:`paged_attention` is the dense-gather reference (the JAX
  package's XLA path), kept as the plain oracle.
- The paged-cache API (the JAX package's ``paddle_tpu.kernels`` surface):
  :func:`paged_cache_init` and :func:`paged_append` (plain torch, as they
  are XLA in JAX); :func:`paged_append_token` (B7, one K/V row per slot)
  and :func:`paged_append_blocks` (B8, whole prefill blocks), in place,
  on CUDA tensors through ``csrc/paged_cache.cu``; and
  :func:`paged_decode_attention` (B6, the one-shot softmax over each
  slot's first ``lengths[n]`` positions, 0 for a zero-length slot) through
  ``csrc/paged_decode.cu``. Each runs its plain version
  (``*_plain``) on CPU tensors. The JAX wrapper of B6 switches to the
  dense gather above 12 MiB of TPU VMEM staging; the CUDA kernel streams
  any length and has no such fallback.

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

import bisect
import ctypes
import math
from typing import NamedTuple

import torch

from . import _build
from ..device import resolve_device

__all__ = ["PagedKVCache", "paged_cache_init", "paged_append",
           "paged_attention", "paged_append_token", "paged_append_blocks",
           "paged_decode_attention", "ragged_decode_partial",
           "ragged_paged_decode"]

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
    ks4, vs4 = _scale_pools(k_pool, ks_pool, vs_pool)
    return _plain_window(q, k_pool, v_pool, block_table,
                         torch.zeros_like(lengths), lengths, layer, ks4, vs4)


def _plain_window(q, k_pool, v_pool, block_table, lo, hi, layer, ks4, vs4):
    """The plain walk over positions [lo[n], hi[n]) of each slot n."""
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
    if ks4 is not None:
        ks = ks4[layer][tbl].reshape(N, MB * BS, Hkv).float()
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    pos = torch.arange(MB * BS, device=q.device)[None, :]
    valid = ((pos >= lo.to(q.device).long()[:, None])
             & (pos < hi.to(q.device).long()[:, None]))[:, None, None, :]
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


# ---------------------------------------------------------------------------
# the split walk: the kernel's schedule and merge, in plain Python
# ---------------------------------------------------------------------------
RAGGED_TILE = 32        # positions a tile of the kernel's bf16-query walk
RAGGED_TILE_F32 = 64    # of its f32-query walk (ragged_walk.cuh's stages)


def ragged_schedule(lengths, Hkv, MB, BS, tile, grid):
    """How the kernel deals the walks to its persistent grid, as rows
    ``(block, slot, kv head, first tile, end tile, walk tiles, parts)``
    (``csrc/ragged_decode.cu``'s ``Sched``, exported there as
    ``ptt_ragged_decode_schedule``). Each (slot, kv head) walk is
    ``ceil(len / tile)`` tiles (one for a length-0 slot, whose tile is
    empty), the walks lie end to end in (slot, kv head) order, and block
    b takes the tiles [b * per, (b + 1) * per), per = ceil(total / grid):
    a walk cut by a range boundary becomes parts on tile boundaries, one a
    block, in block order."""
    cap = MB * BS
    tiles = [max(1, -(-min(max(0, int(n)), cap) // tile)) for n in lengths]
    start = [0]
    for t in tiles:
        start.append(start[-1] + Hkv * t)
    total = start[-1]
    per = -(-total // grid)
    rows = []
    for b in range(grid):
        r, r1 = b * per, min(total, (b + 1) * per)
        while r < r1:
            n = bisect.bisect_right(start, r) - 1
            t = tiles[n]
            hk = (r - start[n]) // t
            ws = start[n] + hk * t
            end = min(r1, ws + t)
            rows.append((b, n, hk, r - ws, end - ws, t,
                         (ws + t - 1) // per - ws // per + 1))
            r = end
    return rows


def merge_parts(parts):
    """The flash-decoding combine of partial states ``(acc, m, l)``, taken
    in the order given (the kernel merges a walk's parts in part order)."""
    m = parts[0][1]
    for _a, mq, _l in parts[1:]:
        m = torch.maximum(m, mq)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, mq, lq in parts:
        w = torch.exp(mq - m)
        acc = acc + a * w[..., None]
        l = l + lq * w
    return acc, m, l


def ragged_decode_partial_split_plain(q, k_pool, v_pool, block_table,
                                      lengths, layer: int = 0, ks_pool=None,
                                      vs_pool=None, *, tile=RAGGED_TILE,
                                      grid=132):
    """The kernel's split of the walks across blocks in plain PyTorch:
    each block part of :func:`ragged_schedule` as the plain walk over its
    positions, a walk's parts merged in part order by :func:`merge_parts`
    (inside a block the kernel also walks a part in up to four pieces,
    merged the same way). Equals :func:`ragged_decode_partial_plain` up to
    the order of f32 sums, and for bf16 pools up to P's rounding."""
    ks4, vs4 = _scale_pools(k_pool, ks_pool, vs_pool)
    N = q.shape[0]
    Hkv, BS = _as5d(k_pool).shape[3], _as5d(k_pool).shape[2]
    MB = block_table.shape[1]
    lens = [max(0, min(int(n), MB * BS)) for n in lengths.tolist()]
    walks = {}
    for _b, n, hk, ta, tb, _t, _np in ragged_schedule(lens, Hkv, MB, BS,
                                                        tile, grid):
        lo = torch.zeros(N, dtype=torch.int64)
        hi = torch.zeros(N, dtype=torch.int64)
        lo[n], hi[n] = min(lens[n], ta * tile), min(lens[n], tb * tile)
        acc, m, l = _plain_window(q, k_pool, v_pool, block_table, lo, hi,
                                  layer, ks4, vs4)
        walks.setdefault((n, hk), []).append((acc[n, hk], m[n, hk],
                                              l[n, hk]))
    G = q.shape[1] // Hkv
    acc = torch.zeros(N, Hkv, G, q.shape[2], dtype=torch.float32,
                      device=q.device)
    m = torch.full((N, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(N, Hkv, G, dtype=torch.float32, device=q.device)
    for (n, hk), parts in walks.items():
        acc[n, hk], m[n, hk], l[n, hk] = merge_parts(parts)
    return acc, m, l


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
_grids = {}   # (device index, dtype code, pool code, D) -> the kernel's grid
# (device index, stream) -> (int32 flags, zero between calls; f32 scratch:
# the parts, then B6's walk maxima): calls on one stream run one after
# another, so B4 and B6 share them
_work = {}
# the current stream's handle without a Stream object (CUDA builds)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                        ctypes.c_void_p]
_MAX_PARTS = 192        # the kernels' largest grid (kMaxParts)
_MAX_SLOTS = 511        # slots a call (the schedule's shared memory)
# the parts' scratch: two parts a block of the largest grid, 8 heads of
# D = 128 (acc, m, l)
_PARTS_FLOATS = 2 * _MAX_PARTS * _MAX_GROUP * 130


def _stream(dev: int) -> int:
    """Device ``dev``'s current stream handle."""
    return _raw_stream(dev) if _raw_stream is not None else \
        torch.cuda.current_stream(dev).cuda_stream


def _on_device(dev: int, fn, *args) -> int:
    """``fn(*args)`` with device ``dev`` current, made so only when another
    device is."""
    if torch.cuda.current_device() == dev:
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _explain(q, kp, vp, block_table, lengths, layer, ks, vs):
    """Raise the error that names what the kernel does not take."""
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
    if q.data_ptr() % 16 or kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("ragged_decode_partial copies q and pool rows 16 "
                         "bytes at a time: they must be 16-byte aligned")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} pool layers")
    if N > _MAX_SLOTS:
        raise ValueError(f"ragged_decode_partial takes at most {_MAX_SLOTS} "
                         f"slots a call, got {N}")


def _fits(q, kp, vp, table, lengths, layer, ks, vs):
    """Whether the kernel takes these tensors: every check of
    :func:`_explain`, in one expression of cheap reads."""
    d = q.get_device()
    N, Hq, D = q.shape
    L, _NB, _BS, Hkv, Dk = kp.shape
    qdt = q.dtype
    pool_dt = qdt if ks is None else torch.int8
    return ((qdt is torch.bfloat16 or qdt is torch.float32)
            and kp.get_device() == d and vp.get_device() == d
            and table.get_device() == d and lengths.get_device() == d
            and vp.shape == kp.shape and Dk == D
            and (D == 64 or D == 128) and Hq % Hkv == 0
            and Hq <= _MAX_GROUP * Hkv and kp.dtype == pool_dt
            and vp.dtype == pool_dt and table.dtype == torch.int32
            and lengths.dtype == torch.int32 and table.dim() == 2
            and table.shape[0] == N and lengths.shape == (N,)
            and q.is_contiguous() and kp.is_contiguous()
            and vp.is_contiguous() and table.is_contiguous()
            and lengths.is_contiguous() and not q.data_ptr() % 16
            and not kp.data_ptr() % 16 and not vp.data_ptr() % 16
            and 0 <= layer < L and N <= _MAX_SLOTS
            and (ks is None or (
                ks.get_device() == d and vs.get_device() == d
                and ks.dtype == torch.float32 and vs.dtype == torch.float32
                and ks.shape == kp.shape[:4] and vs.shape == ks.shape
                and ks.is_contiguous() and vs.is_contiguous())))


def _grid(dev: int, dt: int, pool: int, D: int) -> int:
    """The kernel's persistent grid for a form on device ``dev`` (its
    one-time set-up on that device runs here; the wrapper's scratch holds
    two parts a block of at most _MAX_PARTS blocks)."""
    fn = _build.kernel("ptt_ragged_decode_grid", [ctypes.c_int] * 3)
    with torch.cuda.device(dev):
        grid = fn(dt, pool, D)
    if not 0 < grid <= _MAX_PARTS:
        raise RuntimeError(f"ragged_decode_partial: no grid for dtype {dt}, "
                           f"pools {pool}, D {D} (got {grid})")
    _grids[(dev, dt, pool, D)] = grid
    return grid


def _workspace(dev: int, stream: int, n: int):
    """The walks' flags (int32, zero; the kernels leave them zero) and the
    f32 scratch (the parts' ``_PARTS_FLOATS``, then 8 maxima a walk) of
    the calls on ``stream``, for at least ``n`` walks."""
    work = _work.get((dev, stream))
    if work is None or work[0].numel() < n:
        cuda = torch.device("cuda", dev)
        n = max(n, 256)
        work = (torch.zeros(n, dtype=torch.int32, device=cuda),
                torch.empty(_PARTS_FLOATS + n * _MAX_GROUP,
                            dtype=torch.float32, device=cuda))
        _work[(dev, stream)] = work
    return work


def ragged_decode_partial(q, k_pool, v_pool, block_table, lengths, *,
                          layer: int = 0, ks_pool=None, vs_pool=None,
                          mesh=None):
    """Ragged block-walk decode attention over each slot's TRUE length,
    in partial (flash-decoding) form. q: [N, Hq, D]; pools
    [L, NB, BS, Hkv, D] or [NB, BS, Hkv, D] (q's dtype, or int8 with
    f32 scale pools ``ks_pool``/``vs_pool`` [L, NB, BS, Hkv] or
    [NB, BS, Hkv]); block_table [N, MB] int32; lengths [N] int32, read on
    the device. Returns ``(acc [N, Hkv, G, D], m [N, Hkv, G],
    l [N, Hkv, G])`` in f32 (views of one buffer on the card); a length-0
    slot returns (0, -1e30, 0)."""
    ks4, vs4 = _scale_pools(k_pool, ks_pool, vs_pool)
    if mesh is not None:
        raise NotImplementedError(
            "the tensor-parallel mesh form is not ported yet "
            "(ROADMAP queue A10)")
    qdev = q.device
    where = qdev.type
    if where != "cuda":
        if where == "cpu":
            return ragged_decode_partial_plain(q, k_pool, v_pool,
                                               block_table, lengths, layer,
                                               ks4, vs4)
        raise ValueError(f"ragged_decode_partial: unsupported device "
                         f"{q.device}")
    kp = k_pool if k_pool.dim() == 5 else k_pool[None]
    vp = v_pool if v_pool.dim() == 5 else v_pool[None]
    if not _fits(q, kp, vp, block_table, lengths, layer, ks4, vs4):
        _explain(q, kp, vp, block_table, lengths, layer, ks4, vs4)
    N, Hq, D = q.shape
    _L, NB, BS, Hkv, _D = kp.shape
    G = Hq // Hkv
    dev = qdev.index
    dt = _DTYPES[q.dtype]
    pool = dt if ks4 is None else _POOL_INT8
    if (dev, dt, pool, D) not in _grids:
        _grid(dev, dt, pool, D)
    fn = _build.kernel("ptt_ragged_decode", _ARGS)
    # acc, m and l back to back in one buffer
    a = N * Hkv * G
    out = torch.empty(a * (D + 2), dtype=torch.float32, device=qdev)
    acc = out.as_strided((N, Hkv, G, D), (Hkv * G * D, G * D, D, 1))
    m = out.as_strided((N, Hkv, G), (Hkv * G, G, 1), a * D)
    l = out.as_strided((N, Hkv, G), (Hkv * G, G, 1), a * D + a)
    if N == 0:
        return acc, m, l         # an empty grid is no launch
    stream = _stream(dev)
    flags, scratch = _workspace(dev, stream, N * Hkv)
    err = _on_device(dev, fn, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                     None if ks4 is None else ks4.data_ptr(),
                     None if vs4 is None else vs4.data_ptr(),
                     block_table.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(), flags.data_ptr(), N,
                     layer, NB, BS, Hkv, G, D, block_table.shape[1], dt, pool,
                     1.0 / math.sqrt(D), stream)
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


# ---------------------------------------------------------------------------
# the paged-cache API: init, appends (B7, B8), decode attention (B6)
# ---------------------------------------------------------------------------
def paged_cache_init(batch: int, num_blocks: int, block_size: int,
                     num_heads: int, head_dim: int, max_blocks: int,
                     dtype=torch.bfloat16, device="cuda") -> PagedKVCache:
    """Zeroed [num_blocks, block_size, num_heads, head_dim] pools, a block
    table giving sequence b the blocks b*max_blocks .. (b+1)*max_blocks-1
    (a caller doing real paging overwrites it) and zero lengths."""
    if num_blocks < batch * max_blocks:
        raise ValueError(f"{num_blocks} blocks cannot back {batch} "
                         f"sequences of {max_blocks} blocks")
    dev = resolve_device(device)
    shape = (num_blocks, block_size, num_heads, head_dim)
    table = torch.arange(batch * max_blocks, dtype=torch.int32,
                         device=dev).reshape(batch, max_blocks)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev), table,
                        torch.zeros(batch, dtype=torch.int32, device=dev))


def paged_append(cache: PagedKVCache, k_new, v_new) -> PagedKVCache:
    """Append ONE token per sequence at its length (plain torch — the JAX
    package's XLA path; the kernel form is :func:`paged_append_token`).
    k_new/v_new: [B, H, D]. The pools are written in place; the returned
    cache carries them with the lengths advanced by one."""
    bs = cache.k_pool.shape[1]
    pos = cache.lengths.long()
    blk = cache.block_table.long().gather(1, (pos // bs)[:, None])[:, 0]
    paged_append_token_plain(cache.k_pool, cache.v_pool, k_new, v_new, blk,
                             pos % bs)
    return PagedKVCache(cache.k_pool, cache.v_pool, cache.block_table,
                        cache.lengths + 1)


def _check_pools(name, kp, vp, new, lead, *, layer):
    """Shared checks of the append kernels: 4-D or 5-D pools of one shape
    and dtype, ``new`` [lead..., <pool's trailing dims>] on their device,
    the layer in range, contiguous 16-byte aligned tensors whose rows are
    whole 16-byte vectors."""
    kp5, vp5 = _as5d(kp), _as5d(vp)
    if kp5.dim() != 5 or vp5.shape != kp5.shape or vp5.dtype != kp5.dtype:
        raise ValueError(f"{name}: pools {tuple(kp.shape)} / "
                         f"{tuple(vp.shape)} must be one [L, NB, BS, Hkv, "
                         "D] or [NB, BS, Hkv, D] shape and dtype")
    for what, t in (("k_pool", kp5), ("v_pool", vp5), ("new rows", new)):
        if t.device != kp.device:
            raise ValueError(f"{name}: {what} on {t.device}, pools on "
                             f"{kp.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and "
                             "16-byte aligned")
    if tuple(new.shape) != tuple(lead) + tuple(kp5.shape[-len(new.shape)
                                                         + len(lead):]):
        raise ValueError(f"{name}: new rows {tuple(new.shape)} do not match "
                         f"pools {tuple(kp.shape)}")
    if not 0 <= layer < kp5.shape[0]:
        raise ValueError(f"{name}: layer {layer} out of range for "
                         f"{kp5.shape[0]} pool layers")
    if kp5.shape[3] * kp5.shape[4] * kp5.element_size() % 16:
        raise ValueError(f"{name}: a pool row of Hkv*D = "
                         f"{kp5.shape[3] * kp5.shape[4]} elements is not a "
                         "whole number of 16-byte vectors")
    return kp5, vp5


def _index_check(name, idx, n, dev):
    if idx.dtype != torch.int32 or tuple(idx.shape) != (n,) \
            or idx.device != dev:
        raise ValueError(f"{name}: indices must be int32 [{n}] on {dev}")


def _append_fits(kp, vp, kn, vn, i0, i1, layer) -> bool:
    """Whether an append kernel takes these tensors as they are: the new
    rows ``kn``/``vn`` [n, Hkv, D] (B7, with int32 [n] indices ``i0`` and
    ``i1``) or [n, BS, Hkv, D] (B8, ``i1`` None) in the pools' dtype.
    Every check of :func:`_check_pools` and :func:`_index_check`, with no
    cast or copy needed, in one expression of cheap reads."""
    shp, ks = kp.shape, kn.shape
    nd, nk = len(shp), len(ks)
    if not (nd == 4 or nd == 5) or nk != (3 if i1 is not None else 4):
        return False
    dt, d, n = kp.dtype, kp.get_device(), ks[0]
    return (vp.shape == shp and vn.shape == ks and ks[-1] == shp[-1]
            and ks[-2] == shp[-2] and (nk == 3 or ks[1] == shp[-3])
            and vp.dtype is dt and kn.dtype is dt and vn.dtype is dt
            and vp.get_device() == d and kn.get_device() == d
            and vn.get_device() == d and kp.is_contiguous()
            and vp.is_contiguous() and kn.is_contiguous()
            and vn.is_contiguous()
            and not (kp.data_ptr() | vp.data_ptr() | kn.data_ptr()
                     | vn.data_ptr()) % 16
            and 0 <= layer < (shp[0] if nd == 5 else 1)
            and not shp[-2] * shp[-1] * kp.element_size() % 16
            and i0.dtype is torch.int32 and i0.shape == (n,)
            and i0.get_device() == d and i0.is_contiguous()
            and (i1 is None or (i1.dtype is torch.int32 and i1.shape == (n,)
                                and i1.get_device() == d
                                and i1.is_contiguous())))


_TOKEN_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BLOCKS_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
    + [ctypes.c_int64, ctypes.c_void_p]
_DECODE_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def paged_append_token_plain(k_pool, v_pool, k_new, v_new, blk_phys, offset,
                             layer: int = 0):
    """The plain PyTorch version of :func:`paged_append_token`
    (``index_put_``)."""
    kp5, vp5 = _as5d(k_pool), _as5d(v_pool)
    blk, off = blk_phys.long(), offset.long()
    kp5[layer, blk, off] = k_new.to(kp5.dtype)
    vp5[layer, blk, off] = v_new.to(vp5.dtype)
    return k_pool, v_pool


def paged_append_token(k_pool, v_pool, k_new, v_new, blk_phys, offset,
                       layer: int = 0):
    """Append ONE token per slot in place: ``k_pool[layer, blk_phys[n],
    offset[n]] = k_new[n]`` and the same for v. Pools [L, NB, BS, Hkv, D]
    or [NB, BS, Hkv, D] (returned as given); k_new/v_new [N, Hkv, D], cast
    to the pools' dtype; blk_phys/offset [N] int32, read on the device.
    Slots meant to be idle point at the trash block 0, the one
    destination slots may share (the last such slot's row wins there,
    as on the TPU). Launches
    ``csrc/paged_cache.cu`` on CUDA tensors (or raises) — dependent on the
    kernel before it on the stream, whose writes it waits for before it
    reads — and runs :func:`paged_append_token_plain` on CPU tensors."""
    where = k_pool.device.type
    if where != "cuda":
        if where == "cpu":
            return paged_append_token_plain(k_pool, v_pool, k_new, v_new,
                                            blk_phys, offset, layer)
        raise ValueError(f"paged_append_token: unsupported device "
                         f"{k_pool.device}")
    if not _append_fits(k_pool, v_pool, k_new, v_new, blk_phys, offset,
                        layer):
        k_new = k_new.to(k_pool.dtype).contiguous()
        v_new = v_new.to(v_pool.dtype).contiguous()
        N = k_new.shape[0]
        _check_pools("paged_append_token", k_pool, v_pool, k_new, (N,),
                     layer=layer)
        if v_new.shape != k_new.shape:
            raise ValueError("paged_append_token: k_new and v_new differ in "
                             "shape")
        _check_pools("paged_append_token", k_pool, v_pool, v_new, (N,),
                     layer=layer)
        for idx in (blk_phys, offset):
            _index_check("paged_append_token", idx, N, k_pool.device)
        blk_phys, offset = blk_phys.contiguous(), offset.contiguous()
    N = k_new.shape[0]
    if N == 0:
        return k_pool, v_pool
    fn = _build.kernel("ptt_paged_append_token", _TOKEN_ARGS)
    shp, dev = k_pool.shape, k_pool.get_device()
    err = _on_device(dev, fn, k_new.data_ptr(), v_new.data_ptr(),
                     k_pool.data_ptr(), v_pool.data_ptr(), blk_phys.data_ptr(),
                     offset.data_ptr(), N, int(layer), shp[-4], shp[-3],
                     shp[-2] * shp[-1] * k_pool.element_size(), _stream(dev))
    _build.check(err, "paged_append_token")
    _build.launch_counts["paged_append_token"] += 1
    return k_pool, v_pool


def paged_append_blocks_plain(k_pool, v_pool, k_blocks, v_blocks, blk_ids,
                              layer: int = 0):
    """The plain PyTorch version of :func:`paged_append_blocks`
    (``index_put_``)."""
    kp5, vp5 = _as5d(k_pool), _as5d(v_pool)
    ids = blk_ids.long()
    kp5[layer, ids] = k_blocks.to(kp5.dtype)
    vp5[layer, ids] = v_blocks.to(vp5.dtype)
    return k_pool, v_pool


def paged_append_blocks(k_pool, v_pool, k_blocks, v_blocks, blk_ids,
                        layer: int = 0):
    """Scatter whole prefill blocks into the pools in place:
    ``k_pool[layer, blk_ids[b]] = k_blocks[b]`` and the same for v.
    k_blocks/v_blocks [nblk, BS, Hkv, D], cast to the pools' dtype;
    blk_ids [nblk] int32 (duplicates only for the trash block: pad blocks
    may all point at 0); pools and ``layer`` as in
    :func:`paged_append_token`. Launches ``csrc/paged_cache.cu`` on CUDA
    tensors (or raises), runs :func:`paged_append_blocks_plain` on CPU
    tensors."""
    where = k_pool.device.type
    if where != "cuda":
        if where == "cpu":
            return paged_append_blocks_plain(k_pool, v_pool, k_blocks,
                                             v_blocks, blk_ids, layer)
        raise ValueError(f"paged_append_blocks: unsupported device "
                         f"{k_pool.device}")
    if not _append_fits(k_pool, v_pool, k_blocks, v_blocks, blk_ids, None,
                        layer):
        k_blocks = k_blocks.to(k_pool.dtype).contiguous()
        v_blocks = v_blocks.to(v_pool.dtype).contiguous()
        nblk = k_blocks.shape[0]
        _check_pools("paged_append_blocks", k_pool, v_pool, k_blocks,
                     (nblk,), layer=layer)
        if v_blocks.shape != k_blocks.shape or k_blocks.dim() != 4:
            raise ValueError("paged_append_blocks: k_blocks and v_blocks "
                             "must both be [nblk, BS, Hkv, D]")
        _check_pools("paged_append_blocks", k_pool, v_pool, v_blocks,
                     (nblk,), layer=layer)
        _index_check("paged_append_blocks", blk_ids, nblk, k_pool.device)
        blk_ids = blk_ids.contiguous()
    nblk = k_blocks.shape[0]
    if nblk == 0:
        return k_pool, v_pool
    fn = _build.kernel("ptt_paged_append_blocks", _BLOCKS_ARGS)
    shp, dev = k_pool.shape, k_pool.get_device()
    err = _on_device(dev, fn, k_blocks.data_ptr(), v_blocks.data_ptr(),
                     k_pool.data_ptr(), v_pool.data_ptr(), blk_ids.data_ptr(),
                     nblk, int(layer), shp[-4],
                     shp[-3] * shp[-2] * shp[-1] * k_pool.element_size(),
                     _stream(dev))
    _build.check(err, "paged_append_blocks")
    _build.launch_counts["paged_append_blocks"] += 1
    return k_pool, v_pool


def paged_decode_attention_plain(q, cache: PagedKVCache, layer: int = 0):
    """The plain PyTorch version of :func:`paged_decode_attention`: every
    slot's blocks gathered at full table width, the V rows of blocks at
    or past the length zeroed (as the TPU kernel zeroes the blocks it
    never copies), scores in f32 divided by sqrt(D) and masked to -1e30,
    one softmax, p rounded to the pool dtype for the PV product, the sum
    normalized and cast to q's dtype."""
    N, Hq, D = q.shape
    kp, vp = _as5d(cache.k_pool)[layer], _as5d(cache.v_pool)[layer]
    BS, Hkv = kp.shape[1], kp.shape[2]
    G = Hq // Hkv
    MB = cache.block_table.shape[1]
    tbl = cache.block_table.long()
    lens = cache.lengths.long().to(q.device)
    k = kp[tbl].reshape(N, MB * BS, Hkv, D).float()
    v = vp[tbl].reshape(N, MB * BS, Hkv, D)
    pos = torch.arange(MB * BS, device=q.device)[None, :]
    blk_live = (pos // BS) * BS < lens[:, None]                 # [N, P]
    v = torch.where(blk_live[:, :, None, None], v, torch.zeros_like(v))
    qg = q.float().reshape(N, Hkv, G, D)
    s = torch.einsum("nhgd,nthd->nhgt", qg, k) / math.sqrt(D)
    s = torch.where((pos < lens[:, None])[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("nhgt,nthd->nhgd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(dim=-1)[..., None]).reshape(N, Hq, D).to(q.dtype)


def paged_decode_attention_split_plain(q, cache: PagedKVCache,
                                       layer: int = 0, *, tile=RAGGED_TILE,
                                       grid=132):
    """B6's kernel in plain PyTorch: the walks dealt by
    :func:`ragged_schedule`; pass 1 each part's maximum score and the
    walk's maximum over its parts; pass 2 each part's sums at that
    maximum (p = exp(s - max), rounded to the pool dtype for the PV
    product; l the sum of the unrounded p); the parts' sums added in part
    order and normalized, in q's dtype (0 for a zero-length slot). Equals
    :func:`paged_decode_attention_plain` up to the order of f32 sums."""
    N, Hq, D = q.shape
    kp, vp = _as5d(cache.k_pool)[layer], _as5d(cache.v_pool)[layer]
    BS, Hkv = kp.shape[1], kp.shape[2]
    G = Hq // Hkv
    MB = cache.block_table.shape[1]
    lens = [max(0, min(int(n), MB * BS)) for n in cache.lengths.tolist()]
    tbl = cache.block_table.long()
    k = kp[tbl].reshape(N, MB * BS, Hkv, D).float()
    v = vp[tbl].reshape(N, MB * BS, Hkv, D)
    s = torch.einsum("nhgd,nthd->nhgt", q.float().reshape(N, Hkv, G, D),
                     k) / math.sqrt(D)
    pos = torch.arange(MB * BS, device=q.device)
    parts = {}                    # (n, hk) -> its parts' positions, in order
    for _b, n, hk, ta, tb, _t, _np in ragged_schedule(lens, Hkv, MB, BS,
                                                        tile, grid):
        parts.setdefault((n, hk), []).append(
            (pos >= ta * tile) & (pos < min(lens[n], tb * tile)))
    out = torch.zeros(N, Hkv, G, D, dtype=torch.float32, device=q.device)
    for (n, hk), masks in parts.items():
        if lens[n] == 0:
            continue
        sw = s[n, hk]                                        # [G, P]
        m = torch.stack([torch.where(mk, sw, torch.full_like(sw, NEG_INF))
                         .amax(-1) for mk in masks]).amax(0)
        acc = torch.zeros(G, D, dtype=torch.float32, device=q.device)
        l = torch.zeros(G, dtype=torch.float32, device=q.device)
        for mk in masks:
            p = torch.where(mk, torch.exp(sw - m[:, None]),
                            torch.zeros_like(sw))
            acc = acc + p.to(v.dtype).float() @ v[n, :, hk].float()
            l = l + p.sum(-1)
        out[n, hk] = acc / l[:, None]
    return out.reshape(N, Hq, D).to(q.dtype)


def _decode_explain(q, kp, vp, table, lengths, layer):
    """Raise the error that names what B6's kernel does not take (``kp``,
    ``vp``: the pools as 5-D views)."""
    N, Hq, D = q.shape
    L, NB, BS, Hkv, Dk = kp.shape
    for name, t in (("k_pool", kp), ("v_pool", vp), ("block_table", table),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} on "
                             f"{t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} is not "
                             "contiguous")
    if q.dtype not in _DTYPES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention takes bf16 or f32 q and "
                        f"pools of its dtype, got {q.dtype}, {kp.dtype}, "
                        f"{vp.dtype}")
    if vp.shape != kp.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"pools {tuple(kp.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D not in (64, 128) or Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"paged_decode_attention takes head_dim 64 or 128 "
                         f"and at most {_MAX_GROUP} query heads a kv head, "
                         f"got D={D}, G={Hq // Hkv}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[0] != N \
            or tuple(lengths.shape) != (N,):
        raise ValueError("block_table must be int32 [N, MB] and lengths "
                         "int32 [N]")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged_decode_attention copies pool rows 16 bytes "
                         "at a time: the pools must be 16-byte aligned")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for {L} pool layers")
    if N > _MAX_SLOTS:
        raise ValueError(f"paged_decode_attention takes at most "
                         f"{_MAX_SLOTS} slots a call, got {N}")


def _decode_fits(q, kp, vp, table, lengths, layer) -> bool:
    """Whether B6's kernel takes these tensors as they are (pools 4-D or
    5-D): every check of :func:`_decode_explain`, and q contiguous and
    16-byte aligned, in one expression of cheap reads."""
    N, Hq, D = q.shape
    shp, qdt, d = kp.shape, q.dtype, q.get_device()
    nd = len(shp)
    if nd != 4 and nd != 5:
        return False
    Hkv = shp[-2]
    return ((qdt is torch.bfloat16 or qdt is torch.float32)
            and kp.dtype is qdt and vp.dtype is qdt and vp.shape == shp
            and shp[-1] == D and (D == 64 or D == 128) and Hkv > 0
            and Hq % Hkv == 0 and Hq <= _MAX_GROUP * Hkv
            and kp.get_device() == d and vp.get_device() == d
            and table.get_device() == d and lengths.get_device() == d
            and table.dtype is torch.int32 and lengths.dtype is torch.int32
            and table.dim() == 2 and table.shape[0] == N
            and lengths.shape == (N,) and q.is_contiguous()
            and kp.is_contiguous() and vp.is_contiguous()
            and table.is_contiguous() and lengths.is_contiguous()
            and not (q.data_ptr() | kp.data_ptr() | vp.data_ptr()) % 16
            and 0 <= layer < (shp[0] if nd == 5 else 1) and N <= _MAX_SLOTS)


def paged_decode_attention(q, cache: PagedKVCache, layer: int = 0):
    """Decode attention: q [N, Hq, D] -> [N, Hq, D], each slot attending
    its first ``cache.lengths[n]`` positions of pool plane ``layer``
    (pools [L, NB, BS, Hkv, D] or [NB, BS, Hkv, D] in q's dtype, bf16 or
    f32; D 64 or 128; at most 8 query heads a kv head; at most 511 slots).
    A zero-length slot returns 0. Launches ``csrc/paged_decode.cu`` on
    CUDA tensors (or raises) — whatever the length, with no fallback to
    the dense gather — and runs :func:`paged_decode_attention_plain` on
    CPU tensors."""
    where = q.device.type
    if where != "cuda":
        if where == "cpu":
            return paged_decode_attention_plain(q, cache, layer)
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    kp, vp, table, lengths = cache
    if not _decode_fits(q, kp, vp, table, lengths, layer):
        _decode_explain(q, _as5d(kp), _as5d(vp), table, lengths, layer)
        if not q.is_contiguous() or q.data_ptr() % 16:
            q = q.clone(memory_format=torch.contiguous_format)
    N, Hq, D = q.shape
    out = torch.empty_like(q)
    if N == 0:
        return out
    fn = _build.kernel("ptt_paged_decode_attention", _DECODE_ARGS)
    NB, BS, Hkv = kp.shape[-4:-1]
    dev = q.get_device()
    stream = _stream(dev)
    flags, scratch = _workspace(dev, stream, N * Hkv)
    err = _on_device(dev, fn, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                     table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                     scratch.data_ptr(),
                     scratch.data_ptr() + 4 * _PARTS_FLOATS,
                     flags.data_ptr(), N, int(layer), NB, BS, Hkv, Hq // Hkv,
                     D, table.shape[1], _DTYPES[q.dtype], stream)
    _build.check(err, "paged_decode_attention")
    _build.launch_counts["paged_decode_attention"] += 1
    return out
