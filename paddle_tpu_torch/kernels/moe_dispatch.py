"""Dropless (capacity-less) MoE token dispatch — the port of
paddle_tpu/kernels/moe_dispatch (its single-program forms).

- :func:`fused_routing` is the dispatch prologue: the f32 router matmul,
  top-k gating, the load-balance aux loss and the expert-sort metadata
  (a **stable** argsort, so the combine order is deterministic) in one
  place, reused by every dispatch form through ``routing=``.
- :func:`plan_dispatch` memoizes the shape-derived plan per routing shape.
- B10, the grouped GEMM: :func:`gmm` (``csrc/gmm.cu``; [m, k] rows sorted
  by group times per-group [E, k, n], or [E, n, k] with
  ``transpose_rhs``) and :func:`tgmm` (``csrc/tgmm.cu``; the per-group
  weight gradient [E, k, n]). On CUDA tensors they launch the kernels, on
  CPU tensors they run their plain versions. Group sizes stay on the
  device: the kernels read them there and the host never does. Both
  kernels write every row and group they own, so rows past ``sum(gs)``
  and empty groups come out as zeros. Their ``bn`` is the bf16 kernels'
  output tile width (128 or 256 columns); None takes :func:`tile_width`,
  the static pick.
- :class:`_GmmTuned` is the differentiable grouped matmul (the JAX
  ``_gmm_tuned`` custom_vjp): forward ``gmm``, backward ``gmm`` with
  ``transpose_rhs`` (dgrad) and ``tgmm`` (wgrad), each pass at the width
  :func:`gmm_autotune.get_tilings` measured for its shape on the card.
  Its forward runs through the registered operator
  ``torch.ops.paddle_tpu_torch.gmm``. :func:`grouped_matmul`,
  :func:`_expert_ffn` and :func:`dropless_moe_ffn` (the "gmm" form) build
  on it; :func:`dropless_moe_ffn_fused` is the "fused" form
  (``moe_fused``).
- :func:`dropless_moe_ffn_dense` is the "dense" form: scatter-free gathers
  stage each expert's tokens into a fixed [E, Q, h] buffer and the expert
  FFN runs as batched products (``torch.bmm``, as the reference's are
  XLA einsums outside any Pallas kernel), with a hand-written backward of
  gathers only; a batch whose expert load overflows Q takes the gmm form
  (B10), so nothing is dropped.
- :func:`pick_dispatch_form` measures the forms forward and backward once
  per routing shape on the card and persists the winner
  (``jit/cache.py``, ``moe_dispatch_forms.json``); without CUDA the
  static default "fused" answers.

Not ported yet: the expert-parallel forms (``dropless_moe_ffn_ep``,
``dropless_moe_ffn_a2a``, ROADMAP A10); they raise
``NotImplementedError``.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..framework.flags import define_flag, get_flag
from ..jit import cache as _jcache
from ..observability import numerics as _numerics
from ..observability.catalog import instrument as _instrument
from . import _build
from .gmm_autotune import _device_tag, get_tilings, time_best

define_flag("moe_dispatch_autotune", True,
            "measure dense vs gmm vs fused dispatch once per routing shape "
            "on the card and use the winner (never worse than the static "
            "default); off = the static choice")

__all__ = [
    "dropless_moe_ffn", "dropless_moe_ffn_dense", "dropless_moe_ffn_ep",
    "dropless_moe_ffn_a2a", "dropless_moe_ffn_fused", "sort_by_expert",
    "fused_routing", "routing_from_logits", "Routing", "plan_dispatch",
    "DispatchPlan", "clear_plan_cache", "make_moe_operands", "gmm", "tgmm",
    "tile_width", "gmm_plain", "tgmm_plain", "grouped_matmul",
    "pick_dispatch_form", "clear_form_cache", "time_best", "dense_paths",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_f32 = torch.float32

# the reference's dispatch metrics. Of moe_dispatch_fallbacks_total's
# reasons the port emits dense_buffer_too_big: it has no rewrite to fall
# back to where B10 cannot take a shape (the wrappers raise there), and
# ep_shape_mismatch comes with the expert-parallel forms (ROADMAP A10)
_M_PLAN_HITS = _instrument("moe_plan_cache_hits_total")
_M_PLAN_MISSES = _instrument("moe_plan_cache_misses_total")
_M_FALLBACKS = _instrument("moe_dispatch_fallbacks_total")


def sort_by_expert(idx):
    """Flatten top-k assignments [T, k] into a stable expert-sorted order.

    Returns (order [T*k] assignment permutation, tok [T*k] source token of
    each sorted assignment, flat_e [T*k] unsorted expert ids)."""
    T, k = idx.shape
    flat_e = idx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)   # deterministic combine
    return order, order // k, flat_e


# ---------------------------------------------------------------------------
# fused routing prologue
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    """Everything the router run produces, computed once per MoE layer;
    ``weights``/``idx``/``aux`` are ``moe.top_k_gating``'s."""

    weights: torch.Tensor   # [T, k] f32, renormalized top-k gate weights
    idx: torch.Tensor       # [T, k] int64 expert ids
    aux: torch.Tensor       # 0-d f32 load-balance aux loss (GShard eq. 4)
    order: torch.Tensor     # [T*k] expert-sorted assignment permutation
    tok: torch.Tensor       # [T*k] source token of each sorted assignment
    flat_e: torch.Tensor    # [T*k] unsorted expert ids
    gs: torch.Tensor        # [E] int32 per-expert assignment counts


def routing_from_logits(logits, top_k: int, global_mean=None) -> Routing:
    """Gating and sort metadata from router logits (f32). ``global_mean``
    (sharded training: the mean over the data-parallel ranks) takes the
    per-expert ``mean(probs)`` and top-1 ``mean(onehot)`` before their
    product, so the aux loss is the global batch's."""
    probs = torch.softmax(logits.float(), dim=-1)                 # [T, E]
    weights, idx = torch.topk(probs, top_k, dim=-1)               # [T, k]
    weights = weights / weights.sum(-1, keepdim=True)
    T, E = logits.shape
    flat_e = idx.reshape(T * top_k)
    # one one-hot feeds the group sizes and the aux loss's expert fractions
    onehot = (flat_e[:, None] == torch.arange(E, device=logits.device)
              ).to(torch.int32)                                   # [A, E]
    gs = onehot.sum(0, dtype=torch.int32)
    me = probs.mean(0)
    # rows 0, k, 2k, ... of the flat one-hot are the top-1 assignments
    ce = onehot.reshape(T, top_k, E)[:, 0].float().mean(0)
    if global_mean is not None:
        me, ce = global_mean(me), global_mean(ce)
    aux = E * (me * ce).sum()
    order = torch.argsort(flat_e, stable=True)
    return Routing(weights, idx, aux, order, order // top_k, flat_e, gs)


def fused_routing(x, router_w, top_k: int, global_mean=None) -> Routing:
    """The dispatch prologue: the f32 router matmul, then
    :func:`routing_from_logits`. With numerics on, the router logits are
    probed (``moe.router_logits``): a diverging router is the classic MoE
    blowup source, and its NaNs surface here before they smear across
    every expert. Inside a checkpointed layer the recompute probes them
    again, as the reference's remat'd bodies do."""
    logits = x.float() @ router_w.float()
    _numerics.record_stats("moe.router_logits", logits)
    return routing_from_logits(logits, top_k, global_mean)


# ---------------------------------------------------------------------------
# dispatch plan
# ---------------------------------------------------------------------------

class DispatchPlan(NamedTuple):
    """Static dispatch decisions for one routing shape (T, k, E, h)."""

    T: int
    k: int
    E: int
    h: int
    Q: int               # dense-base slots per expert (A/E + slack, /128)
    use_dense: bool      # dense [E, Q, h] staging would beat the sort here


_PLAN_CACHE: Dict[tuple, DispatchPlan] = {}
_PLAN_LOCK = threading.Lock()


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_dispatch(T: int, k: int, E: int, h: int, slack: float = 0.125,
                  dense_base: bool = True) -> DispatchPlan:
    """The memoized plan for one routing shape (every MoE layer after the
    first, and every later step, reuses it)."""
    key = (T, k, E, h, float(slack), bool(dense_base))
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _M_PLAN_HITS.inc()
        return plan
    _M_PLAN_MISSES.inc()
    A = T * k
    Q = min(_round_up(max(int(A / E * (1 + slack)), 1), 128), A)
    use_dense = bool(dense_base) and E * Q <= 4 * A
    if dense_base and not use_dense:
        # tiny/test shapes: the base buffer would dwarf the real work
        _M_FALLBACKS.labels(reason="dense_buffer_too_big").inc()
    plan = DispatchPlan(T, k, E, h, Q, use_dense)
    with _PLAN_LOCK:
        return _PLAN_CACHE.setdefault(key, plan)


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()


def make_moe_operands(T: int, h: int, E: int, f: int, dtype, seed: int = 0,
                      device="cuda"):
    """The synthetic routed-FFN operands ``(x [T, h], router_w [h, E] f32,
    e_gate [E, h, f], e_up [E, h, f], e_down [E, f, h])``, weights scaled
    0.1, from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    return (rnd((T, h)).to(dtype), rnd((h, E), 0.1),
            rnd((E, h, f), 0.1).to(dtype), rnd((E, h, f), 0.1).to(dtype),
            rnd((E, f, h), 0.1).to(dtype))


# ---------------------------------------------------------------------------
# B10: the grouped GEMM and its weight gradient
# ---------------------------------------------------------------------------

def _wide(t):
    """``t`` in the plain versions' working type: f32, or f64 for f64."""
    return t if t.dtype == torch.float64 else t.float()


def _bounds(gs, M):
    """(group, first row, end row) of each group, clipped to M rows (a
    host read of gs: the plain versions only)."""
    out, start = [], 0
    for g, n in enumerate(gs.tolist()):
        lo, hi = min(start, M), min(start + n, M)
        out.append((g, lo, hi))
        start += n
    return out


def gmm_plain(lhs, rhs, gs, transpose_rhs: bool = False):
    """The plain version of :func:`gmm`: one f32 product a group, rounded
    to lhs's dtype; rows at or past sum(gs) are zeros."""
    M, N = lhs.shape[0], rhs.shape[1 if transpose_rhs else 2]
    out = torch.zeros((M, N), dtype=lhs.dtype, device=lhs.device)
    for g, lo, hi in _bounds(gs, M):
        if hi > lo:
            w = rhs[g].t() if transpose_rhs else rhs[g]
            out[lo:hi] = (_wide(lhs[lo:hi]) @ _wide(w)).to(lhs.dtype)
    return out


def tgmm_plain(lhs_t, rhs, gs, out_dtype=_f32):
    """The plain version of :func:`tgmm`: one f32 product a group; an
    empty group's block is zeros."""
    K, M = lhs_t.shape
    out = torch.zeros((gs.shape[0], K, rhs.shape[1]), dtype=out_dtype,
                      device=lhs_t.device)
    for g, lo, hi in _bounds(gs, M):
        if hi > lo:
            out[g] = (_wide(lhs_t[:, lo:hi]) @ _wide(rhs[lo:hi])).to(out_dtype)
    return out


def _check_cuda(name, tensors, widths, int8: bool = False):
    """What the grouped-GEMM kernels take: one dtype of bf16 or f32 (with
    ``int8``: int8 tensors, B9's int8 rhs, widths multiples of 16),
    contiguous 16-byte-aligned tensors, and widths that are multiples of 8
    (16-byte rows). B10 takes no int8: callers widen an int8 weight
    first."""
    dts = [t.dtype for t in tensors]
    if int8:
        if any(d != torch.int8 for d in dts):
            raise TypeError(f"{name}: expected int8 tensors, got {dts}")
    elif torch.int8 in dts:
        raise TypeError(f"{name} takes no int8 tensors ({dts}): widen an "
                        "int8 expert weight to the rows' dtype first")
    elif dts[0] not in _DTYPES or any(d != dts[0] for d in dts):
        raise TypeError(f"{name} takes bf16 or f32 tensors of one dtype, "
                        f"got {dts}")
    if any(w % (16 if int8 else 8) for w in widths):
        raise ValueError(f"{name}: widths {widths} must be multiples of "
                         f"{16 if int8 else 8}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name} needs contiguous 16-byte-aligned inputs")


def _check_index(name, t, device, n):
    if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 [{n}] tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def tile_width(n: int) -> int:
    """Output columns of a bf16 B9/B10 kernel tile for an n-wide output
    (``tgmm``'s n is rhs's width): 256 where n is a whole number of
    256-column tiles (the MoE step's 2816 and 2048), else 128 (1408, 136,
    264), so no more than 120 of a tile's columns are ever padding.
    Raises on an n the kernels do not take (not a positive multiple of
    8)."""
    if n <= 0 or n % 8:
        raise ValueError(f"tile_width: {n} columns is not a positive "
                         "multiple of 8")
    return 256 if n % 256 == 0 else 128


def _bn(bn, n: int) -> int:
    """The tile width passed to a kernel: ``bn``, or :func:`tile_width`
    when None; the kernels take 128 and 256 only."""
    if bn is None:
        return tile_width(n)
    if bn not in (128, 256):
        raise ValueError(f"tile width {bn}: the kernels take 128 or 256")
    return bn


def gmm(lhs, rhs, gs, transpose_rhs: bool = False, bn=None):
    """B10 ``gmm``: ``out[rows of g] = lhs[rows of g] @ rhs[g]`` (or
    ``@ rhs[g].T`` with ``transpose_rhs``) for lhs [m, k] with rows sorted
    by group, rhs [E, k, n] (or [E, n, k]) and int32 group sizes gs [E];
    out [m, n] in lhs's dtype with f32 sums, rows past sum(gs) zero.
    ``bn``: the bf16 kernel's tile width (None: :func:`tile_width`)."""
    M, K = lhs.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    if rhs.dim() != 3 or rhs.shape[2 if transpose_rhs else 1] != K \
            or gs.shape != (E,):
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}, gs {tuple(gs.shape)} "
                         f"(transpose_rhs={transpose_rhs}) do not match")
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, gs, transpose_rhs)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm: unsupported device {lhs.device}")
    _check_cuda("gmm", (lhs, rhs), (K, N))
    _check_index("gmm", gs, lhs.device, E)
    fn = _build.kernel("ptt_gmm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out               # an empty grid is no launch
    with torch.cuda.device(lhs.device):
        err = fn(_build.ptr(lhs), _build.ptr(rhs), _build.ptr(gs),
                 _build.ptr(out), M, K, N, E, int(transpose_rhs),
                 _DTYPES[lhs.dtype], _bn(bn, N),
                 _build.stream_handle(lhs))
    _build.check(err, "gmm")
    _build.count_launch("gmm")
    return out


def tgmm(lhs_t, rhs, gs, out_dtype=_f32, bn=None):
    """B10 ``tgmm``: ``out[g] = lhs_t[:, rows of g] @ rhs[rows of g]`` for
    lhs_t [k, m] (usually the transposed view of an [m, k] tensor), rhs
    [m, n] and int32 group sizes gs [E]; out [E, k, n] in ``out_dtype``
    (f32, or the inputs' dtype) with f32 sums, an empty group's block
    zero. ``bn``: the bf16 kernel's tile width (None:
    :func:`tile_width`)."""
    K, M = lhs_t.shape
    N = rhs.shape[1]
    E = gs.shape[0]
    if rhs.shape[0] != M or gs.dim() != 1:
        raise ValueError(f"tgmm: lhs_t {tuple(lhs_t.shape)}, rhs "
                         f"{tuple(rhs.shape)}, gs {tuple(gs.shape)} do not "
                         f"match")
    if lhs_t.device.type == "cpu":
        return tgmm_plain(lhs_t, rhs, gs, out_dtype)
    if lhs_t.device.type != "cuda":
        raise ValueError(f"tgmm: unsupported device {lhs_t.device}")
    lhs = lhs_t.t().contiguous()          # [m, k]: no copy for a .t() view
    _check_cuda("tgmm", (lhs, rhs), (K, N))
    _check_index("tgmm", gs, lhs.device, E)
    if out_dtype not in (_f32, lhs.dtype):
        raise TypeError(f"tgmm writes f32 or {lhs.dtype}, not {out_dtype}")
    fn = _build.kernel("ptt_tgmm", [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    out = torch.empty((E, K, N), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out               # an empty grid is no launch
    with torch.cuda.device(lhs.device):
        err = fn(_build.ptr(lhs), _build.ptr(rhs), _build.ptr(gs),
                 _build.ptr(out), M, K, N, E, _DTYPES[lhs.dtype],
                 _DTYPES[out_dtype], _bn(bn, N),
                 _build.stream_handle(lhs))
    _build.check(err, "tgmm")
    _build.count_launch("tgmm")
    return out


@torch.library.custom_op("paddle_tpu_torch::gmm", mutates_args=())
def gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, gs: torch.Tensor,
           transpose_rhs: bool, bn: int) -> torch.Tensor:
    """:func:`gmm` as a registered operator (``torch.ops.paddle_tpu_torch
    .gmm``; ``bn`` 0 takes :func:`tile_width`)."""
    return gmm(lhs, rhs, gs, transpose_rhs, bn or None)


def _zero_tail(out, gs):
    """Zero the rows >= sum(gs) (the megablox kernel leaves them unwritten;
    the port's kernel and plain version already write zeros there, so
    this changes nothing and is kept for the reference's structure)."""
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    return torch.where(rows < gs.sum(), out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))


def _widths(tilings):
    """(fwd, dgrad, wgrad) tile widths of a tiling triple; None for each
    where ``tilings`` is None (the kernels' static pick)."""
    if tilings is None:
        return None, None, None
    return tuple(t[2] for t in tilings)


class _GmmTuned(torch.autograd.Function):
    """``_GmmTuned.apply(lhs, rhs, gs, full_rows, tilings)``: the
    differentiable grouped matmul (the JAX ``_gmm_tuned`` custom_vjp).
    ``full_rows`` asserts sum(gs) == m and skips ``_zero_tail``;
    ``tilings`` (:func:`gmm_autotune.get_tilings`, or None) gives each
    pass its tile width."""

    @staticmethod
    def forward(ctx, lhs, rhs, gs, full_rows, tilings=None):
        bn_fwd, ctx.bn_dgrad, ctx.bn_wgrad = _widths(tilings)
        out = gmm_op(lhs, rhs, gs, False, bn_fwd or 0)
        ctx.save_for_backward(lhs, rhs, gs)
        ctx.full_rows = full_rows
        return out if full_rows else _zero_tail(out, gs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, gs = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = gmm(grad, rhs, gs, transpose_rhs=True, bn=ctx.bn_dgrad)
        if not ctx.full_rows:
            dlhs = _zero_tail(dlhs, gs)
        drhs = tgmm(lhs.t(), grad, gs, out_dtype=rhs.dtype, bn=ctx.bn_wgrad)
        return dlhs, drhs, None, None, None


def grouped_matmul(xs, w, gs, full_rows: bool = False):
    """[m, k] @ per-group [E, k, n] over expert-sorted rows (B10 on the
    card, its plain version on the CPU), differentiable.
    ``full_rows=True`` asserts sum(gs) == m. On the card each pass runs
    at the tile width :func:`gmm_autotune.get_tilings` gives this shape
    (measured on its first encounter)."""
    tilings = None
    if xs.device.type == "cuda":
        tilings = get_tilings(xs.shape[0], xs.shape[1], w.shape[-1],
                              w.shape[0], xs.dtype, full_rows)
    return _GmmTuned.apply(xs.contiguous(), w.contiguous(), gs, full_rows,
                           tilings)


def _expert_ffn(xs, gs, e_gate, e_up, e_down, dt, full_rows=False,
                esorted=None):
    """Grouped-GEMM SwiGLU over expert-sorted rows; gate and up ride one
    grouped GEMM over the width-2f concatenation of their weights. int8
    leaves (``quant_matmul.quantize_grouped``) widen to ``dt`` before each
    grouped GEMM; the gate|up scales multiply its output and the down
    scales its input, by each row's expert ``esorted``."""
    from .moe_fused import _gate_up, _grouped, _unpack

    Wcat, s_gu = _gate_up(e_gate, e_up, dt)
    Wd, s_down = _unpack(e_down)
    f = Wcat.shape[-1] // 2
    gu = _grouped(xs, Wcat, gs, full_rows)
    if s_gu is not None:
        gu = gu * s_gu.index_select(0, esorted).to(gu.dtype)
    z = torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]
    if s_down is not None:
        z = z * s_down.index_select(0, esorted).to(dt)
    return _grouped(z, Wd if s_down is not None else Wd.to(dt), gs,
                    full_rows)


def _shared_swiglu(x, s_gate, s_up, s_down, dt):
    """The always-on shared-expert FFN."""
    xc = x.to(dt)
    g = torch.nn.functional.silu(xc @ s_gate.to(dt))
    return (g * (xc @ s_up.to(dt))) @ s_down.to(dt)


def dropless_moe_ffn(x, weights, idx, e_gate, e_up, e_down,
                     routing: Optional[Routing] = None):
    """Capacity-less routed FFN, the "gmm" form: gather the expert-sorted
    rows, the grouped-GEMM SwiGLU, and a weighted scatter-add combine.
    x: [T, h]; weights/idx: [T, k]; experts [E, h, f] / [E, f, h]."""
    T, h = x.shape
    E = (e_gate["q"] if isinstance(e_gate, dict) else e_gate).shape[0]
    if routing is None:
        order, tok, flat_e = sort_by_expert(idx)
        gs = torch.bincount(flat_e, minlength=E).to(torch.int32)
    else:
        order, tok, flat_e, gs = (routing.order, routing.tok, routing.flat_e,
                                  routing.gs)
    xs = x.index_select(0, tok)                             # [T*k, h]
    # every assignment belongs to a real expert: sum(gs) == T*k
    ys = _expert_ffn(xs, gs, e_gate, e_up, e_down, x.dtype, full_rows=True,
                     esorted=flat_e[order])
    ws = weights.reshape(-1)[order].float()
    y = torch.zeros((T, h), dtype=_f32, device=x.device).index_add(
        0, tok, ys.float() * ws[:, None])
    return y.to(x.dtype)


def dropless_moe_ffn_fused(x, weights, idx, e_gate, e_up, e_down,
                           routing: Optional[Routing] = None):
    """Capacity-less routed FFN, the "fused" scatter-free form — see
    :func:`paddle_tpu_torch.kernels.moe_fused.fused_moe_ffn`."""
    from .moe_fused import fused_moe_ffn

    return fused_moe_ffn(x, weights, idx, e_gate, e_up, e_down,
                         routing=routing)


# ---------------------------------------------------------------------------
# the dense-base form
# ---------------------------------------------------------------------------

# route of each dropless_moe_ffn_dense call that stages a dense base:
# "dense", or "gmm" for a batch whose expert load overflowed Q. Each such
# call reads its overflow predicate on the host once (one sync a call).
dense_paths: collections.Counter = collections.Counter()


def _dense_meta(idx, E: int, Q: int):
    """Branch-free routing metadata for the dense-base dispatch.

    Returns (r [A] slot of each flat assignment, src_tok [E*Q] source
    token of each slot (0 for an empty one), w_sel [E*Q] int32 assignment
    id of each slot (A for an empty one), ok: a 0-d bool tensor, every
    expert's load fits Q).

    No sort: an assignment's rank within its expert is the exclusive
    prefix count of its expert's one-hot column. The one-hot is laid out
    [E, A] so the prefix count runs along the contiguous axis (torch's
    scan along the outer axis of [A, E] runs E columns one after another
    and took most of the form's time on the H100). An overflowing
    assignment (rank >= Q, only when not ok) gets slot E*Q, so it lands
    in no valid slot (the caller then takes the gmm form)."""
    T, k = idx.shape
    A = T * k
    flat_e = idx.reshape(A).long()
    onehot = (torch.arange(E, device=idx.device)[:, None] == flat_e[None, :]
              ).to(torch.int32)                                   # [E, A]
    ranks = torch.cumsum(onehot, 1, dtype=torch.int32)           # inclusive
    pos = ranks.gather(0, flat_e[None, :])[0].long() - 1
    gs = ranks[:, -1]
    ok = gs.max() <= Q
    r = torch.where(pos < Q, flat_e * Q + pos,
                    torch.full_like(pos, E * Q))
    # slot -> flat assignment id (A = empty); overflow writes the extra
    # slot E*Q, which is cut off
    w_sel = torch.full((E * Q + 1,), A, dtype=torch.int32,
                       device=idx.device).index_put_(
        (r,), torch.arange(A, dtype=torch.int32, device=idx.device))[:E * Q]
    src_tok = torch.where(w_sel < A, w_sel // k, torch.zeros_like(w_sel))
    return r, src_tok, w_sel, ok


def _bmm_f32(a, b):
    """A batched product whose result is f32: exact f32 for f32 operands;
    for bf16 operands cuBLAS's f32 sums rounded to bf16 once, then
    widened (the reference keeps its f32 sums; the gradient it feeds is
    rounded to the parameter's dtype next, which for a bf16 parameter is
    the same single rounding)."""
    return torch.bmm(a, b).float()


class _DenseBase(torch.autograd.Function):
    """``_DenseBase.apply(x, weights, e_gate, e_up, e_down, r, src_tok,
    w_sel, k)``: the routed SwiGLU over a dense [E*Q, h] base buffer, with
    the reference's hand-written backward (``_dense_base_bwd``). Every
    data movement in both directions is a gather: slots r[t*k:(t+1)*k]
    enumerate token t's assignments, so y (forward) and dx (backward) are
    k-way gathered sums; d_w is the k-way gather of the slot outputs, and
    the slot gradients come through w_sel / src_tok, never a scatter."""

    @staticmethod
    def forward(ctx, x, weights, e_gate, e_up, e_down, r, src_tok, w_sel,
                k):
        T, h = x.shape
        E, _, f = e_gate.shape
        dt = x.dtype
        xb = x.index_select(0, src_tok)                       # [E*Q, h]
        Wcat = torch.cat([e_gate, e_up], -1).to(dt)
        gu = torch.bmm(xb.reshape(E, -1, h), Wcat)            # [E, Q, 2f]
        z = torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]
        ycat = torch.bmm(z, e_down.to(dt)).reshape(-1, h)     # [E*Q, h]
        yg = ycat.index_select(0, r).reshape(T, k, h).float()
        w = weights.reshape(T, k).float()
        ctx.save_for_backward(weights, e_gate, e_up, e_down, r, src_tok,
                              w_sel, xb, gu, z, ycat)
        ctx.k = k
        return (yg * w[..., None]).sum(1).to(dt)

    @staticmethod
    def backward(ctx, dy):
        (weights, e_gate, e_up, e_down, r, src_tok, w_sel, xb, gu, z,
         ycat) = ctx.saved_tensors
        k = ctx.k
        E, h, f = e_gate.shape
        T = dy.shape[0]
        A = T * k
        dt = xb.dtype
        w = weights.reshape(A).float()
        # router-weight gradient: d_w[a] = <dy[tok(a)], ycat[r[a]]>
        yg = ycat.index_select(0, r).reshape(T, k, h).float()
        d_w = torch.einsum("th,tkh->tk", dy.float(), yg)
        # slot gradients: each slot's weight through the slot->assignment
        # map (0 for an empty slot), its dy row through src_tok
        w_slot = torch.where(w_sel < A,
                             w.index_select(0, w_sel.clamp(max=A - 1)),
                             torch.zeros((), device=w.device))
        d_yb = (dy.index_select(0, src_tok).float() * w_slot[:, None]
                ).to(dt).reshape(E, -1, h)
        dz = torch.bmm(d_yb, e_down.to(dt).transpose(1, 2))   # [E, Q, f]
        d_down = _bmm_f32(z.transpose(1, 2), d_yb)            # [E, f, h]
        g, u = gu[..., :f], gu[..., f:]
        sg = torch.sigmoid(g.float()).to(dt)
        silu_g = g * sg
        d_u = dz * silu_g
        d_g = dz * u * (sg + silu_g * (1 - sg)).to(dt)
        dgu = torch.cat([d_g, d_u], -1)                       # [E, Q, 2f]
        xbr = xb.reshape(E, -1, h)
        d_w1 = _bmm_f32(xbr.transpose(1, 2), dgu)             # [E, h, 2f]
        Wcat = torch.cat([e_gate, e_up], -1).to(dt)
        d_xb = torch.bmm(dgu, Wcat.transpose(1, 2)).reshape(-1, h)
        # dx[t] = sum_j d_xb[slot of assignment (t, j)]: a gather by r
        dx = d_xb.index_select(0, r).reshape(T, k, h).float().sum(1)
        return (dx.to(dt), d_w.reshape(weights.shape).to(weights.dtype),
                d_w1[..., :f].to(e_gate.dtype), d_w1[..., f:].to(e_up.dtype),
                d_down.to(e_down.dtype), None, None, None, None)


def dropless_moe_ffn_dense(x, weights, idx, e_gate, e_up, e_down,
                           slack: float = 0.125,
                           routing: Optional[Routing] = None,
                           plan: Optional[DispatchPlan] = None):
    """Capacity-less routed FFN, the dense-base form (single device).

    Scatter-free gathers stage each expert's tokens into a fixed
    [E, Q, h] buffer (Q = A/E rounded up with ``slack`` headroom, from the
    :class:`DispatchPlan`) and the expert FFN runs as batched products
    over fixed shapes. Nothing is dropped: a batch whose expert load
    exceeds Q takes the gmm form (:func:`dropless_moe_ffn`, B10), so Q
    bounds speed, never the result. Where the plan says the base buffer
    would dwarf the work (``plan.use_dense`` false) the gmm form runs
    with ``routing`` reused.

    The reference decides between the two with a ``lax.cond`` on the
    device. Eager torch cannot branch on a device boolean, so this reads
    the overflow predicate on the host: one sync a call, counted with the
    route in :data:`dense_paths`. Either branch's result equals the
    reference's, and no form without the read gives the same results for
    every batch (staging at Q = A would, at E times the products)."""
    T, h = x.shape
    E = e_gate.shape[0]
    k = idx.shape[1]
    if plan is None:
        plan = plan_dispatch(T, k, E, h, slack=slack)
    if not plan.use_dense:
        return dropless_moe_ffn(x, weights, idx, e_gate, e_up, e_down,
                                routing=routing)
    r, src_tok, w_sel, ok = _dense_meta(idx, E, plan.Q)
    if bool(ok):
        dense_paths["dense"] += 1
        return _DenseBase.apply(x, weights, e_gate, e_up, e_down, r,
                                src_tok, w_sel, k)
    # the overflow batch re-derives its sort, as the reference's branch
    # does (the steady-state dense path never sorts)
    dense_paths["gmm"] += 1
    return dropless_moe_ffn(x, weights, idx, e_gate, e_up, e_down)


# ---------------------------------------------------------------------------
# measured dispatch-form selection
#
# The reference measures the single-program forms once per routing shape
# (forward and backward, the quantity a train step pays) and persists the
# winner through the jit artifact cache; the static default ("fused") is
# always a candidate, so the pick is never worse than it.
# ---------------------------------------------------------------------------

_FORM_PERSIST = "moe_dispatch_forms"
# v2: keys carry the dense_ok candidate-set field — an entry measured with
# the dense form admitted never answers for a caller that excluded it
_FORM_SCHEMA = 2
_FORM_STATIC = "fused"
_FORM_CACHE: Dict[str, dict] = {}
_FORM_LOADED = False


def _forms_ensure_loaded() -> None:
    global _FORM_LOADED
    if _FORM_LOADED:
        return
    disk = _jcache.load_json(_FORM_PERSIST, schema=_FORM_SCHEMA)
    with _PLAN_LOCK:
        if _FORM_LOADED:
            return
        for key, ent in disk.items():
            if (isinstance(ent, dict)
                    and ent.get("winner") in ("fused", "gmm", "dense")
                    and key not in _FORM_CACHE):
                _FORM_CACHE[key] = ent
        _FORM_LOADED = True


def _forms_persist() -> None:
    with _PLAN_LOCK:
        doc = {k: dict(e) for k, e in _FORM_CACHE.items()
               if e.get("source") == "measured"}
    _jcache.store_json(_FORM_PERSIST, doc, schema=_FORM_SCHEMA)


def clear_form_cache() -> None:
    """Drop the in-process form cache (the next pick re-reads the file)."""
    global _FORM_LOADED
    with _PLAN_LOCK:
        _FORM_CACHE.clear()
        _FORM_LOADED = False


def _default_form_measure(T: int, k: int, E: int, h: int, f: int, dtype,
                          device=None, timer=None) -> Optional[Callable]:
    """The forward-plus-backward timing closure ``run(form) -> seconds``
    of one dispatch form at the real routing shape on ``device`` (default:
    the current CUDA device; the sum-of-squares loss through
    :func:`fused_routing` on :func:`make_moe_operands`), or None without
    CUDA (then the static default answers). ``timer`` replaces
    :func:`time_best` (a host clock, to rehearse off the card)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)

    def run(form: str) -> float:
        fn = {"fused": dropless_moe_ffn_fused, "gmm": dropless_moe_ffn,
              "dense": dropless_moe_ffn_dense}[form]
        x, rw, eg, eu, ed = make_moe_operands(T, h, E, f, dtype, device=dev)
        leaves = [t.requires_grad_(True) for t in (x, eg, eu, ed)]

        def fwd_bwd():
            with torch.enable_grad():     # a caller may run under no_grad
                r = fused_routing(leaves[0], rw, k)
                y = fn(leaves[0], r.weights, r.idx, *leaves[1:], routing=r)
                loss = y.float().square().sum()
                return torch.autograd.grad(loss, leaves)

        return (timer or time_best)(fwd_bwd)

    return run


def pick_dispatch_form(T: int, k: int, E: int, h: int, f: int, dtype, *,
                       dense_ok: bool = False,
                       measure: Optional[Callable] = None) -> str:
    """'fused' | 'gmm' | 'dense' for one single-device routing shape.

    On the card the first encounter measures forward and backward of each
    candidate form at the real shape, keeps the winner (never worse than
    the static default: the default is always a candidate, and a winner
    within 2% of it loses to it) and persists it. Without CUDA, or with
    ``FLAGS_moe_dispatch_autotune`` off: the static default.
    ``measure(form) -> seconds`` is injectable for tests.

    One deliberate difference from the reference, which skips a form
    whose measurement raises anything: here only the dense candidate's
    ``torch.cuda.OutOfMemoryError`` is absorbed (its [E, Q, h] staging may
    not fit where fused and gmm do). A CUDA error, a build failure or a
    launch failure of any form propagates."""
    static = _FORM_STATIC
    if not get_flag("moe_dispatch_autotune"):
        return static
    runner = measure if measure is not None else _default_form_measure(
        T, k, E, h, f, dtype)
    if runner is None:
        return static
    cands = ["fused", "gmm"] + (["dense"] if dense_ok else [])
    _forms_ensure_loaded()
    key = (f"{_device_tag()}|T={T}|k={k}|E={E}|h={h}|f={f}|"
           f"{str(dtype).replace('torch.', '')}|dense_ok={bool(dense_ok)}")
    with _PLAN_LOCK:
        ent = _FORM_CACHE.get(key)
    if ent is not None and ent["winner"] in cands:
        return ent["winner"]
    times: Dict[str, float] = {}
    for form in cands:
        try:
            times[form] = runner(form)
        except torch.cuda.OutOfMemoryError:
            if form != "dense":
                raise
            torch.cuda.empty_cache()      # dense staging did not fit
    winner = min(times, key=times.get)
    if winner != static and times[winner] > times[static] * 0.98:
        winner = static               # within noise: keep the default
    ent = {"winner": winner,
           "ms": {fm: round(v * 1e3, 3) for fm, v in times.items()},
           "source": "measured"}
    with _PLAN_LOCK:
        # a racing measurement's entry is kept only if its winner is
        # admissible here (a stale record never answers with an excluded
        # form)
        existing = _FORM_CACHE.get(key)
        if existing is not None and existing.get("winner") in cands:
            ent = existing
        else:
            _FORM_CACHE[key] = ent
    _forms_persist()
    return ent["winner"]


def dropless_moe_ffn_ep(*args, **kwargs):
    raise NotImplementedError(
        "the expert-parallel dispatch (dropless_moe_ffn_ep) is not ported "
        "yet (ROADMAP A10)")


def dropless_moe_ffn_a2a(*args, **kwargs):
    raise NotImplementedError(
        "the ragged all-to-all dispatch (dropless_moe_ffn_a2a) is not "
        "ported yet (ROADMAP A10)")
