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
  and empty groups come out as zeros. :func:`tile_width` picks the bf16
  ``gmm`` and B9 kernels' output tile (256 or 128 columns) on the host.
- :class:`_GmmTuned` is the differentiable grouped matmul (the JAX
  ``_gmm_tuned`` custom_vjp): forward ``gmm``, backward ``gmm`` with
  ``transpose_rhs`` (dgrad) and ``tgmm`` (wgrad). Its forward runs through
  the registered operator ``torch.ops.paddle_tpu_torch.gmm``, which a
  selective checkpoint policy can name (the MoE model's
  ``remat_policy="outs"``). :func:`grouped_matmul`, :func:`_expert_ffn`
  and :func:`dropless_moe_ffn` (the "gmm" form) build on it;
  :func:`dropless_moe_ffn_fused` is the "fused" form (``moe_fused``).

Not ported yet: the dense-base form (``dropless_moe_ffn_dense``, ROADMAP
A9), the measured form pick and ``gmm_autotune``'s TPU tilings (A9; the
kernels have their own tiles), and the expert-parallel forms
(``dropless_moe_ffn_ep``, ``dropless_moe_ffn_a2a``, ROADMAP A10); they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import torch

from . import _build

__all__ = [
    "dropless_moe_ffn", "dropless_moe_ffn_dense", "dropless_moe_ffn_ep",
    "dropless_moe_ffn_a2a", "dropless_moe_ffn_fused", "sort_by_expert",
    "fused_routing", "routing_from_logits", "Routing", "plan_dispatch",
    "DispatchPlan", "clear_plan_cache", "make_moe_operands", "gmm", "tgmm",
    "tile_width", "gmm_plain", "tgmm_plain", "grouped_matmul",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_f32 = torch.float32


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


def routing_from_logits(logits, top_k: int) -> Routing:
    """Gating and sort metadata from router logits (f32)."""
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
    aux = E * (me * ce).sum()
    order = torch.argsort(flat_e, stable=True)
    return Routing(weights, idx, aux, order, order // top_k, flat_e, gs)


def fused_routing(x, router_w, top_k: int) -> Routing:
    """The dispatch prologue: the f32 router matmul, then
    :func:`routing_from_logits`."""
    return routing_from_logits(x.float() @ router_w.float(), top_k)


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
        return plan
    A = T * k
    Q = min(_round_up(max(int(A / E * (1 + slack)), 1), 128), A)
    plan = DispatchPlan(T, k, E, h, Q, bool(dense_base) and E * Q <= 4 * A)
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
    """Output columns of a bf16 B9/``gmm`` kernel tile for an n-wide
    output: 256 where n is a whole number of 256-column tiles (the MoE
    step's 2816 and 2048), else 128 (1408, 136, 264), so no more than 120
    of a tile's columns are ever padding. Raises on an n the kernels do not
    take (not a positive multiple of 8)."""
    if n <= 0 or n % 8:
        raise ValueError(f"tile_width: {n} columns is not a positive "
                         "multiple of 8")
    return 256 if n % 256 == 0 else 128


def gmm(lhs, rhs, gs, transpose_rhs: bool = False):
    """B10 ``gmm``: ``out[rows of g] = lhs[rows of g] @ rhs[g]`` (or
    ``@ rhs[g].T`` with ``transpose_rhs``) for lhs [m, k] with rows sorted
    by group, rhs [E, k, n] (or [E, n, k]) and int32 group sizes gs [E];
    out [m, n] in lhs's dtype with f32 sums, rows past sum(gs) zero."""
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
                 _DTYPES[lhs.dtype], tile_width(N),
                 _build.stream_handle(lhs))
    _build.check(err, "gmm")
    _build.launch_counts["gmm"] += 1
    return out


def tgmm(lhs_t, rhs, gs, out_dtype=_f32):
    """B10 ``tgmm``: ``out[g] = lhs_t[:, rows of g] @ rhs[rows of g]`` for
    lhs_t [k, m] (usually the transposed view of an [m, k] tensor), rhs
    [m, n] and int32 group sizes gs [E]; out [E, k, n] in ``out_dtype``
    (f32, or the inputs' dtype) with f32 sums, an empty group's block
    zero."""
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
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty((E, K, N), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out               # an empty grid is no launch
    with torch.cuda.device(lhs.device):
        err = fn(_build.ptr(lhs), _build.ptr(rhs), _build.ptr(gs),
                 _build.ptr(out), M, K, N, E, _DTYPES[lhs.dtype],
                 _DTYPES[out_dtype], _build.stream_handle(lhs))
    _build.check(err, "tgmm")
    _build.launch_counts["tgmm"] += 1
    return out


@torch.library.custom_op("paddle_tpu_torch::gmm", mutates_args=())
def gmm_op(lhs: torch.Tensor, rhs: torch.Tensor, gs: torch.Tensor,
           transpose_rhs: bool) -> torch.Tensor:
    """:func:`gmm` as a registered operator (``torch.ops.paddle_tpu_torch
    .gmm``), which a selective checkpoint policy can name."""
    return gmm(lhs, rhs, gs, transpose_rhs)


def _zero_tail(out, gs):
    """Zero the rows >= sum(gs) (the megablox kernel leaves them unwritten;
    the port's kernel and plain version already write zeros there, so
    this changes nothing and is kept for the reference's structure)."""
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    return torch.where(rows < gs.sum(), out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))


class _GmmTuned(torch.autograd.Function):
    """``_GmmTuned.apply(lhs, rhs, gs, full_rows)``: the differentiable
    grouped matmul (the JAX ``_gmm_tuned`` custom_vjp). ``full_rows``
    asserts sum(gs) == m and skips ``_zero_tail``."""

    @staticmethod
    def forward(ctx, lhs, rhs, gs, full_rows):
        out = gmm_op(lhs, rhs, gs, False)
        ctx.save_for_backward(lhs, rhs, gs)
        ctx.full_rows = full_rows
        return out if full_rows else _zero_tail(out, gs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, gs = ctx.saved_tensors
        grad = grad.contiguous()
        dlhs = gmm(grad, rhs, gs, transpose_rhs=True)
        if not ctx.full_rows:
            dlhs = _zero_tail(dlhs, gs)
        drhs = tgmm(lhs.t(), grad, gs, out_dtype=rhs.dtype)
        return dlhs, drhs, None, None


def grouped_matmul(xs, w, gs, full_rows: bool = False):
    """[m, k] @ per-group [E, k, n] over expert-sorted rows (B10 on the
    card, its plain version on the CPU), differentiable.
    ``full_rows=True`` asserts sum(gs) == m."""
    return _GmmTuned.apply(xs.contiguous(), w.contiguous(), gs, full_rows)


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


def dropless_moe_ffn_dense(*args, **kwargs):
    raise NotImplementedError(
        "the dense-base dispatch form (dropless_moe_ffn_dense) is not "
        "ported yet (ROADMAP A9, rest)")


def dropless_moe_ffn_ep(*args, **kwargs):
    raise NotImplementedError(
        "the expert-parallel dispatch (dropless_moe_ffn_ep) is not ported "
        "yet (ROADMAP A10)")


def dropless_moe_ffn_a2a(*args, **kwargs):
    raise NotImplementedError(
        "the ragged all-to-all dispatch (dropless_moe_ffn_a2a) is not "
        "ported yet (ROADMAP A10)")
