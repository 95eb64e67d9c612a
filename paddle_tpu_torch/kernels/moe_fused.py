"""Fused dropless-MoE dispatch: the scatter-free grouped-GEMM hot path —
the port of paddle_tpu/kernels/moe_fused.

The routed FFN is arranged so that no scatter runs in either direction:
the combine weight folds into the elementwise SiLU chain before the down
GEMM, the combine is a k-way gather (token t's k outputs sit at known
sorted positions, the inverse of the expert sort), and both gathers carry
autograd Functions whose backward is a gather too (``d_ys[p] =
dy[tok[p]]``, ``dx[t] = sum_j d_xs[inv[t, j]]``).

B9, :func:`gather_gmm` (``csrc/gather_gmm.cu``), folds the expert-sort
gather into the grouped GEMM's lhs load: every tile of rows is gathered
from the token activations inside the kernel, so no [rows, h] gathered
copy exists in device memory. It needs the per-group tile-padded row
layout (:func:`_pad_layout`: each expert's rows rounded up to whole
128-row tiles; padding rows point at token 0 with combine weight 0, exact
no-ops in both directions). On CUDA tensors it launches the kernel, on
CPU tensors it runs its plain version; it is registered as
``torch.ops.paddle_tpu_torch.gather_gmm``. :class:`_GatherGmm` is the
differentiable form: forward B9, backward B10's ``gmm`` (transposed),
the gather of x, B10's ``tgmm`` and the k-way gather into dx.

:func:`fused_moe_ffn` takes that padded pipeline (B9, then B10 ``gmm``
for the down projection) whenever :func:`gather_gmm_supported` passes —
on the CPU always, so the CPU tests run the layout the card runs — and
otherwise the unpadded one (gather, B10 ``gmm`` twice, gather combine).
The route is counted in ``fused_paths`` (the JAX package's
``moe_gmm_fused_dispatch_total{path}``): ``"padded"``, or
``"unpadded:<reason>"``. No exception is caught on either route.

Expert weights are dense tensors or int8 ``{"q": int8, "s": f32}``
leaves (``quant_matmul.quantize_grouped``; ``moe.quantize_expert_params``).
int8 gate|up weights enter B9 unconverted (its int8 branch widens them in
the kernel); their scales multiply B9's output, rounded to the model
dtype, by each row's expert, and the down projection's input scales ride
the combine-weight fold (:func:`_elementwise_core`, the JAX package's
order). The int8 down weight widens to the model dtype before B10, which
has no int8 branch. Quantized leaves are frozen: no gradient reaches
``q`` or ``s``, while x's gradient flows through the widened weights.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _build
from .moe_dispatch import (_DTYPES, _check_cuda, _check_index, _wide,
                           grouped_matmul, sort_by_expert, tile_width)
from .quant_matmul import is_quantized_weight

__all__ = ["fused_moe_ffn", "gather_gmm", "gather_gmm_plain",
           "gather_gmm_supported", "fused_paths"]

# m tile of the padded layout and of B9's blocks (the JAX kernel's _KTM)
_KTM = 128

# route of each fused_moe_ffn call: "padded" or "unpadded:<reason>"
fused_paths: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# scatter-free gathers with gather-based backward passes
# ---------------------------------------------------------------------------

def _inverse_permutation(order):
    """inv with inv[order[p]] = p."""
    return torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device,
                               dtype=order.dtype))


class _GatherRows(torch.autograd.Function):
    """``_GatherRows.apply(x, tok, inv2d)``: xs[p] = x[tok[p]], whose
    backward is the k-way gathered sum dx[t] = sum_j d_xs[inv2d[t, j]]
    (rows of xs that inv2d never names must carry zero gradients, which
    the combine-weight fold guarantees)."""

    @staticmethod
    def forward(ctx, x, tok, inv2d):
        ctx.save_for_backward(inv2d)
        return x.index_select(0, tok)

    @staticmethod
    def backward(ctx, d_xs):
        (inv2d,) = ctx.saved_tensors
        return _k_way_sum(d_xs, inv2d).to(d_xs.dtype), None, None


class _CombineRows(torch.autograd.Function):
    """``_CombineRows.apply(ys, inv2d, tok)``: y[t] = sum_j ys[inv2d[t, j]]
    in f32, the combine as a gather; backward d_ys[p] = dy[tok[p]] (padding
    rows receive token tok[p]'s gradient, harmless: their folded combine
    weight is 0)."""

    @staticmethod
    def forward(ctx, ys, inv2d, tok):
        ctx.save_for_backward(tok)
        ctx.dtype = ys.dtype
        return _k_way_sum(ys, inv2d)

    @staticmethod
    def backward(ctx, dy):
        (tok,) = ctx.saved_tensors
        return dy.index_select(0, tok).to(ctx.dtype), None, None


def _k_way_sum(rows, inv2d):
    """sum_j rows[inv2d[t, j]] over j, in f32: [T, width]."""
    T, k = inv2d.shape
    return rows.index_select(0, inv2d.reshape(-1)).reshape(
        T, k, rows.shape[1]).float().sum(1)


# ---------------------------------------------------------------------------
# expert weights
# ---------------------------------------------------------------------------

def _unpack(w):
    """(matrix, f32 scales | None): an int8 leaf's int8 matrix and scales,
    both detached (quantization never takes a gradient), or a dense
    weight as it is."""
    if is_quantized_weight(w):
        return w["q"].detach(), w["s"].detach().float()
    return w, None


def _gate_up(e_gate, e_up, dt):
    """gate|up concatenated into the one wide grouped-GEMM rhs: (Wcat
    [E, h, 2f] in ``dt`` or int8, scales [E, 2f] f32 | None)."""
    qg, sg = _unpack(e_gate)
    qu, su = _unpack(e_up)
    if (sg is None) != (su is None):
        raise ValueError("e_gate/e_up must be both quantized or neither")
    cat = torch.cat([qg, qu], -1)
    if sg is None:
        return cat.to(dt), None
    return cat, torch.cat([sg, su], -1)


def _grouped(xs, w, gs, full_rows):
    """:func:`moe_dispatch.grouped_matmul`; an int8 matrix widens to the
    rows' dtype first (exact), as the JAX package does for its B10."""
    if w.dtype == torch.int8:
        w = w.to(xs.dtype)
    return grouped_matmul(xs, w, gs, full_rows=full_rows)


# ---------------------------------------------------------------------------
# B9: the gather-fused grouped GEMM
# ---------------------------------------------------------------------------

def gather_gmm_plain(x, idx, rhs, gid, tm: int = _KTM):
    """The plain version of :func:`gather_gmm`: one f32 product for each
    run of tiles of one group, rounded to x's dtype."""
    rows = idx.shape[0]
    out = torch.empty((rows, rhs.shape[2]), dtype=x.dtype, device=x.device)
    gids = gid.tolist()
    i = 0
    while i < len(gids):
        j = i
        while j < len(gids) and gids[j] == gids[i]:
            j += 1
        lo, hi = i * tm, j * tm
        out[lo:hi] = (_wide(x.index_select(0, idx[lo:hi].long()))
                      @ _wide(rhs[gids[i]])).to(x.dtype)
        i = j
    return out


def gather_gmm(x, idx, rhs, gid, *, tm: int = _KTM):
    """B9: ``out[i*tm + r] = x[idx[i*tm + r]] @ rhs[gid[i]]`` for x [T, h],
    int32 idx [rows] (rows a multiple of tm), rhs [E, h, n] (x's dtype, or
    int8, widened inside the kernel) and int32 gid [rows / tm]: out
    [rows, n] in x's dtype with f32 sums. Each tm-row tile belongs to one
    group, which the caller's tile-padded layout guarantees."""
    rows = idx.shape[0]
    T, h = x.shape
    E, h2, n = rhs.shape
    if h2 != h or rows % tm or gid.shape != (rows // tm,):
        raise ValueError(f"gather_gmm: x {tuple(x.shape)}, idx {rows} rows, "
                         f"rhs {tuple(rhs.shape)}, gid {tuple(gid.shape)}, "
                         f"tm {tm} do not match")
    rhs_int8 = rhs.dtype == torch.int8
    if x.device.type == "cpu":
        return gather_gmm_plain(x, idx, rhs, gid, tm)
    if x.device.type != "cuda":
        raise ValueError(f"gather_gmm: unsupported device {x.device}")
    if rhs_int8:
        _check_cuda("gather_gmm", (x,), (h, n))
        _check_cuda("gather_gmm", (rhs,), (n,), int8=True)
    else:
        _check_cuda("gather_gmm", (x, rhs), (h, n))
    _check_index("gather_gmm", idx, x.device, rows)
    _check_index("gather_gmm", gid, x.device, rows // tm)
    if tm % 128:
        raise ValueError(f"gather_gmm: tm {tm} must be a multiple of the "
                         "kernel's 128-row tile")
    fn = _build.kernel("ptt_gather_gmm", [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out               # an empty grid is no launch
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(idx), _build.ptr(rhs),
                 _build.ptr(gid), _build.ptr(out), rows, h, n, E, tm,
                 _DTYPES[x.dtype], int(rhs_int8), tile_width(n),
                 _build.stream_handle(x))
    name = "gather_gmm_int8" if rhs_int8 else "gather_gmm"
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return out


@torch.library.custom_op("paddle_tpu_torch::gather_gmm", mutates_args=())
def gather_gmm_op(x: torch.Tensor, idx: torch.Tensor, rhs: torch.Tensor,
                  gid: torch.Tensor, tm: int) -> torch.Tensor:
    """:func:`gather_gmm` as a registered operator
    (``torch.ops.paddle_tpu_torch.gather_gmm``)."""
    return gather_gmm(x, idx, rhs, gid, tm=tm)


def gather_gmm_supported(x, rhs, num_rows: int) -> Optional[str]:
    """None when the padded pipeline runs B9 for these operands (always on
    the CPU, where the plain versions take any shape), else the reason it
    cannot: "dtype" (x not bf16 or f32, or rhs neither x's dtype nor
    int8), "width" (h or the gate|up width not a multiple of 8, of 16 for
    an int8 rhs) or "rows" (fewer assignments than one tile: the padded
    layout would be mostly padding, the JAX package's own screen)."""
    if x.device.type == "cpu":
        return None
    if x.dtype not in _DTYPES or rhs.dtype not in (x.dtype, torch.int8):
        return "dtype"
    if x.shape[1] % 8 or rhs.shape[-1] % (16 if rhs.dtype == torch.int8
                                          else 8):
        return "width"
    if num_rows < _KTM:
        return "rows"
    return None


def _tile_gids(gs_pad, A_pad: int, tm: int):
    """Group id of each tm-row tile of the padded layout (every tile lies
    inside one group by construction; tail tiles clamp to the last)."""
    starts = torch.arange(A_pad // tm, device=gs_pad.device) * tm
    gid = torch.searchsorted(torch.cumsum(gs_pad.long(), 0), starts,
                             right=True)
    return gid.clamp(max=gs_pad.shape[0] - 1).to(torch.int32)


class _GatherGmm(torch.autograd.Function):
    """``_GatherGmm.apply(x, tok_pad, inv2d, rhs, gs_pad)``: forward B9
    over the padded layout; backward B10's dgrad ``gmm(transpose_rhs)``,
    the gather of x's rows, B10's ``tgmm`` and the k-way gather into dx
    (padding rows carry zero gradients: see the combine-weight fold)."""

    @staticmethod
    def forward(ctx, x, tok_pad, inv2d, rhs, gs_pad):
        gid = _tile_gids(gs_pad, tok_pad.shape[0], _KTM)
        ctx.save_for_backward(x, tok_pad, inv2d, rhs, gs_pad)
        return gather_gmm_op(x, tok_pad, rhs, gid, _KTM)

    @staticmethod
    def backward(ctx, g):
        x, tok_pad, inv2d, rhs, gs_pad = ctx.saved_tensors
        from .moe_dispatch import gmm, tgmm

        g = g.contiguous()
        # int8 experts are frozen: the dgrad runs on the widened weight
        # and they get no gradient
        w = rhs.to(x.dtype) if rhs.dtype == torch.int8 else rhs
        d_xs = gmm(g, w, gs_pad, transpose_rhs=True)
        d_rhs = None
        if ctx.needs_input_grad[3]:
            xs = x.index_select(0, tok_pad)
            d_rhs = tgmm(xs.t(), g, gs_pad, out_dtype=rhs.dtype)
        dx = _k_way_sum(d_xs, inv2d).to(x.dtype)
        return dx, None, None, d_rhs, None


# ---------------------------------------------------------------------------
# the fused routed FFN
# ---------------------------------------------------------------------------

def _routing_meta(idx, routing):
    """(order, tok, flat_e, gs | None) from ``routing`` or a fresh sort."""
    if routing is None:
        return (*sort_by_expert(idx), None)
    return routing.order, routing.tok, routing.flat_e, routing.gs


def _elementwise_core(gu, ws, f: int, dt, *, s_gu=None, s_down=None,
                      esorted=None):
    """silu(g) * u with every per-row coefficient folded in, in the JAX
    package's order: int8 gate|up scales ``s_gu`` multiply the grouped
    GEMM's rounded output by each row's expert (``esorted``), then the
    combine weight ``ws``, then the int8 down projection's input scales
    ``s_down``."""
    if s_gu is not None:
        gu = gu * s_gu.index_select(0, esorted).to(gu.dtype)
    z = torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]
    zw = z * ws.to(dt)[:, None]
    if s_down is not None:
        zw = zw * s_down.index_select(0, esorted).to(dt)
    return zw


def _pad_layout(gs, tok, ws, esorted, inv2d, E: int, tm: int = _KTM):
    """The per-group tile-padded row layout of B9: each expert's segment
    rounded up to whole tm-row tiles, so every tile lies inside one group.
    Padding rows point at token 0 with combine weight 0. Returns (tok_pad
    int32, ws_pad f32 (differentiable in ws), es_pad, inv_pad2d, gs_pad
    int32); the padded row count is the static bound
    ``roundup(A + E*(tm-1), tm)``."""
    T, k = inv2d.shape
    A = T * k
    A_pad = -(-(A + E * (tm - 1)) // tm) * tm
    dev = tok.device
    gs = gs.long()
    gs_pad = -(-gs // tm) * tm
    pad_off = torch.cumsum(gs_pad, 0) - gs_pad
    g_start = torch.cumsum(gs, 0) - gs
    pos_pad = (pad_off[esorted] + torch.arange(A, device=dev)
               - g_start[esorted])
    tok_pad = torch.zeros(A_pad, dtype=torch.int32, device=dev).index_put_(
        (pos_pad,), tok.to(torch.int32))
    ws_pad = torch.zeros(A_pad, dtype=torch.float32, device=dev).index_put(
        (pos_pad,), ws)
    es_pad = torch.zeros(A_pad, dtype=esorted.dtype, device=dev).index_put_(
        (pos_pad,), esorted)
    inv_pad2d = pos_pad[inv2d.reshape(-1)].reshape(T, k)
    return tok_pad, ws_pad, es_pad, inv_pad2d, gs_pad.to(torch.int32)


def _fused_padded(x, ws, tok, esorted, gs, inv2d, Wcat, Wd, E, f, dt, *,
                  s_gu=None, s_down=None):
    """The kernel pipeline over the tile-padded layout: B9 for gate|up,
    the elementwise core (with the int8 scales ``s_gu``/``s_down``), B10
    ``gmm`` for the down projection, the gather combine. Returns y [T, h]
    f32."""
    tok_pad, ws_pad, es_pad, inv_pad2d, gs_pad = _pad_layout(
        gs, tok, ws, esorted, inv2d, E)
    gu = _GatherGmm.apply(x, tok_pad, inv_pad2d, Wcat, gs_pad)
    zw = _elementwise_core(gu, ws_pad, f, dt, s_gu=s_gu, s_down=s_down,
                           esorted=es_pad)
    ys = _grouped(zw, Wd, gs_pad, full_rows=False)
    return _CombineRows.apply(ys, inv_pad2d, tok_pad)


def _fused_unpadded(x, ws, tok, gs, inv2d, Wcat, Wd, f, dt, *, s_gu=None,
                    s_down=None, esorted=None):
    """The same FFN over the unpadded expert-sorted rows (``esorted`` their
    experts, for the int8 scales): the gather, B10 ``gmm`` for gate|up
    and for down, the gather combine. Returns y [T, h] f32."""
    xs = _GatherRows.apply(x, tok, inv2d)
    gu = _grouped(xs, Wcat, gs, full_rows=True)
    zw = _elementwise_core(gu, ws, f, dt, s_gu=s_gu, s_down=s_down,
                           esorted=esorted)
    ys = _grouped(zw, Wd, gs, full_rows=True)
    return _CombineRows.apply(ys, inv2d, tok)


def fused_moe_ffn(x, weights, idx, e_gate, e_up, e_down, routing=None):
    """Capacity-less routed FFN, the fused scatter-free form (single
    device): the same grouped GEMMs over the same expert-sorted rows as
    :func:`moe_dispatch.dropless_moe_ffn`, with the combine weights folded
    into the elementwise chain before the down GEMM and gathers for the
    dispatch and the combine in both directions. x [T, h]; weights/idx
    [T, k]; experts [E, h, f] / [E, f, h], dense or int8 leaves (module
    docstring). Returns y [T, h] in x's dtype."""
    T, h = x.shape
    k = idx.shape[1]
    A = T * k
    dt = x.dtype
    qg, _ = _unpack(e_gate)
    E, f = qg.shape[0], qg.shape[-1]
    order, tok, flat_e, gs = _routing_meta(idx, routing)
    if gs is None:
        gs = torch.bincount(flat_e, minlength=E).to(torch.int32)
    esorted = flat_e[order]
    inv2d = _inverse_permutation(order).reshape(T, k)
    ws = weights.reshape(A)[order].float()
    Wcat, s_gu = _gate_up(e_gate, e_up, dt)
    Wd, s_down = _unpack(e_down)
    if s_down is None:
        Wd = Wd.to(dt)
    reason = gather_gmm_supported(x, Wcat, A)
    if reason is None:
        fused_paths["padded"] += 1
        y = _fused_padded(x, ws, tok, esorted, gs, inv2d, Wcat, Wd, E, f,
                          dt, s_gu=s_gu, s_down=s_down)
    else:
        fused_paths[f"unpadded:{reason}"] += 1
        y = _fused_unpadded(x, ws, tok, gs, inv2d, Wcat, Wd, f, dt,
                            s_gu=s_gu, s_down=s_down, esorted=esorted)
    return y.to(dt)
