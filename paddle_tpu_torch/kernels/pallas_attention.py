"""FlashAttention-2, forward and backward — the port of
paddle_tpu/kernels/pallas_attention.

The functions keep the JAX package's ``[batch, seq, heads, head_dim]``
layout at their boundary and support GQA (k/v may carry fewer heads; query
head h reads kv head ``h // (Hq // Hkv)``). On CUDA tensors they launch
hand-written kernels (bf16 or f32, head_dim 64 or 128, any sequence
length); on CPU tensors they run their plain PyTorch versions:

- :func:`flash_attention_fwd` — ``csrc/flash_fwd.cu`` (B1): the output and
  the f32 log-sum-exp of each query row;
- :func:`flash_dq` — ``csrc/flash_dq.cu`` (B2) and :func:`flash_dkv` —
  ``csrc/flash_dkv.cu`` (B3, dK and dV summed over each kv head's group
  of query heads), from the forward's log-sum-exp and Delta =
  rowsum(O * dO); :func:`flash_attention_bwd` runs both from the
  forward's output, and on the card B2 computes Delta as it goes;
- :class:`flash_attention` — the differentiable function made of the two,
  the counterpart of the JAX package's ``_flash`` custom_vjp.

The plain versions compute in f32 (f64 for f64 inputs, which
``torch.autograd.gradcheck`` uses) and round where the kernels round.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _wide(x):
    """``x`` in the plain versions' working type: f32, or f64 for f64."""
    return x if x.dtype == torch.float64 else x.float()


def flash_attention_fwd_plain(q, k, v, causal: bool = False):
    """The plain PyTorch version: scores in f32; the unnormalized
    probabilities exp(s - rowmax) rounded to the value dtype before the PV
    product and the sum divided out after it (the kernels' rounding).
    Returns (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S] f32)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = _wide(q).transpose(1, 2)                           # [B, H, S, D]
    kf = _wide(k).repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                         # [B, H, S, 1]
    out = (_wide(p.to(v.dtype)) @ _wide(vf)) / l
    lse = (m + torch.log(l))[..., 0]                        # [B, H, S]
    return out.transpose(1, 2).to(q.dtype), lse


def _delta(out, dout):
    """Delta = rowsum(O * dO) in f32, [B, Hq, S] (the JAX ``_bwd`` computes
    it outside its kernels too)."""
    return (_wide(out) * _wide(dout)).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, dout, lse, delta, causal):
    """The backward's recomputed probabilities P = exp(s - lse) and
    dS = P (dO V^T - Delta) scale, [B, Hq, S, S], with the operands in the
    working type ([B, H, S, D], k repeated over its group)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = _wide(q).transpose(1, 2)
    kf = _wide(k).repeat_interleave(G, dim=2).transpose(1, 2)
    vf = _wide(v).repeat_interleave(G, dim=2).transpose(1, 2)
    dof = _wide(dout).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    return qf, kf, dof, p, ds


def flash_dq_plain(q, k, v, dout, lse, delta, causal: bool = False):
    """The plain version of B2: dQ = round(dS) K, dS rounded to k's dtype
    as the kernels round it. Returns dq [B, S, Hq, D] in q's dtype."""
    _, kf, _, _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    return (_wide(ds.to(k.dtype)) @ kf).transpose(1, 2).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, causal: bool = False):
    """The plain version of B3: dV = round(P)^T dO and dK = round(dS)^T Q
    (P rounded to dout's dtype, dS to q's), summed over each kv head's
    group of query heads. Returns (dk, dv) [B, S, Hkv, D]."""
    qf, _, dof, p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    B, S, Hkv, D = k.shape
    G = q.shape[2] // Hkv

    def fold(x):                     # [B, Hq, S, D] -> [B, S, Hkv, D]
        return x.reshape(B, Hkv, G, S, D).sum(2).transpose(1, 2)

    dv = _wide(p.to(dout.dtype)).transpose(-1, -2) @ dof
    dk = _wide(ds.to(q.dtype)).transpose(-1, -2) @ qf
    return fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = False):
    """The plain version of :func:`flash_attention_bwd`."""
    delta = _delta(out, dout)
    dk, dv = flash_dkv_plain(q, k, v, dout, lse, delta, causal)
    return flash_dq_plain(q, k, v, dout, lse, delta, causal), dk, dv


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,Hq,D] and k/v [B,S,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")


def _check_cuda(name, tensors, D):
    """What the CUDA kernels take: one dtype of bf16 or f32, head_dim 64
    or 128, contiguous 16-byte-aligned tensors (B1's bf16 form reads them
    by TMA)."""
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name} takes bf16 or f32 tensors of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    if D not in (64, 128):
        raise ValueError(f"{name}: head_dim {D} not in (64, 128)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name} needs contiguous 16-byte-aligned inputs")


def flash_attention_fwd(q, k, v, causal: bool = False):
    """q: [B, S, Hq, D]; k/v: [B, S, Hkv, D] with Hq a multiple of Hkv.
    Returns (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S] f32)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    B, S, H, D = q.shape
    _check_cuda("flash_attention_fwd", (q, k, v), D)
    fn = _build.kernel("ptt_flash_fwd", [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse          # an empty grid is no launch
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                 _build.ptr(lse), B, S, H, k.shape[2], D, _DTYPES[q.dtype],
                 int(causal), 1.0 / math.sqrt(D), _build.stream_handle(q))
    _build.check(err, "flash_fwd")
    _build.launch_counts["flash_fwd"] += 1
    return out, lse


def _check_bwd(name, q, k, v, dout, lse, delta):
    """The backward kernels' inputs; for CUDA tensors, also what the
    kernels take. Returns True when the plain version is to run (CPU)."""
    _check(q, k, v)
    B, S, H, D = q.shape
    if dout.shape != q.shape or tuple(lse.shape) != (B, H, S) \
            or tuple(delta.shape) != (B, H, S):
        raise ValueError(f"{name}: dout must be {tuple(q.shape)} and "
                         f"lse/delta {(B, H, S)}, got {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)}")
    if not (dout.device == lse.device == delta.device == q.device):
        raise ValueError(f"{name}: dout/lse/delta must lie on q's device")
    if dout.dtype != q.dtype:
        raise TypeError(f"{name}: dout must share q's dtype {q.dtype}, "
                        f"got {dout.dtype}")
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_cuda(name, (q, k, v, dout), D)
    if not all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (lse, delta)):
        raise TypeError(f"{name}: lse/delta must be contiguous f32, got "
                        f"{lse.dtype}, {delta.dtype}")
    if not all(t.data_ptr() % 16 == 0 for t in (lse, delta)):
        raise ValueError(f"{name}: lse/delta must be 16-byte-aligned (B3 "
                         f"reads them by TMA)")
    return False


def _bwd_args(q, k, dout, lse, delta, causal):
    B, S, H, D = q.shape
    return ((_build.ptr(dout), _build.ptr(lse), _build.ptr(delta)),
            (B, S, H, k.shape[2], D, _DTYPES[q.dtype], int(causal),
             1.0 / math.sqrt(D), _build.stream_handle(q)))


def flash_dq(q, k, v, dout, lse, delta, causal: bool = False, out=None):
    """B2: dq [B, S, Hq, D] from q [B, S, Hq, D], k/v [B, S, Hkv, D], the
    output gradient ``dout``, the forward's ``lse`` and
    ``delta = rowsum(out * dout)`` (both [B, Hq, S] f32). Given the
    forward's ``out``, B2 computes Delta itself and writes it into
    ``delta``, a [B, Hq, S] f32 buffer (on the CPU: ``_delta``'s value)."""
    plain = _check_bwd("flash_dq", q, k, v, dout, lse, delta)
    if out is not None:
        if out.shape != q.shape or out.device != q.device:
            raise ValueError(f"flash_dq: out must be {tuple(q.shape)} on "
                             f"{q.device}, got {tuple(out.shape)} on "
                             f"{out.device}")
        if out.dtype != q.dtype:
            raise TypeError(f"flash_dq: out must share q's dtype {q.dtype}, "
                            f"got {out.dtype}")
        if plain:
            delta.copy_(_delta(out, dout))
        else:
            _check_cuda("flash_dq", (out,), q.shape[3])
    if plain:
        return flash_dq_plain(q, k, v, dout, lse, delta, causal)
    fn = _build.kernel("ptt_flash_dq", [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq                # an empty grid is no launch
    ptrs, args = _bwd_args(q, k, dout, lse, delta, causal)
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), ptrs[0],
                 None if out is None else _build.ptr(out), *ptrs[1:],
                 _build.ptr(dq), *args)
    _build.check(err, "flash_dq")
    _build.launch_counts["flash_dq"] += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, causal: bool = False):
    """B3: (dk, dv) [B, S, Hkv, D], each summed over its kv head's group
    of query heads; the inputs as :func:`flash_dq`'s."""
    if _check_bwd("flash_dkv", q, k, v, dout, lse, delta):
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal)
    fn = _build.kernel("ptt_flash_dkv", [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv            # an empty grid is no launch
    ptrs, args = _bwd_args(q, k, dout, lse, delta, causal)
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), *ptrs,
                 _build.ptr(dk), _build.ptr(dv), *args)
    _build.check(err, "flash_dkv")
    _build.launch_counts["flash_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = False):
    """The gradients of :func:`flash_attention_fwd`'s output: q [B, S, Hq,
    D], k/v [B, S, Hkv, D], its ``out`` and ``lse``, and ``dout`` (the
    gradient of ``out``). Returns (dq, dk, dv) in the inputs' dtypes;
    dk/dv sum over each kv head's group of query heads. B2 runs first and
    computes Delta = rowsum(out * dout) into a buffer that B3 then reads
    (on the CPU, ``_delta``'s torch reduction, as in the JAX ``_bwd``)."""
    if not (out.shape == dout.shape == q.shape
            and out.device == dout.device == q.device):
        raise ValueError(f"out/dout must be {tuple(q.shape)} on {q.device}, "
                         f"got {tuple(out.shape)}, {tuple(dout.shape)} on "
                         f"{out.device}, {dout.device}")
    if out.dtype != q.dtype:
        raise TypeError(f"out must share q's dtype {q.dtype}, got "
                        f"{out.dtype}")
    delta = torch.empty_like(lse)        # [B, Hq, S] f32, written by B2
    dq = flash_dq(q, k, v, dout, lse, delta, causal, out=out)
    dk, dv = flash_dkv(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as a registered operator
    (``torch.ops.paddle_tpu_torch.flash_fwd``), which a selective
    checkpoint policy can name to keep its outputs (the model's
    ``remat_policy="attn"``)."""
    return flash_attention_fwd(q, k, v, causal)


class flash_attention(torch.autograd.Function):   # noqa: N801 (JAX's name)
    """Differentiable causal or full GQA attention:
    ``flash_attention.apply(q, k, v, causal)`` -> out [B, S, Hq, D]. The
    forward is :func:`flash_attention_fwd` (B1, through
    :func:`flash_fwd_op`), which saves q, k, v, out and lse; the backward
    is :func:`flash_attention_bwd` (B2, B3)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd_op(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None
