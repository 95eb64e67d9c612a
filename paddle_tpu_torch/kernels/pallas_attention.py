"""FlashAttention-2 forward — the port of paddle_tpu/kernels/pallas_attention.

``flash_attention_fwd`` keeps the JAX package's ``[batch, seq, heads,
head_dim]`` layout at its boundary and supports GQA (k/v may carry fewer
heads; query head h reads kv head ``h // (Hq // Hkv)``). On a CUDA tensor
it launches the hand-written kernel ``csrc/flash_fwd.cu`` (bf16 or f32,
head_dim 64 or 128, any sequence length); on a CPU tensor it runs the
plain PyTorch version :func:`flash_attention_fwd_plain`. It returns the
output and the f32 log-sum-exp of each query row.

The backward kernels (``_dq_kernel``/``_dkv_kernel``) belong to the
training slice and are not ported yet (ROADMAP queue B).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q, k, v, causal: bool = False):
    """The plain PyTorch version: scores in f32; the unnormalized
    probabilities exp(s - rowmax) rounded to the value dtype before the PV
    product and the sum divided out after it (the kernels' rounding).
    Returns (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S] f32)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)                          # [B, H, S, D]
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(G, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                         # [B, H, S, 1]
    out = (p.to(v.dtype).float() @ vf.float()) / l
    lse = (m + torch.log(l))[..., 0]                        # [B, H, S]
    return out.transpose(1, 2).to(q.dtype), lse


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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes bf16 or f32 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention_fwd: head_dim {D} not in (64, 128)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous q/k/v")
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
