"""int8 weight-only matmuls and the int8 KV-pool quantization helpers —
the port of paddle_tpu/kernels/quant_matmul.

Layouts, as in the JAX package:

- a weight-only leaf is ``{"q": int8 [..., K, N], "s": [..., N]}``, one
  scale per output channel (``models.llama.quantize_params``, scales in
  bf16) or per expert and channel (:func:`quantize_grouped`, f32);
- an int8 KV pool entry (token, kv head) is D int8 values and one f32
  scale (:func:`quantize_kv`), absmax over the head dimension.

:func:`weight_only_matmul` computes ``x @ q`` with f32 sums, multiplies
the f32 result by the per-output-channel scale, and rounds once to
``out_dtype``. It runs as plain torch ops (it is a mixed dot outside any
Pallas kernel in the JAX package): the int8 matrix widens to f32 and the
product runs in f32. With bf16 activations on the card the product runs
on the TF32 tensor cores: bf16 values and int8 values are both exact in
TF32, so every product is exact and the sums stay in f32 — the full-f32
result up to the order of the sums, at the tensor cores' rate. A W8A16
GEMM kernel that reads the int8 matrix unconverted is a later queue item.

:func:`attn_qk` and :func:`attn_pv` are the decode attention
contractions over gathered int8 prefixes, with the per-entry K scale on
the f32 scores and the V scale folded into the probabilities.
"""
from __future__ import annotations

import torch

__all__ = [
    "weight_only_matmul", "quantize_kv", "dequantize_kv",
    "attn_qk", "attn_pv", "mixed_dot_supported",
    "quantize_grouped", "dequantize_grouped", "is_quantized_weight",
    "dequantize_channels",
]

# elements quantized at once: larger leaves go in leading-axis slices, so
# the f32 temporaries of a stacked [L, ...] leaf stay small (the scales
# reduce over another axis, so the slices give the same result)
_SLICE_ELEMS = 1 << 28


def dequantize_channels(q, scale, axis: int):
    """f32 reconstruction of a per-channel int8 tensor: ``q *
    unsqueeze(scale, axis)`` where ``axis`` is the dim the scale was
    reduced over — the inverse of :func:`quantize_grouped` (``axis``),
    :func:`quantize_kv` (``axis=-1``) and ``llama.quantize_params``
    (``axis=-2``)."""
    return q.float() * scale.float().unsqueeze(axis)


def mixed_dot_supported() -> bool:
    """True: torch contracts an int8 matrix against bf16 or f32
    activations through :func:`weight_only_matmul`'s widening. The JAX
    package probes this because older jax releases reject mixed-dtype
    dots; torch has no such case."""
    return True


def is_quantized_weight(w) -> bool:
    """True for an int8 weight-only leaf ``{"q": int8, "s": scales}``."""
    return isinstance(w, dict) and "q" in w


def _slices(w, axis: int):
    """Leading-axis slices of ``w`` of at most ``_SLICE_ELEMS`` elements
    (the whole tensor when ``axis`` is 0 or it is small)."""
    ax = axis % w.dim()
    if ax == 0 or w.numel() <= _SLICE_ELEMS:
        return [w]
    per = max(1, _SLICE_ELEMS // max(1, w[0].numel()))
    return list(w.split(per, 0))


def quantize_grouped(w, axis: int):
    """Symmetric per-channel int8 of stacked per-expert weights ``w``
    [E, ...]; ``axis`` is the axis the scale is shared over (reduced by
    absmax): gate/up [E, h, f] with ``axis=1`` give ``s`` [E, f] (scales of
    the GEMM output), down [E, f, h] with ``axis=2`` give ``s`` [E, f]
    (scales of the GEMM input). Returns ``{"q": int8 (w.shape), "s": f32
    (w.shape without axis)}``, values clipped to +-127."""
    qs, ss = [], []
    for part in _slices(w, axis):
        wf = part.float()
        scale = (wf.abs().amax(dim=axis) / 127.0).clamp_min(1e-12)
        q = torch.round(wf / scale.unsqueeze(axis))
        qs.append(q.clamp(-127, 127).to(torch.int8))
        ss.append(scale)
        del wf, q
    if len(qs) == 1:
        return {"q": qs[0], "s": ss[0]}
    return {"q": torch.cat(qs, 0), "s": torch.cat(ss, 0)}


def dequantize_grouped(w, axis: int, dtype):
    """The dense weights of a :func:`quantize_grouped` leaf in ``dtype``."""
    return dequantize_channels(w["q"], w["s"], axis).to(dtype)


def _int8_product(x, q):
    """``x @ q`` for an int8 matrix q [K, N], summed in f32 (module
    docstring: TF32 tensor cores for bf16 x on the card, where every
    product is exact)."""
    xf, qf = x.float(), q.float()
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        return xf @ qf
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return xf @ qf
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def weight_only_matmul(x, w, out_dtype):
    """``x @ w`` for a dense [K, N] weight (``x @ w.to(out_dtype)``) or an
    int8 weight-only leaf ``{"q": int8 [K, N], "s": [N]}``: f32 sums over
    the int8 matrix, times the per-output-channel scale in f32, rounded
    once to ``out_dtype``. ``q`` may come already widened to f32 (a caller
    that reuses one matrix for many products widens it once)."""
    if not is_quantized_weight(w):
        return x @ w.to(out_dtype)
    y = _int8_product(x, w["q"])
    return (y * w["s"].float()).to(out_dtype)


# ---------------------------------------------------------------------------
# int8 KV pools: symmetric per-entry absmax over the head dim
# ---------------------------------------------------------------------------

def quantize_kv(x):
    """[..., D] K/V values -> (int8 [..., D], f32 scale [...]): one scale
    per pool entry (token, kv head), values clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp_min(1e-9)[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return dequantize_channels(q, scale, -1).to(dtype)


# ---------------------------------------------------------------------------
# GQA decode attention contractions over (possibly int8) gathered prefixes
#   qg: [N, Hkv, G, D]; kd/vd: [N, P, Hkv, D]; ks/vs: [N, P, Hkv] f32
# ---------------------------------------------------------------------------

def attn_qk(qg, kd, ks=None):
    """QK^T scores [N, Hkv, G, P] in f32. The per-entry K scale multiplies
    the f32 score (it is constant over the contracted D axis)."""
    s = torch.einsum("nhgd,nphd->nhgp", qg.float(), kd.float())
    if ks is not None:
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    return s


def attn_pv(p, vd, vs=None, *, out_dtype):
    """probs [N, Hkv, G, P] (f32) @ V -> [N, Hkv, G, D] in ``out_dtype``.
    The V scale varies along the contracted P axis, so it folds into the
    probabilities; dense pools round the probabilities to ``out_dtype``
    first, as the JAX package's bf16 einsum does."""
    if vs is not None:
        p = p * vs.float().permute(0, 2, 1)[:, :, None, :]
        out = torch.einsum("nhgp,nphd->nhgd", p, vd.float())
        return out.to(out_dtype)
    out = torch.einsum("nhgp,nphd->nhgd", p.to(out_dtype).float(),
                       vd.float())
    return out.to(out_dtype)
