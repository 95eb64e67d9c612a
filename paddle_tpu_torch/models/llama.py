"""Llama model family — the port of paddle_tpu/models/llama (forward path).

Parameters are a plain dictionary of tensors under the JAX package's keys
and layouts: ``embed`` [vocab, h]; stacked per-layer weights under
``layers`` with a leading [L] axis (``attn_norm``, ``wq``, ``wk``,
``wv``, ``wo``, ``mlp_norm``, ``w_gate``, ``w_up``, ``w_down``) in the
``[in, out]`` layout, so both packages compute ``x @ w``; ``final_norm``
and ``lm_head`` [h, vocab]. :func:`params_from_numpy` carries a JAX
parameter tree over through numpy.

Attention runs through ``kernels.pallas_attention.flash_attention_fwd``:
the CUDA kernel on CUDA tensors, its plain version on CPU tensors.

Training (loss, train step, remat, pipeline and sharding recipes) is not
ported yet (ROADMAP queue A3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.pallas_attention import flash_attention_fwd

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "init_params",
           "params_from_numpy", "num_params", "hidden_states", "forward"]

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    # compute dtype of the forward pass
    dtype: Any = torch.bfloat16


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def tiny_llama(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
               seq=128, ffn=128) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn,
        num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
        head_dim=hidden // heads, max_seq_len=seq)


def _shapes(c: LlamaConfig):
    h, f, L = c.hidden_size, c.intermediate_size, c.num_layers
    nq, nkv, d = c.num_heads, c.num_kv_heads, c.head_dim
    s = 1.0 / math.sqrt(h)
    layers = {
        "attn_norm": ((L, h), None),
        "wq": ((L, h, nq * d), s),
        "wk": ((L, h, nkv * d), s),
        "wv": ((L, h, nkv * d), s),
        "wo": ((L, nq * d, h), s / math.sqrt(2 * L)),
        "mlp_norm": ((L, h), None),
        "w_gate": ((L, h, f), s),
        "w_up": ((L, h, f), s),
        "w_down": ((L, f, h), 1.0 / math.sqrt(f) / math.sqrt(2 * L)),
    }
    top = {"embed": ((c.vocab_size, h), s), "final_norm": ((h,), None),
           "lm_head": ((h, c.vocab_size), s)}
    return top, layers


def init_params(config: LlamaConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and scales (norms
    are ones, matrices scaled normals), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``. ``dtype`` defaults to f32 masters;
    serving passes bf16 to hold the weights at compute precision. The
    JAX and torch generators differ, so the values do not match the
    reference's ``init_params`` — weights move between the packages with
    :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    top, layers = _shapes(config)

    def make(shape, scale):
        if scale is None:
            return torch.ones(shape, dtype=dtype, device=dev)
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=dev).mul_(scale)

    params = {k: make(*v) for k, v in top.items()}
    params["layers"] = {k: make(*v) for k, v in layers.items()}
    return params


def params_from_numpy(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """The JAX parameter tree, as numpy arrays (``embed``, stacked
    ``layers.*`` [L, ...], ``final_norm``, ``lm_head``), as torch tensors
    under the same keys and layouts on ``device``; ``dtype`` None keeps
    each array's own dtype."""
    dev = resolve_device(device)

    def conv(a):
        a = np.array(a)                  # a writable host copy
        if a.dtype.name == "bfloat16":   # torch reads no numpy bf16: widen
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=dev, dtype=dtype or t.dtype)

    missing = ({"embed", "layers", "final_norm", "lm_head"} - set(tree)) \
        | {"layers." + k for k in LAYER_KEYS
           if k not in tree.get("layers", {})}
    if missing:
        raise KeyError(f"parameter tree lacks {sorted(missing)}")
    out = {k: conv(tree[k]) for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = {k: conv(tree["layers"][k]) for k in LAYER_KEYS}
    return out


def num_params(params) -> int:
    return sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rms_norm(x, w, eps):
    # f32 statistics whatever the compute dtype, cast back, then scale
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rope_tables(seq_len: int, head_dim: int, theta: float, device=None):
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freq = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)
    ang = pos[:, None] * freq[None, :]               # [S, D/2]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, c, s):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [S, D/2] f32, cast to x's dtype before the
    multiply (rotate-half convention)."""
    return _rotate(x, cos[None, :, None, :].to(x.dtype),
                   sin[None, :, None, :].to(x.dtype))


def _apply_rope_at(x, cos, sin):
    """Rotate-half RoPE with per-row positions: cos/sin are [B, S, D/2]."""
    return _rotate(x, cos[:, :, None, :].to(x.dtype),
                   sin[:, :, None, :].to(x.dtype))


def _attention(q, k, v, config: LlamaConfig):
    """Causal GQA attention in the [B, S, H, D] layout: the flash kernel on
    CUDA tensors, its plain version on CPU tensors."""
    return flash_attention_fwd(q, k, v, causal=True)[0]


def _layer_body(x, p, cos, sin, config: LlamaConfig):
    c = config
    B, S, _ = x.shape
    dt = c.dtype
    hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
    q = (hn @ p["wq"].to(dt)).reshape(B, S, c.num_heads, c.head_dim)
    k = (hn @ p["wk"].to(dt)).reshape(B, S, c.num_kv_heads, c.head_dim)
    v = (hn @ p["wv"].to(dt)).reshape(B, S, c.num_kv_heads, c.head_dim)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    att = _attention(q, k, v, c).reshape(B, S, c.num_heads * c.head_dim)
    x = x + att @ p["wo"].to(dt)
    hn = _rms_norm(x, p["mlp_norm"], c.rms_eps)
    gate = torch.nn.functional.silu(hn @ p["w_gate"].to(dt))
    up = hn @ p["w_up"].to(dt)
    return x + (gate * up) @ p["w_down"].to(dt)


def hidden_states(params, tokens, config: LlamaConfig):
    """tokens [B, S] int -> final-norm hidden states [B, S, h] (model
    dtype)."""
    c = config
    S = tokens.shape[1]
    x = params["embed"].to(c.dtype)[tokens.long()]
    cos, sin = _rope_tables(S, c.head_dim, c.rope_theta, tokens.device)
    for l in range(c.num_layers):
        p = {k: params["layers"][k][l] for k in LAYER_KEYS}
        x = _layer_body(x, p, cos, sin, c)
    return _rms_norm(x, params["final_norm"], c.rms_eps)


def forward(params, tokens, config: LlamaConfig):
    """tokens [B, S] int -> logits [B, S, vocab] (f32)."""
    x = hidden_states(params, tokens, config)
    return (x @ params["lm_head"].to(config.dtype)).float()
