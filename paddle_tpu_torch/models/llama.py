"""Llama model family — the port of paddle_tpu/models/llama (forward,
loss and the single-device train step).

Parameters are a plain dictionary of tensors under the JAX package's keys
and layouts: ``embed`` [vocab, h]; stacked per-layer weights under
``layers`` with a leading [L] axis (``attn_norm``, ``wq``, ``wk``,
``wv``, ``wo``, ``mlp_norm``, ``w_gate``, ``w_up``, ``w_down``) in the
``[in, out]`` layout, so both packages compute ``x @ w``; ``final_norm``
and, unless ``tie_embeddings`` (then ``embed.T`` is the head),
``lm_head`` [h, vocab]. :func:`params_from_numpy` carries a JAX parameter
tree over through numpy. :func:`quantize_params` makes the serving
path's int8 weight-only tree (``{"q": int8, "s": bf16}`` leaves for the
seven matrices and the head), which the serving engine and the mega
decode kernel consume.

Attention runs through ``kernels.pallas_attention.flash_attention``: the
CUDA kernels (B1 forward, B2/B3 backward) on CUDA tensors, their plain
versions on CPU tensors, whatever ``use_flash`` says — the kernels take
every sequence length, so ``use_flash`` only moves where bf16
probabilities are rounded (the JAX package's non-flash path rounds the
normalized probabilities, the flash path the unnormalized ones).

Inference: :func:`init_kv_cache` and :func:`forward_with_cache`, the
fixed-batch cache forward (``logits_all`` scores every position of a
piece, the verify primitive of speculative decoding);
:func:`draft_config` shrinks a config into a draft model's.

Training: :func:`loss_fn` (optionally chunked cross-entropy),
:func:`loss_and_grads`, :func:`train_step` with a global-norm clip,
gradient accumulation and the optimizers of ``optimizer/functional.py``;
``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``; selective for the "dots" and "attn"
policies). Context parallelism and pipeline schedules raise
``NotImplementedError`` (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..kernels.pallas_attention import flash_attention
from ..kernels.quant_matmul import _slices, is_quantized_weight
from ..kernels.quant_matmul import weight_only_matmul as _wo_mm
from ..optimizer.functional import (init_moments, optimizer_update,
                                    tree_leaves, tree_map)

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "draft_config",
           "init_params",
           "params_from_numpy", "num_params", "quantize_params",
           "head_weight", "hidden_states", "forward",
           "init_kv_cache", "forward_with_cache", "loss_fn",
           "loss_and_grads", "global_norm", "TrainState",
           "init_train_state", "train_step", "flops_per_token"]

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
    # the head is embed.T and there is no lm_head
    tie_embeddings: bool = False
    # compute dtype of the forward pass
    dtype: Any = torch.bfloat16
    # recompute each layer in the backward pass: "full" recomputes all of
    # it, "dots" keeps the matmul outputs, "attn" the attention outputs
    remat: bool = True
    remat_policy: str = "full"
    # kept for the JAX package's configs; attention always runs through
    # the flash kernels (module docstring)
    use_flash: bool = True
    # not ported (ROADMAP A10): raise NotImplementedError when set
    context_parallel: bool = False
    pipeline_microbatches: int = 0
    pipeline_chunks: int = 1
    pipeline_schedule: str = "gpipe"
    # >1 computes the cross-entropy in sequence chunks, each recomputed in
    # the backward pass, so [B, S, vocab] f32 logits never exist at once
    loss_chunks: int = 1


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def tiny_llama(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
               seq=128, ffn=128) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn,
        num_layers=layers, num_heads=heads, num_kv_heads=kv_heads,
        head_dim=hidden // heads, max_seq_len=seq, remat=False,
        use_flash=False)


def draft_config(target: LlamaConfig, *, num_layers=None, hidden_size=None,
                 intermediate_size=None, num_heads=None, num_kv_heads=None,
                 head_dim=None) -> LlamaConfig:
    """A draft-model config for speculative decoding
    (``serving.LLMEngine(draft_params=..., draft_config=...)``): the
    target's vocabulary (the engine requires it), context and dtype, with
    the capacity knobs shrunk. Defaults halve the depth and the widths;
    RoPE theta is the target's."""
    t = target
    hidden = hidden_size if hidden_size is not None else t.hidden_size // 2
    heads = num_heads if num_heads is not None else max(1, t.num_heads // 2)
    return dataclasses.replace(
        t,
        num_layers=(num_layers if num_layers is not None
                    else max(1, t.num_layers // 2)),
        hidden_size=hidden,
        intermediate_size=(intermediate_size if intermediate_size
                           is not None else t.intermediate_size // 2),
        num_heads=heads,
        num_kv_heads=(num_kv_heads if num_kv_heads is not None
                      else max(1, min(t.num_kv_heads, heads))),
        head_dim=(head_dim if head_dim is not None else hidden // heads),
    )


def _check_supported(c) -> None:
    """Raise for what is not ported of ``c`` (a llama config, or another
    model's config that shares these fields, as the MoE config does)."""
    if c.context_parallel:
        raise NotImplementedError(
            "context_parallel (ring attention over an 'sp' mesh axis) is "
            "not ported yet (ROADMAP A10)")
    if getattr(c, "pipeline_microbatches", 0) > 0 \
            or getattr(c, "pipeline_chunks", 1) != 1 \
            or getattr(c, "pipeline_schedule", "gpipe") != "gpipe":
        raise NotImplementedError(
            "pipeline schedules (GPipe, 1F1B, ZB, VPP chunks) are not "
            "ported yet (ROADMAP A10)")


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
    top = {"embed": ((c.vocab_size, h), s), "final_norm": ((h,), None)}
    if not c.tie_embeddings:
        top["lm_head"] = ((h, c.vocab_size), s)
    return top, layers


def init_params(config: LlamaConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and scales (norms
    are ones, matrices scaled normals; no ``lm_head`` when tied), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    ``dtype`` defaults to f32 masters; serving passes bf16 to hold the
    weights at compute precision. The JAX and torch generators differ, so
    the values do not match the reference's ``init_params`` — weights move
    between the packages with :func:`params_from_numpy`."""
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


def _leaf_from_numpy(a, device, dtype=None):
    """One leaf of a JAX tree as torch: an array as a tensor on ``device``
    (``dtype`` None keeps its own), an int8 weight-only leaf ``{"q", "s"}``
    as such a dict with ``q`` and ``s`` untouched in their dtypes."""
    if isinstance(a, dict):
        return {k: _leaf_from_numpy(v, device) for k, v in a.items()}
    a = np.array(a)                  # a writable host copy
    if a.dtype.name == "bfloat16":   # torch reads no numpy bf16: widen
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """The JAX parameter tree, as numpy arrays (``embed``, stacked
    ``layers.*`` [L, ...], ``final_norm`` and, when untied, ``lm_head``),
    as torch tensors under the same keys and layouts on ``device``;
    ``dtype`` None keeps each array's own dtype, and applies only to
    dense leaves: int8 weight-only leaves ``{"q": int8, "s": bf16}``
    (:func:`quantize_params`) come over as they are."""
    dev = resolve_device(device)
    conv = functools.partial(_leaf_from_numpy, device=dev, dtype=dtype)

    missing = ({"embed", "layers", "final_norm"} - set(tree)) \
        | {"layers." + k for k in LAYER_KEYS
           if k not in tree.get("layers", {})}
    if missing:
        raise KeyError(f"parameter tree lacks {sorted(missing)}")
    out = {k: conv(tree[k]) for k in ("embed", "final_norm", "lm_head")
           if k in tree}
    out["layers"] = {k: conv(tree["layers"][k]) for k in LAYER_KEYS}
    return out


def num_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def head_weight(params, config: LlamaConfig):
    """The output projection [h, vocab]: ``embed.T`` when tied, else
    ``lm_head`` — a tensor, or an int8 weight-only leaf for
    :func:`kernels.quant_matmul.weight_only_matmul`."""
    return params["embed"].t() if config.tie_embeddings \
        else params["lm_head"]


# ---------------------------------------------------------------------------
# int8 weight-only quantization (the serving path's weights)
# ---------------------------------------------------------------------------
_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def _quantize_channels(w):
    """Per-output-channel absmax int8 of a [..., K, N] weight: ``{"q":
    int8, "s": bf16 [..., N]}``, values clipped to [-128, 127] (the JAX
    package's quantize_params; its KV and expert quantizers clip to
    +-127). The int8 values come from the f32 scale, which is then stored
    in bf16. Stacked leaves go in leading-axis slices (exact: the scale
    reduces over K)."""
    qs, ss = [], []
    for part in _slices(w, -2):
        wf = part.float()
        scale = wf.abs().amax(dim=-2) / 127.0
        q = torch.round(wf / scale.clamp_min(1e-9)[..., None, :])
        qs.append(q.clamp(-128, 127).to(torch.int8))
        ss.append(scale.to(torch.bfloat16))
        del wf, q
    if len(qs) == 1:
        return {"q": qs[0], "s": ss[0]}
    return {"q": torch.cat(qs, 0), "s": torch.cat(ss, 0)}


def quantize_params(params, include_lm_head: bool = True):
    """Per-output-channel absmax int8 quantization of the matmul weights
    ([L, K, N] stacked leaves -> ``{"q": int8 [L, K, N], "s": bf16
    [L, N]}``) and, with ``include_lm_head``, of ``lm_head``. Norms and the
    embedding stay as they are (gathers, not matmuls)."""
    out = dict(params)
    out["layers"] = {k: (_quantize_channels(v) if k in _QUANT_KEYS else v)
                     for k, v in params["layers"].items()}
    if include_lm_head and "lm_head" in params:
        out["lm_head"] = _quantize_channels(params["lm_head"])
    return out


def _wmat(p, name, dt):
    """A weight leaf as a dense matmul operand in ``dt``: an int8 leaf
    dequantized (``q * s`` in f32, then ``dt``). The serving path keeps
    int8 leaves as they are (``weight_only_matmul``); this is for cold
    paths."""
    w = p[name] if isinstance(name, str) else name
    if is_quantized_weight(w):
        return (w["q"].float() * w["s"].float()[..., None, :]).to(dt)
    return w.to(dt)


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
    """Causal GQA attention in the [B, S, H, D] layout, differentiable: the
    flash kernels on CUDA tensors, their plain versions on CPU tensors."""
    return flash_attention.apply(q, k, v, True)


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


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.matmul.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy (jax checkpoint_dots): keep matmul outputs,
    recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_attention(ctx, op, *args, **kwargs):
    """The "attn" policy (jax save_only_these_names("attn_out")): keep
    the flash forward's output and log-sum-exp, so the backward pass does
    not run B1 again; recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.paddle_tpu_torch.flash_fwd.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, config: LlamaConfig):
    """``body`` recomputed in the backward pass by the non-reentrant
    ``torch.utils.checkpoint`` (the reentrant form carries no gradient to
    parameters that are not its inputs)."""
    policies = {"dots": _save_matmuls, "attn": _save_attention}
    if config.remat_policy in policies:
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                policies[config.remat_policy])
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 context_fn=ctx)
    if config.remat_policy != "full":
        raise ValueError(
            f"remat_policy={config.remat_policy!r}: expected 'full', "
            "'dots', or 'attn'")
    return functools.partial(checkpoint, body, use_reentrant=False)


def hidden_states(params, tokens, config: LlamaConfig):
    """tokens [B, S] int -> final-norm hidden states [B, S, h] (model
    dtype)."""
    c = config
    _check_supported(c)
    S = tokens.shape[1]
    x = params["embed"].to(c.dtype)[tokens.long()]
    cos, sin = _rope_tables(S, c.head_dim, c.rope_theta, tokens.device)
    body = _remat(_layer_body, c) if c.remat else _layer_body
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once (indexing [l] would scatter into a zero [L, ...]
    # tensor per layer)
    per_layer = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    for l in range(c.num_layers):
        x = body(x, {k: per_layer[k][l] for k in LAYER_KEYS}, cos, sin, c)
    return _rms_norm(x, params["final_norm"], c.rms_eps)


def forward(params, tokens, config: LlamaConfig):
    """tokens [B, S] int -> logits [B, S, vocab] (f32); an int8 ``lm_head``
    leaf goes through ``weight_only_matmul``."""
    x = hidden_states(params, tokens, config)
    return _wo_mm(x, head_weight(params, config), config.dtype).float()


# ---------------------------------------------------------------------------
# inference: the fixed-batch KV-cache forward (the verify primitive of
# speculative decoding; the serving engine runs its paged-pool analogue)
# ---------------------------------------------------------------------------

def init_kv_cache(config: LlamaConfig, batch: int, max_len: int, *,
                  device="cuda"):
    """An empty cache: ``k``/``v`` [L, batch, max_len, Hkv, D] in the
    model dtype and the next write position ``pos``."""
    c = config
    dev = resolve_device(device)
    shape = (c.num_layers, batch, max_len, c.num_kv_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev), "pos": 0}


def _cached_attention(q, k_cache, v_cache, pos: int, config: LlamaConfig):
    """q [B, S_new, Hq, D] against one layer's caches [B, max_len, Hkv,
    D]: keys at or below each query's position ``pos + i`` (causal inside
    the new block), GQA-grouped (the cache is never repeated), f32
    scores, probabilities rounded to q's dtype before the PV product."""
    c = config
    B, S, Hq, D = q.shape
    G = Hq // c.num_kv_heads
    qg = q.reshape(B, S, c.num_kv_heads, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k_cache.float()) * (1.0 / math.sqrt(D))
    key_idx = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    qry_idx = pos + torch.arange(S, device=q.device)[:, None]
    s = torch.where((key_idx <= qry_idx)[None, None, None], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache)
    return out.reshape(B, S, Hq, D)


def forward_with_cache(params, tokens, cache, config: LlamaConfig,
                       logits_all: bool = False):
    """Append ``tokens`` [B, S_new] to ``cache`` and return (logits,
    cache): the last position's logits [B, vocab] (f32), or with
    ``logits_all`` every position's [B, S_new, vocab] — score a piece of
    draft tokens in one forward and read the next-token distribution
    after each. Prefill (S_new = prompt length) and decode (S_new = 1)
    alike. The cache's ``k``/``v`` are written in place; the returned
    cache is a new dict with ``pos`` advanced by S_new."""
    c = config
    dt = c.dtype
    B, S = tokens.shape
    pos = int(cache["pos"])
    x = params["embed"].to(dt)[tokens.long()]
    freq = c.rope_theta ** (-torch.arange(0, c.head_dim, 2,
                                          dtype=torch.float32,
                                          device=x.device) / c.head_dim)
    ang = (pos + torch.arange(S, dtype=torch.float32,
                              device=x.device))[:, None] * freq[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    ck, cv = cache["k"], cache["v"]
    for l in range(c.num_layers):
        p = {k: (v[l] if not isinstance(v, dict)
                 else {kk: vv[l] for kk, vv in v.items()})
             for k, v in params["layers"].items()}
        hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
        q = _wo_mm(hn, p["wq"], dt).reshape(B, S, c.num_heads, c.head_dim)
        k = _wo_mm(hn, p["wk"], dt).reshape(B, S, c.num_kv_heads,
                                             c.head_dim)
        v = _wo_mm(hn, p["wv"], dt).reshape(B, S, c.num_kv_heads,
                                             c.head_dim)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        ck[l, :, pos:pos + S] = k
        cv[l, :, pos:pos + S] = v
        att = _cached_attention(q, ck[l], cv[l], pos, c)
        x = x + _wo_mm(att.reshape(B, S, c.num_heads * c.head_dim),
                       p["wo"], dt)
        hn = _rms_norm(x, p["mlp_norm"], c.rms_eps)
        gate = torch.nn.functional.silu(_wo_mm(hn, p["w_gate"], dt))
        x = x + _wo_mm(gate * _wo_mm(hn, p["w_up"], dt), p["w_down"], dt)
    x = _rms_norm(x, params["final_norm"], c.rms_eps)
    xh = x if logits_all else x[:, -1]
    if c.tie_embeddings:
        logits = (xh @ params["embed"].to(dt).t()).float()
    else:
        logits = _wo_mm(xh, params["lm_head"], dt).float()
    return logits, {"k": ck, "v": cv, "pos": pos + S}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce_sum(x, targets, head):
    """Summed cross-entropy of hidden states ``x`` [B, s, h] against
    ``targets`` [B, s] through ``head`` [h, vocab], with f32 logits."""
    logits = (x @ head).float()
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def _chunked_ce_sum(x, targets, head, n_chunks: int):
    """Summed next-token CE over [B, S, h] hidden states without ever
    materializing [B, S, vocab] logits: S/n_chunks-long chunks, each
    recomputed in the backward pass."""
    B, S, h = x.shape
    if S % n_chunks:
        raise ValueError(
            f"loss_chunks={n_chunks} must divide the next-token sequence "
            f"length {S} (= seq - 1 of the training batch); pick a "
            "divisor or a sequence length with small factors")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xi, ti in zip(x.chunk(n_chunks, dim=1),
                      targets.chunk(n_chunks, dim=1)):
        total = total + checkpoint(_ce_sum, xi, ti, head,
                                   use_reentrant=False)
    return total


def loss_fn(params, tokens, config: LlamaConfig):
    """Next-token cross-entropy, mean over positions (f32)."""
    c = config
    x = hidden_states(params, tokens[:, :-1], c)
    head = head_weight(params, c).to(c.dtype)
    targets = tokens[:, 1:]
    if c.loss_chunks > 1:
        total = _chunked_ce_sum(x, targets, head, c.loss_chunks)
    else:
        total = _ce_sum(x, targets, head)
    return total / (x.shape[0] * x.shape[1])


# ---------------------------------------------------------------------------
# train state / step
# ---------------------------------------------------------------------------

class TrainState:
    """Parameters, the optimizer's moments (``mu``, ``nu``) and the step
    count, a 0-d int32 tensor on the parameters' device."""

    def __init__(self, params, mu, nu, step):
        self.params, self.mu, self.nu, self.step = params, mu, nu, step


def init_train_state(config: LlamaConfig, seed: int = 0,
                     optimizer: str = "adamw",
                     moment_dtype=torch.float32,
                     param_dtype=torch.float32,
                     device="cuda") -> TrainState:
    """``optimizer``/``moment_dtype``/``param_dtype`` select the memory mode
    (optimizer/functional.py): adamw+f32 is the 16-bytes/param recipe,
    adafactor+bf16 params about 4 bytes/param."""
    params = init_params(config, seed, device=device, dtype=param_dtype)
    mu, nu = init_moments(params, optimizer, moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=params["embed"].device)
    return TrainState(params, mu, nu, step)


def loss_and_grads(params, tokens, config: LlamaConfig, loss_function=None):
    """(loss, grads) of ``loss_function(params, tokens, config)`` (default
    :func:`loss_fn`), the grads a tree like ``params`` in the parameters'
    dtypes (``jax.value_and_grad``)."""
    lf = loss_function or loss_fn
    with torch.enable_grad():
        tracked = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = lf(tracked, tokens, config)
        grads = iter(torch.autograd.grad(loss, tree_leaves(tracked)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def global_norm(grads):
    """The f32 L2 norm over every leaf of ``grads`` (a 0-d tensor)."""
    return torch.stack([g.float().square().sum()
                        for g in tree_leaves(grads)]).sum().sqrt()


def train_step(state: TrainState, tokens, config: LlamaConfig,
               lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1,
               clip_norm=1.0, loss_function=None, optimizer="adamw",
               accum_steps=1, adafactor_eps2=1e-3):
    """One pretrain step: forward and backward, the global-norm clip
    ``min(1, clip_norm / (gnorm + 1e-6))`` (kept on the device), and the
    optimizer update (optimizer/functional.py — adamw or factored-moment
    adafactor). ``loss_function(params, tokens, config)`` defaults to the
    llama loss. ``accum_steps`` > 1 runs forward and backward over batch
    slices, accumulating grads in f32. ``adafactor_eps2`` floors
    adafactor's step size (optimizer_update). Returns (new_state, loss); the
    state's tensors are new, the input state is left as it was."""
    _check_supported(config)
    if accum_steps > 1:
        if not isinstance(tokens, torch.Tensor):
            raise ValueError(
                "accum_steps>1 requires an array batch; tuple batches "
                "(e.g. bert's (ids, labels)) must pre-slice themselves")
        B = tokens.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum_steps}")
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device),
                         state.params)
        for mb in tokens.reshape((accum_steps, B // accum_steps)
                                 + tuple(tokens.shape[1:])):
            l, g = loss_and_grads(state.params, mb, config, loss_function)
            loss = loss + l
            tree_map(lambda a, b: a.add_(b.float()), grads, g)
        loss = loss / accum_steps
        grads = tree_map(lambda g: g / accum_steps, grads)
    else:
        loss, grads = loss_and_grads(state.params, tokens, config,
                                     loss_function)

    scale = (clip_norm / (global_norm(grads) + 1e-6)).clamp(max=1.0)
    new_p, new_m, new_n = optimizer_update(
        state.params, grads, state.mu, state.nu, state.step,
        optimizer=optimizer, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        wd=wd, scale=scale, adafactor_eps2=adafactor_eps2)
    return TrainState(new_p, new_m, new_n, state.step + 1), loss


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Matmul FLOPs per trained token, forward and backward: 6*N for the
    dense weights plus the 12*L*h*S causal-attention term (PaLM appendix
    accounting, as the JAX package counts)."""
    c = config
    top, layers = _shapes(c)
    n = sum(math.prod(shape) for shape, _ in (*top.values(),
                                              *layers.values()))
    return 6.0 * n + 12.0 * c.num_layers * c.hidden_size * seq_len
