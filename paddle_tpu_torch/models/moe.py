"""Mixture-of-Experts (DeepSeekMoE class) — the port of
paddle_tpu/models/moe (single device).

Parameters are a plain dictionary under the JAX package's keys and
layouts: ``embed`` [vocab, h]; per-layer weights stacked on a leading [L]
axis under ``layers`` (``attn_norm``, ``wq``, ``wk``, ``wv``, ``wo``,
``mlp_norm``, ``router`` [L, h, E], the routed experts ``e_gate``/``e_up``
[L, E, h, f] and ``e_down`` [L, E, f, h], and the shared experts as one
FFN of width n_shared*f, ``s_gate``/``s_up`` [L, h, fs], ``s_down``
[L, fs, h]); ``final_norm``; ``lm_head`` [h, vocab]. The first
``first_dense_layers`` layers carry expert weights they never use (their
gradients are zeros, and the optimizer still updates them, as in the JAX
package) and run the shared FFN alone as their MLP — the JAX package's
dense layer, whose width is n_shared*f rather than the config's
``intermediate_size``. :func:`params_from_numpy` carries a JAX tree over.

The routed FFN (:func:`moe_ffn`) runs on one device: ``routing=
"dropless"`` through ``kernels.moe_dispatch`` (``dispatch="fused"``, which
"auto" resolves to, or ``"gmm"``; B9 and B10 on the card) or ``routing=
"capacity"``, GShard's fixed-capacity einsum dispatch. Not ported yet,
each raising ``NotImplementedError``: the dense-base form
``dispatch="dense"`` and the measured pick of "auto" on the card (ROADMAP
A9); a mesh with ``ep > 1`` (A10).

int8 routed experts: :func:`quantize_expert_params` turns ``e_gate``,
``e_up`` and ``e_down`` into ``{"q": int8, "s": f32}`` leaves
(``quant_matmul.quantize_grouped``: one scale per expert and f channel,
shared over h — the gate/up outputs' and the down projection's inputs'),
for ``routing="dropless"`` only. Such leaves always take the
fused dispatch (B9 reads the int8 gate|up matrix, the scales fold into the
elementwise chain), as in the JAX package, and are frozen: gradients reach
the activations and every other parameter, never ``q`` or ``s``.

``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``): "full" all of it; "attn" keeps the flash
forward's outputs (``torch.ops.paddle_tpu_torch.flash_fwd``); "outs" also
keeps the outputs of every grouped GEMM of the forward pass
(``torch.ops.paddle_tpu_torch.gmm``: the fused form's down projection),
and since the shared FFN runs before the routed one, the recompute stops
there (non-reentrant checkpoint stops once it has every tensor the
backward needs) — neither the down GEMM nor the combine runs twice, as
the JAX package's saved ``routed_out`` spares them. It keeps [A_pad, h]
a layer where the JAX package keeps [T, h] (PERF.md).
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
from ..kernels import moe_dispatch as _md
from ..kernels import quant_matmul as _qm
from ..optimizer.functional import init_moments, tree_leaves
from . import llama as _llama
from .llama import (TrainState, _apply_rope, _attention, _rms_norm,
                    _rope_tables)

__all__ = [
    "MoEConfig", "deepseek_moe_16b", "tiny_moe", "init_params",
    "params_from_numpy", "forward", "loss_fn", "moe_ffn", "top_k_gating",
    "TrainState", "init_train_state", "train_step", "num_params",
    "active_params_per_token", "flops_per_token", "quantize_expert_params",
    "hidden_states_with_aux",
]

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
              "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")

# what dispatch="auto" resolves to: the JAX package's static default (on
# a TPU it measures the forms instead; that measured pick is ROADMAP A9)
_FORM_STATIC = "fused"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944       # never used (module docstring)
    moe_intermediate_size: int = 1408    # per-expert FFN (fine-grained)
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 128
    num_experts: int = 64
    top_k: int = 6
    n_shared_experts: int = 2
    first_dense_layers: int = 1          # DeepSeekMoE: layer 0 stays dense
    # "dropless" (sorted grouped GEMMs, nothing dropped) or "capacity"
    # (GShard fixed-capacity einsums, tokens past capacity dropped)
    routing: str = "dropless"
    # expert-parallel strategy under an ep>1 mesh: not ported (A10)
    ep_strategy: str = "auto"
    # "auto" (= "fused"), "fused", "gmm"; "dense" is not ported (A9)
    dispatch: str = "auto"
    dense_base: bool = True
    # False: the unfused router (top_k_gating, sort metadata re-derived)
    fused_router: bool = True
    # "int8": quantize_expert_params quantizes the routed experts
    expert_dtype: Any = None
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    # "full", "attn" or "outs" (module docstring)
    remat_policy: str = "full"
    # kept for the JAX package's configs; attention always runs through
    # the flash kernels (llama's module docstring)
    use_flash: bool = True
    # not ported (A10): raises when set
    context_parallel: bool = False
    # >1: the cross-entropy in sequence chunks (llama._chunked_ce_sum)
    loss_chunks: int = 8


def deepseek_moe_16b() -> MoEConfig:
    return MoEConfig()


def tiny_moe(vocab=256, hidden=64, layers=2, heads=4, experts=8, top_k=2,
             seq=128) -> MoEConfig:
    return MoEConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 2,
        moe_intermediate_size=hidden, num_layers=layers, num_heads=heads,
        num_kv_heads=heads, head_dim=hidden // heads, num_experts=experts,
        top_k=top_k, n_shared_experts=1, first_dense_layers=0,
        max_seq_len=seq, remat=False, use_flash=False)


def _check_supported(c: MoEConfig) -> None:
    if c.expert_dtype not in (None, "int8"):
        raise ValueError(f"expert_dtype={c.expert_dtype!r}: expected None "
                         "or 'int8'")
    if c.routing not in ("dropless", "capacity"):
        raise ValueError(f"routing={c.routing!r}: expected 'dropless' or "
                         "'capacity'")
    if c.dispatch == "dense":
        raise NotImplementedError(
            "dispatch='dense' (the dense-base form) is not ported yet "
            "(ROADMAP A9, rest)")
    if c.dispatch not in ("auto", "fused", "gmm"):
        raise ValueError(f"dispatch={c.dispatch!r}: expected 'auto', "
                         "'fused', 'gmm', or 'dense'")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _shapes(c: MoEConfig):
    h, L, E = c.hidden_size, c.num_layers, c.num_experts
    nq, nkv, d = c.num_heads, c.num_kv_heads, c.head_dim
    fm, fs = c.moe_intermediate_size, c.n_shared_experts * \
        c.moe_intermediate_size
    s = 1.0 / math.sqrt(h)
    o = s / math.sqrt(2 * L)
    layers = {
        "attn_norm": ((L, h), None),
        "wq": ((L, h, nq * d), s),
        "wk": ((L, h, nkv * d), s),
        "wv": ((L, h, nkv * d), s),
        "wo": ((L, nq * d, h), o),
        "mlp_norm": ((L, h), None),
        "router": ((L, h, E), s),
        "e_gate": ((L, E, h, fm), s),
        "e_up": ((L, E, h, fm), s),
        "e_down": ((L, E, fm, h), o / math.sqrt(fm / h)),
        "s_gate": ((L, h, fs), s),
        "s_up": ((L, h, fs), s),
        "s_down": ((L, fs, h), o),
    }
    top = {"embed": ((c.vocab_size, h), s), "final_norm": ((h,), None),
           "lm_head": ((h, c.vocab_size), s)}
    return top, layers


def init_params(config: MoEConfig, seed: int = 0, *, device="cuda",
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and scales (norms
    are ones, matrices scaled normals) drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``, in ``dtype``. The JAX and torch
    generators differ, so the values do not match the reference's —
    weights move between the packages with :func:`params_from_numpy`."""
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
    """The JAX MoE parameter tree, as numpy arrays, as torch tensors under
    the same keys and layouts on ``device``; ``dtype`` None keeps each
    array's own dtype, and applies only to dense leaves: int8 expert
    leaves ``{"q", "s"}`` come over as they are."""
    dev = resolve_device(device)
    missing = ({"embed", "layers", "final_norm", "lm_head"} - set(tree)) \
        | {"layers." + k for k in LAYER_KEYS
           if k not in tree.get("layers", {})}
    if missing:
        raise KeyError(f"parameter tree lacks {sorted(missing)}")

    conv = functools.partial(_llama._leaf_from_numpy, device=dev,
                             dtype=dtype)
    out = {k: conv(tree[k]) for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = {k: conv(tree["layers"][k]) for k in LAYER_KEYS}
    return out


def num_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def quantize_expert_params(params, config: MoEConfig = None):
    """int8-quantize the routed-expert weights: ``layers.e_gate`` and
    ``e_up`` [L, E, h, f] become ``quantize_grouped(w, 2)`` leaves (scales
    [L, E, f], shared over h), ``e_down`` [L, E, f, h]
    ``quantize_grouped(w, 3)`` (scales [L, E, f], shared over h, one per
    input channel of the down projection); everything else stays as it
    is. With a ``config`` whose ``expert_dtype`` is None the
    params come back unchanged; int8 experts need ``routing="dropless"``."""
    if config is not None and config.expert_dtype != "int8":
        if config.expert_dtype is None:
            return params
        raise ValueError(f"expert_dtype={config.expert_dtype!r}: "
                         "expected None or 'int8'")
    if config is not None and config.routing != "dropless":
        raise ValueError(
            f"routing={config.routing!r}: int8 expert weights require "
            "routing='dropless' (the capacity einsum path has no quantized "
            "form)")
    out = dict(params)
    layers = dict(params["layers"])
    layers["e_gate"] = _qm.quantize_grouped(params["layers"]["e_gate"], 2)
    layers["e_up"] = _qm.quantize_grouped(params["layers"]["e_up"], 2)
    layers["e_down"] = _qm.quantize_grouped(params["layers"]["e_down"], 3)
    out["layers"] = layers
    return out


def active_params_per_token(config: MoEConfig) -> int:
    """Matmul-visible parameters touched per token: attention and shared
    experts every layer, router and top_k routed experts on MoE layers,
    and the lm_head."""
    c = config
    d = c.head_dim
    attn = (c.hidden_size * (c.num_heads * d + 2 * c.num_kv_heads * d)
            + c.num_heads * d * c.hidden_size)
    shared = 3 * c.hidden_size * c.n_shared_experts * c.moe_intermediate_size
    router = c.hidden_size * c.num_experts
    routed = 3 * c.hidden_size * c.moe_intermediate_size * c.top_k
    n_moe = c.num_layers - c.first_dense_layers
    return (c.num_layers * (attn + shared) + n_moe * (router + routed)
            + c.hidden_size * c.vocab_size)


def flops_per_token(config: MoEConfig, seq_len: int) -> float:
    """Forward and backward matmul FLOPs per trained token: 6*N_active plus
    the causal-attention term (the JAX package's accounting, as llama)."""
    c = config
    return (6.0 * active_params_per_token(c)
            + 12.0 * c.num_layers * c.hidden_size * seq_len)


# ---------------------------------------------------------------------------
# routing and expert compute
# ---------------------------------------------------------------------------

def top_k_gating(logits, top_k: int):
    """Top-k softmax router. Returns (weights [T, k], indices [T, k],
    aux_loss) with the load-balance aux loss (GShard eq. (4))."""
    probs = torch.softmax(logits.float(), dim=-1)                 # [T, E]
    weights, idx = torch.topk(probs, top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    E = logits.shape[-1]
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(0)
    return weights, idx, E * (me * ce).sum()


def moe_ffn(x, router_w, e_gate, e_up, e_down, config: MoEConfig,
            shared_weights=None, mesh=None):
    """Routed-expert FFN over flattened tokens x [T, h], dispatched by
    ``config.routing``; returns (y [T, h], aux). With
    ``shared_weights=(s_gate, s_up, s_down)`` y is routed + shared (the
    shared FFN runs first: see the module docstring on "outs"). ``mesh``
    (axis name -> size) with ``ep > 1`` raises: expert parallelism is
    ROADMAP A10."""
    c = config
    _check_supported(c)
    if mesh is not None and mesh.get("ep", 1) > 1:
        raise NotImplementedError(
            "expert parallelism (a mesh with ep > 1) is not ported yet "
            "(ROADMAP A10)")
    quantized = _qm.is_quantized_weight(e_gate)
    if quantized and c.routing != "dropless":
        raise ValueError(
            "int8 expert weights (quantize_expert_params) require "
            "routing='dropless' — the capacity einsum path has no "
            "quantized form")
    shared = None if shared_weights is None else _md._shared_swiglu(
        x, *shared_weights, x.dtype)
    if c.routing == "dropless":
        if c.fused_router:
            routing = _md.fused_routing(x, router_w, c.top_k)
            weights, idx, aux = routing.weights, routing.idx, routing.aux
        else:
            routing = None
            weights, idx, aux = top_k_gating(x.float() @ router_w.float(),
                                             c.top_k)
        form = _FORM_STATIC if c.dispatch == "auto" else c.dispatch
        if quantized:
            form = "fused"     # int8 leaves live on the fused path
        ffn = (_md.dropless_moe_ffn_fused if form == "fused"
               else _md.dropless_moe_ffn)
        y = ffn(x, weights, idx, e_gate, e_up, e_down, routing=routing)
    else:
        y, aux = _capacity_ffn(x, router_w, e_gate, e_up, e_down, c)
    return (y if shared is None else y + shared), aux


def _capacity_ffn(x, router_w, e_gate, e_up, e_down, c: MoEConfig):
    """GShard fixed-capacity one-hot einsum dispatch [T, E, C]; tokens past
    capacity are dropped."""
    weights, idx, aux = top_k_gating(x.float() @ router_w.float(), c.top_k)
    T, h = x.shape
    E, k, dt = c.num_experts, c.top_k, x.dtype
    C = max(1, int(c.capacity_factor * T * k / E))
    onehot = torch.nn.functional.one_hot(idx, E).to(torch.int32)  # [T,k,E]
    flat = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flat, 0) - flat).reshape(T, k, E)    # rank per expert
    pos = (pos * onehot).sum(-1)                              # [T, k]
    keep = pos < C                                            # overflow drop
    w = weights * keep.to(weights.dtype)
    slot = (pos[..., None] == torch.arange(C, device=x.device))  # [T,k,C]
    disp = torch.einsum("tke,tkc->tec",
                        onehot.to(dt) * keep[..., None].to(dt), slot.to(dt))
    comb = torch.einsum("tke,tkc,tk->tec", onehot.float(), slot.float(),
                        w.float()).to(dt)
    xe = torch.einsum("tec,th->ech", disp, x)                 # [E, C, h]
    gate = torch.nn.functional.silu(
        torch.einsum("ech,ehf->ecf", xe, e_gate.to(dt)))
    up = torch.einsum("ech,ehf->ecf", xe, e_up.to(dt))
    ye = torch.einsum("ecf,efh->ech", gate * up, e_down.to(dt))
    return torch.einsum("tec,ech->th", comb, ye), aux


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_body(x, aux, p, cos, sin, config: MoEConfig, dense: bool):
    c = config
    B, S, h = x.shape
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
    if dense:
        # the dense layers' MLP is the shared FFN alone
        sg = torch.nn.functional.silu(hn @ p["s_gate"].to(dt))
        y = (sg * (hn @ p["s_up"].to(dt))) @ p["s_down"].to(dt)
    else:
        y, a = moe_ffn(hn.reshape(B * S, h), p["router"], p["e_gate"],
                       p["e_up"], p["e_down"], c,
                       shared_weights=(p["s_gate"], p["s_up"], p["s_down"]))
        y = y.reshape(B, S, h)
        aux = aux + a
    return x + y, aux


_GMM = torch.ops.paddle_tpu_torch.gmm.default


def _save_outs(ctx, op, *args, **kwargs):
    """The "outs" policy: keep the flash forward's outputs and the grouped
    GEMMs' (the JAX save_only_these_names("attn_out", "routed_out"); see
    the module docstring)."""
    return (CheckpointPolicy.MUST_SAVE
            if op is _GMM or op is torch.ops.paddle_tpu_torch.flash_fwd.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, config: MoEConfig):
    policies = {"attn": _llama._save_attention, "outs": _save_outs}
    if config.remat_policy in policies:
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                policies[config.remat_policy])
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 context_fn=ctx)
    if config.remat_policy != "full":
        raise ValueError(
            f"MoEConfig.remat_policy={config.remat_policy!r}: expected "
            "'full', 'attn', or 'outs'")
    return functools.partial(checkpoint, body, use_reentrant=False)


def hidden_states_with_aux(params, tokens, config: MoEConfig):
    """tokens [B, S] -> (final-norm hidden states [B, S, h], the router aux
    loss summed over the MoE layers)."""
    c = config
    _check_supported(c)
    _llama._check_supported(c)
    S = tokens.shape[1]
    x = params["embed"].to(c.dtype)[tokens.long()]
    cos, sin = _rope_tables(S, c.head_dim, c.rope_theta, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # one unbind per stacked weight (its backward stacks the L gradients)
    per_layer = {k: _unbind(params["layers"][k]) for k in LAYER_KEYS}
    bodies = {}
    for dense in (True, False):
        body = functools.partial(_layer_body, config=c, dense=dense)
        bodies[dense] = _remat(body, c) if c.remat else body
    for l in range(c.num_layers):
        x, aux = bodies[l < c.first_dense_layers](
            x, aux, {k: per_layer[k][l] for k in LAYER_KEYS}, cos, sin)
    return _rms_norm(x, params["final_norm"], c.rms_eps), aux


def _unbind(w):
    """The L per-layer slices of a stacked leaf (of both tensors of an int8
    leaf)."""
    if isinstance(w, dict):
        parts = {k: v.unbind(0) for k, v in w.items()}
        return [dict(zip(parts, vals)) for vals in zip(*parts.values())]
    return w.unbind(0)


def forward(params, tokens, config: MoEConfig, return_aux=False):
    """tokens [B, S] -> logits [B, S, vocab] (f32), and the aux loss."""
    x, aux = hidden_states_with_aux(params, tokens, config)
    logits = (x @ params["lm_head"].to(config.dtype)).float()
    return (logits, aux) if return_aux else logits


def loss_fn(params, tokens, config: MoEConfig):
    """Next-token cross-entropy (mean, f32) plus router_aux_coef * aux; the
    cross-entropy in ``loss_chunks`` sequence chunks when they divide the
    sequence."""
    c = config
    if c.loss_chunks > 1 and (tokens.shape[1] - 1) % c.loss_chunks == 0:
        x, aux = hidden_states_with_aux(params, tokens[:, :-1], c)
        total = _llama._chunked_ce_sum(x, tokens[:, 1:],
                                       params["lm_head"].to(c.dtype),
                                       c.loss_chunks)
        return total / (x.shape[0] * x.shape[1]) + c.router_aux_coef * aux
    logits, aux = forward(params, tokens[:, :-1], c, return_aux=True)
    targets = tokens[:, 1:].long()
    gold = logits.gather(-1, targets[..., None])[..., 0]
    ce = (torch.logsumexp(logits, dim=-1) - gold).mean()
    return ce + c.router_aux_coef * aux


def init_train_state(config: MoEConfig, seed: int = 0,
                     optimizer: str = "adamw", moment_dtype=torch.float32,
                     param_dtype=torch.float32, device="cuda") -> TrainState:
    """Parameters in ``param_dtype`` and the moments of ``optimizer`` (as
    llama.init_train_state)."""
    params = init_params(config, seed, device=device, dtype=param_dtype)
    mu, nu = init_moments(params, optimizer, moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=params["embed"].device)
    return TrainState(params, mu, nu, step)


def train_step(state: TrainState, tokens, config: MoEConfig, **kw):
    """llama's train step with the MoE loss (cross-entropy + router aux)."""
    return _llama.train_step(state, tokens, config, loss_function=loss_fn,
                             **kw)
