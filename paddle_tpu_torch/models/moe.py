"""Mixture-of-Experts (DeepSeekMoE class) — the port of
paddle_tpu/models/moe.

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

The routed FFN (:func:`moe_ffn`) runs ``routing="dropless"`` through
``kernels.moe_dispatch`` (``dispatch="fused"``, ``"gmm"`` or ``"dense"``;
B9 and B10 on the card) or ``routing="capacity"``, GShard's
fixed-capacity einsum dispatch. ``dispatch="auto"``
is ``moe_dispatch.pick_dispatch_form`` at the batch's routing shape: on the
card the forms measured forward and backward once per shape (the dense
form a candidate where ``dense_base`` and the shape's plan allow it), the
winner persisted; on the CPU the static default "fused", as the reference
answers off a TPU. A model resolves "auto" once per forward, before its
layers run.

Sharded training (``llama.activation_mesh`` over a ``(dp, tp)`` mesh;
:func:`param_specs`, :func:`make_shardings`,
:func:`init_sharded_train_state`, ``llama.put_train_state``): each rank
holds its slices and its batch rows (``llama.TrainPlan``). Each routed
and shared expert is split Megatron-style over ``tp`` (gate|up by
columns, down by rows), and one all-reduce over ``tp`` sums the
combined [T, h] output; the router is gathered over ``dp`` and routes
the rank's tokens identically on every ``tp`` rank, its combine weights'
gradient all-reduced over ``tp``. The aux loss is the global batch's:
the per-expert ``mean(probs)`` and ``mean(onehot)`` are averaged over
``dp`` before their product. Capacity routing takes its capacity from
the global T and offsets each token's slot by the counts of the lower
``dp`` ranks, so it drops what the global routing drops. "auto"'s pick
is made on the world's first rank and broadcast. Not ported yet: a mesh
with ``ep > 1`` raises ``NotImplementedError`` (ROADMAP A10.5).

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
keeps the routed FFN's output [T, h] (routed + shared), named by the
identity operator ``torch.ops.paddle_tpu_torch.routed_out`` — the JAX
package's ``save_only_these_names("attn_out", "routed_out")``. The
recompute runs the routed FFN's forward again up to its last saved
tensor (non-reentrant checkpoint stops there), so the down GEMM runs
twice a step, as the reference's recompute does. :data:`saved_probe`, when
set to a list, records what the "outs" policy keeps.
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
from ..distributed.mesh import P
from ..kernels import moe_dispatch as _md
from ..kernels import quant_matmul as _qm
from ..observability import numerics as _numerics
from ..optimizer.functional import init_moments, tree_leaves
from . import llama as _llama
from .llama import TrainState, _attention_block, _rms_norm, _rope_tables

__all__ = [
    "MoEConfig", "deepseek_moe_16b", "tiny_moe", "init_params",
    "params_from_numpy", "forward", "loss_fn", "moe_ffn", "top_k_gating",
    "TrainState", "init_train_state", "train_step", "num_params",
    "active_params_per_token", "flops_per_token", "quantize_expert_params",
    "hidden_states_with_aux", "param_specs", "make_shardings",
    "init_sharded_train_state",
]

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
              "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")


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
    # expert-parallel strategy under an ep>1 mesh: not ported (A10.5)
    ep_strategy: str = "auto"
    # "auto" (measured on the card, "fused" on the CPU), "fused", "gmm",
    # "dense"
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
    # not ported (A10.4): raises when set
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
    if c.dispatch not in ("auto", "fused", "gmm", "dense"):
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


def param_specs(config: MoEConfig, fsdp: bool = True) -> Dict[str, Any]:
    """PartitionSpec per weight: 'ep' shards the expert axis, 'tp' the
    Megatron axis of each expert and of the dense sublayers, fsdp ('dp')
    the remaining matrix axis (the reference's recipe)."""
    dp = "dp" if fsdp else None
    return {
        "embed": P("tp", dp),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, dp, "tp"),
            "wk": P(None, dp, "tp"),
            "wv": P(None, dp, "tp"),
            "wo": P(None, "tp", dp),
            "mlp_norm": P(None, None),
            "router": P(None, dp, None),
            "e_gate": P(None, "ep", dp, "tp"),
            "e_up": P(None, "ep", dp, "tp"),
            "e_down": P(None, "ep", "tp", dp),
            "s_gate": P(None, dp, "tp"),
            "s_up": P(None, dp, "tp"),
            "s_down": P(None, "tp", dp),
        },
        "final_norm": P(None),
        "lm_head": P(dp, "tp"),
    }


def make_shardings(config: MoEConfig, mesh, fsdp: bool = True):
    """The fitted spec of every parameter of ``config`` on ``mesh``
    (``llama._fit_spec``; the reference's NamedSharding tree)."""
    top, layers = _shapes(config)
    specs = param_specs(config, fsdp)
    out = {k: _llama._fit_spec(specs[k], top[k][0], mesh) for k in top}
    out["layers"] = {k: _llama._fit_spec(specs["layers"][k], layers[k][0],
                                         mesh) for k in layers}
    return out


def _tp_mlp(config: MoEConfig, shardings, tp: int):
    """(whether tp splits the experts, the rank's expert width): the
    sharded train path's MLP split (``llama._TrainRecipe``)."""
    lay = shardings["layers"]
    mlp = lay["e_gate"][-1] == "tp"
    if mlp != (lay["s_gate"][-1] == "tp"):
        raise ValueError(
            "tp must split the routed and the shared experts alike (tp "
            "divides moe_intermediate_size and n_shared * it, or neither)")
    return mlp, dict(moe_intermediate_size=config.moe_intermediate_size
                     // (tp if mlp else 1))


_llama._TRAIN_RECIPES[MoEConfig] = _llama._TrainRecipe(
    _shapes, make_shardings, _tp_mlp)


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
    if _numerics.active():
        # paired pre/post-quant probe for the expert-int8 site: one
        # aggregated relative-error landing over gate/up/down
        # (numerics_quant_error{site="expert_int8"})
        _numerics.record_quant_error("expert_int8", [
            (params["layers"][k], layers[k]["q"], layers[k]["s"], axis)
            for k, axis in (("e_gate", 2), ("e_up", 2), ("e_down", 3))])
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

def top_k_gating(logits, top_k: int, global_mean=None):
    """Top-k softmax router. Returns (weights [T, k], indices [T, k],
    aux_loss) with the load-balance aux loss (GShard eq. (4));
    ``global_mean`` as in ``moe_dispatch.routing_from_logits``."""
    probs = torch.softmax(logits.float(), dim=-1)                 # [T, E]
    weights, idx = torch.topk(probs, top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    E = logits.shape[-1]
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(0)
    if global_mean is not None:
        me, ce = global_mean(me), global_mean(ce)
    return weights, idx, E * (me * ce).sum()


def _resolve_form(c: MoEConfig, T: int, x, quantized: bool,
                  plan=None) -> str:
    """The dropless dispatch form for T tokens like x: int8 leaves take
    "fused"; "auto" is :func:`moe_dispatch.pick_dispatch_form` at the
    routing shape on the card (the dense form a candidate where
    ``dense_base`` and the shape's plan allow it) and the static default
    on the CPU, as the reference's single-program branch."""
    if quantized:
        return "fused"     # int8 leaves live on the fused path
    if c.dispatch != "auto":
        return c.dispatch
    if x.device.type != "cuda":
        return _md._FORM_STATIC
    h, E = c.hidden_size, c.num_experts
    if plan is None:
        plan = _md.plan_dispatch(T, c.top_k, E, h)
    return _md.pick_dispatch_form(T, c.top_k, E, h, c.moe_intermediate_size,
                                  x.dtype,
                                  dense_ok=c.dense_base and plan.use_dense)


def moe_ffn(x, router_w, e_gate, e_up, e_down, config: MoEConfig,
            shared_weights=None, mesh=None, tplan=None):
    """Routed-expert FFN over flattened tokens x [T, h], dispatched by
    ``config.routing`` (and ``config.dispatch``: "auto" resolves here
    unless the caller resolved it); returns (y [T, h], aux). With
    ``shared_weights=(s_gate, s_up, s_down)`` y is routed + shared.
    ``mesh`` (axis name -> size) with ``ep > 1`` raises: expert
    parallelism is ROADMAP A10.5. ``tplan`` (a ``llama.TrainPlan``): x is
    this rank's tokens and the experts its tp slices (module docstring);
    y is whole and aux the global batch's."""
    c = config
    _check_supported(c)
    if mesh is not None and mesh.get("ep", 1) > 1:
        raise NotImplementedError(
            "expert parallelism (a mesh with ep > 1) is not ported yet "
            "(ROADMAP A10.5)")
    quantized = _qm.is_quantized_weight(e_gate)
    if quantized and c.routing != "dropless":
        raise ValueError(
            "int8 expert weights (quantize_expert_params) require "
            "routing='dropless' — the capacity einsum path has no "
            "quantized form")
    if tplan is not None and quantized:
        raise ValueError("int8 expert weights are frozen: sharded "
                         "training takes dense experts")
    # under a plan: the router on the whole x (the same on every tp rank),
    # the experts on the rank's f columns, their inputs and combine
    # weights through _c_identity, one all-reduce of the routed + shared sum
    global_mean = None if tplan is None else tplan.dp_mean
    xt = x if tplan is None else tplan.enter(x, tplan.mlp)
    shared = None if shared_weights is None else _md._shared_swiglu(
        xt, *shared_weights, x.dtype)
    if c.routing == "dropless":
        if c.fused_router:
            routing = _md.fused_routing(x, router_w, c.top_k,
                                        global_mean=global_mean)
            weights, idx, aux = routing.weights, routing.idx, routing.aux
        else:
            routing = None
            weights, idx, aux = top_k_gating(x.float() @ router_w.float(),
                                             c.top_k, global_mean)
        if tplan is not None:
            weights = tplan.enter(weights, tplan.mlp)
        # the routing shape's memoized plan, derived once a shape and
        # reused by every layer and step after (moe_plan_cache_* counts
        # it, as in the reference's single-program branch)
        T, h = x.shape
        E = (e_gate["q"] if quantized else e_gate).shape[0]
        plan = _md.plan_dispatch(T, c.top_k, E, h)
        form = _resolve_form(c, T, x, quantized, plan)
        if form == "dense":
            y = _md.dropless_moe_ffn_dense(xt, weights, idx, e_gate, e_up,
                                           e_down, routing=routing,
                                           plan=plan)
        else:
            ffn = (_md.dropless_moe_ffn_fused if form == "fused"
                   else _md.dropless_moe_ffn)
            y = ffn(xt, weights, idx, e_gate, e_up, e_down, routing=routing)
    else:
        y, aux = _capacity_ffn(x, router_w, e_gate, e_up, e_down, c, tplan)
    y = y if shared is None else y + shared
    return (y if tplan is None else tplan.exit(y, tplan.mlp)), aux


def _capacity_ffn(x, router_w, e_gate, e_up, e_down, c: MoEConfig,
                  tplan=None):
    """GShard fixed-capacity one-hot einsum dispatch [T, E, C]; tokens past
    capacity are dropped. Under ``tplan`` x is this rank's tokens: the
    capacity counts the global batch's and the slots follow the lower dp
    ranks' (what the global routing keeps), the experts are tp slices
    (their output partial sums; the caller all-reduces)."""
    weights, idx, aux = top_k_gating(
        x.float() @ router_w.float(), c.top_k,
        None if tplan is None else tplan.dp_mean)
    T, h = x.shape
    E, k, dt = c.num_experts, c.top_k, x.dtype
    n = 1 if tplan is None else tplan.dp
    C = max(1, int(c.capacity_factor * T * n * k / E))
    onehot = torch.nn.functional.one_hot(idx, E).to(torch.int32)  # [T,k,E]
    flat = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flat, 0) - flat).reshape(T, k, E)    # rank per expert
    if tplan is not None:
        pos = pos + tplan.dp_offsets(flat.sum(0))[None, None]
        weights = tplan.enter(weights, tplan.mlp)
        x = tplan.enter(x, tplan.mlp)
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

def _layer_body(x, aux, p, cos, sin, config: MoEConfig, dense: bool,
                tplan=None):
    c = config
    B, S, h = x.shape
    dt = c.dtype
    if tplan is not None:
        p = tplan.layer(p)        # gathered over dp (again in a recompute)
    x = _attention_block(x, p, cos, sin, c, tplan)
    hn = _rms_norm(x, p["mlp_norm"], c.rms_eps)
    if dense:
        # the dense layers' MLP is the shared FFN alone
        if tplan is not None:
            hn = tplan.enter(hn, tplan.mlp)
        sg = torch.nn.functional.silu(hn @ p["s_gate"].to(dt))
        y = (sg * (hn @ p["s_up"].to(dt))) @ p["s_down"].to(dt)
        if tplan is not None:
            y = tplan.exit(y, tplan.mlp)
    else:
        y, a = moe_ffn(hn.reshape(B * S, h), p["router"], p["e_gate"],
                       p["e_up"], p["e_down"], c,
                       shared_weights=(p["s_gate"], p["s_up"], p["s_down"]),
                       tplan=tplan)
        if c.remat and c.remat_policy == "outs":
            y = routed_out(y)          # the one [T, h] tensor "outs" keeps
        y = y.reshape(B, S, h)
        aux = aux + a
    return x + y, aux


@torch.library.custom_op("paddle_tpu_torch::routed_out", mutates_args=())
def routed_out(y: torch.Tensor) -> torch.Tensor:
    """The identity on the routed FFN's output, as a registered operator
    (``torch.ops.paddle_tpu_torch.routed_out``) that the "outs" policy
    names (the JAX ``checkpoint_name(y, "routed_out")``). An operator's
    output may not alias its input, so it is a copy ([T, h]: a few
    microseconds)."""
    return y.clone()


routed_out.register_fake(lambda y: torch.empty_like(y))
routed_out.register_autograd(lambda ctx, grad: grad)

_SAVED_OPS = (torch.ops.paddle_tpu_torch.flash_fwd.default,
              torch.ops.paddle_tpu_torch.routed_out.default)

# None, or a list to which the "outs" policy appends (op name, shape,
# dtype) of the first input of every operator whose outputs it keeps in a
# forward pass (routed_out: its output's; flash_fwd: q's, whose shape its
# output shares, beside a [B, Hq, S] f32 lse)
saved_probe = None


def _save_outs(ctx, op, *args, **kwargs):
    """The "outs" policy: keep the flash forward's outputs and the routed
    FFN's [T, h] output (the JAX save_only_these_names("attn_out",
    "routed_out"))."""
    if op not in _SAVED_OPS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    if saved_probe is not None and not ctx.is_recompute:
        saved_probe.append((op.name(), tuple(args[0].shape), args[0].dtype))
    return CheckpointPolicy.MUST_SAVE


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
    loss summed over the MoE layers). Under ``llama.activation_mesh``
    ``params`` and ``tokens`` are this rank's slices (module docstring)."""
    c = config
    _check_supported(c)
    _llama._check_supported(c)
    tplan = _llama.train_plan(c, params)
    if tplan is not None:
        c = tplan.config
    B, S = tokens.shape
    x = _llama._embed_rows(params, tokens, c, tplan)
    # "auto" resolves once, outside the checkpointed layers (its first
    # encounter of a shape measures the forms on the card); under a mesh
    # on the world's first rank, every rank running its pick
    if c.routing == "dropless" and c.dispatch == "auto":
        quantized = _qm.is_quantized_weight(params["layers"]["e_gate"])

        def pick():
            return _resolve_form(c, B * S, x, quantized)
        form = pick() if tplan is None else tplan.agree(
            ("dispatch", B * S, x.dtype, x.device.type), pick)
        c = dataclasses.replace(c, dispatch=form)
    cos, sin = _rope_tables(S, c.head_dim, c.rope_theta, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # one unbind per stacked weight (its backward stacks the L gradients)
    per_layer = {k: _unbind(params["layers"][k]) for k in LAYER_KEYS}
    bodies = {}
    for dense in (True, False):
        body = functools.partial(_layer_body, config=c, dense=dense,
                                 tplan=tplan)
        bodies[dense] = _remat(body, c) if c.remat else body
    # numerics ladder (the reference's scan ys): one stats rung per layer
    # output, built under no_grad on the detached output outside the
    # checkpointed body (a recompute lands no second rung and the rungs
    # add no backward op), shipped as one [n, 5] landing per group —
    # the dense head at offset 0, the MoE tail at offset
    # first_dense_layers. Off, not one op is added.
    ladder = _numerics.active()
    rungs = []
    n_dense = c.first_dense_layers
    for l in range(c.num_layers):
        x, aux = bodies[l < n_dense](
            x, aux, {k: per_layer[k][l] for k in LAYER_KEYS}, cos, sin)
        if ladder:
            with torch.no_grad():
                rungs.append(_numerics.tensor_stats(x.detach()))
    if ladder:
        with torch.no_grad():
            if n_dense > 0:
                _numerics.ladder_record("moe.layer",
                                        torch.stack(rungs[:n_dense]))
            if c.num_layers > n_dense:
                _numerics.ladder_record("moe.layer",
                                        torch.stack(rungs[n_dense:]),
                                        offset=n_dense)
    return _rms_norm(x, params["final_norm"], c.rms_eps), aux


def _unbind(w):
    """The L per-layer slices of a stacked leaf (of both tensors of an int8
    leaf)."""
    if isinstance(w, dict):
        parts = {k: v.unbind(0) for k, v in w.items()}
        return [dict(zip(parts, vals)) for vals in zip(*parts.values())]
    return w.unbind(0)


def forward(params, tokens, config: MoEConfig, return_aux=False):
    """tokens [B, S] -> logits [B, S, vocab] (f32), and the aux loss
    (under a mesh, this rank's rows with the whole vocabulary)."""
    tplan = _llama.train_plan(config, params)
    x, aux = hidden_states_with_aux(params, tokens, config)
    if tplan is None:
        logits = (x @ params["lm_head"].to(config.dtype)).float()
    else:
        logits = _llama._plan_logits(tplan, x, tplan.leaf(params, "lm_head"),
                                    config.dtype)
    return (logits, aux) if return_aux else logits


def loss_fn(params, tokens, config: MoEConfig):
    """Next-token cross-entropy (mean, f32) plus router_aux_coef * aux; the
    cross-entropy in ``loss_chunks`` sequence chunks when they divide the
    sequence. Under ``llama.activation_mesh``, this rank's share of the
    global batch's loss (llama.loss_fn)."""
    c = config
    tplan = _llama.train_plan(c, params)
    x, aux = hidden_states_with_aux(params, tokens[:, :-1], c)
    n = c.loss_chunks if c.loss_chunks > 1 \
        and x.shape[1] % c.loss_chunks == 0 else 1
    head = params["lm_head"] if tplan is None \
        else tplan.leaf(params, "lm_head")
    total = _llama._ce_total(x, tokens[:, 1:], head.to(c.dtype), n, tplan)
    loss = total / (x.shape[0] * x.shape[1]) + c.router_aux_coef * aux
    return loss if tplan is None else loss / tplan.dp


def init_train_state(config: MoEConfig, seed: int = 0,
                     optimizer: str = "adamw", moment_dtype=torch.float32,
                     param_dtype=torch.float32, device="cuda") -> TrainState:
    """Parameters in ``param_dtype`` and the moments of ``optimizer`` (as
    llama.init_train_state)."""
    params = init_params(config, seed, device=device, dtype=param_dtype)
    mu, nu = init_moments(params, optimizer, moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=params["embed"].device)
    return TrainState(params, mu, nu, step)


def init_sharded_train_state(config: MoEConfig, seed: int = 0,
                             param_shardings=None,
                             optimizer: str = "adamw",
                             param_dtype=torch.float32, device="cuda", *,
                             moment_dtype=torch.float32,
                             mesh=None) -> TrainState:
    """The train state built directly as this rank's slices
    (``llama.init_sharded_train_state`` with this model's shapes; default
    shardings :func:`make_shardings`): equal to
    ``shard_params(init_params(config, seed, device="cpu",
    dtype=param_dtype), ...)`` bit for bit."""
    mesh = _llama._active_mesh(mesh)
    if param_shardings is None:
        param_shardings = make_shardings(config, mesh)
    params = _llama._init_sharded(_shapes, config, seed, param_shardings,
                                  param_dtype, device, mesh)
    mu, nu = init_moments(params, optimizer, moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=params["embed"].device)
    return TrainState(params, mu, nu, step)


def train_step(state: TrainState, tokens, config: MoEConfig, **kw):
    """llama's train step with the MoE loss (cross-entropy + router aux)."""
    return _llama.train_step(state, tokens, config, loss_function=loss_fn,
                             **kw)


# the host FLOP count the resilient loop's train_mfu reads
# (observability/perf.py train_step_flops)
train_step.flops_per_token = flops_per_token
