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
piece, the verify primitive of speculative decoding; a device-resident
``pos`` for a captured decode step); :func:`generate` (one eager step a
token) and :func:`generate_fused` (each step one replay of a CUDA graph
on the card), greedy or sampled with top-k/top-p and an eos early exit;
:func:`draft_config` shrinks a config into a draft model's.
:func:`convert_hf_state_dict` and :func:`to_hf_state_dict` map a Hugging
Face Llama state dict to and from the parameter tree;
:func:`export_for_inference` raises ``NotImplementedError`` (ROADMAP
A11).

Training: :func:`loss_fn` (optionally chunked cross-entropy),
:func:`loss_and_grads`, :func:`train_step` with a global-norm clip,
gradient accumulation and the optimizers of ``optimizer/functional.py``;
``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``; selective for the "dots" and "attn"
policies). Context parallelism and pipeline schedules raise
``NotImplementedError`` (ROADMAP A10.4, A10.3).

Sharding (the reference's Megatron recipe): :func:`param_specs`,
:func:`make_shardings`, :func:`make_serving_shardings` (int8 leaves: ``q``
takes the dense spec, ``s`` the output axis's) and
:func:`make_replicated_shardings` give a tree of the port's
``PartitionSpec``s fitted to a ``DeviceMesh`` (:func:`_fit_spec` drops an
axis that does not divide its dim, warning once); :func:`shard_params`
cuts a whole tree to the calling rank's slices; :func:`make_mesh` builds
the mesh over the job's ranks; :class:`TPPlan` holds the collectives the
tensor-parallel serving programs run.

Sharded training (data parallel with fsdp, and tensor parallel, over a
(dp, sp, tp) ``DeviceMesh``; one process a device): under
:class:`activation_mesh` every training function takes this rank's
slices of the state (:func:`init_sharded_train_state`,
:func:`put_train_state`) and its rows of the batch (:func:`shard_batch`)
and meets the other ranks through the collectives of a
:class:`TrainPlan` (:func:`train_plan`): each step's loss, gradients,
global norm and update are the global batch's. ``sp`` > 1 raises naming
ROADMAP A10.4, ``pp`` > 1 A10.3, ``ep`` > 1 A10.5.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import re
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..distributed.mesh import P, axis_group, axis_rank, axis_size, spec_axes
from ..kernels.pallas_attention import flash_attention
from ..kernels.quant_matmul import _slices, is_quantized_weight
from ..kernels.quant_matmul import weight_only_matmul as _wo_mm
from ..observability import numerics as _numerics
from ..optimizer.functional import (init_moments, moment_shardings,
                                    optimizer_update, tree_leaves, tree_map)

__all__ = ["LlamaConfig", "llama3_8b", "tiny_llama", "draft_config",
           "init_params",
           "params_from_numpy", "num_params", "quantize_params",
           "head_weight", "hidden_states", "forward",
           "init_kv_cache", "forward_with_cache", "loss_fn",
           "loss_and_grads", "global_norm", "TrainState",
           "init_train_state", "train_step", "flops_per_token", "generate",
           "generate_fused", "gen_stats", "convert_hf_state_dict",
           "to_hf_state_dict", "export_for_inference", "param_specs",
           "act_spec", "mesh_shape", "make_mesh", "make_shardings",
           "make_serving_shardings", "make_replicated_shardings",
           "shard_params", "TPPlan", "activation_mesh", "TrainPlan",
           "train_plan", "shard_batch", "init_sharded_train_state",
           "put_train_state"]

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
    # not ported (ROADMAP A10.4, A10.3): raise NotImplementedError when set
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
            "not ported yet (ROADMAP A10.4)")
    if getattr(c, "pipeline_microbatches", 0) > 0 \
            or getattr(c, "pipeline_chunks", 1) != 1 \
            or getattr(c, "pipeline_schedule", "gpipe") != "gpipe":
        raise NotImplementedError(
            "pipeline schedules (GPipe, 1F1B, ZB, VPP chunks) are not "
            "ported yet (ROADMAP A10.3)")


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
    embedding stay as they are (gathers, not matmuls).

    With ``FLAGS_obs_numerics`` (and observability) on, the paired
    pre/post-quant probe of every quantized leaf lands the site's relative
    error in ``numerics_quant_error{site="weight_only"}`` (the scale rides
    axis -2: one scale per output channel)."""
    out = dict(params)
    out["layers"] = {k: (_quantize_channels(v) if k in _QUANT_KEYS else v)
                     for k, v in params["layers"].items()}
    if include_lm_head and "lm_head" in params:
        out["lm_head"] = _quantize_channels(params["lm_head"])
    if _numerics.active():
        probe = _numerics.QuantErrorProbe()
        for k in sorted(_QUANT_KEYS):
            probe.add(params["layers"][k], out["layers"][k]["q"],
                      out["layers"][k]["s"], -2)
        if include_lm_head and "lm_head" in params:
            probe.add(params["lm_head"], out["lm_head"]["q"],
                      out["lm_head"]["s"], -2)
        probe.ship("weight_only")
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
# sharding recipe  (mesh axes: 'dp' data, 'sp' sequence, 'tp' model)
# ---------------------------------------------------------------------------

def param_specs(config: LlamaConfig, fsdp: bool = True) -> Dict[str, Any]:
    """PartitionSpec per weight. 'tp' shards the Megatron axis (column for
    qkv/gate/up, row for wo/down, vocab for embed/lm_head); fsdp additionally
    shards the other matrix axis over 'dp' (ZeRO-3 — reference:
    DygraphShardingOptimizer V2, dygraph_sharding_optimizer.py:592)."""
    dp = "dp" if fsdp else None
    # leading (layer) axis shards over 'pp' when the mesh has one — the
    # pipeline schedule slices stages from it (dropped on pp-less meshes)
    specs = {
        "embed": P("tp", dp),
        "layers": {
            "attn_norm": P("pp", None),
            "wq": P("pp", dp, "tp"),
            "wk": P("pp", dp, "tp"),
            "wv": P("pp", dp, "tp"),
            "wo": P("pp", "tp", dp),
            "mlp_norm": P("pp", None),
            "w_gate": P("pp", dp, "tp"),
            "w_up": P("pp", dp, "tp"),
            "w_down": P("pp", "tp", dp),
        },
        "final_norm": P(None),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = P(dp, "tp")
    return specs


def act_spec() -> P:
    # activations: [batch, seq, hidden] — batch over dp, sequence over sp
    return P("dp", "sp", None)


def mesh_shape(n: int):
    """The default (dp, sp, tp) factorization of ``n`` devices: tp gets
    the largest power-of-two factor up to 8 (innermost, the fastest
    links), sp up to 2 of the rest, dp what remains — the reference's
    hybrid order ['dp','pp','sharding','sep','mp'] outside→inside
    (fleet/base/distributed_strategy.py:1892)."""
    rem = n
    tp = 1
    while tp * 2 <= min(rem, 8) and rem % (tp * 2) == 0:
        tp *= 2
    rem //= tp
    sp = 1
    while sp * 2 <= min(rem, 2) and rem % (sp * 2) == 0:
        sp *= 2
    return (rem // sp, sp, tp)


def make_mesh(n_devices=None, axes=("dp", "sp", "tp"), shape=None,
              device_type=None):
    """A ``DeviceMesh`` over the job's ranks (one device a rank), shaped
    by :func:`mesh_shape` unless ``shape`` is given. Needs the process
    group up (``distributed.init_parallel_env``); ``device_type`` defaults
    to ``"cuda"`` when CUDA is available. Every rank must call it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if not dist.is_initialized() or n != world:
        raise ValueError(
            f"make_mesh({n}) needs a process group of {n} ranks (the "
            f"world has {world}{'' if dist.is_initialized() else ', none up'})")
    shape = tuple(shape or mesh_shape(n))
    dev = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh(dev, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


_FIT_SPEC_WARNED: set = set()


def _fit_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes that don't evenly divide the tensor dim (e.g. dp=3
    fsdp over hidden=128) — falls back to replication on that axis, the
    same degradation the reference's sharding pass applies to odd shapes.
    Warns once per dropped (axis, shape) so a typo'd mesh doesn't silently
    run replicated."""
    entries = []
    for d, entry in enumerate(spec):
        if entry is None:
            entries.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        keep, size = [], shape[d]
        for nm in names:
            ax = axis_size(mesh, nm)  # absent mesh axis → replicate
            if ax > 1 and size % ax == 0:
                keep.append(nm)
                size //= ax
            elif ax > 1:
                sig = (nm, ax, d, tuple(shape))
                if sig not in _FIT_SPEC_WARNED:
                    _FIT_SPEC_WARNED.add(sig)
                    import warnings
                    warnings.warn(
                        f"sharding axis '{nm}'={ax} does not divide dim {d} "
                        f"of shape {tuple(shape)} — replicating on that "
                        "axis (throughput may drop)", stacklevel=3)
        entries.append(tuple(keep) if len(keep) > 1 else
                       (keep[0] if keep else None))
    return P(*entries)


def make_shardings(config: LlamaConfig, mesh, fsdp: bool = True):
    """The fitted spec of every parameter of ``config`` on ``mesh`` (the
    tree :func:`shard_params` takes; the reference's NamedSharding tree)."""
    top, layers = _shapes(config)
    specs = param_specs(config, fsdp)
    out = {k: _fit_spec(specs[k], top[k][0], mesh) for k in top}
    out["layers"] = {k: _fit_spec(specs["layers"][k], layers[k][0], mesh)
                     for k in layers}
    return out


def make_serving_shardings(params, config: LlamaConfig, mesh,
                           fsdp: bool = False):
    """``make_shardings`` generalized over the ACTUAL param tree, so int8
    weight-only params (quantize_params) shard for tp serving: each
    quantized leaf's ``q`` matrix takes the dense weight's Megatron spec
    and its per-output-channel ``s`` vector keeps the spec of the OUTPUT
    axis (sharded over 'tp' for column-parallel qkv/gate/up and lm_head,
    replicated for row-parallel wo/down whose outputs are not
    tp-sharded) — the scale always lives with the channels it scales, so
    the weight-only dot needs no extra collectives."""
    dense = param_specs(config, fsdp)

    def one(spec, leaf):
        if isinstance(leaf, dict) and "q" in leaf:
            s_spec = (P(spec[0], spec[-1]) if leaf["q"].ndim == 3
                      else P(spec[-1]))
            return {"q": _fit_spec(spec, leaf["q"].shape, mesh),
                    "s": _fit_spec(s_spec, leaf["s"].shape, mesh)}
        return _fit_spec(spec, leaf.shape, mesh)

    out = {"embed": one(dense["embed"], params["embed"]),
           "layers": {k: one(dense["layers"][k], params["layers"][k])
                      for k in params["layers"]},
           "final_norm": one(dense["final_norm"], params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = one(dense["lm_head"], params["lm_head"])
    return out


def make_replicated_shardings(params, mesh):
    """A spec tree placing every leaf of ``params`` whole on every rank
    (spec ``P()``). The serving engine uses it for the speculative DRAFT
    under tp serving: the draft is small, so replicating it beats
    sharding a model whose kv heads may not divide the tp size."""
    return tree_map(lambda _: P(), params)


def _cut(t, spec, mesh):
    """This rank's slice of ``t`` under ``spec``; ``t`` itself when the
    spec splits nothing."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, idx = 1, 0
        for nm in (entry if isinstance(entry, tuple) else (entry,)):
            size = axis_size(mesh, nm)
            idx, n = idx * size + axis_rank(mesh, nm), n * size
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of shape {tuple(t.shape)} does not "
                             f"split {n} ways ({spec!r})")
        w = t.shape[d] // n
        t = t.narrow(d, idx * w, w)
    return t


def shard_params(params, shardings, mesh, device=None):
    """Cut each leaf of ``params`` to the calling rank's slice under its
    spec in ``shardings`` (a tree from :func:`make_shardings`,
    :func:`make_serving_shardings` or :func:`make_replicated_shardings`),
    as ``jax.device_put`` does with a sharding tree. A cut leaf is a
    fresh contiguous tensor (the whole one can be freed); a leaf whose
    spec splits nothing stays whole. ``device`` moves the result (the
    leaves' own device when None)."""
    def one(leaf, spec):
        if isinstance(leaf, dict):
            return {k: one(v, spec[k]) for k, v in leaf.items()}
        part = _cut(leaf, spec, mesh)
        if part is not leaf:
            part = part.clone(memory_format=torch.contiguous_format)
        return part if device is None else part.to(device)

    return {k: (one(v, shardings[k]) if k != "layers" else
                {n: one(w, shardings["layers"][n]) for n, w in v.items()})
            for k, v in params.items()}


class TPPlan:
    """Where the serving programs meet the other tensor-parallel ranks
    (Megatron): the vocab-parallel embedding lookup (this rank's rows,
    zeros elsewhere, then an all-reduce), the all-reduce after each
    row-parallel product (``wo``; ``w_down`` when the FFN is split), the
    all-gather of vocab-split logits, and the broadcast of each sampled
    token from the group's first rank, which makes the ranks agree by
    construction. Each decision follows the fitted specs: a dim that
    ``_fit_spec`` left whole runs no collective. ``config`` is the
    rank's own (its head and FFN counts); ``mesh`` is what B4's tp form
    takes; ``counts`` counts the collectives by kind."""

    def __init__(self, mesh, config: LlamaConfig, shardings):
        import torch.distributed as dist

        from ..distributed.collective import Group

        self.mesh = mesh
        pg = mesh.get_group("tp")
        self.group = Group(dist.get_process_group_ranks(pg), pg)
        self.size = axis_size(mesh, "tp")
        self.rank = axis_rank(mesh, "tp")

        def spec(leaf):
            return leaf["q"] if isinstance(leaf, dict) else leaf
        lay = shardings["layers"]
        self.vocab = spec(shardings["embed"])[0] == "tp"
        self.head = self.vocab if config.tie_embeddings \
            else spec(shardings["lm_head"])[-1] == "tp"
        self.mlp = spec(lay["w_gate"])[-1] == "tp"
        if spec(lay["wq"])[-1] != "tp" or spec(lay["wk"])[-1] != "tp":
            raise ValueError("tp serving needs the attention heads split")
        self.config = dataclasses.replace(
            config, num_heads=config.num_heads // self.size,
            num_kv_heads=config.num_kv_heads // self.size,
            intermediate_size=(config.intermediate_size // self.size
                               if self.mlp else config.intermediate_size))
        self.counts = collections.Counter()

    def embed(self, table, ids):
        """Rows ``ids`` of the embedding whose rows this rank holds."""
        if not self.vocab:
            return table[ids.long()]
        from ..distributed.fleet.layers.mpu.mp_ops import _c_lookup_table

        return self.reduce(_c_lookup_table(
            table, ids, start_index=self.rank * table.shape[0]))

    def reduce(self, y):
        """The sum of every rank's partial ``y`` (``_mp_allreduce``)."""
        from ..distributed.fleet.layers.mpu.mp_ops import _mp_allreduce

        self.counts["all_reduce"] += 1
        return _mp_allreduce(y, group=self.group)

    def mlp_out(self, y):
        return self.reduce(y) if self.mlp else y

    def logits(self, lg):
        """The whole vocabulary's logits from this rank's columns."""
        if not self.head:
            return lg
        from ..distributed.fleet.layers.mpu.mp_ops import _c_concat

        self.counts["all_gather"] += 1
        return _c_concat(lg, group=self.group)

    def agree(self, ids):
        """``ids`` as the group's first rank sampled them (in place)."""
        from ..distributed.collective import broadcast

        self.counts["broadcast"] += 1
        return broadcast(ids, self.group.ranks[0], self.group)


# ---------------------------------------------------------------------------
# sharded training: one process a device, each holding its slices
# ---------------------------------------------------------------------------

_ACT_MESH = None


class activation_mesh:
    """Context declaring the ``DeviceMesh`` (dims among ``dp``, ``sp``,
    ``tp``, ``pp``, ``ep``) that the training functions run under — the
    reference's ``_ACT_MESH``, read by :func:`hidden_states`,
    :func:`forward`, :func:`loss_fn`, :func:`loss_and_grads`,
    :func:`train_step` and MoE's. Under it every rank passes its own slices
    of the parameters (:func:`put_train_state`,
    :func:`init_sharded_train_state`) and of the batch
    (:func:`shard_batch`), and the functions meet the other ranks in real
    collectives (:class:`TrainPlan`). ``sp`` > 1 (context parallelism)
    raises naming ROADMAP A10.4, ``pp`` > 1 (pipelines) A10.3 and ``ep``
    > 1 (expert parallelism) A10.5."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.plans: Dict[Any, "TrainPlan"] = {}

    def __enter__(self):
        global _ACT_MESH
        self._prev, _ACT_MESH = _ACT_MESH, self
        return self.mesh

    def __exit__(self, *exc):
        global _ACT_MESH
        _ACT_MESH = self._prev


def _active_mesh(mesh=None):
    if mesh is not None:
        return mesh
    if _ACT_MESH is None or _ACT_MESH.mesh is None:
        raise ValueError("no mesh: pass mesh= or run under "
                         "llama.activation_mesh(mesh)")
    return _ACT_MESH.mesh


class _TrainRecipe(NamedTuple):
    """What the sharded train path needs to know of a model: its
    ``_shapes`` and ``make_shardings``, and ``tp_mlp(config, shardings,
    tp)`` -> (whether tp splits its MLP, the rank's FFN width as config
    fields)."""

    shapes: Callable
    make_shardings: Callable
    tp_mlp: Callable


def _tp_mlp(config, shardings, tp):
    mlp = shardings["layers"]["w_gate"][-1] == "tp"
    return mlp, dict(intermediate_size=config.intermediate_size
                     // (tp if mlp else 1))


# the recipe of each config class; a model module built on this one adds
# its own (moe's MoEConfig)
_TRAIN_RECIPES: Dict[type, _TrainRecipe] = {
    LlamaConfig: _TrainRecipe(_shapes, make_shardings, _tp_mlp)}


def _train_recipe(config) -> _TrainRecipe:
    recipe = _TRAIN_RECIPES.get(type(config))
    if recipe is None:
        raise ValueError(f"{type(config).__name__} has no sharded-training "
                         "recipe (a model registers one in "
                         "llama._TRAIN_RECIPES)")
    return recipe


def _check_mesh(mesh) -> None:
    """Raise for a mesh dim whose parallelism is not ported."""
    for ax, item, what in (("sp", "A10.4", "context parallelism"),
                           ("pp", "A10.3", "pipeline parallelism"),
                           ("ep", "A10.5", "expert parallelism")):
        if axis_size(mesh, ax) > 1:
            raise NotImplementedError(
                f"{what} (a mesh with {ax} > 1) is not ported yet "
                f"(ROADMAP {item})")


def _local_shape(shape, spec, mesh):
    out = list(shape)
    for d, entry in enumerate(spec):
        for nm in spec_axes(entry):
            out[d] //= axis_size(mesh, nm)
    return tuple(out)


def _infer_shardings(recipe, config, params, mesh):
    """The fitted spec tree (fsdp on, else off) whose slices have the
    shapes of ``params`` on ``mesh``."""
    top, layers = recipe.shapes(config)
    whole = dict({k: v[0] for k, v in top.items()},
                 layers={k: v[0] for k, v in layers.items()})
    got = tree_map(lambda t: tuple(t.shape), params)
    for fsdp in (True, False):
        sh = recipe.make_shardings(config, mesh, fsdp=fsdp)
        want = tree_map(lambda shape, spec: _local_shape(shape, spec, mesh),
                        whole, sh)
        if want == got:
            return sh
    raise ValueError(
        "the parameters are not this rank's slices under the active mesh "
        f"(shapes {got}); cut them with put_train_state or build them with "
        "init_sharded_train_state")


def train_plan(config, params):
    """The :class:`TrainPlan` of the active :class:`activation_mesh` for
    ``config`` and the slices in ``params`` (their shapes say whether
    fsdp splits them), made once and kept by the context; None with no
    mesh active."""
    ctx = _ACT_MESH
    if ctx is None or ctx.mesh is None:
        return None
    _check_mesh(ctx.mesh)
    key = (config, tuple(tuple(t.shape) for t in tree_leaves(params)))
    plan = ctx.plans.get(key)
    if plan is None:
        recipe = _train_recipe(config)
        plan = ctx.plans[key] = TrainPlan(
            ctx.mesh, config,
            _infer_shardings(recipe, config, params, ctx.mesh),
            recipe.tp_mlp)
    return plan


class _FsdpGather(torch.autograd.Function):
    """fsdp: a weight's ``dp``-split dim gathered whole before its use;
    the backward reduce-scatters the gradient over ``dp`` (every rank's
    contribution summed, this rank's block kept)."""

    @staticmethod
    def forward(ctx, w, dim, group):
        from ..distributed.collective import all_gather_dim

        ctx.dim, ctx.group = dim, group
        return all_gather_dim(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        from ..distributed.collective import reduce_scatter_dim

        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _DpMean(torch.autograd.Function):
    """The mean over the ``dp`` group of a tensor each rank computed from
    its batch rows; the adjoint is the same mean of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        from ..distributed.collective import ReduceOp, all_reduce

        ctx.group = group
        return all_reduce(x.detach().clone(), ReduceOp.AVG, group)

    @staticmethod
    def backward(ctx, g):
        from ..distributed.collective import ReduceOp, all_reduce

        return all_reduce(g.contiguous().clone(), ReduceOp.AVG,
                          ctx.group), None


class _LayerWeights:
    """One layer's weights under a :class:`TrainPlan`: each read gathers
    the weight's ``dp``-split dim (once a layer call; again in a
    recompute), so a layer whose body skips a weight (a MoE model's dense
    layers skip the experts) moves none of it."""

    def __init__(self, plan, p):
        self.plan, self.p, self.got = plan, p, {}

    def __getitem__(self, k):
        if k not in self.got:
            spec = self.plan.shardings["layers"][k]
            self.got[k] = self.plan.gather(self.p[k], P(*spec[1:]))
        return self.got[k]


class TrainPlan:
    """Where the sharded train step meets the other ranks of its mesh
    (``dp`` x ``tp``; ``shardings`` is the fitted spec tree of the
    parameters, from :func:`make_shardings` or moe's):

    - fsdp: a weight whose spec names ``dp`` is gathered whole over ``dp``
      (:class:`_FsdpGather`, a layer at a time inside the layer's body, so
      a recompute gathers again) and its gradient reduce-scattered back;
      every other leaf's gradient is all-reduced over ``dp``
      (:meth:`reduce_grads`). Each rank's loss is its rows' mean divided
      by ``dp``, so the sums are the global batch's gradient.
    - tp (Megatron, the mpu ops): column-parallel inputs through
      ``_c_identity`` (:meth:`enter`), row-parallel outputs through
      ``_mp_allreduce`` (:meth:`exit`), the vocab-parallel embedding
      (``_c_lookup_table`` and an all-reduce), the vocab-split logits into
      ``_c_softmax_with_cross_entropy``. The attention heads must be split.
    - the global norm counts each distinct slice once
      (:meth:`global_norm`).

    ``tp_mlp`` is the model's (:class:`_TrainRecipe`); ``config`` is the
    rank's own (its heads and FFN widths); ``counts``
    holds the collectives of the steps run under the plan by kind, and
    their bytes (``<kind>_bytes``), over ``steps`` steps."""

    def __init__(self, mesh, config, shardings, tp_mlp=_tp_mlp):
        _check_mesh(mesh)
        self.mesh, self.shardings = mesh, shardings
        self.dp, self.tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
        self.dp_group = axis_group(mesh, "dp") if self.dp > 1 else None
        self.tp_group = axis_group(mesh, "tp") if self.tp > 1 else None
        self.tp_rank = axis_rank(mesh, "tp")
        self.dp_rank = axis_rank(mesh, "dp")
        lay = shardings["layers"]
        if self.tp > 1 and (lay["wq"][-1] != "tp" or lay["wk"][-1] != "tp"
                            or config.num_heads % self.tp
                            or config.num_kv_heads % self.tp):
            raise ValueError("tp training needs the attention heads split "
                             "(tp must divide num_heads and num_kv_heads)")
        self.vocab = shardings["embed"][0] == "tp"
        self.tied = getattr(config, "tie_embeddings", False)
        self.head = self.vocab if self.tied \
            else shardings["lm_head"][-1] == "tp"
        self.mlp, width = tp_mlp(config, shardings, self.tp)
        self.config = dataclasses.replace(
            config, num_heads=config.num_heads // self.tp,
            num_kv_heads=config.num_kv_heads // self.tp, **width)
        self.counts = collections.Counter()
        self.steps = 0
        self.agreed: Dict[Any, Any] = {}

    # -- fsdp -------------------------------------------------------------
    def gather(self, w, spec):
        """``w`` whole along its ``dp``-split dim (none: ``w``)."""
        for d, entry in enumerate(spec):
            if "dp" in spec_axes(entry) and self.dp > 1:
                return _FsdpGather.apply(w, d, self.dp_group)
        return w

    def leaf(self, params, name):
        return self.gather(params[name], self.shardings[name])

    def layer(self, p):
        """A layer's weight slices as gathered weights (read lazily)."""
        return _LayerWeights(self, p)

    # -- tp ---------------------------------------------------------------
    def enter(self, x, split: bool = True):
        """A column-parallel product's input: its gradient all-reduced
        over ``tp`` (``_c_identity``)."""
        if self.tp == 1 or not split:
            return x
        from ..distributed.fleet.layers.mpu.mp_ops import _c_identity

        return _c_identity(x, group=self.tp_group)

    def exit(self, y, split: bool = True):
        """A row-parallel product's partial sums, all-reduced over ``tp``
        (``_mp_allreduce``)."""
        if self.tp == 1 or not split:
            return y
        from ..distributed.fleet.layers.mpu.mp_ops import _mp_allreduce

        return _mp_allreduce(y, group=self.tp_group)

    def embed(self, params, ids, dtype):
        """Rows ``ids`` of the embedding (vocab-parallel over ``tp``)."""
        table = self.leaf(params, "embed").to(dtype)
        if not self.vocab or self.tp == 1:
            return table[ids.long()]
        from ..distributed.fleet.layers.mpu.mp_ops import _c_lookup_table

        return self.exit(_c_lookup_table(
            table, ids, start_index=self.tp_rank * table.shape[0]))

    def head_weight(self, params, config):
        """The output projection [h, vocab / tp] (gathered over ``dp``)."""
        if self.tied:
            return self.leaf(params, "embed").t()
        return self.leaf(params, "lm_head")

    # -- data parallel ----------------------------------------------------
    def dp_mean(self, x):
        """The mean over ``dp`` of a per-rank statistic, differentiable."""
        return x if self.dp == 1 else _DpMean.apply(x, self.dp_group)

    def dp_offsets(self, counts):
        """The sums of ``counts`` over the lower ``dp`` ranks (the global
        position of this rank's rows in a running count)."""
        if self.dp == 1:
            return torch.zeros_like(counts)
        from ..distributed.collective import all_gather

        parts = []
        all_gather(parts, counts.contiguous(), self.dp_group)
        return sum(parts[:self.dp_rank], torch.zeros_like(counts))

    def sum_dp(self, t):
        """``t`` summed over ``dp`` (a new tensor)."""
        if self.dp == 1:
            return t
        from ..distributed.collective import all_reduce

        return all_reduce(t.detach().clone(), group=self.dp_group)

    def reduce_grads(self, grads):
        """Every gradient leaf no ``dp`` axis splits, summed over ``dp``
        (the split ones were reduce-scattered by their gathers)."""
        if self.dp == 1:
            return grads
        from ..distributed.collective import all_reduce

        def one(g, spec):
            if any("dp" in spec_axes(e) for e in spec):
                return g
            return all_reduce(g.contiguous(), group=self.dp_group)
        return tree_map(one, grads, self.shardings)

    def agree(self, key, pick):
        """``pick()`` on the world's first rank, the same answer on every
        rank (kept per ``key``): a decision whose ranks must run one
        program."""
        if key not in self.agreed:
            from ..distributed.collective import broadcast_object_list
            from ..distributed.env import get_rank

            box = [pick() if get_rank() == 0 else None]
            broadcast_object_list(box, 0)
            self.agreed[key] = box[0]
        return self.agreed[key]

    def global_norm(self, grads):
        """The f32 L2 norm of the whole gradient tree from this rank's
        slices: each leaf's sum of squares divided by the number of ranks
        that hold the same slice, summed over the mesh."""
        from ..distributed.collective import all_reduce

        world = self.dp * self.tp

        def part(g, spec):
            n = math.prod(axis_size(self.mesh, a) for e in spec
                          for a in spec_axes(e))
            return g.float().square().sum() * (n / world)
        total = torch.stack(tree_leaves(tree_map(part, grads,
                                                 self.shardings))).sum()
        for g in (self.dp_group, self.tp_group):
            if g is not None:
                total = all_reduce(total, group=g)
        return total.sqrt()


def shard_batch(tokens, mesh=None):
    """This rank's rows of a global batch [B, ...]: the cut by
    ``P("dp", None)`` (``mesh`` defaults to the active one)."""
    mesh = _active_mesh(mesh)
    return _cut(tokens, P("dp", *([None] * (tokens.dim() - 1))),
                mesh).contiguous()


def _init_sharded(shapes, config, seed, param_shardings, param_dtype,
                  device, mesh):
    """Each leaf of ``shapes`` (a model's ``_shapes``) drawn whole on the
    host from the seeded CPU stream, in ``init_params``' order, then cut
    to this rank's slice on ``device``: ``shard_params(init_params(config,
    seed, device="cpu", dtype=param_dtype), ...)`` bit for bit, with one
    whole leaf at a time in host memory and only slices on the card."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    top, layers = shapes(config)

    def make(shape, scale, spec):
        if scale is None:
            whole = torch.ones(shape, dtype=param_dtype)
        else:
            whole = torch.randn(shape, generator=gen,
                                dtype=param_dtype).mul_(scale)
        return _cut(whole, spec, mesh).to(
            dev, memory_format=torch.contiguous_format, copy=True)

    params = {k: make(*top[k], param_shardings[k]) for k in top}
    params["layers"] = {k: make(*layers[k], param_shardings["layers"][k])
                        for k in layers}
    return params


def init_sharded_train_state(config: LlamaConfig, seed: int = 0,
                             param_shardings=None,
                             optimizer: str = "adamw",
                             param_dtype=torch.float32, device="cuda", *,
                             moment_dtype=torch.float32,
                             mesh=None) -> TrainState:
    """The train state built directly as this rank's slices: each
    parameter leaf drawn whole on the host from a CPU generator seeded
    with ``seed`` (one leaf at a time) and cut by ``param_shardings``
    (default ``make_shardings(config, mesh)``), so no rank ever holds a
    whole tree on the card; the moments are zeros of the slices' shapes
    (``moment_shardings``' cut). The slices equal
    ``shard_params(init_params(config, seed, device="cpu",
    dtype=param_dtype), param_shardings, mesh)`` bit for bit (a CUDA
    generator draws other values). ``mesh`` defaults to the active
    :class:`activation_mesh`'s."""
    mesh = _active_mesh(mesh)
    if param_shardings is None:
        param_shardings = make_shardings(config, mesh)
    params = _init_sharded(_shapes, config, seed, param_shardings,
                           param_dtype, device, mesh)
    mu, nu = init_moments(params, optimizer, moment_dtype)
    step = torch.zeros((), dtype=torch.int32, device=params["embed"].device)
    return TrainState(params, mu, nu, step)


def put_train_state(state: TrainState, param_shardings,
                    optimizer: str = "adamw", *, mesh=None) -> TrainState:
    """A whole train state cut to this rank's slices: the params by
    ``param_shardings``, the moments by ``moment_shardings`` (adafactor's
    scalar mu and factored nu are not param-shaped); the step as it is.
    ``mesh`` defaults to the active :class:`activation_mesh`'s."""
    mesh = _active_mesh(mesh)
    mu_sh, nu_sh = moment_shardings(param_shardings, state.params, optimizer)
    return TrainState(shard_params(state.params, param_shardings, mesh),
                      shard_params(state.mu, mu_sh, mesh),
                      shard_params(state.nu, nu_sh, mesh), state.step)


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


def _attention_block(x, p, cos, sin, config, plan=None):
    """x + the attention sublayer's output; under a :class:`TrainPlan`
    on this rank's heads, with the tp collectives around it."""
    c = config
    B, S, _ = x.shape
    dt = c.dtype
    hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
    if plan is not None:
        hn = plan.enter(hn)
    q = (hn @ p["wq"].to(dt)).reshape(B, S, c.num_heads, c.head_dim)
    k = (hn @ p["wk"].to(dt)).reshape(B, S, c.num_kv_heads, c.head_dim)
    v = (hn @ p["wv"].to(dt)).reshape(B, S, c.num_kv_heads, c.head_dim)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    att = _attention(q, k, v, c).reshape(B, S, c.num_heads * c.head_dim)
    o = att @ p["wo"].to(dt)
    return x + (o if plan is None else plan.exit(o))


def _layer_body(x, p, cos, sin, config: LlamaConfig, plan=None):
    """One decoder layer. Under a :class:`TrainPlan` ``p`` holds the
    layer's slices, gathered here (again in a recompute)."""
    c = config
    dt = c.dtype
    if plan is not None:
        p = plan.layer(p)
    x = _attention_block(x, p, cos, sin, c, plan)
    hn = _rms_norm(x, p["mlp_norm"], c.rms_eps)
    if plan is not None:
        hn = plan.enter(hn, plan.mlp)
    gate = torch.nn.functional.silu(hn @ p["w_gate"].to(dt))
    up = hn @ p["w_up"].to(dt)
    y = (gate * up) @ p["w_down"].to(dt)
    return x + (y if plan is None else plan.exit(y, plan.mlp))


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


def _embed_rows(params, tokens, config, plan=None):
    if plan is None:
        return params["embed"].to(config.dtype)[tokens.long()]
    return plan.embed(params, tokens, config.dtype)


def hidden_states(params, tokens, config: LlamaConfig):
    """tokens [B, S] int -> final-norm hidden states [B, S, h] (model
    dtype). Under an :class:`activation_mesh` ``params`` and ``tokens``
    are this rank's slices (:class:`TrainPlan`)."""
    c = config
    _check_supported(c)
    plan = train_plan(c, params)
    if plan is not None:
        c = plan.config
    S = tokens.shape[1]
    x = _embed_rows(params, tokens, c, plan)
    cos, sin = _rope_tables(S, c.head_dim, c.rope_theta, tokens.device)
    body = _layer_body if plan is None else functools.partial(
        _layer_body, plan=plan)
    body = _remat(body, c) if c.remat else body
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once (indexing [l] would scatter into a zero [L, ...]
    # tensor per layer)
    per_layer = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    # numerics ladder (the reference's scan ys): one stats rung per layer
    # output, built under no_grad on the detached output outside the
    # checkpointed body (a recompute lands no second rung and the rungs
    # add no backward op), shipped as ONE [L, 5] landing that the NaN
    # provenance walk reads. Off, not one op is added.
    ladder = _numerics.active()
    rungs = []
    for l in range(c.num_layers):
        x = body(x, {k: per_layer[k][l] for k in LAYER_KEYS}, cos, sin, c)
        if ladder:
            with torch.no_grad():
                rungs.append(_numerics.tensor_stats(x.detach()))
    if ladder:
        with torch.no_grad():
            _numerics.ladder_record("llama.layer", torch.stack(rungs))
    return _rms_norm(x, params["final_norm"], c.rms_eps)


def forward(params, tokens, config: LlamaConfig):
    """tokens [B, S] int -> logits [B, S, vocab] (f32); an int8 ``lm_head``
    leaf goes through ``weight_only_matmul``. Under an
    :class:`activation_mesh`, this rank's rows with the whole vocabulary
    (the vocab-split logits gathered over ``tp``)."""
    plan = train_plan(config, params)
    x = hidden_states(params, tokens, config)
    if plan is None:
        return _wo_mm(x, head_weight(params, config), config.dtype).float()
    return _plan_logits(plan, x, plan.head_weight(params, config),
                       config.dtype)


def _plan_logits(plan, x, head, dtype):
    """Whole-vocabulary f32 logits of hidden states ``x`` through this
    rank's ``head`` columns under ``plan``."""
    lg = (plan.enter(x, plan.head) @ head.to(dtype)).float()
    if not plan.head or plan.tp == 1:
        return lg
    from ..distributed.fleet.layers.mpu.mp_ops import _c_concat

    return _c_concat(lg, group=plan.tp_group)


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


def _cached_attention(q, k_cache, v_cache, pos, config: LlamaConfig):
    """q [B, S_new, Hq, D] against one layer's caches [B, max_len, Hkv,
    D]: keys at or below each query's position ``pos + i`` (causal inside
    the new block; ``pos`` an int or a 0-d device tensor), GQA-grouped
    (the cache is never repeated), f32 scores, probabilities rounded to
    q's dtype before the PV product."""
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
    cache is a new dict with ``pos`` advanced by S_new.

    ``cache["pos"]`` is an int, or a 0-d integer tensor on the cache's
    device: then the rope angles, the causal mask and the cache write
    index all come from it and the host never reads it, so one captured
    CUDA graph of a decode step serves every position
    (:func:`generate_fused`)."""
    c = config
    dt = c.dtype
    B, S = tokens.shape
    pos = cache["pos"]
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    x = params["embed"].to(dt)[tokens.long()]
    freq = c.rope_theta ** (-torch.arange(0, c.head_dim, 2,
                                          dtype=torch.float32,
                                          device=x.device) / c.head_dim)
    rows = pos + torch.arange(S, device=x.device)    # the cache rows written
    ang = rows.float()[:, None] * freq[None, :]
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
        ck[l].index_copy_(1, rows, k)
        cv[l].index_copy_(1, rows, v)
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
# fixed-batch generation (the decode that examples/llama_generate.py runs)
# ---------------------------------------------------------------------------

# host counters of the generation loops: "syncs" (host reads of a device
# value inside a loop), "graph_captures" and "graph_replays"
# (generate_fused on the card)
gen_stats: collections.Counter = collections.Counter()

_NEG = -1e30


def _as_scalar(v, dtype, device):
    """``v`` as a 0-d tensor on ``device``: a tensor as it is (in
    ``dtype``), a Python number through a fill (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _filter_logits(logits, temperature, top_k, top_p, *, use_top_k: bool,
                   use_top_p: bool):
    """The logits :func:`_sample_impl` draws from, the reference's masks:
    ``logits / temperature``; with ``use_top_k`` every logit below the
    top_k-th largest (the k-th sorted logit) set to -1e30; then with
    ``use_top_p`` every token outside the smallest probability-sorted
    prefix whose mass reaches top_p (dropped where ``cum - p >= top_p``,
    scattered back to vocabulary order) set to -1e30. The values may be
    Python numbers or 0-d tensors on the logits' device."""
    lg = logits / temperature
    B, V = lg.shape
    if use_top_k:
        srt = torch.sort(lg, dim=-1).values
        idx = torch.clamp(V - _as_scalar(top_k, torch.long, lg.device), 0,
                          V - 1)
        kth = srt.gather(-1, idx.reshape(1, 1).expand(B, 1))
        lg = torch.where(lg < kth, _NEG, lg)
    if use_top_p:
        sort_idx = torch.argsort(-lg, dim=-1, stable=True)
        sort_p = torch.softmax(lg, dim=-1).gather(-1, sort_idx)
        cum = torch.cumsum(sort_p, dim=-1)
        drop_sorted = cum - sort_p >= top_p      # keep the first >= p prefix
        drop = torch.zeros_like(drop_sorted).scatter(-1, sort_idx,
                                                     drop_sorted)
        lg = torch.where(drop, _NEG, lg)
    return lg


def _sample_impl(logits, generator, temperature, top_k, top_p, *,
                 sampled: bool, use_top_k: bool, use_top_p: bool):
    """Next tokens [B] from [B, vocab] logits. The keyword flags fix the
    regime (the reference's static arguments); temperature/top_k/top_p
    may be 0-d device tensors, so a captured decode step serves any
    values. Greedy is the argmax; sampling is the Gumbel-max draw over
    :func:`_filter_logits` (what ``jax.random.categorical`` computes) with
    uniforms from ``generator``."""
    if not sampled:
        return torch.argmax(logits, dim=-1)
    lg = _filter_logits(logits, temperature, top_k, top_p,
                        use_top_k=use_top_k, use_top_p=use_top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(lg + gumbel, dim=-1)


def _sample_logits(logits, generator, temperature: float, top_k: int,
                   top_p: float):
    """Eager entry: the regime flags from the Python values."""
    return _sample_impl(logits, generator, temperature, top_k, top_p,
                        sampled=temperature > 0, use_top_k=top_k > 0,
                        use_top_p=top_p < 1.0)


def _gen_setup(params, prompt_tokens, device, generator):
    dev = resolve_device(device) if device is not None \
        else params["embed"].device
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, prompt, generator


def generate(params, prompt_tokens, config: LlamaConfig,
             max_new_tokens: int, temperature: float = 0.0, generator=None,
             eos_token_id=None, top_k: int = 0, top_p: float = 1.0,
             device=None):
    """Greedy (temperature 0) or sampled generation, one eager decode step
    a token; ``top_k``/``top_p`` restrict the sampling pool. prompt_tokens
    [B, S_prompt] (a tensor or array) -> [B, S_prompt + n] on ``device``
    (default: the parameters' device), n <= max_new_tokens: with
    ``eos_token_id`` set, finished rows pad with eos and generation stops
    once every row has finished (a host read of that flag each token,
    counted in ``gen_stats["syncs"]``). ``generator``: a
    ``torch.Generator`` on that device (default: seeded with 0)."""
    dev, prompt, gen = _gen_setup(params, prompt_tokens, device, generator)
    B, S0 = prompt.shape
    cache = init_kv_cache(config, B, S0 + max_new_tokens, device=dev)
    logits, cache = forward_with_cache(params, prompt, cache, config)
    out = [prompt]
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        nxt = _sample_logits(logits, gen, temperature, top_k, top_p)
        if eos_token_id is not None:
            # finished rows keep emitting eos
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        nxt = nxt[:, None].to(prompt.dtype)
        out.append(nxt)
        if eos_token_id is not None:
            gen_stats["syncs"] += 1
            if bool(finished.all()):
                break
        if i + 1 < max_new_tokens:
            logits, cache = forward_with_cache(params, nxt, cache, config)
    return torch.cat(out, dim=1)


def _generated_len(toks, eos_token_id) -> int:
    """The reference's ``n``: every token when there is no eos, else the
    step after the last row's first eos (at most every token)."""
    n = toks.shape[1]
    if eos_token_id is None:
        return n
    hit = (toks == eos_token_id).cpu()
    first = torch.where(hit.any(1), hit.int().argmax(1),
                        torch.full((toks.shape[0],), n))
    return min(n, int(first.max()) + 1)


def _replay_steps(step, n_steps: int, finished, has_eos: bool, dev,
                  generator) -> None:
    """``n_steps`` decode steps on the card: the first eager on a side
    stream (the warm-up a capture needs), the rest as replays of ONE CUDA
    graph of ``step`` (the sampling generator registered with it, so each
    replay draws fresh numbers). With an eos, a pinned copy of "every row
    finished" is read one step behind — the host waits on the event of
    the step before the one it just queued, so the card always has work
    — and the loop stops once it is set (finished rows only repeat eos,
    so a later read is as good)."""
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        step()
    cur.wait_stream(side)
    if n_steps == 1:
        return
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        step()
    gen_stats["graph_captures"] += 1
    flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
    pending = collections.deque()
    for _ in range(n_steps - 1):
        graph.replay()
        gen_stats["graph_replays"] += 1
        if not has_eos:
            continue
        flag.copy_(finished.all(), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(cur)
        pending.append(ev)
        if len(pending) > 1:
            pending.popleft().synchronize()
            gen_stats["syncs"] += 1
            if bool(flag):
                break


def generate_fused(params, prompt_tokens, config: LlamaConfig,
                   max_new_tokens: int, temperature: float = 0.0,
                   generator=None, eos_token_id=None, top_k: int = 0,
                   top_p: float = 1.0, device=None):
    """:func:`generate`'s contract with no per-token dispatch on the card:
    one prefill, then each decode step (the forward over a device-resident
    position, the sampling and the eos bookkeeping, all writing static
    buffers in place) captured once a call as one CUDA graph for this
    (batch, length, regime) and replayed each token; the host reads
    nothing per token except, with an eos, a pinned flag one step behind.
    The sampling values (temperature, top_k, top_p, eos) are device
    scalars, the regime (greedy or sampled, top_k on, top_p on, eos set)
    fixes the captured program. The output is ``out[:, :S0 + n]`` with the
    reference's ``n``; ``max_new_tokens <= 0`` returns the prompt. The CPU
    runs the same step as a plain loop."""
    if max_new_tokens <= 0:
        return prompt_tokens
    dev, prompt, gen = _gen_setup(params, prompt_tokens, device, generator)
    B, S0 = prompt.shape
    sampled, has_eos = float(temperature) > 0, eos_token_id is not None
    regime = dict(sampled=sampled, use_top_k=int(top_k) > 0,
                  use_top_p=float(top_p) < 1.0)
    f32, i64 = torch.float32, torch.long
    temp_t = torch.full((), max(float(temperature), 1e-6), dtype=f32,
                        device=dev)
    top_k_t = torch.full((), int(top_k), dtype=i64, device=dev)
    top_p_t = torch.full((), float(top_p), dtype=f32, device=dev)
    eos_t = torch.full((), 0 if eos_token_id is None else int(eos_token_id),
                       dtype=i64, device=dev)
    cache = init_kv_cache(config, B, S0 + max_new_tokens, device=dev)
    cache["pos"] = torch.zeros((), dtype=i64, device=dev)
    toks = torch.zeros((B, max_new_tokens), dtype=i64, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    last = torch.zeros((B, 1), dtype=i64, device=dev)
    i_t = torch.zeros((1,), dtype=i64, device=dev)

    def sample(logits):
        nxt = _sample_impl(logits, gen, temp_t, top_k_t, top_p_t, **regime)
        if has_eos:
            nxt = torch.where(finished, eos_t, nxt)
            finished.logical_or_(nxt == eos_t)
        toks.index_copy_(1, i_t, nxt[:, None])
        last.copy_(nxt[:, None])
        i_t.add_(1)

    def step():
        logits, _ = forward_with_cache(params, last, cache, config)
        cache["pos"].add_(1)
        sample(logits)

    logits, _ = forward_with_cache(params, prompt, cache, config)
    cache["pos"].add_(S0)
    sample(logits)
    if dev.type == "cuda" and max_new_tokens > 1:
        _replay_steps(step, max_new_tokens - 1, finished, has_eos, dev,
                      gen if sampled else None)
    else:
        for _ in range(max_new_tokens - 1):
            step()
            if has_eos and bool(finished.all()):
                break
    n = _generated_len(toks, eos_token_id)
    return torch.cat([prompt, toks[:, :n].to(prompt.dtype)], dim=1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce_sum(x, targets, head):
    """Summed cross-entropy of hidden states ``x`` [B, s, h] against
    ``targets`` [B, s] through ``head`` [h, vocab], with f32 logits."""
    logits = (x @ head).float()
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def _ce_sum_split(x, targets, head, group):
    """:func:`_ce_sum` with ``head`` this rank's vocab columns: the rows'
    cross-entropy over the whole vocabulary from the split logits
    (``_c_softmax_with_cross_entropy`` over ``group``)."""
    from ..distributed.fleet.layers.mpu.mp_ops import \
        _c_softmax_with_cross_entropy

    logits = (x @ head).float()
    return _c_softmax_with_cross_entropy(logits, targets, group=group).sum()


def _ce_total(x, targets, head, n_chunks: int, plan=None):
    """The summed next-token CE of hidden states ``x`` through ``head``,
    in ``n_chunks`` sequence chunks when > 1; under a :class:`TrainPlan`
    with a vocab-split head, from the split logits."""
    ce = _ce_sum
    if plan is not None and plan.head and plan.tp > 1:
        x = plan.enter(x)
        ce = functools.partial(_ce_sum_split, group=plan.tp_group)
    if n_chunks > 1:
        return _chunked_ce_sum(x, targets, head, n_chunks, ce)
    return ce(x, targets, head)


def _chunked_ce_sum(x, targets, head, n_chunks: int, ce=None):
    """Summed next-token CE over [B, S, h] hidden states without ever
    materializing [B, S, vocab] logits: S/n_chunks-long chunks, each
    recomputed in the backward pass (``ce``, default :func:`_ce_sum`)."""
    B, S, h = x.shape
    if S % n_chunks:
        raise ValueError(
            f"loss_chunks={n_chunks} must divide the next-token sequence "
            f"length {S} (= seq - 1 of the training batch); pick a "
            "divisor or a sequence length with small factors")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xi, ti in zip(x.chunk(n_chunks, dim=1),
                      targets.chunk(n_chunks, dim=1)):
        total = total + checkpoint(ce or _ce_sum, xi, ti, head,
                                   use_reentrant=False)
    return total


def loss_fn(params, tokens, config: LlamaConfig):
    """Next-token cross-entropy, mean over positions (f32). Under an
    :class:`activation_mesh` (``params`` and ``tokens`` this rank's
    slices), this rank's share of the global mean: its rows' mean over
    ``dp`` (the ranks' shares sum to the global batch's loss)."""
    c = config
    plan = train_plan(c, params)
    x = hidden_states(params, tokens[:, :-1], c)
    head = (head_weight(params, c) if plan is None
            else plan.head_weight(params, c)).to(c.dtype)
    total = _ce_total(x, tokens[:, 1:], head, c.loss_chunks, plan)
    loss = total / (x.shape[0] * x.shape[1])
    return loss if plan is None else loss / plan.dp


# ---------------------------------------------------------------------------
# train state / step
# ---------------------------------------------------------------------------

class TrainState:
    """Parameters, the optimizer's moments (``mu``, ``nu``) and the step
    count, a 0-d int32 tensor on the parameters' device."""

    def __init__(self, params, mu, nu, step):
        self.params, self.mu, self.nu, self.step = params, mu, nu, step

    # the JAX package's pytree-node protocol: the checkpoint writer
    # (distributed/resilience/atomic_ckpt.py) flattens a state as the
    # custom node (params, mu, nu, step)
    def tree_flatten(self):
        return (self.params, self.mu, self.nu, self.step), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


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


def loss_and_grads(params, tokens, config: LlamaConfig, loss_function=None,
                   _reduce=True):
    """(loss, grads) of ``loss_function(params, tokens, config)`` (default
    :func:`loss_fn`), the grads a tree like ``params`` in the parameters'
    dtypes (``jax.value_and_grad``). Under an :class:`activation_mesh`:
    the global batch's loss (the same on every rank) and this rank's
    slices of its gradients."""
    lf = loss_function or loss_fn
    plan = train_plan(config, params)
    with torch.enable_grad():
        tracked = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = lf(tracked, tokens, config)
        grads = iter(torch.autograd.grad(loss, tree_leaves(tracked)))
    grads = tree_map(lambda _: next(grads), params)
    if plan is not None and _reduce:
        return plan.sum_dp(loss.detach()), plan.reduce_grads(grads)
    return loss.detach(), grads


def global_norm(grads, plan=None):
    """The f32 L2 norm over every leaf of ``grads`` (a 0-d tensor); with
    a :class:`TrainPlan`, of the whole tree whose slices ``grads`` are."""
    if plan is not None:
        return plan.global_norm(grads)
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
    state's tensors are new, the input state is left as it was.

    Under an :class:`activation_mesh` the state is this rank's slices and
    ``tokens`` its rows (:func:`shard_batch`); the step's grads, global
    norm, update and loss are the global batch's, and its collectives
    count in the plan (:func:`train_plan`)."""
    from ..distributed import collective as _coll

    _check_supported(config)
    plan = train_plan(config, state.params)
    before = collections.Counter(_coll.traffic) if plan is not None else None
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
            l, g = loss_and_grads(state.params, mb, config, loss_function,
                                  _reduce=False)
            loss = loss + l
            tree_map(lambda a, b: a.add_(b.float()), grads, g)
        loss = loss / accum_steps
        grads = tree_map(lambda g: g / accum_steps, grads)
        if plan is not None:
            loss, grads = plan.sum_dp(loss), plan.reduce_grads(grads)
    else:
        loss, grads = loss_and_grads(state.params, tokens, config,
                                     loss_function)

    scale = (clip_norm / (global_norm(grads, plan) + 1e-6)).clamp(max=1.0)
    new_p, new_m, new_n = optimizer_update(
        state.params, grads, state.mu, state.nu, state.step,
        optimizer=optimizer, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
        wd=wd, scale=scale, adafactor_eps2=adafactor_eps2,
        mesh=None if plan is None else plan.mesh,
        specs=None if plan is None else plan.shardings)
    if plan is not None:
        plan.counts.update(collections.Counter(_coll.traffic) - before)
        plan.steps += 1
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


# the host FLOP count the resilient loop's train_mfu reads
# (observability/perf.py train_step_flops)
train_step.flops_per_token = flops_per_token


# ---------------------------------------------------------------------------
# Hugging Face checkpoint interchange
# ---------------------------------------------------------------------------

_HF_LAYER_NAMES = (("input_layernorm.weight", "attn_norm", False),
                   ("self_attn.q_proj.weight", "wq", True),
                   ("self_attn.k_proj.weight", "wk", True),
                   ("self_attn.v_proj.weight", "wv", True),
                   ("self_attn.o_proj.weight", "wo", True),
                   ("post_attention_layernorm.weight", "mlp_norm", False),
                   ("mlp.gate_proj.weight", "w_gate", True),
                   ("mlp.up_proj.weight", "w_up", True),
                   ("mlp.down_proj.weight", "w_down", True))


def convert_hf_state_dict(state_dict, config: LlamaConfig, device="cuda"):
    """A Hugging Face Llama ``state_dict`` (torch tensors or numpy arrays
    keyed ``model.layers.{i}.self_attn.q_proj.weight`` ...) as this
    module's f32 parameter tree on ``device``: projection weights
    transposed (a torch Linear stores [out, in]), layers stacked; HF
    checkpoints already carry the rotate-half RoPE layout this module
    uses, so no head permutation. A tied checkpoint without
    ``lm_head.weight`` gives ``embed.T`` as the head. Raises
    ``ValueError`` on a layer-count or embedding-shape mismatch."""
    c = config
    ckpt_layers = {int(m.group(1)) for k in state_dict
                   for m in [re.match(r"model\.layers\.(\d+)\.", str(k))]
                   if m}
    if ckpt_layers and max(ckpt_layers) + 1 != c.num_layers:
        raise ValueError(
            f"checkpoint has {max(ckpt_layers) + 1} layers but "
            f"config.num_layers={c.num_layers} — a truncated load would "
            "silently produce garbage")
    dev = resolve_device(device)

    def arr(name):
        v = state_dict[name]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, dtype=np.float32))
        return v.detach().to(device=dev, dtype=torch.float32)

    def stacked(fmt, transpose=True):
        mats = [arr(fmt.format(i=i)) for i in range(c.num_layers)]
        return torch.stack([m.t() for m in mats] if transpose else mats)

    embed = arr("model.embed_tokens.weight")
    if tuple(embed.shape) != (c.vocab_size, c.hidden_size):
        raise ValueError(
            f"checkpoint embed {tuple(embed.shape)} vs config "
            f"(vocab={c.vocab_size}, hidden={c.hidden_size})")
    params = {
        "embed": embed,
        "layers": {ours: stacked(f"model.layers.{{i}}.{hf}", transpose)
                   for hf, ours, transpose in _HF_LAYER_NAMES},
        "final_norm": arr("model.norm.weight"),
    }
    if not c.tie_embeddings:
        key = ("lm_head.weight" if "lm_head.weight" in state_dict
               else "model.embed_tokens.weight")  # tied checkpoints
        params["lm_head"] = arr(key).t().contiguous()
    return params


def export_for_inference(*args, **kwargs):
    raise NotImplementedError(
        "export_for_inference writes the jit artifact format (paddle.jit."
        "save), which is not ported yet (ROADMAP A11)")


def to_hf_state_dict(params, config: LlamaConfig):
    """The inverse of :func:`convert_hf_state_dict`: numpy arrays under HF
    names (bf16 leaves widened to f32, exactly)."""
    c = config

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {"model.embed_tokens.weight": host(params["embed"]),
           "model.norm.weight": host(params["final_norm"])}
    lay = params["layers"]
    for i in range(c.num_layers):
        for hf, ours, transpose in _HF_LAYER_NAMES:
            m = host(lay[ours][i])
            out[f"model.layers.{i}.{hf}"] = m.T if transpose else m
    if not c.tie_embeddings:
        out["lm_head.weight"] = host(params["lm_head"]).T
    return out
