"""Persistent decode megakernel (B5) — the port of
paddle_tpu/kernels/mega_decode: the single-step form and the multi-step
(speculative draft) form.

:func:`mega_decode_step` runs ONE decode step through all L layers in one
launch: per layer RMSNorm, q/k/v, rotate-half RoPE at ``lens``, the
step's fresh K/V row appended to the in-call ring at index ``t``, the
true-length walk over each slot's pool prefix (``walk_lens``, block table
read on the device) merged with the ring positions ``j <= t`` by the
flash-decoding combine, ``wo`` and the residual, then RMSNorm, SiLU(gate)
* up and ``w_down`` with the residual. The caller owns the epilogue
(final norm, head, sampling) and the ring -> pool writeback, shared with
the ragged path (``serving/engine._paged_decode``).

- On CUDA tensors it launches the hand-written persistent kernel
  (``csrc/mega_decode.cuh``, instantiated in ``csrc/mega_decode_*.cu``,
  entry points in ``csrc/mega_decode.cu``: a cooperative grid of one
  warp-specialised block an SM whose producer streams the weights by TMA
  through a ring of shared-memory stages, ahead of the consumers' five
  grid-wide barriers a layer, on a static schedule: :func:`schedule`) and
  raises on any failure.
- On CPU tensors it runs the plain version :func:`mega_decode_step_plain`:
  :func:`decode_layers`, the ragged path's per-layer math for one step,
  with the plain ragged partial.

:func:`mega_supported` is the engine's counted-fallback screen: the CUDA
kernel's own limits (dtype, head_dim, GQA group, slot count, widths,
shared memory per block) in place of the JAX kernel's VMEM envelope.

int8, each form on its own or both: int8 weight-only leaves
``{"q": int8 [L, K, M], "s": bf16 [L, M]}`` (``llama.quantize_params``)
for all seven matrices, whose per-output-channel scale multiplies each
column's complete f32 sum before it rounds to the model dtype; int8 pools
with f32 scale pools ``ks_pool``/``vs_pool`` [L, NB, BS, Hkv], walked as
the ragged kernel walks them. The in-call ring stays in the model dtype.

The multi-step form :func:`mega_decode_loop` (the speculative draft
wave): ``n_steps`` greedy steps of every layer in ONE launch, each ending
in the final norm, the head (dense, tied to ``embed`` or int8) with the
argmax of its logits rounded to the model dtype (the first maximum wins),
the rows' bookkeeping (last token, length, done, budget) and the
embedding gather of the next input row. On CUDA tensors it launches the
kernel's multi-step instantiations (``csrc/mega_decode_multi_*.cu``, the
entry ``ptt_mega_decode_loop``); on CPU tensors it runs
:func:`mega_decode_loop_plain`. ``mega_supported(multi_step=True)`` is
its screen.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..distributed.mesh import axis_size
from .paged_attention import ragged_decode_partial, ragged_decode_partial_plain
from .quant_matmul import is_quantized_weight
from .quant_matmul import weight_only_matmul as _wo_mm
from ..models.llama import LAYER_KEYS, _rms_norm, _rotate, head_weight

__all__ = ["mega_supported", "mega_decode_step", "mega_decode_step_plain",
           "mega_decode_loop", "mega_decode_loop_plain", "decode_layers",
           "schedule", "MAX_SLOTS"]

NEG_INF = -1e30
_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# limits fixed by csrc/mega_decode.cuh (kept equal to its constants)
MAX_SLOTS = 8             # input rows of a product (wgmma's n = 8)
MAX_GROUP = 8             # query heads per kv head (one warp each)
WIDTH_MULTIPLE = 32       # hidden and ffn widths, a column head's vocab
MAX_HEAD_HIDDEN = 4096    # the multi-step form's hidden width, at most
_STAGE_BYTES = 16384      # a stage of the weight ring: 4 boxes x 32 rows
_MAX_STAGES = 16
_XS_ROWS = 2048           # input rows staged in shared memory at once
_SLOTS = 512              # output columns of a tile, at most
_MAX_PARTS = 8            # parts one (slot, kv head) walk splits into
_MISC_BYTES = 5632
_WALK_FLAGS = 16 + 160 + 2 * 512 * 8   # the walk flags' offset in `count`
_ALIGN = 1024
_WALK_TILE, _WALK_STAGES = 32, 4   # B5's walk: four 32-position stages
SMEM_LIMIT = 232448       # shared memory a block may use on the H100
_HEAD_MODES = {"dense": 0, "tied": 1, "int8": 2}   # csrc HeadMode


def _walk_smem(row_bytes: int, scale_bytes: int, D: int) -> int:
    """The walk's staging: K and V tiles of ``row_bytes`` rows (padded by
    16 bytes) and, for int8 pools, the positions' K and V scales, four
    stages, then the group's f32 queries."""
    return (_WALK_STAGES * (2 * _WALK_TILE * (row_bytes + 16)
                            + 2 * _WALK_TILE * scale_bytes)
            + MAX_GROUP * D * 4)


def _smem_layout(itemsize: int, D: int, n_slots: int):
    """(ring stages, dynamic shared memory of one block) as
    csrc/mega_decode.cuh ``Smem`` lays them out: the weight ring, then a
    region that holds either the GEMVs' staged input rows (bf16: 8 rows
    padded for wgmma; f32: the 4 or 8 rows of the instantiation) and a
    tile's f32 sums, or the attention walk's staging over pools of the
    model dtype or int8 pools (the kernel takes either at run time), then
    the mbarriers, norm factors and RoPE table. The ring takes what is
    left of the card's 227 KB, at most 16 stages."""
    ns = 4 if n_slots <= 4 else 8
    walk = max(_walk_smem(D * itemsize, 0, D), _walk_smem(D, 4, D))
    xs = 8 * _XS_ROWS * 2 if itemsize == 2 else ns * _XS_ROWS * 4
    region = -(-max(walk, xs + _SLOTS * 8 * 4) // 128) * 128
    stages = min(_MAX_STAGES, (SMEM_LIMIT - _ALIGN - region - _MISC_BYTES)
                 // _STAGE_BYTES)
    return stages, _ALIGN + stages * _STAGE_BYTES + region + _MISC_BYTES


def _smem_bytes(itemsize: int, D: int, n_slots: int) -> int:
    """Dynamic shared memory of one block (:func:`_smem_layout`)."""
    return _smem_layout(itemsize, D, n_slots)[1]


def schedule(config, n_blocks: int, w_int8: bool = False,
             head: str = None):
    """The static schedule the kernel runs on a grid of ``n_blocks``
    blocks, as its own code computes it (``ptt_mega_decode_schedule``,
    the function its producer and consumers call; needs the built
    library): for each of one layer's products ``qkv``, ``wo``,
    ``gate_up`` and ``down`` (and, with ``head`` one of ``"dense"``,
    ``"tied"``, ``"int8"``, the multi-step form's head) its tiles, units
    a tile (one 16 KB ring stage each), units, the most units one block
    takes (block b takes units [b U / G, (b + 1) U / G)) and the
    imbalance, that most over the mean."""
    c = config
    fn = _build.kernel("ptt_mega_decode_schedule",
                       [ctypes.c_int] * 10 + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 20)()
    _build.check(fn(_DTYPES[c.dtype], int(w_int8), c.hidden_size,
                    c.intermediate_size, c.num_kv_heads,
                    c.num_heads // c.num_kv_heads, c.head_dim,
                    c.vocab_size, -1 if head is None else _HEAD_MODES[head],
                    n_blocks, out), "mega_decode schedule")
    names = ["qkv", "wo", "gate_up", "down"] + (["head"] if head else [])
    res = {}
    for i, name in enumerate(names):
        tiles, upt, units, most = out[4 * i:4 * i + 4]
        res[name] = {"tiles": tiles, "units_a_tile": upt, "units": units,
                     "max_units": most,
                     "imbalance": most * n_blocks / units if units else None}
    return res


def _head_mode(params, config) -> str:
    """The output head's form: ``"tied"`` (``embed`` is the head),
    ``"int8"`` (an int8 weight-only ``lm_head``) or ``"dense"``."""
    if config.tie_embeddings:
        return "tied"
    return "int8" if is_quantized_weight(params.get("lm_head")) else "dense"


def _head_ok(params, config):
    """(ok, reason) of the multi-step form's epilogue: the embedding (the
    next input rows, and the tied head) in the model dtype; a dense head
    [h, V] in the model dtype or an int8 one with bf16 [V] scales
    (``"head_dtype"``); the head's input rows within the GEMVs' staging
    and a column head's V a multiple of the 32-column tile
    (``"head_width"``)."""
    dt, h, V = config.dtype, config.hidden_size, config.vocab_size
    emb = params["embed"]
    if emb.dtype != dt or tuple(emb.shape) != (V, h) \
            or params["final_norm"].dtype != dt:
        return False, "head_dtype"
    mode = _head_mode(params, config)
    if mode == "dense":
        head = params["lm_head"]
        if head.dtype != dt or tuple(head.shape) != (h, V):
            return False, "head_dtype"
    elif mode == "int8":
        head = params["lm_head"]
        if head["q"].dtype != torch.int8 or tuple(head["q"].shape) != (h, V) \
                or head["s"].dtype != torch.bfloat16 \
                or tuple(head["s"].shape) != (V,):
            return False, "head_dtype"
    if h > MAX_HEAD_HIDDEN or (mode != "tied" and V % WIDTH_MULTIPLE):
        return False, "head_width"
    return True, "ok"


def mega_supported(params, config, *, n_slots: int, n_steps: int,
                   block_size: int, kv_int8: bool, multi_step: bool = False,
                   mesh=None):
    """(ok, reason) eligibility screen for the mega decode kernel — the
    engine's counted-fallback gate (``LLMEngine.mega_fallbacks``; the
    speculative draft's refusals count as ``"draft_<reason>"``). The
    reasons: ``"mesh"`` (a tensor-parallel mesh: one fused launch cannot
    be sharded), ``"mixed_weights"`` (some weights int8, some not), and
    the CUDA kernel's limits: ``"dtype"`` (bf16 or f32; every dense layer
    weight in the model dtype, every int8 leaf an int8 matrix with bf16
    scales), ``"head_dim"`` (64 or 128), ``"group"`` (at most 8 query
    heads per kv head), ``"slots"`` (1 to 8 rows), ``"width"`` (hidden
    and ffn widths multiples of 32) and ``"smem"`` (a block's shared
    memory, with a ring of at least 2 stages, within the card's 227 KB,
    without which no co-resident grid can launch). int8 weights and int8
    pools (``kv_int8``) are taken, each on its own or both. ``multi_step``
    screens the multi-step form (:func:`mega_decode_loop`) as well: its
    head and embedding (``"head_dtype"``, ``"head_width"``: see
    :func:`_head_ok`) and at least one step."""
    if axis_size(mesh, "tp") > 1:
        return False, "mesh"
    lay = params["layers"]
    quant = [is_quantized_weight(lay[k]) for k in _MATS]
    if any(quant) and not all(quant):
        return False, "mixed_weights"
    dt = config.dtype

    def leaf_ok(k):
        w = lay[k]
        if is_quantized_weight(w):
            return w["q"].dtype == torch.int8 \
                and w["s"].dtype == torch.bfloat16
        return w.dtype == dt
    if dt not in _DTYPES or not all(leaf_ok(k) for k in LAYER_KEYS):
        return False, "dtype"
    D = config.head_dim
    if D not in (64, 128):
        return False, "head_dim"
    if config.num_heads % config.num_kv_heads \
            or config.num_heads // config.num_kv_heads > MAX_GROUP:
        return False, "group"
    if not 1 <= n_slots <= MAX_SLOTS:
        return False, "slots"
    if config.hidden_size % WIDTH_MULTIPLE \
            or config.intermediate_size % WIDTH_MULTIPLE:
        return False, "width"
    itemsize = torch.empty((), dtype=dt).element_size()
    stages, smem = _smem_layout(itemsize, D, n_slots)
    if stages < 2 or smem > SMEM_LIMIT:
        return False, "smem"
    if multi_step:
        if n_steps < 1:
            return False, "steps"
        return _head_ok(params, config)
    return True, "ok"


# ---------------------------------------------------------------------------
# the plain version: the ragged path's per-layer math for one step
# ---------------------------------------------------------------------------
def _layer(params, l):
    """Layer l's weights (both tensors of an int8 leaf sliced)."""
    def at(w):
        return {kk: v[l] for kk, v in w.items()} if isinstance(w, dict) \
            else w[l]
    return {k: at(params["layers"][k]) for k in LAYER_KEYS}


def _mlp(x, p, c, tp=None):
    """The residual FFN block. Under tensor parallelism (``tp``, a
    ``models.llama.TPPlan``) the weights are this rank's columns of
    ``w_gate``/``w_up`` and rows of ``w_down``, and the down projection's
    partial sums meet in an all-reduce before the residual add."""
    dt = c.dtype
    hn = _rms_norm(x, p["mlp_norm"], c.rms_eps)
    gate = torch.nn.functional.silu(_wo_mm(hn, p["w_gate"], dt))
    y = _wo_mm(gate * _wo_mm(hn, p["w_up"], dt), p["w_down"], dt)
    return x + (y if tp is None else tp.mlp_out(y))


def _wo(att, p, dt, tp=None):
    """The attention output projection; under ``tp`` this rank's heads'
    rows of ``wo``, all-reduced."""
    y = _wo_mm(att, p["wo"], dt)
    return y if tp is None else tp.reduce(y)


def _rope1(t, ang):
    """Rotate-half RoPE of one position per row: t [N, H, D], ang [N, D/2]
    f32 angles (cos/sin cast to t's dtype before the multiply)."""
    return _rotate(t, torch.cos(ang)[:, None, :].to(t.dtype),
                   torch.sin(ang)[:, None, :].to(t.dtype))


def decode_layers(params, config, x, *, t: int, lens, block_table,
                  walk_lens, ring_k, ring_v, k_pool, v_pool, ks_pool=None,
                  vs_pool=None, partial=ragged_decode_partial, tp=None):
    """One decode step of every layer for x [N, h] (model dtype), the
    ragged path's math: per layer the fresh K/V row lands in ``ring_k``/
    ``ring_v`` [L, N, S, Hkv, D] at index ``t`` (in place), ``partial``
    walks each slot's pool prefix at ``walk_lens`` and its partial softmax
    state merges with the ring positions ``j <= t`` — one softmax over
    [prefix ; ring]. RoPE angles come from ``lens`` (f32). Weights may be
    int8 leaves (``weight_only_matmul``) and the pools int8 with their
    scale pools ``ks_pool``/``vs_pool``; the ring stays in the model
    dtype. Returns the post-layer-stack hidden state [N, h].

    Tensor parallelism (``tp``, a ``models.llama.TPPlan``): ``config`` is
    the rank's own (its head and FFN counts), the weights, rings and pools
    hold its heads, ``partial`` runs B4's tp form on the plan's mesh, and
    the plan all-reduces after ``wo`` and ``w_down``."""
    c = config
    dt = c.dtype
    N = x.shape[0]
    S = ring_k.shape[2]
    Hkv, D = c.num_kv_heads, c.head_dim
    G = c.num_heads // Hkv
    scale = 1.0 / math.sqrt(D)
    freq = c.rope_theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D)
    ang = lens.float()[:, None] * freq[None, :]
    ring_live = (torch.arange(S, device=x.device) <= t)[None, None, None, :]
    for l in range(c.num_layers):
        p = _layer(params, l)
        hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
        q = _rope1(_wo_mm(hn, p["wq"], dt).reshape(N, Hkv * G, D), ang)
        kk = _rope1(_wo_mm(hn, p["wk"], dt).reshape(N, Hkv, D), ang)
        vv = _wo_mm(hn, p["wv"], dt).reshape(N, Hkv, D)
        ring_k[l, :, t] = kk
        ring_v[l, :, t] = vv
        qg = q.reshape(N, Hkv, G, D).float()
        s_rng = torch.einsum("nhgd,nshd->nhgs", qg,
                             ring_k[l].float()) * scale
        s_rng = torch.where(ring_live, s_rng, torch.full_like(s_rng, NEG_INF))
        acc_p, m_p, l_p = partial(q, k_pool, v_pool, block_table, walk_lens,
                                  layer=l, ks_pool=ks_pool, vs_pool=vs_pool,
                                  **({} if tp is None else {"mesh": tp.mesh}))
        # the ring always holds >= 1 live position, so l_tot >= 1
        m_tot = torch.maximum(m_p, s_rng.amax(dim=-1))
        corr = torch.exp(m_p - m_tot)
        p_rng = torch.exp(s_rng - m_tot[..., None])
        l_tot = l_p * corr + p_rng.sum(dim=-1)
        acc = acc_p * corr[..., None] + torch.einsum(
            "nhgs,nshd->nhgd", p_rng, ring_v[l].float())
        att = (acc / l_tot[..., None]).reshape(N, Hkv * G * D).to(dt)
        x = _mlp(x + _wo(att, p, dt, tp), p, c, tp)
    return x


def mega_decode_step_plain(params, config, *, x0, t: int, block_table,
                           walk_lens, lens, ring_k, ring_v, k_pool, v_pool,
                           ks_pool=None, vs_pool=None):
    """The plain PyTorch version of :func:`mega_decode_step`:
    :func:`decode_layers` with the plain ragged partial."""
    x = decode_layers(params, config, x0.to(config.dtype), t=t, lens=lens,
                      block_table=block_table, walk_lens=walk_lens,
                      ring_k=ring_k, ring_v=ring_v, k_pool=k_pool,
                      v_pool=v_pool, ks_pool=ks_pool, vs_pool=vs_pool,
                      partial=ragged_decode_partial_plain)
    return x, ring_k, ring_v


def mega_decode_loop_plain(params, config, *, x0, n_steps: int, block_table,
                           walk_lens, lens, active, last0, budgets, eos_ids,
                           ring_k, ring_v, k_pool, v_pool, ks_pool=None,
                           vs_pool=None):
    """The plain PyTorch version of :func:`mega_decode_loop`: per step
    :func:`decode_layers` (ring row t = step, RoPE at the current lengths),
    the final norm, the head product rounded to the model dtype, the
    argmax (the first maximum wins), then the bookkeeping — a row decodes
    while active and not done, emits its token (-1 otherwise), advances
    its length, spends its budget and is done at its eos or with its
    budget spent — and ``embed[last]`` as the next input rows."""
    c = config
    dt = c.dtype
    head_w = head_weight(params, c)
    x = x0.to(dt)
    last, lens, rem = last0.clone(), lens.clone(), budgets.clone()
    done = torch.zeros_like(active, dtype=torch.bool)
    emitted = []
    for t in range(n_steps):
        x = decode_layers(params, c, x, t=t, lens=lens,
                          block_table=block_table, walk_lens=walk_lens,
                          ring_k=ring_k, ring_v=ring_v, k_pool=k_pool,
                          v_pool=v_pool, ks_pool=ks_pool, vs_pool=vs_pool,
                          partial=ragged_decode_partial_plain)
        xf = _rms_norm(x, params["final_norm"], c.rms_eps)
        nxt = _wo_mm(xf, head_w, dt).float().argmax(dim=-1).to(last.dtype)
        act = active & ~done
        emitted.append(torch.where(act, nxt, torch.full_like(nxt, -1)))
        lens = lens + act.to(lens.dtype)
        rem = rem - act.to(rem.dtype)
        done = done | (act & (eos_ids >= 0) & (nxt == eos_ids)) \
            | (act & (rem <= 0))
        last = torch.where(act, nxt, last)
        x = params["embed"][last.long()].to(dt)
    return torch.stack(emitted), last, lens, done, rem, ring_k, ring_v


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------
_freqs = {}


def _rope_freq(theta: float, D: int, device) -> torch.Tensor:
    """RoPE inverse frequencies [D/2] f32 on ``device``, computed as the
    plain version computes them, once per (theta, D, device)."""
    key = (theta, D, device)
    if key not in _freqs:
        _freqs[key] = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                              device=device) / D)
    return _freqs[key]


def _buffers(config, x0):
    """The kernel's hidden state — a copy of x0 in the model dtype, which
    it updates in place — and its scratch: q/k/v, the attention output,
    gate*up, the f32 sums of split tiles (a 512-column slot of 8 rows a
    block, one block an SM) and of the walks' parts, and the flags (zero):
    the grid barrier's arrivals, then one a block and one a walk part."""
    c = config
    dt, dev = c.dtype, x0.device
    N, h = x0.shape
    Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    F = c.intermediate_size
    G = Hq // Hkv
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    part = max(blocks * _SLOTS * 8, N * Hkv * _MAX_PARTS * G * (D + 2))
    return (x0.to(dt).clone(),
            torch.empty((N, (Hq + 2 * Hkv) * D), dtype=dt, device=dev),
            torch.empty((N, Hq * D), dtype=dt, device=dev),
            torch.empty((N, F), dtype=dt, device=dev),
            torch.empty((part,), dtype=torch.float32, device=dev),
            torch.zeros((_WALK_FLAGS + N * Hkv * _MAX_PARTS,),
                        dtype=torch.int32, device=dev))


def _weight_ptrs(params):
    """The layer weights as the kernel's arguments: the two norms, the
    seven matrices and their seven scales (null for dense weights); and
    whether the weights are int8."""
    lay = params["layers"]
    w_int8 = is_quantized_weight(lay["wq"])
    P, null = _build.ptr, ctypes.c_void_p(0)
    return ([P(lay["attn_norm"]), P(lay["mlp_norm"])]
            + [P(lay[k]["q"] if w_int8 else lay[k]) for k in _MATS]
            + [P(lay[k]["s"]) if w_int8 else null for k in _MATS]), w_int8


def _check_cuda(params, config, x0, t, block_table, walk_lens, lens, ring_k,
                ring_v, k_pool, v_pool, ks_pool, vs_pool, multi_step=False):
    c = config
    N, h = x0.shape
    kv_int8 = k_pool.dtype == torch.int8
    fn_name = "mega_decode_loop" if multi_step else "mega_decode_step"
    ok, reason = mega_supported(params, c, n_slots=N,
                                n_steps=ring_k.shape[2],
                                block_size=k_pool.shape[2], kv_int8=kv_int8,
                                multi_step=multi_step)
    if not ok:
        raise ValueError(f"{fn_name}: the kernel does not take this "
                         f"model or batch (reason {reason!r}); the engine "
                         "screens with mega_supported first")
    dev = x0.device
    lay = params["layers"]
    named = [("x0", x0), ("block_table", block_table),
             ("walk_lens", walk_lens), ("lens", lens), ("ring_k", ring_k),
             ("ring_v", ring_v), ("k_pool", k_pool), ("v_pool", v_pool)]
    for k in LAYER_KEYS:
        w = lay[k]
        named += ([(k + ".q", w["q"]), (k + ".s", w["s"])]
                  if is_quantized_weight(w) else [(k, w)])
    if kv_int8:
        if ks_pool is None or vs_pool is None:
            raise ValueError(f"{fn_name}: int8 pools require "
                             "ks_pool/vs_pool scales")
        named += [("ks_pool", ks_pool), ("vs_pool", vs_pool)]
    for name, tns in named:
        if tns.device != dev:
            raise ValueError(f"{fn_name}: {name} on {tns.device}, x0 "
                             f"on {dev}")
        if not tns.is_contiguous():
            raise ValueError(f"{fn_name}: {name} is not contiguous")
    L, Hkv, D = c.num_layers, c.num_kv_heads, c.head_dim
    Hq, F = c.num_heads, c.intermediate_size
    want = {"attn_norm": (L, h), "mlp_norm": (L, h), "wq": (L, h, Hq * D),
            "wk": (L, h, Hkv * D), "wv": (L, h, Hkv * D),
            "wo": (L, Hq * D, h), "w_gate": (L, h, F), "w_up": (L, h, F),
            "w_down": (L, F, h)}
    for k, shape in want.items():
        w = lay[k]
        got = tuple((w["q"] if is_quantized_weight(w) else w).shape)
        if got != shape or (is_quantized_weight(w) and tuple(w["s"].shape)
                            != (shape[0], shape[2])):
            raise ValueError(f"{fn_name}: layers.{k} is {got}, "
                             f"expected {shape}")
    S = ring_k.shape[2]
    if h != c.hidden_size or tuple(ring_k.shape) != (L, N, S, Hkv, D) \
            or ring_v.shape != ring_k.shape:
        raise ValueError(f"{fn_name}: x0 {tuple(x0.shape)} and rings "
                         f"{tuple(ring_k.shape)} do not match the config")
    if k_pool.dim() != 5 or tuple(k_pool.shape[::4]) != (L, D) \
            or k_pool.shape[3] != Hkv or v_pool.shape != k_pool.shape:
        raise ValueError(f"{fn_name}: pools {tuple(k_pool.shape)} are "
                         "not [L, NB, BS, Hkv, D]")
    pool_dt = torch.int8 if kv_int8 else c.dtype
    for name, tns, want_dt in (("x0", x0, c.dtype), ("ring_k", ring_k, c.dtype),
                               ("ring_v", ring_v, c.dtype),
                               ("k_pool", k_pool, pool_dt),
                               ("v_pool", v_pool, pool_dt)):
        if tns.dtype != want_dt:
            raise TypeError(f"{fn_name}: {name} is {tns.dtype}, "
                            f"expected {want_dt}")
    if kv_int8 and (ks_pool.dtype != torch.float32 or tuple(ks_pool.shape)
                    != tuple(k_pool.shape[:4])
                    or vs_pool.shape != ks_pool.shape
                    or vs_pool.dtype != torch.float32):
        raise ValueError(f"{fn_name}: scale pools must be f32 "
                         f"{tuple(k_pool.shape[:4])}")
    if block_table.dtype != torch.int32 or block_table.dim() != 2 \
            or block_table.shape[0] != N:
        raise ValueError("block_table must be int32 [N, MB]")
    for name, tns in (("walk_lens", walk_lens), ("lens", lens)):
        if tns.dtype != torch.int32 or tuple(tns.shape) != (N,):
            raise ValueError(f"{name} must be int32 [N]")
    if not 0 <= t < S:
        raise ValueError(f"step index t={t} outside the ring's {S} steps")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{fn_name} copies pool rows 16 bytes at a "
                         "time: the pools must be 16-byte aligned")


def mega_decode_step(params, config, *, x0, t: int, block_table, walk_lens,
                     lens, ring_k, ring_v, k_pool, v_pool, ks_pool=None,
                     vs_pool=None):
    """ONE decode step of all layers in one launch: hidden state x0
    [N, hidden] -> the post-layer-stack hidden state [N, hidden] (model
    dtype), with the step's K/V rows written into ``ring_k``/``ring_v``
    [L, N, S, Hkv, D] at index ``t`` (in place; both are returned).
    ``lens`` [N] int32 are the rows' current lengths (the RoPE position);
    ``walk_lens`` [N] int32 the frozen pool prefixes the walk reads
    through ``block_table`` [N, MB] int32 from pools [L, NB, BS, Hkv, D]
    (int8 with f32 scale pools ``ks_pool``/``vs_pool`` [L, NB, BS, Hkv]).
    Weights may be int8 leaves. Launches the CUDA kernel (``csrc/mega_decode*``) on CUDA
    tensors (or raises), runs :func:`mega_decode_step_plain` on CPU
    tensors."""
    if x0.device.type == "cpu":
        return mega_decode_step_plain(
            params, config, x0=x0, t=t, block_table=block_table,
            walk_lens=walk_lens, lens=lens, ring_k=ring_k, ring_v=ring_v,
            k_pool=k_pool, v_pool=v_pool, ks_pool=ks_pool, vs_pool=vs_pool)
    if x0.device.type != "cuda":
        raise ValueError(f"mega_decode_step: unsupported device {x0.device}")
    fn = _build.kernel("ptt_mega_decode", [ctypes.c_void_p] * 32
                       + [ctypes.c_int] * 15
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    _check_cuda(params, config, x0, t, block_table, walk_lens, lens, ring_k,
                ring_v, k_pool, v_pool, ks_pool, vs_pool)
    c = config
    N, h = x0.shape
    Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    bufs = _buffers(c, x0)
    x = bufs[0]
    weights, w_int8 = _weight_ptrs(params)
    P = _build.ptr
    null = ctypes.c_void_p(0)
    kv_int8 = k_pool.dtype == torch.int8
    with torch.cuda.device(x.device):
        err = fn(*weights, P(_rope_freq(c.rope_theta, D, x.device)),
                 P(block_table), P(walk_lens), P(lens), P(k_pool),
                 P(v_pool), P(ks_pool) if kv_int8 else null,
                 P(vs_pool) if kv_int8 else null, P(ring_k), P(ring_v),
                 *(P(b) for b in bufs),
                 c.num_layers, N, h, c.intermediate_size, Hkv, Hq // Hkv, D,
                 k_pool.shape[1], k_pool.shape[2], block_table.shape[1],
                 ring_k.shape[2], int(t), _DTYPES[c.dtype], int(w_int8),
                 int(kv_int8), c.rms_eps, 1.0 / math.sqrt(D),
                 _build.stream_handle(x))
    name = "mega_decode_int8" if w_int8 or kv_int8 else "mega_decode"
    _build.check(err, name)
    _build.count_launch(name)
    return x, ring_k, ring_v


def mega_decode_loop(params, config, *, x0, n_steps: int, block_table,
                     walk_lens, lens, active, last0, budgets, eos_ids, ring_k,
                     ring_v, k_pool, v_pool, ks_pool=None, vs_pool=None):
    """``n_steps`` greedy decode steps of all layers in ONE launch — the
    speculative draft wave. ``x0`` [N, h] is ``embed[last0]``; step s
    writes ring row s of ``ring_k``/``ring_v`` [L, N, S >= n_steps, Hkv,
    D] (in place) and takes RoPE at the rows' current lengths (``lens``
    [N] int32, advanced in the kernel); the walk reads the frozen pool
    prefixes ``walk_lens`` as :func:`mega_decode_step` does. After each
    step's last layer: the final norm, the head (dense, tied or int8 —
    :func:`_head_mode`) and its argmax over logits rounded to the model
    dtype, and the bookkeeping of ``active``, ``budgets`` and ``eos_ids``
    [N] int32 (-1: none); every row starts not done. Returns (emitted
    [n_steps, N] int32 with -1 padding, last, lens, done (bool), budgets,
    ring_k, ring_v). Launches the CUDA kernel on CUDA tensors (or
    raises), runs :func:`mega_decode_loop_plain` on CPU tensors."""
    kw = dict(x0=x0, n_steps=n_steps, block_table=block_table,
              walk_lens=walk_lens, lens=lens, active=active, last0=last0,
              budgets=budgets, eos_ids=eos_ids, ring_k=ring_k, ring_v=ring_v,
              k_pool=k_pool, v_pool=v_pool, ks_pool=ks_pool, vs_pool=vs_pool)
    if x0.device.type == "cpu":
        return mega_decode_loop_plain(params, config, **kw)
    if x0.device.type != "cuda":
        raise ValueError(f"mega_decode_loop: unsupported device {x0.device}")
    c = config
    _check_cuda(params, c, x0, 0, block_table, walk_lens, lens, ring_k,
                ring_v, k_pool, v_pool, ks_pool, vs_pool, multi_step=True)
    N, h = x0.shape
    for name, tns in (("active", active), ("last0", last0),
                      ("budgets", budgets), ("eos_ids", eos_ids)):
        if tns.device != x0.device or tuple(tns.shape) != (N,) \
                or tns.dtype not in (torch.int32, torch.int64, torch.bool):
            raise ValueError(f"mega_decode_loop: {name} must be an integer "
                             f"[{N}] tensor on {x0.device}")
    if not 1 <= n_steps <= ring_k.shape[2]:
        raise ValueError(f"mega_decode_loop: {n_steps} steps do not fit the "
                         f"ring's {ring_k.shape[2]} rows")
    fn = _build.kernel("ptt_mega_decode_loop", [ctypes.c_void_p] * 41
                       + [ctypes.c_int] * 18
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    dev = x0.device
    bufs = _buffers(c, x0)
    weights, w_int8 = _weight_ptrs(params)
    # the rows' state [last, lens, done, budget] and the blocks' head picks
    state = torch.stack([last0.int(), lens.int(), torch.zeros_like(lens.int()),
                         budgets.int()]).contiguous()
    act = active.int().contiguous()
    eos = eos_ids.int().contiguous()
    emitted = torch.empty((n_steps, N), dtype=torch.int32, device=dev)
    hcap = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    hmax = torch.empty((hcap, N), dtype=torch.float32, device=dev)
    hidx = torch.empty((hcap, N), dtype=torch.int32, device=dev)
    mode = _head_mode(params, c)
    head = params.get("lm_head")
    P = _build.ptr
    null = ctypes.c_void_p(0)
    kv_int8 = k_pool.dtype == torch.int8
    with torch.cuda.device(dev):
        err = fn(*weights, P(_rope_freq(c.rope_theta, D, dev)),
                 P(block_table), P(walk_lens), P(k_pool), P(v_pool),
                 P(ks_pool) if kv_int8 else null,
                 P(vs_pool) if kv_int8 else null, P(ring_k), P(ring_v),
                 *(P(b) for b in bufs), P(params["final_norm"]),
                 P(params["embed"]),
                 null if mode == "tied" else P(head["q"] if mode == "int8"
                                               else head),
                 P(head["s"]) if mode == "int8" else null,
                 P(act), P(eos), P(state), P(emitted), P(hmax), P(hidx),
                 c.num_layers, N, h, c.intermediate_size, Hkv, Hq // Hkv, D,
                 k_pool.shape[1], k_pool.shape[2], block_table.shape[1],
                 ring_k.shape[2], int(n_steps), c.vocab_size,
                 _HEAD_MODES[mode], hcap, _DTYPES[c.dtype], int(w_int8),
                 int(kv_int8), c.rms_eps, 1.0 / math.sqrt(D),
                 _build.stream_handle(bufs[0]))
    name = "mega_decode_loop_int8" if w_int8 or kv_int8 \
        else "mega_decode_loop"
    _build.check(err, name)
    _build.count_launch(name)
    return (emitted, state[0], state[1], state[2].bool(), state[3], ring_k,
            ring_v)


def blocks_per_sm(dtype, head_dim: int, n_slots: int,
                  w_int8: bool = False) -> int:
    """How many blocks of the mega kernel one SM holds at once for
    ``dtype``, ``head_dim``, ``n_slots`` rows and dense or int8 weights
    (the occupancy the cooperative grid is sized from: this times the SM
    count)."""
    fn = _build.kernel("ptt_mega_decode_blocks_per_sm", [ctypes.c_int] * 4)
    n = fn(_DTYPES[dtype], head_dim, n_slots, int(w_int8))
    if n < 0:
        _build.check(-n, "mega_decode occupancy")
    return n
