"""Continuous-batching paged-KV serving engine — the port of
paddle_tpu/serving/engine.py (greedy/sampled core, ragged and mega
decode, int8, speculative decoding).

Design, as in the JAX engine:

- A fixed batch of ``max_slots`` sequence slots; requests come and go.
  Idle slots write their K/V to the trash block (physical block 0) and
  are masked out of sampling.
- Bucketed prefill: a wave of admissions pads to the smallest prompt
  bucket covering its longest prompt and to ``max_slots`` rows (a single
  admission runs at B=1); K/V land in the slots' pool blocks and each
  request's first token is sampled on the device.
- Ragged decode: ``decode_steps`` tokens per call; per layer the
  hand-written kernel (``kernels.paged_attention.ragged_decode_partial``)
  walks each slot's pool prefix at its true length, and its partial
  softmax state merges with the call's in-flight ring of new K/V by the
  flash-decoding combine. The ring is written back to the pools once, at
  the end of the call.
- Mega decode (``decode_kernel="mega"``, or ``"auto"`` on the card at
  ``max_slots <= 4``): the same math, but each step's whole layer stack is
  ONE launch of the persistent kernel (``kernels.mega_decode``); the
  embedding gather, final norm, head, sampling, bookkeeping and ring
  writeback stay shared with the ragged path. A pick the kernel's screen
  (``mega_supported``) refuses falls back to ragged and is counted in
  ``LLMEngine.mega_fallbacks`` by reason — never silently.
- A host-side block allocator over ``[L, num_blocks, block_size, Hkv, D]``
  pools: admission reserves the prompt's blocks, decode backs the blocks
  the next call can touch, and when the pool runs dry the newest
  admission is preempted and re-queued for a fresh prefill of
  prompt + generated (recompute preemption).
- int8 everywhere (optional): int8 weight-only params
  (``models.llama.quantize_params``) go through
  ``kernels.quant_matmul.weight_only_matmul`` in prefill, the ragged
  decode layers and the head, and through the mega kernel's int8 branch;
  ``kv_dtype="int8"`` keeps the pools as int8 ``{"k", "v"}`` with f32
  per-entry scales ``{"ks", "vs"}`` [L, NB, BS, Hkv]: prefill runs B1 on
  the dense K/V and scatters them quantized, the decode walks read the
  scales, and the in-call ring stays in the model dtype until the
  writeback quantizes it.
- Speculative decoding (optional): with ``draft_params``/``draft_config``
  a greedy decode wave runs draft-then-verify. The draft (a smaller llama
  on the target's vocabulary, its own ``dk``/``dv`` pools on the target's
  block grid, prefilled right behind the target) proposes ``spec_tokens``
  tokens a slot in one call — on the mega path ONE launch of the
  multi-step kernel (``kernels.mega_decode.mega_decode_loop``), else the
  ragged program at draft scale; the target scores all of them in one
  prefill-shaped call (``_spec_verify``); the host commits the agreeing
  prefix plus the target's own token, capped at ``spec_tokens``. The
  streams are the non-speculative greedy streams.

Differences from the JAX engine: PyTorch runs eagerly, so nothing is
compiled and the pools are updated in place rather than donated. Each
decode call ends in one synchronous readback (the JAX engine chains the
next call before reading the previous one); the first tokens of a
prefill wave stay on the device until that readback. The observability
hooks (among them the JAX engine's int8 numerics probes) are not ported.
The spec wave's draft prefill samples greedily (its token is discarded;
the JAX engine draws it with the wave's flags), so a speculating engine
draws the same random numbers for sampled requests as a plain one. The
``serving_spec_*`` metrics wait for the observability port (A8); the
host counters ``spec_*`` are kept. Prefix caching, chunked prefill,
swap/offload, admission control, deadlines, disaggregated roles and
tensor parallelism are not ported yet (ROADMAP queue A), nor the
``"bucketed"`` dense-gather decode; their constructor and request
arguments raise ``NotImplementedError`` naming their queue when set.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.mega_decode import (_layer, _mlp, decode_layers,
                                   mega_decode_loop, mega_decode_step,
                                   mega_supported)
from ..kernels.pallas_attention import flash_attention_fwd
from ..kernels.quant_matmul import is_quantized_weight, quantize_kv
from ..kernels.quant_matmul import weight_only_matmul as _wo_mm
from ..models.llama import (LlamaConfig, _apply_rope, _apply_rope_at,
                            _rms_norm, _rope_tables, head_weight)

__all__ = ["LLMEngine", "Request"]

NEG_INF = -1e30

# JAX constructor arguments not ported yet -> (default, ROADMAP queue)
_UNPORTED = {
    "mesh": (None, "A10"),
    "admission": (None, "A5"), "kv_swap_bytes": (0, "A5"),
    "injector": (None, "A8"), "prefix_cache": (False, "A5"),
    "prefill_chunk": (0, "A5"), "prefix_cache_host_bytes": (0, "A5"),
    "kv_offload": ("auto", "A5"), "role": ("both", "A7"),
    "relay": (None, "A7"),
}


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    # not ported: a latency budget (A5), the admission tenant (A5) and
    # its stamped deadline
    deadline_s: Optional[float] = None
    tenant: str = "default"
    t_deadline: Optional[float] = None
    # tokens generated before a preemption; a re-admission prefills
    # prompt+generated so already-streamed tokens are never re-emitted
    generated: List[int] = dataclasses.field(default_factory=list)
    # not ported: the relay-pool key of disaggregated serving (A7)
    relay_key: Optional[int] = None

    def __post_init__(self):
        for name, default, queue in (("deadline_s", None, "A5"),
                                     ("tenant", "default", "A5"),
                                     ("t_deadline", None, "A5"),
                                     ("relay_key", None, "A7")):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"Request({name}=...) is not ported yet (ROADMAP queue "
                    f"{queue})")


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------
def _filter_logits(logits, temps, top_ks, top_ps, use_top_k=True,
                   use_top_p=True):
    """Temperature-scaled logits with the top-k and top-p masks applied
    (masked entries -1e30). top_k<=0 and top_p>=1 disable a row's mask."""
    N, vocab = logits.shape
    lg = logits / temps.clamp_min(1e-6)[:, None]
    if use_top_k:
        eff_k = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, vocab))
        srt = torch.sort(lg, dim=-1).values                    # ascending
        kth_idx = (vocab - eff_k).clamp(0, vocab - 1).long()
        kth = srt.gather(-1, kth_idx[:, None])
        lg = torch.where(lg < kth, torch.full_like(lg, NEG_INF), lg)
    if use_top_p:
        sort_idx = torch.argsort(-lg, dim=-1, stable=True)
        sort_p = torch.softmax(lg, dim=-1).gather(-1, sort_idx)
        cum = torch.cumsum(sort_p, dim=-1)
        # rows with top_p >= 1 drop nothing: an f32 cumsum can reach 1.0
        # before the tail, which would mask the tail's tiny probabilities
        drop_sorted = (cum - sort_p >= top_ps[:, None]) \
            & (top_ps < 1.0)[:, None]
        drop = torch.zeros_like(drop_sorted).scatter(-1, sort_idx,
                                                     drop_sorted)
        lg = torch.where(drop, torch.full_like(lg, NEG_INF), lg)
    return lg


def _sample_rows(logits, generator, temps, top_ks, top_ps, any_sampled=True,
                 use_top_k=True, use_top_p=True):
    """Per-row sampling over [N, vocab] f32 logits with per-row knobs
    (temps<=0 -> greedy). The three flags prune work the slot mix cannot
    need: an all-greedy batch is a bare argmax. Sampled rows draw by
    Gumbel-max from ``generator``."""
    greedy = logits.argmax(dim=-1)
    if not any_sampled:
        return greedy.int()
    lg = _filter_logits(logits, temps, top_ks, top_ps, use_top_k, use_top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    sampled = (lg + gumbel).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy).int()


def _apply_admissions(c_last, c_len, c_done, c_rem, wave_toks, slot_of_row,
                      lens_new, rems_new, upd_mask):
    """Scatter one prefill wave's device-resident first tokens into the
    decode carry (pad rows carry slot_of_row == N and are dropped)."""
    N = c_last.shape[0]
    scattered = torch.zeros(N + 1, dtype=c_last.dtype, device=c_last.device)
    scattered[slot_of_row.long()] = wave_toks.to(c_last.dtype)
    c_last = torch.where(upd_mask, scattered[:N], c_last)
    c_len = torch.where(upd_mask, lens_new.to(c_len.dtype), c_len)
    c_done = c_done & ~upd_mask
    c_rem = torch.where(upd_mask, rems_new.to(c_rem.dtype), c_rem)
    return c_last, c_len, c_done, c_rem


def _paged_prefill(params, tokens, blk_ids, true_len, pools, temps, top_ks,
                   top_ps, generator, *, config: LlamaConfig,
                   sample_flags=(True, True, True), kv_prefix: str = ""):
    """Prefill a wave of admissions: causal forward over the padded prompt
    batch, each layer's K/V written into the rows' pool blocks (in place;
    pad rows and the bucket's pad tail point at the trash block 0), and
    each row's first token sampled from its last true position.

    tokens [B, S_bucket]; blk_ids [B, S_bucket // bs] int; true_len [B];
    temps/top_ks/top_ps [B]; pools {"k", "v"} [L, NB, bs, Hkv, D], plus
    {"ks", "vs"} [L, NB, bs, Hkv] f32 for int8 pools: attention runs on
    the dense K/V and the pools get them quantized (``quantize_kv``).
    ``kv_prefix="d"`` runs the wave through the speculative draft (its
    params and config) into the draft's ``dk``/``dv`` pools.
    Returns the first tokens [B] int32 (on the device)."""
    c = config
    dt = c.dtype
    B, S = tokens.shape
    bs = pools[kv_prefix + "k"].shape[2]
    Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    flat = blk_ids.reshape(-1).long()
    x = params["embed"][tokens.long()].to(dt)
    cos, sin = _rope_tables(S, D, c.rope_theta, tokens.device)
    for l in range(c.num_layers):
        p = _layer(params, l)
        hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
        q = _apply_rope(_wo_mm(hn, p["wq"], dt).reshape(B, S, Hq, D),
                        cos, sin)
        k = _apply_rope(_wo_mm(hn, p["wk"], dt).reshape(B, S, Hkv, D),
                        cos, sin)
        v = _wo_mm(hn, p["wv"], dt).reshape(B, S, Hkv, D)
        _write_pools(pools, (slice(l, l + 1), flat),
                     k.reshape(1, -1, bs, Hkv, D),
                     v.reshape(1, -1, bs, Hkv, D), kv_prefix)
        att = flash_attention_fwd(q, k, v, causal=True)[0].reshape(
            B, S, Hq * D)
        x = _mlp(x + _wo_mm(att, p["wo"], dt), p, c)
    x = _rms_norm(x, params["final_norm"], c.rms_eps)
    rows = torch.arange(B, device=x.device)
    last_h = x[rows, (true_len.long() - 1).clamp_min(0)]
    logits = _wo_mm(last_h, head_weight(params, c), dt).float()
    return _sample_rows(logits, generator, temps, top_ks, top_ps,
                        *sample_flags)


def _write_pools(pools, index, k, v, prefix: str = ""):
    """pools[prefix + "k"][index] = k and the same for v — quantized, with
    their scales into the "ks"/"vs" entries, when those pools are int8
    (the draft's ``dk``/``dv`` never are)."""
    pk, pv = prefix + "k", prefix + "v"
    if prefix + "ks" in pools:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        pools[pk][index] = qk
        pools[pv][index] = qv
        pools[prefix + "ks"][index] = sk
        pools[prefix + "vs"][index] = sv
    else:
        pools[pk][index] = k.to(pools[pk].dtype)
        pools[pv][index] = v.to(pools[pv].dtype)


def _paged_decode(params, last_tokens, lengths, done0, budgets, generator,
                  active, block_table, pools, temps, top_ks, top_ps, eos_ids,
                  *, config: LlamaConfig, n_steps: int,
                  sample_flags=(True, True, True), mega: bool = False,
                  mega_multistep: bool = False, kv_prefix: str = ""):
    """``n_steps`` decode iterations over all slots.

    The slot prefixes ``[0, lengths)`` are frozen for the call: every step
    and layer the ragged kernel walks them at their true lengths (slots
    outside ``active`` walk zero blocks) and returns its partial softmax
    state, which merges with the call's ring of new K/V by the
    flash-decoding combine — one softmax over [prefix ; ring]. With
    ``mega`` each step's layer stack is one ``mega_decode_step`` launch
    of the same math instead. Slots that hit their eos or budget flip to
    done and emit -1 from then on. The ring (model dtype) holds the
    call's new K/V; its valid entries are written back to the pools (in
    place, quantized for int8 pools) at the end of the call.

    ``kv_prefix="d"`` runs the call as the speculative draft's proposal
    loop (draft params and config, greedy flags, the ``dk``/``dv`` pools).
    ``mega_multistep`` (greedy, ``done0`` all false: the spec wave's
    draft) moves the step loop itself into the kernel: the ``n_steps``
    steps, argmax, bookkeeping and embedding gathers included, are ONE
    ``mega_decode_loop`` launch; the writeback stays shared.

    Returns (emitted [n_steps, N] int32 with -1 padding, last, lengths,
    done, budgets)."""
    c = config
    dt = c.dtype
    Lc, N, S = c.num_layers, block_table.shape[0], n_steps
    pk, pv = kv_prefix + "k", kv_prefix + "v"
    bs = pools[pk].shape[2]
    Hkv, D = c.num_kv_heads, c.head_dim
    P = block_table.shape[1] * bs
    dev = last_tokens.device
    lens0 = lengths
    walk_lens = torch.where(active, lens0, torch.zeros_like(lens0)).int()
    ring_k = torch.zeros((Lc, N, S, Hkv, D), dtype=dt, device=dev)
    ring_v = torch.zeros_like(ring_k)
    last, lens, done, rem = last_tokens, lengths, done0, budgets
    pools_kw = dict(k_pool=pools[pk], v_pool=pools[pv],
                    ks_pool=pools.get(kv_prefix + "ks"),
                    vs_pool=pools.get(kv_prefix + "vs"))
    in_kernel = mega and mega_multistep
    if in_kernel:
        if any(sample_flags):
            raise ValueError("mega_multistep is greedy-only")
        grid, last, lens, done, rem, ring_k, ring_v = mega_decode_loop(
            params, c, x0=params["embed"][last.long()].to(dt), n_steps=S,
            block_table=block_table, walk_lens=walk_lens, lens=lens,
            active=active, last0=last, budgets=rem, eos_ids=eos_ids,
            ring_k=ring_k, ring_v=ring_v, **pools_kw)
        emitted = list(grid)
    else:
        # the head operand, hoisted out of the step loop: the dense weight
        # in dt, or an int8 head's matrix widened to f32 once a call
        # (exact; weight_only_matmul would widen it again every step)
        head_w = head_weight(params, c)
        if is_quantized_weight(head_w):
            head_w = dict(head_w, q=head_w["q"].float())
        else:
            head_w = head_w.to(dt)
        emitted = []
    for t in range(0 if in_kernel else S):
        act = active & ~done
        x0 = params["embed"][last.long()].to(dt)
        # both write the step's K/V rows into the rings in place
        kw = dict(t=t, block_table=block_table, walk_lens=walk_lens,
                  lens=lens, ring_k=ring_k, ring_v=ring_v, **pools_kw)
        x = mega_decode_step(params, c, x0=x0, **kw)[0] if mega \
            else decode_layers(params, c, x0, **kw)
        xf = _rms_norm(x, params["final_norm"], c.rms_eps)
        logits = _wo_mm(xf, head_w, dt).float()
        nxt = _sample_rows(logits, generator, temps, top_ks, top_ps,
                           *sample_flags)
        emitted.append(torch.where(act, nxt, torch.full_like(nxt, -1)))
        lens = lens + act.to(lens.dtype)
        rem = rem - act.to(rem.dtype)
        done = done | (act & (eos_ids >= 0) & (nxt == eos_ids)) \
            | (act & (rem <= 0))
        last = torch.where(act, nxt, last)

    # writeback: the ring's valid entries -> pools (trash block 0 else)
    cnt = lens - lens0
    j = torch.arange(S, device=dev)[None, :]
    valid = (j < cnt[:, None]) & active[:, None]              # [N, S]
    pos = torch.clamp(lens0.long()[:, None] + j, max=P - 1)
    phys = block_table.long().gather(1, pos // bs)
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    off = pos % bs
    _write_pools(pools, (slice(None), phys, off), ring_k, ring_v, kv_prefix)
    return torch.stack(emitted), last, lens, done, rem


def _spec_verify(params, block_table, last, draft_toks, lengths, active,
                 pools, *, config: LlamaConfig, n_spec: int,
                 max_model_len: int):
    """Score a speculative wave in ONE target forward: each slot's piece
    ``[last, d_1 .. d_k]`` (k = ``n_spec``; ``draft_toks`` is the draft
    call's [k, N] grid, -1 pads clipped into the vocabulary) runs a
    prefill-shaped pass against the slot's resident K/V — the history
    gathered densely through ``block_table`` [N, nbk] (a power-of-two
    bucket covering history plus the piece), RoPE at ``lengths`` + j, one
    softmax over [masked history ; causal piece] — and the target's
    greedy token at each of the k+1 positions comes back: ``out[n, j]`` is
    what the target emits after consuming piece token j. Plain torch (the
    JAX engine leaves it to XLA).

    int8 pools: the history dequantizes up front; piece K/V BELOW the
    diagonal round-trip through ``quantize_kv`` (a step-wise decode reads
    them from the int8 pool) while the diagonal — each position's own
    K/V, the decode ring's — stays raw.

    Writeback is decode-shaped: every position scatters to its own
    (block, offset) at ``lengths[n] + j``, ALL k+1 of them (the host
    commits c <= k; later positions are unreadable past the length and
    the next wave overwrites them). Inactive rows and positions past
    ``max_model_len`` go to trash block 0. Returns the greedy grid
    [N, k+1] int32."""
    c = config
    dt = c.dtype
    N, nbk = block_table.shape
    S = n_spec + 1
    bs = pools["k"].shape[2]
    Lc, Hq, Hkv, D = c.num_layers, c.num_heads, c.num_kv_heads, c.head_dim
    G = Hq // Hkv
    Pp = nbk * bs
    scale = 1.0 / math.sqrt(D)
    kv_int8 = "ks" in pools
    dev = last.device

    tokens = torch.cat([last[:, None].int(), draft_toks.t().int()], dim=1)
    tokens = tokens.clamp(0, c.vocab_size - 1)            # [N, S]
    hist = torch.where(active, lengths.int(), torch.zeros_like(lengths.int()))
    x = params["embed"].to(dt)[tokens.long()]
    freq = c.rope_theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                          device=dev) / D)
    pos = hist.float()[:, None] + torch.arange(S, dtype=torch.float32,
                                               device=dev)[None, :]
    ang = pos[:, :, None] * freq[None, None, :]           # [N, S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    pre_mask = (torch.arange(Pp, device=dev)[None, :]
                < hist[:, None])[:, None, None, None, :]
    in_mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                    device=dev))[None, None, None]
    tbl = block_table.long()
    k_all, v_all = [], []
    for l in range(Lc):
        p = _layer(params, l)
        hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
        q = _apply_rope_at(_wo_mm(hn, p["wq"], dt).reshape(N, S, Hq, D),
                           cos, sin)
        k = _apply_rope_at(_wo_mm(hn, p["wk"], dt).reshape(N, S, Hkv, D),
                           cos, sin)
        v = _wo_mm(hn, p["wv"], dt).reshape(N, S, Hkv, D)
        k_all.append(k)
        v_all.append(v)
        kpre = pools["k"][l][tbl].reshape(N, Pp, Hkv, D)
        vpre = pools["v"][l][tbl].reshape(N, Pp, Hkv, D)
        if kv_int8:
            ksc = pools["ks"][l][tbl].reshape(N, Pp, Hkv)
            vsc = pools["vs"][l][tbl].reshape(N, Pp, Hkv)
            kpre = kpre.to(dt) * ksc[..., None].to(dt)
            vpre = vpre.to(dt) * vsc[..., None].to(dt)
            qk_p, sk_p = quantize_kv(k)
            qv_p, sv_p = quantize_kv(v)
            k_rt = qk_p.to(dt) * sk_p[..., None].to(dt)
            v_rt = qv_p.to(dt) * sv_p[..., None].to(dt)
        else:
            k_rt, v_rt = k, v
        qg = q.reshape(N, S, Hkv, G, D).float()
        s_pre = torch.einsum("bshgd,bphd->bhgsp", qg, kpre.float()) * scale
        s_in = torch.einsum("bshgd,bthd->bhgst", qg, k_rt.float()) * scale
        if kv_int8:
            eye = torch.eye(S, dtype=torch.bool, device=dev)[None, None, None]
            s_diag = torch.einsum("bshgd,bshd->bhgs", qg, k.float()) * scale
            s_in = torch.where(eye, s_diag[..., None], s_in)
        s_pre = torch.where(pre_mask, s_pre, torch.full_like(s_pre, NEG_INF))
        s_in = torch.where(in_mask, s_in, torch.full_like(s_in, NEG_INF))
        probs = torch.softmax(torch.cat([s_pre, s_in], dim=-1), dim=-1)
        p_in = probs[..., Pp:].to(dt)
        if kv_int8:
            eye_f = torch.eye(S, dtype=dt, device=dev)[None, None, None]
            att_in = (torch.einsum("bhgst,bthd->bshgd", p_in * (1 - eye_f),
                                   v_rt)
                      + torch.einsum("bhgs,bshd->bshgd",
                                     (p_in * eye_f).sum(-1), v))
        else:
            att_in = torch.einsum("bhgst,bthd->bshgd", p_in, v)
        att = torch.einsum("bhgsp,bphd->bshgd", probs[..., :Pp].to(dt),
                           vpre) + att_in
        att = att.reshape(N, S, Hq * D).to(dt)
        x = _mlp(x + _wo_mm(att, p["wo"], dt), p, c)

    # positional writeback (the decode ring's scatter at piece width)
    j = torch.arange(S, device=dev)[None, :]
    wpos = hist[:, None] + j                              # [N, S]
    valid = active[:, None] & (wpos < max_model_len)
    wposc = wpos.clamp(max=max_model_len - 1).long()
    phys = tbl.gather(1, (wposc // bs).clamp(max=nbk - 1))
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    _write_pools(pools, (slice(None), phys, wposc % bs), torch.stack(k_all),
                 torch.stack(v_all))
    x = _rms_norm(x, params["final_norm"], c.rms_eps)
    logits = _wo_mm(x, head_weight(params, c), dt).float()
    return logits.argmax(dim=-1).int()


# ---------------------------------------------------------------------------
# host engine
# ---------------------------------------------------------------------------
class LLMEngine:
    """Continuous-batching serving loop.

    >>> eng = LLMEngine(params, config, max_slots=4)
    >>> eng.add_request([1, 2, 3], max_new_tokens=32)
    >>> outputs = eng.run()          # {req_id: [generated tokens...]}

    ``step()`` admits queued requests, runs one decode call and returns
    the (req_id, token) pairs that became host-visible — the streaming
    hook. ``params`` must live on ``device`` (``"cuda"`` by default;
    ``"cpu"`` runs the kernels' plain versions).

    ``draft_params``/``draft_config``: a second, smaller llama sharing the
    target's vocabulary (``models.llama.draft_config``), the speculative
    draft. A decode wave whose slots are all greedy and whose draft K/V
    cover their contexts runs draft-then-verify: ``spec_tokens`` proposals
    a slot, one verify call, and the agreeing prefix plus the target's
    token committed (capped at ``spec_tokens``, at least one token a
    wave) — exactly the non-speculative greedy streams. Other waves take
    the normal decode path (a slot advanced there stays out of spec waves
    until it is re-prefilled). ``spec=False`` leaves the engine as it is
    without a draft: no draft pools, no draft prefill. The counters
    ``spec_waves``, ``spec_proposed``, ``spec_accepted``,
    ``spec_committed``, ``spec_draft_steps`` and ``spec_verify_calls``
    are kept on the host; ``spec_draft_paths`` counts the draft calls by
    kernel path.
    """

    def __init__(self, params, config: LlamaConfig, max_slots: int = 4,
                 block_size: int = 16, max_model_len: int = 512,
                 num_blocks: Optional[int] = None,
                 prompt_buckets: Optional[List[int]] = None, seed: int = 0,
                 decode_steps: int = 1, decode_kernel: str = "auto",
                 kv_dtype=None, device="cuda", draft_params=None,
                 draft_config: Optional[LlamaConfig] = None,
                 spec_tokens: int = 4, spec: bool = True, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"LLMEngine got an unexpected argument "
                                f"{name!r}")
            default, queue = _UNPORTED[name]
            if value is not default and value != default:
                raise NotImplementedError(
                    f"LLMEngine({name}=...) is not ported yet (ROADMAP "
                    f"queue {queue})")
        if decode_kernel == "bucketed":
            raise NotImplementedError(
                "decode_kernel='bucketed' (the dense-gather decode) is not "
                "ported: the port decodes through the ragged or the mega "
                "kernel")
        if decode_kernel not in ("auto", "ragged", "mega"):
            raise ValueError(f"decode_kernel must be 'auto', 'ragged' or "
                             f"'mega', got {decode_kernel!r}")
        if kv_dtype not in (None, "int8", torch.int8):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if max_model_len % block_size:
            raise ValueError(f"max_model_len {max_model_len} is not a "
                             f"multiple of block_size {block_size}")
        self.device = resolve_device(device)
        bad = [k for k, t in _tensors(params) if t.device != self.device]
        if bad:
            raise ValueError(f"params {bad[:3]} are not on {self.device}")
        c = config
        self.params = params
        self.config = config
        self.decode_kernel = decode_kernel
        self.N = max_slots
        self.bs = block_size
        self.mb = max_model_len // block_size      # logical blocks per slot
        self.max_model_len = max_model_len
        # +1: physical block 0 is the trash block for idle slots
        self.nb = (num_blocks if num_blocks is not None
                   else max_slots * self.mb) + 1
        self.buckets = sorted(prompt_buckets or
                              [b for b in (64, 128, 256, 512)
                               if b <= max_model_len] or [max_model_len])
        if self.buckets[-1] < max_model_len:
            # re-admission after preemption prefills prompt+generated, which
            # can reach max_model_len — it must always have a bucket
            self.buckets.append(max_model_len)
        for b in self.buckets:
            if b % block_size:
                raise ValueError(f"prompt bucket {b} is not a multiple of "
                                 f"block_size {block_size}")
        pool_shape = (c.num_layers, self.nb, block_size, c.num_kv_heads,
                      c.head_dim)
        self.kv_int8 = kv_dtype is not None
        if self.kv_int8:
            # int8 payload + f32 per-entry scales (~3% more at D=128)
            self.pools = {
                "k": torch.zeros(pool_shape, dtype=torch.int8,
                                 device=self.device),
                "v": torch.zeros(pool_shape, dtype=torch.int8,
                                 device=self.device),
                "ks": torch.zeros(pool_shape[:-1], dtype=torch.float32,
                                  device=self.device),
                "vs": torch.zeros(pool_shape[:-1], dtype=torch.float32,
                                  device=self.device)}
        else:
            self.pools = {"k": torch.zeros(pool_shape, dtype=c.dtype,
                                           device=self.device),
                          "v": torch.zeros(pool_shape, dtype=c.dtype,
                                           device=self.device)}
        # -- speculative decoding: the optional draft model --------------
        self._spec_on = bool(spec) and draft_params is not None
        self.spec_k = int(spec_tokens)
        self.draft_params = draft_params if self._spec_on else None
        self.draft_config = draft_config if self._spec_on else None
        if self._spec_on:
            if draft_config is None:
                raise ValueError("draft_params requires a draft_config")
            if draft_config.vocab_size != c.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_config.vocab_size} != target vocab "
                    f"{c.vocab_size} — the two models must share a "
                    "tokenizer")
            if self.spec_k < 1:
                raise ValueError(
                    f"spec_tokens must be >= 1, got {spec_tokens}")
            bad = [k for k, t in _tensors(draft_params)
                   if t.device != self.device]
            if bad:
                raise ValueError(f"draft_params {bad[:3]} are not on "
                                 f"{self.device}")
            # the draft's pools share the target's block grid (one block
            # backs both models' K/V for its positions, so the allocator
            # needs no new bookkeeping) and stay in the draft's dtype
            dc = draft_config
            dshape = (dc.num_layers, self.nb, block_size, dc.num_kv_heads,
                      dc.head_dim)
            self.pools["dk"] = torch.zeros(dshape, dtype=dc.dtype,
                                           device=self.device)
            self.pools["dv"] = torch.zeros(dshape, dtype=dc.dtype,
                                           device=self.device)
        # per slot, the positions the draft's K/V cover: a slot joins a
        # spec wave only while they equal its length (a slot advanced by
        # the normal decode path goes stale, -1, until re-prefilled)
        self._draft_len = np.zeros(self.N, np.int64)
        self.spec_proposed = 0      # draft tokens offered to verify
        self.spec_accepted = 0      # of those, accepted by the target
        self.spec_committed = 0     # tokens committed by spec waves
        self.spec_waves = 0         # draft+verify waves
        self.spec_draft_steps = 0   # draft decode steps run (waves * k)
        self.spec_verify_calls = 0  # batched target verify calls
        self.spec_draft_paths: Counter = Counter()   # draft calls by path
        self.free_blocks = deque(range(1, self.nb))
        self.table = np.zeros((self.N, self.mb), np.int32)
        self.n_alloc = np.zeros(self.N, np.int64)  # backed logical blocks
        self.lengths = np.zeros(self.N, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.N
        self.slot_out: List[List[int]] = [[] for _ in range(self.N)]
        self.admit_order: List[int] = []           # slots, oldest first
        self.queue: deque = deque()
        self.results: Dict[int, List[int]] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_steps = max(1, int(decode_steps))
        self._table_dev = None       # device copy of self.table, when clean
        # decode dispatches by path, and mega picks the screen refused by
        # reason (the JAX engine's serving_decode_kernel_total and
        # serving_mega_fallback_total)
        self.decode_paths: Counter = Counter()
        self.mega_fallbacks: Counter = Counter()
        # admissions whose device-sampled first token has not been read
        # back yet: (slot, req_id, wave token array, row)
        self._pending_adm: List = []

    # -- public api ---------------------------------------------------------
    def add_request(self, prompt: List[int], **kw) -> int:
        req = Request(req_id=self._next_id, prompt=list(prompt), **kw)
        if len(req.prompt) + req.max_new_tokens > self.max_model_len:
            raise ValueError(
                f"request {req.req_id}: prompt({len(req.prompt)}) + "
                f"max_new_tokens({req.max_new_tokens}) exceeds "
                f"max_model_len({self.max_model_len})")
        if len(req.prompt) > self.buckets[-1]:
            raise ValueError(
                f"request {req.req_id}: prompt length {len(req.prompt)} "
                f"exceeds the largest prompt bucket {self.buckets[-1]}")
        self._next_id += 1
        self.queue.append(req)
        return req.req_id

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def run(self) -> Dict[int, List[int]]:
        while self.has_work():
            self.step()
        return self.results

    def step(self):
        """Admit queued requests, run one decode call (or, with a draft,
        one draft-then-verify wave) over the active slots, and return the
        (req_id, token) pairs emitted."""
        self._admit()
        active = self._decode_slots()
        if not active:
            return []
        if self._spec_eligible(active):
            return self._spec_wave()
        self._back_or_preempt()
        active = self._decode_slots()
        if not active:
            return []
        return self._dispatch_decode(active)

    def block_accounting(self) -> Dict[str, int]:
        """Device block-pool ledger: ``free + backed == total`` at every
        step boundary (``backed`` counts the blocks slots hold)."""
        return {"total": self.nb - 1, "free": len(self.free_blocks),
                "backed": int(self.n_alloc.sum())}

    # -- internals ----------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _take_up_to(self, k: int) -> List[int]:
        out: List[int] = []
        while self.free_blocks and len(out) < k:
            out.append(self.free_blocks.popleft())
        return out

    def _free_slot(self, slot: int, requeue: bool = False):
        req = self.slot_req[slot]
        out = self.slot_out[slot]
        for j in range(int(self.n_alloc[slot])):
            self.free_blocks.append(int(self.table[slot, j]))
        self.table[slot, :] = 0
        self.n_alloc[slot] = 0
        self.lengths[slot] = 0
        self._draft_len[slot] = 0
        self.slot_req[slot] = None
        if slot in self.admit_order:
            self.admit_order.remove(slot)
        self.slot_out[slot] = []
        self._table_dev = None
        # an admission whose first token was never read back dies with the
        # slot (recompute semantics: re-admission prefills and re-samples)
        self._pending_adm = [e for e in self._pending_adm if e[0] != slot]
        if requeue:
            # preemption: carry generated tokens so re-admission continues
            # from prompt+generated — streamed tokens are never re-emitted
            req.generated.extend(out)
            self.queue.appendleft(req)
        else:
            self.results[req.req_id] = req.generated + out

    def _admit(self):
        """Admit every queued request a free slot and free blocks can
        take, then prefill the whole wave in one call."""
        wave = []
        while self.queue and len(wave) < self.N:
            slot = next((i for i in range(self.N)
                         if self.slot_req[i] is None), None)
            if slot is None:
                break
            req = self.queue[0]
            ctx = req.prompt + req.generated   # re-admission continues
            need = max(1, -(-len(ctx) // self.bs))
            if len(self.free_blocks) < need:
                if not any(r is not None for r in self.slot_req):
                    raise RuntimeError(
                        f"request {req.req_id}: prefill needs {need} blocks "
                        f"but the pool only has {self.nb - 1} usable — the "
                        "block pool is too small for this request")
                break                        # blocks busy: wait for frees
            self.queue.popleft()
            blocks = self._take_up_to(need)
            self.table[slot, :need] = blocks
            self.n_alloc[slot] = need
            self.slot_req[slot] = req
            self.admit_order.append(slot)
            self._table_dev = None
            wave.append((slot, req, ctx))
        if wave:
            self._dispatch_prefill(wave)

    def _dispatch_prefill(self, rows):
        """One prefill call for a wave: B=1 for a single admission, else
        padded to ``max_slots`` rows; pad rows point at the trash block."""
        bucket = self._bucket_for(max(len(ctx) for _s, _r, ctx in rows))
        B = 1 if len(rows) == 1 else self.N
        toks = np.zeros((B, bucket), np.int32)
        blk_ids = np.zeros((B, bucket // self.bs), np.int32)
        true_lens = np.ones(B, np.int32)
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int32)
        top_ps = np.ones(B, np.float32)
        for i, (slot, req, ctx) in enumerate(rows):
            nblk = -(-len(ctx) // self.bs)
            toks[i, :len(ctx)] = ctx
            blk_ids[i, :nblk] = self.table[slot, :nblk]
            true_lens[i] = len(ctx)
            temps[i], top_ks[i], top_ps[i] = (req.temperature, req.top_k,
                                              req.top_p)
        flags = _sample_flags([r for _s, r, _c in rows])
        dev = self.device
        tok_dev = _paged_prefill(
            self.params, torch.as_tensor(toks, device=dev),
            torch.as_tensor(blk_ids, device=dev),
            torch.as_tensor(true_lens, device=dev), self.pools,
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(top_ks, device=dev),
            torch.as_tensor(top_ps, device=dev), self._gen,
            config=self.config, sample_flags=flags)
        if self._spec_on:
            # the same wave through the draft, so both models' K/V cover
            # every prefilled position; its token is discarded (greedy:
            # it draws nothing from the generator)
            _paged_prefill(
                self.draft_params, torch.as_tensor(toks, device=dev),
                torch.as_tensor(blk_ids, device=dev),
                torch.as_tensor(true_lens, device=dev), self.pools,
                torch.as_tensor(temps, device=dev),
                torch.as_tensor(top_ks, device=dev),
                torch.as_tensor(top_ps, device=dev), self._gen,
                config=self.draft_config, sample_flags=(False, False, False),
                kv_prefix="d")
        for i, (slot, req, ctx) in enumerate(rows):
            self.lengths[slot] = len(ctx)
            self._draft_len[slot] = len(ctx)
            self._pending_adm.append((slot, req.req_id, tok_dev, i))

    def _emit(self, slot: int, tok: int) -> bool:
        """Record a generated token; free the slot when the request is done.
        Returns True if the request finished."""
        req = self.slot_req[slot]
        self.slot_out[slot].append(tok)
        n_gen = len(req.generated) + len(self.slot_out[slot])
        done = (req.eos_token_id is not None and tok == req.eos_token_id) \
            or n_gen >= req.max_new_tokens
        if done:
            self._free_slot(slot)
        return done

    def _ensure_backed(self, slot: int, steps: Optional[int] = None) -> bool:
        """Back every block this slot's next decode call can write
        (clamped to its remaining token budget); ``steps`` overrides the
        call's write horizon (a spec wave commits up to ``spec_tokens``).
        Returns False if the pool is exhausted (caller preempts)."""
        req = self.slot_req[slot]
        remaining = req.max_new_tokens - len(req.generated) \
            - len(self.slot_out[slot])
        base = self.decode_steps if steps is None else steps
        steps = max(1, min(base, remaining))
        horizon = int(self.lengths[slot]) + steps - 1
        last_blk = min(horizon, self.max_model_len - 1) // self.bs
        need = last_blk + 1 - int(self.n_alloc[slot])
        if need <= 0:
            return True
        got = self._take_up_to(need)
        for blk in got:
            self.table[slot, int(self.n_alloc[slot])] = blk
            self.n_alloc[slot] += 1
            self._table_dev = None
        return len(got) == need

    def _decode_slots(self):
        return [i for i in range(self.N) if self.slot_req[i] is not None]

    def _back_or_preempt(self, steps: Optional[int] = None):
        """Back the next call's writes for every active slot (``steps``
        positions, default ``decode_steps``); preempt the newest
        admissions while the pool is short (recompute policy)."""
        for slot in self._decode_slots():
            if self.slot_req[slot] is None:
                continue                      # already preempted as a victim
            while not self._ensure_backed(slot, steps):
                victim = self.admit_order[-1]
                if victim == slot and len(self.admit_order) == 1:
                    # alone and starved: nothing else will ever free a block
                    raise RuntimeError(
                        f"request {self.slot_req[slot].req_id}: the block "
                        f"pool ({self.nb - 1} usable blocks) is too small "
                        "to decode this request any further")
                self._free_slot(victim, requeue=True)
                if victim == slot:
                    break

    def _decode_path(self) -> str:
        """Kernel path of the next decode dispatch: ``"mega"`` (the
        persistent megakernel — forced, or picked by ``"auto"`` on the
        card at ``max_slots <= 4``, where a step is launch-bound) when its
        screen accepts the model and batch, else ``"ragged"``. A mega pick
        the screen refuses is counted in ``mega_fallbacks`` by reason."""
        want_mega = self.decode_kernel == "mega" or (
            self.decode_kernel == "auto" and self.device.type == "cuda"
            and self.N <= 4)
        if want_mega:
            ok, reason = mega_supported(
                self.params, self.config, n_slots=self.N,
                n_steps=self.decode_steps, block_size=self.bs,
                kv_int8=self.kv_int8)
            if ok:
                return "mega"
            self.mega_fallbacks[reason] += 1
        return "ragged"

    def _dispatch_decode(self, active):
        """Run one decode call over ``active`` and read its tokens back."""
        dev = self.device
        pend = {s for s, _, _, _ in self._pending_adm}
        last = np.zeros(self.N, np.int32)
        budgets = np.zeros(self.N, np.int32)
        temps = np.zeros(self.N, np.float32)
        top_ks = np.zeros(self.N, np.int32)
        top_ps = np.ones(self.N, np.float32)
        eos_ids = np.full(self.N, -1, np.int32)
        act = np.zeros(self.N, bool)
        for i in active:
            req = self.slot_req[i]
            # pending-admission slots get their device-sampled first token
            # scattered in by _apply_admissions below
            last[i] = self.slot_out[i][-1] if self.slot_out[i] else \
                (req.generated[-1] if req.generated else req.prompt[-1])
            budgets[i] = req.max_new_tokens - len(req.generated) \
                - len(self.slot_out[i]) - (1 if i in pend else 0)
            temps[i], top_ks[i], top_ps[i] = (req.temperature, req.top_k,
                                              req.top_p)
            if req.eos_token_id is not None:
                eos_ids[i] = req.eos_token_id
            act[i] = True
        c_last = torch.as_tensor(last, device=dev)
        c_len = torch.as_tensor(self.lengths.astype(np.int32), device=dev)
        c_done = torch.zeros(self.N, dtype=torch.bool, device=dev)
        c_rem = torch.as_tensor(budgets, device=dev)
        waves: Dict = {}
        for s, _rid, arr, i in self._pending_adm:
            waves.setdefault(id(arr), (arr, []))[1].append((s, i))
        for arr, items in waves.values():
            slot_of_row = np.full(arr.shape[0], self.N, np.int32)
            upd = np.zeros(self.N, bool)
            for s, i in items:
                slot_of_row[i] = s
                upd[s] = True
            c_last, c_len, c_done, c_rem = _apply_admissions(
                c_last, c_len, c_done, c_rem, arr,
                torch.as_tensor(slot_of_row, device=dev), c_len, c_rem,
                torch.as_tensor(upd, device=dev))
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.table, device=dev)
        path = self._decode_path()
        self.decode_paths[path] += 1
        toks, *_carry = _paged_decode(
            self.params, c_last, c_len, c_done, c_rem, self._gen,
            torch.as_tensor(act, device=dev), self._table_dev, self.pools,
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(top_ks, device=dev),
            torch.as_tensor(top_ps, device=dev),
            torch.as_tensor(eos_ids, device=dev), config=self.config,
            n_steps=self.decode_steps,
            sample_flags=_sample_flags([self.slot_req[i] for i in active]),
            mega=path == "mega")
        adm, self._pending_adm = self._pending_adm, []
        return self._process(adm, toks,
                             [(i, self.slot_req[i].req_id) for i in active])

    def _flush_adm(self, adm):
        """Read back the first tokens of admissions ((slot, req_id, wave
        token array, row) tuples) and emit them; slots whose request
        changed since are skipped."""
        emitted = []
        host = {}
        for slot, rid, arr, i in adm:
            if id(arr) not in host:
                host[id(arr)] = arr.cpu().numpy()
            req = self.slot_req[slot]
            if req is None or req.req_id != rid:
                continue
            tok = int(host[id(arr)][i])
            emitted.append((rid, tok))
            self._emit(slot, tok)
        return emitted

    def _process(self, adm, toks, snapshot):
        """Read back a decode call: the first tokens of its admissions,
        then its emitted grid [n_steps, N]. Slots whose request changed
        since dispatch are skipped."""
        emitted = self._flush_adm(adm)
        toks_host = toks.cpu().numpy()
        for slot, rid in snapshot:
            for k in range(toks_host.shape[0]):
                req = self.slot_req[slot]
                if req is None or req.req_id != rid:
                    break
                tok = int(toks_host[k, slot])
                if tok < 0:
                    break          # slot went done mid-call
                self.lengths[slot] += 1     # its K/V was appended
                if self._spec_on:
                    # advanced by the normal path: the draft's K/V are
                    # behind until a re-prefill
                    self._draft_len[slot] = -1
                emitted.append((rid, tok))
                if self._emit(slot, tok):
                    break
        return emitted

    # -- speculative decoding: draft-then-verify waves ----------------------
    def _spec_eligible(self, active) -> bool:
        """True when the next wave can run draft-then-verify: a draft is
        configured, every decode slot is greedy (accepting the longest
        agreeing prefix is exact for argmax only) and every slot's draft
        K/V cover its whole context."""
        if not self._spec_on or not active:
            return False
        return all(self.slot_req[i].temperature <= 0
                   and self._draft_len[i] == self.lengths[i] for i in active)

    def _spec_bucket(self, active) -> int:
        """Power-of-two block count covering every wave slot's history
        plus the verify piece's k+1 writes: the verify's table width."""
        hmax = need = 0
        for i in active:
            hmax = max(hmax, int(self.lengths[i]))
            need = max(need, int(self.n_alloc[i]))
        horizon = min(hmax + self.spec_k + 1, self.max_model_len)
        need = max(1, need, -(-horizon // self.bs))
        return min(1 << (need - 1).bit_length(), self.mb)

    def _spec_wave(self):
        """One draft-then-verify wave: the draft proposes ``spec_k``
        tokens a slot in one call, the target scores them all in one
        verify call (the draft's grid feeds it on the device), and the
        host commits each slot's agreeing prefix plus the target's token,
        capped at ``spec_k`` — so the draft's K/V stay in lockstep with the
        target's and a rejected suffix is rolled back by the length alone.
        Pending admissions are read back first: the wave reads the host's
        state."""
        emitted = []
        if self._pending_adm:
            adm, self._pending_adm = self._pending_adm, []
            emitted += self._flush_adm(adm)
        self._back_or_preempt(steps=self.spec_k)
        active = self._decode_slots()
        if not active:
            return emitted
        k, N, dev = self.spec_k, self.N, self.device
        path = self._decode_path()
        if path == "mega":
            # the draft's own screen (its widths, its head, the multi-step
            # epilogue); a refusal is counted and the draft runs ragged
            ok, reason = mega_supported(
                self.draft_params, self.draft_config, n_slots=N,
                n_steps=k, block_size=self.bs, kv_int8=False,
                multi_step=True)
            if not ok:
                self.mega_fallbacks["draft_" + reason] += 1
                path = "ragged"
        self.spec_draft_paths[path] += 1
        nbk = self._spec_bucket(active)
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.table, device=dev)
        last = np.zeros(N, np.int32)
        budgets = np.zeros(N, np.int32)
        act = np.zeros(N, bool)
        for i in active:
            req = self.slot_req[i]
            out = self.slot_out[i]
            last[i] = out[-1] if out else (
                req.generated[-1] if req.generated else req.prompt[-1])
            # the draft stops at the slot's remaining budget: tokens past
            # it could never commit
            budgets[i] = req.max_new_tokens - len(req.generated) - len(out)
            act[i] = True
        last_d = torch.as_tensor(last, device=dev)
        lens_d = torch.as_tensor(self.lengths.astype(np.int32), device=dev)
        act_d = torch.as_tensor(act, device=dev)
        draft, *_ = _paged_decode(
            self.draft_params, last_d, lens_d,
            torch.zeros(N, dtype=torch.bool, device=dev),
            torch.as_tensor(budgets, device=dev), self._gen, act_d,
            self._table_dev, self.pools,
            torch.zeros(N, dtype=torch.float32, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev),
            torch.ones(N, dtype=torch.float32, device=dev),
            torch.full((N,), -1, dtype=torch.int32, device=dev),
            config=self.draft_config, n_steps=k,
            sample_flags=(False, False, False), mega=path == "mega",
            mega_multistep=path == "mega", kv_prefix="d")
        verified = _spec_verify(
            self.params, self._table_dev[:, :nbk], last_d, draft, lens_d,
            act_d, self.pools, config=self.config, n_spec=k,
            max_model_len=self.max_model_len)
        d_host = draft.cpu().numpy()                    # [k, N]
        v_host = verified.cpu().numpy()                 # [N, k+1]
        wave_prop = wave_acc = wave_commit = 0
        for i in active:
            req = self.slot_req[i]
            rid = req.req_id
            rem = req.max_new_tokens - len(req.generated) \
                - len(self.slot_out[i])
            prop = min(k, rem)              # what the draft really ran
            d, g = d_host[:, i], v_host[i]
            a = 0
            while a < prop and d[a] == g[a]:
                a += 1
            # the agreeing prefix + the target's own token, capped at k
            # (the lockstep invariant) and at the budget: a wave commits
            # at least one token
            c = min(a + 1, k, rem)
            wave_prop += prop
            wave_acc += a
            for j in range(c):
                tok = int(g[j])
                self.lengths[i] += 1        # verify wrote its K/V
                self._draft_len[i] += 1     # and the draft its own
                wave_commit += 1
                emitted.append((rid, tok))
                if self._emit(i, tok):
                    break                   # eos or budget mid-wave
        self.spec_waves += 1
        self.spec_verify_calls += 1
        self.spec_draft_steps += k
        self.spec_proposed += wave_prop
        self.spec_accepted += wave_acc
        self.spec_committed += wave_commit
        return emitted


def _sample_flags(reqs):
    """(any sampled, any sampled top-k, any sampled top-p) over ``reqs``."""
    sampled = [r for r in reqs if r.temperature > 0]
    return (bool(sampled), any(r.top_k > 0 for r in sampled),
            any(r.top_p < 1.0 for r in sampled))


def _tensors(params, prefix=""):
    """(path, tensor) of every leaf of a nested parameter dict (both
    tensors of an int8 leaf)."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v
