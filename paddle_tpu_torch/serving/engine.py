"""Continuous-batching paged-KV serving engine — the port of
paddle_tpu/serving/engine.py (greedy/sampled core, ragged and mega
decode chained in flight, int8, speculative decoding, the prefix cache
with chunked prefill, and the swap/offload host tiers).

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
  prompt + generated (recompute preemption) — or, with a host swap tier
  (``kv_swap_bytes``), its blocks move to host memory and re-admission
  restores them bit-exactly (``serving.kv_swap``).
- Chained decode: call k+1 is dispatched before call k is read whenever
  no slot of call k can finish inside it, so the readback overlaps the
  next call. The carry (last tokens, lengths, done flags, budgets) stays
  on the device from call to call, and nothing in a dispatch waits on
  the device: every upload goes through a pinned staging copy and the
  slot vectors and the block table are uploaded only when they change.
- Prefix cache + chunked prefill (optional): a radix trie of full prompt
  blocks (``serving.prefix_cache``) lets an admission pin a cached
  prefix and prefill only the suffix against it (plain torch: one
  softmax over the gathered history and the causal piece);
  ``prefill_chunk`` feeds long suffixes one chunk a step between decode
  calls. Cached blocks spill to a host tier under pressure.
- Async offload (``serving.offload``): spills copy d2h on a side stream
  and land at step boundaries (their blocks ride the ledger's
  ``in_flight`` term until then), queued restores prefetch h2d ahead of
  admission, and cold cached blocks spill proactively under pressure.
- int8 everywhere (optional): int8 weight-only params
  (``models.llama.quantize_params``) go through
  ``kernels.quant_matmul.weight_only_matmul`` in prefill, the ragged
  decode layers and the head, and through the mega kernel's int8 branch;
  ``kv_dtype="int8"`` keeps the pools as int8 ``{"k", "v"}`` with f32
  per-entry scales ``{"ks", "vs"}`` [L, NB, BS, Hkv]: prefill runs B1 on
  the dense K/V and scatters them quantized, the decode walks read the
  scales, and the in-call ring stays in the model dtype until the
  writeback quantizes it.
- Bucketed decode (``decode_kernel="bucketed"``): the dense-gather
  path. Each call gathers every slot's frozen prefix ONCE, over the
  smallest power-of-two block count covering ``max(lengths) +
  decode_steps`` (``_prefix_blocks``; the table is sliced to it), and
  each step runs masked attention over [prefix ; ring] in one softmax —
  plain torch, as the JAX engine leaves this path to XLA (int8 pools
  through ``attn_qk``/``attn_pv``). The ring is written back as on the
  other paths. ``"auto"`` never picks it: on the card the hand-written
  kernels serve (ragged, or mega at ``max_slots <= 4``), and on the CPU
  ragged runs its plain version — unlike the JAX engine, whose "auto"
  picks bucketed off a TPU because its kernel would run interpreted.
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
- Survivability: ``admission`` (``serving.admission``) sheds
  reject-newest with a typed ``ShedError``; ``Request.deadline_s``
  evicts a request past its budget (queued or in a slot, partial tokens
  delivered); ``cancel_request`` marks a request for eviction at the
  next step boundary; every minted id ends in exactly one
  ``finish_reasons`` entry. ``injector`` (a
  ``distributed.resilience.FaultInjector``) fires the serving fault
  kinds inside the step loop, and ``serving.resilient.ResilientEngine``
  recovers a crashed step through ``recover_crashed_step``.
- Observability (``FLAGS_obs_enabled``, ``paddle_tpu_torch.observability``):
  the JAX engine's metrics (the catalog's ``serving_*`` rows but the
  disaggregation ones), the ``serving.step`` span with ``.prefill``,
  ``.decode``, ``.readback``, ``.spec_draft`` and ``.spec_verify``
  nested in it, per-request timelines with TTFT/TPOT exemplars, flight
  events, the decode MFU and HBM gauges, the profiler window tick and,
  with ``FLAGS_obs_numerics``, the ``kv_int8`` quant-error probes. Off,
  ``step()`` costs one boolean check (plus the idle profiler tick's one
  attribute read) and the probe sites add no device op. On, nothing in a
  dispatch waits on the card either: a device-side value (a numerics
  vector) lands after the readback the engine already does.

Differences from the JAX engine: PyTorch runs eagerly, so nothing is
compiled and the pools are updated in place rather than donated;
``serving_decode_recompiles_total`` counts the first use of each decode
variant key — the ``(path or bucket, flags)`` key the JAX engine jits
once — so it equals the reference's count step for step. The decode
MFU's FLOPs are counted on the host (``observability.perf.decode_flops``)
instead of by XLA's cost analysis. The random source is the engine's
``torch.Generator`` (sampled streams differ from the JAX engine's, whose
RNG differs; greedy streams are equal). The spec wave's draft prefill
samples greedily (its token is discarded; the JAX engine draws it with
the wave's flags), so a speculating engine draws the same random numbers
for sampled requests as a plain one. The host counters (``spec_*``,
``decode_paths``, ``mega_fallbacks``, ``readbacks``, ``swap_fallbacks``,
``cancel_noops``, the admission controller's ``sheds``) are kept beside
the metrics, which mirror them, and so are the disaggregated handoff's
(``handoffs``, ``handoff_bytes``, ``handoff_seconds``). Each step ends
with the time-series sampler's tick (``observability.timeseries
.step_tick``: throttled, and skipped — never waited on — when another
replica's step thread is sampling).

Tensor parallelism (``mesh``, a ``DeviceMesh`` with a ``"tp"`` dim): one
engine a rank, SPMD — every rank builds the engine with the same whole
params and makes the same ``add_request``/``step``/``run`` calls (as a
torchrun program does), because every step meets the other ranks in
collectives. Each rank keeps its Megatron slice of the target
(``models.llama.make_serving_shardings``, ``shard_params``) and its
kv-head slice of the pools, runs B1 and B4 on its own heads, and meets
the others where ``models.llama.TPPlan`` says: the vocab-parallel
embedding lookup, after ``wo`` and ``w_down``, the vocab-split logits,
and the broadcast of each sampled token from the first rank (so the host
schedulers cannot drift). The speculative draft stays whole on every
rank. Mega decode bows out counted (``reason="mesh"``). A process group
that cannot carry the engine's tensors raises at construction. Over gloo
every collective on a CUDA tensor waits for the card, so the chained
decode no longer overlaps its readback; ``tp_collectives`` counts them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import observability as _obs
from ..device import resolve_device
from ..distributed.mesh import axis_size, is_mesh
from ..distributed.resilience.faults import SimulatedCrash
from ..framework.flags import get_flag
from ..kernels.mega_decode import (_layer, _mlp, _rope1, _wo, decode_layers,
                                   mega_decode_loop, mega_decode_step,
                                   mega_supported)
from ..kernels.pallas_attention import flash_attention_fwd
from ..kernels.quant_matmul import (attn_pv, attn_qk, is_quantized_weight,
                                    quantize_kv)
from ..kernels.quant_matmul import weight_only_matmul as _wo_mm
from ..models.llama import (LlamaConfig, TPPlan, _apply_rope, _apply_rope_at,
                            _rms_norm, _rope_tables, head_weight,
                            make_replicated_shardings,
                            make_serving_shardings, shard_params)
from ..observability import flight_recorder as _flight
from ..observability import numerics as _nm
from ..observability import perf as _perf
from ..observability import profiling as _profiling
from ..observability import request_trace as _rt
from ..observability import timeseries as _ts
from ..observability import trace_span
from ..observability.catalog import instrument as _instrument
from .admission import AdmissionConfig, AdmissionController, ShedError
from .kv_swap import HostKVPool
from .offload import OffloadEngine, gather_blocks, take_staged, upload
from .prefix_cache import PrefixCache

__all__ = ["LLMEngine", "Request"]

NEG_INF = -1e30

# the span a decode dispatch runs in while observability is off
_NO_SPAN = contextlib.nullcontext()

# always-on serving telemetry (no-ops until FLAGS_obs_enabled /
# observability.enable()); the JAX engine's set
_M_QUEUE_DEPTH = _instrument("serving_queue_depth")
_M_ACTIVE_SLOTS = _instrument("serving_active_slots")
_M_KV_USED = _instrument("serving_kv_pool_used_blocks")
_M_KV_BLOCKS = _instrument("serving_kv_pool_blocks")
_M_ADMISSIONS = _instrument("serving_admissions_total")
_M_PREEMPTIONS = _instrument("serving_preemptions_total")
_M_FINISHED = _instrument("serving_requests_finished_total")
_M_TOKENS = _instrument("serving_tokens_total")
_M_TTFT = _instrument("serving_ttft_seconds")
_M_TPS = _instrument("serving_tokens_per_second")
_M_STEP_SECONDS = _instrument("serving_step_seconds")
_M_PREFIX_BUCKET = _instrument("serving_decode_prefix_bucket")
_M_DECODE_RECOMPILES = _instrument("serving_decode_recompiles_total")
_M_KV_READ_BYTES = _instrument("serving_decode_kv_read_bytes")
_M_TPOT = _instrument("serving_tpot_seconds")
_M_SERVING_MFU = _instrument("serving_mfu")
_M_DEADLINE = _instrument("serving_deadline_exceeded_total")
_M_SWAP_FALLBACK = _instrument("serving_kv_swap_fallback_total")
_M_DECODE_KERNEL = _instrument("serving_decode_kernel_total")
_M_DECODE_VARIANTS = _instrument("serving_decode_variants")
_M_SPEC_PROPOSED = _instrument("serving_spec_proposed_total")
_M_SPEC_ACCEPTED = _instrument("serving_spec_accepted_total")
_M_SPEC_ACCEPT_RATE = _instrument("serving_spec_acceptance_rate")
_M_SPEC_TOKENS_PER_WAVE = _instrument("serving_spec_tokens_per_wave")
_M_CANCEL_NOOP = _instrument("serving_cancel_noop_total")
_M_MEGA_FALLBACK = _instrument("serving_mega_fallback_total")
_M_DISAGG_HANDOFFS = _instrument("serving_disagg_handoffs_total")
_M_DISAGG_SECONDS = _instrument("serving_disagg_handoff_seconds")


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    # latency budget in seconds from add_request; past it the request is
    # evicted (queued or mid-decode), its KV blocks freed, partial tokens
    # delivered with finish reason "deadline_exceeded". None = no deadline.
    deadline_s: Optional[float] = None
    # admission-control tenant for the per-tenant token-bucket rate limit
    tenant: str = "default"
    # absolute perf_counter deadline, stamped by add_request
    t_deadline: Optional[float] = None
    # tokens generated before a preemption; a re-admission prefills
    # prompt+generated so already-streamed tokens are never re-emitted
    generated: List[int] = dataclasses.field(default_factory=list)
    # disaggregated serving: key of a relay-pool KV entry spilled by a
    # prefill replica. Admission restores the entry (one batched h2d
    # scatter) instead of prefilling; a missing entry degrades to a full
    # prefill of the same context — streams identical either way.
    relay_key: Optional[int] = None


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


class _Readback:
    """A device tensor and its copy to pinned host memory, started as soon
    as the work that makes the tensor is enqueued: ``numpy()`` waits for
    that copy alone, not for work queued after it (the next chained call;
    a ``.cpu()`` there would wait for it too). On the CPU the tensor is
    its own host copy."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, t):
        self.dev = t
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.event = t, None

    def wait(self):
        """Block until the copy into ``host`` has landed."""
        if self.event is not None:
            self.event.synchronize()

    def numpy(self):
        self.wait()
        return self.host.numpy()


def _paged_prefill(params, tokens, blk_ids, true_len, pools, temps, top_ks,
                   top_ps, generator, *, config: LlamaConfig,
                   sample_flags=(True, True, True), kv_prefix: str = "",
                   hist_len=None, ctx_tbl=None, numerics: bool = False,
                   tp=None):
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

    Suffix/chunked prefill (``ctx_tbl`` given): the wave prefills only a
    PIECE of each row's context — tokens ``[hist_len[b], hist_len[b] +
    true_len[b])`` — against K/V already resident in the pools (a matched
    prefix-cache path and/or the slot's earlier chunks). ``ctx_tbl``
    [B, prefix_nbk] names the history's physical blocks (a power-of-two
    bucket; pad entries point at the trash block and mask via
    ``hist_len``); each layer gathers its history K/V once (int8 pools
    dequantized), each piece token attends to (masked history) + (causal
    within the piece) in one softmax, and RoPE offsets by ``hist_len``
    per row — plain torch, as the JAX engine leaves it to XLA. Without
    ``ctx_tbl`` the program is the full-prompt prefill on B1, bit for bit.

    ``numerics`` (int8 pools, ``FLAGS_obs_numerics``): the paired
    pre/post-quant probe of every K/V the wave writes, one
    ``kv_int8`` landing (``observability.numerics``).

    ``tp`` (a ``models.llama.TPPlan``): the rank's slice of the model
    and pools (``config`` is the rank's own), with the plan's collectives.
    Returns the first tokens [B] int32 (on the device)."""
    c = config
    dt = c.dtype
    B, S = tokens.shape
    pk, pv = kv_prefix + "k", kv_prefix + "v"
    bs = pools[pk].shape[2]
    Hq, Hkv, D = c.num_heads, c.num_kv_heads, c.head_dim
    flat = blk_ids.reshape(-1).long()
    x = (params["embed"][tokens.long()] if tp is None
         else tp.embed(params["embed"], tokens)).to(dt)
    dev = tokens.device
    probe = _nm.QuantErrorProbe() if numerics else None
    if ctx_tbl is not None:
        G = Hq // Hkv
        Pp = ctx_tbl.shape[1] * bs
        scale = 1.0 / math.sqrt(D)
        kv_int8 = kv_prefix + "ks" in pools
        # per-row absolute positions: row b's piece starts hist_len[b]
        # tokens into its sequence
        freq = c.rope_theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                              device=dev) / D)
        pos = hist_len.float()[:, None] + torch.arange(
            S, dtype=torch.float32, device=dev)[None, :]
        ang = pos[:, :, None] * freq[None, None, :]           # [B, S, D/2]
        cos, sin = torch.cos(ang), torch.sin(ang)
        pre_mask = (torch.arange(Pp, device=dev)[None, :]
                    < hist_len[:, None])[:, None, None, None, :]
        in_mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                        device=dev))[None, None, None]
        tbl = ctx_tbl.long()
    else:
        cos, sin = _rope_tables(S, D, c.rope_theta, dev)
    for l in range(c.num_layers):
        p = _layer(params, l)
        hn = _rms_norm(x, p["attn_norm"], c.rms_eps)
        q = _wo_mm(hn, p["wq"], dt).reshape(B, S, Hq, D)
        k = _wo_mm(hn, p["wk"], dt).reshape(B, S, Hkv, D)
        v = _wo_mm(hn, p["wv"], dt).reshape(B, S, Hkv, D)
        if ctx_tbl is None:
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
            _write_pools(pools, (slice(l, l + 1), flat),
                         k.reshape(1, -1, bs, Hkv, D),
                         v.reshape(1, -1, bs, Hkv, D), kv_prefix, probe)
            att = flash_attention_fwd(q, k, v, causal=True)[0].reshape(
                B, S, Hq * D)
        else:
            q, k = _apply_rope_at(q, cos, sin), _apply_rope_at(k, cos, sin)
            # the history, gathered before this layer's piece lands
            kpre = pools[pk][l][tbl].reshape(B, Pp, Hkv, D)
            vpre = pools[pv][l][tbl].reshape(B, Pp, Hkv, D)
            if kv_int8:
                ksc = pools[kv_prefix + "ks"][l][tbl].reshape(B, Pp, Hkv)
                vsc = pools[kv_prefix + "vs"][l][tbl].reshape(B, Pp, Hkv)
                kpre = kpre.to(dt) * ksc[..., None].to(dt)
                vpre = vpre.to(dt) * vsc[..., None].to(dt)
            _write_pools(pools, (slice(l, l + 1), flat),
                         k.reshape(1, -1, bs, Hkv, D),
                         v.reshape(1, -1, bs, Hkv, D), kv_prefix, probe)
            # softmax over [history ; causal in-piece]: masked history
            # positions contribute an exact 0.0
            qg = q.reshape(B, S, Hkv, G, D).float()
            s_pre = torch.einsum("bshgd,bphd->bhgsp", qg,
                                 kpre.float()) * scale
            s_in = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * scale
            s_pre = torch.where(pre_mask, s_pre,
                                torch.full_like(s_pre, NEG_INF))
            s_in = torch.where(in_mask, s_in, torch.full_like(s_in, NEG_INF))
            probs = torch.softmax(torch.cat([s_pre, s_in], dim=-1), dim=-1)
            att = (torch.einsum("bhgsp,bphd->bshgd", probs[..., :Pp].to(dt),
                                vpre.to(dt))
                   + torch.einsum("bhgst,bthd->bshgd",
                                  probs[..., Pp:].to(dt), v))
            att = att.reshape(B, S, Hq * D).to(dt)
        x = _mlp(x + _wo(att, p, dt, tp), p, c, tp)
    if probe is not None:
        probe.ship("kv_int8")
    x = _rms_norm(x, params["final_norm"], c.rms_eps)
    rows = torch.arange(B, device=x.device)
    last_h = x[rows, (true_len.long() - 1).clamp_min(0)]
    logits = _wo_mm(last_h, head_weight(params, c), dt).float()
    if tp is None:
        return _sample_rows(logits, generator, temps, top_ks, top_ps,
                            *sample_flags)
    return tp.agree(_sample_rows(tp.logits(logits), generator, temps, top_ks,
                                 top_ps, *sample_flags))


def _write_pools(pools, index, k, v, prefix: str = "", probe=None):
    """pools[prefix + "k"][index] = k and the same for v — quantized, with
    their scales into the "ks"/"vs" entries, when those pools are int8
    (the draft's ``dk``/``dv`` never are). ``probe`` (a
    ``numerics.QuantErrorProbe``) takes the quantized pairs."""
    pk, pv = prefix + "k", prefix + "v"
    if prefix + "ks" in pools:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        if probe is not None:
            probe.add(k, qk, sk, -1)
            probe.add(v, qv, sv, -1)
        pools[pk][index] = qk
        pools[pv][index] = qv
        pools[prefix + "ks"][index] = sk
        pools[prefix + "vs"][index] = sv
    else:
        pools[pk][index] = k.to(pools[pk].dtype)
        pools[pv][index] = v.to(pools[pv].dtype)


def _dense_layers(params, config, x, *, t: int, lens, ring_k, ring_v, kd,
                  vd, ksc, vsc, pre_mask, tp=None):
    """One decode step of every layer for x [N, h], the bucketed path's
    math (the JAX engine's dense body): per layer the fresh K/V row lands
    in the ring at index ``t`` (in place), and one masked softmax runs
    over [gathered prefix ; ring positions ``j <= t``]. ``kd``/``vd``
    [L, N, P, Hkv, D] are the call's gathered prefixes (int8 with their
    scales ``ksc``/``vsc`` [L, N, P, Hkv] under int8 pools, through
    ``attn_qk``/``attn_pv``); ``pre_mask`` [N, 1, 1, P] marks each slot's
    frozen prefix. Returns the post-layer-stack hidden state [N, h]."""
    c = config
    dt = c.dtype
    N = x.shape[0]
    S = ring_k.shape[2]
    P = kd.shape[2]
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
        qg = q.reshape(N, Hkv, G, D)
        s_rng = torch.einsum("nhgd,nshd->nhgs", qg.float(),
                             ring_k[l].float()) * scale
        s_rng = torch.where(ring_live, s_rng, torch.full_like(s_rng, NEG_INF))
        s_pre = attn_qk(qg, kd[l], None if ksc is None else ksc[l]) * scale
        s_pre = torch.where(pre_mask, s_pre, torch.full_like(s_pre, NEG_INF))
        probs = torch.softmax(torch.cat([s_pre, s_rng], dim=-1), dim=-1)
        p_rng = probs[..., P:].to(dt)
        att = (attn_pv(probs[..., :P], vd[l], None if vsc is None else vsc[l],
                       out_dtype=dt)
               + torch.einsum("nhgs,nshd->nhgd", p_rng.float(),
                              ring_v[l].float()).to(dt))
        att = att.reshape(N, Hkv * G * D).to(dt)
        x = _mlp(x + _wo(att, p, dt, tp), p, c, tp)
    return x


def _paged_decode(params, last_tokens, lengths, done0, budgets, generator,
                  active, block_table, pools, temps, top_ks, top_ps, eos_ids,
                  *, config: LlamaConfig, n_steps: int,
                  sample_flags=(True, True, True), mega: bool = False,
                  mega_multistep: bool = False, kv_prefix: str = "",
                  bucketed: bool = False, numerics: bool = False, tp=None):
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

    ``bucketed``: the dense-gather path instead. ``block_table`` arrives
    sliced to the engine's power-of-two bucket [N, nbk]; the call gathers
    every slot's prefix once, P = nbk * bs positions, and each step runs
    :func:`_dense_layers` (one masked softmax over [prefix ; ring]).

    ``kv_prefix="d"`` runs the call as the speculative draft's proposal
    loop (draft params and config, greedy flags, the ``dk``/``dv`` pools).
    ``mega_multistep`` (greedy, ``done0`` all false: the spec wave's
    draft) moves the step loop itself into the kernel: the ``n_steps``
    steps, argmax, bookkeeping and embedding gathers included, are ONE
    ``mega_decode_loop`` launch; the writeback stays shared.

    ``numerics``: the writeback's ``kv_int8`` quant-error probe over the
    ring (int8 pools, ``FLAGS_obs_numerics``).

    ``tp`` (a ``models.llama.TPPlan``): the rank's slice of a
    tensor-parallel engine (``config`` is the rank's own): B4's tp form on
    its heads, the plan's collectives, and each step's tokens broadcast
    from the first rank.

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
    if bucketed:
        # one dense gather of every slot's frozen prefix (int8 pools stay
        # int8: half the bytes moved); positions past a slot's length are
        # masked to -1e30, so the bucket's tail changes nothing
        tbl = block_table.long()
        sks, svs = pools.get(kv_prefix + "ks"), pools.get(kv_prefix + "vs")
        dense = dict(
            kd=pools[pk][:, tbl].reshape(Lc, N, P, Hkv, D),
            vd=pools[pv][:, tbl].reshape(Lc, N, P, Hkv, D),
            ksc=None if sks is None else sks[:, tbl].reshape(Lc, N, P, Hkv),
            vsc=None if svs is None else svs[:, tbl].reshape(Lc, N, P, Hkv),
            pre_mask=(torch.arange(P, device=dev)[None, :]
                      < lens0[:, None])[:, None, None, :])
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
        x0 = (params["embed"][last.long()] if tp is None
              else tp.embed(params["embed"], last)).to(dt)
        # both write the step's K/V rows into the rings in place
        kw = dict(t=t, block_table=block_table, walk_lens=walk_lens,
                  lens=lens, ring_k=ring_k, ring_v=ring_v, **pools_kw)
        if mega:
            x = mega_decode_step(params, c, x0=x0, **kw)[0]
        elif bucketed:
            x = _dense_layers(params, c, x0, t=t, lens=lens, ring_k=ring_k,
                              ring_v=ring_v, tp=tp, **dense)
        else:
            x = decode_layers(params, c, x0, tp=tp, **kw)
        xf = _rms_norm(x, params["final_norm"], c.rms_eps)
        logits = _wo_mm(xf, head_w, dt).float()
        if tp is None:
            nxt = _sample_rows(logits, generator, temps, top_ks, top_ps,
                               *sample_flags)
        else:
            nxt = tp.agree(_sample_rows(tp.logits(logits), generator, temps,
                                        top_ks, top_ps, *sample_flags))
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
    probe = _nm.QuantErrorProbe() if numerics else None
    _write_pools(pools, (slice(None), phys, off), ring_k, ring_v, kv_prefix,
                 probe)
    if probe is not None:
        probe.ship("kv_int8")
    return torch.stack(emitted), last, lens, done, rem


def _spec_verify(params, block_table, last, draft_toks, lengths, active,
                 pools, *, config: LlamaConfig, n_spec: int,
                 max_model_len: int, numerics: bool = False, tp=None):
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
    ``max_model_len`` go to trash block 0. ``numerics``: the writeback's
    ``kv_int8`` quant-error probe. ``tp``: the rank's slice of a
    tensor-parallel engine, as in :func:`_paged_prefill`. Returns the
    greedy grid [N, k+1] int32."""
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
    x = (params["embed"].to(dt)[tokens.long()] if tp is None
         else tp.embed(params["embed"], tokens).to(dt))
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
        x = _mlp(x + _wo(att, p, dt, tp), p, c, tp)

    # positional writeback (the decode ring's scatter at piece width)
    j = torch.arange(S, device=dev)[None, :]
    wpos = hist[:, None] + j                              # [N, S]
    valid = active[:, None] & (wpos < max_model_len)
    wposc = wpos.clamp(max=max_model_len - 1).long()
    phys = tbl.gather(1, (wposc // bs).clamp(max=nbk - 1))
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    probe = _nm.QuantErrorProbe() if numerics else None
    _write_pools(pools, (slice(None), phys, wposc % bs), torch.stack(k_all),
                 torch.stack(v_all), probe=probe)
    if probe is not None:
        probe.ship("kv_int8")
    x = _rms_norm(x, params["final_norm"], c.rms_eps)
    logits = _wo_mm(x, head_weight(params, c), dt).float()
    if tp is None:
        return logits.argmax(dim=-1).int()
    return tp.agree(tp.logits(logits).argmax(dim=-1).int())


# ---------------------------------------------------------------------------
# host engine
# ---------------------------------------------------------------------------
class LLMEngine:
    """Continuous-batching serving loop.

    >>> eng = LLMEngine(params, config, max_slots=4)
    >>> eng.add_request([1, 2, 3], max_new_tokens=32)
    >>> outputs = eng.run()          # {req_id: [generated tokens...]}

    ``step()`` admits queued requests, keeps the card fed and returns the
    (req_id, token) pairs that became host-visible — the streaming hook.
    ``params`` must live on ``device`` (``"cuda"`` by default; ``"cpu"``
    runs the kernels' plain versions).

    Chained decode: call k+1 is dispatched BEFORE call k's tokens are
    read whenever no slot of call k can finish inside it (``_spec_safe``:
    no eos token, budget beyond the call), so the readback overlaps the
    next call's work; the stream then lags the card by one call. Every
    readback is counted in ``readbacks`` as ``"chained"`` (a call was
    queued behind it) or ``"drained"`` (the card had nothing left).

    ``draft_params``/``draft_config``: a second, smaller llama sharing the
    target's vocabulary (``models.llama.draft_config``), the speculative
    draft. A decode wave whose slots are all greedy and whose draft K/V
    cover their contexts runs draft-then-verify: ``spec_tokens`` proposals
    a slot, one verify call, and the agreeing prefix plus the target's
    token committed (capped at ``spec_tokens``, at least one token a
    wave) — exactly the non-speculative greedy streams. A spec wave
    drains the pipeline first (acceptance is a host decision). Other
    waves take the normal decode path (a slot advanced there stays out of
    spec waves until it is re-prefilled). ``spec=False`` leaves the
    engine as it is without a draft. The counters ``spec_waves``,
    ``spec_proposed``, ``spec_accepted``, ``spec_committed``,
    ``spec_draft_steps`` and ``spec_verify_calls`` are kept on the host;
    ``spec_draft_paths`` counts the draft calls by kernel path.

    ``prefix_cache``: a refcounted radix index over the block pool
    (``serving.prefix_cache``) — an admission matches the longest cached
    prefix at block granularity, pins those blocks into the slot's table
    and prefills ONLY the suffix. Cached blocks are LRU-evicted at
    refcount 0 under pool pressure, spilling to a host tier of
    ``prefix_cache_host_bytes`` (0 = drop instead of spill) and restoring
    on a later match.

    ``prefill_chunk``: split suffix prefills longer than this many tokens
    into chunks (rounded up to a block-size multiple), one chunk a slot a
    step, interleaved with the other slots' decode calls. 0 = one-shot.

    ``kv_swap_bytes``: capacity of the host KV swap tier
    (``serving.kv_swap``). Non-zero turns preemption from recompute into
    swap: the victim's blocks move to host memory and re-admission
    restores them bit-exactly instead of re-prefilling; recompute stays
    the fallback when the host pool is full (``swap_fallbacks``).

    ``kv_offload``: how the host tiers move their bytes
    (``serving.offload``). ``"async"`` — spills copy on a side stream
    and land at a step boundary (their blocks ride the ledger's
    ``in_flight`` term until then), queued restores prefetch h2d ahead of
    admission, and refcount-0 cached blocks spill proactively under pool
    pressure. ``"sync"`` — inline transfers. ``"auto"`` (default) follows
    ``FLAGS_serve_kv_offload_sync``. Greedy streams are equal either way.
    Ignored when no host tier is configured.

    ``decode_kernel``: ``"ragged"`` (B4's true-length walk), ``"mega"``
    (B5, one launch a step), ``"bucketed"`` (the dense-gather path over a
    power-of-two prefix bucket, plain torch; ``decode_paths`` counts it
    ``"bucketed"``, or ``"dense"`` at the full-width bucket) or
    ``"auto"``: mega on the card at ``max_slots <= 4``, else ragged (on
    the CPU its plain version). The JAX engine's "auto" picks bucketed
    off a TPU; this one does not, on purpose: the card has the kernels.

    ``admission``: an :class:`AdmissionConfig` (or a prebuilt
    :class:`AdmissionController`) enabling load shedding —
    ``add_request`` raises :class:`ShedError` (queue_full /
    rate_limited / pool_pressure) instead of queueing without bound.
    ``None`` admits everything.

    ``injector``: a ``distributed.resilience.FaultInjector`` whose serving
    kinds (``readback_fail``, ``slow_step``, ``pool_squeeze``,
    ``spec_verify_fail``, ``offload_crash``, keyed by engine step index)
    fire inside the step loop — the chaos surface behind
    :class:`~paddle_tpu_torch.serving.resilient.ResilientEngine`.

    ``role`` / ``relay`` (disaggregated serving): ``role`` declares which
    phase of a request this engine serves — ``"both"`` (default: the
    colocated engine), ``"decode"`` (identical engine behavior; a
    placement hint for the ReplicaRouter, which keeps fresh prefills off
    it when a prefill-capable replica is healthy), or ``"prefill"``: the
    engine runs admission + (chunked) prefill ONLY — as soon as a slot's
    first token is host-visible it copies the slot's pool blocks
    (payload + scales bit-exact, the swap-out d2h path) into the shared
    host ``relay`` pool (``HostKVPool(kind="relay")``) keyed by request
    id, frees the slot, and finishes the request with reason
    ``"handoff"`` — partial result: the first token. A decode/both
    engine admitting a request whose ``relay_key`` finds a relay entry
    restores it with the batched h2d scatter of a swap-in instead of
    prefilling; a missing or incomplete entry degrades to a full prefill
    of the same context — greedy streams equal a colocated engine's
    either way. ``role="prefill"`` requires a ``relay``.

    ``finish_reasons`` maps every minted request id to exactly one of
    ``finished``, ``shed``, ``deadline_exceeded``, ``handoff`` (a
    prefill-role engine's terminal) or a cancellation's reason
    (``client_disconnected`` by default).
    """

    def __init__(self, params, config: LlamaConfig, max_slots: int = 4,
                 block_size: int = 16, max_model_len: int = 512,
                 num_blocks: Optional[int] = None,
                 prompt_buckets: Optional[List[int]] = None, seed: int = 0,
                 decode_steps: int = 1, decode_kernel: str = "auto",
                 kv_dtype=None, device="cuda", draft_params=None,
                 draft_config: Optional[LlamaConfig] = None,
                 spec_tokens: int = 4, spec: bool = True,
                 kv_swap_bytes: int = 0, prefix_cache: bool = False,
                 prefill_chunk: int = 0, prefix_cache_host_bytes: int = 0,
                 kv_offload: str = "auto", admission=None, injector=None,
                 role: str = "both", relay: Optional[HostKVPool] = None,
                 mesh=None):
        if mesh is not None and not is_mesh(mesh):
            raise TypeError(
                f"mesh must be a torch.distributed.device_mesh.DeviceMesh "
                f"with a 'tp' dim, got {type(mesh).__name__}")
        tp = axis_size(mesh, "tp")
        if decode_kernel not in ("auto", "ragged", "bucketed", "mega"):
            raise ValueError(f"decode_kernel must be 'auto', 'ragged', "
                             f"'bucketed' or 'mega', got {decode_kernel!r}")
        if kv_dtype not in (None, "int8", torch.int8):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if kv_offload not in ("auto", "async", "sync"):
            raise ValueError(
                f"kv_offload must be 'auto', 'async' or 'sync', got "
                f"{kv_offload!r}")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'both', got "
                f"{role!r}")
        if relay is not None and getattr(relay, "kind", None) != "relay":
            raise ValueError(
                "relay must be a HostKVPool(kind='relay') shared "
                "between the prefill and decode replicas")
        if role == "prefill" and relay is None:
            raise ValueError(
                "role='prefill' requires a relay pool — the handed-off "
                "KV has to live somewhere the decode replica can reach")
        if max_model_len % block_size:
            raise ValueError(f"max_model_len {max_model_len} is not a "
                             f"multiple of block_size {block_size}")
        self.device = resolve_device(device)
        c = config
        if c.num_kv_heads % tp:
            raise ValueError(
                f"tp={tp} must divide num_kv_heads={c.num_kv_heads}")
        # a tp engine takes the whole params on the card or the host and
        # keeps this rank's slice on the card
        bad = [k for k, t in _tensors(params) if t.device != self.device
               and not (tp > 1 and t.device.type == "cpu")]
        if bad:
            raise ValueError(f"params {bad[:3]} are not on {self.device}")
        self.mesh = mesh
        self._tp = None
        if tp > 1:
            shardings = make_serving_shardings(params, c, mesh, fsdp=False)
            params = shard_params(params, shardings, mesh,
                                  device=self.device)
            self._tp = TPPlan(mesh, c, shardings)
        # the device programs' config: the rank's own head and FFN counts
        self._dc = c if self._tp is None else self._tp.config
        self.params = params
        self.config = config
        if self._tp is not None:
            self._tp_check()
        self.role = role
        self.relay = relay
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
        pool_shape = (c.num_layers, self.nb, block_size,
                      self._dc.num_kv_heads, c.head_dim)
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
                   if t.device != self.device
                   and not (tp > 1 and t.device.type == "cpu")]
            if bad:
                raise ValueError(f"draft_params {bad[:3]} are not on "
                                 f"{self.device}")
            if tp > 1:
                # the draft stays whole on every rank (its kv heads need
                # not divide tp); its proposals are broadcast like tokens
                self.draft_params = shard_params(
                    draft_params, make_replicated_shardings(draft_params,
                                                            mesh),
                    mesh, device=self.device)
            # the draft's pools share the target's block grid (one block
            # backs both models' K/V for its positions, so the allocator,
            # the prefix cache and the swap tier need no new bookkeeping)
            # and stay in the draft's dtype
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
        # decode dispatches by path, and mega picks the screen refused by
        # reason (the JAX engine's serving_decode_kernel_total and
        # serving_mega_fallback_total)
        self.decode_paths: Counter = Counter()
        self.mega_fallbacks: Counter = Counter()
        # decode-record readbacks: "chained" (the next call was already
        # queued) or "drained" (read with the card's queue empty)
        self.readbacks: Counter = Counter()
        # decode variant keys used so far — the JAX engine's compiled-
        # variant keys ((path or bucket, flags)); the first use of each
        # counts in serving_decode_recompiles_total
        self._decode_variants: set = set()
        # swap-enabled preemptions that fell back to recompute
        self.swap_fallbacks = 0
        # disaggregated handoffs this prefill-role engine completed, and
        # their d2h + relay bytes and seconds
        self.handoffs = 0
        self.handoff_bytes = 0
        self.handoff_seconds = 0.0
        # observability: add_request and first-token-visible times of the
        # live requests (TTFT / TPOT), and the counted FLOPs of this
        # step's decode call (the MFU numerator; None on a no-decode step)
        self._obs_t_add: Dict[int, float] = {}
        self._obs_t_first: Dict[int, float] = {}
        self._last_decode_flops = None
        # device-resident decode carry (last, lengths, done, budgets) and
        # the per-slot vectors (active, temps, top_ks, top_ps, eos ids):
        # the carry chains from call to call and is rebuilt from host
        # state only when the pipeline is drained; the vectors and the
        # table are uploaded again only when they changed
        self._carry = None
        self._slot_vecs = None
        self._slots_dirty = True
        self._table_dirty = True
        self._table_dev = None
        # the dispatched-but-unread decode call (pipeline depth 1)
        self._inflight = None
        # admissions whose device-sampled first token has not been read
        # back yet: (slot, req_id, the wave's _Readback, row); attached to
        # the next dispatch record
        self._pending_adm: List = []
        # -- host tiers ----------------------------------------------------
        self.swap_pool = (HostKVPool(kv_swap_bytes) if kv_swap_bytes
                          else None)
        # one transfer engine whenever any host tier exists; "auto"
        # defers the sync decision to FLAGS_serve_kv_offload_sync
        self.offload = (OffloadEngine(
            sync=None if kv_offload == "auto" else kv_offload == "sync",
            device=self.device)
            if (kv_swap_bytes or (prefix_cache and prefix_cache_host_bytes))
            else None)
        # -- survivability: shedding, deadlines, cancellation, chaos -----
        self.admission = (AdmissionController(admission)
                          if isinstance(admission, AdmissionConfig)
                          else admission)
        # proactive-spill pressure threshold: the flag, raised to twice
        # the admission shed threshold when one is set (spilling must
        # engage before shedding)
        self._spill_free_frac = float(
            get_flag("serve_kv_offload_spill_free_frac"))
        if isinstance(self.admission, AdmissionController):
            self._spill_free_frac = self.admission.spill_free_frac(
                self._spill_free_frac)
        self.injector = injector
        # terminal disposition per minted request id: finished / shed /
        # deadline_exceeded / a cancellation's reason
        self.finish_reasons: Dict[int, str] = {}
        self.cancel_noops = 0   # cancels that raced a terminal reason
        self._step_idx = 0
        # blocks an injected pool_squeeze holds, with their release step
        self._squeezed: List = []
        # live requests carrying a deadline: the expiry sweep is skipped
        # at 0, so deadline-free traffic pays nothing for the feature
        self._deadline_live = 0
        # rid -> reason marked by cancel_request, applied at the next step
        # boundary; the lock makes the handoff safe from any thread
        self._cancels: Dict[int, str] = {}
        self._cancel_lock = threading.Lock()
        # every (rid, tok) committed host-side THIS step, in commit order:
        # the salvage buffer ResilientEngine delivers after a crash
        self._step_emitted: List = []
        # swap-ins whose carry lanes await their host-known state
        # ((slot, req_id); the recompute path uses _pending_adm instead)
        self._pending_swapin: List = []
        # slots (re)admitted by swap since the last dispatch: their
        # rem_start comes from host state, never the previous record's
        # chained countdown (the slot id may be recycled)
        self._fresh_swapins: set = set()
        # -- prefix cache + chunked prefill --------------------------------
        if prefill_chunk:
            # chunks start and (but for the last) end on block
            # boundaries, so cached prefixes and chunk history stay
            # block-aligned — round up rather than reject
            prefill_chunk = -(-int(prefill_chunk) // block_size) \
                * block_size
            if prefill_chunk > self.buckets[-1]:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} exceeds the largest "
                    f"prompt bucket {self.buckets[-1]}")
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = (
            PrefixCache(block_size,
                        HostKVPool(prefix_cache_host_bytes, kind="prefix")
                        if prefix_cache_host_bytes else None)
            if prefix_cache else None)
        # trie nodes each slot has pinned, in block-table order: the first
        # len(_pinned[slot]) table entries are cache-owned (shared, never
        # freed by the slot — unpinned instead)
        self._pinned: List[List] = [[] for _ in range(self.N)]
        # slots mid-chunked-prefill: slot -> {"ctx", "pos", "rid"};
        # excluded from decode dispatch until the final chunk lands
        self._chunks: Dict[int, Dict] = {}

    def _tp_check(self) -> None:
        """One all-reduce of the model dtype on the engine's device: a
        process group that cannot carry the engine's tensors (an NCCL
        group with CPU tensors, a backend without the dtype) raises here,
        at construction, never mid-stream."""
        probe = torch.ones(1, dtype=self.config.dtype, device=self.device)
        try:
            self._tp.reduce(probe)
        except Exception as e:
            from ..distributed.collective import get_backend
            raise RuntimeError(
                f"tp serving: the {get_backend(self._tp.group)!r} process "
                f"group cannot carry {self.config.dtype} tensors on "
                f"{self.device} ({e})") from e
        self._tp.counts.clear()

    @property
    def tp_collectives(self) -> Counter:
        """The collectives this rank's programs ran, by kind (empty
        without a tp mesh)."""
        return Counter() if self._tp is None else Counter(self._tp.counts)

    # -- public api ---------------------------------------------------------
    def add_request(self, prompt: List[int], **kw) -> int:
        """Queue a request and return its id. A request the engine can
        never serve raises before an id is minted; one that admission
        control sheds gets an id, finish reason ``shed`` and raises
        :class:`ShedError` carrying both."""
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
        rid = self._next_id
        self._next_id += 1
        if req.deadline_s is not None:
            req.t_deadline = time.perf_counter() + float(req.deadline_s)
        if self.admission is not None:
            # cache-aware pressure: refcount-0 cached blocks are
            # reclaimable, so they count as headroom
            reason = self.admission.check(
                req, queue_depth=len(self.queue),
                free_frac=self._avail_blocks() / max(1, self.nb - 1))
            if reason is not None:
                # reject-newest: fail THIS request at once so the
                # admitted ones keep their latency
                self.finish_reasons[rid] = "shed"
                _flight.record("request_shed", req_id=rid, reason=reason)
                if _obs.enabled():
                    tracer = _rt.get_request_tracer()
                    tracer.submit(rid, prompt_tokens=len(req.prompt),
                                  max_new_tokens=req.max_new_tokens,
                                  tenant=req.tenant)
                    tracer.finish(rid, tokens=0, reason="shed",
                                  shed_reason=reason)
                raise ShedError(reason, rid)
        self.queue.append(req)
        if req.t_deadline is not None:
            self._deadline_live += 1
        if _obs.enabled():
            self._obs_t_add[rid] = time.perf_counter()
            _M_QUEUE_DEPTH.set(len(self.queue))
            # the id minted here is the request's trace id: it follows
            # the request through slots, preemptions and re-admissions
            _rt.get_request_tracer().submit(
                rid, prompt_tokens=len(req.prompt),
                max_new_tokens=req.max_new_tokens, tenant=req.tenant)
        return rid

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def run(self) -> Dict[int, List[int]]:
        while self.has_work():
            self.step()
        if self._inflight is not None:      # defensive: step() drains first
            self._process_inflight()
        self.drain_offload()                # land stragglers: in_flight -> 0
        return self.results

    def step(self):
        """Admit queued requests, keep the card fed, and return the
        (req_id, token) pairs that became host-visible this call.

        Chained: decode call k+1 is dispatched BEFORE call k's tokens are
        read whenever no in-flight slot can finish mid-call
        (``_spec_safe``), so the readback overlaps the next call. A step
        runs, in order: the injected faults, deadline expiry, the
        cancellations, the offload sweep (landed spills, proactive
        spills, prefetch), one chunk for every mid-prefill slot,
        admission, then a spec wave (pipeline drained first) or a decode
        dispatch.

        Observability (``FLAGS_obs_enabled``): each call lands a
        ``serving.step`` span (prefill/decode/readback nested inside), a
        step-duration and tokens/s observation, TTFT (with a request_id
        exemplar) for requests whose first token became visible, a
        decode tick on each request's timeline, the MFU and HBM gauges
        and the queue/slot/KV-pool gauges. Off, this wrapper costs one
        boolean check (plus the idle profiler tick's attribute read)."""
        # the on-demand capture window's boundary: outside the enabled()
        # gate — a capture is an explicit operator action
        _profiling.step_tick()
        if not _obs.enabled():
            return self._step_inner()
        t0 = time.perf_counter()
        with trace_span("serving.step"):
            emitted = self._step_inner()
        now = time.perf_counter()
        dt = now - t0
        _M_STEP_SECONDS.observe(dt)
        if emitted:
            _M_TOKENS.inc(len(emitted))
            if dt > 0:
                _M_TPS.observe(len(emitted) / dt)
            tracer = _rt.get_request_tracer()
            step_toks: Dict[int, int] = {}
            for rid, _tok in emitted:
                step_toks[rid] = step_toks.get(rid, 0) + 1
                t_add = self._obs_t_add.pop(rid, None)
                if t_add is not None:
                    tracer.record(rid, "first_token")
                    _rt.observe_with_exemplar(_M_TTFT, now - t_add, rid)
                    self._obs_t_first[rid] = now
            for rid, n in step_toks.items():
                # one decode tick per request per step (finished requests
                # already left the live table: a no-op there)
                tracer.record(rid, "decode", tokens=n)
        if self._last_decode_flops:
            m = _perf.mfu(self._last_decode_flops, dt, self.device)
            if m is not None:
                _M_SERVING_MFU.set(m)
        _perf.update_serving_slo_gauges(_M_TTFT, _M_TPOT)
        _perf.update_hbm_gauges(self.device.index or 0)
        _M_QUEUE_DEPTH.set(len(self.queue))
        _M_ACTIVE_SLOTS.set(sum(r is not None for r in self.slot_req))
        _M_KV_BLOCKS.set(self.nb - 1)
        _M_KV_USED.set(self.nb - 1 - len(self.free_blocks))
        if self.prefix_cache is not None:
            self.prefix_cache.update_gauges()
        # time-series sampler: throttled by FLAGS_obs_ts_interval_s and
        # contention-free — a concurrent replica already sampling means
        # this step skips instead of waiting
        _ts.step_tick()
        return emitted

    def _step_inner(self):
        emitted = []
        self._step_emitted = []
        self._step_idx += 1
        # chaos, deadlines and cancellations run before admission: an
        # injected squeeze shapes this step's block budget, and an
        # expired or cancelled request must not hold a slot a live one
        # could take
        self._apply_faults()
        self._expire_deadlines()
        self._apply_cancels()
        # the offload sweep after cancellations (a dead request is not
        # staged) and before admission (blocks a landed spill frees are
        # allocatable this step)
        self._offload_tick()
        # stale FLOPs from an earlier dispatch must not divide a
        # no-decode step's wall time
        self._last_decode_flops = None
        self._advance_chunks()
        self._admit()
        if self.role == "prefill":
            # disaggregated: no decode ever dispatches here — slots whose
            # prefill (chunked included) just completed hand their K/V to
            # the relay and their stream to a decode replica
            return emitted + self._prefill_handoffs()
        if self._spec_on:
            active = self._decode_slots()
            if active and self._spec_eligible(active):
                # a spec wave syncs on its own acceptance decision: drain
                # the pipeline first (host state must be exact), refill
                # freed slots, then draft -> verify -> commit
                if self._inflight is not None:
                    emitted += self._process_inflight()
                    self._admit()
                    active = self._decode_slots()
                if active and self._spec_eligible(active):
                    return emitted + self._spec_wave(active)
        if self._inflight is not None and not self._spec_safe():
            emitted += self._process_inflight()
            self._admit()          # freed slots: refill before dispatching
        active = self._decode_slots()
        if not active:
            if self._inflight is not None:
                emitted += self._process_inflight()
            return emitted
        emitted += self._back_or_preempt()
        active = self._decode_slots()
        if not active:
            return emitted
        self._refresh_carry(active)
        prev = self._dispatch_decode(active)
        if prev is not None:
            self.readbacks["chained"] += 1
            emitted += self._process(prev)
        return emitted

    def block_accounting(self) -> Dict[str, int]:
        """Device block-pool ledger: ``free + backed + cached + squeezed
        + in_flight == total`` at every step boundary, through eviction,
        preemption (swap or recompute) and cache spills. ``backed``
        counts blocks a slot owns PRIVATELY; a cache-owned block counts
        once under ``cached`` however many slots pin it. ``in_flight``
        counts blocks parked behind an async swap-out d2h still moving (0
        whenever no transfer is in flight). ``squeezed`` counts the
        blocks an injected ``pool_squeeze`` holds until its release.
        ``host_spilled_blocks`` (prefix-cache blocks
        resident only in the host tier) and ``swapped_host_blocks`` ride
        along — those blocks are not in the sum. The draft's ``dk``/
        ``dv`` pools share the block ids, so speculative decoding adds no
        terms."""
        pc = self.prefix_cache
        return {
            "total": self.nb - 1,
            "free": len(self.free_blocks),
            "backed": int(sum(int(self.n_alloc[i]) - len(self._pinned[i])
                              for i in range(self.N))),
            "cached": pc.device_blocks if pc is not None else 0,
            "squeezed": sum(len(b) for _, b in self._squeezed),
            "in_flight": (self.offload.held_blocks
                          if self.offload is not None else 0),
            "host_spilled_blocks": (pc.host_blocks if pc is not None
                                    else 0),
            "swapped_host_blocks": (self.swap_pool.swapped_blocks
                                    if self.swap_pool is not None else 0),
        }

    def drain_offload(self) -> None:
        """Land every in-flight offload transfer NOW (blocking) — the
        run()-exit / quiescence hook, so a drained engine's ledger shows
        ``in_flight == 0`` and the host tiers hold exactly their
        committed entries."""
        if self.offload is not None:
            self.free_blocks.extend(self.offload.poll(block=True))

    # -- survivability: deadlines, cancellation, chaos, recovery -----------
    def cancel_request(self, rid: int,
                       reason: str = "client_disconnected") -> None:
        """Mark a live request for cancellation (a dropped connection, a
        stalled reader, a drain cutoff). Applied at the NEXT step
        boundary, so any thread may call this: a queued victim finishes
        at once with its partial tokens, an in-slot victim has its slot
        and KV blocks freed and its lanes of an unread in-flight call
        skipped at readback (the (slot, rid) snapshot check). An
        already-terminal rid is a counted no-op (``cancel_noops``)."""
        if rid in self.finish_reasons:
            self.cancel_noops += 1
            _M_CANCEL_NOOP.inc()
            return
        with self._cancel_lock:
            self._cancels[rid] = str(reason)

    def _active_slots(self):
        return [i for i in range(self.N) if self.slot_req[i] is not None]

    def _finish_expired(self, req: Request, out: List[int], queued: bool,
                        reason: str = "deadline_exceeded") -> None:
        """Terminal bookkeeping for a QUEUED request evicted before any
        slot (deadline expiry or a cancellation): its partial tokens
        become its result. A rid that already has a terminal reason is a
        counted no-op — never a double free of its swap/offload state."""
        rid = req.req_id
        if rid in self.finish_reasons:
            self.cancel_noops += 1
            _M_CANCEL_NOOP.inc()
            return
        self.results[rid] = out
        self.finish_reasons[rid] = reason
        if req.t_deadline is not None:
            self._deadline_live = max(0, self._deadline_live - 1)
        if self.swap_pool is not None:
            self.swap_pool.discard(rid)
            if self.offload is not None:
                self.free_blocks.extend(self.offload.cancel(rid))
        if reason == "deadline_exceeded":
            _M_DEADLINE.inc()
        _flight.record(reason, req_id=rid, queued=queued, tokens=len(out))
        self._obs_t_add.pop(rid, None)
        self._obs_t_first.pop(rid, None)
        if _obs.enabled():
            _rt.get_request_tracer().finish(rid, tokens=len(out),
                                            reason=reason)

    def _apply_cancels(self) -> None:
        """Evict every request marked by :meth:`cancel_request` — queued
        and in-slot. Free when nothing is marked (the unlocked emptiness
        probe is safe: a marker racing past it is applied next step)."""
        if not self._cancels:
            return
        with self._cancel_lock:
            cancels, self._cancels = self._cancels, {}
        live = {req.req_id for req in self.queue} \
            | {r.req_id for r in self.slot_req if r is not None}
        kept = {rid: rsn for rid, rsn in cancels.items() if rid in live}
        # markers that raced a natural finish: counted no-ops
        dropped = len(cancels) - len(kept)
        if dropped:
            self.cancel_noops += dropped
            _M_CANCEL_NOOP.inc(dropped)
        cancels = kept
        if not cancels:
            return
        if any(req.req_id in cancels for req in self.queue):
            queue = deque()
            for req in self.queue:
                if req.req_id in cancels:
                    self._finish_expired(req, list(req.generated),
                                         queued=True,
                                         reason=cancels[req.req_id])
                else:
                    queue.append(req)
            self.queue = queue
        for slot in self._active_slots():
            req = self.slot_req[slot]
            if req.req_id in cancels:
                self._free_slot(slot, reason=cancels[req.req_id])

    def _expire_deadlines(self) -> None:
        """Evict every request past its deadline — queued and in-slot
        (KV blocks freed; the in-flight record's lanes for the slot are
        skipped at readback). Free when no live request has a
        deadline."""
        if not self._deadline_live:
            return
        now = time.perf_counter()
        if any(r.t_deadline is not None and now >= r.t_deadline
               for r in self.queue):
            queue = deque()
            for req in self.queue:
                if req.t_deadline is not None and now >= req.t_deadline:
                    self._finish_expired(req, list(req.generated),
                                         queued=True)
                else:
                    queue.append(req)
            self.queue = queue
        for slot in self._active_slots():
            req = self.slot_req[slot]
            if req.t_deadline is not None and now >= req.t_deadline:
                self._free_slot(slot, reason="deadline_exceeded")

    def _apply_faults(self) -> None:
        """Release expired pool squeezes, then fire this step's injected
        ``slow_step`` and ``pool_squeeze`` (``readback_fail`` fires in
        :meth:`_process`, ``spec_verify_fail`` in :meth:`_spec_wave`,
        ``offload_crash`` in :meth:`_offload_tick`)."""
        if self._squeezed:
            keep = []
            for release_step, blocks in self._squeezed:
                if self._step_idx >= release_step:
                    self.free_blocks.extend(blocks)
                else:
                    keep.append((release_step, blocks))
            self._squeezed = keep
        inj = self.injector
        if inj is None:
            return
        if inj.fires("slow_step", self._step_idx):
            _flight.record("injected_slow_step", step=self._step_idx)
            time.sleep(0.02)
        if inj.fires("pool_squeeze", self._step_idx):
            n = min(max(1, (self.nb - 1) // 2), len(self.free_blocks))
            taken = [self.free_blocks.popleft() for _ in range(n)]
            if taken:
                self._squeezed.append((self._step_idx + 2, taken))
            _flight.record("injected_pool_squeeze", step=self._step_idx,
                           blocks=len(taken))

    def recover_crashed_step(self) -> None:
        """Recovery from a crashed ``step()`` (ResilientEngine): drop the
        poisoned in-flight wave — its tokens were never host-visible, so
        the stream stays exactly-once — and requeue every request in a
        slot from its host state for a recompute re-admission (the pools'
        contents are suspect, so the swap tier is bypassed). Every
        in-flight spill is abandoned and the prefix cache cleared. The
        device carry is rebuilt from host state at the next dispatch.

        The dropped call's d2h copies into pinned memory are waited for
        first, so no pinned buffer goes back to the host allocator under
        a running copy; a device fault there raises."""
        rec = self._inflight
        adm = self._pending_adm + (rec["adm"] if rec is not None else [])
        for rb in ([rec["toks"]] if rec is not None else []) \
                + [wave for _s, _rid, wave, _i in adm]:
            rb.wait()
        self._inflight = None
        self._pending_adm = []
        self._pending_swapin = []
        self._fresh_swapins = set()
        self._carry = None
        self._slots_dirty = True
        for slot in self._active_slots():
            self._free_slot(slot, requeue=True, swap=False)
        self._chunks = {}
        if self.offload is not None:
            # the poisoned-wave rule extends to transfers: every in-flight
            # spill is abandoned (reservations released, nothing
            # half-landed commits) and its custody blocks freed; staged
            # prefetch buffers drop too
            self.free_blocks.extend(self.offload.abandon())
        if self.prefix_cache is not None:
            # cached K/V is as suspect as the rest of the pools
            self.free_blocks.extend(self.prefix_cache.clear())

    # -- internals ----------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _upload(self, arr) -> torch.Tensor:
        return upload(arr, self.device)

    def _table(self) -> torch.Tensor:
        """The block table on the device, uploaded again only after a
        change (full width: the kernels read each slot's true length)."""
        if self._table_dirty or self._table_dev is None:
            self._table_dev = self._upload(self.table)
            self._table_dirty = False
        return self._table_dev

    # -- block allocation over the free list + the prefix cache ------------
    def _avail_blocks(self) -> int:
        """Blocks an allocation could obtain right now: the free list plus
        every refcount-0 cached block (reclaimable by spill/drop)."""
        n = len(self.free_blocks)
        if self.prefix_cache is not None:
            n += self.prefix_cache.evictable_blocks
        return n

    def _take_up_to(self, k: int) -> List[int]:
        """Pop up to ``k`` free blocks, reclaiming from the prefix cache
        (LRU spill-then-drop) when the free list runs short — ONE reclaim
        sweep and one batched d2h however many blocks are needed."""
        if len(self.free_blocks) < k and self.prefix_cache is not None:
            self.free_blocks.extend(self.prefix_cache.reclaim(
                k - len(self.free_blocks), self._fetch_blocks))
        out: List[int] = []
        while self.free_blocks and len(out) < k:
            out.append(self.free_blocks.popleft())
        return out

    def _fetch_blocks(self, blks: List[int]) -> Dict:
        """d2h a batch of blocks from every pool entry in one gather per
        entry (payload AND scales under int8 pools — the spill/restore
        round trip is bit-exact), blocking, into pinned host tensors on
        the card. Returns CPU tensors stacked on the block axis, the
        layout :meth:`PrefixCache.reclaim` slices per node."""
        arrays = gather_blocks(self.pools, blks)
        if self.device.type != "cuda":
            return arrays
        return {n: torch.empty(a.shape, dtype=a.dtype,
                               pin_memory=True).copy_(a)
                for n, a in arrays.items()}

    def _swapin(self, blks: List[int], data: Dict) -> None:
        """Scatter every restored pool entry into blocks ``blks`` in
        place (one ``index_copy_`` on the block axis an entry)."""
        idx = self._upload(torch.tensor(blks, dtype=torch.long))
        for name, d in data.items():
            self.pools[name].index_copy_(1, idx, d)

    def _restore_blocks(self, blks: List[int], ents: List) -> None:
        """h2d a matched path's spilled blocks in ONE batched scatter —
        never a transfer per block on the admission path. Entries the
        offload engine staged ahead of time (``SwapEntry.staged``) are
        prefetch hits; the rest transfer here and the observed wait
        counts as a stall."""
        names = sorted(ents[0].data)
        staged_i = [i for i, e in enumerate(ents) if e.staged is not None]
        fresh_i = [i for i, e in enumerate(ents) if e.staged is None]
        # reorder entries staged-first WITH their blocks (the scatter
        # pairs blks[i] with slice i, so any consistent permutation is
        # exact): every fresh payload batches into one h2d an entry
        blks = [blks[i] for i in staged_i + fresh_i]
        t0 = time.perf_counter()
        fresh_up = {}
        if fresh_i:
            fresh_up = self.offload.upload_inline({n: torch.cat(
                [ents[i].data[n] for i in fresh_i], dim=1)
                if len(fresh_i) > 1 else ents[fresh_i[0]].data[n]
                for n in names})
            self.offload.note_stall(time.perf_counter() - t0,
                                    n=len(fresh_i))
        if staged_i:
            self.offload.note_hit(len(staged_i))
        staged = [take_staged(ents[i]) for i in staged_i]
        stacked = {}
        for n in names:
            parts = [st[n] for st in staged]
            if fresh_i:
                parts.append(fresh_up[n])
            stacked[n] = torch.cat(parts, dim=1) if len(parts) > 1 \
                else parts[0]
        self._swapin(blks, stacked)

    def _free_slot(self, slot: int, requeue: bool = False,
                   reason: str = "finished", swap: bool = True):
        """Release a slot: requeue its request (preemption: swap unless
        ``swap=False``, else recompute) or end it with ``reason``."""
        req = self.slot_req[slot]
        out = self.slot_out[slot]
        swapped, held = False, []
        if requeue and req is not None and swap \
                and self.swap_pool is not None:
            # swap instead of recompute: move the victim's blocks to the
            # host tier BEFORE they are freed (fallback: recompute; async
            # mode parks `held` with the in-flight transfer)
            swapped, held = self._swap_out(slot, req, out)
            if not swapped:
                self.swap_fallbacks += 1
        # blocks [0, keep) are cache-owned: shared, unpinned below, never
        # freed here. A finishing request first offers its decode-grown
        # FULL blocks to the trie (multi-turn prefix reuse: the next turn
        # re-sends prompt+answer and matches them)
        keep = len(self._pinned[slot])
        if not requeue and req is not None and reason == "finished" \
                and self.prefix_cache is not None:
            # K/V are valid for the first self.lengths positions only
            # (the final emitted token's K/V were never written)
            full = int(self.lengths[slot]) // self.bs
            if full > keep:
                ctx_all = req.prompt + req.generated + out
                adopted = self.prefix_cache.extend(
                    ctx_all, keep,
                    [int(self.table[slot, j]) for j in range(keep, full)],
                    pin=False)
                keep += len(adopted)
        held_set = set(held)
        for j in range(keep, int(self.n_alloc[slot])):
            blk = int(self.table[slot, j])
            if blk not in held_set:     # custody: frees when the spill lands
                self.free_blocks.append(blk)
        if self._pinned[slot]:
            self.prefix_cache.unpin(self._pinned[slot])
            self._pinned[slot] = []
        self._chunks.pop(slot, None)
        self.table[slot, :] = 0
        self.n_alloc[slot] = 0
        self.lengths[slot] = 0
        self._draft_len[slot] = 0
        self.slot_req[slot] = None
        if slot in self.admit_order:
            self.admit_order.remove(slot)
        self.slot_out[slot] = []
        self._table_dirty = True
        self._slots_dirty = True
        # an admission whose first token was never read back dies with the
        # slot (recompute semantics: re-admission prefills and re-samples)
        self._pending_adm = [e for e in self._pending_adm if e[0] != slot]
        self._pending_swapin = [e for e in self._pending_swapin
                                if e[0] != slot]
        self._fresh_swapins.discard(slot)
        if requeue and req is not None:
            # preemption: carry generated tokens so re-admission continues
            # from prompt+generated — streamed tokens are never re-emitted
            # (swap-in restores their K/V; recompute re-prefills them)
            req.generated.extend(out)
            self.queue.appendleft(req)
            _M_PREEMPTIONS.inc()
            _flight.record("preemption", req_id=req.req_id,
                           generated=len(req.generated), swapped=swapped)
            if _obs.enabled():
                _rt.get_request_tracer().record(
                    req.req_id, "preempt", slot=slot,
                    generated=len(req.generated), swapped=swapped)
        elif req is not None:
            self.results[req.req_id] = req.generated + out
            self.finish_reasons[req.req_id] = reason
            if req.t_deadline is not None:
                self._deadline_live = max(0, self._deadline_live - 1)
            if self.swap_pool is not None:
                self.swap_pool.discard(req.req_id)
                if self.offload is not None:
                    # an in-flight spill for a terminal request is moot:
                    # drop it, reclaim its custody blocks now
                    self.free_blocks.extend(
                        self.offload.cancel(req.req_id))
            if reason == "deadline_exceeded":
                _M_DEADLINE.inc()
                _flight.record("deadline_exceeded", req_id=req.req_id,
                               tokens=len(self.results[req.req_id]))
            elif reason != "finished":
                # a cancellation: terminal with partial tokens, but not a
                # completed request
                _flight.record(reason, req_id=req.req_id,
                               tokens=len(self.results[req.req_id]))
            else:
                _M_FINISHED.inc()
            self._obs_finish(req, out, reason)

    def _obs_finish(self, req: Request, out: List[int], reason: str):
        """TTFT/TPOT and the timeline's finish for a request leaving its
        slot. One that finishes in the SAME step its first token became
        host-visible retires before step()'s TTFT loop runs — its first
        token is visible now, so TTFT is observed here, and there is no
        TPOT (no decode cadence to measure)."""
        now = time.perf_counter()
        rid = req.req_id
        t_first = self._obs_t_first.pop(rid, None)
        t_add = self._obs_t_add.pop(rid, None)
        tracer = _rt.get_request_tracer() if _obs.enabled() else None
        if t_add is not None and (req.generated or out):
            if tracer is not None:
                tracer.record(rid, "first_token")
            _rt.observe_with_exemplar(_M_TTFT, now - t_add, rid)
        elif t_first is not None:
            n_out = len(req.generated) + len(out)
            if n_out > 1:
                _rt.observe_with_exemplar(
                    _M_TPOT, (now - t_first) / (n_out - 1), rid)
        if tracer is not None:
            tracer.finish(rid, tokens=len(self.results[rid]), reason=reason)

    # -- swap ---------------------------------------------------------------
    def _swap_out(self, slot: int, req: Request, out: List[int]):
        """Copy the slot's live K/V blocks to the host tier. Keeps
        ``len(ctx) - 1`` positions where ``ctx = prompt + generated +
        out``: the context tail is the re-admission's next decode input,
        whose K/V the first restored decode step rewrites — so a slot
        whose sampled-but-unread first token died with it (K/V cover ALL
        of ctx) and a mid-decode victim (K/V cover ctx[:-1]) restore
        through one invariant.

        Returns ``(swapped, held)``. Async mode dispatches a non-blocking
        d2h and parks the victim's private blocks in the offload engine's
        custody (``held`` — the ledger's ``in_flight`` term; cache-pinned
        head blocks stay ``cached``: the gather read them in stream
        order): they return to the free list at the step boundary after
        the copy lands. Sync mode blocks inline and holds nothing.
        ``swapped=False`` on fallback (host pool full, nothing to keep) —
        the caller then recomputes."""
        n_keep = len(req.prompt) + len(req.generated) + len(out) - 1
        if n_keep <= 0 or self.lengths[slot] < n_keep:
            # every swap-enabled preemption lands in a swap-out or a
            # counted fallback
            _M_SWAP_FALLBACK.inc(reason="nothing_to_keep")
            return False, []
        nb_keep = -(-n_keep // self.bs)
        blocks = [int(b) for b in self.table[slot, :nb_keep]]
        keep = len(self._pinned[slot])
        held = ([] if self.offload.sync else blocks[keep:nb_keep])
        ok = self.offload.spill_async(
            req.req_id, self.pools, blocks, n_keep, self.swap_pool,
            hold_blocks=held)
        return ok, (held if ok else [])

    def _swap_in(self, slot: int, req: Request, ent) -> None:
        """Re-admit a preempted request from its host-tier K/V (or a
        handed-off one from its relay entry): allocate blocks, restore
        the payload, and rebuild host bookkeeping — a short h2d instead
        of a full re-prefill."""
        blocks = self._take_up_to(max(1, ent.n_blocks))
        assert len(blocks) == max(1, ent.n_blocks), \
            "swap-in allocated past _avail_blocks"
        self._pinned[slot] = []      # restored K/V is slot-private
        self.table[slot, :len(blocks)] = blocks
        self.n_alloc[slot] = len(blocks)
        self.lengths[slot] = ent.n_tokens
        if self._spec_on:
            # the swap moved BOTH models' pool entries verbatim, so the
            # draft's coverage restores with the target's
            self._draft_len[slot] = ent.n_tokens
        self.slot_req[slot] = req
        self.admit_order.append(slot)
        self._table_dirty = True
        self._slots_dirty = True
        offload_mode = None
        if ent.n_blocks:
            if ent.staged is not None:
                # prefetch hit: the offload engine staged this entry's
                # payload ahead of admission — no inline wait
                datas = take_staged(ent)
                self.offload.note_hit()
                offload_mode = "hit"
            elif self.offload is None:
                # a relay restore on an engine with no host tier of its
                # own: a plain non-blocking h2d on the current stream
                datas = {n: upload(a, self.device)
                         for n, a in ent.data.items()}
            else:
                t0 = time.perf_counter()
                datas = self.offload.upload_inline(ent.data)
                self.offload.note_stall(time.perf_counter() - t0)
                offload_mode = "stall"
            self._swapin(blocks[:ent.n_blocks], datas)
        self._pending_swapin.append((slot, req.req_id))
        self._fresh_swapins.add(slot)
        _M_ADMISSIONS.inc()
        _flight.record("kv_swap_in", req_id=req.req_id, tokens=ent.n_tokens,
                       blocks=ent.n_blocks, offload=offload_mode)
        if _obs.enabled():
            kw = ({"offload": offload_mode} if offload_mode is not None
                  else {})
            _rt.get_request_tracer().admitted(
                req.req_id, slot=slot, context_tokens=ent.n_tokens,
                swapped_in=True, **kw)

    def _handoff(self, slot: int) -> None:
        """Disaggregated handoff: copy the slot's prefilled K/V blocks
        into the shared relay pool and finish the stream with reason
        ``"handoff"`` — the prefill replica's terminal. Keeps
        ``lengths[slot]`` positions (every prefilled token; the sampled
        first token's K/V is written by the decode replica's first
        restored step — the :meth:`_swap_out` invariant with the first
        token as ``out``), so a decode replica re-admitting ``prompt +
        delivered`` finds a relay entry of exactly ``len(ctx) - 1``
        tokens: the same restore contract as a swap-in, payload + scales
        bit-exact. A capacity refusal still hands the stream off — the
        decode replica then re-prefills the identical context (the pool
        counts outcome="relay_full"; streams match either way, only the
        transfer saving is lost)."""
        req = self.slot_req[slot]
        t0 = time.perf_counter()
        n_keep = int(self.lengths[slot])
        nb_keep = -(-n_keep // self.bs)
        data = self._fetch_blocks(
            [int(self.table[slot, j]) for j in range(nb_keep)])
        ok = self.relay.put(req.req_id, data, n_keep)
        dt = time.perf_counter() - t0
        nbytes = int(sum(a.numel() * a.element_size()
                         for a in data.values()))
        self.handoffs += 1
        self.handoff_bytes += nbytes
        self.handoff_seconds += dt
        if ok:
            _M_DISAGG_HANDOFFS.inc(outcome="ok")
        _M_DISAGG_SECONDS.observe(dt)
        _flight.record("kv_handoff", req_id=req.req_id, tokens=n_keep,
                       blocks=nb_keep, bytes=nbytes, relayed=ok)
        self._free_slot(slot, reason="handoff")

    def _prefill_handoffs(self):
        """The ``role="prefill"`` tail of a step (standing in for the
        decode dispatch): flush pending first tokens (a host sync — a
        handoff must not outrun its stream's delivered prefix), then hand
        off every slot whose prefill completed. Mid-chunk slots keep
        chunking; a request that finished ON its first token (budget 1
        or eos) already freed its slot in the flush and never relays."""
        emitted = []
        if self._pending_adm:
            adm, self._pending_adm = self._pending_adm, []
            emitted += self._flush_adm(adm)
        for slot in self._decode_slots():
            if self.slot_req[slot] is not None:
                self._handoff(slot)
        return emitted

    def _offload_tick(self) -> None:
        """The step-boundary offload sweep, in three moves:

        1. **Land** — commit every finished async spill into its host pool
           and return the custody blocks to the free list.
        2. **Proactive spill** — when the allocatable-block fraction
           drops below the pressure threshold, start background d2h for
           the coldest refcount-0 cached blocks, so a later reclaim frees
           them without an inline transfer.
        3. **Prefetch** — scan the first ``prefetch_depth`` queued
           requests: a swapped one's host entry, or the host-resident trie
           nodes its prompt would match, start staging h2d NOW so the
           admission-time restore is a prefetch hit.

        The injected ``offload_crash`` fires at its end, with transfers
        possibly in flight."""
        off = self.offload
        if off is None:
            return
        freed = off.poll()
        if freed:
            self.free_blocks.extend(freed)
        if not off.sync:
            pc = self.prefix_cache
            if pc is not None and pc.host is not None:
                frac = self._avail_blocks() / max(1, self.nb - 1)
                # one arithmetic headroom probe before the O(trie)
                # candidate sweep: a saturated host tier is not asked
                # again every step
                blk_bytes = sum(a.shape[0] * int(np.prod(a.shape[2:]))
                                * a.element_size()
                                for a in self.pools.values())
                room = (pc.host.capacity_bytes - pc.host.bytes_used
                        - pc.host.reserved_bytes)
                n_spill = min(off.spill_batch(), room // max(1, blk_bytes))
                if frac < self._spill_free_frac and n_spill > 0:
                    for nd in pc.spill_candidates(n_spill):
                        if not off.spill_async(
                                ("pfx", nd.uid), self.pools, [nd.block],
                                self.bs, pc.host, hold_blocks=[],
                                on_land=functools.partial(
                                    pc.finish_spill, nd),
                                proactive=True):
                            pc.abort_spill(nd)
            depth = off.prefetch_depth()
            if depth:
                for req in itertools.islice(self.queue, depth):
                    if self.swap_pool is not None:
                        ent = self.swap_pool.get(req.req_id)
                        if ent is not None:
                            off.stage(self.swap_pool, req.req_id, ent)
                            continue
                    if pc is not None and pc.host is not None:
                        ctx = req.prompt + req.generated
                        for key, ent in pc.host_path_entries(
                                ctx, (len(ctx) - 1) // self.bs):
                            off.stage(pc.host, key, ent)
        if self.injector is not None and \
                self.injector.fires("offload_crash", self._step_idx):
            _flight.record("injected_offload_crash", step=self._step_idx,
                           in_flight=off.held_blocks,
                           inflight_bytes=off.inflight_bytes)
            raise SimulatedCrash(
                f"injected offload crash at serving step {self._step_idx}")

    # -- admission and prefill ---------------------------------------------
    def _admit(self):
        """Admit every queued request a free slot and free blocks can
        take, then dispatch ONE prefill call for the whole wave. No host
        sync: each first token is sampled on the device and rides to the
        host one decode call later (``_pending_adm`` → the next dispatch
        record).

        A request with a host swap entry is restored instead (no prefill;
        an entry still in flight is landed first). With the prefix cache
        on, each admission first matches the longest cached prefix at
        block granularity (capped at ``(len(ctx)-1)//bs`` so at least one
        token prefills and yields the sampling hidden state), pins those
        blocks into the slot's table and prefills ONLY the suffix.
        Suffixes longer than ``prefill_chunk`` enter chunked mode: the
        wave carries their first chunk and :meth:`_advance_chunks` feeds
        one chunk a step until the final chunk samples the first
        token."""
        wave = []           # rows: (slot, req, ctx, hist, piece, final)
        while self.queue and len(wave) < self.N:
            slot = next((i for i in range(self.N)
                         if self.slot_req[i] is None), None)
            if slot is None:
                break
            req = self.queue[0]
            ent = (self.swap_pool.get(req.req_id)
                   if self.swap_pool is not None else None)
            if ent is None and self.swap_pool is not None \
                    and self.offload.pending(req.req_id):
                # the request's swap-out is still in flight but its
                # re-admission is due NOW: land it (blocking — counted as
                # a stall) so the swap-in path sees a committed entry
                freed = self.offload.force_land(req.req_id)
                if freed:
                    self.free_blocks.extend(freed)
                ent = self.swap_pool.get(req.req_id)
            # nothing will free a block: no slot busy, no squeeze to
            # release, no spill to land
            idle = not any(r is not None for r in self.slot_req) \
                and not self._squeezed \
                and not (self.offload is not None
                         and self.offload.held_blocks)
            if ent is not None:
                # swap-in re-admission: restore the preempted K/V blocks
                # from the host tier — no prefill, no sampled first token
                # (the tail of prompt+generated is the next decode input)
                if self._avail_blocks() < max(1, ent.n_blocks):
                    if idle:
                        raise RuntimeError(
                            f"request {req.req_id}: swap-in needs "
                            f"{ent.n_blocks} blocks but the pool only has "
                            f"{self.nb - 1} usable")
                    break                    # blocks busy: wait for frees
                self.queue.popleft()
                self._swap_in(slot, req, self.swap_pool.pop(req.req_id))
                continue
            if self.relay is not None and req.relay_key is not None:
                # disaggregated restore: a prefill replica's relay entry
                # stands in for the whole prefill — the same batched h2d
                # scatter as a swap-in, payload + scales bit-exact. An
                # entry that vanished with its replica, or whose pool
                # names do not match this engine's (asymmetric draft
                # configs), degrades to a full prefill of the identical
                # context — streams match either way.
                rent = self.relay.get(req.relay_key)
                if rent is not None and set(rent.data) == set(self.pools) \
                        and rent.n_tokens == len(req.prompt) \
                        + len(req.generated) - 1:
                    if self._avail_blocks() < max(1, rent.n_blocks):
                        if idle:
                            raise RuntimeError(
                                f"request {req.req_id}: relay restore "
                                f"needs {rent.n_blocks} blocks but the "
                                f"pool only has {self.nb - 1} usable")
                        break            # blocks busy: wait for frees
                    self.queue.popleft()
                    self._swap_in(slot, req,
                                  self.relay.pop(req.relay_key))
                    _M_DISAGG_HANDOFFS.inc(outcome="restored")
                    continue
                self.relay.discard(req.relay_key)
                req.relay_key = None
                _M_DISAGG_HANDOFFS.inc(outcome="missing")
            ctx = req.prompt + req.generated   # re-admission continues
            true_len = len(ctx)
            nodes, cached_blocks = [], []
            if self.prefix_cache is not None:
                # longest cached prefix, pinned; host-resident blocks on
                # the path restore through the free list
                nodes, cached_blocks = self.prefix_cache.match_and_pin(
                    ctx, (true_len - 1) // self.bs,
                    self._take_up_to, self._restore_blocks)
            m = len(nodes)
            hist = m * self.bs
            # only the blocks the true prompt occupies; the bucket's pad
            # tail scatters into the trash block (never read: causality)
            need = max(1, -(-true_len // self.bs)) - m
            if self._avail_blocks() < need:
                if nodes:
                    self.prefix_cache.unpin(nodes)
                if idle:
                    raise RuntimeError(
                        f"request {req.req_id}: prefill needs {need} blocks "
                        f"but the pool only has {self.nb - 1} usable — the "
                        "block pool is too small for this request")
                break                        # blocks busy: wait for frees
            self.queue.popleft()
            blocks = cached_blocks + self._take_up_to(need)
            self.table[slot, :len(blocks)] = blocks
            self.n_alloc[slot] = len(blocks)
            self.lengths[slot] = hist        # grows as pieces land
            self.slot_req[slot] = req
            self.admit_order.append(slot)
            self._pinned[slot] = nodes
            self._table_dirty = True
            self._slots_dirty = True
            if self.prefix_cache is not None:
                self.prefix_cache.note_lookup(hist)
            suffix = true_len - hist
            piece = (min(suffix, self.prefill_chunk)
                     if self.prefill_chunk else suffix)
            if _obs.enabled():
                # "admitted" the first time, "resumed" after a preemption
                _rt.get_request_tracer().admitted(
                    req.req_id, slot=slot, context_tokens=true_len,
                    cached_tokens=hist)
            wave.append((slot, req, ctx, hist, piece, piece == suffix))
        if wave:
            _M_ADMISSIONS.inc(len(wave))
            self._dispatch_prefill(wave)

    def _advance_chunks(self):
        """Feed every mid-prefill slot its next chunk — ONE chunk a slot a
        step, so long prefills interleave with the other slots' decode
        calls. The final chunk samples the request's first token and
        hands the slot to the decode path."""
        if not self._chunks:
            return
        rows = []
        for slot in sorted(self._chunks):
            st = self._chunks[slot]
            req = self.slot_req[slot]
            if req is None or req.req_id != st["rid"]:
                self._chunks.pop(slot)     # freed since (defensive)
                continue
            ctx, pos = st["ctx"], st["pos"]
            piece = min(self.prefill_chunk, len(ctx) - pos)
            rows.append((slot, req, ctx, pos, piece,
                         pos + piece == len(ctx)))
        if rows:
            self._dispatch_prefill(rows)

    def _dispatch_prefill(self, rows):
        """One prefill call for a wave of context PIECES — full prompts,
        cache-hit suffixes and chunk continuations mix in one call: B=1
        for a single row, else padded to ``max_slots`` rows; pad rows
        point at the trash block. Rows whose piece completes the context
        (``final``) keep their device-sampled first token
        (``_pending_adm``); chunk rows discard it and stay in
        ``_chunks``. A wave with history (``hist > 0`` on some row) runs
        the suffix form over a power-of-two history bucket."""
        bucket = self._bucket_for(max(piece for *_x, piece, _f in rows))
        B = 1 if len(rows) == 1 else self.N
        nbp = bucket // self.bs
        hist_blocks = max(hist // self.bs for _s, _r, _c, hist, _p, _f
                          in rows)
        pnbk = ((1 << (hist_blocks - 1).bit_length()) if hist_blocks
                else 0)
        toks = np.zeros((B, bucket), np.int32)
        blk_ids = np.zeros((B, nbp), np.int32)   # pad rows: all trash
        true_lens = np.ones(B, np.int32)
        hist_lens = np.zeros(B, np.int32)
        ctx_tbl = np.zeros((B, pnbk), np.int32) if pnbk else None
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int32)
        top_ps = np.ones(B, np.float32)
        for i, (slot, req, ctx, hist, piece, final) in enumerate(rows):
            b0 = hist // self.bs
            nblk = -(-(hist + piece) // self.bs) - b0
            toks[i, :piece] = ctx[hist:hist + piece]
            blk_ids[i, :nblk] = self.table[slot, b0:b0 + nblk]
            true_lens[i] = piece
            hist_lens[i] = hist
            if pnbk and b0:
                ctx_tbl[i, :b0] = self.table[slot, :b0]
            if final:        # non-final rows sample a discarded argmax
                temps[i], top_ks[i], top_ps[i] = (req.temperature,
                                                  req.top_k, req.top_p)
        flags = _sample_flags([r for _s, r, _c, _h, _p, final in rows
                               if final])
        up = self._upload
        args = (up(toks), up(blk_ids), up(true_lens))
        knobs = (up(temps), up(top_ks), up(top_ps), self._gen)
        hist_kw = (dict(hist_len=up(hist_lens), ctx_tbl=up(ctx_tbl))
                   if pnbk else {})
        wave_rids = [r.req_id for _s, r, _c, _h, _p, _f in rows]
        with trace_span("serving.prefill", bucket=bucket, batch=B,
                        wave=len(rows), prefix_bucket=pnbk * self.bs,
                        request_ids=wave_rids):
            wave = _Readback(_paged_prefill(
                self.params, *args, self.pools, *knobs, config=self._dc,
                sample_flags=flags, numerics=self.kv_int8 and _nm.active(),
                tp=self._tp, **hist_kw))
        if self._spec_on:
            # the same pieces through the draft, so both models' K/V
            # cover every prefilled position; its token is discarded
            # (greedy: it draws nothing from the generator)
            with trace_span("serving.prefill", bucket=bucket, batch=B,
                            wave=len(rows), model="draft",
                            request_ids=wave_rids):
                _paged_prefill(self.draft_params, *args, self.pools, *knobs,
                               config=self.draft_config,
                               sample_flags=(False, False, False),
                               kv_prefix="d", **hist_kw)
        tracer = _rt.get_request_tracer() if _obs.enabled() else None
        for i, (slot, req, ctx, hist, piece, final) in enumerate(rows):
            self.lengths[slot] = hist + piece
            if self._spec_on:
                self._draft_len[slot] = hist + piece
            if final:
                if self._chunks.pop(slot, None) is not None:
                    self._slots_dirty = True   # rejoins the decode mask
                self._pending_adm.append((slot, req.req_id, wave, i))
            else:
                if slot not in self._chunks:
                    self._slots_dirty = True   # leaves the decode mask
                self._chunks[slot] = {"ctx": ctx, "pos": hist + piece,
                                      "rid": req.req_id}
            if tracer is not None:
                tracer.record(req.req_id, "prefill", bucket=bucket,
                              batch=B, chunk_start=hist, chunk=piece)
            if self.prefix_cache is not None \
                    and len(self._pinned[slot]) == hist // self.bs:
                # adopt this piece's FULL blocks into the trie (pinned:
                # the slot itself holds them); adoption stays contiguous
                # with the pinned head — a gap (another request cached the
                # same block first) ends adoption for this slot
                b0 = hist // self.bs
                full = (hist + piece) // self.bs
                if full > b0:
                    self._pinned[slot].extend(self.prefix_cache.extend(
                        ctx, b0,
                        [int(self.table[slot, j]) for j in range(b0, full)],
                        pin=True))

    # -- decode ---------------------------------------------------------------
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

    def _ensure_backed(self, slot: int, lag: int = 0,
                       steps: Optional[int] = None) -> bool:
        """Back every block this slot's next decode call can write
        (clamped to its remaining token budget). ``lag``: tokens the
        unread in-flight call may already have appended beyond the host's
        view of the length; the horizon covers them too, since
        under-backing would divert K/V to the trash block. ``steps``
        overrides the call's write horizon (a spec wave commits up to
        ``spec_tokens``). Returns False if the pool is exhausted (caller
        preempts)."""
        req = self.slot_req[slot]
        remaining = req.max_new_tokens - len(req.generated) \
            - len(self.slot_out[slot])
        base = self.decode_steps if steps is None else steps
        steps = max(1, min(base + lag, remaining + lag))
        horizon = int(self.lengths[slot]) + steps - 1
        last_blk = min(horizon, self.max_model_len - 1) // self.bs
        need = last_blk + 1 - int(self.n_alloc[slot])
        if need <= 0:
            return True
        got = self._take_up_to(need)     # one reclaim sweep for the lot
        for blk in got:
            self.table[slot, int(self.n_alloc[slot])] = blk
            self.n_alloc[slot] += 1
            self._table_dirty = True
        return len(got) == need

    def _decode_slots(self):
        """Slots the decode call covers: active and not mid-chunked-
        prefill (a chunking slot joins once its final chunk lands)."""
        return [i for i in range(self.N) if self.slot_req[i] is not None
                and i not in self._chunks]

    def _spec_safe(self) -> bool:
        """True iff dispatching the next decode call BEFORE reading the
        in-flight one cannot waste work: every slot in the in-flight
        snapshot is still alive when that call ends — no eos token to
        trip on, and budget strictly beyond the call's horizon. Otherwise
        the engine reads first."""
        rec = self._inflight
        for slot, rid in rec["snapshot"]:
            req = self.slot_req[slot]
            if req is None or req.req_id != rid:
                return False
            if req.eos_token_id is not None:
                return False
            if rec["rem_start"][slot] - self.decode_steps <= 0:
                return False
        return True

    def _back_or_preempt(self, steps: Optional[int] = None):
        """Back upcoming writes for every decode slot; preempt the newest
        admissions while the pool is short (recompute or swap). With an
        unread call in flight the host length lags by up to
        ``decode_steps`` — if generous backing fails, the pipeline is
        drained so preemption decisions see exact state. ``steps``
        overrides the write horizon (spec waves back ``spec_k``
        positions and run with the pipeline drained). Returns the tokens
        a drain made host-visible."""
        emitted = []
        for slot in list(self._decode_slots()):
            if self.slot_req[slot] is None:
                continue                      # already preempted as a victim
            while True:
                in_snap = self._inflight is not None and any(
                    s == slot for s, _ in self._inflight["snapshot"])
                if self._ensure_backed(slot,
                                       self.decode_steps if in_snap else 0,
                                       steps=steps):
                    break
                if self._inflight is not None:
                    # exact lengths before evicting anyone
                    emitted += self._process_inflight()
                    if self.slot_req[slot] is None:
                        break
                    continue
                if self.offload is not None and self.offload.held_blocks:
                    # blocks parked behind an in-flight spill: landing
                    # them (blocking) beats preempting ANOTHER victim
                    self.drain_offload()
                    continue
                victim = self.admit_order[-1]
                if victim == slot and len(self.admit_order) == 1 \
                        and not self._squeezed:
                    # alone and starved: nothing else will ever free a
                    # block (an injected squeeze returns its blocks in a
                    # step or two: self-preempt and wait instead)
                    raise RuntimeError(
                        f"request {self.slot_req[slot].req_id}: the block "
                        f"pool ({self.nb - 1} usable blocks) is too small "
                        "to decode this request any further")
                self._free_slot(victim, requeue=True)
                if victim == slot:
                    break
        return emitted

    def _refresh_carry(self, active_slots):
        """Bring the device carry and per-slot vectors up to date, with no
        host sync: every upload goes through a pinned staging copy.

        The carry CHAINS on the device from call to call; host state is
        injected only where it is exact: a full rebuild when no call is
        unread (carry is None), or a per-slot scatter for freshly
        admitted slots (whose first token exists only on the device) and
        swapped-in slots. Freed slots are masked out by the active
        vector — their stale carry lanes are never read."""
        up = self._upload
        if self._carry is None:
            assert self._inflight is None, \
                "carry rebuild requires a drained pipeline"
            last = np.zeros(self.N, np.int32)
            budgets = np.zeros(self.N, np.int32)
            pend = {s for s, _, _, _ in self._pending_adm}
            for i in active_slots:
                req = self.slot_req[i]
                # swap-in slots continue from the context tail; pending
                # slots get a placeholder overwritten by _apply_admissions
                last[i] = self.slot_out[i][-1] if self.slot_out[i] else \
                    (req.generated[-1] if req.generated else req.prompt[-1])
                budgets[i] = req.max_new_tokens - len(req.generated) \
                    - len(self.slot_out[i]) - (1 if i in pend else 0)
            self._carry = (up(last), up(self.lengths.astype(np.int32)),
                           torch.zeros(self.N, dtype=torch.bool,
                                       device=self.device), up(budgets))
        if self._pending_adm:
            # one _apply_admissions call per wave array (usually one)
            groups: Dict = {}
            for s, rid, wave, i in self._pending_adm:
                groups.setdefault(id(wave), (wave.dev, []))[1].append((s, i))
            c_last, c_len, c_done, c_rem = self._carry
            for arr, items in groups.values():
                slot_of_row = np.full(arr.shape[0], self.N, np.int32)
                upd = np.zeros(self.N, bool)
                lens_new = np.zeros(self.N, np.int32)
                rems_new = np.zeros(self.N, np.int32)
                for s, i in items:
                    slot_of_row[i] = s
                    upd[s] = True
                    lens_new[s] = int(self.lengths[s])
                    req = self.slot_req[s]
                    rems_new[s] = (req.max_new_tokens
                                   - len(req.generated) - 1)
                c_last, c_len, c_done, c_rem = _apply_admissions(
                    c_last, c_len, c_done, c_rem, arr, up(slot_of_row),
                    up(lens_new), up(rems_new), up(upd))
            self._carry = (c_last, c_len, c_done, c_rem)
        if self._pending_swapin:
            # swap-in lanes: the same scatter as a prefill wave, but the
            # "wave token" is host-known (the tail of prompt+generated)
            c_last, c_len, c_done, c_rem = self._carry
            slot_of_row = np.full(self.N, self.N, np.int32)
            upd = np.zeros(self.N, bool)
            toks = np.zeros(self.N, np.int32)
            lens_new = np.zeros(self.N, np.int32)
            rems_new = np.zeros(self.N, np.int32)
            for row, (s, rid) in enumerate(self._pending_swapin):
                req = self.slot_req[s]
                if req is None or req.req_id != rid:
                    continue          # freed again before any dispatch
                slot_of_row[row] = s
                upd[s] = True
                toks[row] = (req.generated[-1] if req.generated
                             else req.prompt[-1])
                lens_new[s] = int(self.lengths[s])
                rems_new[s] = req.max_new_tokens - len(req.generated)
            self._pending_swapin = []
            if upd.any():
                self._carry = _apply_admissions(
                    c_last, c_len, c_done, c_rem, up(toks),
                    up(slot_of_row), up(lens_new), up(rems_new), up(upd))
        if self._slots_dirty or self._slot_vecs is None:
            temps = np.zeros(self.N, np.float32)
            top_ks = np.zeros(self.N, np.int32)
            top_ps = np.ones(self.N, np.float32)
            eos_ids = np.full(self.N, -1, np.int32)
            active = np.zeros(self.N, bool)
            for i in active_slots:
                req = self.slot_req[i]
                temps[i], top_ks[i], top_ps[i] = (req.temperature,
                                                  req.top_k, req.top_p)
                if req.eos_token_id is not None:
                    eos_ids[i] = req.eos_token_id
                active[i] = True
            self._slot_vecs = (up(active), up(temps), up(top_ks),
                               up(top_ps), up(eos_ids))
            self._slots_dirty = False

    def _decode_path(self) -> str:
        """Kernel path of the next decode dispatch: ``"bucketed"`` when
        forced, ``"mega"`` (the persistent megakernel — forced, or picked
        by ``"auto"`` on the card at ``max_slots <= 4``, where a step is
        launch-bound) when its screen accepts the model and batch, else
        ``"ragged"``. A mega pick the screen refuses is counted in
        ``mega_fallbacks`` by reason."""
        if self.decode_kernel == "bucketed":
            return "bucketed"
        want_mega = self.decode_kernel == "mega" or (
            self.decode_kernel == "auto" and self.device.type == "cuda"
            and self.N <= 4 and self._tp is None)
        if want_mega:
            ok, reason = mega_supported(
                self.params, self.config, n_slots=self.N,
                n_steps=self.decode_steps, block_size=self.bs,
                kv_int8=self.kv_int8, mesh=self.mesh)
            if ok:
                return "mega"
            self.mega_fallbacks[reason] += 1
            _M_MEGA_FALLBACK.inc(reason=reason)
        return "ragged"

    def _prefix_blocks(self, active_slots) -> int:
        """The bucketed call's prefix horizon: the smallest power-of-two
        BLOCK COUNT covering ``max(lengths) + decode_steps`` over the
        active slots, from the host's exact lengths plus the pipeline lag
        (an unread in-flight call may already have appended up to
        ``decode_steps`` tokens for the slots in its snapshot)."""
        prev = self._inflight
        snap = ({s for s, _ in prev["snapshot"]} if prev is not None
                else ())
        hmax = need = 0
        for i in active_slots:
            h = int(self.lengths[i]) + (self.decode_steps if i in snap
                                        else 0)
            hmax = max(hmax, h)
            need = max(need, int(self.n_alloc[i]))
        horizon = min(hmax + self.decode_steps, self.max_model_len)
        need = max(1, need, -(-horizon // self.bs))
        return min(1 << (need - 1).bit_length(), self.mb)

    def _dispatch_decode(self, active_slots):
        """Enqueue one multi-step decode call and record it as in flight;
        return the previous record (unread) or None. ``rem_start`` holds
        each slot's EXACT remaining budget at the start of the call (host
        bookkeeping lags; it chains from the previous record when
        pipelined). Nothing here reads the device."""
        prev = self._inflight
        pend = {s for s, _, _, _ in self._pending_adm}
        rem_start = {}
        for i in active_slots:
            req = self.slot_req[i]
            if i in pend:
                rem_start[i] = req.max_new_tokens - len(req.generated) - 1
            elif i in self._fresh_swapins:
                # swap-in since the last dispatch: the slot id may be
                # recycled from the previous record — its budget comes
                # from host state, never the stale chained countdown
                rem_start[i] = req.max_new_tokens - len(req.generated)
            elif prev is not None and i in prev["rem_start"]:
                rem_start[i] = prev["rem_start"][i] - self.decode_steps
            else:
                rem_start[i] = req.max_new_tokens - len(req.generated) \
                    - len(self.slot_out[i])
        path = self._decode_path()
        table = self._table()
        nbk = self.mb
        if path == "bucketed":
            # the kernels read true lengths from a full-width table; the
            # dense gather reads the table sliced to its bucket
            nbk = self._prefix_blocks(active_slots)
            table = table[:, :nbk]
            label = "dense" if nbk >= self.mb else path
        else:
            label = path
        self.decode_paths[label] += 1
        flags = _sample_flags([self.slot_req[i] for i in active_slots])
        # the JAX engine's variant key: one program per (path, flags) on
        # the kernel paths, per (bucket, flags) on the bucketed one
        vk = (nbk if path == "bucketed" else path, flags)
        if vk not in self._decode_variants:
            self._decode_variants.add(vk)
            _M_DECODE_RECOMPILES.inc()
        _M_DECODE_KERNEL.inc(path=label)
        _M_DECODE_VARIANTS.set(len(self._decode_variants))
        span = (self._obs_decode(path, nbk, active_slots, prev)
                if _obs.enabled() else _NO_SPAN)
        c_last, c_len, c_done, c_rem = self._carry
        v_act, v_t, v_k, v_p, v_eos = self._slot_vecs
        with span:
            toks, *carry = _paged_decode(
                self.params, c_last, c_len, c_done, c_rem, self._gen, v_act,
                table, self.pools, v_t, v_k, v_p, v_eos,
                config=self._dc, n_steps=self.decode_steps,
                sample_flags=flags, mega=path == "mega",
                bucketed=path == "bucketed",
                numerics=self.kv_int8 and _nm.active(), tp=self._tp)
        self._carry = tuple(carry)
        self._inflight = {
            "toks": _Readback(toks),
            "snapshot": [(i, self.slot_req[i].req_id) for i in active_slots],
            "adm": self._pending_adm,
            "rem_start": rem_start,
        }
        self._pending_adm = []
        self._fresh_swapins = set()
        return prev

    def _pool_block_bytes(self) -> int:
        """Bytes one physical block holds across the target's pool entries
        and layers (int8 pools: payload and scales); the draft's
        ``dk``/``dv`` are not counted."""
        return sum(a.shape[0] * int(np.prod(a.shape[2:])) * a.element_size()
                   for n, a in self.pools.items()
                   if n in ("k", "v", "ks", "vs"))

    def _obs_decode(self, path, nbk, active_slots, prev):
        """Observability of one decode dispatch (host ints only): the
        prefix-horizon and K/V-read gauges, the call's counted FLOPs for
        the step's MFU, and the ``serving.decode`` span to run it in."""
        bs = self.bs
        if path == "bucketed":
            step_bytes = self._pool_block_bytes() * self.N * nbk
            bucket_tokens = nbk * bs
            attn_tokens = self.N * nbk * bs
        else:
            # the kernels walk the device carry's lengths, ahead of the
            # host's by decode_steps for slots behind an unread call
            snap = ({s for s, _ in prev["snapshot"]} if prev is not None
                    else ())
            lens = [int(self.lengths[i])
                    + (self.decode_steps if i in snap else 0)
                    for i in active_slots]
            walk = sum(-(-ln // bs) for ln in lens)
            step_bytes = walk * self._pool_block_bytes()
            bucket_tokens = -(-max(lens, default=0) // bs) * bs
            attn_tokens = walk * bs
        _M_PREFIX_BUCKET.set(bucket_tokens)
        _M_KV_READ_BYTES.set(step_bytes)
        self._last_decode_flops = _perf.decode_flops(
            self.config, self.N, self.decode_steps, attn_tokens)
        return trace_span("serving.decode", slots=len(active_slots),
                          steps=self.decode_steps,
                          prefix_bucket=bucket_tokens,
                          request_ids=[self.slot_req[i].req_id
                                       for i in active_slots])

    def _flush_adm(self, adm):
        """Read back the first tokens of admissions ((slot, req_id, the
        wave's ``_Readback``, row) tuples) — one readback per distinct
        wave — and emit them; slots whose request changed since are
        skipped."""
        emitted = []
        host = {}
        for slot, rid, wave, i in adm:
            if id(wave) not in host:
                host[id(wave)] = wave.numpy()
            req = self.slot_req[slot]
            if req is None or req.req_id != rid:
                continue              # preempted before its call ran
            tok = int(host[id(wave)][i])
            emitted.append((rid, tok))
            # commit point: host-visible from here on, so mirrored into
            # the step's salvage buffer
            self._step_emitted.append((rid, tok))
            self._emit(slot, tok)
        return emitted

    def _process(self, rec):
        """Read back one decode record: the first tokens of its
        admissions, then its emitted grid [n_steps, N]. Slots whose
        request changed since dispatch (finished or preempted) are
        skipped — their lanes are -1 padding or discarded work. The
        injected ``readback_fail`` fires here, before anything is read."""
        if self.injector is not None and \
                self.injector.fires("readback_fail", self._step_idx):
            _flight.record("injected_readback_fail", step=self._step_idx)
            raise SimulatedCrash(
                f"injected readback failure at serving step "
                f"{self._step_idx}")
        emitted = []
        with trace_span("serving.readback"):
            if rec["adm"]:
                emitted += self._flush_adm(rec["adm"])
            toks_host = rec["toks"].numpy()
            # the readback has landed the call and all before it: the
            # numerics vectors they shipped land with it
            _nm.land()
            for slot, rid in rec["snapshot"]:
                req = self.slot_req[slot]
                if req is None or req.req_id != rid:
                    continue
                for k in range(toks_host.shape[0]):
                    tok = int(toks_host[k, slot])
                    if tok < 0:
                        break          # slot went done mid-call
                    self.lengths[slot] += 1     # its K/V was appended
                    if self._spec_on:
                        # advanced by the normal path: the draft's K/V
                        # are behind until a re-prefill
                        self._draft_len[slot] = -1
                    emitted.append((rid, tok))
                    self._step_emitted.append((rid, tok))
                    if self._emit(slot, tok):
                        break
        return emitted

    def _process_inflight(self):
        """Read the in-flight call with nothing queued behind it."""
        rec, self._inflight = self._inflight, None
        self.readbacks["drained"] += 1
        return self._process(rec)

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

    def _spec_wave(self, active):
        """One draft-then-verify wave, run with the pipeline drained: the
        draft proposes ``spec_k`` tokens a slot in one call, the target
        scores them all in one verify call (the draft's grid feeds it on
        the device), and the host commits each slot's agreeing prefix plus
        the target's token, capped at ``spec_k`` — so the draft's K/V stay
        in lockstep with the target's and a rejected suffix is rolled back
        by the length alone. Pending admissions are read back first: the
        wave reads the host's state, and the chained carry is rebuilt
        after it."""
        emitted = []
        if self._pending_adm:
            adm, self._pending_adm = self._pending_adm, []
            with trace_span("serving.readback"):
                emitted += self._flush_adm(adm)
                _nm.land()
        # swap-in carry lanes are host-known state; the spec wave reads
        # host state directly and invalidates the chained device carry
        self._pending_swapin = []
        self._fresh_swapins = set()
        self._carry = None
        self._slots_dirty = True
        emitted += self._back_or_preempt(steps=self.spec_k)
        active = self._decode_slots()
        if not active:
            return emitted
        k, N = self.spec_k, self.N
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
                _M_MEGA_FALLBACK.inc(reason="draft_" + reason)
                path = "ragged"
        self.spec_draft_paths[path] += 1
        nbk = self._spec_bucket(active)
        table = self._table()
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
        up, dev = self._upload, self.device
        last_d = up(last)
        lens_d = up(self.lengths.astype(np.int32))
        act_d = up(act)
        rids = [self.slot_req[i].req_id for i in active]
        with trace_span("serving.spec_draft", slots=len(active), k=k,
                        request_ids=rids):
            draft, *_ = _paged_decode(
                self.draft_params, last_d, lens_d,
                torch.zeros(N, dtype=torch.bool, device=dev), up(budgets),
                self._gen, act_d,
                table[:, :nbk] if path == "bucketed" else table, self.pools,
                torch.zeros(N, dtype=torch.float32, device=dev),
                torch.zeros(N, dtype=torch.int32, device=dev),
                torch.ones(N, dtype=torch.float32, device=dev),
                torch.full((N,), -1, dtype=torch.int32, device=dev),
                config=self.draft_config, n_steps=k,
                sample_flags=(False, False, False), mega=path == "mega",
                mega_multistep=path == "mega", kv_prefix="d",
                bucketed=path == "bucketed")
            if self._tp is not None:
                self._tp.agree(draft)
        with trace_span("serving.spec_verify", slots=len(active), k=k,
                        prefix_bucket=nbk * self.bs, request_ids=rids):
            verified = _spec_verify(
                self.params, table[:, :nbk], last_d, draft, lens_d, act_d,
                self.pools, config=self._dc, n_spec=k,
                max_model_len=self.max_model_len,
                numerics=self.kv_int8 and _nm.active(), tp=self._tp)
        if self.injector is not None and \
                self.injector.fires("spec_verify_fail", self._step_idx):
            # nothing of this wave is host-visible yet: recovery rolls
            # back to the last committed token
            _flight.record("injected_spec_verify_fail", step=self._step_idx)
            raise SimulatedCrash(
                f"injected speculative-verify failure at serving step "
                f"{self._step_idx}")
        with trace_span("serving.readback"):
            d_host = draft.cpu().numpy()                    # [k, N]
            v_host = verified.cpu().numpy()                 # [N, k+1]
            _nm.land()
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
                self._step_emitted.append((rid, tok))
                if self._emit(i, tok):
                    break                   # eos or budget mid-wave
        self.spec_waves += 1
        self.spec_verify_calls += 1
        self.spec_draft_steps += k
        self.spec_proposed += wave_prop
        self.spec_accepted += wave_acc
        self.spec_committed += wave_commit
        _M_SPEC_PROPOSED.inc(wave_prop)
        if wave_acc:
            _M_SPEC_ACCEPTED.inc(wave_acc)
        if _obs.enabled():
            _M_SPEC_ACCEPT_RATE.set(
                self.spec_accepted / max(1, self.spec_proposed))
            _M_SPEC_TOKENS_PER_WAVE.set(
                self.spec_committed / max(1, self.spec_verify_calls))
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
