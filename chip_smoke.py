#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/kernels/csrc``
into the git-ignored ``paddle_tpu_torch/_build``, then runs, in order
(any failure raises and the script exits non-zero):

1. device: the card's name and power limit, torch/CUDA versions, the
   kernel build time; TF32 off for f32 matmuls and convolutions;
2. B1, the flash-prefill kernel, against its plain version at Llama-3-8B
   head shapes (Hq=32, Hkv=8, D=128; B=2; S in 128/1000/1024; causal and
   not; bf16 and f32; D=64 once), then at the bf16 Hopper kernel's edge
   shapes (S from 1 to 2048 around its 128-row tiles, GQA groups of 1, 3
   and 4, D 64 and 128, causal and not), each equal to itself over two
   calls;
3. B4, the ragged paged-decode kernel, against its plain version on
   [L=4, NB=512, BS=64, Hkv=8, D=128] pools with lengths 0, 1, 64, 2000
   and more;
4. the serving path: ``LLMEngine(decode_kernel="ragged")`` serving 16
   greedy requests (prompts of 64-1000 tokens, 64 new tokens each) on
   Llama-3-8B with random bf16 weights, with the kernels' launch counts
   read around the run; then one more decode call traced with
   torch.profiler (the device's busy share of its wall time), and each
   kernel timed at the run's own shapes beside its plain version (and,
   for B1, beside SDPA; B1 also at the llama-2.6b and DeepSeekMoE train
   steps' shapes; B4 and B4-int8 also alone by the profiler, with the
   host microseconds a wrapper call costs, and B4 at one and at eight
   2000-position slots);
5. cross-device streams: Llama-3-8B widths cut to 2 layers and a 32768
   vocabulary, f32, two prompts of 130 and 200 tokens for 8 greedy
   tokens through the ragged engine on the card and on the CPU (plain
   versions) with the same numpy-made weights — the streams must be
   equal;
6. the mega decode path: (a) B5, the persistent decode megakernel,
   against its plain version for one step of Llama-3-8B at full width and
   depth (4 slots at the serving mix's lengths): in f32 within 1e-3, in
   bf16 no farther from the f32 result than 1.5x the plain bf16 version;
   then timed in bf16 beside it; (b) phase 5's streams again through the mega engine on the card
   and on the CPU — all four must be equal; (c)
   ``LLMEngine(decode_kernel="mega", max_slots=4)`` serving 8 requests
   of phase 4's mix on phase 4's weights, with one B5 launch a decode
   step and no B4 launch, a traced decode call, and the same mix through
   a ragged engine at 4 slots for comparison;
7. B2/B3, the flash-backward kernels (dQ with Delta computed in it;
   dK/dV), against their plain versions at llama-2.6b head shapes
   (Hq=24, Hkv=8, D=128; B=2; S in 128/1000/2048; causal and not; bf16
   and f32; D=64 once), then at the bf16 Hopper kernels' edge shapes (S
   from 1 to 1000 around their 64-row tiles, GQA groups of 1, 3 and 4, D
   64 and 128, causal and not), each equal to itself over two calls, and
   their f32 gradients against torch.autograd through dense attention;
8. the training path: ``train_step`` on llama-2.6b at full width and
   depth (batch 8, seq 2048, full remat, adafactor, bf16 params, random
   weights), 2 warm-up and 5 timed steps on one fixed batch — finite,
   falling losses and, per step, 2x24 B1 and 24 B2/B3 launches; tokens/s,
   step time, MFU, peak memory; one more step traced with torch.profiler;
9. B2 and B3 timed at the llama-2.6b and DeepSeekMoE steps' shapes
   beside their plain versions and their bounds, B2 also given a torch
   Delta, and the whole backward (Delta + B2 + B3) beside SDPA's
   backward;
10. card vs CPU train step: llama-2.6b widths cut to 2 layers, f32,
    AdamW, B=1, S=256, the same numpy-made weights — loss, grad norm,
    grads and updated params must agree;
11. B9 (gather_gmm) and B10 (gmm, with and without transpose_rhs; tgmm)
    against their plain versions, bf16 and f32, at small shapes with empty
    groups, a skewed group, tiles spanning groups and tail rows; the
    Hopper kernels' edge shapes (a ragged reduction that wraps the stage
    ring, more tiles than 2 x 132 persistent blocks, 1408 and 136 columns;
    B9 with bf16 and int8 weights; tgmm with group boundaries off 64 and
    8, empty groups, one group of every row, rows past sum(gs), bf16 and
    f32 out), each call equal to itself bit for bit over two calls; then
    bf16 at the MoE train step's shapes;
12. the MoE training path: ``moe.train_step`` on DeepSeekMoE-16B's
    widths cut to 12 layers (batch 4, seq 2048, remat "outs", adafactor,
    bf16 params, random weights), 2 warm-up and 5 timed steps — falling
    losses and, per step, the expected launches of B1-B3, B9, gmm and
    tgmm; tokens/s, step time, MFU, peak memory, the fused dispatch's
    route counts; one more step traced, its device time by kernel;
13. B9, gmm and tgmm timed at each of their calls' shapes in the step
    beside their plain versions, their bounds (and each call's share of
    it) and ``torch._grouped_mm``;
    the fused and gmm dispatch forms timed forward and backward;
14. card vs CPU MoE train step (f32, 2 layers, AdamW), and the card's gmm
    form against its fused form.

The int8 slice rides beside them (int8 weights from ``quantize_params``,
int8 pools from ``kv_dtype="int8"``, int8 experts from
``quantize_expert_params``):

(a) after phase 3: B4's int8 branch against its plain version on int8
    pools of phase 3's shapes (bf16 and f32 queries, D=64 once), acc, m
    and l within 1e-5; timed at the serving run's shapes after (c);
(b) after phase 6: B5's int8 branches against the plain version for one
    Llama-3-8B step at full width and depth, 4 slots, with int8 pools,
    int8 weights and both, by phase 6(a)'s rules, each timed;
(c) phase 4's weights through ``quantize_params`` with int8 pools: phase
    4's 16 requests through a ragged engine at 8 slots, the first 8
    through a mega engine at 4 slots, with 32 B4-int8 launches a ragged
    decode step, one B5-int8 and no B4 a mega step, no fallback, a traced
    decode call each, the first stream divergences (int8 against bf16,
    mega against ragged) and the prefill logits' relative error of int8
    against bf16 on one wave;
(d) phase 5's cut model with int8 weights and pools: ragged and mega on
    the card and ragged on the CPU emit equal streams;
(e) after phase 14: B9's int8 branch against its plain version at small
    shapes (an empty and a skewed group), then at the MoE step's gate|up
    shape, timed beside its bound (and its share of it) and
    ``torch._grouped_mm`` on the widened weight;
(f) ``moe.forward`` on DeepSeekMoE-16B at full depth (28 layers) with
    int8 experts, batch 4 x 2048, 2 warm-up and 5 timed forwards with one
    B9-int8 and one gmm launch a MoE layer each, and its logits against
    the bf16 forward of the same weights at 12 layers.

The speculative-decoding slice (``LLMEngine(draft_params=...)``, B5's
multi-step form ``mega_decode_loop``) and the paged-cache API (B6-B8):

(s4) after phase 3 (int8 a): B6 (``paged_decode_attention``), B7
     (``paged_append_token``) and B8 (``paged_append_blocks``) against
     their plain versions on phase 3's pools at Llama-3-8B's heads (G=3
     and D=64 once each, bf16 and f32; lengths 0, 1, 64, 2000 and more):
     B7/B8 bit-equal, B6 per slot (over the slot's largest |ref|) f32
     within 1e-5, bf16 within 2e-2, 0 for a zero-length slot; the JAX package's chip-test path (cache init, prefill blocks,
     decode attention, token append, block append) with its launches
     counted; each kernel timed beside its bound, its plain version and
     (B7, B8) ``index_put_``, with its kernels alone and the host
     microseconds a call: B6 at (s4)'s lengths and at one and eight slots
     of 2000 positions (``ragged_paged_decode`` at each shape beside it),
     B7 also at 64 and 256 rows (bit-equal there too), B8 also from a
     cold L2; B7 and B8 beside the launch floor E (the profiler's time of
     ``torch.cuda._sleep(0)``, an empty kernel) and E + their bytes
     bound; then the API's decode sequence over 32 pool layers of [32,
     512, 64, 8, 128] bf16 (B7 appends at (s4)'s lengths, B6 attends at
     lengths + 1, a layer; rows bit-equal and B6 within 2e-2 of the plain
     chain), its device span a layer from behind a spin kernel on a
     ``paged_chain`` line;
(s1) after phase 6 (c): B5's multi-step form against its plain version
     for one k=4 draft wave at 4 slots and the serving mix's lengths: f32
     Llama-3-8B at full width and depth (dense head: tokens and states
     equal, rings within 1e-3), the Llama-3.2-1B-shaped draft widened to
     f32 (its tied head: tokens and states equal), the bf16 draft (the
     first step's ring rows by phase 6(a)'s rule, lens/done/budgets equal,
     the first token divergence reported), the draft with int8 weights, and a
     2-layer f32 model at the draft's widths with an int8 head where a
     budget and an eos end rows mid-loop beside an inactive row; each
     timed beside its bound;
(s2) phase 5's cut model as the target and a 1-layer ``draft_config`` of
     it (other numpy weights) as the draft, spec_tokens=4: the draft on
     the mega and the ragged path on the card and ragged on the CPU emit
     phase 5's plain streams, and so does the self-draft (the target as
     its own draft: tokens accepted, several committed a wave) on the
     mega and the ragged path on the card; again with int8 pools;
(s3) speculative serving on phase 4's Llama-3-8B weights with a
     Llama-3.2-1B-shaped draft (random bf16, seed 1): phase 6(c)'s 8
     requests through a mega engine at 4 slots (one B5-multi launch a spec
     wave, no single-step B5 inside the waves), through the same with the
     self-draft, and through a ragged engine at 8 slots; tokens/s, waves,
     acceptance and tokens a verify call from a run with no timer in it,
     then draft and verify call times from a second run of the same
     requests, a traced spec wave and the first divergence from the plain
     mega streams.

The training memory modes (``optimizer/offload.py``), phase 15, after
(f), each sub-phase's state freed before the next, phase 8's recipe
(adafactor, bf16 params, lr 3e-5 with its floor lifted, random weights,
one fixed batch), 1 warm-up step then timed ones:

(t1) ``llama.train_step`` on Llama-3-8B (``llama3_8b()``, seq 2048, full
     remat, 16 loss chunks) at the largest batch of 8, 4, 2 whose peak,
     reckoned from the code and printed first (``reckon_8b``), lies
     within 0.9 of the card's memory; 3 timed steps, each launching B1
     2x32 times and B2, B3 32 times; finite, falling losses;
(t2) ``make_layerwise_train_step`` on the same model at batch 8 (and at
     t1's batch if smaller): the same launches, finite and falling
     losses;
(t3) ``make_streaming_train_step`` at batch 8: the same launches; after
     every step each layer tensor lies on the CPU, pinned, and the card
     holds at most the tail (embedding, final norm, head, their moments)
     plus 1 GB; the pinned bytes against the layers', the step's PCIe
     bytes, the link's pinned copy rates (each direction alone and both
     at once), the step time against t2's, one step traced;
(t4) a small f32 model (4 layers, heads of 128): 3 layer-wise and
     streaming steps on the card and streaming steps on the CPU from one
     numpy-made state (losses within 2e-5 relative, parameters and second
     moments within 1e-4 of each leaf's largest magnitude), and 2
     ``make_offload_train_step`` steps (adamw with pinned moments,
     adafactor) against ``llama.train_step`` on the card by the same rule;
(t5) ``make_streaming_moe_train_step`` on DeepSeekMoE-16B at full depth
     (28 layers, layer 0 dense; cut, and the cut printed, only if the
     host cannot pin them), batch 4 x 2048, 2 timed steps with the B1-B3,
     B9, gmm and tgmm launches the step's code implies, finite losses,
     one step traced;
then B1, B2 and B3 timed at the 8B step's attention shape ([8, 2048,
32/8, 128], causal) beside SDPA and their bounds. Each of (t1)-(t3) and
(t5) prints tokens/s, MFU and its peak memory with the card.

Before its last line it prints ``serving``, ``mega``, ``training``,
``moe_training``, ``int8``, ``training_memory`` and ``spec`` lines
(phases 4, 6, 8, 12-15, (a)-(f) and (s1)-(s4)),
one JSON object with every ported kernel
(launches on its main path, max error, and times in ms beside the
bound), and the card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the repository beside it, it exits 1
and prints no result.
"""
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and dense bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SEED = 0


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    """Mean device time of ``fn()`` in ms over ``iters`` calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_spans(fn, iters, key):
    """The device intervals (start, end) in us of the kernels whose name
    holds ``key`` over ``iters`` calls of ``fn()`` (torch.profiler, after
    one warm-up call), in order."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and key in e.name)


def kernel_device_ms(fn, iters, key):
    """Mean device time in ms of the kernels whose name holds ``key`` over
    ``iters`` calls of ``fn()``, summed over every such kernel of a call:
    the kernel alone, where CUDA events around back-to-back calls of a
    short kernel time its wrapper's host work. None when the trace holds
    no such kernel."""
    spans = kernel_spans(fn, iters, key)
    return sum(b - a for a, b in spans) / 1e3 / iters if spans else None


def kernel_span_ms(fn, iters, key):
    """As :func:`kernel_device_ms`, but the union of the kernels'
    intervals: where a call's kernels overlap (a dependent launch starts
    before its primary ends) the time the card spends on the call."""
    spans = kernel_spans(fn, iters, key)
    if not spans:
        return None
    union, end = 0.0, spans[0][0]
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return union / 1e3 / iters


def host_us(fn, calls=1000):
    """Host microseconds a call of ``fn()`` costs: a host clock over
    ``calls`` calls with no synchronize between them (after one warm-up
    call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def spans_behind_spin(run, reps, layers, spin=40_000_000):
    """``reps`` runs of ``run()`` (``layers`` layers of launches), each
    queued behind a spin kernel (``torch.cuda._sleep`` of ``spin``
    cycles) so that the host enqueues every launch before the card
    reaches them, traced: each run's device span a layer in us (the spin
    kernel's end to the last kernel's end, over ``layers``), each run's
    host enqueue time in ms, and each spin kernel's time in ms."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    host = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(spin)
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    spins = [(a, b) for a, b in events if b - a > 1e3]   # over 1 ms
    spans = []
    for k, (a, b) in enumerate(spins):
        nxt = spins[k + 1][0] if k + 1 < len(spins) else float("inf")
        spans.append((max(e for s, e in events if a < s < nxt) - b)
                     / layers)
    return spans, host, [(b - a) / 1e3 for a, b in spins]


def launch_floor_ms(iters=200):
    """E, the least device time a launch takes: the profiler's mean time
    of ``torch.cuda._sleep(0)`` (a kernel that returns at once)."""
    return kernel_span_ms(lambda i=0: torch.cuda._sleep(0), iters, "")


def free_memory():
    """Collect what is unreachable (a timed engine holds itself in a
    cycle through its wrapped methods) and give the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: B1, flash prefill
# ---------------------------------------------------------------------------
# Edge shapes of B1's Hopper kernel (128-row query and K/V tiles), bf16,
# B=1: S below, at and past one tile, ragged in the last tile and whole;
# GQA groups of 1, 3 and 4 (Hq, Hkv); D 64 and 128; causal and not.
FLASH_EDGE_S = (1, 63, 64, 100, 129, 1000, 1024, 2048)
FLASH_EDGE_HEADS = ((2, 2), (6, 2), (8, 2))


def check_flash(tfa, dev):
    """B1 against its plain version at Llama-3-8B head shapes (B=2, S in
    128/1000/1024, causal and not, bf16 and f32, D=64 once), then at the
    Hopper kernel's edge shapes (``FLASH_EDGE_S`` x ``FLASH_EDGE_HEADS``
    x D 64/128 x causal and not), each bf16 call equal to itself bit for
    bit over two calls. bf16 within 2e-2, f32 within 1e-4 (out and lse)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(2, S, 32, 8, causal, dtype, 128) for S in (128, 1000, 1024)
             for causal in (True, False)
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append((2, 1000, 32, 8, True, torch.bfloat16, 64))
    cases += [(1, S, hq, hkv, causal, torch.bfloat16, D)
              for S in FLASH_EDGE_S for hq, hkv in FLASH_EDGE_HEADS
              for D in (64, 128) for causal in (False, True)]
    worst = {}
    for B, S, hq, hkv, causal, dtype, D in cases:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, S, hq, D), (B, S, hkv, D),
                                 (B, S, hkv, D)))
        out, lse = tfa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        eo, el = max_err(out, ref), max_err(lse, ref_lse)
        label = (f"B={B} S={S} Hq={hq} Hkv={hkv} causal={causal} "
                 f"{str(dtype)[6:]} D={D}")
        if B == 2:
            log(f"  B1 {label}: max|dO|={eo:.3g} max|dLSE|={el:.3g} "
                f"(tol {tol})")
        worst[str(dtype)[6:]] = max(worst.get(str(dtype)[6:], 0.0), eo, el)
        if not (eo <= tol and el <= tol):
            raise AssertionError(f"B1 disagrees with its plain version at "
                                 f"{label}: {eo}, {el}")
        if dtype == torch.bfloat16:
            again, lse2 = tfa.flash_attention_fwd(q, k, v, causal)
            if not (torch.equal(out, again) and torch.equal(lse, lse2)):
                raise AssertionError(f"B1: two calls differ at {label}")
    log(f"  B1 vs plain at {len(cases)} shapes (edge shapes included), "
        f"largest errors: {worst}")


def time_flash(tfa, dev, B, S, Hq=32, Hkv=8, D=128):
    """B1 at [B, S, Hq, D] bf16, causal (q, k, v from a seeded generator),
    held to its plain version within 2e-2: CUDA-event ms beside the plain
    version, the bound (causal FLOPs over 989 TFLOP/s, or each input read
    once and the outputs written once over 3.35 TB/s), its share (bound
    over ms) and SDPA's time. Returns the kernels-line fields."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    q, k, v = (torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    out, _ = tfa.flash_attention_fwd(q, k, v, True)
    ref, _ = tfa.flash_attention_fwd_plain(q, k, v, True)
    err = max_err(out, ref)
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    if err > 2e-2:
        raise AssertionError(f"B1 disagrees at {shape}: {err}")
    del out, ref
    torch.cuda.empty_cache()
    ms = time_ms(lambda i=0: tfa.flash_attention_fwd(q, k, v, True), 10)
    plain_ms = time_ms(
        lambda i=0: tfa.flash_attention_fwd_plain(q, k, v, True), 3)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(
        lambda i=0: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    flops = 2.0 * B * Hq * S * S * D                     # causal QK + PV
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + 4 * B * Hq * S
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "bound_share": bound / ms,
            "tflops": flops / ms / 1e9, "shape": shape}


def time_flash_shapes(tfa, dev, B, S):
    """B1 timed (``time_flash``) at the serving run's largest prefill wave
    [B, S, 32, 128], the llama-2.6b train step's [8, 2048, 24/8, 128] and
    the DeepSeekMoE step's [4, 2048, 16/16, 128]: the kernels-line entry
    (the serving shape's fields, every shape in "per_shape")."""
    rows = []
    for args in ((B, S, 32, 8), (8, 2048, 24, 8), (4, 2048, 16, 16)):
        rows.append(time_flash(tfa, dev, *args))
        log(f"  B1 {rows[-1]['shape']}: {rows[-1]}")
        torch.cuda.empty_cache()
    return dict(rows[0], per_shape=rows,
                library="torch.nn.functional.scaled_dot_product_attention "
                        "(is_causal, enable_gqa) on [B, H, S, D] copies")


# ---------------------------------------------------------------------------
# phase 3: B4, ragged paged decode
# ---------------------------------------------------------------------------
def check_ragged(tpa, dev):
    L, NB, BS, Hkv, D, N, G = 4, 512, 64, 8, 128, 8, 4
    MB = 2048 // BS
    rng = np.random.default_rng(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:N * MB]
                            .reshape(N, MB).astype(np.int32), device=dev)
    lens = torch.tensor([0, 1, 64, 2000, 777, 128, 1500, 33],
                        dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        kp = torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev).to(dtype)
        vp = torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev).to(dtype)
        q = torch.randn(N, Hkv * G, D, generator=g, device=dev).to(dtype)
        for layer in (0, 3):
            got = tpa.ragged_decode_partial(q, kp, vp, table, lens,
                                            layer=layer)
            want = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens,
                                                   layer)
            torch.cuda.synchronize()
            if not (torch.all(got[0][0] == 0) and torch.all(got[2][0] == 0)
                    and torch.all(got[1][0] == -1e30)):
                raise AssertionError("B4: a length-0 slot must emit "
                                     "(0, -1e30, 0)")
            out = got[0][1:] / got[2][1:, ..., None]
            ref = want[0][1:] / want[2][1:, ..., None]
            rel = max_err(out, ref) / ref.abs().max().item()
            # f32: acc, m and l each within 1e-5 of the plain version,
            # relative to their largest magnitude (abs below 1)
            errs = [max_err(a, b) / max(1.0, b.abs().max().item())
                    for a, b in zip(got, want)]
            log(f"  B4 {str(dtype)[6:]} layer={layer}: rel|dOut|={rel:.3g} "
                f"acc/m/l rel err={[f'{e:.3g}' for e in errs]}")
            if dtype == torch.bfloat16 and rel > 1e-2:
                raise AssertionError(f"B4 bf16 disagrees: {rel}")
            if dtype == torch.float32 and max(errs) > 1e-5:
                raise AssertionError(f"B4 f32 disagrees: {errs}")
        del kp, vp


def time_ragged(tpa, dev, lengths, num_blocks, Lc=32, plain=True):
    """B4 at the serving run's decode shape: q [8, 32, 128] bf16 over a
    [32, num_blocks, 64, 8, 128] pool, one launch per layer in turn (each
    layer's blocks are cold in L2, as on the main path): CUDA events over
    back-to-back wrapper calls, the profiler's time of the kernel alone
    and the host microseconds a wrapper call costs."""
    N, Hkv, G, D, BS, MB = len(lengths), 8, 4, 128, 64, 2048 // 64
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    kp = torch.randn(Lc, num_blocks, BS, Hkv, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn_like(kp)
    q = torch.randn(N, Hkv * G, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    table = torch.as_tensor(rng.permutation(np.arange(1, num_blocks))
                            [:N * MB].reshape(N, MB).astype(np.int32),
                            device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = tpa.ragged_decode_partial(q, kp, vp, table, lens, layer=5)
    want = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens, 5)
    out = got[0] / got[2][..., None]
    ref = want[0] / want[2][..., None]
    err = max_err(out, ref)
    if err > 1e-2 * ref.abs().max().item():
        raise AssertionError(f"B4 disagrees at the serving shape: {err}")
    def call(i=0):
        return tpa.ragged_decode_partial(q, kp, vp, table, lens,
                                         layer=i % Lc)
    ms = time_ms(call, 4 * Lc)
    device_ms = kernel_device_ms(call, 2 * Lc, "ragged_decode")
    us = host_us(call)
    plain_ms = time_ms(lambda i=0: tpa.ragged_decode_partial_plain(
        q, kp, vp, table, lens, i % Lc), Lc) if plain else None
    tokens = int(sum(lengths))
    nbytes = 2 * tokens * Hkv * D * 2 + q.numel() * 2 \
        + N * Hkv * G * (D + 2) * 4 + table.numel() * 4 + N * 4
    flops = 4.0 * tokens * Hkv * G * D
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "host_us": us, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None,
            "share_of_bound": bound / device_ms if device_ms else None,
            "shape": f"N={N} sum(len)={tokens} Hq=32 Hkv=8 D=128 bf16"}


# B4's shapes beyond the serving run's: one long slot and eight, each 2000
# positions
RAGGED_LONG = {"n1x2000": [2000], "n8x2000": [2000] * 8}


def time_ragged_long(tpa, dev):
    """B4 (bf16) at RAGGED_LONG's shapes, as :func:`time_ragged` times it,
    each over a pool just large enough for its table."""
    return {name: time_ragged(tpa, dev, lens, len(lens) * 32 + 1,
                              plain=False)
            for name, lens in RAGGED_LONG.items()}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
class CallTimer:
    """Counts an engine method's calls and times each on the host clock up
    to a device synchronize (a decode call ends in a readback anyway; a
    prefill wave is otherwise left in flight for the next decode call)."""

    def __init__(self, obj, name):
        self.args = []
        self.seconds = []
        inner = getattr(obj, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            res = inner(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.args.append(a)
            return res

        setattr(obj, name, wrapped)

    @property
    def n(self):
        return len(self.seconds)


def llama3_8b_bf16(llama, dev):
    """Llama-3-8B with random bf16 weights from SEED, on the card."""
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=SEED, device=dev,
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  Llama-3-8B random bf16 weights: {llama.num_params(params)} "
        f"params in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def serving_mix(cfg, n):
    """The first ``n`` requests of the serving mix: prompt lengths drawn
    from 64-1000 and tokens by ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1001, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    return prompts[:n]


def serve(LLMEngine, build, dev, card, cfg, params, prompts, max_slots,
          decode_kernel, kv_dtype=None):
    """``LLMEngine`` on Llama-3-8B serving ``prompts`` (64 greedy tokens
    each) through ``decode_kernel`` (int8 pools with ``kv_dtype="int8"``;
    int8 weights when ``params`` hold them): the run's numbers, with the
    kernels' launch counts read around it, then one more decode call
    traced. The decode kernels counted are the int8 branches when the
    weights or the pools are int8."""
    eng = LLMEngine(params, cfg, max_slots=max_slots, block_size=64,
                    max_model_len=2048, prompt_buckets=[128, 512, 1024],
                    decode_steps=16, decode_kernel=decode_kernel, seed=SEED,
                    kv_dtype=kv_dtype, device=dev)
    w_int8 = isinstance(params["layers"]["wq"], dict)
    b4 = "ragged_decode_int8" if kv_dtype else "ragged_decode"
    b5 = "mega_decode_int8" if kv_dtype or w_int8 else "mega_decode"
    lens = np.array([len(p) for p in prompts])
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    prefills = CallTimer(eng, "_dispatch_prefill")
    decodes = CallTimer(eng, "_dispatch_decode")
    torch.cuda.reset_peak_memory_stats(dev)
    build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    n_tok = sum(len(out[i]) for i in ids)
    for i in ids:
        toks = out[i]
        if len(toks) != 64 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, "
                                 f"range [{min(toks)}, {max(toks)}]")
    acct = eng.block_accounting()
    if acct["free"] != acct["total"] or acct["backed"] != 0:
        raise AssertionError(f"block ledger unbalanced after drain: {acct}")
    L = cfg.num_layers
    if launches.get("flash_fwd", 0) < L * prefills.n:
        raise AssertionError(f"flash_fwd launched {launches} for "
                             f"{prefills.n} prefill waves")
    if decode_kernel == "ragged" \
            and launches.get(b4, 0) < L * 16 * decodes.n:
        raise AssertionError(f"{b4} launched {launches} for "
                             f"{decodes.n} decode calls")
    if decode_kernel == "mega" and (
            eng.mega_fallbacks
            or launches.get(b5, 0) != 16 * decodes.n
            or launches.get("ragged_decode", 0)
            or launches.get("ragged_decode_int8", 0)):
        raise AssertionError(f"the mega engine launched {launches} for "
                             f"{decodes.n} decode calls of 16 steps "
                             f"(fallbacks {dict(eng.mega_fallbacks)})")
    peak = torch.cuda.max_memory_allocated(dev)
    # each prefill wave's (rows, bucket): B=1 alone, else max_slots rows
    waves = [(1 if len(rows) == 1 else eng.N,
              eng._bucket_for(max(len(ctx) for _s, _r, ctx in rows)))
             for (rows,) in prefills.args]
    step_ms = [1e3 * t / 16 for t in decodes.seconds]
    log(f"  {decode_kernel} decode, {max_slots} slots, weights "
        f"{'int8' if w_int8 else str(cfg.dtype)[6:]}, KV "
        f"{kv_dtype or str(cfg.dtype)[6:]}: served {len(ids)} "
        f"requests, {n_tok} tokens in {wall:.2f} s: {n_tok / wall:.1f} "
        f"output tok/s; prefill waves {waves} took {prefills.seconds} s; "
        f"{decodes.n} decode calls of 16 steps took {decodes.seconds} s "
        f"(median step {float(np.median(step_ms)):.2f} ms); launches "
        f"{launches}; peak memory {peak / 2**30:.2f} GiB; card: {card}")
    summary = {"decode_kernel": decode_kernel, "max_slots": max_slots,
               "int8_weights": w_int8, "kv_dtype": kv_dtype,
               "requests": len(ids), "output_tokens": n_tok,
               "wall_s": wall, "output_tok_per_s": n_tok / wall,
               "prefill_waves": waves, "prefill_s": list(prefills.seconds),
               "decode_calls": decodes.n, "decode_s": list(decodes.seconds),
               "decode_step_ms": step_ms,
               "median_decode_step_ms": float(np.median(step_ms)),
               "launches": launches,
               "peak_mem_gib": peak / 2**30, "prompt_lens": lens.tolist()}
    streams = [out[i] for i in ids]
    summary["traced_decode_call"] = trace_decode_call(eng, prompts[:eng.N])
    return launches, summary, streams, eng.nb


def trace_decode_call(eng, prompts):
    """Where one steady decode call's time goes: admit a full wave, run
    its first decode call, then trace the next one with torch.profiler
    and report the device's busy share of the call's wall time, its
    kernel launches and the kernels that took the most device time. The
    engine is drained afterwards."""
    for p in prompts:
        eng.add_request(p, max_new_tokens=48)
    eng.step()
    torch.cuda.synchronize()
    res = traced(eng.step)
    if res is not None:
        res["launches_per_step"] = res["kernel_launches"] / eng.decode_steps
    eng.run()
    acct = eng.block_accounting()
    if acct["free"] != acct["total"]:
        raise AssertionError(f"block ledger unbalanced after drain: {acct}")
    log(f"  traced decode call ({eng.decode_steps} steps): {res}")
    return res


def union_us(events):
    """The union of the events' device intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return 0.0
    busy, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy, s0, e0 = busy + e0 - s0, s, e
        else:
            e0 = max(e0, e)
    return busy + e0 - s0


def traced(fn, classify=None):
    """Run ``fn()`` once under torch.profiler (device activity only), up to
    a device synchronize, and return the device's busy share of the wall
    time, the kernel launches and the kernels that took the most device
    time (None when the trace holds no device activity), and the busy
    share of the kernels alone (copies left out); with
    ``classify`` (kernel name -> bucket), also the device ms and launches
    of each bucket."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log("  the trace holds no device activity; busy share not measured")
        return None
    busy = union_us(kern)
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    compute = [e for e in kern if not e.name.startswith("Memcpy")]
    res = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "kernel_launches": len(kern),
           "compute_busy_share": union_us(compute) / wall_us,
           "top_kernels_ms": [(name[:60], t / 1e3, n)
                              for name, (t, n) in top]}
    if classify is not None:
        cats = {}
        for name, (t, n) in by_name.items():
            ct, cn = cats.get(classify(name), (0.0, 0))
            cats[classify(name)] = (ct + t / 1e3, cn + n)
        res["by_category_ms_launches"] = cats
    return res


# ---------------------------------------------------------------------------
# phase 5: card vs CPU streams
# ---------------------------------------------------------------------------
def numpy_params(cfg, seed):
    """f32 weights made with numpy, scaled as llama.init_params does."""
    rng = np.random.default_rng(seed)
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(h)

    def rnd(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= scale
        return a

    return {
        "embed": rnd((cfg.vocab_size, h), s),
        "layers": {
            "attn_norm": np.ones((L, h), np.float32),
            "wq": rnd((L, h, nq * d), s), "wk": rnd((L, h, nkv * d), s),
            "wv": rnd((L, h, nkv * d), s),
            "wo": rnd((L, nq * d, h), s / math.sqrt(2 * L)),
            "mlp_norm": np.ones((L, h), np.float32),
            "w_gate": rnd((L, h, f), s), "w_up": rnd((L, h, f), s),
            "w_down": rnd((L, f, h), 1 / math.sqrt(f) / math.sqrt(2 * L)),
        },
        "final_norm": np.ones((h,), np.float32),
        "lm_head": rnd((h, cfg.vocab_size), s),
    }


def tree_to(tree, device):
    """A nested dict of tensors (int8 leaves included) moved to device."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def cross_device_streams(llama, LLMEngine, dev, decode_kernel, int8=False):
    """Llama-3-8B widths cut to 2 layers and a 32768 vocabulary, f32
    weights made with numpy: two prompts' greedy streams through
    ``decode_kernel`` on the card and on the CPU, which must be equal.
    With ``int8`` the weights are ``quantize_params``'d (once, on the CPU)
    and the pools int8."""
    import dataclasses
    cfg = dataclasses.replace(llama.llama3_8b(), num_layers=2,
                              vocab_size=32768, dtype=torch.float32)
    base = llama.params_from_numpy(numpy_params(cfg, SEED), device="cpu")
    if int8:
        base = llama.quantize_params(base)
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (130, 200)]
    streams = {}
    for where in (str(dev), "cpu"):
        params = tree_to(base, where)
        eng = LLMEngine(params, cfg, max_slots=2, block_size=64,
                        max_model_len=512, prompt_buckets=[256],
                        decode_steps=4, decode_kernel=decode_kernel,
                        kv_dtype="int8" if int8 else None, device=where)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        t0 = time.perf_counter()
        out = eng.run()
        if dict(eng.decode_paths) != {decode_kernel: eng.decode_paths[
                decode_kernel]}:
            raise AssertionError(f"{where}: decode paths "
                                 f"{dict(eng.decode_paths)}")
        streams[where] = [out[i] for i in ids]
        log(f"  {decode_kernel} on {where}: {streams[where]} "
            f"({time.perf_counter() - t0:.1f} s)")
        del params, eng
    if streams[str(dev)] != streams["cpu"]:
        raise AssertionError(f"card and CPU streams differ: {streams}")
    return streams[str(dev)]


# ---------------------------------------------------------------------------
# phase 6: the mega decode path
# ---------------------------------------------------------------------------
def mega_inputs(cfg, dev, walk, t=8, S=16, bs=64, max_len=2048):
    """Inputs of one mega decode step at step ``t`` of a 16-step call:
    [L, NB, 64, Hkv, D] bf16 pools holding random K/V, each slot's table a
    random choice of blocks, frozen prefixes ``walk`` and current lengths
    ``walk + t``, a ring whose rows hold random K/V, and embeddings of
    random tokens as the hidden state."""
    N, L = len(walk), cfg.num_layers
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    MB = max_len // bs
    NB = N * MB + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    pools = [torch.randn(L, NB, bs, Hkv, D, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2)]
    rings = [torch.randn(L, N, S, Hkv, D, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2)]
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))
                            .reshape(N, MB).astype(np.int32), device=dev)
    walk = torch.tensor(walk, dtype=torch.int32, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, N), device=dev)
    return dict(t=t, block_table=table, walk_lens=walk, lens=walk + t,
                ring_k=rings[0], ring_v=rings[1], k_pool=pools[0],
                v_pool=pools[1]), toks


def widen_params(params):
    """The params with every dense leaf in f32 (int8 leaves as they are:
    an f32 model with int8 weights)."""
    def widen(v):
        return v if isinstance(v, dict) else v.float()
    return {k: ({kk: widen(vv) for kk, vv in v.items()} if k == "layers"
                else widen(v)) for k, v in params.items()}


def leaf_tensors(params):
    """Every tensor of a parameter tree (both of an int8 leaf)."""
    return [t for _p, t in leaves(params)]


def check_mega(tmd, cfg, params, dev, walk, kv_int8=False):
    """B5 against its plain version for one step of Llama-3-8B at full
    width and depth, then both timed in bf16; ``params`` may hold int8
    weights (``quantize_params``) and with ``kv_int8`` the pools are int8
    with f32 scales (``quantize_kv`` of the random ones). Checked three
    ways, on the hidden state and the ring rows written at step t, each
    error relative to the largest magnitude of what it is compared with:

    - f32 (dense weights, pools and rings widened from the bf16 ones; int8
      weights and pools as they are): the kernel within 1e-3 of the plain
      version — both round nowhere, only the order of the f32 sums
      differs;
    - bf16: the kernel at most 1.5x as far from the f32 plain result as
      the bf16 plain version is (both round to bf16, a 2^-8 relative
      step, at the same points of each of the 32 layers; which of two
      neighbours a sum rounds to depends on its order, and the
      differences carry through the later layers, so the two bf16
      versions differ from each other by about as much as each differs
      from f32);
    - bf16 kernel against bf16 plain: printed.

    cuBLAS's reduced-precision bf16 reductions are off while the plain
    versions run, so they accumulate in f32 as the kernel does. Returns
    the kernels-line entry fields (bf16)."""
    import dataclasses
    from paddle_tpu_torch.kernels.quant_matmul import quantize_kv
    kw, toks = mega_inputs(cfg, dev, walk)
    N, t, L = len(walk), kw["t"], cfg.num_layers
    w_int8 = isinstance(params["layers"]["wq"], dict)
    if kv_int8:
        qk, sk = quantize_kv(kw.pop("k_pool"))
        qv, sv = quantize_kv(kw.pop("v_pool"))
        kw.update(k_pool=qk, v_pool=qv, ks_pool=sk, vs_pool=sv)
        del qk, qv, sk, sv

    def outs(res):
        return res[0], res[1][:, :, t], res[2][:, :, t]

    def run(fn, c, p, k, fresh=True):
        if fresh:
            k = dict(k, ring_k=k["ring_k"].clone(), ring_v=k["ring_v"].clone())
        return fn(p, c, x0=p["embed"][toks].to(c.dtype), **k)

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        got = outs(run(tmd.mega_decode_step, cfg, params, kw))
        want = outs(run(tmd.mega_decode_step_plain, cfg, params, kw))
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = widen_params(params)
        kw32 = {k: v.float() if torch.is_tensor(v) and v.is_floating_point()
                else v for k, v in kw.items()}
        got32 = outs(run(tmd.mega_decode_step, cfg32, p32, kw32))
        want32 = outs(run(tmd.mega_decode_step_plain, cfg32, p32, kw32))
        torch.cuda.synchronize()
        ms32 = time_ms(lambda i=0: run(tmd.mega_decode_step, cfg32, p32,
                                       kw32, False), 3)
        del p32, kw32
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    names = ("x", "ring_k", "ring_v")
    errs = {
        "f32_kernel_vs_plain": [rel_err(a, b) for a, b in zip(got32, want32)],
        "bf16_kernel_vs_f32": [rel_err(a, b) for a, b in zip(got, want32)],
        "bf16_plain_vs_f32": [rel_err(a, b) for a, b in zip(want, want32)],
        "bf16_kernel_vs_plain": [rel_err(a, b) for a, b in zip(got, want)]}
    form = (f"weights {'int8' if w_int8 else 'bf16'}, KV "
            f"{'int8' if kv_int8 else 'bf16'}")
    log(f"  B5 vs plain, Llama-3-8B N={N} walk={walk} t={t}, {form}: "
        f"relative errors of {names}: {errs}; f32 kernel {ms32:.2f} ms")
    ok = all(torch.isfinite(a).all() for a in got + got32) \
        and max(errs["f32_kernel_vs_plain"]) <= 1e-3 \
        and all(k <= 1.5 * p for k, p in zip(errs["bf16_kernel_vs_f32"],
                                             errs["bf16_plain_vs_f32"]))
    if not ok:
        raise AssertionError(f"B5 disagrees with its plain version ({form}):"
                             f" {errs}")
    err = max_err(got[0], want[0])
    del got, want, got32, want32
    torch.cuda.empty_cache()
    # timed in place: each launch writes the same ring rows again
    ms = time_ms(lambda i=0: run(tmd.mega_decode_step, cfg, params, kw,
                                 False), 10)
    plain_ms = time_ms(lambda i=0: run(tmd.mega_decode_step_plain, cfg,
                                       params, kw, False), 3)
    # each input read once, each output written once: the layer weights
    # (int8 matrices and their scales), the walk's K/V (int8 rows and
    # their f32 scales), the ring rows j < t and the new ones, x in and out
    lay = params["layers"]
    w_bytes = sum(w.numel() * w.element_size() for w in leaf_tensors(lay))
    Hkv, D, Hq = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    kv_row = Hkv * D * 2
    pool_row = Hkv * D + Hkv * 4 if kv_int8 else kv_row
    walked = sum(walk)
    nbytes = (w_bytes + 2 * L * walked * pool_row + 2 * L * N * t * kv_row
              + 2 * L * N * kv_row + 2 * N * cfg.hidden_size * 2
              + kw["block_table"].numel() * 4 + 2 * N * 4)
    w_elems = sum((w["q"] if isinstance(w, dict) else w).numel()
                  for k, w in lay.items() if "norm" not in k)
    flops = 2.0 * N * w_elems + 4.0 * L * Hq * D * (walked + N * (t + 1))
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    res = {"max_abs_err": err, "rel_err": errs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": None, "bytes": nbytes, "f32_ms": ms32,
           "share_of_bound": max(t_ops, t_bytes) / ms,
           "schedule": static_schedule(tmd, cfg, dev, N, w_int8),
           "shape": f"L={L} h={cfg.hidden_size} F={cfg.intermediate_size} "
                    f"Hq={Hq} Hkv={Hkv} D={D} bf16, {form}, N={N}, "
                    f"walk={walk}, t={t}"}
    log(f"  B5 timing: {res}")
    del kw
    return res


def static_schedule(tmd, cfg, dev, n_slots, w_int8, head=None):
    """B5's static split of each phase's units over its grid, from the
    kernel library's own schedule code (``mega_decode.schedule``): what
    the kernel is set to do, not a measurement of what it did. Printed
    on its own line, beside the kernels line."""
    per_sm = tmd.blocks_per_sm(cfg.dtype, cfg.head_dim, n_slots, w_int8)
    blocks = per_sm * torch.cuda.get_device_properties(
        dev).multi_processor_count
    return {"blocks_per_sm": per_sm, "blocks": blocks,
            "phases": tmd.schedule(cfg, blocks, w_int8=w_int8, head=head)}


def first_divergence(a, b):
    """(request index, token index) where two stream lists first differ,
    or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return (i, j)
        if len(x) != len(y):
            return (i, min(len(x), len(y)))
    return None


# ---------------------------------------------------------------------------
# spec phases (s1)-(s4): B5's multi-step form, speculative serving, and the
# paged-cache kernels B6-B8
# ---------------------------------------------------------------------------
def llama32_1b_draft(llama, cfg, dev):
    """The draft of Llama-3-8B at meta-llama/Llama-3.2-1B's published
    widths (16 layers, hidden 2048, ffn 8192, 32 heads, 8 kv heads of 64,
    tied embeddings; it shares Llama-3's 128,256-token vocabulary; its
    llama3 RoPE scaling is not modelled), random bf16 weights from seed 1,
    on the card."""
    import dataclasses
    dcfg = dataclasses.replace(llama.draft_config(
        cfg, num_layers=16, hidden_size=2048, intermediate_size=8192,
        num_heads=32, num_kv_heads=8, head_dim=64), tie_embeddings=True)
    return dcfg, llama.init_params(dcfg, seed=1, device=dev,
                                   dtype=torch.bfloat16)


def loop_inputs(cfg, dev, walk, k=4, bs=64, max_len=2048, budgets=None,
                eos=None, active=None):
    """One draft wave's inputs for ``mega_decode_loop``: [L, NB, 64, Hkv,
    D] pools of random K/V in the model dtype, a random block table, the
    frozen prefixes ``walk`` (also the rows' lengths), random last tokens;
    every row active with a budget of k and no eos unless given."""
    N, L = len(walk), cfg.num_layers
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    MB = max_len // bs
    NB = N * MB + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    rng = np.random.default_rng(SEED + 9)
    pools = [torch.randn(L, NB, bs, Hkv, D, generator=g, device=dev,
                         dtype=torch.bfloat16).to(cfg.dtype)
             for _ in range(2)]
    walk = torch.tensor(walk, dtype=torch.int32, device=dev)

    def ints(v, fill):
        return torch.as_tensor(np.asarray(v if v is not None else [fill] * N,
                                          np.int32), device=dev)
    return dict(
        n_steps=k, walk_lens=walk, lens=walk.clone(),
        block_table=torch.as_tensor(rng.permutation(np.arange(1, NB))
                                    .reshape(N, MB).astype(np.int32),
                                    device=dev),
        active=ints(active, 1).bool(),
        last0=torch.as_tensor(rng.integers(0, cfg.vocab_size, N)
                              .astype(np.int32), device=dev),
        budgets=ints(budgets, k), eos_ids=ints(eos, -1), k_pool=pools[0],
        v_pool=pools[1])


def run_loop(fn, params, cfg, kw):
    """``fn`` (the kernel or its plain version) on fresh zeroed rings."""
    L, N = cfg.num_layers, kw["last0"].shape[0]
    shape = (L, N, kw["n_steps"], cfg.num_kv_heads, cfg.head_dim)
    rk = torch.zeros(shape, dtype=cfg.dtype, device=kw["last0"].device)
    return fn(params, cfg,
              x0=params["embed"][kw["last0"].long()].to(cfg.dtype),
              ring_k=rk, ring_v=torch.zeros_like(rk), **kw)


def loop_bound(cfg, params, kw):
    """Bytes and operations a k-step draft wave must take: every step
    streams the layer weights and the head again (the k steps run one
    after another, each on the last one's token, and gigabytes of weights
    stay in no on-chip memory between them), walks the rows' pool
    prefixes and the ring rows written so far, and writes its ring rows;
    the operations are the weights' and the head's products and the
    attention's. Returns (bound ms, "bytes" or "operations", bytes)."""
    lay = params["layers"]
    k, N = kw["n_steps"], kw["last0"].shape[0]
    L, Hq, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    h, V = cfg.hidden_size, cfg.vocab_size
    isz = torch.empty((), dtype=cfg.dtype).element_size()
    w_bytes = sum(t.numel() * t.element_size() for t in leaf_tensors(lay))
    w_elems = sum((w["q"] if isinstance(w, dict) else w).numel()
                  for key, w in lay.items() if "norm" not in key)
    head = {k_: v for k_, v in params.items()
            if k_ in ("lm_head", "final_norm")}
    head_bytes = sum(t.numel() * t.element_size()
                     for t in leaf_tensors(head))
    if cfg.tie_embeddings:
        head_bytes += V * h * isz
    act = kw["active"].cpu().numpy()
    walked = int((kw["walk_lens"].cpu().numpy() * act).sum())
    kv_row = Hkv * D * isz
    nbytes = flops = 0.0
    for s in range(k):
        nbytes += (w_bytes + head_bytes + 2 * L * walked * kv_row
                   + 2 * L * N * (s + 1) * kv_row + 2 * N * h * isz)
        flops += 2.0 * N * (w_elems + h * V) \
            + 4.0 * L * Hq * D * (walked + N * (s + 1))
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), \
        "operations" if t_ops > t_bytes else "bytes", nbytes


def check_loop(tmd, cfg, params, dev, walk, label, budgets=None, eos=None,
               active=None, time_it=True):
    """B5's multi-step form against mega_decode_loop_plain for one k = 4
    wave. f32 models: the emitted tokens and the final last/lens/done/
    budgets equal the plain version's, the rings within 1e-3 of their
    largest magnitude. bf16 models: the first step's ring rows (which no
    token of the wave has touched yet) by phase 6(a)'s rule against the
    f32 plain result of the same weights (int8 leaves stay int8), and the
    first divergence of the emitted tokens from the bf16 plain version's
    reported (bf16 logits tie often; a flipped argmax changes the rest of
    the row), and with no eos the final lens/done/budgets equal the plain
    version's (they follow the steps, not the tokens). cuBLAS's reduced-precision bf16 reductions are off for the
    plain versions. Returns the result fields, timed when ``time_it``."""
    import dataclasses
    kw = loop_inputs(cfg, dev, walk, budgets=budgets, eos=eos,
                     active=active)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        got = run_loop(tmd.mega_decode_loop, params, cfg, kw)
        want = run_loop(tmd.mega_decode_loop_plain, params, cfg, kw)
        torch.cuda.synchronize()
        res = {"form": label, "N": len(walk), "walk": list(walk),
               "emitted": got[0].t().tolist(),
               "plain_emitted": want[0].t().tolist()}
        names = ("emitted", "last", "lens", "done", "budgets")
        if cfg.dtype == torch.float32:
            diff = [n for n, a, b in zip(names, got[:5], want[:5])
                    if not torch.equal(a.long(), b.long())]
            errs = [rel_err(a, b) for a, b in zip(got[5:], want[5:])]
            res.update(states_equal=not diff, ring_rel_err=errs)
            ok = not diff and max(errs) <= 1e-3
        else:
            cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
            p32 = widen_params(params)
            kw32 = {k: (v.float() if torch.is_tensor(v)
                        and v.is_floating_point() else v)
                    for k, v in kw.items()}
            want32 = run_loop(tmd.mega_decode_loop_plain, p32, cfg32, kw32)
            torch.cuda.synchronize()
            del p32, kw32

            def row0(res_):
                return [r[:, :, 0] for r in res_[5:]]
            kern = [rel_err(a, b) for a, b in zip(row0(got), row0(want32))]
            plain = [rel_err(a, b) for a, b in zip(row0(want), row0(want32))]
            diff = [] if eos is not None else [
                n for n, a, b in zip(names[2:], got[2:5], want[2:5])
                if not torch.equal(a.long(), b.long())]
            res.update(step0_ring_kernel_vs_f32=kern,
                       step0_ring_plain_vs_f32=plain,
                       lens_done_budgets_equal=not diff,
                       f32_emitted=want32[0].t().tolist(),
                       first_divergence_vs_plain=first_divergence(
                           got[0].t().tolist(), want[0].t().tolist()))
            ok = all(torch.isfinite(r).all() for r in row0(got)) \
                and not diff \
                and all(a <= 1.5 * b for a, b in zip(kern, plain)) \
                and bool(((got[0] >= -1) & (got[0] < cfg.vocab_size)).all())
        # the rings where they are compared: every row in f32, the first
        # step's in bf16 (later rows follow tokens that may differ)
        res["max_abs_err"] = max(
            max_err(a, b) if cfg.dtype == torch.float32
            else max_err(a[:, :, 0], b[:, :, 0])
            for a, b in zip(got[5:], want[5:]))
        log(f"  B5-multi {label}: {res}")
        if not ok:
            raise AssertionError(f"B5-multi disagrees with its plain version "
                                 f"({label}): {res}")
        del got, want
        torch.cuda.empty_cache()
        if time_it:
            res["ms"] = time_ms(lambda i=0: run_loop(tmd.mega_decode_loop,
                                                     params, cfg, kw), 5)
            res["device_ms"] = kernel_device_ms(
                lambda i=0: run_loop(tmd.mega_decode_loop, params, cfg, kw),
                3, "mega_decode_kernel")
            res["plain_ms"] = time_ms(lambda i=0: run_loop(
                tmd.mega_decode_loop_plain, params, cfg, kw), 1)
            res["bound_ms"], res["bound_by"], res["bytes"] = loop_bound(
                cfg, params, kw)
            res["library_ms"] = None
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            res["schedule"] = static_schedule(
                tmd, cfg, dev, len(walk),
                isinstance(params["layers"]["wq"], dict),
                head=tmd._head_mode(params, cfg))
            res["shape"] = (f"L={cfg.num_layers} h={cfg.hidden_size} "
                            f"F={cfg.intermediate_size} Hq={cfg.num_heads} "
                            f"Hkv={cfg.num_kv_heads} D={cfg.head_dim} "
                            f"V={cfg.vocab_size} {str(cfg.dtype)[6:]}, "
                            f"{label}, N={len(walk)}, k=4, walk={walk}")
            log(f"  B5-multi {label} timing: ms {res['ms']:.3f}, plain "
                f"{res['plain_ms']:.2f}, bound {res['bound_ms']:.3f} "
                f"({res['bound_by']})")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    del kw
    return res


def check_loops(tmd, llama, cfg8, params8, dcfg, dparams, dev, walk):
    """(s1): the f32 Llama-3-8B wave (full width and depth, dense untied
    head), the 1B-shaped draft widened to f32 (its tied head held exactly),
    the bf16 1B-shaped draft, the draft's int8 weights, and a cut f32 model at the draft's widths with an int8 head where
    budget and eos end rows mid-loop and a row is inactive."""
    import dataclasses
    out = {}
    cfg32 = dataclasses.replace(cfg8, dtype=torch.float32)
    p32 = widen_params(params8)
    out["llama3_8b_f32"] = check_loop(tmd, cfg32, p32, dev, walk,
                                      "Llama-3-8B f32, dense head")
    del p32
    free_memory()
    out["draft_1b_f32"] = check_loop(
        tmd, dataclasses.replace(dcfg, dtype=torch.float32),
        widen_params(dparams), dev, walk, "1B draft f32, tied head")
    free_memory()
    out["draft_1b_bf16"] = check_loop(tmd, dcfg, dparams, dev, walk,
                                      "1B draft bf16, tied head")
    free_memory()
    q8 = llama.quantize_params(dparams)
    out["draft_1b_int8_weights"] = check_loop(
        tmd, dcfg, q8, dev, walk, "1B draft bf16, int8 weights, tied head")
    del q8
    free_memory()
    # an f32 model at the draft's widths, 2 layers, untied, every matrix
    # and the head int8: row 1's budget ends after 2 steps, row 2 is
    # inactive, row 3 stops at the eos its first run emits at step 1
    scfg = dataclasses.replace(dcfg, num_layers=2, tie_embeddings=False,
                               dtype=torch.float32)
    sp = llama.quantize_params(llama.init_params(scfg, seed=2, device=dev))
    budgets, active = [4, 2, 4, 4], [1, 1, 0, 1]
    first = run_loop(tmd.mega_decode_loop_plain, sp, scfg,
                     loop_inputs(scfg, dev, walk, budgets=budgets,
                                 active=active))[0]
    eos = [-1, -1, -1, int(first[1, 3])]
    res = check_loop(tmd, scfg, sp, dev, walk, "2-layer f32, int8 weights "
                     "and head, budget/eos/inactive rows", budgets=budgets,
                     eos=eos, active=active)
    em = np.array(res["emitted"])                         # [N, k]
    stop = int(np.argmax(em[3] == eos[3]))                # eos step, <= 1
    if not (all(em[1, 2:] == -1) and all(em[2] == -1) and stop <= 1
            and em[3, stop] == eos[3] and all(em[3, stop + 1:] == -1)):
        raise AssertionError(f"B5-multi bookkeeping: emitted {em.tolist()}")
    out["small_int8_head_mid_loop_ends"] = res
    del sp
    free_memory()
    return out


def spec_cross_device(llama, LLMEngine, build, dev, want, kv_int8=False):
    """(s2): phase 5's cut model (f32, 2 layers, 32768 vocabulary) as the
    target and ``draft_config(cfg, num_layers=1)`` with other numpy weights
    as the draft, spec_tokens=4: the draft on the mega path and on the
    ragged path on the card, ragged on the CPU; then the self-draft (draft
    = the target's params and config) on the card through both paths,
    where the draft's tokens are accepted (> 0) and waves commit several
    tokens that later waves read back from the pools. Every wave
    speculates; the streams must all be equal and equal ``want``, the plain
    engine's (with ``kv_int8``, int8 pools everywhere and a plain card
    engine's streams)."""
    import dataclasses
    cfg = dataclasses.replace(llama.llama3_8b(), num_layers=2,
                              vocab_size=32768, dtype=torch.float32)
    dcfg = llama.draft_config(cfg, num_layers=1)
    base = llama.params_from_numpy(numpy_params(cfg, SEED), device="cpu")
    dbase = llama.params_from_numpy(numpy_params(dcfg, SEED + 11),
                                    device="cpu")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (130, 200)]
    kv = "int8" if kv_int8 else None
    kw = dict(max_slots=2, block_size=64, max_model_len=512,
              prompt_buckets=[256], decode_steps=4, kv_dtype=kv)
    if want is None:
        params = tree_to(base, dev)
        eng = LLMEngine(params, cfg, decode_kernel="ragged", device=dev, **kw)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        out = eng.run()
        want = [out[i] for i in ids]
        del params, eng
    streams = {}
    for where, kernel, self_draft in (
            (str(dev), "mega", False), (str(dev), "ragged", False),
            ("cpu", "ragged", False), (str(dev), "mega", True),
            (str(dev), "ragged", True)):
        params = tree_to(base, where)
        dparams = params if self_draft else tree_to(dbase, where)
        eng = LLMEngine(params, cfg, decode_kernel=kernel, device=where,
                        draft_params=dparams,
                        draft_config=cfg if self_draft else dcfg,
                        spec_tokens=4, **kw)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        build.launch_counts.clear()
        t0 = time.perf_counter()
        out = eng.run()
        leg = f"{where} {kernel}" + (" self-draft" if self_draft else "")
        if eng.decode_paths or eng.mega_fallbacks \
                or dict(eng.spec_draft_paths) != {kernel: eng.spec_waves} \
                or (where != "cpu" and kernel == "mega"
                    and build.launch_counts["mega_decode_loop"]
                    != eng.spec_waves) \
                or (self_draft and eng.spec_accepted == 0):
            raise AssertionError(
                f"{leg}: decode paths {dict(eng.decode_paths)}, draft paths "
                f"{dict(eng.spec_draft_paths)}, fallbacks "
                f"{dict(eng.mega_fallbacks)}, launches "
                f"{dict(build.launch_counts)}, {eng.spec_accepted} accepted "
                f"and {eng.spec_committed} committed in {eng.spec_waves} "
                "waves")
        streams[leg] = [out[i] for i in ids]
        log(f"  spec, {leg}, KV {kv or 'f32'}: {streams[leg]} "
            f"({eng.spec_waves} waves, "
            f"{eng.spec_accepted}/{eng.spec_proposed} accepted, "
            f"{eng.spec_committed} committed, "
            f"{time.perf_counter() - t0:.1f} s)")
        del params, dparams, eng
    if any(s != want for s in streams.values()):
        raise AssertionError(f"spec streams differ from the plain ones "
                             f"{want}: {streams}")
    return want


class FnTimer:
    """Times a module-level function on the host clock up to a device
    synchronize while it is installed (``with``), keeping calls whose
    keyword arguments match ``when``."""

    def __init__(self, module, name, **when):
        self.module, self.name, self.when = module, name, when
        self.seconds = []

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            res = inner(*a, **k)
            if all(k.get(kk) == vv for kk, vv in self.when.items()):
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
            return res
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def serve_spec(LLMEngine, teng, build, dev, card, cfg, params, dcfg, dparams,
               prompts, max_slots, decode_kernel, label, want=None):
    """(s3): ``LLMEngine`` on Llama-3-8B with the draft ``dcfg``/
    ``dparams`` (spec_tokens=4) serving ``prompts`` (64 greedy tokens each)
    through ``decode_kernel``: every decode wave speculates (no plain
    decode call, no counted fallback); the mega draft launches B5's
    multi-step form once a wave and never the single-step form. The run's
    numbers (tokens/s from this run, which has no timer in it), then the
    same requests again with the prefill, draft and verify calls timed
    (each ended by a synchronize, which keeps the host from queueing the verify behind
    the draft, so that run's wall time is not reported), one spec wave
    traced, and the first divergence from ``want`` (the plain mega
    engine's streams)."""
    eng = LLMEngine(params, cfg, max_slots=max_slots, block_size=64,
                    max_model_len=2048, prompt_buckets=[128, 512, 1024],
                    decode_steps=16, decode_kernel=decode_kernel, seed=SEED,
                    device=dev, draft_params=dparams, draft_config=dcfg,
                    spec_tokens=4)
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    torch.cuda.reset_peak_memory_stats(dev)
    build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    streams = [out[i] for i in ids]
    n_tok = sum(len(s) for s in streams)
    if any(len(s) != 64 or not all(0 <= t < cfg.vocab_size for t in s)
           for s in streams):
        raise AssertionError(f"{label}: bad streams")
    acct = eng.block_accounting()
    waves = eng.spec_waves
    acceptance = eng.spec_accepted / max(1, eng.spec_proposed)
    per_verify = eng.spec_committed / max(1, eng.spec_verify_calls)
    counts = {k: getattr(eng, k) for k in ("spec_committed", "spec_proposed",
                                           "spec_accepted")}
    bad = []
    if acct["free"] != acct["total"] or acct["backed"] != 0:
        bad.append(f"ledger {acct}")
    if eng.decode_paths or eng.mega_fallbacks \
            or dict(eng.spec_draft_paths) != {decode_kernel: waves}:
        bad.append(f"paths {dict(eng.decode_paths)}, draft paths "
                   f"{dict(eng.spec_draft_paths)}, fallbacks "
                   f"{dict(eng.mega_fallbacks)}")
    if decode_kernel == "mega" and (launches.get("mega_decode_loop", 0)
                                    != waves
                                    or launches.get("mega_decode", 0)):
        bad.append(f"launches {launches} for {waves} waves")
    if decode_kernel == "ragged" and (
            launches.get("mega_decode_loop", 0)
            or launches.get("ragged_decode", 0)
            < waves * 4 * dcfg.num_layers):
        bad.append(f"launches {launches} for {waves} waves")
    # the same requests again, each prefill, draft and verify call timed
    for p in prompts:
        eng.add_request(p, max_new_tokens=64)
    prefills = CallTimer(eng, "_dispatch_prefill")
    with FnTimer(teng, "_paged_decode", kv_prefix="d") as draft_t, \
            FnTimer(teng, "_spec_verify") as verify_t:
        eng.run()
    timed_waves = eng.spec_waves - waves
    if len(draft_t.seconds) != timed_waves \
            or len(verify_t.seconds) != timed_waves:
        bad.append(f"{len(draft_t.seconds)} draft and "
                   f"{len(verify_t.seconds)} verify calls for {timed_waves} "
                   "waves")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    res = {"label": label, "decode_kernel": decode_kernel,
           "max_slots": max_slots, "requests": len(ids),
           "output_tokens": n_tok, "wall_s": wall,
           "output_tok_per_s": n_tok / wall, "spec_waves": waves,
           "acceptance_rate": acceptance,
           "tokens_per_verify_call": per_verify, **counts,
           "timed_run_waves": timed_waves,
           "draft_call_ms_median": 1e3 * float(np.median(draft_t.seconds)),
           "verify_call_ms_median": 1e3 * float(np.median(verify_t.seconds)),
           "draft_call_ms": [1e3 * t for t in draft_t.seconds],
           "verify_call_ms": [1e3 * t for t in verify_t.seconds],
           "prefill_s": list(prefills.seconds), "launches": launches,
           "mega_fallbacks": dict(eng.mega_fallbacks),
           "peak_mem_gib": peak / 2**30,
           "first_divergence_vs_plain_mega": (
               first_divergence(streams, want) if want else None)}
    # one steady spec wave traced: admit a wave and run its first spec
    # wave, then trace the next
    for p in prompts[:eng.N]:
        eng.add_request(p, max_new_tokens=48)
    eng.step()
    torch.cuda.synchronize()
    res["traced_spec_wave"] = traced(eng.step)
    eng.run()
    log(f"  {label}: {res['output_tok_per_s']:.1f} output tok/s over "
        f"{n_tok} tokens in {wall:.2f} s; {waves} spec waves, acceptance "
        f"{res['acceptance_rate']:.3f}, {res['tokens_per_verify_call']:.3f} "
        f"tokens a verify call; timed run: draft call "
        f"{res['draft_call_ms_median']:.2f} ms, verify call "
        f"{res['verify_call_ms_median']:.2f} ms (medians);"
        f" launches {launches}; fallbacks {res['mega_fallbacks']}; peak "
        f"{res['peak_mem_gib']:.2f} GiB; first divergence from the plain "
        f"mega streams {res['first_divergence_vs_plain_mega']}; card: {card}")
    log(f"  {label} traced spec wave: {res['traced_spec_wave']}")
    return res, streams


def check_paged_api(tpa, build, dev, NB=512):
    """(s4): B6, B7 and B8 against their plain versions on phase 3's
    [L=4, NB=512, BS=64] pools at Llama-3-8B's heads (Hq=32, Hkv=8, D=128;
    G=3 and D=64 once each, in bf16 and f32), lengths 0, 1, 64, 2000 and
    more: B7/B8 bit-equal; B6 per slot, its largest error over its own
    largest |ref| (so that a long walk's small outputs are not judged by a
    short one's large ones), f32 within 1e-5, bf16 within 2e-2 (phase 2's
    rule), a zero-length slot exactly 0. Then the API path of the
    JAX package's chip test (tests_tpu/test_serving_tpu.py) at its shape
    — cache init, prefill blocks, decode attention, token append, block
    append — with the launch counts read around it, and each kernel timed
    at Llama-3-8B's shapes beside its bound, its plain version and (B7,
    B8) ``index_put_``: B6 also at RAGGED_LONG's shapes, B8 also cycling
    through eight source sets and destinations (cold in L2). Returns (the
    path's launches, the kernels-line fields of B6, B7, B8)."""
    L, BS, Hkv, N, MB = 4, 64, 8, 8, 32
    rng = np.random.default_rng(SEED + 12)
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:N * MB]
                            .reshape(N, MB).astype(np.int32), device=dev)
    lens = torch.tensor([0, 1, 64, 2000, 777, 128, 1500, 33],
                        dtype=torch.int32, device=dev)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for G, D in ((4, 128), (3, 128), (4, 64)):
            kp, vp = (torch.randn(L, NB, BS, Hkv, D, generator=g,
                                  device=dev).to(dtype) for _ in range(2))
            q = torch.randn(N, G * Hkv, D, generator=g, device=dev).to(dtype)
            cache = tpa.PagedKVCache(kp, vp, table, lens)
            out = tpa.paged_decode_attention(q, cache, layer=3)
            ref = tpa.paged_decode_attention_plain(q, cache, layer=3)
            k_new, v_new = (torch.randn(N, Hkv, D, generator=g, device=dev)
                            .to(dtype) for _ in range(2))
            blk = table.gather(1, (lens.long() // BS)[:, None])[:, 0]
            off = (lens % BS).int()
            got = [kp.clone(), vp.clone()]
            want = [kp.clone(), vp.clone()]
            tpa.paged_append_token(*got, k_new, v_new, blk, off, layer=1)
            tpa.paged_append_token_plain(*want, k_new, v_new, blk, off, 1)
            b7 = all(torch.equal(a, b) for a, b in zip(got, want))
            kb, vb = (torch.randn(MB, BS, Hkv, D, generator=g, device=dev)
                      .to(dtype) for _ in range(2))
            tpa.paged_append_blocks(*got, kb, vb, table[3], layer=2)
            tpa.paged_append_blocks_plain(*want, kb, vb, table[3], 2)
            b8 = all(torch.equal(a, b) for a, b in zip(got, want))
            torch.cuda.synchronize()
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            err = max_err(out, ref)
            live = lens > 0
            rel = ((out.float() - ref.float()).abs().flatten(1).amax(1)[live]
                   / ref.float().abs().flatten(1).amax(1)[live]).max().item()
            key = f"{str(dtype)[6:]} G={G} D={D}"
            errs[key] = {"b6_max_abs_err": err, "b6_slot_rel": rel,
                         "b7_equal": b7, "b8_equal": b8}
            log(f"  B6/B7/B8 {key}: B6 max|d|={err:.3g} (per-slot rel "
                f"{rel:.3g}, tol {tol}), B7 equal {b7}, B8 equal {b8}")
            if not (rel <= tol and b7 and b8 and bool((out[0] == 0).all())):
                raise AssertionError(f"B6/B7/B8 disagree at {key}: "
                                     f"{errs[key]}")
            del kp, vp, got, want
    torch.cuda.empty_cache()

    # the API path at the chip test's shape: N=8, BS=64, Hkv=8, G=3, D=128
    Np, MBp, Gp, D = 8, 8, 3, 128
    prompt_lens = rng.integers(3, MBp * BS - 1, size=Np)
    build.launch_counts.clear()
    cache = tpa.paged_cache_init(Np, Np * MBp + 1, BS, Hkv, D, MBp,
                                 device=dev)
    blocks = [torch.randn(Np * MBp, BS, Hkv, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2)]
    tpa.paged_append_blocks(cache.k_pool, cache.v_pool, *blocks,
                            cache.block_table.reshape(-1))
    cache = cache._replace(lengths=torch.as_tensor(
        prompt_lens.astype(np.int32), device=dev))
    q = torch.randn(Np, Gp * Hkv, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    out = tpa.paged_decode_attention(q, cache)
    k_new, v_new = (torch.randn(Np, Hkv, D, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    bs_ = cache.block_table.gather(
        1, (cache.lengths.long() // BS)[:, None])[:, 0]
    kp0, vp0 = cache.k_pool.clone(), cache.v_pool.clone()
    tpa.paged_append_token(cache.k_pool, cache.v_pool, k_new, v_new, bs_,
                           (cache.lengths % BS).int())
    kb = torch.randn(4, BS, Hkv, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    bids = torch.as_tensor(rng.permutation(np.arange(1, Np * MBp + 1))[:4]
                           .astype(np.int32), device=dev)
    kp1 = cache.k_pool.clone()
    tpa.paged_append_blocks(cache.k_pool, cache.v_pool, kb, kb, bids)
    torch.cuda.synchronize()
    path_launches = dict(build.launch_counts)
    ref = tpa.paged_attention(q, cache._replace(k_pool=kp0, v_pool=vp0))
    cref = tpa.paged_append(tpa.PagedKVCache(kp0, vp0, cache.block_table,
                                             cache.lengths), k_new, v_new)
    kp1_want = cref.k_pool.clone()
    kp1[bids.long()] = kb
    kp1_want[bids.long()] = kb
    path_ok = ((out.float() - ref.float()).abs().max().item() <= 2e-2
               and torch.equal(kp1, kp1_want)
               and torch.equal(cache.k_pool, kp1_want))
    log(f"  paged-cache API path (N=8 BS=64 Hkv=8 G=3 D=128 bf16): "
        f"launches {path_launches}, agrees with the oracles {path_ok}")
    if not path_ok or any(path_launches.get(k, 0) < 1 for k in (
            "paged_decode_attention", "paged_append_token",
            "paged_append_blocks")):
        raise AssertionError(f"paged-cache API path: {path_launches}, "
                             f"ok {path_ok}")
    del cache, blocks, kp0, vp0, kp1, kp1_want, cref
    torch.cuda.empty_cache()

    # timed at Llama-3-8B's heads, bf16, [L=4, NB=512, BS=64] pools
    D, G = 128, 4
    kp, vp = (torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(N, G * Hkv, D, generator=g, device=dev,
                    dtype=torch.bfloat16)

    def fields(ms, plain_ms, nbytes, flops, library_ms, err, shape):
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "library_ms": library_ms, "shape": shape}

    k_new, v_new = (torch.randn(N, Hkv, D, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    blk = table.gather(1, (lens.long() // BS)[:, None])[:, 0]
    off = (lens % BS).int()
    kb, vb = (torch.randn(MB, BS, Hkv, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    ids = table[3]

    def b6_case(lengths):
        n = len(lengths)
        qn = q[:n]
        cache = tpa.PagedKVCache(kp, vp, table[:n], torch.tensor(
            lengths, dtype=torch.int32, device=dev))
        return (lengths, qn, cache,
                lambda i=0: tpa.paged_decode_attention(qn, cache,
                                                       layer=i % L))
    b6_cases = {"s4": b6_case(lens.tolist()),
                **{name: b6_case(lengths)
                   for name, lengths in RAGGED_LONG.items()}}

    def b7_call(i=0):
        return tpa.paged_append_token(kp, vp, k_new, v_new, blk, off,
                                      layer=1)

    def b8_call(i=0):
        return tpa.paged_append_blocks(kp, vp, kb, vb, ids, layer=2)
    # the wrappers' host cost first: once a process has run the profiler,
    # every launch costs it more host time; 200 calls stay within the
    # launch queue, which would otherwise hold the host to the device
    hosts = {name: host_us(case[3], calls=200)
             for name, case in b6_cases.items()}
    hosts["b7"] = host_us(b7_call, calls=200)
    hosts["b8"] = host_us(b8_call, calls=200)

    def time_b6(name, plain=True):
        """B6 at one of ``b6_cases``: events over back-to-back calls (one
        pool layer a call in turn), the kernels alone (the profiler:
        ``device_ms`` sums the call's kernels, ``device_span_ms`` is their
        union, which the share of the bound reads), the host microseconds
        a call, and ``ragged_paged_decode`` (B4 and its normalization:
        another rounding of p, an in-repo note) at the same shape."""
        lengths, qn, cache, call = b6_cases[name]
        n = len(lengths)
        out = tpa.paged_decode_attention(qn, cache, layer=1)
        ref = tpa.paged_decode_attention_plain(qn, cache, layer=1)
        tokens = int(sum(lengths))

        def b4(i=0):
            return tpa.ragged_paged_decode(qn, cache, layer=i % L)
        f = fields(
            time_ms(call, 4 * L),
            time_ms(lambda i=0: tpa.paged_decode_attention_plain(
                qn, cache, i % L), L) if plain else None,
            2 * tokens * Hkv * D * 2 + 2 * qn.numel() * 2 + n * MB * 4
            + n * 4, 4.0 * tokens * Hkv * G * D, None, max_err(out, ref),
            f"N={n} sum(len)={tokens} Hq=32 Hkv=8 D=128 bf16")
        f["device_ms"] = kernel_device_ms(call, 4 * L, "paged_decode")
        f["device_span_ms"] = kernel_span_ms(call, 4 * L, "paged_decode")
        f["host_us"] = hosts[name]
        f["share_of_bound"] = (f["bound_ms"] / f["device_span_ms"]
                               if f["device_span_ms"] else None)
        f["ragged_paged_decode"] = {
            "ms": time_ms(b4, 4 * L),
            "device_ms": kernel_device_ms(b4, 4 * L, "ragged_decode")}
        return f
    b6 = time_b6("s4")
    b6["long_shapes"] = {name: time_b6(name, plain=False)
                         for name in RAGGED_LONG}

    def index_put_token(i=0):
        kp[1, blk.long(), off.long()] = k_new
        vp[1, blk.long(), off.long()] = v_new
    b7 = fields(
        time_ms(b7_call, 50),
        time_ms(lambda i=0: tpa.paged_append_token_plain(
            kp, vp, k_new, v_new, blk, off, 1), 50),
        2 * 2 * N * Hkv * D * 2 + 2 * N * 4, 0.0,
        time_ms(index_put_token, 50), 0.0,
        f"N={N} rows of [Hkv=8, D=128] bf16 into [L=4, NB=512, BS=64] "
        "pools")

    def index_put_blocks(i=0):
        kp[2, ids.long()] = kb
        vp[2, ids.long()] = vb
    b8 = fields(
        time_ms(b8_call, 20),
        time_ms(lambda i=0: tpa.paged_append_blocks_plain(kp, vp, kb, vb,
                                                          ids, 2), 20),
        2 * 2 * kb.numel() * 2 + MB * 4, 0.0, time_ms(index_put_blocks, 20),
        0.0, f"{MB} blocks of [BS=64, Hkv=8, D=128] bf16 (one 2048-token "
        "prefill) into [L=4, NB=512, BS=64] pools")
    # the kernels' own device time: B7/B8 last a few microseconds, less
    # than their wrappers' host work between back-to-back calls; beside
    # them the launch floor E and E + the bytes bound
    floor = launch_floor_ms()

    def with_floor(f, device_ms):
        f["floor_ms"] = floor
        f["floor_bound_ms"] = floor + f["bound_ms"]
        f["share_of_floor_bound"] = f["floor_bound_ms"] / device_ms
        return f
    b7["device_ms"] = kernel_span_ms(b7_call, 50, "append_token_kernel")
    b7["host_us"] = hosts["b7"]
    with_floor(b7, b7["device_ms"])
    # B7 at 64 and 256 rows on distinct random blocks, bit-equal first
    b7["shapes"] = {}
    for n in (64, 256):
        dst = rng.permutation(np.arange(1, NB))[:n]
        bn, on = (torch.as_tensor(a.astype(np.int32), device=dev) for a in (
            dst, rng.integers(0, BS, size=n)))
        kn, vn = (torch.randn(n, Hkv, D, generator=g, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        got, want = [kp.clone(), vp.clone()], [kp.clone(), vp.clone()]
        tpa.paged_append_token(*got, kn, vn, bn, on, layer=1)
        tpa.paged_append_token_plain(*want, kn, vn, bn, on, 1)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"B7 differs from its plain version at "
                                 f"N={n}")
        del got, want

        def call(i=0, kn=kn, vn=vn, bn=bn, on=on):
            return tpa.paged_append_token(kp, vp, kn, vn, bn, on, layer=1)

        def index_put(i=0, kn=kn, vn=vn, bn=bn, on=on):
            kp[1, bn.long(), on.long()] = kn
            vp[1, bn.long(), on.long()] = vn
        fn = fields(
            time_ms(call, 50),
            time_ms(lambda i=0: tpa.paged_append_token_plain(
                kp, vp, kn, vn, bn, on, 1), 20),
            2 * 2 * n * Hkv * D * 2 + 2 * n * 4, 0.0,
            time_ms(index_put, 50), 0.0,
            f"N={n} rows of [Hkv=8, D=128] bf16 on distinct blocks")
        fn["device_ms"] = kernel_span_ms(call, 50, "append_token_kernel")
        b7["shapes"][f"n{n}"] = with_floor(fn, fn["device_ms"])
    b8["device_ms"] = kernel_device_ms(b8_call, 20, "append_blocks_kernel")
    b8["host_us"] = hosts["b8"]
    # B8 cold: eight source sets and destinations in turn (134 MB of
    # traffic a cycle against the 50 MB L2), as a prefill finds them
    rng8 = np.random.default_rng(SEED + 13)
    sets = [(torch.randn(MB, BS, Hkv, D, generator=g, device=dev,
                         dtype=torch.bfloat16),
             torch.randn(MB, BS, Hkv, D, generator=g, device=dev,
                         dtype=torch.bfloat16),
             torch.as_tensor(rng8.permutation(np.arange(1, NB))[:MB]
                             .astype(np.int32), device=dev))
            for _ in range(8)]

    def b8_cold(i=0):
        kc, vc, ic = sets[i % 8]
        return tpa.paged_append_blocks(kp, vp, kc, vc, ic, layer=i % L)
    b8["cold_ms"] = time_ms(b8_cold, 48)
    b8["device_cold_ms"] = kernel_device_ms(b8_cold, 48,
                                            "append_blocks_kernel")
    b8["share_of_bound_cold"] = (b8["bound_ms"] / b8["device_cold_ms"]
                                 if b8["device_cold_ms"] else None)
    with_floor(b8, b8["device_ms"])
    b8["share_of_floor_bound_cold"] = (b8["floor_bound_ms"]
                                       / b8["device_cold_ms"])
    log(f"  B6 timing: {b6}")
    log(f"  B7 timing: {b7}")
    log(f"  B8 timing: {b8}")
    del kp, vp, sets
    torch.cuda.empty_cache()
    chain = paged_chain(tpa, dev, g, rng, NB=NB)
    errs["chain_b6_slot_rel"] = chain["b6_slot_rel"]
    log(json.dumps({"paged_chain": chain}))
    return path_launches, {"b6": b6, "b7": b7, "b8": b8, "checks": errs,
                           "chain": chain}


def paged_chain(tpa, dev, g, rng, layers=32, NB=512, reps=5):
    """The paged-cache API's decode sequence over ``layers`` pool layers of
    [layers, NB, 64, 8, 128] bf16 (4.3 GB of K and V at 32 layers, so each
    layer is cold in L2): a layer is ``paged_append_token`` of 8 rows at
    (s4)'s lengths, then ``paged_decode_attention`` (Hq=32) at lengths +
    1. Checked against the plain chain (rows bit-equal, B6 per slot within
    2e-2 of the slot's largest magnitude), then its device span a layer
    behind a spin kernel (:func:`spans_behind_spin`; us, the median over
    ``reps`` runs)."""
    BS, Hkv, D, N, MB = 64, 8, 128, 8, 32
    table = rng.permutation(np.arange(1, NB))[:N * MB].reshape(N, MB)
    lens = np.array([0, 1, 64, 2000, 777, 128, 1500, 33])
    kp, vp = (torch.randn(layers, NB, BS, Hkv, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    k_new, v_new = (torch.randn(N, Hkv, D, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(N, 4 * Hkv, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    blk, off = (torch.as_tensor(a.astype(np.int32), device=dev) for a in (
        table[np.arange(N), lens // BS], lens % BS))
    cache = tpa.PagedKVCache(kp, vp, torch.as_tensor(
        table.astype(np.int32), device=dev), torch.as_tensor(
            (lens + 1).astype(np.int32), device=dev))
    at = (slice(None), blk.long(), off.long())
    rows = (kp[at].clone(), vp[at].clone())
    ref = []
    for layer in range(layers):
        tpa.paged_append_token_plain(kp, vp, k_new, v_new, blk, off, layer)
        ref.append(tpa.paged_decode_attention_plain(q, cache, layer))
    kp[at], vp[at] = rows

    def run(outs=None):
        for layer in range(layers):
            tpa.paged_append_token(kp, vp, k_new, v_new, blk, off,
                                   layer=layer)
            out = tpa.paged_decode_attention(q, cache, layer=layer)
            if outs is not None:
                outs.append(out)
    outs = []
    run(outs)
    torch.cuda.synchronize()
    new_rows = (k_new.expand(layers, -1, -1, -1),
                v_new.expand(layers, -1, -1, -1))
    rows_ok = torch.equal(kp[at], new_rows[0]) and torch.equal(vp[at],
                                                               new_rows[1])
    rel = max(((o.float() - r.float()).abs().flatten(1).amax(1)
               / r.float().abs().flatten(1).amax(1)).max().item()
              for o, r in zip(outs, ref))
    if not rows_ok or rel > 2e-2:
        raise AssertionError(f"the append-then-attend chain disagrees with "
                             f"the plain chain: rows equal {rows_ok}, B6 "
                             f"per-slot error {rel}")
    spans, host, spin_ms = spans_behind_spin(run, reps, layers)
    del kp, vp, cache, outs, ref, rows
    torch.cuda.empty_cache()
    return {"layers": layers, "N": N, "tokens": int(lens.sum()),
            "us_a_layer": float(np.median(spans)), "runs_us": spans,
            "host_enqueue_ms": host, "spin_ms": spin_ms,
            "queued_ahead": all(h < s for h, s in zip(host, spin_ms)),
            "rows_equal": rows_ok, "b6_slot_rel": rel}


# ---------------------------------------------------------------------------
# phase 7: B2/B3, the flash backward
# ---------------------------------------------------------------------------
def rel_err(a, b):
    """max |a - b| over max |b|."""
    return max_err(a, b) / b.float().abs().max().item()


# Edge shapes of B2/B3's Hopper kernels (64-row K/V and query tiles,
# 128-row dQ items), bf16, B=1: ragged S below, past and across tiles;
# GQA groups of 1, 3 and 4; D 64 and 128; causal and not.
FLASH_BWD_EDGE_S = (1, 63, 100, 129, 1000)


def check_flash_bwd(tfa, dev):
    """B2 (dQ, Delta computed in it) and B3 (dK/dV) against their plain
    versions at llama-2.6b head shapes (Hq=24, Hkv=8, D=128; B=2; S in
    128/1000/2048; causal and not; bf16 and f32; D=64 once), then at the
    Hopper kernels' edge shapes (``FLASH_BWD_EDGE_S`` x
    ``FLASH_EDGE_HEADS`` x D 64/128 x causal and not), each gradient within
    2e-2 (bf16) or 1e-4 (f32) of its largest magnitude (floored at 1e-2)
    and each bf16 call equal to itself bit for bit over two calls (no
    atomics); then the
    kernels' f32 gradients against torch.autograd through a dense f32
    attention at S=256."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = [(2, S, 24, 8, causal, dtype, 128) for S in (128, 1000, 2048)
             for causal in (True, False)
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append((2, 1000, 24, 8, True, torch.bfloat16, 64))
    cases += [(1, S, hq, hkv, causal, torch.bfloat16, D)
              for S in FLASH_BWD_EDGE_S for hq, hkv in FLASH_EDGE_HEADS
              for D in (64, 128) for causal in (False, True)]
    worst = {}
    for B, S, hq, hkv, causal, dtype, D in cases:
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B, S, hq, D), (B, S, hkv, D),
                                     (B, S, hkv, D), (B, S, hq, D)))
        out, lse = tfa.flash_attention_fwd(q, k, v, causal)
        got = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        # S=1 leaves dq and dk zero up to rounding: the largest magnitude
        # is floored at 1e-2
        errs = [max_err(a, b) / max(b.float().abs().max().item(), 1e-2)
                for a, b in zip(got, want)]
        label = (f"B={B} S={S} Hq={hq} Hkv={hkv} causal={causal} "
                 f"{str(dtype)[6:]} D={D}")
        if B == 2:
            log(f"  B2/B3 {label}: rel err dq/dk/dv "
                f"{[f'{e:.3g}' for e in errs]} (tol {tol})")
        worst[str(dtype)[6:]] = max(worst.get(str(dtype)[6:], 0.0), *errs)
        if max(errs) > tol:
            raise AssertionError(f"B2/B3 disagree with their plain versions "
                                 f"at {label}: {errs}")
        if dtype == torch.bfloat16:
            again = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"B2/B3: two calls differ at {label}")
        del q, k, v, do, out, lse, got, want
    log(f"  B2/B3 vs plain at {len(cases)} shapes (edge shapes included), "
        f"largest relative errors: {worst}")
    # the gradients are the derivative: autograd through dense attention
    S = 256
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   for shape in ((2, S, 24, 128), (2, S, 8, 128),
                                 (2, S, 8, 128), (2, S, 24, 128)))
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention.apply(*args, True).backward(do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kk, vv = (t.repeat_interleave(3, dim=2) for t in ref[1:])
    s = torch.einsum("bshd,bthd->bhst", ref[0], kk) / math.sqrt(128)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    torch.einsum("bhst,bthd->bshd", s.masked_fill(~mask, float("-inf"))
                 .softmax(-1), vv).backward(do)
    errs = [rel_err(a.grad, b.grad) for a, b in zip(args, ref)]
    log(f"  f32 kernels vs autograd of dense attention, S={S}: rel err "
        f"dq/dk/dv {[f'{e:.3g}' for e in errs]} (tol 1e-3)")
    if max(errs) > 1e-3:
        raise AssertionError("the flash gradients are not the derivative of "
                             "dense attention")


# ---------------------------------------------------------------------------
# phase 8: the training path
# ---------------------------------------------------------------------------
def llama_2_6b(llama):
    """The repo's training configuration (bench.py's llama-2.6b row)."""
    return llama.LlamaConfig(
        vocab_size=32768, hidden_size=3072, intermediate_size=8192,
        num_layers=24, num_heads=24, num_kv_heads=8, head_dim=128,
        max_seq_len=2048, remat=True)


def train_llama_2_6b(llama, build, dev, card, warmup=2, steps=5, lr=3e-5):
    """``train_step`` on llama-2.6b at full width and depth with bench.py's
    recipe (batch 8, seq 2048, full remat, adafactor, bf16 params; random
    weights and one fixed token batch from seeded generators on the card):
    ``warmup`` steps, then ``steps`` timed ones. The step size is ``lr``
    with adafactor's 1e-3 floor lifted: at the floor, the loss of the
    random-init model on one batch oscillates instead of falling (PERF.md,
    PR 2); the step time does not depend on it. The launch counts are read
    around the whole run and per step; one more step is traced."""
    cfg = llama_2_6b(llama)
    B, S, L = 8, 2048, cfg.num_layers
    t0 = time.perf_counter()
    state = llama.init_train_state(cfg, SEED, optimizer="adafactor",
                                   param_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    n_params = llama.num_params(state.params)
    log(f"  llama-2.6b: {n_params} params (bf16) in "
        f"{time.perf_counter() - t0:.1f} s")

    def step(st):
        return llama.train_step(st, tokens, cfg, optimizer="adafactor",
                                lr=lr, adafactor_eps2=0.0)

    torch.cuda.reset_peak_memory_stats(dev)
    losses, per_step = [], []
    build.launch_counts.clear()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(build.launch_counts)
        state, loss = step(state)
        losses.append(loss)
        per_step.append({k: v - before.get(k, 0)
                         for k, v in build.launch_counts.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [x.item() for x in losses]
    want = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    for i, n in enumerate(per_step):
        if any(n.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"step {i} launched {n}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses {losses}: not finite or not falling")
    tok_s = B * S * steps / wall
    mfu = llama.flops_per_token(cfg, S) * tok_s / BF16_FLOPS
    res = {"config": "llama-2.6b (bench.py:89-92): vocab 32768, hidden 3072, "
           "ffn 8192, 24 layers, 24/8 heads, head_dim 128, remat full, "
           "adafactor, bf16 params", "lr": lr, "adafactor_eps2": 0.0,
           "batch": B, "seq": S,
           "params": n_params, "warmup_steps": warmup, "timed_steps": steps,
           "tokens_per_s": tok_s, "step_s": wall / steps, "mfu": mfu,
           "flops_per_token": llama.flops_per_token(cfg, S),
           "peak_mem_gib": peak / 2**30, "losses": losses,
           "launches_per_step": per_step[-1], "card": card}
    log(f"  trained {steps} steps of {B}x{S} tokens in {wall:.2f} s: "
        f"{tok_s:.1f} tok/s, {wall / steps * 1e3:.1f} ms a step, MFU "
        f"{mfu:.4f}, peak memory {peak / 2**30:.2f} GiB, losses {losses}; "
        f"card: {card}")
    res["traced_step"] = traced(lambda: step(state), kernel_category)
    log(f"  traced train step: {res['traced_step']}")
    return launches, res


# ---------------------------------------------------------------------------
# phase 9: B2/B3 timed at the train steps' shapes
# ---------------------------------------------------------------------------
def sdpa_backward(q, k, v, do):
    """A function running PyTorch's SDPA backward (dq, dk, dv together) on
    [B, S, H, D] inputs, causal, and a note of how it was asked: the flash
    backend with ``enable_gqa``; if that backend refuses GQA, with K/V
    repeated to Hq heads; if it refuses both, the default backend with
    ``enable_gqa``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    tries = (
        ("flash backend, enable_gqa", [SDPBackend.FLASH_ATTENTION],
         lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
        ("flash backend, K/V repeated to Hq heads (it refuses GQA)",
         [SDPBackend.FLASH_ATTENTION],
         lambda: sdpa(qt, kt.repeat_interleave(G, 1),
                      vt.repeat_interleave(G, 1), is_causal=True)),
        ("default backend, enable_gqa", None,
         lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    for note, backends, fwd in tries:
        try:
            if backends is None:
                out = fwd()
            else:
                with sdpa_kernel(backends):
                    out = fwd()
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        except RuntimeError as exc:
            log(f"  SDPA ({note}) refused: {str(exc)[:120]}")
            continue
        return (lambda i=0: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                retain_graph=True)), note
    raise RuntimeError("SDPA's backward ran on no backend")


def time_flash_bwd(tfa, dev, B, S, Hq, Hkv, D=128):
    """B2 and B3 at a train step's shape ([B, S, Hq/Hkv, D] bf16, causal)
    as the step runs them: B2 given the forward's ``out`` (it computes
    Delta), B3 reading that Delta. CUDA-event ms of each beside its plain
    version and its bound (and share), B2 given a torch Delta instead,
    the whole ``flash_attention_bwd`` (Delta + B2 + B3) beside SDPA's
    backward, the library yardstick of the two together. Each gradient is
    held to its plain version within 2e-2 of its largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((B, S, Hq, D), (B, S, Hkv, D),
                                 (B, S, Hkv, D), (B, S, Hq, D)))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    ref_delta = tfa._delta(out, do)
    delta = torch.empty_like(ref_delta)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, True, out=out)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, True)
    want_dq = tfa.flash_dq_plain(q, k, v, do, lse, ref_delta, True)
    err_dq = max_err(dq, want_dq)
    rel_dq = err_dq / want_dq.float().abs().max().item()
    del want_dq
    want_dk, want_dv = tfa.flash_dkv_plain(q, k, v, do, lse, ref_delta,
                                           True)
    err_dk, err_dv = max_err(dk, want_dk), max_err(dv, want_dv)
    rel_dkv = max(err_dk / want_dk.float().abs().max().item(),
                  err_dv / want_dv.float().abs().max().item())
    del want_dk, want_dv, dq, dk, dv
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    if max(rel_dq, rel_dkv) > 2e-2:
        raise AssertionError(f"B2/B3 disagree at {shape}: {rel_dq}, "
                             f"{rel_dkv}")
    torch.cuda.empty_cache()
    ms_dq = time_ms(lambda i=0: tfa.flash_dq(q, k, v, do, lse, delta, True,
                                             out=out), 10)
    ms_dq_given = time_ms(lambda i=0: tfa.flash_dq(q, k, v, do, lse,
                                                   ref_delta, True), 10)
    ms_dkv = time_ms(lambda i=0: tfa.flash_dkv(q, k, v, do, lse, delta,
                                               True), 10)
    ms_bwd = time_ms(lambda i=0: tfa.flash_attention_bwd(
        q, k, v, out, lse, do, True), 10)
    plain_dq = time_ms(lambda i=0: tfa.flash_dq_plain(
        q, k, v, do, lse, ref_delta, True), 3)
    plain_dkv = time_ms(lambda i=0: tfa.flash_dkv_plain(
        q, k, v, do, lse, ref_delta, True), 3)
    torch.cuda.empty_cache()
    fn, note = sdpa_backward(q, k, v, do)
    library_ms = time_ms(fn, 10)
    del fn
    torch.cuda.empty_cache()
    # each input read once, each output written once
    qb, kvb, stat = q.numel() * 2, k.numel() * 2, B * Hq * S * 4

    def bound(n_mm, nbytes):
        flops = n_mm * B * Hq * S * S * D            # causal: S^2/2 pairs
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, \
            nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), \
            "operations" if t_ops >= t_bytes else "bytes"

    # B2: q, k, v, dout, out, lse in; dq, delta out; 3 products (S, dP,
    # dQ). B3: q, k, v, dout, lse, delta in; dk, dv out; 4 products (S, dP,
    # dV, dK). The backward as a function: B2's inputs in, dq, dk, dv out,
    # and 5 products (S, dP, dV, dK, dQ): the 2 that B2 and B3 both
    # recompute are this design's cost, not the function's.
    b_dq, by_dq = bound(3, 4 * qb + 2 * kvb + 2 * stat)
    b_dkv, by_dkv = bound(4, 2 * qb + 4 * kvb + 2 * stat)
    b_bwd, _ = bound(5, 4 * qb + 4 * kvb + stat)
    res = {}
    for name, err, ms, plain, b, by in (
            ("flash_dq", err_dq, ms_dq, plain_dq, b_dq, by_dq),
            ("flash_dkv", max(err_dk, err_dv), ms_dkv, plain_dkv, b_dkv,
             by_dkv)):
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "bound_share": b / ms,
                     "library_ms": library_ms,
                     "library": f"SDPA backward, dq/dk/dv together "
                                f"(compare with flash_attention_bwd): "
                                f"{note}",
                     "bwd_ms": ms_bwd, "bwd_bound_ms": b_bwd,
                     "bwd_bound_share": b_bwd / ms_bwd, "shape": shape}
    res["flash_dq"]["ms_given_delta"] = ms_dq_given
    res["flash_dq"]["rel_err"] = rel_dq
    res["flash_dkv"]["rel_err"] = rel_dkv
    return res


def time_flash_bwd_shapes(tfa, dev):
    """B2 and B3 timed (``time_flash_bwd``) at the llama-2.6b train step's
    [8, 2048, 24/8, 128] and the DeepSeekMoE step's [4, 2048, 16/16, 128]:
    the kernels-line entries (the llama shape's fields, both shapes in
    "per_shape")."""
    rows = []
    for args in ((8, 2048, 24, 8), (4, 2048, 16, 16)):
        rows.append(time_flash_bwd(tfa, dev, *args))
        for name in ("flash_dq", "flash_dkv"):
            r = rows[-1][name]
            log(f"  {name} {r['shape']}: {r['ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f}, share {r['bound_share']:.3f}; plain "
                f"{r['plain_ms']:.2f})" + (
                    f", given a torch Delta {r['ms_given_delta']:.4f}"
                    if name == "flash_dq" else ""))
        r = rows[-1]["flash_dq"]
        log(f"  flash_attention_bwd (Delta + B2 + B3) {r['bwd_ms']:.4f} ms "
            f"(bound {r['bwd_bound_ms']:.4f}, share "
            f"{r['bwd_bound_share']:.3f}) against SDPA's backward "
            f"{r['library_ms']:.4f} ms ({r['library'].split(': ')[-1]})")
    return {name: dict(rows[0][name], per_shape=[r[name] for r in rows])
            for name in ("flash_dq", "flash_dkv")}


# ---------------------------------------------------------------------------
# phase 10: card vs CPU train step
# ---------------------------------------------------------------------------
def leaves(tree):
    """(path, tensor) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return [(f"{k}.{p}" if p else k, t) for k, v in tree.items()
                for p, t in leaves(v)]
    return [("", tree)]


def cross_device_train_step(llama, dev):
    """One AdamW ``train_step`` of llama-2.6b widths cut to 2 layers, f32,
    B=1, S=256, on the card and on the CPU (plain versions) from the same
    numpy-made weights: loss within 1e-5 relative; grad norm and every
    gradient within 1e-3 relative (each leaf against its largest
    magnitude); every updated leaf within 1e-3 of its largest magnitude,
    apart from elements whose gradient is f32 noise around 0 (below 1e-5
    of its leaf's largest), whose AdamW update may take any size up to its
    bound: those are held to 2*lr and counted."""
    import dataclasses
    from paddle_tpu_torch.optimizer.functional import init_moments
    lr = 3e-4
    cfg = dataclasses.replace(llama_2_6b(llama), num_layers=2,
                              dtype=torch.float32)
    tree = numpy_params(cfg, SEED)
    tokens = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (1, 257))
    res = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        params = llama.params_from_numpy(tree, device=where)
        toks = torch.as_tensor(tokens, device=where)
        loss, grads = llama.loss_and_grads(params, toks, cfg)
        gnorm = llama.global_norm(grads)
        mu, nu = init_moments(params, "adamw")
        state = llama.TrainState(params, mu, nu, torch.zeros(
            (), dtype=torch.int32, device=where))
        new, step_loss = llama.train_step(state, toks, cfg, lr=lr)
        res.append({
            "loss": loss.item(), "step_loss": step_loss.item(),
            "gnorm": gnorm.item(),
            "grads": {p: t.cpu() for p, t in leaves(grads)},
            "params": {p: t.cpu() for p, t in leaves(new.params)}})
        log(f"  {where}: loss {loss.item():.7f}, grad norm "
            f"{gnorm.item():.7f} ({time.perf_counter() - t0:.1f} s)")
        del params, grads, state, new, mu, nu
    card, cpu = res
    worst = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
             "step_loss": abs(card["step_loss"] - cpu["step_loss"])
             / abs(cpu["step_loss"]),
             "gnorm": abs(card["gnorm"] - cpu["gnorm"]) / cpu["gnorm"],
             "grads": max(rel_err(card["grads"][p], g)
                          for p, g in cpu["grads"].items())}
    strict, noisy = 0.0, 0
    for p, want in cpu["params"].items():
        err = (card["params"][p] - want).abs()
        gr = cpu["grads"][p].abs()
        noise = (gr > 0) & (gr < 1e-5 * gr.max())
        strict = max(strict, err[~noise].max().item()
                     / want.abs().max().item())
        noisy += int((err[noise] > 1e-3 * want.abs().max()).sum())
        if err[noise].numel() and err[noise].max().item() > 2 * lr:
            raise AssertionError(f"{p}: a noise element moved "
                                 f"{err[noise].max().item()}")
    worst["params"] = strict
    log(f"  card vs CPU: relative errors {worst}; {noisy} updated elements "
        f"whose gradient is noise around 0 differ by more than 1e-3 of "
        f"their leaf (held to 2*lr)")
    if worst["loss"] > 1e-5 or worst["step_loss"] > 1e-5 \
            or max(worst["gnorm"], worst["grads"], worst["params"]) > 1e-3:
        raise AssertionError(f"card and CPU train steps differ: {worst}")
    return dict(worst, noise_elements=noisy)


# ---------------------------------------------------------------------------
# phase 11: B9 (gather_gmm) and B10 (gmm, tgmm) against their plain versions
# ---------------------------------------------------------------------------
def deepseek_routing(tmdisp, tmf, dev, T=8192, h=2048, E=64, f=1408, k=6):
    """The grouped GEMMs' operands at the DeepSeekMoE train step's shapes
    (batch 4 x 2048 tokens, top-6 of 64 experts, expert FFN 1408): bf16
    tokens and experts from ``make_moe_operands`` (seed SEED), their
    routing and its tile-padded layout, as the fused dispatch builds them."""
    x, rw, eg, eu, ed = tmdisp.make_moe_operands(T, h, E, f, torch.bfloat16,
                                                 seed=SEED, device=dev)
    r = tmdisp.fused_routing(x, rw, k)
    inv2d = tmf._inverse_permutation(r.order).reshape(T, k)
    ws = r.weights.reshape(-1)[r.order]
    tok_pad, ws_pad, _, inv_pad, gs_pad = tmf._pad_layout(
        r.gs, r.tok, ws, r.flat_e[r.order], inv2d, E)
    return dict(x=x, rw=rw, eg=eg, eu=eu, ed=ed, r=r, tok_pad=tok_pad,
                gs_pad=gs_pad, gid=tmf._tile_gids(gs_pad, tok_pad.shape[0],
                                                  128),
                Wcat=torch.cat([eg, eu], -1), T=T, h=h, E=E, f=f, k=k)


# Edge shapes of the Hopper kernels of B9 and gmm (grouped_gemm_sm90.cuh):
# gmm (M, K, N, group sizes), unpadded; B9 (tokens, h, n) over the padded
# layout of a skewed top-2 routing to 8 experts. "wrap": 33 64-deep stages
# (K not a multiple of 64: the stage ring's barriers wrap, the last stage is
# ragged) and more output tiles than 2 x 132 persistent blocks; "n1408": a
# multiple of 128 columns but not of 256; "n136": a 128-wide tile with 8
# live columns and a first row tile spanning four groups around an empty
# one. Every gmm shape has tail rows.
SM90_GMM_EDGES = {
    "wrap": (4096, 2056, 2816, [700, 0, 13, 1200, 87, 900, 600, 500]),
    "n1408": (1000, 200, 1408, [3, 60, 0, 200, 5, 1, 500]),
    "n136": (300, 136, 136, [40, 30, 0, 20, 100]),
}
SM90_B9_EDGES = {"wrap": (2048, 2056, 2816), "n1408": (300, 200, 1408)}
# tgmm's Hopper kernel: (M, K, N, group sizes), out [E, K, N]. "ragged":
# group boundaries off 64 and off 8 (a group's last stage holds the next
# group's rows), empty groups, 250 rows past sum(gs), K = 136 and N = 1408;
# "one": one group holds every row, K = 1408, N = 136; "wrap": K = N =
# 2048, 1024 output tiles (more than 2 x 132), up to 19 stages a tile.
SM90_TGMM_EDGES = {
    "ragged": (1000, 136, 1408, [3, 61, 0, 77, 9, 500, 0, 100]),
    "one": (700, 1408, 136, [0, 700, 0]),
    "wrap": (4096, 2048, 2048, [700, 0, 13, 1200, 87, 900, 600, 500]),
}


def check_grouped(tmdisp, tmf, dev):
    """B9, gmm (plain and transpose_rhs) and tgmm against their plain
    versions, each within 1e-2 (bf16) or 1e-5 (f32) of the plain result's
    largest magnitude: (a) small shapes: 300 rows in groups of
    [0, 130, 1, 0, 100] (empty groups, a one-row group, boundaries inside
    128-row tiles, 69 tail rows, which must come out zero), a reduction of
    200 and 136/264-wide outputs (partial tiles), B9 over the padded layout
    of a skewed top-3 routing of 50 tokens; (b) the Hopper kernels' edge
    shapes (``SM90_GMM_EDGES``, ``SM90_B9_EDGES``; B9 with bf16 and int8
    weights), bf16, each called twice and equal to itself bit for bit; (c)
    the train step's shapes (``deepseek_routing``), bf16; tgmm's Hopper
    kernel at ``SM90_TGMM_EDGES``, bf16 and f32 out (1e-2 and 1e-5), each
    called twice and equal to itself, empty groups exact zeros."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    gs = torch.tensor([0, 130, 1, 0, 100], dtype=torch.int32, device=dev)
    errs = {}

    def hold(name, got, want, tol):
        e = rel_err(got, want)
        errs[name] = e
        if not e <= tol:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{e} > {tol}")

    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        dn = str(dtype)[6:]

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        lhs = rnd(300, 200)
        for tr in (False, True):
            rhs = rnd(5, 136, 200) if tr else rnd(5, 200, 136)
            out = tmdisp.gmm(lhs, rhs, gs, tr)
            if not torch.all(out[231:] == 0):
                raise AssertionError("gmm: tail rows are not zero")
            hold(f"gmm {dn} transpose={tr}", out,
                 tmdisp.gmm_plain(lhs, rhs, gs, tr), tol)
        a, b = rnd(300, 136), rnd(300, 200)
        want = tmdisp.tgmm_plain(a.t(), b, gs)
        for odt in dict.fromkeys((torch.float32, dtype)):
            out = tmdisp.tgmm(a.t(), b, gs, out_dtype=odt)
            if not (torch.all(out[0] == 0) and torch.all(out[3] == 0)):
                raise AssertionError("tgmm: empty groups are not zero")
            hold(f"tgmm {dn} out={str(odt)[6:]}", out, want,
                 1e-5 if odt == torch.float32 else tol)
        x, rhs = rnd(50, 136), rnd(4, 136, 264)
        logits = torch.randn(50, 4, generator=g, device=dev)
        logits[:, 0] += 3.0
        r = tmdisp.routing_from_logits(logits, 3)
        inv2d = tmf._inverse_permutation(r.order).reshape(50, 3)
        tok_pad, _, _, _, gs_pad = tmf._pad_layout(
            r.gs, r.tok, r.weights.reshape(-1)[r.order], r.flat_e[r.order],
            inv2d, 4)
        gid = tmf._tile_gids(gs_pad, tok_pad.shape[0], 128)
        hold(f"gather_gmm {dn}", tmf.gather_gmm(x, tok_pad, rhs, gid),
             tmf.gather_gmm_plain(x, tok_pad, rhs, gid), tol)

    def twice(name, fn):
        out = fn()
        if not torch.equal(out, fn()):
            raise AssertionError(f"{name}: two calls differ")
        return out

    def bf16(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    for shape, (M, K, N, sizes) in SM90_GMM_EDGES.items():
        gse = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs = bf16(M, K)
        for tr in (False, True):
            rhs = bf16(len(sizes), N, K) if tr else bf16(len(sizes), K, N)
            out = twice(f"gmm {shape}", lambda: tmdisp.gmm(lhs, rhs, gse, tr))
            if not torch.all(out[sum(sizes):] == 0):
                raise AssertionError(f"gmm {shape}: tail rows are not zero")
            hold(f"gmm {shape} transpose={tr}", out,
                 tmdisp.gmm_plain(lhs, rhs, gse, tr), 1e-2)
    for shape, (T, h, n) in SM90_B9_EDGES.items():
        x = bf16(T, h)
        logits = torch.randn(T, 8, generator=g, device=dev)
        logits[:, 0] += 2.0
        r = tmdisp.routing_from_logits(logits, 2)
        inv2d = tmf._inverse_permutation(r.order).reshape(T, 2)
        tok_pad, _, _, _, gs_pad = tmf._pad_layout(
            r.gs, r.tok, r.weights.reshape(-1)[r.order], r.flat_e[r.order],
            inv2d, 8)
        gid = tmf._tile_gids(gs_pad, tok_pad.shape[0], 128)
        for kind, rhs in (("bf16", bf16(8, h, n)),
                          ("int8", torch.randint(-127, 128, (8, h, n),
                                                 generator=g, device=dev,
                                                 dtype=torch.int8))):
            hold(f"gather_gmm {shape} {kind}",
                 twice(f"gather_gmm {shape} {kind}",
                       lambda: tmf.gather_gmm(x, tok_pad, rhs, gid)),
                 tmf.gather_gmm_plain(x, tok_pad, rhs, gid), 1e-2)
    for shape, (M, K, N, sizes) in SM90_TGMM_EDGES.items():
        gse = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs, rhs = bf16(M, K), bf16(M, N)
        want = tmdisp.tgmm_plain(lhs.t(), rhs, gse)
        for odt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            name = f"tgmm {shape} out={str(odt)[6:]}"
            out = twice(name, lambda: tmdisp.tgmm(lhs.t(), rhs, gse,
                                                  out_dtype=odt))
            if not all(torch.all(out[e] == 0)
                       for e, n in enumerate(sizes) if n == 0):
                raise AssertionError(f"{name}: empty groups are not zero")
            hold(name, out, want, tol)
    d = deepseek_routing(tmdisp, tmf, dev)
    Ap, f = d["tok_pad"].shape[0], d["f"]
    hold("step gather_gmm", tmf.gather_gmm(d["x"], d["tok_pad"], d["Wcat"],
                                           d["gid"]),
         tmf.gather_gmm_plain(d["x"], d["tok_pad"], d["Wcat"], d["gid"]),
         1e-2)
    zw = torch.randn(Ap, f, generator=g, device=dev).to(torch.bfloat16)
    hold("step gmm", tmdisp.gmm(zw, d["ed"], d["gs_pad"]),
         tmdisp.gmm_plain(zw, d["ed"], d["gs_pad"]), 1e-2)
    dgu = torch.randn(Ap, 2 * f, generator=g, device=dev).to(torch.bfloat16)
    hold("step gmm transpose", tmdisp.gmm(dgu, d["Wcat"], d["gs_pad"], True),
         tmdisp.gmm_plain(dgu, d["Wcat"], d["gs_pad"], True), 1e-2)
    xs = d["x"].index_select(0, d["tok_pad"])
    hold("step tgmm", tmdisp.tgmm(xs.t(), dgu, d["gs_pad"],
                                  out_dtype=torch.bfloat16),
         tmdisp.tgmm_plain(xs.t(), dgu, d["gs_pad"]), 1e-2)
    torch.cuda.synchronize()
    log(f"  B9/gmm/tgmm vs plain, relative errors: {errs}")
    return errs


# ---------------------------------------------------------------------------
# phase 12: the MoE training path
# ---------------------------------------------------------------------------
def kernel_category(name):
    """The device-time bucket of a traced kernel by its name."""
    if "grouped_gemm_sm90<" in name:   # <BN, kGather, ...>: B9 or B10's gmm
        gather = name.split("grouped_gemm_sm90<", 1)[1].split(",")[1].strip()
        return "B9 gather_gmm" if gather in ("true", "1") else "B10 gmm"
    for key, cat in (("gather_gmm", "B9 gather_gmm"), ("tgmm", "B10 tgmm"),
                     ("gmm_", "B10 gmm"), ("flash_fwd", "B1"),
                     ("flash_dq", "B2"), ("flash_dkv", "B3")):
        if key in name:
            return cat
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "cuBLAS"
    for keys, cat in ((("index", "gather", "scatter"), "gathers, scatters"),
                      (("sort", "radix"), "sorts"),
                      (("reduce",), "reductions"),
                      (("catarray", "copy"), "copies"),
                      (("elementwise",), "elementwise")):
        if any(k in low for k in keys):
            return cat
    return "other"


def train_moe(moe, build, tmf, dev, card, layers=12, warmup=2, steps=5,
              lr=3e-5):
    """``moe.train_step`` on DeepSeekMoE-16B's widths (``deepseek_moe_16b``:
    hidden 2048, 16 heads of 128, 64 routed experts of 1408, top-6, 2
    shared, vocab 102400, layer 0 dense) cut to ``layers`` layers, as
    bench.py's bench_moe runs it: batch 4 x seq 2048, adafactor, bf16
    params, remat "outs"; random weights and one fixed token batch from
    seeded generators on the card; ``warmup`` steps, then ``steps`` timed
    ones, at lr 3e-5 with adafactor's floor lifted (as phase 8). Each step
    must launch, per MoE layer, B9 twice (forward and recompute), gmm three
    times (down projection; its two dgrads) and tgmm twice, and per layer
    B1, B2 and B3 once; the losses must be finite and fall. One more step is
    traced."""
    import dataclasses
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), num_layers=layers,
                              remat=True, remat_policy="outs")
    B, S = 4, 2048
    t0 = time.perf_counter()
    state = moe.init_train_state(cfg, SEED, optimizer="adafactor",
                                 param_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    n_params = moe.num_params(state.params)
    log(f"  DeepSeekMoE-16B widths, {layers} layers: {n_params} params "
        f"(bf16) in {time.perf_counter() - t0:.1f} s")

    def step(st):
        return moe.train_step(st, tokens, cfg, optimizer="adafactor", lr=lr,
                              adafactor_eps2=0.0)

    torch.cuda.reset_peak_memory_stats(dev)
    losses, per_step = [], []
    build.launch_counts.clear()
    tmf.fused_paths.clear()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(build.launch_counts)
        state, loss = step(state)
        losses.append(loss)
        per_step.append({k: v - before.get(k, 0)
                         for k, v in build.launch_counts.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    fused_paths = dict(tmf.fused_paths)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [x.item() for x in losses]
    n_moe = layers - cfg.first_dense_layers
    want = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers,
            "gather_gmm": 2 * n_moe, "gmm": 3 * n_moe, "tgmm": 2 * n_moe}
    for i, n in enumerate(per_step):
        if n != want:
            raise AssertionError(f"step {i} launched {n}, expected {want}")
    if fused_paths != {"padded": 2 * n_moe * (warmup + steps)}:
        raise AssertionError(f"fused dispatch paths {fused_paths}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses {losses}: not finite or not falling")
    tok_s = B * S * steps / wall
    fpt = moe.flops_per_token(cfg, S)
    mfu = fpt * tok_s / BF16_FLOPS
    res = {"config": f"deepseek_moe_16b (models/moe.py:123) cut to {layers} "
           "layers: hidden 2048, 16/16 heads of 128, 64 experts of 1408, "
           "top-6, 2 shared, vocab 102400, first layer dense; remat outs, "
           "adafactor, bf16 params, dispatch auto (fused)",
           "lr": lr, "adafactor_eps2": 0.0, "batch": B, "seq": S,
           "params": n_params,
           "active_params_per_token": moe.active_params_per_token(cfg),
           "warmup_steps": warmup, "timed_steps": steps,
           "tokens_per_s": tok_s, "step_s": wall / steps, "mfu": mfu,
           "flops_per_token": fpt, "peak_mem_gib": peak / 2**30,
           "losses": losses, "launches_per_step": per_step[-1],
           "fused_paths": fused_paths, "card": card}
    log(f"  trained {steps} steps of {B}x{S} tokens in {wall:.2f} s: "
        f"{tok_s:.1f} tok/s, {wall / steps * 1e3:.1f} ms a step, MFU "
        f"{mfu:.4f}, peak memory {peak / 2**30:.2f} GiB, losses {losses}, "
        f"fused paths {fused_paths}; card: {card}")
    res["traced_step"] = traced(lambda: step(state), classify=kernel_category)
    log(f"  traced MoE train step: {res['traced_step']}")
    res["step_parts"] = step_parts(moe, state, tokens, cfg, lr)
    log(f"  step parts: {res['step_parts']}")
    return launches, res


def step_parts(moe, state, tokens, cfg, lr):
    """One more step's two halves on the host clock up to a device
    synchronize, each traced: forward and backward (``loss_and_grads``),
    then the clip's global norm and the adafactor update."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.optimizer.functional import optimizer_update
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = llama.loss_and_grads(state.params, tokens, cfg, moe.loss_fn)
    torch.cuda.synchronize()
    out["loss_and_grads_ms"] = (time.perf_counter() - t0) * 1e3

    def update():
        scale = (1.0 / (llama.global_norm(grads) + 1e-6)).clamp(max=1.0)
        return optimizer_update(state.params, grads, state.mu, state.nu,
                                state.step, optimizer="adafactor", lr=lr,
                                scale=scale, adafactor_eps2=0.0)

    t0 = time.perf_counter()
    new = update()
    torch.cuda.synchronize()
    out["clip_and_optimizer_ms"] = (time.perf_counter() - t0) * 1e3
    del new
    out["clip_and_optimizer_traced"] = traced(update, classify=kernel_category)
    del grads
    return out


# ---------------------------------------------------------------------------
# phase 13: B9/gmm/tgmm timed at the step's shapes; the two dispatch forms
# ---------------------------------------------------------------------------
def grouped_mm_yardstick(a, b, offs):
    """``torch._grouped_mm(a, b, offs=offs)`` as a timed function, or None
    where this torch has no such call or refuses these operands."""
    gm = getattr(torch, "_grouped_mm", None)
    if gm is None:
        return None
    try:
        gm(a, b, offs=offs)
    except (RuntimeError, TypeError, ValueError) as exc:
        log(f"  torch._grouped_mm refused {tuple(a.shape)} x "
            f"{tuple(b.shape)}: {str(exc)[:120]}")
        return None
    return lambda i=0: gm(a, b, offs=offs)


def time_grouped(tmdisp, tmf, dev):
    """Each grouped-GEMM call of a MoE layer of the train step, at its
    shapes over the padded layout (``deepseek_routing``): CUDA-event ms
    beside the plain version, the bound (the larger of the FLOPs of the
    rows that hold assignments or padding over 989 TFLOP/s — B9 computes
    every padded row — and the bytes of each input read once and the
    output written once over 3.35 TB/s) and ``torch._grouped_mm`` (for B9
    after an index gather of the rows). Returns one kernels-line entry for
    each kernel (its call named in "shape"; every call in "per_shape"),
    with each call's share of its bound (bound ms over ms)."""
    d = deepseek_routing(tmdisp, tmf, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x, gs, tok, gid = d["x"], d["gs_pad"], d["tok_pad"], d["gid"]
    Ap, h, f, E = tok.shape[0], d["h"], d["f"], d["E"]
    rows = int(gs.sum().item())
    offs = torch.cumsum(gs, 0).to(torch.int32)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    zw, dys, dgu = rnd(Ap, f), rnd(Ap, h), rnd(Ap, 2 * f)
    xs = x.index_select(0, tok)
    Wcat, Wd = d["Wcat"], d["ed"]

    def gather_then_gm():
        """torch._grouped_mm after the gather B9 fuses away."""
        if grouped_mm_yardstick(xs, Wcat, offs) is None:
            return None
        return lambda i=0: torch._grouped_mm(x.index_select(0, tok), Wcat,
                                             offs=offs)

    calls = [
        ("gather_gmm", "gate|up forward: x[8192, 2048] gathered by idx "
         f"[{Ap}] @ Wcat[64, 2048, 2816]",
         lambda i=0: tmf.gather_gmm(x, tok, Wcat, gid),
         lambda i=0: tmf.gather_gmm_plain(x, tok, Wcat, gid),
         gather_then_gm(),
         2.0 * Ap * h * 2 * f,
         2 * (x.numel() + Wcat.numel() + Ap * 2 * f) + 4 * (Ap + gid.numel())),
        ("gmm", f"down forward: [{Ap}, 1408] @ [64, 1408, 2048]",
         lambda i=0: tmdisp.gmm(zw, Wd, gs),
         lambda i=0: tmdisp.gmm_plain(zw, Wd, gs),
         grouped_mm_yardstick(zw, Wd, offs),
         2.0 * rows * f * h, 2 * (zw.numel() + Wd.numel() + Ap * h) + 4 * E),
        ("gmm", f"down dgrad: [{Ap}, 2048] @ [64, 1408, 2048]^T",
         lambda i=0: tmdisp.gmm(dys, Wd, gs, True),
         lambda i=0: tmdisp.gmm_plain(dys, Wd, gs, True),
         grouped_mm_yardstick(dys, Wd.transpose(1, 2), offs),
         2.0 * rows * h * f, 2 * (dys.numel() + Wd.numel() + Ap * f) + 4 * E),
        ("gmm", f"gate|up dgrad: [{Ap}, 2816] @ [64, 2048, 2816]^T",
         lambda i=0: tmdisp.gmm(dgu, Wcat, gs, True),
         lambda i=0: tmdisp.gmm_plain(dgu, Wcat, gs, True),
         grouped_mm_yardstick(dgu, Wcat.transpose(1, 2), offs),
         2.0 * rows * 2 * f * h,
         2 * (dgu.numel() + Wcat.numel() + Ap * h) + 4 * E),
        ("tgmm", f"gate|up wgrad: xs^T[2048, {Ap}] @ [{Ap}, 2816]",
         lambda i=0: tmdisp.tgmm(xs.t(), dgu, gs, out_dtype=torch.bfloat16),
         lambda i=0: tmdisp.tgmm_plain(xs.t(), dgu, gs),
         grouped_mm_yardstick(xs.t(), dgu, offs),
         2.0 * rows * h * 2 * f,
         2 * (xs.numel() + dgu.numel() + Wcat.numel()) + 4 * E),
        ("tgmm", f"down wgrad: zw^T[1408, {Ap}] @ [{Ap}, 2048]",
         lambda i=0: tmdisp.tgmm(zw.t(), dys, gs, out_dtype=torch.bfloat16),
         lambda i=0: tmdisp.tgmm_plain(zw.t(), dys, gs),
         grouped_mm_yardstick(zw.t(), dys, offs),
         2.0 * rows * f * h,
         2 * (zw.numel() + dys.numel() + Wd.numel()) + 4 * E),
    ]
    out = {}
    for name, shape, kern, plain, lib, flops, nbytes in calls:
        err = max_err(kern(), plain())
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, \
            nbytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": shape, "max_abs_err": err, "ms": time_ms(kern, 10),
               "plain_ms": time_ms(plain, 3), "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": None if lib is None else time_ms(lib, 10)}
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        log(f"  {name}, {shape}: {row}")
        if name not in out:
            out[name] = dict(row, per_shape=[])
        out[name]["per_shape"].append(row)
    for name, entry in out.items():
        entry["library"] = ("torch._grouped_mm on the same operands" +
                            (" after an index gather of x's rows"
                             if name == "gather_gmm" else ""))
    return out, d


def time_forms(tmdisp, d, dev):
    """The fused and the gmm dispatch forms of the routed FFN, forward and
    backward (gradients of x and the three expert weights), at the step's
    routing shape (``deepseek_routing``): CUDA-event ms of each, and their
    bf16 outputs' difference."""
    x, rw = d["x"], d["rw"]
    ws = [t.detach().requires_grad_(True)
          for t in (x, d["eg"], d["eu"], d["ed"])]
    ct = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3)
                     ).to(x.dtype)
    r = tmdisp.fused_routing(x, rw, d["k"])
    res = {}
    outs = {}
    for form, fn in (("fused", tmdisp.dropless_moe_ffn_fused),
                     ("gmm", tmdisp.dropless_moe_ffn)):
        def run(i=0, fn=fn):
            y = fn(ws[0], r.weights, r.idx, *ws[1:], routing=r)
            return y, torch.autograd.grad(y, ws, ct)
        outs[form] = run()[0].detach()
        res[form + "_fwd_bwd_ms"] = time_ms(run, 5)
    res["fused_vs_gmm_rel"] = rel_err(outs["fused"], outs["gmm"])
    log(f"  dispatch forms, forward + backward at T={x.shape[0]}: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 14: card vs CPU MoE train step
# ---------------------------------------------------------------------------
def cross_device_moe_step(moe, llama, dev):
    """One AdamW ``moe.train_step`` of a small MoE (hidden 256, 4 heads of
    64, 16 experts of 128, top-4, 2 shared, 2 layers with layer 0 dense,
    vocab 512, remat "outs"), f32, B=2, S=256, on the card (fused form:
    B9 and B10) and on the CPU (their plain versions) from the same weights
    (the port's seeded CPU init, through numpy): loss within 1e-5 relative, every gradient within
    1e-3 of its leaf's largest magnitude (phase 10's bounds); then the
    card's gmm form against its fused form, loss within 1e-5 and every
    gradient within 1e-4."""
    import dataclasses
    from paddle_tpu_torch.optimizer.functional import init_moments, tree_map
    cfg = moe.MoEConfig(vocab_size=512, hidden_size=256,
                        moe_intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=4, head_dim=64,
                        num_experts=16, top_k=4, n_shared_experts=2,
                        first_dense_layers=1, max_seq_len=256,
                        dtype=torch.float32, remat=True,
                        remat_policy="outs")
    tree = tree_map(lambda t: t.numpy(),
                    moe.init_params(cfg, SEED, device="cpu"))
    rng = np.random.default_rng(SEED + 11)
    toks = rng.integers(0, cfg.vocab_size, (2, 257))
    res = {}
    for where, c in ((str(dev), cfg), ("cpu", cfg),
                     (str(dev) + " gmm", dataclasses.replace(
                         cfg, dispatch="gmm"))):
        device = where.split()[0]
        params = moe.params_from_numpy(tree, device=device)
        t = torch.as_tensor(toks, device=device)
        loss, grads = llama.loss_and_grads(params, t, c, moe.loss_fn)
        state = moe.TrainState(params, *init_moments(params, "adamw"),
                               torch.zeros((), dtype=torch.int32,
                                           device=device))
        _, step_loss = moe.train_step(state, t, c, lr=3e-4)
        res[where] = {"loss": loss.item(), "step_loss": step_loss.item(),
                      "grads": {p: g.cpu() for p, g in leaves(grads)}}
        log(f"  {where}: loss {loss.item():.7f}")
        del params, grads, state
    card, cpu, gmm = res[str(dev)], res["cpu"], res[str(dev) + " gmm"]
    worst = {}
    for name, a, b in (("card_vs_cpu", card, cpu), ("gmm_vs_fused", gmm,
                                                    card)):
        worst[name] = {
            "loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "step_loss": abs(a["step_loss"] - b["step_loss"])
            / abs(b["step_loss"]),
            "grads": max(rel_err(a["grads"][p], g)
                         for p, g in b["grads"].items() if g.abs().max() > 0)}
    log(f"  relative errors: {worst}")
    cc, gf = worst["card_vs_cpu"], worst["gmm_vs_fused"]
    if max(cc["loss"], cc["step_loss"]) > 1e-5 or cc["grads"] > 1e-3 \
            or max(gf["loss"], gf["step_loss"]) > 1e-5 or gf["grads"] > 1e-4:
        raise AssertionError(f"MoE train steps differ: {worst}")
    return worst


# ---------------------------------------------------------------------------
# int8 phases (a)-(f): B4-int8, B5-int8, int8 serving, int8 streams across
# devices, B9-int8, the int8-expert MoE forward
# ---------------------------------------------------------------------------
def int8_pools(kp, vp):
    """int8 pools and their f32 scale pools from dense ones."""
    from paddle_tpu_torch.kernels.quant_matmul import quantize_kv
    qk, sk = quantize_kv(kp)
    qv, sv = quantize_kv(vp)
    return qk, qv, sk, sv


def check_ragged_int8(tpa, dev):
    """(a) B4's int8 branch against its plain version on int8 pools
    (``quantize_kv`` of random ones) of phase 3's shapes, [L=4, NB=512,
    BS=64, Hkv=8, D=128], lengths 0, 1, 64, 2000 and more, bf16 and f32
    queries, and D=64 once: acc, m and l within 1e-5 of their largest
    magnitude (bf16 queries and int8 rows are exact in f32 and the int8
    walk rounds no probability: only the order of the f32 sums
    differs)."""
    L, NB, BS, Hkv, N, G = 4, 512, 64, 8, 8, 4
    MB = 2048 // BS
    rng = np.random.default_rng(SEED + 12)
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:N * MB]
                            .reshape(N, MB).astype(np.int32), device=dev)
    lens = torch.tensor([0, 1, 64, 2000, 777, 128, 1500, 33],
                        dtype=torch.int32, device=dev)
    worst = {}
    for dtype, D in ((torch.bfloat16, 128), (torch.float32, 128),
                     (torch.bfloat16, 64)):
        kp, vp, ks, vs = int8_pools(
            torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev),
            torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev))
        q = torch.randn(N, Hkv * G, D, generator=g, device=dev).to(dtype)
        for layer in (0, 3):
            got = tpa.ragged_decode_partial(q, kp, vp, table, lens,
                                            layer=layer, ks_pool=ks,
                                            vs_pool=vs)
            want = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens,
                                                   layer, ks, vs)
            torch.cuda.synchronize()
            if not (torch.all(got[0][0] == 0) and torch.all(got[2][0] == 0)
                    and torch.all(got[1][0] == -1e30)):
                raise AssertionError("B4-int8: a length-0 slot must emit "
                                     "(0, -1e30, 0)")
            errs = [max_err(a, b) / max(1.0, b.abs().max().item())
                    for a, b in zip(got, want)]
            key = f"{str(dtype)[6:]} D={D} layer={layer}"
            worst[key] = max(errs)
            log(f"  B4-int8 {key}: acc/m/l rel err "
                f"{[f'{e:.3g}' for e in errs]} (tol 1e-5)")
            if max(errs) > 1e-5:
                raise AssertionError(f"B4-int8 disagrees at {key}: {errs}")
        del kp, vp, ks, vs
    return worst


def time_ragged_int8(tpa, dev, lengths, num_blocks, Lc=32):
    """(a) B4-int8 at the serving run's decode shape: q [8, 32, 128] bf16
    over int8 [32, num_blocks, 64, 8, 128] pools with f32 scales, one
    launch per layer in turn; its bound is the int8 K/V and f32 scale
    bytes (and q, the partials, the table) over 3.35 TB/s."""
    N, Hkv, G, D, BS, MB = len(lengths), 8, 4, 128, 64, 2048 // 64
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    rng = np.random.default_rng(SEED + 13)
    kp, vp, ks, vs = int8_pools(
        torch.randn(Lc, num_blocks, BS, Hkv, D, generator=g, device=dev,
                    dtype=torch.bfloat16),
        torch.randn(Lc, num_blocks, BS, Hkv, D, generator=g, device=dev,
                    dtype=torch.bfloat16))
    q = torch.randn(N, Hkv * G, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    table = torch.as_tensor(rng.permutation(np.arange(1, num_blocks))
                            [:N * MB].reshape(N, MB).astype(np.int32),
                            device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = tpa.ragged_decode_partial(q, kp, vp, table, lens, layer=5,
                                    ks_pool=ks, vs_pool=vs)
    want = tpa.ragged_decode_partial_plain(q, kp, vp, table, lens, 5, ks,
                                           vs)
    err = max(max_err(a, b) / max(1.0, b.abs().max().item())
              for a, b in zip(got, want))
    if err > 1e-5:
        raise AssertionError(f"B4-int8 disagrees at the serving shape: {err}")
    def call(i=0):
        return tpa.ragged_decode_partial(q, kp, vp, table, lens,
                                         layer=i % Lc, ks_pool=ks,
                                         vs_pool=vs)
    ms = time_ms(call, 4 * Lc)
    device_ms = kernel_device_ms(call, 2 * Lc, "ragged_decode")
    us = host_us(call)
    plain_ms = time_ms(lambda i=0: tpa.ragged_decode_partial_plain(
        q, kp, vp, table, lens, i % Lc, ks, vs), Lc)
    tokens = int(sum(lengths))
    nbytes = 2 * tokens * Hkv * (D + 4) + q.numel() * 2 \
        + N * Hkv * G * (D + 2) * 4 + table.numel() * 4 + N * 4
    flops = 4.0 * tokens * Hkv * G * D
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    return {"max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
            "rel_err": err, "ms": ms, "device_ms": device_ms, "host_us": us,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None,
            "share_of_bound": bound / device_ms if device_ms else None,
            "shape": f"N={N} sum(len)={tokens} Hq=32 Hkv=8 D=128, bf16 q, "
                     "int8 pools + f32 scales"}


def prefill_logits_error(teng, cfg, params16, params8, prompts, dev):
    """(c) One prefill wave (``prompts`` padded to the 1024 bucket)
    through the engine's prefill with bf16 weights and pools and with
    int8 weights and pools: the relative error max |l8 - l16| / max |l16|
    of the logits it samples from (the rows' last positions)."""
    bs, bucket = 64, 1024
    B, nblk = len(prompts), bucket // bs
    toks = torch.zeros((B, bucket), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    blk = torch.arange(1, B * nblk + 1, dtype=torch.int32,
                       device=dev).reshape(B, nblk)
    true_len = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                            device=dev)
    shape = (cfg.num_layers, B * nblk + 1, bs, cfg.num_kv_heads,
             cfg.head_dim)
    knobs = (torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32,
                                                      device=dev),
             torch.ones(B, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    captured = []
    real = teng._sample_rows

    def capture(logits, *a, **k):
        captured.append(logits.float().clone())
        return real(logits, *a, **k)

    teng._sample_rows = capture
    try:
        for params, int8 in ((params16, False), (params8, True)):
            if int8:
                pools = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                         "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                         "ks": torch.zeros(shape[:-1], device=dev),
                         "vs": torch.zeros(shape[:-1], device=dev)}
            else:
                pools = {k: torch.zeros(shape, dtype=cfg.dtype, device=dev)
                         for k in ("k", "v")}
            teng._paged_prefill(params, toks, blk, true_len, pools, *knobs,
                                gen, config=cfg)
            del pools
    finally:
        teng._sample_rows = real
    torch.cuda.synchronize()
    l16, l8 = captured
    return {"rows": B, "bucket": bucket, "rel_err": rel_err(l8, l16),
            "argmax_agree": int((l8.argmax(-1) == l16.argmax(-1)).sum())}


def check_gather_gmm_int8(tmdisp, tmf, dev):
    """(e) B9's int8 branch against its plain version: bf16 and f32 x
    over int8 rhs at small shapes (a top-3 routing of 50 tokens to 5
    experts, expert 0 skewed, expert 4 empty; h = 136, n = 272), each
    within 1e-2 (bf16) or 1e-5 (f32) of the plain result's largest
    magnitude; then bf16 at the MoE step's gate|up shape (x [8192, 2048],
    idx [57344], rhs int8 [64, 2048, 2816]: the step's gate|up weights
    through quantize_grouped), timed beside its bound and beside
    ``torch._grouped_mm`` on the widened weight after the gather, a
    yardstick only; "bound_share" is bound ms over ms."""
    from paddle_tpu_torch.kernels.quant_matmul import quantize_grouped
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    errs = {}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        x = torch.randn(50, 136, generator=g, device=dev).to(dtype)
        rhs = torch.randint(-127, 128, (5, 136, 272), generator=g,
                            device=dev, dtype=torch.int8)
        logits = torch.randn(50, 5, generator=g, device=dev)
        logits[:, 0] += 3.0
        logits[:, 4] -= 30.0
        r = tmdisp.routing_from_logits(logits, 3)
        inv2d = tmf._inverse_permutation(r.order).reshape(50, 3)
        tok_pad, _, _, _, gs_pad = tmf._pad_layout(
            r.gs, r.tok, r.weights.reshape(-1)[r.order], r.flat_e[r.order],
            inv2d, 5)
        if int(gs_pad[4]) != 0:
            raise AssertionError(f"expert 4 was meant to be empty: {gs_pad}")
        gid = tmf._tile_gids(gs_pad, tok_pad.shape[0], 128)
        e = rel_err(tmf.gather_gmm(x, tok_pad, rhs, gid),
                    tmf.gather_gmm_plain(x, tok_pad, rhs, gid))
        errs[str(dtype)[6:]] = e
        if not e <= tol:
            raise AssertionError(f"B9-int8 disagrees ({dtype}): {e} > {tol}")
    d = deepseek_routing(tmdisp, tmf, dev)
    x, tok, gid, gs = d["x"], d["tok_pad"], d["gid"], d["gs_pad"]
    Wq = quantize_grouped(d["Wcat"], 1)["q"]
    Ap, h, f, E = tok.shape[0], d["h"], d["f"], d["E"]
    out = tmf.gather_gmm(x, tok, Wq, gid)
    ref = tmf.gather_gmm_plain(x, tok, Wq, gid)
    errs["step"] = rel_err(out, ref)
    if not errs["step"] <= 1e-2:
        raise AssertionError(f"B9-int8 disagrees at the step's shape: {errs}")
    err = max_err(out, ref)
    del out, ref
    W16 = Wq.to(torch.bfloat16)
    offs = torch.cumsum(gs, 0).to(torch.int32)
    xs = x.index_select(0, tok)
    lib = None
    if grouped_mm_yardstick(xs, W16, offs) is not None:
        lib = time_ms(lambda i=0: torch._grouped_mm(x.index_select(0, tok),
                                                    W16, offs=offs), 10)
    del xs
    ms = time_ms(lambda i=0: tmf.gather_gmm(x, tok, Wq, gid), 10)
    plain_ms = time_ms(lambda i=0: tmf.gather_gmm_plain(x, tok, Wq, gid), 3)
    flops = 2.0 * Ap * h * 2 * f
    nbytes = 2 * x.numel() + Wq.numel() + 2 * Ap * 2 * f \
        + 4 * (Ap + gid.numel())
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    res = {"max_abs_err": err, "rel_err": errs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib, "tflops": flops / ms / 1e9,
           "bound_share": max(t_ops, t_bytes) / ms,
           "library": "torch._grouped_mm after an index gather of x's rows, "
                      "on the gate|up weight widened to bf16 once",
           "shape": f"gate|up forward: x[8192, 2048] gathered by idx "
                    f"[{Ap}] @ int8 Wcat[64, 2048, 2816]"}
    log(f"  B9-int8 vs plain: {errs}; step shape: {res}")
    return res


def moe_int8_forward(moe, build, tmf, dev, card, layers=28, cmp_layers=12,
                     warmup=2, runs=5):
    """(f) ``moe.forward`` on DeepSeekMoE-16B (``deepseek_moe_16b``) at
    full depth with ``quantize_expert_params`` (int8 routed experts, f32
    scales) and dispatch "auto" (fused), batch 4 x 2048, random bf16
    weights and tokens from seeded generators: ``warmup`` then ``runs``
    timed forwards (no autograd), each launching B9's int8 branch and B10
    gmm once a MoE layer, then one more traced (device time by kernel
    bucket). Before, the logits of the bf16 and the int8 forward of the
    same weights cut to ``cmp_layers`` layers (both at that depth, so the
    bf16 model fits beside the int8 one) on the batch's first sequence:
    their relative error."""
    import dataclasses
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), num_layers=layers,
                              remat=False, expert_dtype="int8")
    B, S = 4, 2048
    t0 = time.perf_counter()
    params = moe.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    log(f"  DeepSeekMoE-16B, {layers} layers: {moe.num_params(params)} "
        f"params (bf16) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q8 = moe.quantize_expert_params(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0

    def cut(p, n):
        return dict(p, layers={k: ({kk: vv[:n] for kk, vv in v.items()}
                                   if isinstance(v, dict) else v[:n])
                               for k, v in p["layers"].items()})

    ccfg = dataclasses.replace(cfg, num_layers=cmp_layers)
    with torch.no_grad():
        l16 = moe.forward(cut(params, cmp_layers), tokens[:1], ccfg)
        l8 = moe.forward(cut(q8, cmp_layers), tokens[:1], ccfg)
    logits_rel = rel_err(l8, l16)
    agree = float((l8.argmax(-1) == l16.argmax(-1)).float().mean())
    del l16, l8, params
    free_memory()
    expert_bytes = sum(t.numel() * t.element_size() for k in
                       ("e_gate", "e_up", "e_down")
                       for t in q8["layers"][k].values())
    torch.cuda.reset_peak_memory_stats(dev)
    build.launch_counts.clear()
    tmf.fused_paths.clear()
    n_moe = layers - cfg.first_dense_layers
    with torch.no_grad():
        for i in range(warmup + runs):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = dict(build.launch_counts)
            logits = moe.forward(q8, tokens, cfg)
            per = {k: v - before.get(k, 0)
                   for k, v in build.launch_counts.items()}
            if per.get("gather_gmm_int8") != n_moe \
                    or per.get("gmm") != n_moe or per.get("gather_gmm"):
                raise AssertionError(f"forward {i} launched {per}, expected "
                                     f"one B9-int8 and one gmm for each of "
                                     f"{n_moe} MoE layers")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(logits).all() \
            or tuple(logits.shape) != (B, S, cfg.vocab_size):
        raise AssertionError(f"int8-expert logits {tuple(logits.shape)} not "
                             "finite or not [B, S, vocab]")
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"config": f"deepseek_moe_16b (models/moe.py:123), {layers} layers "
           "(full depth): hidden 2048, 16/16 heads of 128, 64 experts of "
           "1408, top-6, 2 shared, vocab 102400, first layer dense; "
           "quantize_expert_params (int8 experts, f32 scales), dispatch auto "
           "(fused), bf16 activations, forward only", "layers": layers,
           "batch": B, "seq": S, "warmup": warmup, "runs": runs,
           "tokens_per_s": B * S * runs / wall, "forward_ms": wall / runs * 1e3,
           "peak_mem_gib": peak / 2**30, "int8_expert_gb": expert_bytes / 1e9,
           "quantize_s": quant_s, "launches_per_forward": per,
           "fused_paths": dict(tmf.fused_paths),
           f"logits_rel_err_vs_bf16_at_{cmp_layers}_layers": logits_rel,
           f"argmax_agreement_vs_bf16_at_{cmp_layers}_layers": agree,
           "card": card}
    log(f"  int8-expert forward, {layers} layers, {B}x{S} tokens: "
        f"{res['tokens_per_s']:.1f} tok/s, {res['forward_ms']:.1f} ms a "
        f"forward, peak memory {peak / 2**30:.2f} GiB, launches a forward "
        f"{per}; logits vs bf16 at {cmp_layers} layers: rel err "
        f"{logits_rel:.4g}, argmax agreement {agree:.4f}; card: {card}")
    launches = dict(build.launch_counts)
    del logits
    with torch.no_grad():
        res["traced_forward"] = traced(lambda: moe.forward(q8, tokens, cfg),
                                       classify=kernel_category)
    log(f"  traced int8-expert forward: {res['traced_forward']}")
    del q8
    return launches, res


# ---------------------------------------------------------------------------
# phase 15 (t1-t5): the training memory modes (optimizer/offload.py)
# ---------------------------------------------------------------------------
T_LR = 3e-5      # phase 8's recipe: adafactor, lr 3e-5, its floor lifted


def llama3_8b_train(llama):
    """Llama-3-8B (``llama3_8b()``) as bench.py's bench_8b trains it: seq
    2048, full remat, the cross-entropy in 16 chunks."""
    import dataclasses
    return dataclasses.replace(llama.llama3_8b(), max_seq_len=2048,
                               remat=True, remat_policy="full",
                               loss_chunks=16)


def leaves_of(tree):
    """The tensors of a nested dict, or of lists of them."""
    from paddle_tpu_torch.optimizer.functional import tree_leaves
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves_of(sub)]
    return tree_leaves(tree)


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves_of(tree))


def reckon_8b(llama, cfg, B, S, mode):
    """Peak device bytes of a Llama-3-8B step (bf16 parameters, adafactor)
    reckoned from the code before it runs, by part:

    * ``train_step`` (``mode="plain"``): the backward phase holds the
      parameters, the gradient tree, the activations and the stacked
      gradient of its largest leaf (the unbind's backward stacks the L
      slices while they are alive); the update (``optimizer_update`` maps
      over every leaf before it returns) holds the parameters, the
      gradients, the new leaves made so far and the f32 temporaries of
      the leaf it updates: ~6 copies (``functional.adafactor_update``: g
      in f32, v, rsqrt, u, p in f32, the update's products) of the whole
      leaf, or of one slice of a leaf above 2^30 elements (whose new
      bf16 leaf is made first). The leaves go in tree order: embed,
      final_norm, lm_head, then the layers' (``llama.LAYER_KEYS``);
    * the layer-wise step: the parameters (updated in place) and either
      the activations and one layer's gradients, or the tail update:
      ``d_embed`` in f32, ~6 f32 temporaries of ``embed`` [128256, 4096]
      and the head's gradient;
    * the streaming step: the tail (embedding, head) and the larger of
      the activations with ~3 layers in flight, and the tail update;
    * ``activations``: the saved layer inputs (L x B x S x h bf16), one
      layer's recompute and backward ((10h + 7f) x B x S bf16) and one
      cross-entropy chunk (f32 logits, their gradient and the bf16
      product: 10 x B x S/chunks x V bytes)."""
    from paddle_tpu_torch.optimizer import functional
    h, f, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, \
        cfg.num_layers
    top, layers = llama._shapes(cfg)
    shapes = {**{k: s for k, (s, _) in top.items()},
              **{k: layers[k][0] for k in llama.LAYER_KEYS}}
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    P = 2 * sum(sizes.values())
    layer_bytes = 2 * sum(sizes[k] for k in layers) // L
    acts = (2 * L * B * S * h + 2 * (10 * h + 7 * f) * B * S
            + 10 * B * (S // cfg.loss_chunks) * V)
    tail_update = (4 + 24 + 2) * V * h       # d_embed, 6 f32, d_head
    if mode == "plain":
        update, made, largest = 0, 0, 0
        for k, n in sizes.items():
            shape = shapes[k]
            if len(shape) >= 3 and n > functional._ADAFACTOR_WHOLE:
                row = n // shape[0]
                temp = 24 * row * max(1, functional._ADAFACTOR_CHUNK // row)
                made += 2 * n                 # the new leaf, made first
                update = max(update, 2 * P + made + temp)
            else:
                temp = 24 * n
                update = max(update, 2 * P + made + temp)
                made += 2 * n
            largest = max(largest, temp)
        backward = 2 * P + acts + 2 * max(sizes.values())
        parts = {"params": P, "grads": P, "new_params": P,
                 "adafactor_largest_transient": largest,
                 "activations": acts, "backward_phase": backward,
                 "update_phase": update}
        peak = max(backward, update)
    elif mode == "layerwise":
        parts = {"params": P, "adafactor_tail": tail_update,
                 "activations": acts, "layer_grads": layer_bytes}
        peak = P + max(acts + layer_bytes, tail_update)
    else:
        tail = 4 * V * h
        parts = {"tail": tail, "layers_in_flight": 3 * layer_bytes,
                 "adafactor_tail": tail_update, "activations": acts}
        peak = tail + max(acts + 3 * layer_bytes, tail_update)
    return {"peak": peak, "parts": parts}


def gb(n):
    return round(n / 1e9, 3)


def run_steps(build, step, holder, warmup, steps, after=None):
    """``warmup`` steps, then ``steps`` timed ones (synchronized wall
    clock), of ``step(state) -> (state, loss)`` from the state in the
    one-element list ``holder`` (taken out of it, so that no caller keeps
    the first state alive beside the later ones); the launches of each
    step and the peak device memory over all of them. ``after(state)``
    runs after each step (host checks only: no synchronize)."""
    state = holder.pop()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, per_step = [], []
    build.launch_counts.clear()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(build.launch_counts)
        state, loss = step(state)
        losses.append(loss)
        per_step.append({k: v - before.get(k, 0)
                         for k, v in build.launch_counts.items()
                         if v - before.get(k, 0)})
        if after is not None:
            after(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, {"losses": [x.item() for x in losses], "wall_s": wall,
                   "step_ms": wall / steps * 1e3, "per_step": per_step,
                   "launches": dict(build.launch_counts),
                   "peak_bytes": torch.cuda.max_memory_allocated()}


def check_steps(label, res, want, falling):
    """Each step launched ``want``; the losses are finite (and fall)."""
    for i, n in enumerate(res["per_step"]):
        if any(n.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"{label}: step {i} launched {n}, "
                                 f"expected {want}")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) \
            or (falling and losses[-1] >= losses[0]):
        raise AssertionError(f"{label}: losses {losses} not finite"
                             + (" or not falling" if falling else ""))


def rates(res, B, S, steps, fpt):
    tok_s = B * S * steps / res["wall_s"]
    return {"tokens_per_s": tok_s, "mfu": fpt * tok_s / BF16_FLOPS}


def tokens_for(cfg, B, S, dev, seed=SEED + 1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev)


def train_8b_plain(llama, build, dev, card, total, S=2048, warmup=1,
                   steps=3):
    """(t1) ``llama.train_step`` on Llama-3-8B at full width and depth
    (random bf16 weights, adafactor, lr 3e-5 with the floor lifted, one
    fixed batch): the batch is the largest of 8, 4, 2 whose reckoned peak
    (``reckon_8b``) lies within 0.9 of the card's memory. Each step must
    launch B1 2L times (forward and the remat recompute), B2 and B3 L
    times; the losses must be finite and fall."""
    cfg = llama3_8b_train(llama)
    L = cfg.num_layers
    reck = {b: reckon_8b(llama, cfg, b, S, "plain") for b in (8, 4, 2)}
    B = next((b for b in (8, 4, 2) if reck[b]["peak"] <= 0.9 * total), 2)
    parts = {k: gb(v) for k, v in reck[B]["parts"].items()}
    log(f"  reckoned peaks (GB) by batch: "
        f"{ {b: gb(r['peak']) for b, r in reck.items()} } against 0.9 x "
        f"{gb(total)}; batch {B}: {parts}")
    holder = [llama.init_train_state(cfg, SEED, optimizer="adafactor",
                                     param_dtype=torch.bfloat16,
                                     device=dev)]
    tokens = tokens_for(cfg, B, S, dev)

    def step(st):
        return llama.train_step(st, tokens, cfg, optimizer="adafactor",
                                lr=T_LR, adafactor_eps2=0.0)

    state, res = run_steps(build, step, holder, warmup, steps)
    check_steps("t1", res, {"flash_fwd": 2 * L, "flash_dq": L,
                            "flash_dkv": L}, falling=True)
    res.update(rates(res, B, S, steps, llama.flops_per_token(cfg, S)),
               batch=B, seq=S, warmup=warmup, timed_steps=steps,
               params=llama.num_params(state.params),
               reckoned_peak_gb=gb(reck[B]["peak"]),
               reckoned_parts_gb=parts, card=card)
    log_train("t1 plain train_step", res)
    return res


def log_train(label, res):
    reck = res.get("reckoned_peak_gb")
    log(f"  {label}: batch {res['batch']}, {res['tokens_per_s']:.1f} tok/s, "
        f"{res['step_ms']:.1f} ms a step, MFU {res['mfu']:.4f}, peak "
        f"{gb(res['peak_bytes'])} GB"
        + ("" if reck is None else f" (reckoned {reck})")
        + f", losses {res['losses']}, launches a step "
        f"{res['per_step'][-1]}; card: {res['card']}")


def train_8b_layerwise(llama, offload, build, dev, card, batches, S=2048,
                       warmup=1, steps=3):
    """(t2) ``make_layerwise_train_step`` on Llama-3-8B at each batch of
    ``batches`` (t1's recipe): the same launches a step as t1, finite and
    falling losses."""
    cfg = llama3_8b_train(llama)
    L = cfg.num_layers
    out = {}
    for B in batches:
        reck = reckon_8b(llama, cfg, B, S, "layerwise")
        holder = [offload.init_layerwise_train_state(cfg, SEED, device=dev)]
        tokens = tokens_for(cfg, B, S, dev)
        step_fn = offload.make_layerwise_train_step(cfg, lr=T_LR,
                                                    adafactor_eps2=0.0)
        state, res = run_steps(build, lambda st: step_fn(st, tokens), holder,
                               warmup, steps)
        check_steps(f"t2 batch {B}", res, {"flash_fwd": 2 * L,
                                           "flash_dq": L, "flash_dkv": L},
                    falling=True)
        res.update(rates(res, B, S, steps, llama.flops_per_token(cfg, S)),
                   batch=B, seq=S, warmup=warmup, timed_steps=steps,
                   reckoned_peak_gb=gb(reck["peak"]),
                   reckoned_parts_gb={k: gb(v)
                                      for k, v in reck["parts"].items()},
                   card=card)
        log_train(f"t2 layer-wise step", res)
        out[B] = res
        del state, tokens
        free_memory()
    return out


def pcie_rates(dev, nbytes, reps=5):
    """GB/s of pinned copies of ``nbytes`` (one layer's bf16 weights):
    host to device alone, device to host alone, and both at once on two
    streams (the sum of the two directions), each from a synchronized
    wall clock over ``reps`` copies."""
    from paddle_tpu_torch.optimizer.offload import host_put
    d_src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    d_dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    h = host_put({"a": d_src, "b": d_dst}, dev)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def run(h2d, d2h):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            if h2d:
                with torch.cuda.stream(s1):
                    d_dst.copy_(h["a"], non_blocking=True)
            if d2h:
                with torch.cuda.stream(s2):
                    h["b"].copy_(d_src, non_blocking=True)
        torch.cuda.synchronize()
        return (h2d + d2h) * nbytes * reps / (time.perf_counter() - t0) / 1e9

    run(True, True)
    return {"h2d_gb_s": run(True, False), "d2h_gb_s": run(False, True),
            "both_gb_s": run(True, True), "bytes": nbytes}


def memcpy_category(name):
    """A traced event's bucket: the PCIe copies by direction, else the
    kernel's bucket."""
    if name.startswith("Memcpy HtoD"):
        return "PCIe h2d"
    if name.startswith("Memcpy DtoH"):
        return "PCIe d2h"
    return kernel_category(name)


def train_8b_streaming(llama, offload, build, dev, card, B, layerwise_ms,
                       S=2048, warmup=1, steps=3):
    """(t3) ``make_streaming_train_step`` on Llama-3-8B at t2's batch
    (t1's recipe): the same launches a step as t1 and finite losses;
    after every step each layer tensor (parameters and second moments)
    lies on the CPU in pinned memory, and the card holds at most the
    tail (embedding, final norm, head and their moments) plus 1 GB. The
    pinned bytes against the layers' bytes, the step's PCIe bytes, the
    link's pinned copy rates and the step time against t2's at the same
    batch; one more step traced (device busy share, PCIe copies by
    direction)."""
    cfg = llama3_8b_train(llama)
    L = cfg.num_layers
    reck = reckon_8b(llama, cfg, B, S, "streaming")
    t0 = time.perf_counter()
    state = offload.init_streaming_train_state(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lay_bytes = tree_bytes(state.layers)
    nu_bytes = tree_bytes(state.nu_layers)
    pinned = offload.pinned_bytes([state.layers, state.nu_layers])
    tail_bytes = tree_bytes([state.embed, state.final_norm, state.lm_head,
                             state.nu_embed, state.nu_fn, state.nu_head])
    log(f"  streaming state in {init_s:.1f} s: layers {gb(lay_bytes)} GB "
        f"bf16 + second moments {gb(nu_bytes)} GB in {gb(pinned)} GB "
        f"pinned; tail on the card {gb(tail_bytes)} GB")
    seen = []

    def after(st):
        bad = [t for t in leaves_of([st.layers, st.nu_layers])
               if t.device.type != "cpu" or not t.is_pinned()]
        alloc = torch.cuda.memory_allocated()
        seen.append(alloc)
        if bad or alloc > tail_bytes + 1e9:
            raise AssertionError(f"t3: {len(bad)} layer tensors not pinned "
                                 f"on the host; {alloc} bytes on the card "
                                 f"against a tail of {tail_bytes}")

    after(state)
    tokens = tokens_for(cfg, B, S, dev)
    step_fn = offload.make_streaming_train_step(cfg, lr=T_LR,
                                                adafactor_eps2=0.0,
                                                device=dev)
    holder = [state]
    del state
    state, res = run_steps(build, lambda st: step_fn(st, tokens), holder,
                           warmup, steps, after=after)
    check_steps("t3", res, {"flash_fwd": 2 * L, "flash_dq": L,
                            "flash_dkv": L}, falling=False)
    res.update(rates(res, B, S, steps, llama.flops_per_token(cfg, S)),
               batch=B, seq=S, warmup=warmup, timed_steps=steps,
               reckoned_peak_gb=gb(reck["peak"]),
               reckoned_parts_gb={k: gb(v) for k, v in reck["parts"].items()},
               init_s=init_s, layer_bytes=lay_bytes, nu_bytes=nu_bytes,
               pinned_bytes=pinned, tail_bytes=tail_bytes,
               allocated_between_steps=seen,
               pcie_bytes_per_step=3 * lay_bytes + 2 * nu_bytes,
               layerwise_step_ms=layerwise_ms,
               vs_layerwise=res["step_ms"] / layerwise_ms, card=card)
    log_train("t3 streaming step", res)
    res["pcie"] = pcie_rates(dev, lay_bytes // L)
    log(f"  pinned copy rates: {res['pcie']}; the step moves "
        f"{gb(res['pcie_bytes_per_step'])} GB over PCIe; step time "
        f"{res['step_ms']:.1f} ms against the layer-wise step's "
        f"{layerwise_ms:.1f} at batch {B}")
    res["traced_step"] = traced(lambda: step_fn(state, tokens),
                                classify=memcpy_category)
    log(f"  traced streaming step: {res['traced_step']}")
    del state, tokens
    free_memory()
    return res


def small_llama(llama):
    """(t4)'s model: f32, 4 layers, 4 heads of 128 (hidden 512) over 2 KV
    heads, ffn 1024, vocab 4096."""
    import dataclasses
    return dataclasses.replace(
        llama.tiny_llama(vocab=4096, hidden=512, layers=4, heads=4,
                         kv_heads=2, seq=256, ffn=1024),
        head_dim=128, dtype=torch.float32)


def layerwise_nu_numpy(tree):
    """Zero layer-wise second moments for a numpy parameter tree (the
    stacked matrices factored with the stack dim kept, the [L, h] norms
    full; the tail per leaf)."""
    def nu(a, stacked):
        if a.ndim - stacked >= 2:
            return {"vr": np.zeros(a.shape[:-1], np.float32),
                    "vc": np.zeros(a.shape[:-2] + a.shape[-1:], np.float32)}
        return {"v": np.zeros(a.shape, np.float32)}
    return {k: ({kk: nu(vv, 1) for kk, vv in v.items()} if k == "layers"
                else nu(v, 0)) for k, v in tree.items()}


def trees_rel_err(got, want):
    """The largest error of a leaf of ``got`` over the largest magnitude of
    the matching leaf of ``want`` (both on the CPU)."""
    return max((a.float().cpu() - b.float().cpu()).abs().max().item()
               / max(b.float().abs().max().item(), 1e-30)
               for a, b in zip(leaves_of(got), leaves_of(want)))


def cross_device_offload(llama, offload, dev, steps=3, B=2, S=256):
    """(t4) From one numpy-made state of ``small_llama``: ``steps`` steps
    of the layer-wise and the streaming step on the card and of the
    streaming step on the CPU (t1's recipe): losses within 2e-5 relative,
    parameters and second moments within 1e-4 of each leaf's largest
    magnitude (card streaming against card layer-wise and against the
    CPU). Then 2 steps of ``make_offload_train_step`` (adamw with the
    moments in pinned memory, and adafactor) against ``llama.train_step``
    on the card from the same state, by the same rule; the adamw moments
    lie in pinned memory between steps."""
    cfg = small_llama(llama)
    tree = numpy_params(cfg, SEED + 3)
    nu = layerwise_nu_numpy(tree)
    toks = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (B, S + 1))
    kw = dict(lr=T_LR, adafactor_eps2=0.0)
    cpu = torch.device("cpu")
    runs = {}
    for name, where, streaming in (("card_layerwise", dev, False),
                                   ("card_streaming", dev, True),
                                   ("cpu_streaming", cpu, True)):
        st = offload.layerwise_state_from_numpy(tree, nu, device=where)
        if streaming:
            st = offload.streaming_state_from_layerwise(st)
            step = offload.make_streaming_train_step(cfg, device=where, **kw)
        else:
            step = offload.make_layerwise_train_step(cfg, **kw)
        t = torch.as_tensor(toks, device=where)
        losses = []
        for _ in range(steps):
            st, loss = step(st, t)
            losses.append(loss.item())
        if streaming:
            st = offload.layerwise_state_from_streaming(st)
        runs[name] = {"losses": losses, "params": st.params, "nu": st.nu}
    ref = runs["card_layerwise"]
    out = {}
    for name, want in (("card_streaming_vs_card_layerwise", ref),
                       ("card_streaming_vs_cpu_streaming",
                        runs["cpu_streaming"])):
        got = runs["card_streaming"]
        out[name] = {
            "loss": max(abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], want["losses"])),
            "params": trees_rel_err(got["params"], want["params"]),
            "nu": trees_rel_err(got["nu"], want["nu"])}
    out["losses"] = {k: v["losses"] for k, v in runs.items()}
    del runs, ref
    t = torch.as_tensor(toks, device=dev)
    for opt in ("adamw", "adafactor"):
        params = llama.params_from_numpy(tree, device=dev)
        from paddle_tpu_torch.optimizer.functional import init_moments
        mu, nu_ = init_moments(params, opt)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        ref_st = llama.TrainState(params, mu, nu_, zero)
        host = opt == "adamw"
        st = llama.TrainState(
            llama.params_from_numpy(tree, device=dev),
            offload.host_put(mu, dev) if host else mu,
            offload.host_put(nu_, dev) if host else nu_, zero)
        step = offload.make_offload_train_step(
            llama, cfg, optimizer=opt, lr=T_LR, offload_moments=host,
            adafactor_eps2=0.0)
        errs = []
        for _ in range(2):
            st, loss = step(st, t)
            ref_st, rloss = llama.train_step(ref_st, t, cfg, optimizer=opt,
                                             lr=T_LR, adafactor_eps2=0.0)
            errs.append(abs(loss.item() - rloss.item()) / abs(rloss.item()))
            if host and not all(x.device.type == "cpu" and x.is_pinned()
                                for x in leaves_of([st.mu, st.nu])):
                raise AssertionError("t4: offloaded moments not pinned")
        torch.cuda.synchronize()
        out[f"offload_{opt}_vs_train_step"] = {
            "loss": max(errs),
            "params": trees_rel_err(st.params, ref_st.params),
            "nu": trees_rel_err(st.nu, ref_st.nu)}
    log(f"  card vs card and card vs CPU: {out}")
    for k, v in out.items():
        if k != "losses" and (v["loss"] > 2e-5 or v["params"] > 1e-4
                              or v["nu"] > 1e-4):
            raise AssertionError(f"t4: {k} differs: {v}")
    return out


def meminfo_bytes(key="MemAvailable"):
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"/proc/meminfo has no {key}")


def moe_layer_bytes(cfg, dense):
    """Pinned bytes of one streamed MoE layer: bf16 parameters and their
    f32 second moments (factored for matrices)."""
    h, E, fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    d, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    fs = cfg.n_shared_experts * fm
    mats = [(h, nq * d), (h, nkv * d), (h, nkv * d), (nq * d, h),
            (h, fs), (h, fs), (fs, h)]
    if not dense:
        mats += [(h, E)] + [(E, h, fm)] * 2 + [(E, fm, h)]
    p = 2 * (2 * h + sum(math.prod(m) for m in mats))
    nu = 4 * (2 * h + sum(math.prod(m[:-1]) + math.prod(m[:-2] + m[-1:])
                          for m in mats))
    return p + nu


def train_moe_streaming(moe, offload, build, tmf, dev, card, B=4, S=2048,
                        warmup=1, steps=2, host_reserve=16e9):
    """(t5) ``make_streaming_moe_train_step`` on DeepSeekMoE-16B
    (``deepseek_moe_16b``) at full depth, 28 layers with layer 0 dense,
    batch 4 x 2048, random bf16 weights, t1's recipe; the depth is cut
    (and the cut printed) only if the host's MemAvailable cannot pin 28
    layers and keep ``host_reserve`` bytes. Each step launches, per
    layer, B1 twice (the forward and the vjp's re-run), B2 and B3 once,
    and per MoE layer B9 twice, gmm four times (the down projection in
    both forwards, its dgrad, gate|up's dgrad) and tgmm twice; the losses
    are finite. One more step traced."""
    import dataclasses
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), max_seq_len=S)
    dense_b = moe_layer_bytes(cfg, True)
    moe_b = moe_layer_bytes(cfg, False)
    nd = cfg.first_dense_layers
    need = nd * dense_b + (cfg.num_layers - nd) * moe_b
    avail = meminfo_bytes()
    full = layers = cfg.num_layers
    if need > avail - host_reserve:
        layers = nd + int((avail - host_reserve - nd * dense_b) // moe_b)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    log(f"  MemAvailable {gb(avail)} GB; {gb(need)} GB pinned for {full} "
        f"layers (+ {gb(host_reserve)} GB kept free): running {layers} "
        f"layers" + ("" if layers == full else
                     " (depth cut by host memory)"))
    t0 = time.perf_counter()
    state = offload.init_streaming_moe_train_state(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lay_bytes = tree_bytes(state.layers)
    nu_bytes = tree_bytes(state.nu_layers)
    pinned = offload.pinned_bytes([state.layers, state.nu_layers])
    log(f"  streaming MoE state in {init_s:.1f} s: layers {gb(lay_bytes)} "
        f"GB bf16 + second moments {gb(nu_bytes)} GB in {gb(pinned)} GB "
        f"pinned (MemAvailable now {gb(meminfo_bytes())} GB)")
    tokens = tokens_for(cfg, B, S, dev)
    step_fn = offload.make_streaming_moe_train_step(cfg, lr=T_LR,
                                                    adafactor_eps2=0.0,
                                                    device=dev)
    tmf.fused_paths.clear()
    holder = [state]
    del state
    state, res = run_steps(build, lambda st: step_fn(st, tokens), holder,
                           warmup, steps)
    n_moe = layers - nd
    want = {"flash_fwd": 2 * layers, "flash_dq": layers,
            "flash_dkv": layers, "gather_gmm": 2 * n_moe, "gmm": 4 * n_moe,
            "tgmm": 2 * n_moe}
    check_steps("t5", res, want, falling=False)
    fused = dict(tmf.fused_paths)
    if fused != {"padded": 2 * n_moe * (warmup + steps)}:
        raise AssertionError(f"t5: fused dispatch paths {fused}")
    res.update(rates(res, B, S, steps, moe.flops_per_token(cfg, S)),
               layers=layers, batch=B, seq=S, warmup=warmup,
               timed_steps=steps, init_s=init_s, layer_bytes=lay_bytes,
               nu_bytes=nu_bytes, pinned_bytes=pinned,
               mem_available_before=avail,
               pcie_bytes_per_step=3 * lay_bytes + 2 * nu_bytes,
               active_params_per_token=moe.active_params_per_token(cfg),
               fused_paths=fused, card=card)
    log_train(f"t5 streaming MoE step, {layers} layers", res)
    log(f"  the step moves {gb(res['pcie_bytes_per_step'])} GB over PCIe")
    res["traced_step"] = traced(lambda: step_fn(state, tokens),
                                classify=memcpy_category)
    log(f"  traced streaming MoE step: {res['traced_step']}")
    del state, tokens
    free_memory()
    return res


def training_memory(llama, moe, offload, build, tfa, tmf, dev, card):
    """Phase 15, (t1)-(t5), then B1-B3 timed at the 8B step's attention
    shape; each sub-phase's state is freed before the next. Returns the
    results and the launches of each path."""
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {}
    log("phase 15 (t1): llama.train_step on Llama-3-8B")
    out["t1_plain"] = train_8b_plain(llama, build, dev, card, total)
    free_memory()
    b1 = out["t1_plain"]["batch"]
    log("phase 15 (t2): the layer-wise step on Llama-3-8B")
    out["t2_layerwise"] = train_8b_layerwise(
        llama, offload, build, dev, card, sorted({8, b1}, reverse=True))
    B = 8
    log("phase 15 (t3): the host-streamed step on Llama-3-8B")
    out["t3_streaming"] = train_8b_streaming(
        llama, offload, build, dev, card, B,
        out["t2_layerwise"][B]["step_ms"])
    log("phase 15 (t4): streaming vs layer-wise on the card, card vs CPU, "
        "offload vs train_step")
    out["t4_cross_device"] = cross_device_offload(llama, offload, dev)
    free_memory()
    log("phase 15 (t5): the streaming MoE step on DeepSeekMoE-16B")
    out["t5_moe_streaming"] = train_moe_streaming(moe, offload, build, tmf,
                                                  dev, card)
    log(f"phase 15: B1-B3 at the 8B step's attention shape (B={B})")
    shape = {"flash_fwd": time_flash(tfa, dev, B, 2048, 32, 8)}
    log(f"  B1 {shape['flash_fwd']['shape']}: {shape['flash_fwd']}")
    torch.cuda.empty_cache()
    shape.update(time_flash_bwd(tfa, dev, B, 2048, 32, 8))
    for name in ("flash_dq", "flash_dkv"):
        log(f"  {name} at the 8B shape: {shape[name]}")
    torch.cuda.empty_cache()
    out["b1_b3_8b_shape"] = shape
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch.kernels import _build as build
        from paddle_tpu_torch.kernels import mega_decode as tmd
        from paddle_tpu_torch.kernels import moe_dispatch as tmdisp
        from paddle_tpu_torch.kernels import moe_fused as tmf
        from paddle_tpu_torch.kernels import paged_attention as tpa
        from paddle_tpu_torch.kernels import pallas_attention as tfa
        from paddle_tpu_torch.models import llama, moe
        from paddle_tpu_torch.optimizer import offload
        from paddle_tpu_torch.serving import LLMEngine
        from paddle_tpu_torch.serving import engine as teng
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a repository checkout "
              f"({exc})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    log("phase 1: device")
    card = nvidia_smi()
    log(f"  {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    log(f"  kernels built in {build.build_seconds:.1f} s")

    log("phase 2: B1 flash prefill vs plain")
    check_flash(tfa, dev)

    log("phase 3: B4 ragged paged decode vs plain")
    check_ragged(tpa, dev)

    log("phase 3 (int8 a): B4-int8, int8 pools, vs plain")
    int8_res = {"b4_checks": check_ragged_int8(tpa, dev)}
    torch.cuda.empty_cache()

    log("phase (s4): B6, B7, B8 (the paged-cache API) vs plain, and its "
        "path")
    paged_launches, paged = check_paged_api(tpa, build, dev)
    torch.cuda.empty_cache()

    log("phase 4: LLMEngine serves Llama-3-8B (ragged decode)")
    cfg8, params8 = llama3_8b_bf16(llama, dev)
    launches, serving, bf16_streams, num_blocks = serve(
        LLMEngine, build, dev, card, cfg8, params8, serving_mix(cfg8, 16),
        max_slots=8, decode_kernel="ragged")
    free_memory()
    # the kernels timed at the run's own shapes: its largest prefill wave,
    # and its first wave's decode lengths halfway through their tokens
    B, S = max(serving["prefill_waves"], key=lambda w: w[0] * w[1] ** 2)
    b1 = time_flash_shapes(tfa, dev, B=B, S=S)
    torch.cuda.empty_cache()
    lens = [n + 32 for n in serving["prompt_lens"][:8]]
    b4 = time_ragged(tpa, dev, lens, num_blocks)
    log(f"  B4 timing: {b4}")
    b4["long_shapes"] = time_ragged_long(tpa, dev)
    log(f"  B4 at {list(RAGGED_LONG)}: {b4['long_shapes']}")
    torch.cuda.empty_cache()

    log("phase 5: card vs CPU greedy streams")
    ragged_streams = cross_device_streams(llama, LLMEngine, dev, "ragged")

    log("phase 6: the mega decode path (phase 4's weights)")
    mix8 = serving_mix(cfg8, 8)
    b5 = check_mega(tmd, cfg8, params8, dev,
                    [len(p) + 24 for p in mix8[:4]])
    free_memory()
    mega_streams = cross_device_streams(llama, LLMEngine, dev, "mega")
    if mega_streams != ragged_streams:
        raise AssertionError(f"mega streams {mega_streams} differ from the "
                             f"ragged ones {ragged_streams}")
    mega_launches, mega, m_streams, _ = serve(
        LLMEngine, build, dev, card, cfg8, params8, mix8, max_slots=4,
        decode_kernel="mega")
    _, ragged4, r_streams, _ = serve(
        LLMEngine, build, dev, card, cfg8, params8, mix8, max_slots=4,
        decode_kernel="ragged")
    mega["ragged_same_mix"] = ragged4
    mega["first_stream_divergence"] = first_divergence(m_streams, r_streams)
    mega["B5"] = b5
    log(f"  mega vs ragged at 4 slots: {mega['output_tok_per_s']:.1f} vs "
        f"{ragged4['output_tok_per_s']:.1f} output tok/s, median step "
        f"{mega['median_decode_step_ms']:.2f} vs "
        f"{ragged4['median_decode_step_ms']:.2f} ms; first stream "
        f"divergence (request, token): {mega['first_stream_divergence']}")
    free_memory()

    log("phase (s1): B5's multi-step form vs plain, one k=4 draft wave at "
        "4 slots")
    walk4 = [len(p) + 24 for p in mix8[:4]]
    dcfg, dparams = llama32_1b_draft(llama, cfg8, dev)
    spec = {"b5_multi": check_loops(tmd, llama, cfg8, params8, dcfg,
                                    dparams, dev, walk4)}
    b5_multi = spec["b5_multi"]["draft_1b_bf16"]
    free_memory()

    log("phase (s2): card vs CPU speculative streams (phase 5's cut model)")
    spec["cross_device_streams"] = spec_cross_device(
        llama, LLMEngine, build, dev, ragged_streams)
    spec["cross_device_streams_kv_int8"] = spec_cross_device(
        llama, LLMEngine, build, dev, None, kv_int8=True)
    free_memory()

    log("phase (s3): speculative serving, Llama-3-8B with a "
        "Llama-3.2-1B-shaped draft (mega at 4 slots, the self-draft, "
        "ragged at 8 slots)")
    spec_mega, _ = serve_spec(
        LLMEngine, teng, build, dev, card, cfg8, params8, dcfg, dparams,
        mix8, 4, "mega", "spec mega 4 slots, 1B draft", want=m_streams)
    free_memory()
    spec["serving_mega_1b_draft"] = spec_mega
    spec["serving_mega_self_draft"], _ = serve_spec(
        LLMEngine, teng, build, dev, card, cfg8, params8, cfg8, params8,
        mix8, 4, "mega", "spec mega 4 slots, self-draft", want=m_streams)
    free_memory()
    spec["serving_ragged_1b_draft"], _ = serve_spec(
        LLMEngine, teng, build, dev, card, cfg8, params8, dcfg, dparams,
        mix8, 8, "ragged", "spec ragged 8 slots, 1B draft", want=m_streams)
    spec["plain_mega_4_slots"] = {
        k: mega[k] for k in ("output_tok_per_s", "median_decode_step_ms")}
    del dparams
    free_memory()

    log("phase 6 (int8 b): B5-int8 vs plain, Llama-3-8B, 4 slots")
    walk4 = [len(p) + 24 for p in mix8[:4]]
    b5_forms = {"kv_int8": check_mega(tmd, cfg8, params8, dev, walk4,
                                      kv_int8=True)}
    free_memory()
    q8 = llama.quantize_params(params8)
    free_memory()
    b5_forms["w_int8"] = check_mega(tmd, cfg8, q8, dev, walk4)
    free_memory()
    b5_int8 = check_mega(tmd, cfg8, q8, dev, walk4, kv_int8=True)
    b5_forms["w_int8_kv_int8"] = b5_int8
    int8_res["b5_forms"] = {k: {kk: v[kk] for kk in ("rel_err", "ms",
                                                     "plain_ms", "bound_ms",
                                                     "f32_ms", "bytes")}
                            for k, v in b5_forms.items()}
    free_memory()

    log("phase 6 (int8 c): the int8 serving path, Llama-3-8B, int8 weights "
        "and int8 pools")
    i8_launches, i8_serving, i8_streams, _ = serve(
        LLMEngine, build, dev, card, cfg8, q8, serving_mix(cfg8, 16),
        max_slots=8, decode_kernel="ragged", kv_dtype="int8")
    free_memory()
    i8_mega_launches, i8_mega, i8_mega_streams, _ = serve(
        LLMEngine, build, dev, card, cfg8, q8, mix8, max_slots=4,
        decode_kernel="mega", kv_dtype="int8")
    free_memory()
    i8_serving["first_divergence_int8_vs_bf16"] = first_divergence(
        i8_streams, bf16_streams)
    i8_mega["first_divergence_mega_vs_ragged"] = first_divergence(
        i8_mega_streams, i8_streams[:8])
    i8_mega["first_divergence_int8_vs_bf16_mega"] = first_divergence(
        i8_mega_streams, m_streams)
    int8_res["prefill_logits"] = prefill_logits_error(
        teng, cfg8, params8, q8, mix8[:4], dev)
    int8_res["serving_ragged"] = i8_serving
    int8_res["serving_mega"] = i8_mega
    log(f"  int8 serving: ragged 8 slots {i8_serving['output_tok_per_s']:.1f}"
        f" tok/s (median step {i8_serving['median_decode_step_ms']:.2f} ms,"
        f" peak {i8_serving['peak_mem_gib']:.2f} GiB; bf16 "
        f"{serving['output_tok_per_s']:.1f}), mega 4 slots "
        f"{i8_mega['output_tok_per_s']:.1f} tok/s (median step "
        f"{i8_mega['median_decode_step_ms']:.2f} ms, peak "
        f"{i8_mega['peak_mem_gib']:.2f} GiB; bf16 "
        f"{mega['output_tok_per_s']:.1f}); first divergence int8 vs bf16 "
        f"{i8_serving['first_divergence_int8_vs_bf16']}, mega vs ragged "
        f"{i8_mega['first_divergence_mega_vs_ragged']}; prefill logits "
        f"{int8_res['prefill_logits']}")
    b4_int8 = time_ragged_int8(tpa, dev, lens, num_blocks)
    log(f"  B4-int8 timing: {b4_int8}")
    del params8, q8
    free_memory()

    log("phase 6 (int8 d): card vs CPU int8 streams (int8 weights and "
        "pools)")
    i8_ragged = cross_device_streams(llama, LLMEngine, dev, "ragged",
                                     int8=True)
    i8_mega_s = cross_device_streams(llama, LLMEngine, dev, "mega", int8=True)
    if i8_mega_s != i8_ragged:
        raise AssertionError(f"int8 mega streams {i8_mega_s} differ from the "
                             f"ragged ones {i8_ragged}")
    int8_res["cross_device_streams"] = i8_ragged
    free_memory()

    log("phase 7: B2/B3 flash backward vs plain")
    check_flash_bwd(tfa, dev)
    torch.cuda.empty_cache()

    log("phase 8: train_step trains llama-2.6b")
    train_launches, training = train_llama_2_6b(llama, build, dev, card)
    torch.cuda.empty_cache()

    log("phase 9: B2/B3 timed at the train steps' shapes")
    bwd = time_flash_bwd_shapes(tfa, dev)
    log(f"  B2/B3 timing: {json.dumps(bwd)}")
    torch.cuda.empty_cache()

    log("phase 10: card vs CPU train step")
    training["card_vs_cpu"] = cross_device_train_step(llama, dev)
    free_memory()

    log("phase 11: B9 gather_gmm, B10 gmm and tgmm vs plain")
    grouped_errs = check_grouped(tmdisp, tmf, dev)
    free_memory()

    log("phase 12: moe.train_step trains DeepSeekMoE-16B widths")
    moe_launches, moe_training = train_moe(moe, build, tmf, dev, card)
    free_memory()

    log("phase 13: B9/gmm/tgmm and the dispatch forms at the step's shapes")
    grouped, routing = time_grouped(tmdisp, tmf, dev)
    moe_training["dispatch_forms"] = time_forms(tmdisp, routing, dev)
    moe_training["kernel_checks"] = grouped_errs
    del routing
    free_memory()

    log("phase 14: card vs CPU MoE train step")
    moe_training["card_vs_cpu"] = cross_device_moe_step(moe, llama, dev)
    free_memory()

    log("phase 14 (int8 e): B9-int8 vs plain; at the MoE step's shape")
    b9_int8 = check_gather_gmm_int8(tmdisp, tmf, dev)
    free_memory()

    log("phase 14 (int8 f): moe.forward with int8 experts, DeepSeekMoE-16B "
        "at full depth")
    moe8_launches, int8_res["moe_forward"] = moe_int8_forward(
        moe, build, tmf, dev, card)
    free_memory()

    tm_res = training_memory(llama, moe, offload, build, tfa, tmf, dev, card)
    free_memory()
    # each kernel's launches on the training-memory paths (per run) and,
    # for B1-B3, their times at the 8B step's attention shape
    t_launch = {
        k: {"plain_8b": tm_res["t1_plain"]["launches"].get(k, 0),
            "layerwise_8b": tm_res["t2_layerwise"][8]["launches"].get(k, 0),
            "streaming_8b": tm_res["t3_streaming"]["launches"].get(k, 0),
            "streaming_moe_16b":
                tm_res["t5_moe_streaming"]["launches"].get(k, 0)}
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "gather_gmm", "gmm",
                  "tgmm")}
    shape8 = tm_res.pop("b1_b3_8b_shape")

    # B5's static schedules: printed apart from the kernels line, whose
    # numbers (bound_ms aside) are measured in this run
    schedules = {"mega_decode": b5.pop("schedule"),
                 "mega_decode_int8": b5_int8.pop("schedule"),
                 "mega_decode_loop": b5_multi["schedule"]}
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
             replaces="paddle_tpu/kernels/pallas_attention.py:107",
             launches=launches.get("flash_fwd", 0),
             train_launches=train_launches.get("flash_fwd", 0),
             train8b_launches=t_launch["flash_fwd"],
             train8b_shape=shape8["flash_fwd"], **b1),
        dict(name="ragged_decode", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/ragged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:578",
             launches=launches.get("ragged_decode", 0), **b4),
        dict(name="flash_dq", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_dq.cu",
             replaces="paddle_tpu/kernels/pallas_attention.py:232",
             launches=train_launches.get("flash_dq", 0),
             train8b_launches=t_launch["flash_dq"],
             train8b_shape=shape8["flash_dq"], **bwd["flash_dq"]),
        dict(name="flash_dkv", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_dkv.cu",
             replaces="paddle_tpu/kernels/pallas_attention.py:253",
             launches=train_launches.get("flash_dkv", 0),
             train8b_launches=t_launch["flash_dkv"],
             train8b_shape=shape8["flash_dkv"], **bwd["flash_dkv"]),
        dict(name="mega_decode", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/mega_decode.cuh",
             replaces="paddle_tpu/kernels/mega_decode.py:645",
             launches=mega_launches.get("mega_decode", 0), **b5),
        dict(name="gather_gmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/gather_gmm.cu",
             replaces="paddle_tpu/kernels/moe_fused.py:266",
             launches=moe_launches.get("gather_gmm", 0),
             train8b_launches=t_launch["gather_gmm"],
             **grouped["gather_gmm"]),
        dict(name="gmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/gmm.cu",
             replaces="paddle_tpu/kernels/moe_dispatch.py:434",
             launches=moe_launches.get("gmm", 0),
             train8b_launches=t_launch["gmm"], **grouped["gmm"]),
        dict(name="tgmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/tgmm.cu",
             replaces="paddle_tpu/kernels/moe_dispatch.py:445",
             launches=moe_launches.get("tgmm", 0),
             train8b_launches=t_launch["tgmm"], **grouped["tgmm"]),
        dict(name="ragged_decode_int8", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/ragged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:578",
             launches=i8_launches.get("ragged_decode_int8", 0), **b4_int8),
        dict(name="mega_decode_int8", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/mega_decode.cuh",
             replaces="paddle_tpu/kernels/mega_decode.py:645",
             launches=i8_mega_launches.get("mega_decode_int8", 0), **b5_int8),
        dict(name="gather_gmm_int8", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/gather_gmm.cu",
             replaces="paddle_tpu/kernels/moe_fused.py:266",
             launches=moe8_launches.get("gather_gmm_int8", 0), **b9_int8),
        dict(name="mega_decode_loop", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/mega_decode.cuh",
             replaces="paddle_tpu/kernels/mega_decode.py:645",
             launches=spec_mega["launches"].get("mega_decode_loop", 0),
             **{k: b5_multi[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "share_of_bound", "shape")}),
        dict(name="paged_decode_attention", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/paged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:343",
             launches=paged_launches.get("paged_decode_attention", 0),
             **paged["b6"]),
        dict(name="paged_append_token", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/paged_cache.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:167",
             launches=paged_launches.get("paged_append_token", 0),
             **paged["b7"]),
        dict(name="paged_append_blocks", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/paged_cache.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:218",
             launches=paged_launches.get("paged_append_blocks", 0),
             **paged["b8"]),
    ]
    log(f"serving: {json.dumps(serving)}")
    log(f"mega: {json.dumps(mega)}")
    log(f"training: {json.dumps(training)}")
    log(f"moe_training: {json.dumps(moe_training)}")
    log(f"int8: {json.dumps(int8_res)}")
    log(f"training_memory: {json.dumps(tm_res)}")
    spec["paged_api_checks"] = paged["checks"]
    log(f"spec: {json.dumps(spec)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"static_schedule": schedules}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
