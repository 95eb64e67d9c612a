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
   not; bf16 and f32; D=64 once);
3. B4, the ragged paged-decode kernel, against its plain version on
   [L=4, NB=512, BS=64, Hkv=8, D=128] pools with lengths 0, 1, 64, 2000
   and more;
4. the serving path: ``LLMEngine(decode_kernel="ragged")`` serving 16
   greedy requests (prompts of 64-1000 tokens, 64 new tokens each) on
   Llama-3-8B with random bf16 weights, with the kernels' launch counts
   read around the run; then one more decode call traced with
   torch.profiler (the device's busy share of its wall time), and each
   kernel timed at the run's own shapes beside its plain version (and,
   for B1, beside SDPA);
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
7. B2/B3, the flash-backward kernels (dQ; dK/dV), against their plain
   versions at llama-2.6b head shapes (Hq=24, Hkv=8, D=128; B=2; S in
   128/1000/2048; causal and not; bf16 and f32; D=64 once), and their f32
   gradients against torch.autograd through dense attention;
8. the training path: ``train_step`` on llama-2.6b at full width and
   depth (batch 8, seq 2048, full remat, adafactor, bf16 params, random
   weights), 2 warm-up and 5 timed steps on one fixed batch — finite,
   falling losses and, per step, 2x24 B1 and 24 B2/B3 launches; tokens/s,
   step time, MFU, peak memory; one more step traced with torch.profiler;
9. B2 and B3 timed at the step's shapes beside their plain versions,
   their bounds and SDPA's backward;
10. card vs CPU train step: llama-2.6b widths cut to 2 layers, f32,
    AdamW, B=1, S=256, the same numpy-made weights — loss, grad norm,
    grads and updated params must agree;
11. B9 (gather_gmm) and B10 (gmm, with and without transpose_rhs; tgmm)
    against their plain versions, bf16 and f32, at small shapes with empty
    groups, a skewed group, tiles spanning groups and tail rows; the
    Hopper kernels' edge shapes (a ragged reduction that wraps the stage
    ring, more tiles than 2 x 132 persistent blocks, 1408 and 136 columns;
    B9 with bf16 and int8 weights), each call equal to itself bit for bit
    over two calls; then bf16 at the MoE train step's shapes;
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
     (B7, B8) ``index_put_``;
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

Before its last line it prints ``serving``, ``mega``, ``training``,
``moe_training``, ``int8`` and ``spec`` lines (phases 4, 6, 8, 12-14,
(a)-(f) and (s1)-(s4)),
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


def kernel_device_ms(fn, iters, key):
    """Mean device time in ms of the kernels whose name holds ``key`` over
    ``iters`` calls of ``fn()`` (torch.profiler, after one warm-up call):
    the kernel alone, where CUDA events around back-to-back calls of a
    short kernel time its wrapper's host work. None when the trace holds
    no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and key in e.name]
    return sum(spans) / 1e3 / iters if spans else None


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def free_memory():
    """Collect what is unreachable (a timed engine holds itself in a
    cycle through its wrapped methods) and give the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: B1, flash prefill
# ---------------------------------------------------------------------------
def check_flash(tfa, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(S, causal, dtype, 128) for S in (128, 1000, 1024)
             for causal in (True, False)
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append((1000, True, torch.bfloat16, 64))
    for S, causal, dtype, D in cases:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((2, S, 32, D), (2, S, 8, D), (2, S, 8, D)))
        out, lse = tfa.flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        eo, el = max_err(out, ref), max_err(lse, ref_lse)
        log(f"  B1 S={S} causal={causal} {str(dtype)[6:]} D={D}: "
            f"max|dO|={eo:.3g} max|dLSE|={el:.3g} (tol {tol})")
        if not (eo <= tol and el <= tol):
            raise AssertionError(f"B1 disagrees with its plain version at "
                                 f"S={S} causal={causal} {dtype} D={D}")


def time_flash(tfa, dev, B, S):
    """B1 at the serving run's largest prefill wave: [B, S, 32, 128] bf16,
    causal. Returns the kernels-line entry fields."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    Hq, Hkv, D = 32, 8, 128
    q, k, v = (torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
               for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    out, _ = tfa.flash_attention_fwd(q, k, v, True)
    ref, _ = tfa.flash_attention_fwd_plain(q, k, v, True)
    err = max_err(out, ref)
    if err > 2e-2:
        raise AssertionError(f"B1 disagrees at the serving shape: {err}")
    del ref
    ms = time_ms(lambda i=0: tfa.flash_attention_fwd(q, k, v, True), 10)
    plain_ms = time_ms(
        lambda i=0: tfa.flash_attention_fwd_plain(q, k, v, True), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(
        lambda i=0: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    flops = 2.0 * B * Hq * S * S * D                     # causal QK + PV
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + 4 * B * Hq * S
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "shape": f"B={B} S={S} Hq=32 Hkv=8 "
            "D=128 bf16 causal"}


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


def time_ragged(tpa, dev, lengths, num_blocks, Lc=32):
    """B4 at the serving run's decode shape: q [8, 32, 128] bf16 over a
    [32, num_blocks, 64, 8, 128] pool, one launch per layer in turn (each
    layer's blocks are cold in L2, as on the main path)."""
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
    ms = time_ms(lambda i=0: tpa.ragged_decode_partial(
        q, kp, vp, table, lens, layer=i % Lc), 4 * Lc)
    plain_ms = time_ms(lambda i=0: tpa.ragged_decode_partial_plain(
        q, kp, vp, table, lens, i % Lc), Lc)
    tokens = int(sum(lengths))
    nbytes = 2 * tokens * Hkv * D * 2 + q.numel() * 2 \
        + N * Hkv * G * (D + 2) * 4 + table.numel() * 4 + N * 4
    flops = 4.0 * tokens * Hkv * G * D
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None,
            "shape": f"N={N} sum(len)={tokens} Hq=32 Hkv=8 D=128 bf16"}


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


def traced(fn, classify=None):
    """Run ``fn()`` once under torch.profiler (device activity only), up to
    a device synchronize, and return the device's busy share of the wall
    time, the kernel launches and the kernels that took the most device
    time (None when the trace holds no device activity); with
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
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy, s0, e0 = busy + e0 - s0, s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    by_name = {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    res = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "kernel_launches": len(kern),
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
           "blocks_per_sm": tmd.blocks_per_sm(cfg.dtype, D, N, w_int8),
           "shape": f"L={L} h={cfg.hidden_size} F={cfg.intermediate_size} "
                    f"Hq={Hq} Hkv={Hkv} D={D} bf16, {form}, N={N}, "
                    f"walk={walk}, t={t}"}
    log(f"  B5 timing: {res}")
    del kw
    return res


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
    B8) ``index_put_``. Returns (the path's launches, the kernels-line
    fields of B6, B7, B8)."""
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
    cache = tpa.PagedKVCache(kp, vp, table, lens)
    out = tpa.paged_decode_attention(q, cache, layer=1)
    ref = tpa.paged_decode_attention_plain(q, cache, layer=1)
    tokens = int(lens.sum())

    def fields(ms, plain_ms, nbytes, flops, library_ms, err, shape):
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "library_ms": library_ms, "shape": shape}
    b6 = fields(
        time_ms(lambda i=0: tpa.paged_decode_attention(q, cache,
                                                       layer=i % L), 4 * L),
        time_ms(lambda i=0: tpa.paged_decode_attention_plain(q, cache,
                                                             i % L), L),
        2 * tokens * Hkv * D * 2 + 2 * q.numel() * 2 + table.numel() * 4
        + N * 4, 4.0 * tokens * Hkv * G * D, None, max_err(out, ref),
        f"N={N} sum(len)={tokens} Hq=32 Hkv=8 D=128 bf16")
    k_new, v_new = (torch.randn(N, Hkv, D, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    blk = table.gather(1, (lens.long() // BS)[:, None])[:, 0]
    off = (lens % BS).int()

    def index_put_token(i=0):
        kp[1, blk.long(), off.long()] = k_new
        vp[1, blk.long(), off.long()] = v_new
    b7 = fields(
        time_ms(lambda i=0: tpa.paged_append_token(kp, vp, k_new, v_new,
                                                   blk, off, layer=1), 50),
        time_ms(lambda i=0: tpa.paged_append_token_plain(
            kp, vp, k_new, v_new, blk, off, 1), 50),
        2 * 2 * N * Hkv * D * 2 + 2 * N * 4, 0.0,
        time_ms(index_put_token, 50), 0.0,
        f"N={N} rows of [Hkv=8, D=128] bf16 into [L=4, NB=512, BS=64] "
        "pools")
    kb, vb = (torch.randn(MB, BS, Hkv, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    ids = table[3]

    def index_put_blocks(i=0):
        kp[2, ids.long()] = kb
        vp[2, ids.long()] = vb
    b8 = fields(
        time_ms(lambda i=0: tpa.paged_append_blocks(kp, vp, kb, vb, ids,
                                                    layer=2), 20),
        time_ms(lambda i=0: tpa.paged_append_blocks_plain(kp, vp, kb, vb,
                                                          ids, 2), 20),
        2 * 2 * kb.numel() * 2 + MB * 4, 0.0, time_ms(index_put_blocks, 20),
        0.0, f"{MB} blocks of [BS=64, Hkv=8, D=128] bf16 (one 2048-token "
        "prefill) into [L=4, NB=512, BS=64] pools")
    # the kernels' own device time: B7/B8 last a few microseconds, less
    # than their wrappers' host work between back-to-back calls
    b6["device_ms"] = kernel_device_ms(
        lambda i=0: tpa.paged_decode_attention(q, cache, layer=i % L),
        4 * L, "paged_decode_kernel")
    b7["device_ms"] = kernel_device_ms(
        lambda i=0: tpa.paged_append_token(kp, vp, k_new, v_new, blk, off,
                                           layer=1), 50,
        "append_token_kernel")
    b8["device_ms"] = kernel_device_ms(
        lambda i=0: tpa.paged_append_blocks(kp, vp, kb, vb, ids, layer=2),
        20, "append_blocks_kernel")
    log(f"  B6 timing: {b6}")
    log(f"  B7 timing: {b7}")
    log(f"  B8 timing: {b8}")
    del kp, vp
    torch.cuda.empty_cache()
    return path_launches, {"b6": b6, "b7": b7, "b8": b8, "checks": errs}


# ---------------------------------------------------------------------------
# phase 7: B2/B3, the flash backward
# ---------------------------------------------------------------------------
def rel_err(a, b):
    """max |a - b| over max |b|."""
    return max_err(a, b) / b.float().abs().max().item()


def check_flash_bwd(tfa, dev):
    """B2 (dQ) and B3 (dK/dV) against their plain versions at llama-2.6b
    head shapes (Hq=24, Hkv=8, D=128; B=2; S in 128/1000/2048; causal and
    not; bf16 and f32; D=64 once), each gradient within 2e-2 (bf16) or
    1e-4 (f32) of its largest magnitude; then the kernels' f32 gradients
    against torch.autograd through a dense f32 attention at S=256."""
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = [(S, causal, dtype, 128) for S in (128, 1000, 2048)
             for causal in (True, False)
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append((1000, True, torch.bfloat16, 64))
    for S, causal, dtype, D in cases:
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((2, S, 24, D), (2, S, 8, D),
                                     (2, S, 8, D), (2, S, 24, D)))
        out, lse = tfa.flash_attention_fwd(q, k, v, causal)
        got = tfa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        log(f"  B2/B3 S={S} causal={causal} {str(dtype)[6:]} D={D}: "
            f"rel err dq/dk/dv {[f'{e:.3g}' for e in errs]} (tol {tol})")
        if max(errs) > tol:
            raise AssertionError(f"B2/B3 disagree with their plain versions "
                                 f"at S={S} causal={causal} {dtype} D={D}")
        del q, k, v, do, out, lse, got, want
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
    res["traced_step"] = traced(lambda: step(state))
    log(f"  traced train step: {res['traced_step']}")
    return launches, res


# ---------------------------------------------------------------------------
# phase 9: B2/B3 timed at the step's shapes
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


def time_flash_bwd(tfa, dev, B=8, S=2048, Hq=24, Hkv=8, D=128):
    """B2 and B3 at the train step's shape ([8, 2048, 24/8, 128] bf16,
    causal): CUDA-event ms beside their plain versions, their bounds, and
    SDPA's backward as the library yardstick for the two together."""
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((B, S, Hq, D), (B, S, Hkv, D),
                                 (B, S, Hkv, D), (B, S, Hq, D)))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    delta = tfa._delta(out, do)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, True)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, True)
    want_dq = tfa.flash_dq_plain(q, k, v, do, lse, delta, True)
    err_dq = max_err(dq, want_dq)
    rel_dq = err_dq / want_dq.float().abs().max().item()
    del want_dq
    want_dk, want_dv = tfa.flash_dkv_plain(q, k, v, do, lse, delta, True)
    err_dk, err_dv = max_err(dk, want_dk), max_err(dv, want_dv)
    rel_dkv = max(err_dk / want_dk.float().abs().max().item(),
                  err_dv / want_dv.float().abs().max().item())
    del want_dk, want_dv
    if max(rel_dq, rel_dkv) > 2e-2:
        raise AssertionError(f"B2/B3 disagree at the step's shape: "
                             f"{rel_dq}, {rel_dkv}")
    ms_dq = time_ms(lambda i=0: tfa.flash_dq(q, k, v, do, lse, delta, True),
                    10)
    ms_dkv = time_ms(lambda i=0: tfa.flash_dkv(q, k, v, do, lse, delta,
                                               True), 10)
    plain_dq = time_ms(lambda i=0: tfa.flash_dq_plain(
        q, k, v, do, lse, delta, True), 3)
    plain_dkv = time_ms(lambda i=0: tfa.flash_dkv_plain(
        q, k, v, do, lse, delta, True), 3)
    fn, note = sdpa_backward(q, k, v, do)
    library_ms = time_ms(fn, 10)
    # each input read once, each output written once
    qb, kvb, stats = q.numel() * 2, k.numel() * 2, 2 * B * Hq * S * 4
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    res = {}
    for name, err, ms, plain, n_mm, out_b in (
            ("flash_dq", err_dq, ms_dq, plain_dq, 3, qb),
            ("flash_dkv", max(err_dk, err_dv), ms_dkv, plain_dkv, 4,
             2 * kvb)):
        flops = n_mm * B * Hq * S * S * D            # causal: S^2/2 pairs
        nbytes = 2 * qb + 2 * kvb + stats + out_b
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, \
            nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "library_ms": library_ms,
                     "library": f"SDPA backward, dq/dk/dv together "
                                f"(compare with flash_dq + flash_dkv): "
                                f"{note}",
                     "shape": shape}
    return res


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
    the train step's shapes (``deepseek_routing``), bf16."""
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
    ms = time_ms(lambda i=0: tpa.ragged_decode_partial(
        q, kp, vp, table, lens, layer=i % Lc, ks_pool=ks, vs_pool=vs), 4 * Lc)
    plain_ms = time_ms(lambda i=0: tpa.ragged_decode_partial_plain(
        q, kp, vp, table, lens, i % Lc, ks, vs), Lc)
    tokens = int(sum(lengths))
    nbytes = 2 * tokens * Hkv * (D + 4) + q.numel() * 2 \
        + N * Hkv * G * (D + 2) * 4 + table.numel() * 4 + N * 4
    flops = 4.0 * tokens * Hkv * G * D
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
            "rel_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None,
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
    b1 = time_flash(tfa, dev, B=B, S=S)
    log(f"  B1 timing: {b1}")
    torch.cuda.empty_cache()
    lens = [n + 32 for n in serving["prompt_lens"][:8]]
    b4 = time_ragged(tpa, dev, lens, num_blocks)
    log(f"  B4 timing: {b4}")
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

    log("phase 9: B2/B3 timed at the train step's shapes")
    bwd = time_flash_bwd(tfa, dev)
    log(f"  B2/B3 timing: {bwd}")
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

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
             replaces="paddle_tpu/kernels/pallas_attention.py:107",
             launches=launches.get("flash_fwd", 0),
             train_launches=train_launches.get("flash_fwd", 0), **b1),
        dict(name="ragged_decode", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/ragged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:578",
             launches=launches.get("ragged_decode", 0), **b4),
        dict(name="flash_dq", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_dq.cu",
             replaces="paddle_tpu/kernels/pallas_attention.py:232",
             launches=train_launches.get("flash_dq", 0), **bwd["flash_dq"]),
        dict(name="flash_dkv", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/flash_dkv.cu",
             replaces="paddle_tpu/kernels/pallas_attention.py:253",
             launches=train_launches.get("flash_dkv", 0),
             **bwd["flash_dkv"]),
        dict(name="mega_decode", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/mega_decode.cuh",
             replaces="paddle_tpu/kernels/mega_decode.py:645",
             launches=mega_launches.get("mega_decode", 0), **b5),
        dict(name="gather_gmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/gather_gmm.cu",
             replaces="paddle_tpu/kernels/moe_fused.py:266",
             launches=moe_launches.get("gather_gmm", 0),
             **grouped["gather_gmm"]),
        dict(name="gmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/gmm.cu",
             replaces="paddle_tpu/kernels/moe_dispatch.py:434",
             launches=moe_launches.get("gmm", 0), **grouped["gmm"]),
        dict(name="tgmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/tgmm.cu",
             replaces="paddle_tpu/kernels/moe_dispatch.py:445",
             launches=moe_launches.get("tgmm", 0), **grouped["tgmm"]),
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
                 "library_ms", "shape")}),
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
    spec["paged_api_checks"] = paged["checks"]
    log(f"spec: {json.dumps(spec)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
