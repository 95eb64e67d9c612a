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
   Llama-3-8B with random bf16 weights, its decode calls chained (no
   synchronize inside the timed run: tokens/s, chained step times, time
   to first token, readbacks a call), with the kernels' launch counts
   read around the run; then one more decode call traced alone with
   torch.profiler (the device's busy share of its wall time) and two
   chained calls traced back to back, and each
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
   and on the CPU — all four must be equal; (c), run right after
   phase 4 (``serving_runs``),
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
    bf16 params, random weights, the fused dispatch), 2 warm-up and 5
    timed steps — falling losses and, per step, the expected launches of
    B1-B3, B9, gmm (four a MoE layer: "outs" keeps the routed output, so
    the recompute runs the down GEMM again) and tgmm; tokens/s, step
    time, MFU, peak memory, the fused dispatch's route counts; one more
    step traced, its device time by kernel;
13. B9, gmm and tgmm timed at each of their calls' shapes in the step
    beside their plain versions, their bounds (and each call's share of
    it) and ``torch._grouped_mm``;
    the fused and gmm dispatch forms timed forward and backward;
14. card vs CPU MoE train step (f32, 2 layers, AdamW), and the card's gmm
    form against its fused form.

The rest of single-device MoE (``kernels/gmm_autotune.py``, the measured
``pick_dispatch_form``, ``dispatch="dense"``, remat "outs" keeping
[T, h]), its measured artifacts in a temporary ``FLAGS_jit_cache_dir``:

(m3) after phase 11: ``get_tilings`` at phase 12's four grouped-GEMM
     sites (the fused form's gate|up and down over the padded layout,
     the gmm form's two over the sorted rows), every candidate tile
     width of every pass (forward, dgrad, wgrad) held to the plain
     version at that width and timed; the winners against the
     heuristic; the persisted file read back with no measurement;
(m1) ``pick_dispatch_form`` at phase 12's routing shape with the dense
     form admitted: each form's forward-plus-backward ms, the winner
     (what "auto" runs there), no measurement on a second call nor from
     the file after ``clear_form_cache()``; a traced dense forward and
     backward;
(m2) after phase 12, on its state: 2 warm-up and 3 timed steps with
     ``dispatch="dense"`` beside phase 12's fused numbers (its route a
     MoE layer and host syncs a step, a traced step); phase 14's small
     model with the dense form on the card against the CPU and against
     the card's fused form, and an overflowing batch that takes B10;
(m3) the fused step with the tuned widths against the heuristic ones;
(m4) what "outs" keeps a MoE layer (no tensor of A_pad rows), the
     memory a forward holds, and the forward-plus-backward peak and step
     time against "outs" keeping the down GEMM's output as before.

Llama generation (``llama.generate``, ``generate_fused``) and the HF
interchange:

(g1) after (s3), on phase 4's weights: batch 8 of 128-token prompts, 32
     new tokens, greedy and sampled (temperature 0.8, top_k 40, top_p
     0.95) with an eos ending some rows: tokens/s, decode ms a token,
     host syncs and graph replays a token, kernels a token; greedy
     ``generate`` equals ``generate_fused``; the first divergence from
     ``LLMEngine``'s greedy streams;
(g2) after (int8 d), phase 5's cut model: ``generate`` and
     ``generate_fused`` on the card, ``generate`` on the CPU and a ragged
     engine on the card emit equal streams; ``to_hf_state_dict`` ->
     ``convert_hf_state_dict`` returns every leaf and the logits exactly.

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
     requests (``S3_NEW`` = 32 new tokens each) through a mega engine at
     4 slots (one B5-multi launch a spec
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

The serving tiers (chained decode, ``serving/prefix_cache.py``,
``kv_swap.py``, ``offload.py``), after phase 6 (c), on phase 4's
weights:

(p1) two steady-state chained steps (``eng.step()`` whole, the previous
     call unread; only its readback runs with the mode off) each for
     ragged at 8 slots and mega at 4 and 8 under
     ``torch.cuda.set_sync_debug_mode("error")``: a host sync raises;
     then phase 4's 16 requests through mega at 8 slots beside phase 4's
     ragged run (tokens/s, steps, readbacks a call, first divergence);
(p2) bench.py's shared-prefix recipe: 24 clients, a 384-token shared
     prefix plus 48-112-token tails, 48 new tokens, int8 pools, 8 slots
     of mega decode; prefix cache with 128-token chunks against no
     cache, each warmed on another prefix, two arrivals up front then one
     a step: tokens/s, TTFT p50/p95, hits, misses, tokens skipped, the
     first divergence;
(p3) bench.py's offload recipe: 16 requests of 256-384 tokens, 96 new
     tokens, int8 pools, 8 slots of mega decode, decode_steps 8, a pool
     of 2/5 the working set and an 8 GiB swap tier, ``kv_offload="sync"``
     against ``"async"``: the first swapped request's restored blocks equal
     its spilled bytes (every pool entry, scales included), tokens/s,
     restores, prefetch hits, stalls, stall seconds, fallbacks, the held
     host bytes beside the pinned memory torch reports;
(p4) phase 5's cut model through the prefix cache, 64-token chunks, a
     prefix host tier and the swap tier over a 6-block pool (spills and
     preemptions forced), on the card in sync and async modes and on the
     CPU: every stream equals the card's cache-off streams, and the
     ledger balances at every step.

The rest of the serving engine (``serving/admission.py``,
``serving/resilient.py``, ``distributed/resilience/faults.py``, the
engine's deadlines, cancellation and ``decode_kernel="bucketed"``), after
(p4), on phase 4's weights:

(r1) chaos at full width: Llama-3-8B, mega decode at 8 slots, a 4 GiB
     swap tier with async offload over a pool of 2/5 of the working set,
     admission control (two tenants) and the fault injector
     (``R_SCHEDULE``: a slow step, a pool squeeze, two failed readbacks,
     an offload crash) under ``ResilientEngine``; 32 submissions of
     64-512 prompt tokens, two a step, some with deadlines of 0 and 0.3
     s, a queued and an in-flight request cancelled. The ledger balances
     with no block counted twice at every step; at the end every minted
     id has one terminal reason, 3 recoveries, exactly-once streams, the
     pool free and the tiers empty. Sheds by reason, seconds from each
     crash to the next token, and tokens/s beside the same submissions
     with no injector;
(r2) card against CPU under chaos: phase 5's cut model as a self-draft
     speculative engine on ragged decode, the (r1) schedule plus a failed
     verify, scripted cancels: each step's emitted list, the ledgers,
     finish reasons and recoveries equal on the card and the CPU;
(r3) phase 4's mix through the bucketed decode at 8 slots beside phase
     4's ragged run (tokens/s, step time, TTFT p95, a traced call's busy
     share and launches a step, KV bytes a call, the first divergence);
     the cut model's f32 streams bucketed on the card and the CPU and
     ragged on the card, equal, with model-dtype and int8 pools.

The observability core (``paddle_tpu_torch.observability``) on the
serving path, after (r3), on phase 4's weights, observability on:

(o1) phase 4's 16-request mix through mega and ragged at 8 slots:
     tokens/s and step time beside phase 4's ragged run and (p1)'s mega
     run with observability off; every decode step's ``serving_mfu`` in
     (0, 1] and equal to this script's FLOP count
     (``analytic_decode_flops``) over the step's wall time within 1%,
     the HBM gauges equal to torch's allocator counters at each step's
     end, every request's timeline queued -> admitted -> prefill ->
     first_token -> decode... -> finish; then a ``MetricsServer(port=0)``
     scraped: every serving name the runs move documented and above
     zero, every prefill, decode and readback span inside a
     ``serving.step``, the TTFT exemplars resolving to finished requests;
(o2) int8 pools, mega at 4 slots: two chained steps under
     ``set_sync_debug_mode("error")`` with the numerics probes on
     ((p1)'s check with the telemetry added), the kv_int8 quant-error
     gauge against this script's recompute on the same K/V within 1e-5
     relative, step time with the probes on and off, a post-mortem
     holding the run's flight events and a metrics snapshot;
(o3) a two-step ``profiling.request_capture`` window during a mega run
     at 8 slots: B5's kernel among the trace's device events inside a
     ``serving.step`` range, one capture counted and its flight event,
     the window's busy share and top device ops by time.

The front door and the fleet (``serving/http.py``, ``serving/router.py``,
the engine's disaggregated roles, ``observability/fleet.py`` and
``timeseries.py``, ``distributed/watchdog.py``, ``tools/serve.py``),
after (o3), on phase 4's weights, observability on for (h1)-(h3), each
leg's launches counted from zero; (p1)'s mega run at 8 slots is the
direct (colocated) run beside them:

(h1) ``HTTPFrontDoor(ResilientEngine(LLMEngine(mega, 8 slots)))`` and
     stdlib socket clients: (a) 4 requests one at a time, each SSE body
     byte-equal to the frames of the same engine's direct run of them;
     (b) the 16-request mix from 16 concurrent clients: tokens/s at the
     clients and TTFT from each send to its first frame, beside (p1);
     (c) a client closes after 2 frames: ``client_disconnected`` within
     2 engine steps and no backed block; (d) 8 live streams and
     ``max_queue=2`` under a burst of 6: 503s with ``Retry-After``; (e) a
     ``readback_fail`` mid-stream: one ``: retrying`` frame, the stream
     exactly-once; (g) ``serving_http_*`` on ``/metrics`` and, with the
     door's process as a fleet source, on ``/fleet/metrics``; (f) drain:
     ``/readyz`` 503, a new POST 503 + ``Connection: close``, the live
     stream finishes, ``serving_http_drain_seconds`` observed;
(h2) ``ReplicaRouter`` over two 4-slot mega replicas sharing the weights,
     each step under a log-mode watchdog: (a) (p2)'s shared-prefix prompts
     count affinity hits; (b) the mix (submits acked while the replicas
     hold, so placement sees every load; then from 16 concurrent
     submitters) beside (p1); (c) r0 killed mid-flight: 16 ``finished``
     streams of 64 tokens, failovers, dedup drops, bf16 identity with
     (b); (e) ``revive_replica``: dead -> half_open -> healthy through one
     probe, then ``drain_all`` leaves both ledgers free; (d) the same
     kill on phase 5's cut model (f32): streams equal an uninterrupted
     engine's; (f) both replicas on ragged decode with 6 (c)'s 8
     requests: tokens/s and each replica's step time beside 6 (c)'s one
     4-slot ragged engine;
(h3) a ``role="prefill"`` engine and a ``role="decode"`` mega engine at
     8 slots behind one router over one ``HostKVPool(kind="relay")``:
     handoff bytes equal to Σ ⌈nᵢ/64⌉ x 8 MiB, 16 restored and none
     missing, handoff seconds (median, max), the relay's peak, tokens/s
     and TTFT beside (p1), bf16 identity with (p1); the pair on the cut
     model (f32) equal to a colocated engine; int8 pools: the relay entry
     and the restored slot's positions byte-equal to the prefill slot's
     blocks (payload and scales);
(h4) ``python -m paddle_tpu_torch.tools.serve --port 0`` on the card at
     1024 wide: ``serving on``, one generate, SIGINT, ``drained; bye``
     and exit 0 within 60 s (its output in
     ``chip_smoke_out/serve_cli.log``).

The training half of resilience and observability (A8-train), after
phase 10 ((c1), (c2)) and after (m2)-(m4) ((c3)):
(c1) ``ResilientTrainLoop`` around ``llama.train_step`` on llama-2.6b at
     full width cut to ``C1_LAYERS`` (12) layers, phase 8's shape
     otherwise, observability and numerics on: a clean run of 6
     steps and a faulted one (``C1_SCHEDULE``: a NaN gradient, a NaN in
     layer 7's weights, a crash; snapshots every 2 steps, keep 2, the
     newest corrupted before the relaunch) end allclose at 1e-6 (the
     differing elements counted), with equal loader positions, the
     rollback and the post-mortem naming ``llama.layer:7`` and B1-B3
     launched on every attempt; save, load and validation seconds
     against the tree's bytes, the steps lost, goodput fractions,
     ``train_mfu`` beside phase 8's MFU, the loop's step beside the bare
     ``train_step``; snapshots go to a temp dir with room for 4 of them;
(c2) ``python -m paddle_tpu_torch.tools.chaos_run --train --device cuda``
     prints ``CHAOS_PARITY: OK`` (its output in
     ``chip_smoke_out/chaos_run_train.log``);
(c3) one ``moe.forward`` at phase 12's state with numerics on under
     ``torch.cuda.set_sync_debug_mode("error")``: 12 ``moe.layer`` rungs,
     the router-logit and routed-output probes, the plan-cache and
     fused-dispatch counters, ``expert_int8``'s gauge; the forward's
     time numerics on against off.

Tensor-parallel serving (A10.1), after phase 15:
(t1) B4's tp form in one process: at the Llama-3-8B decode shape (Hq=32,
     Hkv=8, D=128, BS=64) in bf16, f32 and int8, q and the pools cut into
     tp in {2, 4, 8} kv-head slices (``shard_kv_heads``) and
     ``ragged_decode_shard`` launched on each (a shard walks on the whole
     launch's schedule); the slices' partials side by side equal the whole
     launch bit for bit, at phase 3's lengths and at short ones; each
     shard's time beside the whole launch's;
(t2) two ranks on the one card, started by ``distributed.spawn(nprocs=2,
     backend="gloo")``, each an ``LLMEngine(mesh=DeviceMesh("cuda", [0, 1],
     mesh_dim_names=("tp",)))``: phase 5's cut model (f32) through f32,
     int8-KV and int8-weight engines and a prefix-cache hit with chunked
     prefill, each equal to the single-rank engine on the card stream for
     stream, then Llama-3-8B at full width in bf16 (``TP_BF16_LAYERS``
     layers) with its first divergence and logit margins; tok/s, B4
     launches per rank, collectives and readbacks a step;
(t3) ``decode_kernel="mega"`` under the mesh falls back counted
     (reason "mesh") with the single-rank ragged streams; spec with a
     replicated draft equals the unmeshed spec engine.

Data-parallel and sharded training (A10.2), after (t3): two ranks on
the one card over gloo (``distributed.spawn(nprocs=2, backend="gloo")``),
each running ``train_step`` under ``llama.activation_mesh`` on its slices
of the state and its rows of the batch (``dp_phases``):
(d1) llama-2.6b at full width cut to ``D1_LAYERS`` layers, batch 8 x
     2048, f32 adamw, 3 steps at dp=2 with fsdp, tp=2 and dp=2 without
     fsdp from the single-rank state: losses within 1e-5 relative and
     slices within the CPU tests' f32 bound of the single-rank step on the
     card; phase 8's recipe at dp=2 (fsdp) with its loss gap;
(d2) DeepSeekMoE-16B's widths cut to ``D2_LAYERS`` layers: the same at
     dp=2 (fsdp) and tp=2, the aux loss equal to the single rank's, and
     phase 12's recipe at tp=2 with each B9/B10 call's tile width;
(d3) ``python -m paddle_tpu_torch.examples.llama_pretrain --size 740m
     --dp 2 --batch-size 4 --steps 2`` prints its loss and tokens/s.
Per rank: B1-B3 (B9, B10) launches a step, the collectives a step by kind
and bytes, step seconds (two processes share one card: no parallel
speed).

``python3 chip_smoke.py --serving`` runs phases 4, 6 (c), (p1)-(p4),
(r1)-(r3), (o1)-(o3) and (h1)-(h4) alone (no kernel checks, no device
line); ``python3 chip_smoke.py --resilience`` runs (c1)-(c3) alone ((c3)
on a fresh state of phase 12's config); ``python3 chip_smoke.py --tp``
runs (t1)-(t3) alone; ``python3 chip_smoke.py --dp`` runs (d1)-(d3)
alone.

Before its last line it prints ``serving``, ``serving_tiers``,
``serving_resilience``, ``observability``, ``front_door``,
``train_resilience``, ``mega``,
``training``, ``tp``, ``dp``,
``moe_training`` (with (m1)-(m4) under ``forms``), ``int8``,
``training_memory``, ``spec`` and ``generation`` lines (phases 4,
(p1)-(p4), 6, 8, 12-15, (a)-(f), (s1)-(s4), (g1)-(g2)), one JSON object
with every ported kernel (launches on its main path, max error, and
times in ms beside the bound; B9 and B10 with the tile width each of
their calls ran at), and the card's name and power limit; the last line
is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the repository beside it, it exits 1
and prints no result.
"""
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and dense bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SEED = 0


T0 = time.perf_counter()


def log(*a):
    """Print and flush; a phase's header line also gets the seconds since
    the script started, so the log shows where the run's time goes."""
    if a and isinstance(a[0], str) and a[0].startswith("phase"):
        a = (*a, f"[{time.perf_counter() - T0:.1f} s]")
    # one write a line: (t2)'s two ranks print to the same stream
    sys.stdout.write(" ".join(str(x) for x in a) + "\n")
    sys.stdout.flush()


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


def kernel_spans(fn, iters, key, traces=3):
    """The device intervals (start, end) in us of the kernels whose name
    holds ``key`` over ``iters`` calls of ``fn()`` (torch.profiler, after
    one warm-up call), in order. A trace that comes back without any such
    kernel (CUPTI now and then hands back none of a run's device events)
    is taken again, up to ``traces`` traces; empty only if all were."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and key in e.name)
        if spans:
            return spans
        log(f"  (trace of {key!r} held none of its kernels; tracing again)")
    return []


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
    """Counts an engine method's calls and times each on the host clock,
    up to a device synchronize with ``sync`` (left out where a
    synchronize would drain the chained decode pipeline: the time is
    then the call's host time alone)."""

    def __init__(self, obj, name, sync=True):
        self.args = []
        self.seconds = []
        inner = getattr(obj, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            res = inner(*a, **k)
            if sync:
                torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.args.append(a)
            return res

        setattr(obj, name, wrapped)

    @property
    def n(self):
        return len(self.seconds)


class StepTimer:
    """Wraps ``eng.step`` (no synchronize: the chained pipeline runs as it
    would): each step's wall time, whether it dispatched a prefill and a
    decode call, and each request's time to its first host-visible token
    from its arrival (``arrive``; ``start`` stamps every request queued
    so far)."""

    def __init__(self, eng, prefills, decodes):
        self.steps = []           # (seconds, prefill calls, decode calls)
        self.arrived = {}
        self.ttft = {}
        inner = eng.step

        def wrapped():
            n_p, n_d = prefills.n, decodes.n
            t0 = time.perf_counter()
            out = inner()
            t1 = time.perf_counter()
            self.steps.append((t1 - t0, prefills.n - n_p, decodes.n - n_d))
            for rid, _tok in out:
                if rid in self.arrived and rid not in self.ttft:
                    self.ttft[rid] = t1 - self.arrived[rid]
            return out

        eng.step = wrapped

    def arrive(self, rid):
        self.arrived[rid] = time.perf_counter()

    def start(self, rids):
        t = time.perf_counter()
        for rid in rids:
            self.arrived[rid] = t

    def decode_step_ms(self, decode_steps):
        """Per decode step, the wall time of each step that dispatched a
        decode call and no prefill (in steady chaining one call's time)."""
        return [1e3 * t / decode_steps for t, n_p, n_d in self.steps
                if n_d and not n_p]

    def ttft_s(self):
        return sorted(self.ttft.values())


def p95(xs):
    return xs[int(0.95 * (len(xs) - 1))] if xs else None


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


# every engine of phases 4, 6 (c) and (p1): block size, length, prefill
# buckets, steps a decode call
SERVE_ENGINE = dict(block_size=64, max_model_len=2048,
                    prompt_buckets=[128, 512, 1024], decode_steps=16)
# phases 4 and 6 (c): (cell, decode kernel, slots, requests of the mix)
SERVING_CELLS = (("phase4_ragged_8", "ragged", 8, 16),
                 ("phase6c_mega_4", "mega", 4, 8),
                 ("phase6c_ragged_4", "ragged", 4, 8))


def analytic_decode_flops(cfg, rows, steps, walk_lens, block_size):
    """This script's own count of one decode call's FLOPs, which (o1)
    holds the engine's ``serving_mfu`` to: two FLOPs per matmul weight
    element (q, k, v, o, the SwiGLU MLP, the head) per batch row per step,
    plus QK and PV — 4 * Hq * D FLOPs per walked K/V position per layer
    per step — over each slot's whole blocks at its walked length."""
    h, d, L = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    weights = L * (2 * h * cfg.num_heads * d + 2 * h * cfg.num_kv_heads * d
                   + 3 * h * cfg.intermediate_size) + h * cfg.vocab_size
    positions = sum(-(-n // block_size) * block_size for n in walk_lens)
    return steps * (2 * weights * rows
                    + 4 * cfg.num_heads * d * L * positions)


def serving_mix(cfg, n):
    """The first ``n`` requests of the serving mix: prompt lengths drawn
    from 64-1000 and tokens by ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1001, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    return prompts[:n]


def serve(LLMEngine, build, dev, card, cfg, params, prompts, max_slots,
          decode_kernel, kv_dtype=None, chained_trace=0, trace=True,
          hook=None):
    """``LLMEngine`` on Llama-3-8B serving ``prompts`` (64 greedy tokens
    each) through ``decode_kernel`` (int8 pools with ``kv_dtype="int8"``;
    int8 weights when ``params`` hold them), its decode calls chained: the
    run's numbers with no synchronize inside it (tokens/s, steady step
    times, time to first token with every request queued at the start,
    readbacks a decode dispatch), with the kernels' launch counts read
    around it, then one decode call traced alone and, with
    ``chained_trace``, that many chained calls traced back to back. The
    decode kernels counted are the int8 branches when the weights or the
    pools are int8. ``trace=False`` leaves the traced calls out;
    ``hook(eng)`` runs on the new engine before anything else wraps it."""
    eng = LLMEngine(params, cfg, max_slots=max_slots, **SERVE_ENGINE,
                    decode_kernel=decode_kernel, seed=SEED,
                    kv_dtype=kv_dtype, device=dev)
    if hook is not None:
        hook(eng)
    w_int8 = isinstance(params["layers"]["wq"], dict)
    b4 = "ragged_decode_int8" if kv_dtype else "ragged_decode"
    b5 = "mega_decode_int8" if kv_dtype or w_int8 else "mega_decode"
    lens = np.array([len(p) for p in prompts])
    ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    kv_bytes = []
    dispatch = eng._dispatch_decode

    def dispatch_counting(active):
        kv_bytes.append(call_kv_bytes(eng, active))
        return dispatch(active)

    eng._dispatch_decode = dispatch_counting
    prefills = CallTimer(eng, "_dispatch_prefill", sync=False)
    decodes = CallTimer(eng, "_dispatch_decode", sync=False)
    steps = StepTimer(eng, prefills, decodes)
    torch.cuda.reset_peak_memory_stats(dev)
    build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps.start(ids)
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
    if decode_kernel == "bucketed" and (
            set(eng.decode_paths) - {"bucketed", "dense"}
            or any(launches.get(k, 0) for k in (
                "ragged_decode", "ragged_decode_int8", "mega_decode",
                "mega_decode_int8"))):
        raise AssertionError(f"the bucketed engine launched {launches}, "
                             f"paths {dict(eng.decode_paths)}")
    if sum(eng.readbacks.values()) != decodes.n:
        raise AssertionError(f"{dict(eng.readbacks)} readbacks for "
                             f"{decodes.n} decode calls")
    peak = torch.cuda.max_memory_allocated(dev)
    # each prefill wave's (rows, bucket): B=1 alone, else max_slots rows
    waves = [(1 if len(rows) == 1 else eng.N,
              eng._bucket_for(max(r[4] for r in rows)))
             for (rows,) in prefills.args]
    step_ms = steps.decode_step_ms(16)
    ttft = steps.ttft_s()
    drained = eng.readbacks["drained"]
    log(f"  {decode_kernel} decode, {max_slots} slots, weights "
        f"{'int8' if w_int8 else str(cfg.dtype)[6:]}, KV "
        f"{kv_dtype or str(cfg.dtype)[6:]}: served {len(ids)} "
        f"requests, {n_tok} tokens in {wall:.2f} s: {n_tok / wall:.1f} "
        f"output tok/s; prefill waves {waves}; {decodes.n} decode calls "
        f"of 16 steps, readbacks {dict(eng.readbacks)} "
        f"({drained / max(1, decodes.n):.3f} draining syncs a call); "
        f"median chained step {float(np.median(step_ms)):.2f} ms over "
        f"{len(step_ms)} decode-only steps; TTFT p50 "
        f"{ttft[len(ttft) // 2]:.3f} s, p95 {p95(ttft):.3f} s; launches "
        f"{launches}; peak memory {peak / 2**30:.2f} GiB; card: {card}")
    summary = {"decode_kernel": decode_kernel, "max_slots": max_slots,
               "int8_weights": w_int8, "kv_dtype": kv_dtype,
               "requests": len(ids), "output_tokens": n_tok,
               "wall_s": wall, "output_tok_per_s": n_tok / wall,
               "prefill_waves": waves,
               "prefill_host_s": list(prefills.seconds),
               "decode_calls": decodes.n,
               "decode_host_s": list(decodes.seconds),
               "readbacks": dict(eng.readbacks),
               "draining_syncs_per_call": drained / max(1, decodes.n),
               "decode_step_ms": step_ms,
               "median_decode_step_ms": float(np.median(step_ms)),
               "ttft_s": ttft, "ttft_p95_s": p95(ttft),
               "kv_bytes_per_call": float(np.mean([b for b, _ in
                                                   kv_bytes])),
               "gathered_bytes_per_call": float(np.mean([g for _, g in
                                                         kv_bytes])),
               "decode_paths": dict(eng.decode_paths),
               "launches": launches,
               "peak_mem_gib": peak / 2**30, "prompt_lens": lens.tolist()}
    streams = [out[i] for i in ids]
    if trace:
        summary["traced_decode_call"], summary["traced_chained_calls"] = \
            trace_decode_call(eng, prompts[:eng.N], chained_trace)
    return launches, summary, streams, eng.nb


def call_kv_bytes(eng, active):
    """(KV bytes, gathered bytes) of the next decode call of ``eng`` for
    ``active``, by the JAX engine's ``kv_read_bytes`` convention (target
    pools only): ragged and mega walk each slot's blocks at its true
    length (plus the unread call's lag) every step and gather nothing;
    bucketed gathers its power-of-two bucket of blocks for every slot
    once a call, writes that dense copy and reads it every step."""
    pb = sum(a.shape[0] * int(np.prod(a.shape[2:])) * a.element_size()
             for n, a in eng.pools.items() if n in ("k", "v", "ks", "vs"))
    if eng.decode_kernel == "bucketed":
        gathered = pb * eng.N * eng._prefix_blocks(active)
        return gathered * (2 + eng.decode_steps), gathered
    snap = ({s for s, _ in eng._inflight["snapshot"]}
            if eng._inflight is not None else ())
    walk = sum(-(-(int(eng.lengths[i])
                   + (eng.decode_steps if i in snap else 0)) // eng.bs)
               for i in active)
    return walk * pb * eng.decode_steps, 0


def serving_runs(llama, LLMEngine, build, dev, card):
    """Phases 4 and 6 (c) on Llama-3-8B's random bf16 weights: each of
    SERVING_CELLS through ``serve`` (two chained calls traced, but for
    the ragged 4-slot cell). Returns the config, the weights and, by
    cell, ``serve``'s (launches, summary, streams, blocks)."""
    log("phase 4: LLMEngine serves Llama-3-8B (ragged decode); phase 6 "
        "(c): mega and ragged at 4 slots")
    cfg8, params8 = llama3_8b_bf16(llama, dev)
    runs = {}
    for cell, kernel, slots, n in SERVING_CELLS:
        runs[cell] = serve(
            LLMEngine, build, dev, card, cfg8, params8, serving_mix(cfg8, n),
            max_slots=slots, decode_kernel=kernel,
            chained_trace=0 if cell == "phase6c_ragged_4" else 2)
        free_memory()
    mega, ragged4 = runs["phase6c_mega_4"][1], runs["phase6c_ragged_4"][1]
    mega["ragged_same_mix"] = ragged4
    mega["first_stream_divergence"] = first_divergence(
        runs["phase6c_mega_4"][2], runs["phase6c_ragged_4"][2])
    log(f"  mega vs ragged at 4 slots: {mega['output_tok_per_s']:.1f} vs "
        f"{ragged4['output_tok_per_s']:.1f} output tok/s, median step "
        f"{mega['median_decode_step_ms']:.2f} vs "
        f"{ragged4['median_decode_step_ms']:.2f} ms; first stream "
        f"divergence (request, token): {mega['first_stream_divergence']}")
    return cfg8, params8, runs


def trace_decode_call(eng, prompts, chained=0):
    """Where one steady decode call's time goes: admit a full wave, run
    its first decode call, then trace the next one alone (the pipeline
    drained before it) with torch.profiler and report the device's busy
    share of the call's wall time, its kernel launches and the kernels
    that took the most device time; then, the pipeline drained again,
    trace ``chained`` steps back to back (each dispatches a call and
    reads the one before): the busy share the chain reaches. The engine
    is drained afterwards."""
    for p in prompts:
        eng.add_request(p, max_new_tokens=16 * (chained + 3))
    eng.step()
    torch.cuda.synchronize()
    res = traced(eng.step)
    if res is not None:
        res["launches_per_step"] = res["kernel_launches"] / eng.decode_steps
    torch.cuda.synchronize()
    chain = (traced(lambda: [eng.step() for _ in range(chained)])
             if chained else None)
    if chain is not None:
        chain["calls"] = chained
    eng.run()
    acct = eng.block_accounting()
    if acct["free"] != acct["total"]:
        raise AssertionError(f"block ledger unbalanced after drain: {acct}")
    log(f"  traced decode call ({eng.decode_steps} steps): {res}")
    if chained:
        log(f"  traced {chained} chained decode calls: {chain}")
    return res, chain


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


CUT = {}


def cut_model(llama, int8=False):
    """Phase 5's cut model: Llama-3-8B widths, 2 layers, a 32768
    vocabulary, f32 weights made with numpy from SEED, on the CPU (with
    ``int8``, ``quantize_params``'d) — made once and shared by phases 5,
    6, (p4), (s2) and (int8 d); ``CUT.clear()`` frees it."""
    if "cfg" not in CUT:
        import dataclasses
        CUT["cfg"] = dataclasses.replace(llama.llama3_8b(), num_layers=2,
                                         vocab_size=32768,
                                         dtype=torch.float32)
        CUT[False] = llama.params_from_numpy(numpy_params(CUT["cfg"], SEED),
                                             device="cpu")
    if int8 not in CUT:
        CUT[int8] = llama.quantize_params(CUT[False])
    return CUT["cfg"], CUT[int8]


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
    cfg, base = cut_model(llama, int8)
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
# phases (p1)-(p4): chained decode, the prefix cache with chunked prefill,
# and the swap/offload host tiers
# ---------------------------------------------------------------------------
def chained_dispatch(LLMEngine, dev, cfg, params, prompts):
    """(p1): two steady-state chained steps — ``eng.step()`` whole: the
    offload sweep, chunks, admission, backing, the carry and slot-vector
    refresh and the decode dispatch, with the previous call unread — for
    each of ragged at 8 slots and mega at 4 and 8, under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises.
    Only ``_process``, the previous call's readback (a wait by design),
    runs with the mode off; each step must have dispatched and read one
    chained call and drained none."""
    res = {}
    for kernel, slots in (("ragged", 8), ("mega", 4), ("mega", 8)):
        eng = LLMEngine(params, cfg, max_slots=slots, **SERVE_ENGINE,
                        decode_kernel=kernel, seed=SEED, device=dev)
        for p in prompts[:slots]:
            eng.add_request(p[:128], max_new_tokens=64)
        eng.step()                   # the wave's prefill and first call
        eng.step()                   # the second call, chained
        process = eng._process

        def process_unchecked(rec):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return process(rec)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        eng._process = process_unchecked
        for _ in range(2):
            if eng._inflight is None or not eng._spec_safe():
                raise AssertionError(f"{kernel} {slots}: not chained")
            before = dict(eng.readbacks)
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if eng.readbacks["chained"] != before.get("chained", 0) + 1 \
                    or eng.readbacks["drained"] != before.get("drained", 0):
                raise AssertionError(f"{kernel} {slots}: readbacks "
                                     f"{before} -> {dict(eng.readbacks)}")
        eng._process = process
        out = eng.run()
        if eng.mega_fallbacks or any(len(v) != 64 for v in out.values()):
            raise AssertionError(f"{kernel} {slots}: fallbacks "
                                 f"{dict(eng.mega_fallbacks)}")
        res[f"{kernel}_{slots}_slots"] = {
            "sync_free_steps": 2, "readbacks": dict(eng.readbacks),
            "decode_paths": dict(eng.decode_paths)}
        log(f"  {kernel} at {slots} slots: 2 chained steps under sync "
            f"debug mode 'error' raised nothing; readbacks "
            f"{dict(eng.readbacks)}")
        del eng, process
        free_memory()
    return res


def mega_only(eng, label):
    """Fail unless every decode call of ``eng`` ran the mega kernel."""
    if eng.mega_fallbacks or set(eng.decode_paths) != {"mega"}:
        raise AssertionError(f"{label}: decode paths "
                             f"{dict(eng.decode_paths)}, mega fallbacks "
                             f"{dict(eng.mega_fallbacks)}")


def shared_prefix(LLMEngine, build, dev, card, cfg, params):
    """(p2): bench.py's shared-prefix recipe (attempt_sharedprefix) on
    Llama-3-8B with int8 pools: 24 clients whose prompts share a
    384-token prefix (tails of 48-112 tokens), 48 greedy tokens each;
    cache on (prefix cache + 128-token chunks) against off, each engine
    warmed on another prefix; two arrivals up front, then one a step.
    Decode runs the mega kernel (B5-int8), as in (p1) at 8 slots, where
    ragged would be host-bound and leave prefill a small share.
    Tokens/s, TTFT p50/p95 from each arrival, the cache's counters over
    the timed run, launches, and the first stream divergence on against
    off."""
    n_clients, new_tok = 24, 48
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 32768, size=384).tolist()
    tails = [rng.integers(1, 32768, size=int(t)).tolist()
             for t in rng.integers(48, 112, size=n_clients)]
    warm_shared = rng.integers(1, 32768, size=384).tolist()
    res, streams = {}, {}
    for on in (False, True):
        eng = LLMEngine(params, cfg, max_slots=8, block_size=64,
                        max_model_len=1024, prompt_buckets=[128, 512, 1024],
                        decode_steps=16, decode_kernel="mega",
                        kv_dtype="int8", prefix_cache=on,
                        prefill_chunk=128 if on else 0, seed=SEED,
                        device=dev)
        for t in tails[:2]:
            eng.add_request(warm_shared + t, max_new_tokens=17)
        eng.run()
        pc = eng.prefix_cache
        base = ((pc.hits, pc.misses, pc.tokens_skipped) if on
                else (0, 0, 0))
        prefills = CallTimer(eng, "_dispatch_prefill", sync=False)
        decodes = CallTimer(eng, "_dispatch_decode", sync=False)
        steps = StepTimer(eng, prefills, decodes)
        build.launch_counts.clear()
        pending = [shared + t for t in tails]
        ids, gen = [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            ids.append(eng.add_request(pending.pop(0),
                                       max_new_tokens=new_tok))
            steps.arrive(ids[-1])
        while eng.has_work() or pending:
            if pending:
                ids.append(eng.add_request(pending.pop(0),
                                           max_new_tokens=new_tok))
                steps.arrive(ids[-1])
            gen += len(eng.step())
            acct = eng.block_accounting()
            if acct["free"] + acct["backed"] + acct["cached"] \
                    != acct["total"]:
                raise AssertionError(f"ledger {acct}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = [eng.results[i] for i in ids]
        acct = eng.block_accounting()
        if gen != n_clients * new_tok or any(len(s) != new_tok for s in out) \
                or acct["backed"] or acct["free"] + acct["cached"] \
                != acct["total"]:
            raise AssertionError(f"cache {on}: {gen} tokens, ledger {acct}")
        mega_only(eng, f"(p2) cache {on}")
        ttft = steps.ttft_s()
        key = "cache_on" if on else "cache_off"
        streams[key] = out
        res[key] = {
            "output_tok_per_s": gen / wall, "wall_s": wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p95_s": p95(ttft),
            "prefill_calls": prefills.n, "decode_calls": decodes.n,
            "readbacks": dict(eng.readbacks),
            "median_decode_step_ms": float(np.median(
                steps.decode_step_ms(16) or [float("nan")])),
            "launches": dict(build.launch_counts)}
        if on:
            res[key].update(hits=pc.hits - base[0],
                            misses=pc.misses - base[1],
                            tokens_skipped=pc.tokens_skipped - base[2],
                            evictions=dict(pc.evictions))
        log(f"  shared prefix, cache {'on' if on else 'off'}: "
            f"{res[key]}; card: {card}")
        del eng, prefills, decodes, steps
        free_memory()
    res["first_divergence_on_vs_off"] = first_divergence(
        streams["cache_on"], streams["cache_off"])
    res["speedup_on_over_off"] = (res["cache_on"]["output_tok_per_s"]
                                  / res["cache_off"]["output_tok_per_s"])
    return res


def offload_tiers(LLMEngine, build, dev, card, cfg, params):
    """(p3): bench.py's offload recipe (attempt_offload) on Llama-3-8B
    with int8 pools: 16 requests of 256-384 prompt tokens, 96 greedy
    tokens each, at 8 slots, decode_steps 8, the block pool 2/5 of the
    working set (bench.py's divisor of the working set, 1.5, raised to
    2.5: at 2/3 the run swaps 3 times in all, at 2/5 in most prefill
    waves) and an 8 GiB swap tier; ``kv_offload="sync"`` against
    ``"async"``. Decode runs the mega kernel (B5-int8): device-bound
    steps, so a restore's inline stall is not lost in host noise. The first
    swapped-out request's blocks are copied on the card when it is
    spilled and compared (``torch.equal``, every pool entry, scales
    included) with what its swap-in restores: a mismatch fails. Tokens/s,
    restores, prefetch hits, stalls and their seconds, recompute
    fallbacks, the held host bytes' peak against the pinned host memory
    torch's allocator reports."""
    n_reqs, new_tok = 16, 96
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 32768, size=int(ln)).tolist()
               for ln in rng.integers(256, 384, size=n_reqs)]
    per_req = -(-(384 + new_tok) // 64)
    pool_blocks = max(2 * per_req, int(8 * per_req / 2.5))
    res, streams = {"pool_blocks": pool_blocks,
                    "working_set_blocks": 8 * per_req}, {}
    stats = getattr(torch.cuda, "host_memory_stats", None)
    for mode in ("sync", "async"):
        eng = LLMEngine(params, cfg, max_slots=8, block_size=64,
                        max_model_len=1024, prompt_buckets=[128, 512, 1024],
                        decode_steps=8, decode_kernel="mega",
                        kv_dtype="int8",
                        num_blocks=pool_blocks, kv_swap_bytes=8 << 30,
                        kv_offload=mode, seed=SEED, device=dev)
        warm = np.random.default_rng(1)
        for ln in (100, 300):
            eng.add_request(warm.integers(1, 32768, size=ln).tolist(),
                            max_new_tokens=17)
        eng.run()
        check = {"rid": None, "before": None, "equal": None}
        spill = eng.offload.spill_async

        def spill_copying(key, pools, block_ids, *a, **k):
            if check["rid"] is None and a[1] is eng.swap_pool:
                idx = torch.tensor(list(block_ids), device=dev)
                check["rid"] = key
                check["before"] = {n: p.index_select(1, idx).clone()
                                   for n, p in pools.items()}
            return spill(key, pools, block_ids, *a, **k)

        swap_in = eng._swap_in

        def swap_in_comparing(slot, req, ent):
            swap_in(slot, req, ent)
            if req.req_id == check["rid"] and check["equal"] is None:
                idx = torch.tensor(eng.table[slot, :ent.n_blocks].tolist(),
                                   device=dev)
                check["equal"] = all(
                    torch.equal(p.index_select(1, idx), check["before"][n])
                    for n, p in eng.pools.items())
                check["before"] = None

        eng.offload.spill_async = spill_copying
        eng._swap_in = swap_in_comparing
        held = [0]
        step = eng.step

        def step_checked():
            out = step()
            acct = eng.block_accounting()
            if acct["free"] + acct["backed"] + acct["in_flight"] \
                    != acct["total"]:
                raise AssertionError(f"ledger {acct}")
            held[0] = max(held[0], eng.swap_pool.bytes_used
                          + eng.swap_pool.reserved_bytes)
            return out

        eng.step = step_checked
        build.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=new_tok) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams[mode] = [out[r] for r in rids]
        gen = sum(len(s) for s in streams[mode])
        off = eng.offload
        acct = eng.block_accounting()
        if check["equal"] is not True:
            raise AssertionError(f"{mode}: request {check['rid']}'s "
                                 f"restored blocks: {check['equal']}")
        if gen != n_reqs * new_tok or acct["free"] != acct["total"] \
                or acct["in_flight"] or len(eng.swap_pool):
            raise AssertionError(f"{mode}: {gen} tokens, ledger {acct}")
        mega_only(eng, f"(p3) {mode}")
        res[mode] = {
            "output_tok_per_s": gen / wall, "wall_s": wall,
            "restores": off.prefetch_hits + off.stalls,
            "prefetch_hits": off.prefetch_hits, "stalls": off.stalls,
            "stall_seconds": off.stall_seconds,
            "recompute_fallbacks": eng.swap_fallbacks,
            "restored_block_bytes_equal": {"request": check["rid"],
                                           "equal": True},
            "readbacks": dict(eng.readbacks),
            "held_host_bytes_peak": held[0],
            "host_memory_stats": ({k: v for k, v in stats().items()
                                   if "bytes" in k}
                                  if stats is not None else "not measured"),
            "launches": dict(build.launch_counts)}
        log(f"  offload {mode}: {res[mode]}; card: {card}")
        del eng, spill, swap_in, step
        free_memory()
    res["first_divergence_async_vs_sync"] = first_divergence(
        streams["async"], streams["sync"])
    res["async_over_sync"] = (res["async"]["output_tok_per_s"]
                              / res["sync"]["output_tok_per_s"])
    return res


P4_GEOMETRY = dict(max_slots=2, block_size=64, max_model_len=512,
                   prompt_buckets=[128, 256], decode_steps=4)
P4_TIERS = dict(prefix_cache=True, prefill_chunk=64,
                prefix_cache_host_bytes=64 << 20, kv_swap_bytes=64 << 20,
                num_blocks=6)


def p4_requests(vocab, seed=SEED + 9):
    """(p4)'s traffic: two 128-token prefixes taken in turn by four
    prompts with 20-70-token tails, 40 greedy tokens each."""
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, vocab, size=128).tolist() for _ in range(2))
    heads = (a, b, a, b)
    tails = (40, 70, 30, 20)
    news = (40, 40, 40, 40)
    return [(h + rng.integers(0, vocab, size=t).tolist(), n)
            for h, t, n in zip(heads, tails, news)]


def serve_tiers(LLMEngine, cfg, params, device, requests, **kw):
    """``requests`` through an engine of (p4)'s geometry, the ledger
    checked at every step; the streams and the engine's tier counters."""
    eng = LLMEngine(params, cfg, device=device, **P4_GEOMETRY, **kw)
    ids = [eng.add_request(p, max_new_tokens=n) for p, n in requests]
    preempted = []
    free_slot = eng._free_slot

    def counting(slot, requeue=False):
        preempted.append(requeue)
        return free_slot(slot, requeue)

    eng._free_slot = counting
    while eng.has_work():
        eng.step()
        a = eng.block_accounting()
        if a["free"] + a["backed"] + a["cached"] + a["squeezed"] \
                + a["in_flight"] != a["total"]:
            raise AssertionError(f"{device} {kw}: ledger {a}")
    eng.drain_offload()
    a = eng.block_accounting()
    if a["backed"] or a["in_flight"] or a["free"] + a["cached"] \
            != a["total"]:
        raise AssertionError(f"{device} {kw}: ledger after drain {a}")
    stats = {"preemptions": sum(preempted)}
    if eng.prefix_cache is not None:
        pc = eng.prefix_cache
        stats.update(hits=pc.hits, tokens_skipped=pc.tokens_skipped,
                     spills=pc.evictions["spill"],
                     restores=eng.offload.prefetch_hits
                     + eng.offload.stalls,
                     swap_fallbacks=eng.swap_fallbacks)
    return [eng.results[i] for i in ids], stats


def tiers_cross_device(llama, LLMEngine, dev):
    """(p4): phase 5's cut model (Llama-3-8B widths, 2 layers, a 32768
    vocabulary, f32 numpy-made weights) through the prefix cache, 64-token
    chunks, a prefix host tier and the swap tier over a 6-block pool that
    forces spills and preemptions, on the card (sync and async) and on
    the CPU (sync), and cache-off on the card: every greedy stream must be
    equal, and the ledger balance at every step."""
    cfg, base = cut_model(llama)
    reqs = p4_requests(cfg.vocab_size)
    streams, stats = {}, {}
    for where, modes in ((str(dev), ("sync", "async")), ("cpu", ("sync",))):
        params = tree_to(base, where)
        for mode in modes:
            t0 = time.perf_counter()
            key = f"{where}_{mode}"
            streams[key], stats[key] = serve_tiers(
                LLMEngine, cfg, params, where, reqs, kv_offload=mode,
                **P4_TIERS)
            log(f"  {key}: {stats[key]} ({time.perf_counter() - t0:.1f} s)")
        if where == str(dev):
            streams["cache_off"], _ = serve_tiers(LLMEngine, cfg, params,
                                                  where, reqs)
        del params
    ref = streams["cache_off"]
    bad = {k: first_divergence(v, ref) for k, v in streams.items()
           if v != ref}
    if bad:
        raise AssertionError(f"(p4) streams differ from cache-off: {bad}")
    st = stats[f"{dev}_async"]
    if not (st["hits"] and st["spills"] and st["preemptions"]
            and st["restores"]):
        raise AssertionError(f"(p4) the tiers were not exercised: {stats}")
    log(f"  card and CPU streams equal cache-off in sync and async modes: "
        f"{[len(s) for s in ref]} tokens")
    return {"stats": stats, "streams_equal": True}


# ---------------------------------------------------------------------------
# phases (r1)-(r3): admission control, deadlines, cancellation, the serving
# fault injector under ResilientEngine, and the bucketed dense-gather decode
# ---------------------------------------------------------------------------
# the serving faults of (r1), at fixed engine steps; (r2) adds a failed
# speculative verify
R_SCHEDULE = ("slow_step@3,pool_squeeze@5,readback_fail@8,offload_crash@13,"
              "readback_fail@21")
R_CRASHES = 3           # readback_fail twice, offload_crash once
TERMINAL = {"finished", "shed", "deadline_exceeded", "client_disconnected"}
# (r1): Llama-3-8B at 8 slots of mega decode with both host tiers
R1_ENGINE = dict(max_slots=8, block_size=64, max_model_len=1024,
                 prompt_buckets=[128, 512, 1024], decode_steps=8,
                 decode_kernel="mega", kv_swap_bytes=4 << 30,
                 kv_offload="async")
# (r2): phase 5's cut model, a self-draft spec engine on ragged decode
R2_ENGINE = dict(max_slots=2, block_size=16, max_model_len=256,
                 prompt_buckets=[64], decode_steps=2, decode_kernel="ragged",
                 num_blocks=7, kv_swap_bytes=64 << 20, kv_offload="async",
                 spec_tokens=3)


def ledger_checked(eng):
    """The block ledger ``free + backed + cached + squeezed + in_flight ==
    total``, with no block id counted twice (the free list, the slots'
    tables, squeezed and custody blocks) and the trash block never handed
    out; returns the ledger."""
    a = eng.block_accounting()
    if a["free"] + a["backed"] + a["cached"] + a["squeezed"] \
            + a["in_flight"] != a["total"]:
        raise AssertionError(f"ledger {a}")
    ids = list(eng.free_blocks)
    for i in range(eng.N):
        ids += [int(b) for b in eng.table[i, :int(eng.n_alloc[i])]]
    ids += [b for _, blocks in eng._squeezed for b in blocks]
    if eng.offload is not None:
        ids += [b for t in eng.offload._spills.values() for b in t.blocks]
    if len(ids) != len(set(ids)) or 0 in ids:
        raise AssertionError(f"a block id counted twice or the trash block "
                             f"handed out; ledger {a}")
    return a


def drive_chaos(eng, reng, submissions, per_step, actions, clock=None):
    """Submit ``submissions`` ((prompt, kwargs) pairs) ``per_step`` a step
    to ``eng`` and step ``reng`` (its ``ResilientEngine``) until both are
    done, the ledger checked after every step. ``actions`` maps a step
    index to a callable run just before that step (a cancel); one that
    returns False is tried again at the next step. ``clock`` (a
    one-element list) advances 0.1 s a step: the admission controller's
    clock. Returns the minted ids (sheds included), each step's emitted
    list, ledger and end time, and the times of the recoveries."""
    from paddle_tpu_torch.serving import ShedError
    pending = list(submissions)
    ids, steps, ledgers, t_end, t_crash = [], [], [], [], []
    todo = sorted(actions.items())
    idx = 0
    while reng.has_work() or pending:
        for prompt, kw in pending[:per_step]:
            try:
                ids.append(eng.add_request(prompt, **kw))
            except ShedError as e:
                ids.append(e.req_id)
        pending = pending[per_step:]
        idx += 1
        while todo and todo[0][0] <= idx and todo[0][1]() is not False:
            todo.pop(0)
        n_rec = reng.recoveries
        steps.append(reng.step())
        t_end.append(time.perf_counter())
        if reng.recoveries != n_rec:
            t_crash.append((idx, t_end[-1]))
        ledgers.append(ledger_checked(eng))
        if clock is not None:
            clock[0] += 0.1
    if todo:
        raise AssertionError(f"actions never found a target: {todo}")
    eng.drain_offload()
    return ids, steps, ledgers, t_end, t_crash


def streams_of(steps):
    out = {}
    for step in steps:
        for rid, tok in step:
            out.setdefault(rid, []).append(tok)
    return out


def r1_requests(vocab):
    """(r1)'s 32 submissions: prompts of 64-512 tokens and 16-48 new
    tokens from ``numpy.random.default_rng(SEED + 17)`` (the lengths
    drawn before the tokens, so they do not depend on ``vocab``), two
    tenants in turn; every 5th has a deadline of 0 s, two more one of
    0.3 s."""
    rng = np.random.default_rng(SEED + 17)
    lens, news = rng.integers(64, 513, size=32), rng.integers(16, 49, 32)
    subs = []
    for i in range(32):
        kw = dict(max_new_tokens=int(news[i]),
                  tenant=("interactive", "batch")[i % 2])
        if i % 5 == 4:
            kw["deadline_s"] = 0.0
        elif i in (7, 16):
            kw["deadline_s"] = 0.3
        subs.append((rng.integers(0, vocab, size=int(lens[i])).tolist(),
                     kw))
    return subs


def chaos_full_width(LLMEngine, build, dev, card, cfg, params):
    """(r1): Llama-3-8B, bf16, mega decode at 8 slots, a 4 GiB swap tier
    with async offload over a pool of 2/5 of the working set, admission
    control (a 6-deep queue, per-tenant buckets of 1500 tokens/s and a
    2000-token burst on a clock that advances 0.1 s a step, so the same
    requests shed on every run) and ``FaultInjector(R_SCHEDULE)`` under
    ``ResilientEngine``: 32 submissions, two a step; the newest queued
    request cancelled at step 6 and a request whose call is in flight at
    step 10 (or the first step after with such a target). The ledger is
    checked at every step; at the end every minted id has one terminal
    reason, every fault fired, 3 recoveries, each stream equals its
    result, the pool is free, the swap tier empty and nothing in flight.
    The same submissions then run with no injector, for tokens/s."""
    from paddle_tpu_torch.distributed.resilience import FaultInjector
    from paddle_tpu_torch.serving import (AdmissionConfig,
                                          AdmissionController,
                                          ResilientEngine)
    subs = r1_requests(cfg.vocab_size)
    per_req = -(-(512 + 48) // 64)
    pool = int(8 * per_req / 2.5)
    res = {"pool_blocks": pool, "working_set_blocks": 8 * per_req}
    launches = {}
    for label, schedule in (("chaos", R_SCHEDULE), ("no_faults", None)):
        clock = [0.0]
        ctl = AdmissionController(
            AdmissionConfig(max_queue=6, rate_tokens_per_s=1500.0,
                            burst_tokens=2000.0), now_fn=lambda: clock[0])
        inj = FaultInjector(schedule) if schedule else None
        eng = LLMEngine(params, cfg, num_blocks=pool, seed=SEED,
                        device=dev, admission=ctl, injector=inj,
                        **R1_ENGINE)
        reng = ResilientEngine(eng)
        cancelled = {}

        def cancel_queued(eng=eng, cancelled=cancelled):
            if not eng.queue:
                return False
            cancelled["queued"] = eng.queue[-1].req_id
            eng.cancel_request(cancelled["queued"])

        def cancel_in_flight(eng=eng, cancelled=cancelled):
            rec = eng._inflight
            live = [r for s, r in (rec["snapshot"] if rec else [])
                    if eng.slot_req[s] is not None
                    and eng.slot_req[s].req_id == r]
            if not live:
                return False
            cancelled["in_flight"] = live[0]
            eng.cancel_request(live[0])

        build.launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, steps, ledgers, t_end, t_crash = drive_chaos(
            eng, reng, subs, 2, {6: cancel_queued, 10: cancel_in_flight},
            clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"r1_{label}"] = dict(build.launch_counts)
        reasons = eng.finish_reasons
        streams = streams_of(steps)
        bad = [r for r in eng.results if streams.get(r, []) !=
               eng.results[r]]
        a = eng.block_accounting()
        if set(reasons) != set(ids) or set(reasons.values()) - TERMINAL \
                or bad or a["free"] != a["total"] or a["in_flight"] \
                or eng.swap_pool.bytes_used or len(eng.swap_pool) \
                or eng.offload.held_blocks \
                or any(reasons[r] != "client_disconnected"
                       for r in cancelled.values()):
            raise AssertionError(
                f"(r1) {label}: reasons {dict(Counter(reasons.values()))} "
                f"for {len(ids)} ids, streams unequal {bad}, ledger {a}, "
                f"swap {eng.swap_pool.bytes_used} B, cancelled "
                f"{cancelled}")
        if inj is not None and (inj.pending or reng.recoveries != R_CRASHES):
            raise AssertionError(f"(r1): faults not fired {inj.pending}, "
                                 f"fired {inj.fired}, recoveries "
                                 f"{reng.recoveries}")
        mega_only(eng, f"(r1) {label}")
        n_tok = sum(len(v) for v in streams.values())
        # seconds from each recovered crash to the next step that emitted
        to_token = []
        for idx, t in t_crash:
            nxt = next((t_end[i] for i in range(idx, len(steps))
                        if steps[i]), None)
            to_token.append(None if nxt is None else nxt - t)
        res[label] = {
            "minted": len(ids), "finish_reasons": dict(Counter(
                reasons.values())),
            "sheds": dict(ctl.sheds), "cancelled": cancelled,
            "recoveries": reng.recoveries,
            "fired": inj.fired if inj is not None else [],
            "crash_to_next_token_s": to_token, "steps": len(steps),
            "output_tokens": n_tok, "wall_s": wall,
            "output_tok_per_s": n_tok / wall,
            "swap_restores": eng.offload.prefetch_hits + eng.offload.stalls,
            "swap_fallbacks": eng.swap_fallbacks,
            "max_squeezed": max(x["squeezed"] for x in ledgers),
            "readbacks": dict(eng.readbacks), "launches": launches[
                f"r1_{label}"]}
        log(f"  (r1) {label}: {res[label]}; card: {card}")
        del eng, reng, cancel_queued, cancel_in_flight
        free_memory()
    return res, launches


def r2_requests(vocab):
    """(r2)'s 14 submissions: prompts of 16-60 tokens and 10-15 new
    tokens from ``numpy.random.default_rng(SEED + 19)`` (lengths first);
    every 4th has a deadline of 0 s; every 5th of the rest samples with
    ``top_k=1``: its stream is the greedy one on any device, but its
    waves take the normal decode path, so readbacks happen there (a
    greedy self-draft engine otherwise runs only spec waves)."""
    rng = np.random.default_rng(SEED + 19)
    lens, news = rng.integers(16, 61, size=14), rng.integers(10, 16, 14)
    subs = []
    for i in range(14):
        kw = dict(max_new_tokens=int(news[i]))
        if i % 4 == 3:
            kw["deadline_s"] = 0.0
        elif i % 5 == 4:
            kw.update(temperature=0.7, top_k=1)
        subs.append((rng.integers(0, vocab, size=int(lens[i])).tolist(),
                     kw))
    return subs


def chaos_cross_device(llama, LLMEngine, build, dev):
    """(r2): phase 5's cut model (f32) as a self-draft speculative engine
    on ragged decode, async offload over a 7-block pool, a 5-deep
    admission queue and ``FaultInjector(R_SCHEDULE +
    ",spec_verify_fail@6")`` under ``ResilientEngine``; (r2)'s
    submissions two a step, request 6 cancelled before step 5 and request
    2 before step 11. On the card and on the CPU: each step's emitted
    list, every ledger, ``finish_reasons``, ``recoveries`` and the
    results must be equal."""
    from paddle_tpu_torch.distributed.resilience import FaultInjector
    from paddle_tpu_torch.serving import AdmissionConfig, ResilientEngine
    cfg, base = cut_model(llama)
    subs = r2_requests(cfg.vocab_size)
    runs = {}
    launches = {}
    for where in (str(dev), "cpu"):
        params = tree_to(base, where)
        inj = FaultInjector(R_SCHEDULE + ",spec_verify_fail@6")
        eng = LLMEngine(params, cfg, draft_params=params, draft_config=cfg,
                        admission=AdmissionConfig(max_queue=5),
                        injector=inj, device=where, seed=SEED, **R2_ENGINE)
        reng = ResilientEngine(eng)
        acts = {5: lambda: eng.cancel_request(6),
                11: lambda: eng.cancel_request(2)}
        build.launch_counts.clear()
        t0 = time.perf_counter()
        ids, steps, ledgers, _, _ = drive_chaos(eng, reng, subs, 2, acts)
        runs[where] = (steps, ledgers, dict(eng.finish_reasons),
                       reng.recoveries, dict(eng.results), inj.fired)
        if where != "cpu":
            torch.cuda.synchronize()
            launches["r2_card"] = dict(build.launch_counts)
        log(f"  (r2) {where}: {len(steps)} steps, recoveries "
            f"{reng.recoveries}, fired {inj.fired}, pending {inj.pending}, "
            f"reasons {dict(Counter(eng.finish_reasons.values()))}, spec "
            f"waves {eng.spec_waves}, decode paths "
            f"{dict(eng.decode_paths)}, cancel no-ops {eng.cancel_noops} "
            f"({time.perf_counter() - t0:.1f} s)")
        del params, eng, reng
    card_run, cpu_run = runs[str(dev)], runs["cpu"]
    names = ("steps", "ledgers", "finish_reasons", "recoveries", "results",
             "fired")
    unequal = [n for n, a, b in zip(names, card_run, cpu_run) if a != b]
    if unequal:
        raise AssertionError(f"(r2) card and CPU differ in {unequal}")
    steps, _, reasons, recoveries, results, fired = card_run
    if streams_of(steps) != {r: t for r, t in results.items() if t} \
            or set(reasons.values()) - TERMINAL or not recoveries:
        raise AssertionError(f"(r2): reasons {reasons}, recoveries "
                             f"{recoveries}")
    return {"steps": len(steps), "recoveries": recoveries, "fired": fired,
            "finish_reasons": dict(Counter(reasons.values())),
            "card_equals_cpu": True}, launches


def bucketed_streams(llama, LLMEngine, dev, kv_dtype):
    """Phase 5's two prompts through the cut model (f32): bucketed on the
    card, bucketed on the CPU and ragged on the card must emit equal
    greedy streams (``kv_dtype="int8"``: int8 pools)."""
    cfg, base = cut_model(llama)
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (130, 200)]
    streams = {}
    for where, kernel in ((str(dev), "bucketed"), ("cpu", "bucketed"),
                          (str(dev), "ragged")):
        params = tree_to(base, where)
        eng = LLMEngine(params, cfg, max_slots=2, block_size=64,
                        max_model_len=512, prompt_buckets=[256],
                        decode_steps=4, decode_kernel=kernel,
                        kv_dtype=kv_dtype, device=where)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        out = eng.run()
        streams[f"{kernel}_{where}"] = [out[i] for i in ids]
        del params, eng
    if len({str(v) for v in streams.values()}) != 1:
        raise AssertionError(f"(r3) f32 streams differ ({kv_dtype}): "
                             f"{streams}")
    return streams[f"bucketed_{dev}"]


def bucketed_decode(llama, LLMEngine, build, dev, card, cfg8, params8,
                    serving, bf16_streams):
    """(r3): phase 4's mix (16 requests, 64 new tokens) through
    ``decode_kernel="bucketed"`` at 8 slots on Llama-3-8B's bf16 weights,
    as ``serve`` runs it (tokens/s, chained step time, TTFT, a traced
    decode call), beside phase 4's ragged numbers from this same call,
    the KV bytes a call of each and the first stream divergence; then the
    f32 cut model's streams, bucketed on the card and the CPU and ragged
    on the card, with the model's own and with int8 pools."""
    launches = {}
    launches["r3_bucketed"], summary, streams, _ = serve(
        LLMEngine, build, dev, card, cfg8, params8, serving_mix(cfg8, 16),
        max_slots=8, decode_kernel="bucketed")
    keys = ("output_tok_per_s", "median_decode_step_ms", "ttft_p95_s",
            "kv_bytes_per_call", "gathered_bytes_per_call", "readbacks")
    res = {"bucketed_8_slots": {k: summary[k] for k in keys + (
        "decode_paths",)}, "ragged_8_slots": {k: serving[k] for k in keys}}
    for name, src in (("bucketed_8_slots", summary),
                      ("ragged_8_slots", serving)):
        tr = src["traced_decode_call"] or {}
        res[name]["traced_decode_call"] = {
            k: tr.get(k) for k in ("device_busy_share", "launches_per_step",
                                   "wall_ms", "top_kernels_ms")}
    res["first_divergence_vs_ragged"] = first_divergence(streams,
                                                         bf16_streams)
    log(f"  (r3) bucketed vs ragged at 8 slots: {json.dumps(res)}; card: "
        f"{card}")
    free_memory()
    res["f32_streams"] = {kv or "model_dtype": bucketed_streams(
        llama, LLMEngine, dev, kv) for kv in (None, "int8")}
    log(f"  (r3) f32 cut model: bucketed card = bucketed CPU = ragged card, "
        f"model-dtype and int8 pools")
    return res, launches


def serving_resilience(llama, LLMEngine, build, dev, card, cfg8, params8,
                       serving, bf16_streams):
    """Phases (r1)-(r3) on phase 4's weights. Returns their numbers and
    the kernels' launches in each run."""
    log("phase (r1): chaos at full width — Llama-3-8B, mega at 8 slots, "
        "admission, deadlines, cancels, the fault injector")
    res, launches = {}, {}
    res["r1"], more = chaos_full_width(LLMEngine, build, dev, card, cfg8,
                                       params8)
    launches.update(more)
    log("phase (r2): card against CPU under chaos (phase 5's cut model, "
        "self-draft spec on ragged)")
    res["r2"], more = chaos_cross_device(llama, LLMEngine, build, dev)
    launches.update(more)
    free_memory()
    log("phase (r3): the bucketed dense-gather decode")
    res["r3"], more = bucketed_decode(llama, LLMEngine, build, dev, card,
                                      cfg8, params8, serving, bf16_streams)
    launches.update(more)
    free_memory()
    return res, launches


# ---------------------------------------------------------------------------
# phases (o1)-(o3): the observability core on the serving path
# ---------------------------------------------------------------------------
# what a full-width serving run must move ((o1)): counters and histogram
# counts above zero, gauges above zero, and gauges that must be set (0 is a
# fair reading for them at the end of a drained run)
O1_MOVED = ("serving_admissions_total", "serving_tokens_total",
            "serving_requests_finished_total", "serving_decode_kernel_total",
            "serving_decode_recompiles_total",
            "serving_request_traces_total", "serving_request_exemplars_total",
            "serving_ttft_seconds_count", "serving_tpot_seconds_count",
            "serving_step_seconds_count", "serving_tokens_per_second_count",
            "serving_request_queue_seconds_count", "serving_decode_variants",
            "serving_decode_prefix_bucket", "serving_decode_kv_read_bytes",
            "serving_kv_pool_blocks", "serving_mfu", "hbm_used_bytes",
            "hbm_peak_bytes")
O1_SET = ("serving_queue_depth", "serving_active_slots",
          "serving_kv_pool_used_blocks", "serving_slo_ttft_attainment",
          "serving_slo_tpot_attainment")


def obs_reset(obs):
    obs.get_registry().reset()
    obs.get_tracer().clear()
    obs.flight_recorder.get_recorder().clear()
    obs.request_trace.get_request_tracer().clear()
    obs.request_trace.get_exemplar_store().clear()
    obs.numerics.clear()


def prometheus_values(text):
    """{sample name: sum over its label sets} of a Prometheus page."""
    vals = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        name = name_labels.split("{", 1)[0]
        vals[name] = vals.get(name, 0.0) + float(value)
    return vals


def obs_serve(LLMEngine, build, dev, card, cfg, params, kernel, obs):
    """(o1) for one path: phase 4's 16-request mix through ``kernel`` at 8
    slots with observability on, through ``serve`` (its checks, its
    numbers). Every decode step is held to this script's own FLOP count
    (the engine's count equal, ``serving_mfu`` equal to it over the
    step's ``serving_step_seconds`` observation within 1%, in (0, 1]) and
    the host time ``step()`` spends around ``_step_inner`` (its
    telemetry) recorded, the HBM gauges to ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated`` at the step's end; each request's timeline
    runs queued -> admitted -> prefill -> first_token -> decode... ->
    finish."""
    reg = obs.get_registry()
    step_hist = reg.histogram("serving_step_seconds").labels()
    mfu = reg.gauge("serving_mfu").labels()
    used, peak = reg.gauge("hbm_used_bytes").labels(), \
        reg.gauge("hbm_peak_bytes").labels()
    rec = {"mfu": [], "hbm_mismatch": [], "wrapper_us": []}

    def hook(eng):
        inner_step, inner_dispatch = eng.step, eng._dispatch_decode
        step_inner = eng._step_inner
        walk, inner_s = [], []

        def timed_inner():
            t0 = time.perf_counter()
            out = step_inner()
            inner_s.append(time.perf_counter() - t0)
            return out

        def dispatch(active):
            prev = eng._inflight
            snap = ({s for s, _ in prev["snapshot"]} if prev is not None
                    else set())
            walk[:] = [int(eng.lengths[i])
                       + (eng.decode_steps if i in snap else 0)
                       for i in active]
            return inner_dispatch(active)

        def step():
            walk.clear()
            s0 = step_hist.sum
            t0 = time.perf_counter()
            out = inner_step()
            # the host time step() spends around _step_inner: its
            # telemetry (spans, TTFT loop, gauges, SLO and HBM reads)
            rec["wrapper_us"].append(
                (time.perf_counter() - t0 - inner_s[-1]) * 1e6)
            dt = step_hist.sum - s0
            if eng._last_decode_flops:
                rec["mfu"].append((eng._last_decode_flops,
                                   analytic_decode_flops(
                                       cfg, eng.N, eng.decode_steps, walk,
                                       eng.bs), dt, mfu.value))
            got = (used.value, peak.value)
            want = (torch.cuda.memory_allocated(dev),
                    torch.cuda.max_memory_allocated(dev))
            if got != want:
                rec["hbm_mismatch"].append((got, want))
            return out

        eng._dispatch_decode = dispatch
        eng._step_inner = timed_inner
        eng.step = step

    launches, summary, _streams, _ = serve(
        LLMEngine, build, dev, card, cfg, params, serving_mix(cfg, 16),
        max_slots=8, decode_kernel=kernel, trace=False, hook=hook)
    if not rec["mfu"]:
        raise AssertionError(f"(o1) {kernel}: no decode step set serving_mfu")
    worst = 0.0
    for flops, want, dt, m in rec["mfu"]:
        if flops != want:
            raise AssertionError(f"(o1) {kernel}: the engine counted {flops}"
                                 f" FLOPs, this script {want}")
        ref = want / (dt * BF16_FLOPS)
        worst = max(worst, abs(m - ref) / ref)
        if not 0 < m <= 1 or abs(m - ref) > 0.01 * ref:
            raise AssertionError(f"(o1) {kernel}: serving_mfu {m} against "
                                 f"{ref} ({want} FLOPs in {dt} s)")
    if rec["hbm_mismatch"]:
        raise AssertionError(f"(o1) {kernel}: HBM gauges (used, peak) "
                             f"{rec['hbm_mismatch'][:3]} against torch's")
    tracer = obs.request_trace.get_request_tracer()
    for rid in range(16):
        kinds = [e["kind"] for e in tracer.get(rid)["events"]]
        if kinds[:4] != ["queued", "admitted", "prefill", "first_token"] \
                or kinds[-1] != "finish" \
                or set(kinds[4:-1]) != {"decode"}:
            raise AssertionError(f"(o1) {kernel}: request {rid}'s timeline "
                                 f"{kinds}")
    mfus = [m for *_x, m in rec["mfu"]]
    summary["mfu_median"] = float(np.median(mfus))
    summary["mfu_max"] = max(mfus)
    summary["mfu_steps_checked"] = len(mfus)
    summary["mfu_worst_rel_diff"] = worst
    summary["step_wrapper_us_median"] = float(np.median(rec["wrapper_us"]))
    summary["step_wrapper_us_max"] = max(rec["wrapper_us"])
    return launches, summary


def obs_scrape(obs, kernels):
    """(o1) after both runs: ``/metrics`` of a ``MetricsServer(port=0)``
    (every name of O1_MOVED documented and above zero, O1_SET present),
    ``/trace.json`` (every prefill, decode and readback span inside a
    ``serving.step`` of its thread) and ``/requests.json`` (the TTFT
    exemplars resolve to finished requests)."""
    import urllib.request
    from paddle_tpu_torch.observability.catalog import CATALOG

    srv = obs.MetricsServer(port=0)
    try:
        def get(path):
            url = f"http://127.0.0.1:{srv.port}{path}"
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.read().decode()

        text = get("/metrics")
        trace = json.loads(get("/trace.json"))
        reqs = json.loads(get("/requests.json"))
    finally:
        srv.close()
    vals = prometheus_values(text)
    bad = []
    for name in O1_MOVED + O1_SET:
        base = name[:-len("_count")] if name.endswith("_count") else name
        if base not in CATALOG or f"# HELP {base} " not in text:
            bad.append((name, "undocumented"))
        elif name not in vals:
            bad.append((name, "absent"))
        elif name in O1_MOVED and not vals[name] > 0:
            bad.append((name, vals[name]))
    for k in kernels:
        if f'serving_decode_kernel_total{{path="{k}"}}' not in text:
            bad.append((k, "path not counted"))
    if bad:
        raise AssertionError(f"(o1) /metrics: {bad}")
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    steps = {}
    for e in spans:
        if e["name"] == "serving.step":
            steps.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    counts = Counter()
    for e in spans:
        if e["name"] not in ("serving.prefill", "serving.decode",
                             "serving.readback"):
            continue
        counts[e["name"]] += 1
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        if not any(a - 1e-3 <= t0 and t1 <= b + 1e-3
                   for a, b in steps.get(e["tid"], ())):
            raise AssertionError(f"(o1) {e['name']} at {t0} us is inside "
                                 f"no serving.step")
    if min(counts.get(n, 0) for n in ("serving.prefill", "serving.decode",
                                      "serving.readback")) < 1:
        raise AssertionError(f"(o1) nested spans {dict(counts)}")
    tracer = obs.request_trace.get_request_tracer()
    exs = reqs["exemplars"].get("serving_ttft_seconds", [])
    for ex in exs:
        doc = tracer.get(ex["request_id"])
        if doc is None or not doc["finished"] or "first_token" not in [
                e["kind"] for e in doc["events"]]:
            raise AssertionError(f"(o1) exemplar {ex} resolves to {doc}")
    if not exs or "p99" not in reqs["exemplar_quantiles"].get(
            "serving_ttft_seconds", {}):
        raise AssertionError(f"(o1) no TTFT exemplars: {reqs['exemplars']}")
    return {"metrics_bytes": len(text), "span_counts": dict(counts),
            "serving_steps": sum(len(v) for v in steps.values()),
            "ttft_exemplars": len(exs),
            "ttft_p99_exemplar": reqs["exemplar_quantiles"][
                "serving_ttft_seconds"]["p99"]["request_id"]}


def plain_kv_quant_error(tensors):
    """This script's recompute of the kv_int8 probe: each tensor quantized
    per entry (one f32 scale per [..., D] row, absmax / 127, values
    rounded and clipped to +-127), the relative RMS reconstruction error
    over all of them, summed in f64."""
    num = den = None
    for x in tensors:
        xf = x.float()
        scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
        q = torch.round(xf / scale.clamp_min(1e-9)).clamp(-127, 127)
        d = (xf - q * scale).double()
        n, m = (d * d).sum(), (xf.double() ** 2).sum()
        num, den = (n, m) if num is None else (num + n, den + m)
    return math.sqrt(float(num) / max(float(den), 1e-30))


def obs_chained_numerics(LLMEngine, build, dev, cfg, params, obs):
    """(o2): phase 4's weights with int8 pools, mega at 4 slots, two
    chained ``eng.step()`` calls under ``set_sync_debug_mode("error")``
    with observability and FLAGS_obs_numerics on ((p1)'s check with the
    telemetry added). Then the kv_int8 gauge against this script's
    recompute on the same K/V (captured as the probes saw them), step
    time with the probes on and off, and a post-mortem holding the run's
    flight events and a metrics snapshot. The kernels' launches are those
    of the whole run."""
    nm = obs.numerics
    shipped, pending = [], {}
    add, ship = nm.QuantErrorProbe.add, nm.QuantErrorProbe.ship

    def add_capturing(self, pre, q, scale, axis):
        pending.setdefault(id(self), []).append(
            (pre.detach().clone(), q.clone(), scale.clone()))
        return add(self, pre, q, scale, axis)

    def ship_capturing(self, site):
        shipped.append(pending.pop(id(self), []))
        return ship(self, site)

    nm.QuantErrorProbe.add = add_capturing
    nm.QuantErrorProbe.ship = ship_capturing
    res = {}
    try:
        nm.enable()
        eng = LLMEngine(params, cfg, max_slots=4, **SERVE_ENGINE,
                        decode_kernel="mega", kv_dtype="int8", seed=SEED,
                        device=dev)
        build.launch_counts.clear()
        ids = [eng.add_request(p[:128], max_new_tokens=512)
               for p in serving_mix(cfg, 4)]
        eng.step()
        eng.step()
        process = eng._process

        def process_unchecked(rec):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return process(rec)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        eng._process = process_unchecked
        for _ in range(2):
            if eng._inflight is None or not eng._spec_safe():
                raise AssertionError("(o2) the step is not chained")
            before = dict(eng.readbacks)
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if eng.readbacks["chained"] != before.get("chained", 0) + 1:
                raise AssertionError(f"(o2) readbacks {before} -> "
                                     f"{dict(eng.readbacks)}")
        eng._process = process
        nm.flush()
        got = obs.get_registry().gauge("numerics_quant_error").labels(
            site="kv_int8").value
        want = plain_kv_quant_error([pre for pre, _q, _s in shipped[-1]])
        rel = abs(got - want) / want
        if not 0 < got < 0.05 or rel > 1e-5:
            raise AssertionError(f"(o2) kv_int8 quant error {got} against "
                                 f"the recompute's {want} (rel {rel})")
        res.update(sync_free_steps=2, kv_int8_quant_error=got,
                   recompute=want, rel_diff=rel, landings=len(nm.entries()),
                   probes_shipped=len(shipped))
        nm.QuantErrorProbe.add, nm.QuantErrorProbe.ship = add, ship
        # the probe's own device time on the last decode writeback's ring
        # (what it adds to a decode call): its reductions, no landing
        ring = shipped[-1]

        def probe(*_):
            p = nm.QuantErrorProbe()
            for pre, q, scale in ring:
                p.add(pre, q, scale, -1)

        res["probe_ms_per_decode_call"] = time_ms(probe, 20)
        res["probe_ring_shape"] = list(ring[0][0].shape)
        shipped.clear()
        # step time with the probes on, then off (steady chained steps)
        for label, on in (("step_ms_numerics_on", True),
                          ("step_ms_numerics_off", False)):
            (nm.enable if on else nm.disable)()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                eng.step()
                ts.append((time.perf_counter() - t0) * 1e3)
            res[label] = float(np.median(ts))
        for rid in ids:               # the requests end here, cancelled
            eng.cancel_request(rid)
        eng.step()
        eng.run()
        if set(eng.finish_reasons.values()) != {"client_disconnected"}:
            raise AssertionError(f"(o2) {eng.finish_reasons}")
        res["launches"] = dict(build.launch_counts)
        pm = obs.flight_recorder.get_recorder().postmortem(trigger="manual")
        kinds = {e["kind"] for e in pm["events"]}
        names = {f["name"] for f in pm["metrics"]["metrics"]}
        if not {"flag_change", "client_disconnected"} <= kinds \
                or not {"numerics_quant_error",
                        "serving_tokens_total"} <= names \
                or "numerics" not in pm:
            raise AssertionError(f"(o2) post-mortem events {sorted(kinds)}")
        res["postmortem_events"] = sorted(kinds)
        res["postmortem_metric_families"] = len(names)
    finally:
        nm.QuantErrorProbe.add, nm.QuantErrorProbe.ship = add, ship
        nm.disable()
    return res


def obs_profile_window(LLMEngine, build, dev, cfg, params, obs):
    """(o3): a ``profiling.request_capture(steps=2)`` window armed during
    a mega run at 8 slots (phase 4's mix, its first 8 requests): the trace
    file written, B5's kernel among its device events inside a
    ``serving.step`` range, ``obs_profile_captures_total`` 1 and the
    ``profile_capture`` flight event there; the window's busy share (of
    its wall time, and of the span from its first device op to its last)
    and its top device ops by time."""
    import tempfile
    reg = obs.get_registry()
    reg.counter("obs_profile_captures_total").reset()
    eng = LLMEngine(params, cfg, max_slots=8, **SERVE_ENGINE,
                    decode_kernel="mega", seed=SEED, device=dev)
    for p in serving_mix(cfg, 8):
        eng.add_request(p, max_new_tokens=64)
    eng.step()
    eng.step()
    with tempfile.TemporaryDirectory(prefix="ptt_obs_capture_") as d:
        if not obs.profiling.request_capture(steps=2, out_dir=d)["ok"]:
            raise AssertionError("(o3) the capture did not arm")
        build.launch_counts.clear()
        for _ in range(3):             # start, count down, stop
            eng.step()
        launches = dict(build.launch_counts)
        ctl = obs.profiling.get_profile_controller()
        last = ctl.status()["last_capture"]
        if not last or not last["ok"] or not os.path.getsize(last["trace"]):
            raise AssertionError(f"(o3) capture {last}")
        with open(last["trace"]) as f:
            events = json.load(f)["traceEvents"]
        trace_mb = os.path.getsize(last["trace"]) / 2**20
    eng.run()
    kern = [e for e in events if e.get("cat") == "kernel"]
    b5 = [e for e in kern if "mega_decode_kernel" in e.get("name", "")]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and e.get("name") == "serving.step"]
    inside = sum(any(a <= k["ts"] and k["ts"] + k["dur"] <= b
                     for a, b in ranges) for k in b5)
    how = "gpu_user_annotation"
    if not inside:
        # no device-side ranges: a B5 launch inside a host serving.step
        cpu = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation"
               and e.get("name") == "serving.step"]
        corr = {k.get("args", {}).get("correlation") for k in b5}
        inside = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                     and e.get("args", {}).get("correlation") in corr
                     and any(a <= e["ts"] <= b for a, b in cpu))
        how = "host launch inside the host range"
    if not b5 or not inside:
        raise AssertionError(f"(o3) {len(b5)} B5 kernels, {len(ranges)} "
                             f"serving.step device ranges, {inside} inside")
    if reg.counter("obs_profile_captures_total").labels().value != 1:
        raise AssertionError("(o3) obs_profile_captures_total is not 1")
    evs = [e for e in obs.flight_recorder.get_recorder().events()
           if e["kind"] == "profile_capture"]
    if len(evs) != 1:
        raise AssertionError(f"(o3) profile_capture events {evs}")
    # device work: kernels, copies and memsets (the device-side
    # serving.* annotation ranges are not work)
    work = [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    wall_us = last["seconds"] * 1e6
    by_name = {}
    for e in work:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in work)
    busy, (s0, e0) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > e0:
            busy, s0, e0 = busy + e0 - s0, a, b
        else:
            e0 = max(e0, b)
    busy += e0 - s0
    span = max(b for _a, b in spans) - spans[0][0]
    return {"steps": 2, "trace_mb": trace_mb, "b5_kernels": len(b5),
            "b5_inside_serving_step": inside, "enclosed_by": how,
            "serving_step_device_ranges": len(ranges),
            "window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "device_span_ms": span / 1e3,
            "busy_share_of_device_span": busy / span,
            "device_events": len(work), "launches": launches,
            "top_device_ops_ms": [(name[:60], t / 1e3, n)
                                  for name, (t, n) in top]}


def observability_phases(LLMEngine, build, dev, card, cfg8, params8,
                         serving, tiers):
    """Phases (o1)-(o3) on phase 4's weights, observability on throughout
    and off again after. (o1)'s off figures are phase 4's ragged run and
    (p1)'s mega run at 8 slots in this process. Returns the numbers and
    the kernels' launches in each run."""
    import paddle_tpu_torch.observability as obs
    t0 = time.perf_counter()
    res, launches = {}, {}
    obs_reset(obs)
    obs.enable()
    try:
        log("phase (o1): Llama-3-8B through mega and ragged at 8 slots with "
            "observability on; /metrics, /trace.json, /requests.json")
        off = {"mega": tiers["p1"]["serve_mega_8_slots"], "ragged": serving}
        o1 = {}
        for kernel in ("mega", "ragged"):
            launches[f"o1_{kernel}_8"], on = obs_serve(
                LLMEngine, build, dev, card, cfg8, params8, kernel, obs)
            o1[kernel] = {
                "tok_per_s_on": on["output_tok_per_s"],
                "tok_per_s_off": off[kernel]["output_tok_per_s"],
                "median_step_ms_on": on["median_decode_step_ms"],
                "median_step_ms_off": off[kernel]["median_decode_step_ms"],
                "step_cost_share": on["median_decode_step_ms"]
                / off[kernel]["median_decode_step_ms"] - 1,
                "readbacks": on["readbacks"], "launches": on["launches"],
                **{k: on[k] for k in ("mfu_median", "mfu_max",
                                      "mfu_steps_checked",
                                      "mfu_worst_rel_diff",
                                      "step_wrapper_us_median",
                                      "step_wrapper_us_max")}}
            log(f"  {kernel}: {o1[kernel]}")
            free_memory()
        o1["scrape"] = obs_scrape(obs, ("mega", "ragged"))
        log(f"  scrape: {o1['scrape']}")
        res["o1"] = o1
        log("phase (o2): int8 pools, mega at 4 slots: chained steps with "
            "the numerics probes on under sync debug mode")
        res["o2"] = obs_chained_numerics(LLMEngine, build, dev, cfg8, params8,
                                         obs)
        launches["o2_mega_4_int8"] = res["o2"]["launches"]
        log(f"  {res['o2']}")
        free_memory()
        log("phase (o3): a torch.profiler window of 2 steps, mega at 8 "
            "slots")
        res["o3"] = obs_profile_window(LLMEngine, build, dev, cfg8, params8,
                                       obs)
        launches["o3_mega_8_window"] = res["o3"]["launches"]
        log(f"  {res['o3']}")
        free_memory()
    finally:
        obs.disable()
        obs_reset(obs)
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res, launches


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
    cfg, base = cut_model(llama)
    dcfg = llama.draft_config(cfg, num_layers=1)
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


# (s3)'s greedy tokens a request, few enough for the whole run to fit
S3_NEW = 32


def serve_spec(LLMEngine, teng, build, dev, card, cfg, params, dcfg, dparams,
               prompts, max_slots, decode_kernel, label, want=None):
    """(s3): ``LLMEngine`` on Llama-3-8B with the draft ``dcfg``/
    ``dparams`` (spec_tokens=4) serving ``prompts`` (``S3_NEW`` greedy
    tokens each)
    through ``decode_kernel``: every decode wave speculates (no plain
    decode call, no counted fallback); the mega draft launches B5's
    multi-step form once a wave and never the single-step form. The run's
    numbers (tokens/s from this run, which has no timer in it), then the
    same requests again with the prefill, draft and verify calls timed
    (each ended by a synchronize, which keeps the host from queueing the verify behind
    the draft, so that run's wall time is not reported), one spec wave
    traced, and the first divergence from ``want`` (the plain mega
    engine's streams, cut to ``S3_NEW`` tokens)."""
    eng = LLMEngine(params, cfg, max_slots=max_slots, block_size=64,
                    max_model_len=2048, prompt_buckets=[128, 512, 1024],
                    decode_steps=16, decode_kernel=decode_kernel, seed=SEED,
                    device=dev, draft_params=dparams, draft_config=dcfg,
                    spec_tokens=4)
    ids = [eng.add_request(p, max_new_tokens=S3_NEW) for p in prompts]
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
    if any(len(s) != S3_NEW or not all(0 <= t < cfg.vocab_size for t in s)
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
        eng.add_request(p, max_new_tokens=S3_NEW)
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
               first_divergence(streams, [w[:S3_NEW] for w in want])
               if want else None)}
    # one steady spec wave traced: admit a wave and run its first spec
    # wave, then trace the next
    for p in prompts[:eng.N]:
        eng.add_request(p, max_new_tokens=16)
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
        f["floor_bound_ms"] = (floor + f["bound_ms"] if floor is not None
                               else None)
        f["share_of_floor_bound"] = (f["floor_bound_ms"] / device_ms
                                     if device_ms and f["floor_bound_ms"]
                                     else None)
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
    b8["share_of_floor_bound_cold"] = (
        b8["floor_bound_ms"] / b8["device_cold_ms"]
        if b8["device_cold_ms"] and b8["floor_bound_ms"] else None)
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
              lr=3e-5, hold=None):
    """``moe.train_step`` on DeepSeekMoE-16B's widths (``deepseek_moe_16b``:
    hidden 2048, 16 heads of 128, 64 routed experts of 1408, top-6, 2
    shared, vocab 102400, layer 0 dense) cut to ``layers`` layers, as
    bench.py's bench_moe runs it: batch 4 x seq 2048, adafactor, bf16
    params, remat "outs", the fused dispatch (named: "auto" measures the
    forms); random weights and one fixed token batch from
    seeded generators on the card; ``warmup`` steps, then ``steps`` timed
    ones, at lr 3e-5 with adafactor's floor lifted (as phase 8). Each step
    must launch, per MoE layer, B9 twice (forward and recompute), gmm four
    times (the down projection in the forward and in the recompute, which
    runs to the routed FFN's end since "outs" keeps its [T, h] output and
    no longer the down GEMM's; its two dgrads) and tgmm twice, and per
    layer B1, B2 and B3 once; the losses must be finite and fall. One more
    step is traced. With ``hold`` (a dict), the state, the tokens, the
    config and the step function are left in it for the phases that
    follow."""
    import dataclasses
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), num_layers=layers,
                              remat=True, remat_policy="outs",
                              dispatch="fused")
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
            "gather_gmm": 2 * n_moe, "gmm": 4 * n_moe, "tgmm": 2 * n_moe}
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
           "adafactor, bf16 params, dispatch fused",
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
    if hold is not None:
        hold.update(state=[state], tokens=tokens, cfg=cfg, lr=lr)
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
def phase14_config(moe, dispatch="fused"):
    """Phase 14's small MoE (its docstring), the fused dispatch named
    ("auto" measures the forms on the card)."""
    return moe.MoEConfig(vocab_size=512, hidden_size=256,
                         moe_intermediate_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=4, head_dim=64,
                         num_experts=16, top_k=4, n_shared_experts=2,
                         first_dense_layers=1, max_seq_len=256,
                         dtype=torch.float32, remat=True,
                         remat_policy="outs", dispatch=dispatch)


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
    cfg = phase14_config(moe)
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
    scales) and the fused dispatch, batch 4 x 2048, random bf16
    weights and tokens from seeded generators: ``warmup`` then ``runs``
    timed forwards (no autograd), each launching B9's int8 branch and B10
    gmm once a MoE layer, then one more traced (device time by kernel
    bucket). Before, the logits of the bf16 and the int8 forward of the
    same weights cut to ``cmp_layers`` layers (both at that depth, so the
    bf16 model fits beside the int8 one) on the batch's first sequence:
    their relative error."""
    import dataclasses
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), num_layers=layers,
                              remat=False, expert_dtype="int8",
                              dispatch="fused")
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
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), max_seq_len=S,
                              dispatch="fused")
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


def serving_tiers(llama, LLMEngine, build, dev, card, cfg8, params8,
                  serving, bf16_streams):
    """Phases (p1)-(p4) on phase 4's weights: the chained dispatch under
    sync debug mode, phase 4's mix through mega at 8 slots beside phase
    4's ragged run, the shared-prefix and offload recipes, and the tiers
    card against CPU. Returns their numbers and the kernels' launches in
    each run."""
    log("phase (p1): chained decode — sync-free dispatch; phase 4's mix "
        "through mega at 8 slots")
    tiers = {"p1": chained_dispatch(LLMEngine, dev, cfg8, params8,
                                    serving_mix(cfg8, 8))}
    launches = {}
    launches["p1_mega_8"], mega8, m8_streams, _ = serve(
        LLMEngine, build, dev, card, cfg8, params8, serving_mix(cfg8, 16),
        max_slots=8, decode_kernel="mega", chained_trace=2)
    mega8["first_divergence_vs_ragged_8"] = first_divergence(m8_streams,
                                                            bf16_streams)
    STREAMS["p1_mega_8"] = m8_streams
    tiers["p1"]["serve_mega_8_slots"] = mega8
    tiers["p1"]["serve_ragged_8_slots"] = {k: serving[k] for k in (
        "output_tok_per_s", "median_decode_step_ms", "readbacks",
        "draining_syncs_per_call", "ttft_p95_s")}
    log(f"  phase 4's mix at 8 slots: mega {mega8['output_tok_per_s']:.1f} "
        f"tok/s (median step {mega8['median_decode_step_ms']:.2f} ms), "
        f"ragged {serving['output_tok_per_s']:.1f} "
        f"({serving['median_decode_step_ms']:.2f} ms); draining syncs a "
        f"call {mega8['draining_syncs_per_call']:.3f} and "
        f"{serving['draining_syncs_per_call']:.3f}")
    free_memory()
    log("phase (p2): shared prefix, Llama-3-8B, int8 pools, cache on vs off")
    tiers["p2"] = shared_prefix(LLMEngine, build, dev, card, cfg8, params8)
    for k in ("cache_on", "cache_off"):
        launches[f"p2_{k}"] = tiers["p2"][k]["launches"]
    free_memory()
    log("phase (p3): offload, Llama-3-8B, int8 pools, sync vs async")
    tiers["p3"] = offload_tiers(LLMEngine, build, dev, card, cfg8, params8)
    for k in ("sync", "async"):
        launches[f"p3_{k}"] = tiers["p3"][k]["launches"]
    free_memory()
    log("phase (p4): the tiers on the card against the CPU (phase 5's cut "
        "model)")
    tiers["p4"] = tiers_cross_device(llama, LLMEngine, dev)
    free_memory()
    return tiers, launches


def serving_only(llama, LLMEngine, build, dev, card) -> int:
    """``--serving``: phases 4 and 6(c) (the serving runs alone, no kernel
    checks), (p1)-(p4), (r1)-(r3) and (o1)-(o3), then their lines; no
    device line."""
    cfg8, params8, runs = serving_runs(llama, LLMEngine, build, dev, card)
    _, serving, bf16_streams, _ = runs["phase4_ragged_8"]
    tiers, tier_launches = serving_tiers(
        llama, LLMEngine, build, dev, card, cfg8, params8, serving,
        bf16_streams)
    resilience, r_launches = serving_resilience(
        llama, LLMEngine, build, dev, card, cfg8, params8, serving,
        bf16_streams)
    tier_launches.update(r_launches)
    observed, o_launches = observability_phases(
        LLMEngine, build, dev, card, cfg8, params8, serving, tiers)
    tier_launches.update(o_launches)
    fd, h_launches = front_door_phases(
        llama, LLMEngine, build, dev, card, cfg8, params8, tiers,
        runs["phase6c_ragged_4"][1])
    tier_launches.update(h_launches)
    log(f"serving: {json.dumps(serving)}")
    log(f"mega: {json.dumps(runs['phase6c_mega_4'][1])}")
    log(f"serving_tiers: {json.dumps(tiers)}")
    log(f"serving_resilience: {json.dumps(resilience)}")
    log(f"tier_launches: {json.dumps(tier_launches)}")
    log(json.dumps({"observability": observed}))
    log(json.dumps({"front_door": fd}))
    log(f"total {time.perf_counter() - T0:.1f} s")
    log(card)
    return 0


# ---------------------------------------------------------------------------
# phases (m1)-(m4): the rest of single-device MoE — the measured dispatch
# pick, the dense-base form, the tile-width autotuner, what remat "outs"
# keeps
# ---------------------------------------------------------------------------
# phase 12's routing shape: 4 x 2048 tokens of DeepSeekMoE-16B, top-6 of 64
# experts of 1408, hidden 2048
P12 = dict(T=8192, k=6, E=64, h=2048, f=1408)


def tile_autotune(tmdisp, tmf, dev):
    """(m3) ``gmm_autotune.get_tilings`` at phase 12's four grouped-GEMM
    call sites (the fused form's gate|up, variant "fused", and down
    projection over the padded layout of ``deepseek_routing``; the gmm
    form's two over the sorted rows), each pass (forward, dgrad, wgrad)
    timed at every candidate width by a measure that first holds the
    kernel's result at that width to its plain version (within 1e-2 of
    its largest magnitude, bf16) and then takes ``time_best``. The
    winners persist; a cleared cache answers from the file with no
    measurement. Returns each site's candidates' ms, winner and
    heuristic."""
    from paddle_tpu_torch.jit import cache as jcache
    from paddle_tpu_torch.kernels import gmm_autotune as ga
    d = deepseek_routing(tmdisp, tmf, dev)
    x, r, gs_pad, tok_pad, gid = (d[k] for k in ("x", "r", "gs_pad",
                                                 "tok_pad", "gid"))
    Wcat, Wd, E, f, h = d["Wcat"], d["ed"], d["E"], d["f"], d["h"]
    Ap, A = tok_pad.shape[0], r.tok.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 12)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    xs_pad, xs = x.index_select(0, tok_pad), x.index_select(0, r.tok)
    bf = torch.bfloat16
    sites = {}
    for name, variant, lhs, rhs, gs, full in (
            ("fused gate|up", "fused", xs_pad, Wcat, gs_pad, False),
            ("fused down", "gmm", rnd(Ap, f), Wd, gs_pad, False),
            ("gmm gate|up", "gmm", xs, Wcat, r.gs, True),
            ("gmm down", "gmm", rnd(A, f), Wd, r.gs, True)):
        grad = rnd(lhs.shape[0], rhs.shape[2])
        if variant == "fused":
            fwd = (lambda bn: tmf.gather_gmm(x, tok_pad, Wcat, gid, bn=bn),
                   lambda: tmf.gather_gmm_plain(x, tok_pad, Wcat, gid))
        else:
            fwd = (lambda bn, l=lhs, w=rhs, s=gs: tmdisp.gmm(l, w, s, bn=bn),
                   lambda l=lhs, w=rhs, s=gs: tmdisp.gmm_plain(l, w, s))
        passes = {
            "fwd": fwd,
            "dgrad": (lambda bn, gr=grad, w=rhs, s=gs: tmdisp.gmm(
                gr, w, s, transpose_rhs=True, bn=bn),
                lambda gr=grad, w=rhs, s=gs: tmdisp.gmm_plain(gr, w, s, True)),
            "wgrad": (lambda bn, l=lhs, gr=grad, s=gs: tmdisp.tgmm(
                l.t(), gr, s, out_dtype=bf, bn=bn),
                lambda l=lhs, gr=grad, s=gs: tmdisp.tgmm_plain(l.t(), gr, s))}
        rows, plains = [], {}

        def measure(pass_, tiling, passes=passes, rows=rows, plains=plains):
            kern, plain = passes[pass_]
            if pass_ not in plains:
                plains[pass_] = plain()
            err = rel_err(kern(tiling[2]), plains[pass_])
            if not err <= 1e-2:
                raise AssertionError(f"{pass_} at width {tiling[2]}: "
                                     f"relative error {err}")
            t = ga.time_best(lambda: kern(tiling[2]))
            rows.append({"pass": pass_, "bn": tiling[2], "ms": t * 1e3,
                         "rel_err": err})
            return t

        m, k, n = lhs.shape[0], lhs.shape[1], rhs.shape[2]
        key = (m, k, n, E, bf, full)
        heur = ga.heuristic_tilings(m, k, n)
        t0 = time.perf_counter()
        won = ga.get_tilings(*key, measure=measure, variant=variant)
        sites[name] = {
            "shape": f"[{m}, {k}] @ [{E}, {k}, {n}], {variant}, "
                     f"full_rows={full}",
            "key": key, "variant": variant, "candidates": rows,
            "heuristic": [t[2] for t in heur],
            "winner": [t[2] for t in won],
            "seconds": time.perf_counter() - t0}
        log(f"  (m3) {name}: {sites[name]}")
        del plains
    doc = jcache.load_json(ga.PERSIST_NAME, schema=ga.SCHEMA)
    if len(doc) != 4 or any(e["source"] != "measured" for e in doc.values()):
        raise AssertionError(f"persisted tilings {doc}")
    ga.clear()

    def boom(pass_, tiling):
        raise AssertionError("a persisted width was measured again")

    for name, site in sites.items():
        got = ga.get_tilings(*site["key"], measure=boom,
                             variant=site["variant"])
        if [t[2] for t in got] != site["winner"]:
            raise AssertionError(f"{name}: {got} read back, "
                                 f"{site['winner']} persisted")
        site["key"] = list(map(str, site["key"]))
    log(f"  (m3) the persisted file round-trips: {len(doc)} entries")
    return sites


def form_pick(tmdisp, dev):
    """(m1) ``pick_dispatch_form`` at phase 12's routing shape with the
    dense form admitted (``plan_dispatch`` gives Q = 896 and use_dense):
    each form's forward-plus-backward ms from ``_default_form_measure``
    (the sum-of-squares loss through ``fused_routing`` on
    ``make_moe_operands``, best of 3 after a warm call), the winner —
    what ``dispatch="auto"`` runs at this shape on this card; a second
    call measures nothing, and after ``clear_form_cache()`` the file
    answers the same winner with no measurement."""
    from paddle_tpu_torch.jit import cache as jcache
    T, k, E, h, f = (P12[n] for n in ("T", "k", "E", "h", "f"))
    plan = tmdisp.plan_dispatch(T, k, E, h)
    if not plan.use_dense:
        raise AssertionError(f"plan {plan}: the dense form is not admitted")
    runner = tmdisp._default_form_measure(T, k, E, h, f, torch.bfloat16)
    ms = {}

    def measure(form):
        t = runner(form)
        ms[form] = t * 1e3
        return t

    def boom(form):
        raise AssertionError("a cached dispatch form was measured again")

    def pick(fn):
        return tmdisp.pick_dispatch_form(T, k, E, h, f, torch.bfloat16,
                                         dense_ok=True, measure=fn)

    tmdisp.clear_form_cache()
    tmdisp.dense_paths.clear()
    t0 = time.perf_counter()
    winner = pick(measure)
    seconds = time.perf_counter() - t0
    dense_route = dict(tmdisp.dense_paths)
    if pick(boom) != winner:
        raise AssertionError("the in-process form cache answered otherwise")
    tmdisp.clear_form_cache()
    if pick(boom) != winner:
        raise AssertionError("the persisted form cache answered otherwise")
    doc = jcache.load_json("moe_dispatch_forms", schema=2)
    x, rw, eg, eu, ed = tmdisp.make_moe_operands(T, h, E, f, torch.bfloat16,
                                                 device=dev)
    ws = [t.requires_grad_(True) for t in (x, eg, eu, ed)]

    def dense_fwd_bwd():
        r = tmdisp.fused_routing(ws[0], rw, k)
        y = tmdisp.dropless_moe_ffn_dense(ws[0], r.weights, r.idx, *ws[1:],
                                          routing=r)
        return torch.autograd.grad(y.float().square().sum(), ws)

    dense_fwd_bwd()
    traced_dense = traced(dense_fwd_bwd, classify=kernel_category)
    del x, rw, eg, eu, ed, ws
    res = {"plan": {"Q": plan.Q, "use_dense": plan.use_dense},
           "fwd_bwd_ms": ms, "winner": winner, "seconds": seconds,
           "dense_route_while_measured": dense_route,
           "traced_dense_fwd_bwd": traced_dense, "persisted": doc,
           "dense_over_fused": ms.get("dense", math.nan) / ms["fused"],
           "gmm_over_fused": ms["gmm"] / ms["fused"]}
    log(f"  (m1) {res}")
    return res


def moe_phase12_forms(moe, llama, tmdisp, build, dev, card, hold, fused):
    """(m2), the step comparison of (m3) and (m4), on phase 12's state
    (``hold``) and beside its fused numbers (``fused``): (m2) 2 warm-up
    and 3 timed steps with ``dispatch="dense"`` (no B9 or B10 launch when
    no batch overflows; host syncs a step from ``dense_paths``; one step
    traced for its busy share); (m3) the fused step with the tuned widths
    against ``tile_width``'s (``FLAGS_moe_gmm_autotune`` off), 2 timed
    steps each in the order tuned, heuristic, heuristic, tuned after one
    warm step; (m4) what remat "outs" keeps a MoE layer (``moe.saved_probe``
    over one forward: no tensor with A_pad rows), the memory one forward
    holds under "outs" and "full", and the forward-plus-backward peak and
    step time of "outs" against "outs" keeping the down GEMM's [A_pad, h]
    output as it did before (its policy's operator list swapped back),
    2 timed steps each in the order now, before, before, now."""
    import dataclasses
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.optimizer.functional import tree_map
    cfg, tokens, lr = hold["cfg"], hold["tokens"], hold["lr"]
    n_moe = cfg.num_layers - cfg.first_dense_layers
    B, S = tokens.shape[0], tokens.shape[1] - 1
    fpt = moe.flops_per_token(cfg, S)

    def step_of(c):
        return lambda st: moe.train_step(st, tokens, c, optimizer="adafactor",
                                         lr=lr, adafactor_eps2=0.0)

    def steps(c, warmup, timed):
        """``run_steps`` on the held state, which goes back into ``hold``
        (no other reference to a state outlives the call: two states of
        this model do not fit beside a step)."""
        state, res = run_steps(build, step_of(c), hold["state"], warmup,
                               timed)
        hold["state"].append(state)
        return res

    out = {}
    cd = dataclasses.replace(cfg, dispatch="dense")
    tmdisp.dense_paths.clear()
    res = steps(cd, 2, 3)
    paths = dict(tmdisp.dense_paths)
    for i, n in enumerate(res["per_step"]):
        if any(n.get(kk) for kk in ("gather_gmm", "gmm", "tgmm")) and \
                paths.get("gmm", 0) == 0:
            raise AssertionError(f"dense step {i} launched {n}")
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"dense losses {res['losses']}")
    tok_s = B * S / (res["step_ms"] / 1e3)
    out["m2_dense_step"] = {
        "step_ms": res["step_ms"], "tokens_per_s": tok_s,
        "mfu": fpt * tok_s / BF16_FLOPS,
        "peak_mem_gib": res["peak_bytes"] / 2**30, "losses": res["losses"],
        "launches_per_step": res["per_step"][-1], "dense_paths": paths,
        "host_syncs_per_step": sum(paths.values()) / 5,
        "fused_step_ms": fused["step_s"] * 1e3,
        "fused_tokens_per_s": fused["tokens_per_s"], "fused_mfu": fused["mfu"],
        "fused_peak_mem_gib": fused["peak_mem_gib"], "card": card}
    tr = traced(lambda: step_of(cd)(hold["state"][0]),
                classify=kernel_category)
    out["m2_dense_step"]["traced"] = tr
    fused_tr = fused.get("traced_step") or {}
    out["m2_dense_step"]["fused_traced_busy_share"] = fused_tr.get(
        "device_busy_share")
    log(f"  (m2) dense step: {out['m2_dense_step']}")

    runs = []
    for mode in ("tuned", "heuristic", "heuristic", "tuned"):
        set_flags({"moe_gmm_autotune": mode == "tuned"})
        runs.append((mode, steps(cfg, 1, 2)["step_ms"]))
    set_flags({"moe_gmm_autotune": True})
    mean = {m: sum(t for mm, t in runs if mm == m) / 2
            for m in ("tuned", "heuristic")}
    out["m3_step"] = {"runs_ms": runs, "mean_ms": mean,
                      "tuned_over_heuristic": mean["tuned"]
                      / mean["heuristic"], "card": card}
    log(f"  (m3) fused step, tuned against heuristic widths: "
        f"{out['m3_step']}")

    T, h = B * S, cfg.hidden_size
    A_pad = -(-(T * cfg.top_k + cfg.num_experts * 127) // 128) * 128
    held = {}
    for pol in ("outs", "full"):
        c = dataclasses.replace(cfg, remat_policy=pol)
        probe = []
        free_memory()
        with torch.enable_grad():
            tracked = tree_map(lambda t: t.detach().requires_grad_(True),
                               hold["state"][0].params)
            base = torch.cuda.memory_allocated()
            moe.saved_probe = probe
            loss = moe.loss_fn(tracked, tokens, c)
            moe.saved_probe = None
            torch.cuda.synchronize()
            held[pol] = torch.cuda.memory_allocated() - base
        del loss, tracked
        if pol == "outs":
            kept = probe
    before_ops = (torch.ops.paddle_tpu_torch.flash_fwd.default,
                  torch.ops.paddle_tpu_torch.gmm.default)
    now_ops = moe._SAVED_OPS
    fwd_bwd_peak = {}
    for label, ops in (("outs", now_ops), ("outs_before", before_ops)):
        moe._SAVED_OPS = ops
        free_memory()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, grads = llama.loss_and_grads(hold["state"][0].params, tokens, cfg,
                                        moe.loss_fn)
        torch.cuda.synchronize()
        fwd_bwd_peak[label] = torch.cuda.max_memory_allocated() - base
        del grads
    step_runs = []
    for label in ("outs", "outs_before", "outs_before", "outs"):
        moe._SAVED_OPS = now_ops if label == "outs" else before_ops
        res = steps(cfg, 1, 2)
        step_runs.append((label, res["step_ms"], res["per_step"][-1]))
    moe._SAVED_OPS = now_ops
    if any(shape and shape[0] == A_pad for _, shape, _ in kept):
        raise AssertionError(f"outs kept a tensor of {A_pad} rows: {kept}")
    routed = [s for n, s, _ in kept if n.endswith("routed_out")]
    if routed != [(T, h)] * n_moe:
        raise AssertionError(f"routed outputs kept {routed}")
    hq = cfg.num_heads * cfg.head_dim
    per_layer = {"routed_out": T * h * 2,
                 "flash_fwd": T * hq * 2 + B * cfg.num_heads * S * 4}
    out["m4_outs"] = {
        "kept_per_moe_layer_bytes": per_layer,
        "kept_before_per_moe_layer_bytes": {
            "gmm_down_out": A_pad * h * 2, "flash_fwd": per_layer[
                "flash_fwd"]},
        "A_pad": A_pad, "kept_ops": len(kept),
        "forward_held_bytes": held, "fwd_bwd_peak_bytes": fwd_bwd_peak,
        "step_ms_now_against_before": step_runs,
        "phase12_peak_gib": fused["peak_mem_gib"],
        "pr10_peak_gib": 45.64, "card": card}
    log(f"  (m4) outs: {out['m4_outs']}")
    return out


def moe_dense_cross_device(moe, llama, tmdisp, tmf, build, dev):
    """(m2) phase 14's small MoE (f32, remat "outs") with
    ``dispatch="dense"`` on the card against the CPU (loss within 1e-5
    relative, gradients within 1e-3 of each leaf's largest magnitude,
    phase 14's bounds) and against the card's fused form (1e-5, 1e-4);
    every MoE layer takes the dense base. The weights come from the
    port's CPU init with seed SEED + 1: phase 14's own (seed SEED) route
    258 assignments to one expert, past Q = 256, so that batch would take
    the gmm form, which the overflow check below covers. Then a batch at
    its routing
    width whose router favours expert 0 for every token (its load 512 >
    Q = 256): ``dropless_moe_ffn_dense`` takes the gmm form (B10's gmm and
    tgmm launched) and equals the fused form, values within 1e-5 and
    gradients within 1e-4."""
    from paddle_tpu_torch.optimizer.functional import tree_map
    cfg = phase14_config(moe, "dense")
    tree = tree_map(lambda t: t.numpy(),
                    moe.init_params(cfg, SEED + 1, device="cpu"))
    toks = np.random.default_rng(SEED + 11).integers(0, cfg.vocab_size,
                                                     (2, 257))
    res, paths = {}, {}
    for where, form in ((str(dev), "dense"), ("cpu", "dense"),
                        (str(dev), "fused")):
        params = moe.params_from_numpy(tree, device=where)
        tmdisp.dense_paths.clear()
        loss, grads = llama.loss_and_grads(
            params, torch.as_tensor(toks, device=where),
            phase14_config(moe, form), moe.loss_fn)
        res[(where, form)] = {"loss": loss.item(), "grads": {
            p: g.cpu() for p, g in leaves(grads)}}
        paths[f"{where} {form}"] = dict(tmdisp.dense_paths)
        del params, grads
    if paths[f"{dev} dense"] != {"dense": 2}:
        raise AssertionError(f"dense paths {paths}")
    card, cpu, fus = (res[(str(dev), "dense")], res[("cpu", "dense")],
                      res[(str(dev), "fused")])
    worst = {}
    for name, a, b, bounds in (("card_vs_cpu", card, cpu, (1e-5, 1e-3)),
                               ("dense_vs_fused", card, fus, (1e-5, 1e-4))):
        worst[name] = {
            "loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grads": max(rel_err(a["grads"][p], gg)
                         for p, gg in b["grads"].items()
                         if gg.abs().max() > 0)}
        if worst[name]["loss"] > bounds[0] or worst[name]["grads"] > bounds[1]:
            raise AssertionError(f"dense {name}: {worst[name]}")
    # an overflowing batch at the same routing width (T = 512, k = 4,
    # E = 16, h = 256, f = 128, f32)
    rng = np.random.default_rng(SEED + 13)
    T, h, E, f, k = 512, 256, 16, 128, 4
    x = rng.standard_normal((T, h)).astype(np.float32)
    rw = (rng.standard_normal((h, E)) * 0.1).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 3.0
    rw[0, 0] += 3.0
    ex = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, h, f), (E, h, f), (E, f, h))]
    ct = torch.as_tensor(rng.standard_normal((T, h)).astype(np.float32),
                         device=dev)
    r = tmdisp.fused_routing(torch.as_tensor(x, device=dev),
                             torch.as_tensor(rw, device=dev), k)
    load = torch.bincount(r.idx.reshape(-1), minlength=E).max().item()
    plan = tmdisp.plan_dispatch(T, k, E, h)
    outs = {}
    for form in ("dense", "fused"):
        leaves_ = [torch.as_tensor(a, device=dev).requires_grad_(True)
                   for a in [x] + ex]
        w = r.weights.detach().requires_grad_(True)
        tmdisp.dense_paths.clear()
        before = dict(build.launch_counts)
        if form == "dense":
            y = tmdisp.dropless_moe_ffn_dense(leaves_[0], w, r.idx,
                                              *leaves_[1:], routing=r,
                                              plan=plan)
        else:
            y = tmdisp.dropless_moe_ffn_fused(leaves_[0], w, r.idx,
                                              *leaves_[1:], routing=r)
        grads = torch.autograd.grad((y * ct).sum(), [leaves_[0], w] +
                                    leaves_[1:])
        torch.cuda.synchronize()
        outs[form] = (y.detach(), grads, dict(tmdisp.dense_paths), {
            kk: v - before.get(kk, 0) for kk, v in build.launch_counts.items()
            if v - before.get(kk, 0)})
    y_d, g_d, p_d, l_d = outs["dense"]
    y_f, g_f, _, _ = outs["fused"]
    overflow = {"max_load": load, "Q": plan.Q, "dense_paths": p_d,
                "launches": l_d, "y_rel_err": rel_err(y_d, y_f),
                "grads_rel_err": max(rel_err(a, b) for a, b in zip(g_d, g_f))}
    if load <= plan.Q or p_d != {"gmm": 1} or l_d.get("gmm", 0) < 3 \
            or l_d.get("tgmm", 0) < 2 or overflow["y_rel_err"] > 1e-5 \
            or overflow["grads_rel_err"] > 1e-4:
        raise AssertionError(f"overflow batch: {overflow}")
    out = {"relative_errors": worst, "dense_paths": paths,
           "overflow": overflow}
    log(f"  (m2) dense on the card: {out}")
    return out


# ---------------------------------------------------------------------------
# phases (g1)-(g2): fixed-batch generation and HF interchange
# ---------------------------------------------------------------------------
def generation_full_width(llama, LLMEngine, dev, card, cfg, params):
    """(g1) ``generate`` and ``generate_fused`` on Llama-3-8B (phase 4's
    random bf16 weights), batch 8 of 128-token prompts (numpy seed), 32
    new tokens: greedy without an eos (the eos is then row 0's 17th
    token, which ends some rows early), greedy with it — the two loops'
    streams must be equal — and sampled at temperature 0.8, top_k 40,
    top_p 0.95 with it, from one generator seed each (eos padding
    checked); each run's tokens/s, ms a step, host syncs and graph
    replays a token; a traced 16-token greedy run of each for its kernels
    a token and busy share; and the first divergence of the fused greedy
    streams from ``LLMEngine``'s (8 slots, ``SERVE_ENGINE``) on the same
    prompts (bf16 near-ties may differ)."""
    B, S0, NEW = 8, 128, 32
    prompts = np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab_size, (B, S0))
    prompt = torch.as_tensor(prompts, device=dev)
    runs = {}

    def run(label, fn, new=NEW, **kw):
        llama.gen_stats.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(params, prompt, cfg, new, **kw).cpu()
        wall = time.perf_counter() - t0
        n = out.shape[1] - S0
        st = dict(llama.gen_stats)
        runs[label] = {"new_tokens": n, "wall_s": wall,
                       "tokens_per_s": B * n / wall,
                       "ms_per_step": wall / n * 1e3,
                       "host_syncs_per_token": st.get("syncs", 0) / n,
                       "graph_replays": st.get("graph_replays", 0),
                       "graph_captures": st.get("graph_captures", 0)}
        log(f"  (g1) {label}: {runs[label]}")
        return out

    run("warm_loop", llama.generate, new=2)
    run("warm_fused", llama.generate_fused, new=2)
    run("loop_1", llama.generate, new=1)
    run("fused_1", llama.generate_fused, new=1)
    free = run("fused_greedy_no_eos", llama.generate_fused)
    eos = int(free[0, S0 + 16])
    loop = run("loop_greedy_eos", llama.generate, eos_token_id=eos)
    fused = run("fused_greedy_eos", llama.generate_fused, eos_token_id=eos)
    if not torch.equal(loop, fused):
        raise AssertionError(f"greedy generate and generate_fused differ at "
                             f"{first_divergence(loop.tolist(), fused.tolist())}")
    ended = int((free[:, S0:] == eos).any(1).sum())
    kw = dict(temperature=0.8, top_k=40, top_p=0.95, eos_token_id=eos)
    sampled = {}
    for label, fn in (("loop_sampled", llama.generate),
                      ("fused_sampled", llama.generate_fused)):
        sampled[label] = run(label, fn, generator=torch.Generator(
            device=dev).manual_seed(SEED + 5), **kw)
        toks = sampled[label][:, S0:]
        hit = toks == eos
        for row in range(B):
            i = int(hit[row].int().argmax()) if hit[row].any() else None
            if i is not None and not hit[row, i:].all():
                raise AssertionError(f"{label}: row {row} emits past eos")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{label}: token ids out of range")
    for label, fn in (("loop", llama.generate),
                      ("fused", llama.generate_fused)):
        tr = traced(lambda fn=fn: fn(params, prompt, cfg, 16))
        if tr is not None:
            tr["kernels_per_token"] = tr["kernel_launches"] / 16
        runs[f"traced_{label}_16"] = tr
        log(f"  (g1) traced {label}, 16 tokens: {tr}")
    # decode alone: a run's time past the one-token run (prefill and the
    # first sample) of the same loop, over its remaining steps
    for label, r in runs.items():
        one = runs.get("fused_1" if "fused" in label else "loop_1")
        if r and "new_tokens" in r and r["new_tokens"] > 1 and one:
            r["decode_ms_per_token"] = ((r["wall_s"] - one["wall_s"])
                                        / (r["new_tokens"] - 1) * 1e3)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in leaves_of(params))
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    eng = LLMEngine(params, cfg, max_slots=8, device=dev, **SERVE_ENGINE)
    ids = [eng.add_request(p.tolist(), max_new_tokens=NEW) for p in prompts]
    got = eng.run()
    engine = [got[i] for i in ids]
    del eng
    free_memory()
    res = {"runs": runs, "eos": eos, "rows_ending_early": ended,
           "weight_bytes": weight_bytes,
           "weight_read_floor_ms_per_token": floor_ms,
           "greedy_loop_equals_fused": True,
           "sampled_streams_equal": torch.equal(sampled["loop_sampled"],
                                                sampled["fused_sampled"]),
           "first_divergence_from_engine": first_divergence(
               free[:, S0:].tolist(), engine),
           "fused_over_loop_tokens_per_s":
               runs["fused_greedy_eos"]["tokens_per_s"]
               / runs["loop_greedy_eos"]["tokens_per_s"],
           "card": card}
    log(f"  (g1) {res}")
    return res


def generation_cross_device(llama, LLMEngine, dev):
    """(g2) phase 5's cut model (f32): two 128-token prompts, 16 greedy
    tokens through ``generate`` and ``generate_fused`` on the card,
    ``generate`` on the CPU and a ragged ``LLMEngine`` on the card: all
    equal. Then ``to_hf_state_dict`` -> ``convert_hf_state_dict`` of the
    card's tree (2 layers at Llama-3-8B widths, vocabulary 32768) gives
    every leaf back exactly and the same logits on the card."""
    cfg, base = cut_model(llama)
    prompts = np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (2, 128))
    NEW = 16
    t0 = time.perf_counter()
    cpu = llama.generate(base, prompts, cfg, NEW, device="cpu")[:, 128:]
    cpu_s = time.perf_counter() - t0
    params = tree_to(base, dev)
    loop = llama.generate(params, prompts, cfg, NEW).cpu()[:, 128:]
    fused = llama.generate_fused(params, prompts, cfg, NEW).cpu()[:, 128:]
    eng = LLMEngine(params, cfg, max_slots=2, block_size=64,
                    max_model_len=512, prompt_buckets=[256], decode_steps=4,
                    decode_kernel="ragged", device=dev)
    ids = [eng.add_request(p.tolist(), max_new_tokens=NEW) for p in prompts]
    got = eng.run()
    engine = [got[i] for i in ids]
    del eng
    streams = {"cpu": cpu.tolist(), "card_loop": loop.tolist(),
               "card_fused": fused.tolist(), "card_engine": engine}
    if any(v != streams["cpu"] for v in streams.values()):
        raise AssertionError(f"generation streams differ: {streams}")
    t0 = time.perf_counter()
    sd = llama.to_hf_state_dict(params, cfg)
    back = llama.convert_hf_state_dict(sd, cfg, device=dev)
    hf_s = time.perf_counter() - t0
    back_leaves = dict(leaves(back))
    bad = [p for p, t in leaves(params) if not torch.equal(t, back_leaves[p])]
    ids_t = torch.as_tensor(prompts[:, :64], device=dev)
    same_logits = torch.equal(llama.forward(params, ids_t, cfg),
                              llama.forward(back, ids_t, cfg))
    if bad or not same_logits:
        raise AssertionError(f"HF round trip: leaves {bad} differ, logits "
                             f"equal {same_logits}")
    res = {"streams": streams["cpu"], "cpu_generate_s": cpu_s,
           "hf_keys": len(sd), "hf_roundtrip_s": hf_s,
           "hf_roundtrip_exact": True, "hf_same_logits": True}
    log(f"  (g2) {res}")
    del params, back, sd
    return res


# ---------------------------------------------------------------------------
# phases (h1)-(h4): the HTTP/SSE front door, the replica router, the
# disaggregated prefill/decode pair and the serve CLI
# ---------------------------------------------------------------------------
# (p1)'s direct streams (phase 4's mix through mega at 8 slots): the
# colocated run (h1) and (h3) are held beside
STREAMS = {}


def http_post(port, doc, timeout=600):
    """A raw client connection with one ``POST /v1/generate`` sent."""
    import socket
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    body = json.dumps(doc).encode()
    s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Length: "
              + str(len(body)).encode() + b"\r\n\r\n" + body)
    return s


def http_recv(s):
    data = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        data += chunk
    s.close()
    return data


def http_get(port, path):
    import socket
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    return http_recv(s)


def http_status(raw):
    return int(raw.split(b" ", 2)[1])


def http_split(raw):
    head, _, body = raw.partition(b"\r\n\r\n")
    return head, body


def sse_frames(body):
    """The JSON of every ``data:`` frame of an SSE body."""
    return [json.loads(c.split(b"\n", 1)[0])
            for c in body.split(b"data: ")[1:]]


def read_frames(s, n):
    """Read until ``n`` SSE ``data:`` frames arrived."""
    buf = b""
    while buf.count(b"data:") < n or not buf.endswith(b"\n\n"):
        c = s.recv(1)
        if not c:
            break
        buf += c
    return buf


def wait_until(pred, timeout, what):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.002)


def need_launches(launches, dev, label, want=(), none=()):
    """Fail unless each kernel of ``want`` launched in the run (and none
    of ``none``): its counts were zeroed just before and read just
    after."""
    missing = [k for k in want if not launches.get(k)]
    extra = [k for k in none if launches.get(k)]
    if missing or extra:
        raise AssertionError(f"{label}: launches {launches} (missing "
                             f"{missing}, unexpected {extra})")


def stream_identity(got, want):
    """(streams equal, of how many, the first divergence)."""
    return {"equal": sum(a == b for a, b in zip(got, want)),
            "of": len(want), "first_divergence": first_divergence(got,
                                                                  want)}


def client_run(port, prompts, new_tokens, dev):
    """Every prompt posted at once from its own client thread (SSE):
    tokens/s at the clients (all tokens over first send to last
    terminal), each client's TTFT from its send to its first ``data:``
    frame, and each stream (the terminal frame's tokens, checked equal to
    the streamed frames)."""
    import threading
    out = [None] * len(prompts)
    t_send = [0.0] * len(prompts)
    t_first = [0.0] * len(prompts)
    t_done = [0.0] * len(prompts)
    errors = []

    def client(i):
        try:
            t_send[i] = time.perf_counter()
            s = http_post(port, {"prompt": prompts[i],
                                 "max_new_tokens": new_tokens})
            head = read_frames(s, 1)
            t_first[i] = time.perf_counter()
            body = http_split(head)[1] + http_recv(s)
            t_done[i] = time.perf_counter()
            frames = sse_frames(body)
            term = frames[-1]
            toks = [f["token"] for f in frames if "token" in f]
            if term.get("reason") != "finished" or toks != term["tokens"] \
                    or len(toks) != new_tokens:
                raise AssertionError(f"client {i}: terminal {term}, "
                                     f"{len(toks)} streamed tokens")
            out[i] = toks
        except Exception as e:          # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")
    torch.cuda.synchronize(dev)
    wall = max(t_done) - min(t_send)
    ttft = sorted(f - s for f, s in zip(t_first, t_send))
    n_tok = sum(len(t) for t in out)
    return {"requests": len(prompts), "output_tokens": n_tok,
            "wall_s": wall, "output_tok_per_s": n_tok / wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p95_s": p95(ttft),
            "ttft_s": ttft}, out


def front_door(LLMEngine, build, dev, card, cfg, params, direct):
    """(h1): ``HTTPFrontDoor(ResilientEngine(LLMEngine(mega, 8 slots)))``
    on phase 4's weights, observability on, stdlib socket clients.
    ``direct`` is (p1)'s run of the same mix through the same engine
    geometry. Returns the numbers and each leg's launches."""
    import threading
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.distributed.resilience import FaultInjector
    from paddle_tpu_torch.serving import (AdmissionConfig,
                                          AdmissionController,
                                          HTTPFrontDoor, ResilientEngine)
    from paddle_tpu_torch.serving.http import (sse_retry_frame,
                                               sse_terminal_frame,
                                               sse_token_frame)
    mix = serving_mix(cfg, 16)
    res, launches = {}, {}
    eng = LLMEngine(params, cfg, max_slots=8, **SERVE_ENGINE,
                    decode_kernel="mega", seed=SEED, device=dev)
    # (a)'s reference: the same engine, the same 4 requests one at a time
    direct_toks = []
    for p in mix[:4]:
        rid = eng.add_request(p, max_new_tokens=64)
        direct_toks.append(eng.run()[rid])
    reng = ResilientEngine(eng)
    front = HTTPFrontDoor(reng, port=0)
    _, port = front.start()
    try:
        log("  (h1 a) sequential: 4 requests, SSE bytes against the direct "
            "run")
        build.launch_counts.clear()
        equal = 0
        for p, toks in zip(mix[:4], direct_toks):
            rid = eng._next_id           # the door is idle between them
            raw = http_recv(http_post(port, {"prompt": p,
                                             "max_new_tokens": 64}))
            body = http_split(raw)[1]
            want = b"".join(sse_token_frame(t) for t in toks) \
                + sse_terminal_frame(rid, "finished", toks)
            if body != want:
                raise AssertionError(
                    f"request {rid}: the SSE body differs from the direct "
                    f"run's frames (first divergence "
                    f"{first_divergence([sse_frames(body)[-1]['tokens']], [toks])})")
            equal += 1
        launches["h1_sequential"] = dict(build.launch_counts)
        need_launches(launches["h1_sequential"], dev, "(h1 a)",
                      want=("flash_fwd", "mega_decode"),
                      none=("ragged_decode",))
        res["a_sequential"] = {"byte_equal": equal, "of": 4}

        log("  (h1 b) 16 concurrent clients")
        build.launch_counts.clear()
        b, streams = client_run(port, mix, 64, dev)
        launches["h1_concurrent"] = dict(build.launch_counts)
        need_launches(launches["h1_concurrent"], dev, "(h1 b)",
                      want=("flash_fwd", "mega_decode"))
        b["direct_tok_per_s"] = direct["output_tok_per_s"]
        b["direct_ttft_p95_s"] = direct["ttft_p95_s"]
        d_ttft = direct["ttft_s"]
        b["direct_ttft_p50_s"] = d_ttft[len(d_ttft) // 2] if d_ttft \
            else None
        b["door_cost"] = 1 - b["output_tok_per_s"] \
            / direct["output_tok_per_s"]
        if "p1_mega_8" in STREAMS:
            b["identity_vs_direct"] = stream_identity(
                streams, STREAMS["p1_mega_8"])
        res["b_concurrent"] = b
        log(f"  {b['output_tok_per_s']:.1f} tok/s at the clients against "
            f"{direct['output_tok_per_s']:.1f} direct; TTFT p50 "
            f"{b['ttft_p50_s']:.3f} s, p95 {b['ttft_p95_s']:.3f} s "
            f"(direct p95 {direct['ttft_p95_s']:.3f} s)")

        log("  (h1 c) a client disconnects after 2 frames")
        rid = eng._next_id
        s = http_post(port, {"prompt": mix[4], "max_new_tokens": 64})
        read_frames(s, 2)
        s.close()
        step0 = eng._step_idx
        wait_until(lambda: eng.finish_reasons.get(rid) is not None, 120,
                   "(h1 c) the disconnect's terminal")
        steps = eng._step_idx - step0
        wait_until(lambda: not eng.has_work(), 120, "(h1 c) idle")
        acct = eng.block_accounting()
        if eng.finish_reasons[rid] != "client_disconnected" \
                or acct["backed"] != 0 or steps > 2:
            raise AssertionError(f"(h1 c): reason "
                                 f"{eng.finish_reasons[rid]}, {steps} "
                                 f"steps, ledger {acct}")
        res["c_disconnect"] = {"reason": eng.finish_reasons[rid],
                               "steps_to_terminal": steps,
                               "tokens_kept": len(eng.results[rid]),
                               "backed": acct["backed"]}

        log("  (h1 d) overload: 8 live streams, max_queue 2, a burst of 6")
        live = [http_post(port, {"prompt": p, "max_new_tokens": 64})
                for p in mix[:8]]
        for s in live:
            read_frames(s, 1)               # every slot is decoding
        eng.admission = AdmissionController(AdmissionConfig(max_queue=2))
        codes, heads = [], []
        lock = threading.Lock()

        def burst(p):
            raw = http_recv(http_post(port, {"prompt": p,
                                             "max_new_tokens": 4,
                                             "stream": False}))
            with lock:
                codes.append(http_status(raw))
                heads.append(http_split(raw)[0])

        threads = [threading.Thread(target=burst, args=(p,))
                   for p in mix[8:14]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        for s in live:
            term = sse_frames(http_recv(s))[-1]
            if term["reason"] != "finished":
                raise AssertionError(f"(h1 d): a live stream ended {term}")
        eng.admission = None
        shed = [h for c, h in zip(codes, heads) if c == 503]
        if len(codes) != 6 or not shed or set(codes) - {200, 503} \
                or not all(b"Retry-After:" in h for h in shed):
            raise AssertionError(f"(h1 d): codes {sorted(codes)}")
        res["d_overload"] = {"served": codes.count(200),
                             "shed_503": len(shed)}

        log("  (h1 e) a readback_fail mid-stream")
        rec0 = reng.recoveries
        eng.injector = FaultInjector([("readback_fail", eng._step_idx + 3)])
        raw = http_recv(http_post(port, {"prompt": mix[0],
                                         "max_new_tokens": 64}))
        eng.injector = None
        body = http_split(raw)[1]
        frames = sse_frames(body)
        toks = [f["token"] for f in frames if "token" in f]
        if reng.recoveries != rec0 + 1 \
                or sse_retry_frame(rec0 + 1) not in body \
                or frames[-1]["reason"] != "finished" \
                or toks != frames[-1]["tokens"] or len(toks) != 64:
            raise AssertionError(f"(h1 e): recoveries {reng.recoveries}, "
                                 f"terminal {frames[-1]}")
        res["e_recovery"] = {"recoveries": reng.recoveries - rec0,
                             "retrying_frame": True, "exactly_once": True,
                             "identity_vs_direct": stream_identity(
                                 [toks], direct_toks[:1])}

        log("  (h1 g) /metrics and /fleet/metrics through the door")
        page = http_split(http_get(port, "/metrics"))[1].decode()
        vals = prometheus_values(page)
        # the fleet view merges replica-scoped series; the door's own
        # process joins it as an explicit source, as a remote process
        # would through fleet.http_source
        agg = obs.fleet.get_aggregator()
        agg.add_source("door", obs.snapshot)
        try:
            fpage = http_split(http_get(port, "/fleet/metrics"))[1].decode()
        finally:
            agg.remove_source("door")
        fvals = prometheus_values(fpage)
        http_names = sorted(k for k in vals if k.startswith("serving_http_"))
        if vals.get("serving_http_requests_total", 0) < 20 \
                or vals.get("serving_http_client_disconnects_total", 0) < 1 \
                or fvals.get("serving_http_requests_total", 0) \
                < vals["serving_http_requests_total"]:
            raise AssertionError(f"(h1 g): {http_names} {vals} {fvals}")
        res["g_scrapes"] = {"serving_http_series": http_names,
                            "requests_total":
                                vals["serving_http_requests_total"]}

        log("  (h1 f) drain")
        s = http_post(port, {"prompt": mix[1], "max_new_tokens": 64})
        read_frames(s, 1)
        t0 = time.perf_counter()
        front.begin_drain(drain_s=300)
        ready = http_status(http_get(port, "/readyz"))
        raw = http_recv(http_post(port, {"prompt": mix[2],
                                         "max_new_tokens": 2}))
        term = sse_frames(http_recv(s))[-1]
        if not front.wait_drained(300):
            raise AssertionError("(h1 f): the door never drained")
        drained_s = time.perf_counter() - t0
        hist = obs.get_registry().histogram(
            "serving_http_drain_seconds").labels()
        if ready != 503 or http_status(raw) != 503 \
                or b"Connection: close" not in http_split(raw)[0] \
                or term["reason"] != "finished" \
                or len(term["tokens"]) != 64 or sum(hist.counts) != 1:
            raise AssertionError(f"(h1 f): readyz {ready}, post "
                                 f"{http_status(raw)}, terminal {term}")
        res["f_drain"] = {"readyz": ready, "post_during_drain": 503,
                          "live_stream": term["reason"],
                          "drain_s": drained_s}
    finally:
        front.stop()
    acct = eng.block_accounting()
    if acct["backed"] or acct["free"] != acct["total"]:
        raise AssertionError(f"(h1): ledger after the door {acct}")
    del reng, eng, front
    free_memory()
    return res, launches


class StepClock:
    """A router ``step_hook``: each replica's step wall times (between two
    calls of the hook on its thread), and each stream's first-token time
    from its submit (``submitted``). While ``hold`` is set every replica
    waits after its step, taking its ops (a submit is acked at once) but
    stepping nothing; with ``park`` set to (replica set, tokens), the
    first replica found owning a live stream with that many delivered
    tokens waits so until ``go`` is set, so a kill lands mid-stream."""

    def __init__(self, park=None):
        import threading
        self.router = None
        self.last = {}
        self.steps = {}
        self.submitted = {}
        self.first = {}
        self.park = park
        self.victim = None
        self.parked = threading.Event()
        self.go = threading.Event()
        self.hold = threading.Event()

    def _wait(self, name, done):
        rep = self.router.replicas[name]
        t0 = time.perf_counter()
        while not done() and time.perf_counter() - t0 < 300:
            rep._run_ops()
            time.sleep(0.001)
        self.last.pop(name, None)

    def __call__(self, name, _eng):
        if self.hold.is_set():
            self._wait(name, lambda: not self.hold.is_set())
        now = time.perf_counter()
        if name in self.last:
            self.steps.setdefault(name, []).append(now - self.last[name])
        self.last[name] = now
        router = self.router
        with router._lock:
            for rid, rec in router._streams.items():
                if rec.delivered and rid not in self.first \
                        and rid in self.submitted:
                    self.first[rid] = now - self.submitted[rid]
            if self.park is None or self.victim is not None:
                return
            names, tokens = self.park
            if name not in names or not any(
                    rec.replica == name and not rec.done.is_set()
                    and len(rec.delivered) >= tokens
                    for rec in router._streams.values()):
                return
            self.victim = name
        self.parked.set()
        self._wait(name, self.go.is_set)


def watched(fn, label, timeout=120.0):
    """Run ``fn()`` under a process watchdog in log mode (every replica
    step is a guarded region): a step past ``timeout`` fails the phase
    once ``fn`` returns or raises, never hangs it silently."""
    from paddle_tpu_torch.distributed import watchdog
    hits = []
    watchdog.install(watchdog.CommWatchdog(
        timeout=timeout, mode="log", on_timeout=lambda n, e:
        hits.append((n, round(e, 1)))))
    try:
        out = fn()
    finally:
        watchdog.uninstall()
    if hits:
        raise AssertionError(f"{label}: replica steps past {timeout} s: "
                             f"{hits}")
    return out


def submit_held(router, clock, prompts, new_tokens):
    """Submit every prompt in order while the replicas hold (each submit
    acked at once, so the router's load model sees every earlier
    placement), then let them run; the router ids in prompt order."""
    clock.hold.set()
    try:
        rids = []
        for p in prompts:
            t = time.perf_counter()
            rids.append(router.submit(list(p), max_new_tokens=new_tokens))
            clock.submitted[rids[-1]] = t
    finally:
        clock.hold.clear()
    return rids


def submit_all(router, clock, prompts, new_tokens):
    """Submit every prompt at once, one client thread each (the router
    places each on the loads it saw, before any was acked); the router
    ids in prompt order."""
    import threading
    rids = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            t = time.perf_counter()
            rids[i] = router.submit(list(prompts[i]),
                                    max_new_tokens=new_tokens)
            clock.submitted[rids[i]] = t
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors:
        raise AssertionError(f"submits failed: {errors[:3]}")
    return rids


def stop_router(router):
    """Stop every replica thread; fail if one does not end (a hung
    replica fails the phase, the script does not wait on it)."""
    router.stop()
    alive = [n for n, rep in router.replicas.items() if rep.alive()]
    if alive:
        raise AssertionError(f"replica threads still running: {alive}")


def drained_clean(eng):
    acct = eng.block_accounting()
    return acct["free"] + acct["cached"] == acct["total"] \
        and not acct["backed"] and not acct["squeezed"]


def run_router(router, clock, prompts, new_tokens, dev, label,
               submit=submit_held):
    """``prompts`` through ``router``, submitted by ``submit``: tokens/s,
    TTFT at the router, the dispatch split, streams (each checked
    ``finished`` with ``new_tokens``)."""
    torch.cuda.synchronize(dev)
    before = {n: rep.dispatches for n, rep in router.replicas.items()}
    t0 = time.perf_counter()
    rids = submit(router, clock, prompts, new_tokens)
    streams = [router.wait(r, timeout=600) for r in rids]
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    bad = [(r, router.finish_reasons[r], len(s))
           for r, s in zip(rids, streams)
           if router.finish_reasons[r] != "finished" or len(s) != new_tokens]
    if bad:
        raise AssertionError(f"{label}: streams {bad}")
    ttft = sorted(clock.first.get(r, float("nan")) for r in rids)
    n_tok = sum(len(s) for s in streams)
    return {"requests": len(rids), "output_tokens": n_tok, "wall_s": wall,
            "output_tok_per_s": n_tok / wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_p95_s": p95(ttft),
            "dispatches": {n: rep.dispatches - before[n]
                           for n, rep in router.replicas.items()}}, \
        rids, streams


def cut_prompts(cfg, n, seed=SEED + 5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=int(m)).tolist()
            for m in rng.integers(100, 250, size=n)]


CUT_ENGINE = dict(block_size=64, max_model_len=512, prompt_buckets=[256],
                  decode_steps=4)


def cut_failover(llama, LLMEngine, dev):
    """(h2 d): phase 5's cut model (f32) on the card, two mega replicas
    at 4 slots; one killed once a stream on it has 4 tokens: every
    stream equals an uninterrupted engine's."""
    from paddle_tpu_torch.serving import ReplicaRouter
    cfg, base = cut_model(llama)
    params = tree_to(base, dev)
    prompts = cut_prompts(cfg, 8)
    ref = LLMEngine(params, cfg, max_slots=4, **CUT_ENGINE,
                    decode_kernel="mega", device=dev)
    ids = [ref.add_request(p, max_new_tokens=24) for p in prompts]
    out = ref.run()
    want = [out[i] for i in ids]
    clock = StepClock(park=({"r0", "r1"}, 4))
    router = ReplicaRouter(
        [LLMEngine(params, cfg, max_slots=4, **CUT_ENGINE,
                   decode_kernel="mega", device=dev) for _ in range(2)],
        names=["r0", "r1"], step_hook=clock)
    clock.router = router
    router.start()
    try:
        rids = submit_held(router, clock, prompts, 24)
        if not clock.parked.wait(300):
            raise AssertionError("(h2 d): no replica reached the park")
        router.kill_replica(clock.victim)
        clock.go.set()
        got = [router.wait(r, timeout=300) for r in rids]
        failovers = router.failovers
    finally:
        clock.go.set()
        stop_router(router)
    if got != want or not failovers:
        raise AssertionError(f"(h2 d): f32 resumed streams differ "
                             f"({stream_identity(got, want)}), failovers "
                             f"{failovers}")
    del params, ref
    return {"streams": len(got), "equal": True, "failovers": failovers,
            "victim": clock.victim}


def replica_router(llama, LLMEngine, build, dev, card, cfg, params, direct,
                   ragged4):
    """(h2): ``ReplicaRouter`` over two 4-slot replicas of phase 4's
    weights (one params dict) on one card, observability on. ``direct``
    is (p1)'s one 8-slot mega engine, ``ragged4`` phase 6 (c)'s one
    4-slot ragged engine."""
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.serving import ReplicaRouter
    res, launches = {}, {}
    mix = serving_mix(cfg, 16)

    def engines(kernel):
        return [LLMEngine(params, cfg, max_slots=4, **SERVE_ENGINE,
                          decode_kernel=kernel, seed=SEED, device=dev)
                for _ in range(2)]

    clock = StepClock()
    router = ReplicaRouter(engines("mega"), names=["r0", "r1"],
                           step_hook=clock, halfopen_s=0.5)
    clock.router = router
    if any(rep.raw.params is not params for rep in router.replicas.values()):
        raise AssertionError("(h2): a replica copied the weights")
    router.start()
    try:
        log("  (h2 a) affinity: (p2)'s shared 384-token prefix")
        rng = np.random.default_rng(0)
        top = min(32768, cfg.vocab_size)
        shared = rng.integers(1, top, size=384).tolist()
        tails = [rng.integers(1, top, size=int(t)).tolist()
                 for t in rng.integers(48, 112, size=4)]
        build.launch_counts.clear()
        owners = []
        for t in tails:
            rid = router.submit(shared + t, max_new_tokens=8)
            router.wait(rid, timeout=300)
            owners.append(router._streams[rid].replica)
        hits = obs.get_registry().counter(
            "serving_router_affinity_total").labels(outcome="hit").value
        if hits < 3 or len(set(owners)) != 1:
            raise AssertionError(f"(h2 a): hits {hits}, owners {owners}")
        res["a_affinity"] = {"hits": hits, "owners": owners}

        log("  (h2 b) phase 4's 16-request mix, both replicas healthy")
        clock.steps.clear()
        build.launch_counts.clear()
        b, _, streams_b = run_router(router, clock, mix, 64, dev, "(h2 b)")
        launches["h2_router_mega"] = dict(build.launch_counts)
        need_launches(launches["h2_router_mega"], dev, "(h2 b)",
                      want=("flash_fwd", "mega_decode"),
                      none=("ragged_decode",))
        steps = [t for ts in clock.steps.values() for t in ts]
        b.update(direct_tok_per_s=direct["output_tok_per_s"],
                 direct_ttft_p95_s=direct["ttft_p95_s"],
                 ratio=b["output_tok_per_s"] / direct["output_tok_per_s"],
                 median_replica_step_ms=1e3 * float(np.median(steps)))
        # the same mix from 16 concurrent submitters: each placed on the
        # loads it saw before any earlier one was acked
        herd, _, _ = run_router(router, clock, mix, 64, dev, "(h2 b herd)",
                                submit=submit_all)
        b["concurrent_submits"] = herd
        if "p1_mega_8" in STREAMS:
            b["identity_vs_direct"] = stream_identity(
                streams_b, STREAMS["p1_mega_8"])
        res["b_throughput"] = b
        log(f"  router {b['output_tok_per_s']:.1f} tok/s against one 8-slot "
            f"engine's {direct['output_tok_per_s']:.1f}; median replica "
            f"step {b['median_replica_step_ms']:.2f} ms")

        log("  (h2 c) r0 killed with streams in flight")
        build.launch_counts.clear()
        clock.first.clear()
        rids = submit_held(router, clock, mix, 64)
        wait_until(lambda: any(
            rec.replica == "r0" and len(rec.delivered) >= 8
            and not rec.done.is_set()
            for rec in list(router._streams.values())), 300,
            "(h2 c) a stream 8 tokens into r0")
        router.kill_replica("r0")
        streams_c = [router.wait(r, timeout=600) for r in rids]
        launches["h2_failover"] = dict(build.launch_counts)
        need_launches(launches["h2_failover"], dev, "(h2 c)",
                      want=("flash_fwd", "mega_decode"))
        reasons = [router.finish_reasons[r] for r in rids]
        if set(reasons) != {"finished"} \
                or any(len(s) != 64 for s in streams_c) \
                or not router.failovers:
            raise AssertionError(f"(h2 c): reasons {Counter(reasons)}, "
                                 f"lengths {[len(s) for s in streams_c]}")
        res["c_failover"] = {
            "failovers": router.failovers,
            "resumed_streams": router.resumed_streams,
            "dedup_drops": router.dedup_drops,
            "terminal_reasons": dict(Counter(reasons)),
            "identity_vs_b": stream_identity(streams_c, streams_b)}
        log(f"  {res['c_failover']}")

        log("  (h2 e) revive r0: dead -> half_open -> healthy")
        states = [router.check()["r0"]]
        router.revive_replica("r0")
        time.sleep(0.6)                     # past halfopen_s
        states.append(router.check()["r0"])
        # a prompt no replica has served: no affinity, so the half-open
        # probe takes it
        rid = router.submit(list(range(1, 65)), max_new_tokens=4)
        probe_on = router._streams[rid].replica
        router.wait(rid, timeout=300)
        states.append(router.check()["r0"])
        if states != ["dead", "half_open", "healthy"] or probe_on != "r0":
            raise AssertionError(f"(h2 e): states {states}, probe on "
                                 f"{probe_on}")
        if not router.drain_all(timeout=300):
            raise AssertionError("(h2 e): drain_all timed out")
        wait_until(lambda: set(router.check().values()) == {"drained"},
                   300, "(h2 e) both replicas drained")
        ledgers = {n: rep.raw.block_accounting()
                   for n, rep in router.replicas.items()}
        if not all(drained_clean(rep.raw)
                   for rep in router.replicas.values()):
            raise AssertionError(f"(h2 e): ledgers after drain_all "
                                 f"{ledgers}")
        res["e_breaker"] = {"states": states, "ledgers": ledgers}
    finally:
        stop_router(router)
    del router
    free_memory()

    log("  (h2 d) the same kill on phase 5's cut model (f32)")
    res["d_f32_identity"] = cut_failover(llama, LLMEngine, dev)
    free_memory()

    log("  (h2 f) both replicas on ragged decode at 4 slots, 6 (c)'s 8 "
        "requests")
    clock = StepClock()
    router = ReplicaRouter(engines("ragged"), names=["r0", "r1"],
                           step_hook=clock)
    clock.router = router
    router.start()
    try:
        build.launch_counts.clear()
        f, _, _ = run_router(router, clock, mix[:8], 64, dev, "(h2 f)")
        launches["h2_router_ragged"] = dict(build.launch_counts)
        need_launches(launches["h2_router_ragged"], dev, "(h2 f)",
                      want=("flash_fwd", "ragged_decode"),
                      none=("mega_decode",))
    finally:
        stop_router(router)
    steps = [t for ts in clock.steps.values() for t in ts]
    f.update(median_replica_step_ms=1e3 * float(np.median(steps)),
             one_engine_4_slots_tok_per_s=ragged4["output_tok_per_s"],
             one_engine_4_slots_median_decode_step_ms=ragged4[
                 "median_decode_step_ms"])
    res["f_ragged"] = f
    log(f"  ragged router {f['output_tok_per_s']:.1f} tok/s, median "
        f"replica step {f['median_replica_step_ms']:.1f} ms (one 4-slot "
        f"engine: {ragged4['output_tok_per_s']:.1f} tok/s, "
        f"{ragged4['median_decode_step_ms']:.2f} ms a token step)")
    del router
    free_memory()
    return res, launches


def kv_block_bytes(eng):
    """Bytes one block of every pool entry holds (all layers)."""
    return sum(t[:, :1].numel() * t.element_size()
               for t in eng.pools.values())


def disagg_pair(LLMEngine, dev, cfg, params, roles_slots, kernel,
                relay_bytes, clock, **kw):
    from paddle_tpu_torch.serving import HostKVPool, ReplicaRouter
    relay = HostKVPool(relay_bytes, kind="relay")
    engines = [LLMEngine(params, cfg, max_slots=slots, decode_kernel=kernel,
                         role=role, relay=relay, device=dev, **kw)
               for role, slots in roles_slots]
    router = ReplicaRouter(engines, names=["p0", "d0"], step_hook=clock)
    clock.router = router
    return router.start(), relay, engines


def relay_bit_exact(LLMEngine, dev, cfg, params, prompt):
    """(h3)'s int8-pool leg: one request handed off by a prefill engine
    to a decode engine through the relay, both with int8 pools. The
    relay entry (payload and scales) equals the prefill slot's blocks,
    and the restored slot's positions equal them byte for byte."""
    from paddle_tpu_torch.serving import HostKVPool
    relay = HostKVPool(1 << 30, kind="relay")
    kw = dict(max_slots=1, **SERVE_ENGINE, decode_kernel="mega",
              kv_dtype="int8", relay=relay, device=dev)
    pre = LLMEngine(params, cfg, role="prefill", **kw)
    dec = LLMEngine(params, cfg, role="decode", **kw)
    nb = -(-len(prompt) // pre.bs)
    held = {}
    handoff = pre._handoff

    def spy(slot):
        blks = [int(b) for b in pre.table[slot, :nb]]
        held.update({n: t[:, blks].cpu() for n, t in pre.pools.items()})
        handoff(slot)

    pre._handoff = spy
    erid = pre.add_request(prompt, max_new_tokens=64)
    first = []
    while pre.has_work():
        first += [t for _r, t in pre.step()]
    ent = relay.get(erid)
    if pre.finish_reasons[erid] != "handoff" or ent is None \
            or sorted(ent.data) != ["k", "ks", "v", "vs"] \
            or not all(torch.equal(ent.data[n], held[n]) for n in held):
        raise AssertionError("(h3 int8): the relay entry differs from the "
                             "prefill slot's blocks")
    rid = dec.add_request(prompt + first, max_new_tokens=63,
                          relay_key=erid)
    dec.step()
    blks = [int(b) for b in dec.table[0, :nb]]
    n = len(prompt)
    for name, t in dec.pools.items():
        got = t[:, blks].cpu().flatten(1, 2)[:, :n]
        if not torch.equal(got, held[name].flatten(1, 2)[:, :n]):
            raise AssertionError(f"(h3 int8): restored {name} differs")
    out = first + dec.run()[rid]
    if len(out) != 64:
        raise AssertionError(f"(h3 int8): {len(out)} tokens")
    res = {"entries": ["k", "ks", "v", "vs"], "blocks": nb,
           "bytes": int(sum(t.numel() * t.element_size()
                            for t in ent.data.values())),
           "bit_exact": True}
    del pre, dec, relay, held, ent
    return res


def disaggregated(llama, LLMEngine, build, dev, card, cfg, params, direct):
    """(h3): a prefill-role engine and a decode-role mega engine at 8
    slots behind one router, one shared relay pool, phase 4's mix,
    observability on."""
    import paddle_tpu_torch.observability as obs
    res, launches = {}, {}
    mix = serving_mix(cfg, 16)
    clock = StepClock()
    router, relay, (p_eng, d_eng) = disagg_pair(
        LLMEngine, dev, cfg, params, (("prefill", 8), ("decode", 8)),
        "mega", 4 << 30, clock, seed=SEED, **SERVE_ENGINE)
    handoff_s, relay_peak = [], [0]
    handoff = p_eng._handoff

    def timed(slot):
        t0 = time.perf_counter()
        handoff(slot)
        handoff_s.append(time.perf_counter() - t0)
        relay_peak[0] = max(relay_peak[0], relay.bytes_used)

    p_eng._handoff = timed
    try:
        build.launch_counts.clear()
        run, _, streams = run_router(router, clock, mix, 64, dev, "(h3)")
        launches["h3_disagg"] = dict(build.launch_counts)
        need_launches(launches["h3_disagg"], dev, "(h3)",
                      want=("flash_fwd", "mega_decode"),
                      none=("ragged_decode",))
        agg = obs.fleet.get_aggregator()
        outcome = {o: agg.fleet_counter_value(
            "serving_disagg_handoffs_total", outcome=o)
            for o in ("ok", "restored", "missing", "relay_full")}
        per_block = kv_block_bytes(p_eng)
        reckoned = per_block * sum(-(-len(p) // p_eng.bs) for p in mix)
        if p_eng.handoff_bytes != reckoned or len(relay) \
                or router.handoff_resumes != 16 \
                or outcome["restored"] != 16 or outcome["missing"] \
                or d_eng.handoffs:
            raise AssertionError(f"(h3): handoff bytes "
                                 f"{p_eng.handoff_bytes} against "
                                 f"{reckoned}, relay {len(relay)}, "
                                 f"outcomes {outcome}")
        run.update(
            direct_tok_per_s=direct["output_tok_per_s"],
            direct_ttft_p95_s=direct["ttft_p95_s"],
            handoffs=p_eng.handoffs, handoff_bytes=p_eng.handoff_bytes,
            reckoned_bytes=reckoned, block_bytes=per_block,
            handoff_s_median=float(np.median(handoff_s)),
            handoff_s_max=max(handoff_s), relay_peak_bytes=relay_peak[0],
            outcomes=outcome)
        if "p1_mega_8" in STREAMS:
            run["identity_vs_colocated"] = stream_identity(
                streams, STREAMS["p1_mega_8"])
        res["bf16"] = run
        log(f"  disaggregated {run['output_tok_per_s']:.1f} tok/s (colocated "
            f"{direct['output_tok_per_s']:.1f}), TTFT p95 "
            f"{run['ttft_p95_s']:.3f} s (colocated "
            f"{direct['ttft_p95_s']:.3f}), handoff median "
            f"{1e3 * run['handoff_s_median']:.1f} ms, max "
            f"{1e3 * run['handoff_s_max']:.1f} ms, relay peak "
            f"{relay_peak[0] / 2**30:.2f} GiB, bytes {p_eng.handoff_bytes} "
            f"= reckoned {reckoned}")
    finally:
        stop_router(router)
    del router, relay, p_eng, d_eng
    free_memory()

    log("  (h3) f32: the pair on phase 5's cut model against a colocated "
        "engine")
    ccfg, base = cut_model(llama)
    cparams = tree_to(base, dev)
    prompts = cut_prompts(ccfg, 8, seed=SEED + 6)
    ref = LLMEngine(cparams, ccfg, max_slots=4, **CUT_ENGINE,
                    decode_kernel="mega", device=dev)
    ids = [ref.add_request(p, max_new_tokens=24) for p in prompts]
    out = ref.run()
    want = [out[i] for i in ids]
    clock = StepClock()
    router, relay, (cp, _cd) = disagg_pair(
        LLMEngine, dev, ccfg, cparams, (("prefill", 4), ("decode", 4)),
        "mega", 1 << 30, clock, **CUT_ENGINE)
    try:
        _, _, got = run_router(router, clock, prompts, 24, dev, "(h3 f32)")
    finally:
        stop_router(router)
    if got != want or router.handoff_resumes != len(prompts):
        raise AssertionError(f"(h3 f32): {stream_identity(got, want)}")
    res["f32_identity"] = {"streams": len(got), "equal": True,
                           "handoffs": cp.handoffs}
    del router, relay, cp, _cd, ref, cparams
    free_memory()

    log("  (h3) int8 pools: the relayed payload and scales bit-exact")
    res["int8_relay"] = relay_bit_exact(LLMEngine, dev, cfg, params,
                                        mix[0])
    free_memory()
    return res, launches


def serve_cli(dev, card):
    """(h4): ``python -m paddle_tpu_torch.tools.serve --port 0`` on the
    card at 1024 wide, one generate, SIGINT: ``drained; bye`` and exit 0
    within 60 s. Its output goes to ``chip_smoke_out/serve_cli.log``."""
    import re
    import signal
    import threading
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "chip_smoke_out"), exist_ok=True)
    path = os.path.join(root, "chip_smoke_out", "serve_cli.log")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.serve",
           "--port", "0", "--hidden", "1024",
           "--heads", "8", "--kv-heads", "8", "--dtype", "bfloat16",
           "--block-size", "64", "--max-len", "512",
           "--flags", "serve_drain_s=30"]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, cwd=root, env=env)
    lines = []
    port_box = []
    seen = threading.Event()

    def reader():
        for raw in proc.stdout:
            line = raw.decode(errors="replace")
            lines.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m and not port_box:
                port_box.append(int(m.group(1)))
                seen.set()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        if not seen.wait(60):
            raise AssertionError("(h4): no 'serving on' line in 60 s")
        port = port_box[0]
        up_s = time.perf_counter() - t0
        raw = http_recv(http_post(port, {"prompt": [1, 2, 3],
                                         "max_new_tokens": 8}))
        term = sse_frames(http_split(raw)[1])[-1]
        if term.get("reason") != "finished" or len(term["tokens"]) != 8:
            raise AssertionError(f"(h4): terminal {term}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=max(1.0, 60 - (time.perf_counter() - t0)))
        th.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        with open(path, "w") as f:
            f.writelines(lines)
    total = time.perf_counter() - t0
    if rc != 0 or not any("drained; bye" in x for x in lines) or total > 60:
        raise AssertionError(f"(h4): exit {rc} after {total:.1f} s; tail "
                             f"{lines[-5:]}")
    return {"exit": rc, "up_s": up_s, "total_s": total,
            "terminal_tokens": len(term["tokens"]), "log": path}


def front_door_phases(llama, LLMEngine, build, dev, card, cfg8, params8,
                      tiers, ragged4):
    """Phases (h1)-(h4) on phase 4's weights, observability on for
    (h1)-(h3) and off again after; (p1)'s mega run at 8 slots is the
    direct and colocated run beside them. Returns the ``front_door``
    numbers and each leg's launches."""
    import paddle_tpu_torch.observability as obs
    t0 = time.perf_counter()
    direct = tiers["p1"]["serve_mega_8_slots"]
    res, launches = {}, {}
    obs_reset(obs)
    obs.enable()
    try:
        log("phase (h1): the HTTP/SSE front door, mega at 8 slots")
        res["h1"], l1 = front_door(LLMEngine, build, dev, card, cfg8,
                                   params8, direct)
        launches.update(l1)
        obs_reset(obs)
        log("phase (h2): the replica router, two 4-slot replicas on one "
            "card")
        res["h2"], l2 = watched(lambda: replica_router(
            llama, LLMEngine, build, dev, card, cfg8, params8, direct,
            ragged4), "(h2)")
        launches.update(l2)
        obs_reset(obs)
        log("phase (h3): disaggregated prefill/decode over a relay pool")
        res["h3"], l3 = watched(lambda: disaggregated(
            llama, LLMEngine, build, dev, card, cfg8, params8, direct),
            "(h3)")
        launches.update(l3)
    finally:
        obs.disable()
        obs.fleet.get_aggregator().detach_router()
        obs_reset(obs)
    log("phase (h4): python -m paddle_tpu_torch.tools.serve on the card")
    res["h4"] = serve_cli(dev, card)
    log(f"  {res['h4']}")
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res, launches


# ---------------------------------------------------------------------------
# phases (c1)-(c3): the training half of resilience and observability — the
# resilient loop around llama-2.6b's train step, chaos_run on the card, the
# MoE probes at phase 12's state
# ---------------------------------------------------------------------------
# (c1)'s faulted schedule: an untargeted NaN gradient, a NaN injected into
# layer 7's weights (the provenance ladder must name it) and a crash
C1_SCHEDULE = "nan_grad@2,nan_inject:7@3,crash@5"
C1_STEPS = 6
# (c1)'s depth: llama-2.6b at full width, cut from 24 layers so that the
# whole run keeps inside its time limit with (d1)-(d3)
C1_LAYERS = 12


def ckpt_scratch(need_bytes):
    """A fresh directory for (c1)'s snapshots on a file system with
    ``need_bytes`` free: the system temp dir, else ``chip_smoke_out/``
    beside the script. Returns (path, free bytes where it lies)."""
    import shutil
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    tried = []
    for base in (tempfile.gettempdir(), os.path.join(root, "chip_smoke_out")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        tried.append((base, free))
        if free >= need_bytes:
            return tempfile.mkdtemp(prefix="ptt_ckpt_", dir=base), free
    raise AssertionError(f"(c1): {need_bytes / 1e9:.1f} GB of snapshots "
                         f"fit nowhere: {tried}")


def resilient_train(llama, build, dev, card, phase8=None, lr=3e-5):
    """(c1) ``ResilientTrainLoop`` around ``llama.train_step`` on
    llama-2.6b at full width cut to ``C1_LAYERS`` layers, at phase 8's
    shape otherwise (8 x 2048, full remat, adafactor, bf16 params; 8
    seeded token batches on the card), observability and
    numerics on in both runs. A clean loop runs ``C1_STEPS`` steps with no
    checkpoint dir; a faulted one the same steps with ``ckpt_every=2``,
    ``keep=2`` under ``C1_SCHEDULE``; after the crash the newest snapshot
    is corrupted and a fresh loop resumes (chaos_run's relaunch). The
    final parameters must be allclose at 1e-6 (the elements that differ at
    all are counted), the loader positions equal, the rollback's
    ``first_bad`` and the post-mortem's provenance ``llama.layer:7``, and
    every attempt must launch B1 2L times and B2, B3 L times (the forward
    and the recompute; no plain attention on the card). Measured: save
    and load seconds against the tree's bytes, one crc validation pass,
    the steps lost, the goodput fractions, ``train_mfu`` against phase 8's
    MFU, and the loop's step time (numerics on, and off) against the bare
    ``train_step`` (3 timed steps each, no faults, no checkpoints)."""
    import functools
    import shutil
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.distributed.resilience import (
        FaultInjector, ResilientTrainLoop, ResumableIterator, SimulatedCrash,
        atomic_ckpt)
    import dataclasses
    cfg = dataclasses.replace(llama_2_6b(llama), num_layers=C1_LAYERS)
    B, S, L = 8, 2048, cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batches = [torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                             device=dev) for _ in range(8)]
    step = functools.partial(llama.train_step, config=cfg,
                             optimizer="adafactor", lr=lr,
                             adafactor_eps2=0.0)

    def state():
        return llama.init_train_state(cfg, SEED, optimizer="adafactor",
                                      param_dtype=torch.bfloat16,
                                      device=dev)

    def loop(st, **kw):
        return ResilientTrainLoop(
            step, st, ResumableIterator(lambda e: iter(batches)), **kw)

    res = {"config": f"llama-2.6b (bench.py:89-92) at full width, "
           f"{C1_LAYERS} of its 24 layers, 8 x 2048, full remat, "
           "adafactor, bf16 params", "schedule": C1_SCHEDULE,
           "steps": C1_STEPS, "card": card}
    # the bare step: 1 warm-up and 3 timed steps, synchronized at the ends
    st = state()
    st, loss = step(st, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        st, loss = step(st, batches[1 + i])
    torch.cuda.synchronize()
    res["bare_step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    del st, loss
    free_memory()
    # the loop with observability on and numerics off: 4 steps, the
    # median of the last 3 (the loop's own cost, apart from the ladder)
    obs_reset(obs)
    obs.enable()
    try:
        loop(state()).run(4)
    finally:
        obs.disable()
    secs = [e["seconds"] for e in obs.flight_recorder.get_recorder()
            .events() if e["kind"] == "step"]
    res["loop_numerics_off_step_ms"] = sorted(secs[-3:])[1] * 1e3
    free_memory()

    obs_reset(obs)
    obs.goodput.get_tracker().reset()
    obs.enable()
    obs.numerics.enable()
    ckpt_dir = None
    try:
        t0 = time.perf_counter()
        clean_loop = loop(state())
        clean = clean_loop.run(C1_STEPS)
        res["clean_s"] = time.perf_counter() - t0
        secs = [e["seconds"] for e in obs.flight_recorder.get_recorder()
                .events() if e["kind"] == "step"]
        res["loop_step_ms"] = sorted(secs[-3:])[1] * 1e3
        res["loop_step_ms_each"] = [s * 1e3 for s in secs]
        res["train_mfu"] = obs.get_registry().gauge(
            "train_mfu").labels().value
        res["loop_flops_per_step"] = clean_loop._flops
        Bb, Sb = batches[0].shape[0], batches[0].shape[1] - 1
        res["flops_per_step_want"] = llama.flops_per_token(cfg, Sb) * Bb * Sb
        if clean_loop._flops != res["flops_per_step_want"]:
            raise AssertionError(f"(c1): the loop counted "
                                 f"{clean_loop._flops} FLOPs a step")
        clean_pos = clean_loop.data.state_dict()
        tree_bytes = atomic_ckpt.tree_nbytes({"state": clean})
        res["tree_bytes"] = tree_bytes
        ckpt_dir, free = ckpt_scratch(4 * tree_bytes)
        res["ckpt_fs_free_bytes"] = free
        log(f"  clean: {C1_STEPS} steps in {res['clean_s']:.1f} s, loop "
            f"step {res['loop_step_ms']:.1f} ms (numerics off "
            f"{res['loop_numerics_off_step_ms']:.1f}, bare "
            f"{res['bare_step_ms']:.1f}), train_mfu "
            f"{res['train_mfu']:.4f}; snapshot {tree_bytes / 1e9:.3f} GB, "
            f"{free / 1e9:.1f} GB free at {ckpt_dir}")

        obs_reset(obs)
        obs.goodput.get_tracker().reset()
        inj = FaultInjector(C1_SCHEDULE)
        build.launch_counts.clear()
        t0 = time.perf_counter()
        faulted_loop = loop(state(), ckpt_dir=ckpt_dir, ckpt_every=2,
                            keep=2, injector=inj)
        try:
            faulted_loop.run(C1_STEPS)
            raise AssertionError("(c1): the injected crash never fired")
        except SimulatedCrash:
            pass
        first_events = list(faulted_loop.events)
        crash_step = faulted_loop.step
        newest = atomic_ckpt.list_checkpoints(ckpt_dir)[-1]
        with open(os.path.join(newest[1], "a00000.bin"), "r+b") as f:
            f.write(b"bitrot!!")
        del faulted_loop
        free_memory()
        relaunched = loop(state(), ckpt_dir=ckpt_dir, ckpt_every=2, keep=2,
                          injector=inj)
        faulted = relaunched.run(C1_STEPS)
        res["faulted_s"] = time.perf_counter() - t0
        launches = dict(build.launch_counts)
        events = first_events + relaunched.events
        attempts = sum(1 for e in events
                       if e["kind"] in ("rollback",)) + sum(
            1 for e in obs.flight_recorder.get_recorder().events()
            if e["kind"] == "step")
        want = {"flash_fwd": 2 * L * attempts, "flash_dq": L * attempts,
                "flash_dkv": L * attempts}
        if any(launches.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"(c1): {attempts} attempts launched "
                                 f"{launches}, expected {want}")
        rollbacks = [e for e in events if e["kind"] == "rollback"]
        named = [e.get("first_bad") for e in rollbacks]
        pm_path = os.path.join(ckpt_dir, "postmortem.json")
        obs.flight_recorder.dump(pm_path)
        with open(pm_path) as f:
            pm = json.load(f)
        provenance = (pm.get("numerics") or {}).get("provenance")
        if named != [None, "llama.layer:7"] \
                or provenance != "llama.layer:7":
            raise AssertionError(f"(c1): rollbacks name {named}, the "
                                 f"post-mortem {provenance!r}")
        pos = relaunched.data.state_dict()
        if pos != clean_pos or relaunched.skipped_batches:
            raise AssertionError(f"(c1): loader {pos} vs {clean_pos}, "
                                 f"{relaunched.skipped_batches} skipped")
        n_diff = n_elems = 0
        max_diff = 0.0
        close = True
        for a, b in zip(atomic_ckpt.flatten(clean)[0],
                        atomic_ckpt.flatten(faulted)[0]):
            n_elems += a.numel()
            n_diff += int((a != b).sum())
            max_diff = max(max_diff,
                           float((a.float() - b.float()).abs().max()))
            close = close and torch.allclose(a.float(), b.float(),
                                             rtol=1e-6, atol=1e-6)
        if not close:
            raise AssertionError(f"(c1): final states differ: {n_diff} of "
                                 f"{n_elems} elements, max {max_diff}")
        reg = obs.get_registry()
        save_h = reg.histogram("train_checkpoint_save_seconds").labels()
        load_h = reg.histogram("train_checkpoint_load_seconds").labels()
        t1 = time.perf_counter()
        atomic_ckpt.validate_checkpoint(
            atomic_ckpt.list_checkpoints(ckpt_dir)[-1][1])
        res["validate_s"] = time.perf_counter() - t1
        gp = obs.goodput.get_tracker().report()
        res.update({
            "launches": launches, "attempts": attempts,
            "crash_at_step": crash_step, "resumed_from":
                relaunched.resumed_from,
            "steps_lost": attempts - C1_STEPS,
            "rollbacks": len(rollbacks), "first_bad": named,
            "postmortem_provenance": provenance,
            "loader": pos, "elements": n_elems, "elements_differing": n_diff,
            "max_abs_diff": max_diff,
            "saves": save_h.count, "save_s_mean": save_h.sum / save_h.count,
            "loads": load_h.count, "load_s": load_h.sum,
            "save_gb_per_s": tree_bytes / (save_h.sum / save_h.count) / 1e9,
            "load_gb_per_s": tree_bytes / load_h.sum / 1e9,
            "validate_gb_per_s": tree_bytes / res["validate_s"] / 1e9,
            "goodput_ratio": gp["goodput_ratio"],
            "goodput_fractions": gp["fractions"],
            "phase8_mfu": None if phase8 is None else phase8["mfu"],
            "phase8_step_ms": None if phase8 is None
            else phase8["step_s"] * 1e3,
            "kinds": [e["kind"] for e in events]})
        log(f"  faulted: {attempts} attempts ({res['steps_lost']} lost: "
            f"{len(rollbacks)} rollbacks, crash at step {crash_step}, "
            f"resumed from {relaunched.resumed_from}) in "
            f"{res['faulted_s']:.1f} s; first_bad {named}; "
            f"{n_diff} of {n_elems} elements differ (max {max_diff}); "
            f"{save_h.count} saves, {res['save_s_mean']:.2f} s each "
            f"({res['save_gb_per_s']:.2f} GB/s), load {res['load_s']:.2f} "
            f"s, validate {res['validate_s']:.2f} s; goodput "
            f"{gp['goodput_ratio']:.3f}; card: {card}")
    finally:
        obs.numerics.disable()
        obs.disable()
        obs_reset(obs)
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, res


def chaos_on_card(card):
    """(c2) ``python -m paddle_tpu_torch.tools.chaos_run --train --device
    cuda`` in a subprocess: ``CHAOS_PARITY: OK`` and exit 0 (its output in
    ``chip_smoke_out/chaos_run_train.log``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "chip_smoke_out"), exist_ok=True)
    path = os.path.join(root, "chip_smoke_out", "chaos_run_train.log")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_run", "--train",
         "--device", "cuda"], capture_output=True, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=root), timeout=300)
    secs = time.perf_counter() - t0
    with open(path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    tail = proc.stdout.strip().splitlines()[-3:]
    if proc.returncode != 0 or "CHAOS_PARITY: OK" not in proc.stdout:
        raise AssertionError(f"(c2): exit {proc.returncode}, tail {tail}")
    return {"exit": proc.returncode, "seconds": secs, "tail": tail,
            "log": path, "card": card}


def moe_probes(moe, build, dev, card, hold=None):
    """(c3) one ``moe.forward`` at phase 12's state (``hold``, or a fresh
    one of its config: DeepSeekMoE-16B widths, 12 layers, bf16, "outs",
    the fused form) with numerics on: a warm-up forward, then one under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside the
    forward), after a flush 12 ``moe.layer`` rungs, the router-logit and
    routed-output probes, the plan-cache and fused-dispatch counters
    moved; ``quantize_expert_params`` (over the first 2 layers' experts)
    sets ``expert_int8``'s gauge. The
    forward's time with numerics on against off (CUDA events, 3 each)."""
    import dataclasses
    import paddle_tpu_torch.observability as obs
    if hold is None:
        cfg = dataclasses.replace(moe.deepseek_moe_16b(), num_layers=12,
                                  remat=True, remat_policy="outs",
                                  dispatch="fused")
        params = moe.init_params(cfg, SEED, device=dev, dtype=torch.bfloat16)
        tokens = tokens_for(cfg, 4, 2048, dev)
    else:
        cfg, tokens = hold["cfg"], hold["tokens"]
        params = hold["state"][-1].params
    toks = tokens[:, :-1]
    L = cfg.num_layers

    def fwd(i=0):
        with torch.no_grad():
            return moe.forward(params, toks, cfg)

    res = {"config": f"phase 12's: DeepSeekMoE-16B widths, {L} layers, "
           "4 x 2048, bf16, remat outs, fused", "card": card}
    obs_reset(obs)
    obs.enable()
    try:
        res["off_ms"] = time_ms(fwd, 3)
        obs.numerics.enable()
        fwd()
        obs.numerics.flush()
        obs_reset(obs)
        torch.cuda.synchronize()
        build.launch_counts.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fwd()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = dict(build.launch_counts)
        obs.numerics.flush()
        rows = obs.numerics.rows()
        rungs = [r["layer"] for r in rows if r["site"] == "moe.layer"]
        sites = sorted({r["site"] for r in rows})
        reg = obs.get_registry()
        counters = {
            "moe_plan_cache_hits_total": reg.counter(
                "moe_plan_cache_hits_total").labels().value,
            "moe_plan_cache_misses_total": reg.counter(
                "moe_plan_cache_misses_total").labels().value,
            "moe_gmm_fused_dispatch_total{path=padded}": reg.counter(
                "moe_gmm_fused_dispatch_total").labels(path="padded").value}
        if rungs != list(range(L)) or not {"moe.router_logits",
                                           "moe.routed_out"} <= set(sites) \
                or counters["moe_plan_cache_hits_total"] < 1 \
                or counters["moe_gmm_fused_dispatch_total{path=padded}"] < 1:
            raise AssertionError(f"(c3): rungs {rungs}, sites {sites}, "
                                 f"counters {counters}")
        res["on_ms"] = time_ms(fwd, 3)
        obs.numerics.flush()
        # the probe's f32 temporaries of all 12 layers' experts would take
        # ~27 GB beside the held state: the first 2 layers' experts
        cut = dict(params, layers={k: v[:2] for k, v in
                                   params["layers"].items()})
        q = moe.quantize_expert_params(cut)
        obs.numerics.flush()
        del q, cut
        qerr = reg.gauge("numerics_quant_error").labels(
            site="expert_int8").value
        if not 0 < qerr < 0.1:
            raise AssertionError(f"(c3): expert_int8 quant error {qerr}")
        res.update({"host_syncs_in_forward": 0, "rungs": rungs,
                    "sites": sites, "counters": counters,
                    "expert_int8_quant_error": qerr, "launches": launches,
                    "on_over_off": res["on_ms"] / res["off_ms"]})
        log(f"  (c3): forward {res['off_ms']:.2f} ms numerics off, "
            f"{res['on_ms']:.2f} on ({res['on_over_off']:.4f}x); no host "
            f"sync; {len(rungs)} rungs, sites {sites}, counters {counters}, "
            f"expert_int8 {qerr:.3e}; launches {launches}; card: {card}")
    finally:
        obs.numerics.disable()
        obs.disable()
        obs_reset(obs)
    return launches, res


# ---------------------------------------------------------------------------
# phases (t1)-(t3): tensor-parallel serving, two ranks on the one card
# ---------------------------------------------------------------------------
TP_SIZES = (2, 4, 8)
# B4 at phase 3's lengths (long walks cut into parts over many blocks),
# and at lengths whose tiles all fit the grid (every walk cut at each tile)
TP_B4_LENS = {"phase3": [0, 1, 64, 2000, 777, 128, 1500, 33],
              "one_tile_parts": [0, 1, 17, 32, 33, 40, 50, 64]}
# (t2)'s bf16 run: Llama-3-8B at full width (vocabulary 128256), its depth
# cut to this many layers to fit the run's time
TP_BF16_LAYERS = 8
TP_ENGINE = dict(max_slots=4, block_size=64, max_model_len=1024,
                 prompt_buckets=[256, 512], decode_steps=4, seed=SEED,
                 decode_kernel="ragged")
# (t2)/(t3)'s serving variants: engine arguments, int8 weights, a second
# round of the first two prompts (prefix-cache hits), a replicated draft
TP_VARIANTS = {
    "f32": {},
    "kv_int8": {"engine": {"kv_dtype": "int8"}},
    "w_int8": {"w_int8": True},
    "prefix_chunked": {"engine": {"prefix_cache": True,
                                  "prefill_chunk": 128}, "again": True},
    "mega_fallback": {"engine": {"decode_kernel": "mega"}},
    "spec_replicated_draft": {"spec": True},
    "bf16": {},
}
TP_F32 = [n for n in TP_VARIANTS if n != "bf16"]


def b4_tp_inputs(tpa, dev, form, lens, seed, L=4, NB=512, BS=64, Hkv=8,
                 D=128, G=4):
    """B4's inputs at the Llama-3-8B decode shape (phase 3's pools): q
    [N, 32, 128], [4, 512, 64, 8, 128] pools (bf16 or f32; ``int8``:
    ``quantize_kv`` of bf16 ones, bf16 queries), a random table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    N, MB = len(lens), 2048 // BS
    table = torch.as_tensor(rng.permutation(np.arange(1, NB))[:N * MB]
                            .reshape(N, MB).astype(np.int32), device=dev)
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    kp = torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(L, NB, BS, Hkv, D, generator=g, device=dev).to(dtype)
    q = torch.randn(N, Hkv * G, D, generator=g, device=dev).to(dtype)
    kw = {}
    if form == "int8":
        kp, vp, ks, vs = int8_pools(kp, vp)
        kw = dict(ks_pool=ks, vs_pool=vs)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens_t, kw


def b4_shard(tpa, q, kp, vp, kw, tp, r):
    """Rank r's kv-head slice of B4's inputs when tp ranks split them, and
    the keywords of its ``ragged_decode_shard`` call."""
    kw = {k: tpa.shard_kv_heads(v, tp, r, 3) for k, v in kw.items()}
    return (tpa.shard_kv_heads(q, tp, r, 1), tpa.shard_kv_heads(kp, tp, r, 3),
            tpa.shard_kv_heads(vp, tp, r, 3), dict(kw, tp=tp, rank=r))


def b4_out(part):
    """The normalized attention of B4's partials (0 where l is 0)."""
    acc, _m, l = part
    return torch.where((l > 0)[..., None], acc / l.clamp_min(1e-30)[..., None],
                       torch.zeros_like(acc))


def b4_tp_bound(tokens, N, Hkv, G, D, q_bytes, pool_bytes, scales):
    """B4's bound at this work: each walked K/V row (and its scales) read
    once, q read and the partials written once, over 3.35 TB/s; QK and PV
    over 989 TFLOP/s."""
    nbytes = 2 * tokens * Hkv * D * pool_bytes + N * Hkv * G * D * q_bytes \
        + N * Hkv * G * (D + 2) * 4 + (2 * tokens * Hkv * 4 if scales else 0)
    flops = 4.0 * tokens * Hkv * G * D
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def check_ragged_tp(tpa, dev):
    """(t1) B4's tp form in one process: at the Llama-3-8B decode shape
    (Hq=32, Hkv=8, D=128, BS=64) in bf16, f32 and int8 (bf16 queries), q
    and the pools cut into tp in {2, 4, 8} contiguous kv-head slices and
    ``ragged_decode_shard`` launched on each, as each rank's tp form does;
    the slices' partials side by side must equal the whole launch bit for
    bit (each shard walks on the whole launch's schedule). The whole
    launch is held to phase 3's tolerances against the plain version
    (normalized output, relative to its largest magnitude: bf16 1e-2, f32
    and int8 1e-5). Each shard's CUDA-event time beside the whole
    launch's. Returns the results and the kernels-line fields of the tp
    form (tp=2, rank 0's shard at phase 3's lengths)."""
    res, line = {}, {}
    for form in ("bf16", "f32", "int8"):
        tol = 1e-2 if form == "bf16" else 1e-5
        for label, lens in TP_B4_LENS.items():
            q, kp, vp, table, lens_t, kw = b4_tp_inputs(
                tpa, dev, form, lens, SEED + 40)
            whole = tpa.ragged_decode_partial(q, kp, vp, table, lens_t,
                                              layer=1, **kw)
            plain = tpa.ragged_decode_partial_plain(
                q, kp, vp, table, lens_t, 1, kw.get("ks_pool"),
                kw.get("vs_pool"))
            ref = b4_out(plain)
            scale = max(ref.abs().max().item(), 1e-30)
            err = max_err(b4_out(whole), ref) / scale
            if err > tol:
                raise AssertionError(f"(t1) B4 {form} {label}: the whole "
                                     f"launch is {err} from plain")
            whole_ms = time_ms(lambda i=0: tpa.ragged_decode_partial(
                q, kp, vp, table, lens_t, layer=1, **kw), 50)
            row = {"whole_ms": whole_ms}
            for tp in TP_SIZES:
                shards = [b4_shard(tpa, q, kp, vp, kw, tp, r)
                          for r in range(tp)]
                outs = [tpa.ragged_decode_shard(sq, sk, sv, table, lens_t,
                                                layer=1, **skw)
                        for sq, sk, sv, skw in shards]
                cat = [torch.cat([o[i] for o in outs], dim=1)
                       for i in range(3)]
                bit = all(torch.equal(c, w) for c, w in zip(cat, whole))
                diff = max(max_err(c, w) for c, w in zip(cat, whole))
                if not bit:
                    raise AssertionError(
                        f"(t1) B4 {form} {label} tp={tp}: the shards differ "
                        f"from the whole launch (max |diff| {diff})")
                ms = [time_ms(lambda i=0, s=s: tpa.ragged_decode_shard(
                    s[0], s[1], s[2], table, lens_t, layer=1, **s[3]), 50)
                      for s in shards]
                row[f"tp{tp}"] = {"bit_equal": bit, "max_abs_diff": diff,
                                  "shard_ms": ms}
                if tp == 2 and label == "phase3":
                    sq, sk, sv, skw = shards[0]
                    got = b4_out(outs[0])
                    want = b4_out(tpa.ragged_decode_partial_plain(
                        sq, sk, sv, table, lens_t, 1, skw.get("ks_pool"),
                        skw.get("vs_pool")))
                    plain_ms = time_ms(
                        lambda i=0: tpa.ragged_decode_partial_plain(
                            sq, sk, sv, table, lens_t, 1,
                            skw.get("ks_pool"), skw.get("vs_pool")), 5)
                    bound, by = b4_tp_bound(
                        sum(lens), len(lens), 4, 4, 128,
                        2 if form != "f32" else 4,
                        1 if form == "int8" else (2 if form == "bf16"
                                                  else 4), form == "int8")
                    line[form] = {
                        "max_abs_err": max_err(got, want), "ms": ms[0],
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "library_ms": None,
                        "whole_launch_ms": whole_ms,
                        "shape": f"tp=2 rank 0: N=8 sum(len)={sum(lens)} "
                                 f"Hq=16 Hkv=4 D=128 {form}"}
            res[f"{form}_{label}"] = row
            log(f"  (t1) B4 {form} at {label} lengths: whole launch "
                f"{whole_ms:.4f} ms; " + "; ".join(
                    f"tp={tp}: bit-equal {row[f'tp{tp}']['bit_equal']}, max "
                    f"|diff| {row[f'tp{tp}']['max_abs_diff']:.3g}, shards "
                    f"{[round(m, 4) for m in row[f'tp{tp}']['shard_ms']]} ms"
                    for tp in TP_SIZES))
            del q, kp, vp, kw, whole, plain
            torch.cuda.empty_cache()
    return res, line


def tp_model(llama, full_width):
    """(t2)'s models, random weights from SEED on the card: phase 5's cut
    (Llama-3-8B widths, 2 layers, a 32768 vocabulary, f32), or Llama-3-8B
    at full width in bf16 with ``TP_BF16_LAYERS`` layers."""
    import dataclasses
    if full_width:
        cfg = dataclasses.replace(llama.llama3_8b(),
                                  num_layers=TP_BF16_LAYERS)
    else:
        cfg = dataclasses.replace(llama.llama3_8b(), num_layers=2,
                                  vocab_size=32768, dtype=torch.float32)
    return cfg, llama.init_params(cfg, seed=SEED, device="cuda",
                                  dtype=cfg.dtype)


def tp_prompts(cfg, n=8):
    """(t2)'s requests: n prompts of 100-400 tokens by
    ``numpy.random.default_rng(SEED + 7)``."""
    rng = np.random.default_rng(SEED + 7)
    lens = rng.integers(100, 401, size=n)
    return [rng.integers(0, cfg.vocab_size, size=int(k)).tolist()
            for k in lens]


def tp_serve(llama, LLMEngine, build, cfg, params, name, mesh=None,
             new_tokens=24):
    """One (t2)/(t3) serving run of variant ``name`` (``TP_VARIANTS``) on
    ``TP_ENGINE``: 8 greedy requests (a second round of the first two with
    ``again``), the streams, tokens/s over the run's wall time, engine
    steps, decode calls, readbacks and collectives, and the kernels'
    launches."""
    v = TP_VARIANTS[name]
    kw = dict(TP_ENGINE, **v.get("engine", {}))
    if v.get("w_int8"):
        params = llama.quantize_params(params)
    if v.get("spec"):
        dcfg = llama.draft_config(cfg, num_layers=1)
        kw.update(draft_params=llama.init_params(
            dcfg, seed=SEED + 1, device="cuda", dtype=dcfg.dtype),
            draft_config=dcfg, spec_tokens=4)
    eng = LLMEngine(params, cfg, device="cuda", mesh=mesh, **kw)
    steps = [0]
    step = eng.step

    def counted():
        steps[0] += 1
        return step()
    eng.step = counted
    prompts = tp_prompts(cfg)
    rounds = [prompts] + ([prompts[:2]] if v.get("again") else [])
    build.launch_counts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = []
    for batch in rounds:
        ids = [eng.add_request(p, max_new_tokens=new_tokens) for p in batch]
        out = eng.run()
        streams += [out[i] for i in ids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acct = eng.block_accounting()
    if acct["backed"] != 0:
        raise AssertionError(f"(t2) {name}: blocks still backed {acct}")
    calls = sum(eng.decode_paths.values())
    return {"streams": streams,
            "tok_s": sum(len(s) for s in streams) / wall, "wall_s": wall,
            "steps": steps[0], "decode_calls": calls,
            "decode_paths": dict(eng.decode_paths),
            "mega_fallbacks": dict(eng.mega_fallbacks),
            "readbacks": dict(eng.readbacks),
            "collectives": dict(eng.tp_collectives),
            "launches": dict(build.launch_counts),
            "prefix_hits": (eng.prefix_cache.hits
                            if eng.prefix_cache is not None else None),
            "spec_waves": eng.spec_waves}


def tp_runs(llama, LLMEngine, build, mesh, tag):
    """Every (t2)/(t3) variant: the f32 ones on the cut model, then bf16
    at full width; ``mesh`` None is the single-rank engine."""
    runs = {}
    for full_width, names in ((False, TP_F32), (True, ["bf16"])):
        cfg, params = tp_model(llama, full_width)
        for name in names:
            if mesh is None and name == "mega_fallback":
                continue            # held to the single-rank f32 run
            r = runs[name] = tp_serve(llama, LLMEngine, build, cfg, params,
                                      name, mesh)
            log(f"  {tag} {name}: {r['tok_s']:.1f} tok/s, {r['steps']} "
                f"steps, {r['decode_calls']} decode calls "
                f"{r['decode_paths']}, readbacks {r['readbacks']}, "
                f"collectives {r['collectives']}, launches {r['launches']}")
        del params
        free_memory()
    return runs


def tp_rank(out_dir):
    """A rank of (t2)/(t3), started by ``distributed.spawn``: its process
    group from the env contract (the backend the parent named), a 1-D
    ``DeviceMesh`` "tp" over the card, then every variant through
    ``LLMEngine(mesh=)``; its results go to ``out_dir/rank<r>.json``."""
    torch.cuda.set_device(0)
    from torch.distributed.device_mesh import DeviceMesh

    from paddle_tpu_torch import distributed as pd
    from paddle_tpu_torch.kernels import _build as build
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import LLMEngine

    pd.init_parallel_env()
    rank = pd.get_rank()
    mesh = DeviceMesh("cuda", list(range(pd.get_world_size())),
                      mesh_dim_names=("tp",))
    build.library()          # the parent's build: no rank runs nvcc
    res = {"rank": rank, "backend": pd.get_backend(),
           "runs": tp_runs(llama, LLMEngine, build, mesh, f"[rank {rank}]")}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pd.barrier()
    pd.destroy_process_group()


def logit_margin(llama, cfg, params, prompt, stream, j, other):
    """At a greedy stream's token j: the top logit's lead over the next
    and over ``other`` (the token the other engine chose), from one plain
    forward of prompt + stream[:j] on the card."""
    toks = torch.tensor([prompt + stream[:j]], device="cuda")
    with torch.no_grad():
        logits = llama.forward(params, toks, cfg)[0, -1].float()
    top = torch.topk(logits, 2).values
    return {"top1_minus_top2": float(top[0] - top[1]),
            "chosen_minus_other": float(logits[stream[j]] - logits[other])}


def tp_serving(llama, LLMEngine, build, dev, card):
    """(t2) two ranks on the one card over gloo and (t3) the mega
    fallback and spec with a replicated draft: the single-rank engine's
    runs first, then ``distributed.spawn(nprocs=2, backend="gloo")``. The
    f32 variants must equal the single-rank streams (the mega fallback:
    the single-rank ragged f32 streams), both ranks' streams must be
    equal, mega must bow out counted (reason "mesh"), the prefix run must
    hit, spec must run waves; bf16 reports its first divergence from the
    single-rank engine and the logit margins there. Two processes
    time-share one card through host-staged collectives: the numbers are
    no tp speed."""
    import tempfile

    from paddle_tpu_torch import distributed as pd

    single = tp_runs(llama, LLMEngine, build, None, "single rank")
    out_dir = tempfile.mkdtemp(prefix="ptt_tp_")
    backend = "gloo"
    log(f"  spawning 2 ranks on the one card, backend={backend!r} (NCCL "
        f"takes one rank a device)")
    pd.spawn(tp_rank, args=(out_dir,), nprocs=2, backend=backend)
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if any(x["backend"] != backend for x in ranks):
        raise AssertionError(f"(t2) backends {[x['backend'] for x in ranks]}")
    summary = {"backend": backend, "card": card, "variants": {}}
    for name in TP_VARIANTS:
        runs = [x["runs"][name] for x in ranks]
        if runs[0]["streams"] != runs[1]["streams"]:
            raise AssertionError(f"(t2) {name}: the ranks' streams differ")
        want = single["f32" if name == "mega_fallback" else name]
        div = first_divergence(runs[0]["streams"], want["streams"])
        b4 = "ragged_decode_int8_tp" if name == "kv_int8" \
            else "ragged_decode_tp"
        calls = max(1, runs[0]["decode_calls"])
        row = {
            "equal_to_single_rank": div is None, "first_divergence": div,
            "tok_s": runs[0]["tok_s"], "single_rank_tok_s": want["tok_s"],
            "b4_tp_launches_per_rank": [x["launches"].get(b4, 0)
                                        for x in runs],
            "collectives_per_step": {k: v / runs[0]["steps"] for k, v in
                                     runs[0]["collectives"].items()},
            "collectives_per_decode_call": {
                k: v / calls for k, v in runs[0]["collectives"].items()},
            "readbacks_per_step": sum(runs[0]["readbacks"].values())
            / runs[0]["steps"],
            "readbacks": runs[0]["readbacks"],
            "steps": runs[0]["steps"], "decode_calls": calls,
            "decode_paths": runs[0]["decode_paths"],
            "launches_rank0": runs[0]["launches"]}
        if name != "spec_replicated_draft" \
                and not all(x["launches"].get(b4, 0) for x in runs):
            raise AssertionError(f"(t2) {name}: a rank launched no {b4}")
        if name == "mega_fallback":
            if not all(x["mega_fallbacks"].get("mesh", 0) >= 1
                       and "mega" not in x["decode_paths"] for x in runs):
                raise AssertionError(f"(t3) mega under the mesh: "
                                     f"{[x['mega_fallbacks'] for x in runs]}")
            row["mega_fallbacks"] = runs[0]["mega_fallbacks"]
        if name == "prefix_chunked" and not all(
                x["prefix_hits"] >= 1 for x in runs + [want]):
            raise AssertionError("(t2) the prefix run did not hit")
        if name == "spec_replicated_draft":
            if not all(x["spec_waves"] > 0 for x in runs):
                raise AssertionError("(t3) no spec wave under the mesh")
            row["spec_waves"] = runs[0]["spec_waves"]
        if name == "bf16" and div is not None:
            cfg, params = tp_model(llama, True)
            i, j = div
            prompts = tp_prompts(cfg)
            row["margins"] = logit_margin(
                llama, cfg, params, prompts[i], want["streams"][i], j,
                runs[0]["streams"][i][j])
            del params
            free_memory()
        elif div is not None:
            raise AssertionError(f"(t2) {name}: the tp streams differ from "
                                 f"the single-rank engine's at {div}")
        summary["variants"][name] = row
        log(f"  (t2) {name}: equal to the single-rank engine {div is None}"
            f"{'' if div is None else f' (first divergence {div}, margins ' + str(row.get('margins')) + ')'}"
            f"; {row['tok_s']:.1f} tok/s (single rank "
            f"{row['single_rank_tok_s']:.1f}); {b4} launches per rank "
            f"{row['b4_tp_launches_per_rank']}; collectives per step "
            f"{ {k: round(v, 2) for k, v in row['collectives_per_step'].items()} }"
            f"; readbacks per step {row['readbacks_per_step']:.2f}")
    summary["bf16_depth"] = TP_BF16_LAYERS
    return summary


def tp_phases(tpa, llama, LLMEngine, build, dev, card):
    """(t1)-(t3); returns their results and the kernels-line entries of
    B4's tp form (launches: the bf16 full-width run's, and the int8-KV
    run's for B4-int8, summed over the ranks)."""
    log("phase (t1): B4's tp form, the shards against the whole launch")
    t1, line = check_ragged_tp(tpa, dev)
    free_memory()
    log("phase (t2)-(t3): two tp ranks on the one card over gloo")
    t2 = tp_serving(llama, LLMEngine, build, dev, card)
    free_memory()
    v = t2["variants"]
    kernels = [
        dict(name="ragged_decode_tp", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/ragged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:506",
             launches=sum(v["bf16"]["b4_tp_launches_per_rank"]),
             launches_per_rank=v["bf16"]["b4_tp_launches_per_rank"],
             **line["bf16"]),
        dict(name="ragged_decode_int8_tp", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/ragged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:506",
             launches=sum(v["kv_int8"]["b4_tp_launches_per_rank"]),
             launches_per_rank=v["kv_int8"]["b4_tp_launches_per_rank"],
             **line["int8"]),
    ]
    return {"t1": t1, "t2_t3": t2}, kernels


def tp_only(tpa, llama, LLMEngine, build, dev, card) -> int:
    """``--tp``: phases (t1)-(t3) alone, then their lines; no device
    line."""
    tp, kernels = tp_phases(tpa, llama, LLMEngine, build, dev, card)
    log(f"total {time.perf_counter() - T0:.1f} s")
    log(card)
    log(json.dumps({"tp": tp}))
    log(json.dumps({"kernels": kernels}))
    return 0


def resilience_only(llama, moe, build, dev, card) -> int:
    """``--resilience``: phases (c1)-(c3) alone ((c1) without phase 8's
    MFU beside it, (c3) on a fresh state of phase 12's config), then their
    line; no device line."""
    log("phase (c1): the resilient loop around llama-2.6b's train step")
    _, c1 = resilient_train(llama, build, dev, card)
    free_memory()
    log("phase (c2): chaos_run --train on the card")
    c2 = chaos_on_card(card)
    log(f"  {c2}")
    log("phase (c3): the MoE probes at phase 12's config")
    _, c3 = moe_probes(moe, build, dev, card)
    free_memory()
    log(json.dumps({"train_resilience": {"c1": c1, "c2": c2, "c3": c3}}))
    log(f"total {time.perf_counter() - T0:.1f} s")
    log(card)
    return 0


# ---------------------------------------------------------------------------
# phases (d1)-(d3): data-parallel and sharded training (A10.2), two ranks
# on the one card over gloo
# ---------------------------------------------------------------------------
# (d1): llama-2.6b at full width cut to D1_LAYERS layers, batch 8 x 2048;
# (d2): DeepSeekMoE-16B's widths cut to D2_LAYERS layers (the first dense,
# so one MoE layer), batch 4 x 2048; each mesh runs D_STEPS steps
D1_LAYERS = 1
D2_LAYERS = 2
D1_BATCH = (8, 2048)
D2_BATCH = (4, 2048)
D_STEPS = 3
D_LR = 3e-4
# (dp, tp, fsdp) of each f32 mesh
D1_MESHES = {"dp2_fsdp": (2, 1, True), "tp2": (1, 2, True),
             "dp2_no_fsdp": (2, 1, False)}
D2_MESHES = {"dp2_fsdp": (2, 1, True), "tp2": (1, 2, True)}
# the bf16 recipes (phase 8's and phase 12's: adafactor, bf16 params,
# lr 3e-5, eps2 0) on one mesh each
D1_RECIPE_MESH = "dp2_fsdp"
D2_RECIPE_MESH = "tp2"
D_RECIPE = dict(optimizer="adafactor", lr=3e-5, adafactor_eps2=0.0)
D3_ARGS = ["--size", "740m", "--dp", "2", "--batch-size", "4", "--steps",
           "2"]
# the bf16 recipes' loss gap to the single rank's, relative to its loss:
# 5x the largest gap measured (3.9e-4 at a loss of 10.4: (d2) tp=2)
D_GAP = 2e-4
# an f32 slice element's band past 2e-5 of its leaf's largest magnitude,
# in lr a step (d_compare): 3.9x the largest error measured (0.065 lr a
# step: 5.82e-5 after 3 steps, (d2) tp=2)
D_BAND = 0.25
# B1-B3 and B9/B10 against their plain versions at the ranks' shapes (the
# card tests' tolerances: flash out/lse absolute, its grads and the
# grouped GEMMs relative to the plain result's largest magnitude)
D_FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
D_GROUPED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

D_MESHES = {}


def d_mesh(dp, tp):
    """The (dp, 1, tp) ``DeviceMesh`` over the two ranks (one object a
    shape, kept in ``D_MESHES``; both ranks make them in the same
    order)."""
    from torch.distributed.device_mesh import DeviceMesh

    if (dp, tp) not in D_MESHES:
        D_MESHES[dp, tp] = DeviceMesh("cuda", torch.arange(2).reshape(
            dp, 1, tp), mesh_dim_names=("dp", "sp", "tp"))
    return D_MESHES[dp, tp]


class WidthLog:
    """The tile width each B9/B10 call resolves (``moe_dispatch._bn``,
    read by the three wrappers), by kernel and (output width, tile);
    :meth:`clear` before a step keeps that step's calls (the first
    step's include the tile measurements)."""

    def __init__(self):
        from paddle_tpu_torch.kernels import moe_dispatch, moe_fused
        self.mods, self.seen = (moe_dispatch, moe_fused), Counter()
        self.orig = moe_dispatch._bn

        def bn(b, n):
            w = self.orig(b, n)
            self.seen[f"{sys._getframe(1).f_code.co_name} n={n} bn={w}"] \
                += 1
            return w
        for m in self.mods:
            m._bn = bn

    def clear(self):
        self.seen.clear()

    def close(self):
        for m in self.mods:
            m._bn = self.orig
        return dict(self.seen)


class NormLog:
    """Each train step's global gradient norm (``llama.global_norm``, which
    ``train_step`` calls on the step's whole grads, or under a mesh on its
    slices), and with ``noise`` the elements whose gradient was f32 noise
    around 0 in some step (nonzero and below 1e-5 of its leaf's largest:
    the CPU tests' ``grad_noise``), a tree of bool masks on the host."""

    def __init__(self, llama, noise=False):
        from paddle_tpu_torch.optimizer.functional import tree_map

        self.llama, self.orig = llama, llama.global_norm
        self.norms, self.noise = [], None

        def mark(g):
            a = g.detach().float().abs()
            return (a > 0) & (a < 1e-5 * a.max())

        def norm(grads, plan=None):
            out = self.orig(grads, plan)
            self.norms.append(out.item())
            if noise:
                m = tree_map(mark, grads)
                self.noise = m if self.noise is None else tree_map(
                    torch.logical_or, self.noise, m)
            return out
        llama.global_norm = norm

    def close(self):
        from paddle_tpu_torch.optimizer.functional import tree_map

        self.llama.global_norm = self.orig
        if self.noise is not None:
            self.noise = tree_map(lambda m: m.cpu(), self.noise)
        return self.norms


def d_steps(mod, llama, build, cfg, params0, tokens, mesh, steps, rec, *,
            fsdp=True, optimizer="adamw", lr=D_LR, adafactor_eps2=1e-3,
            param_dtype=torch.float32, widths=False):
    """``steps`` sharded train steps on this rank from the whole state
    ``params0`` (host or card) cut by ``mod.make_shardings(fsdp=)``, on
    its rows of ``tokens``: the state, each step's loss and seconds
    (synchronized), B1-B3/B9/B10 launches a step, the plan's collectives
    a step by kind and bytes, the aux loss of a MoE model's rows before
    the first step, each step's global gradient norm, and with ``widths``
    the tile width of each B9/B10 call of the last step."""
    from paddle_tpu_torch.optimizer.functional import init_moments, tree_map

    dev = torch.device("cuda", 0)
    sh = mod.make_shardings(cfg, mesh, fsdp=fsdp)
    params = tree_map(lambda t: t.to(param_dtype),
                      llama.shard_params(params0, sh, mesh, device=dev))
    mu, nu = init_moments(params, optimizer)
    st = llama.TrainState(params, mu, nu,
                          torch.zeros((), dtype=torch.int32, device=dev))
    out = {"losses": [], "step_s": [], "launches_per_step": []}
    log_w = WidthLog() if widths else None
    log_n = NormLog(llama)
    try:
        with llama.activation_mesh(mesh):
            rows = llama.shard_batch(tokens)
            if hasattr(cfg, "num_experts"):
                with torch.no_grad():
                    _, aux = mod.hidden_states_with_aux(st.params,
                                                        rows[:, :-1], cfg)
                out["aux"] = float(aux)
            for _ in range(steps):
                before = dict(build.launch_counts)
                if log_w is not None:
                    log_w.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, loss = mod.train_step(
                    st, rows, cfg, lr=lr, optimizer=optimizer,
                    adafactor_eps2=adafactor_eps2)
                out["losses"].append(loss.item())
                out["step_s"].append(time.perf_counter() - t0)
                out["launches_per_step"].append({
                    k: v - before.get(k, 0)
                    for k, v in build.launch_counts.items()
                    if v != before.get(k, 0)})
            plan = llama.train_plan(cfg, st.params)
    finally:
        out["gnorms"] = log_n.close()
        if log_w is not None:
            out["tile_widths"] = log_w.close()
    out["collectives_per_step"] = {k: v / plan.steps
                                   for k, v in plan.counts.items()}
    out["local_heads"] = (plan.config.num_heads, plan.config.num_kv_heads)
    rec[0] = st
    return out, sh


def d_reference(mod, llama, cfg, params0, tokens, steps, *,
                optimizer="adamw", lr=D_LR, adafactor_eps2=1e-3,
                param_dtype=torch.float32, keep=False):
    """The single-rank ``train_step`` on the card from the same state and
    batch: each step's loss and global gradient norm, the aux loss before
    it (MoE) and, with ``keep``, the final params on the host and where a
    step's gradient was noise around 0 (:class:`NormLog`)."""
    from paddle_tpu_torch.optimizer.functional import init_moments, tree_map

    dev = torch.device("cuda", 0)
    params = tree_map(lambda t: t.to(dev, param_dtype, copy=True), params0)
    mu, nu = init_moments(params, optimizer)
    st = llama.TrainState(params, mu, nu,
                          torch.zeros((), dtype=torch.int32, device=dev))
    out = {"losses": []}
    if hasattr(cfg, "num_experts"):
        with torch.no_grad():
            out["aux"] = float(mod.hidden_states_with_aux(
                st.params, tokens[:, :-1], cfg)[1])
    log_n = NormLog(llama, noise=keep)
    try:
        for _ in range(steps):
            st, loss = mod.train_step(st, tokens, cfg, lr=lr,
                                      optimizer=optimizer,
                                      adafactor_eps2=adafactor_eps2)
            out["losses"].append(loss.item())
    finally:
        out["gnorms"] = log_n.close()
    final = (tree_map(lambda t: t.to("cpu"), st.params), log_n.noise) \
        if keep else None
    del st, params, mu, nu, log_n
    free_memory()
    return out, final


def d_compare(llama, got, want, sh, mesh, lr, steps):
    """This rank's slices ``got`` after ``steps`` AdamW steps at ``lr``
    against the cut of the single rank's final params and noise masks
    ``want`` (:func:`d_reference`): per leaf the largest error over the
    whole leaf's largest magnitude, the share of elements past 2e-5 of
    it, and how many elements break the bound. Every element is within
    2e-5 of its leaf's largest magnitude, or within ``D_BAND`` lr a step
    (f32 sums in another order perturb a gradient's later steps by a
    fraction of lr; a gradient whose direction is wrong moves elements by
    up to 2 lr a step), or, where the single rank's gradient was noise
    around 0 in some step (the CPU tests' rule: AdamW moves such an
    element by up to lr a step whatever its sign), within 2 lr a step."""
    band, cap = D_BAND * lr * steps, 2 * lr * steps
    final, noise = want
    rows = {}

    def one(path, g, w, m, spec):
        part = llama._cut(w, spec, mesh).to(g.device, torch.float32)
        scale = float(w.float().abs().max())
        err = (g.float() - part).abs()
        off = err > 2e-5 * scale
        noise = llama._cut(m, spec, mesh).to(g.device) & (err <= cap)
        bad = off & (err > band) & ~noise
        rows[path] = {"max_rel": float(err.max()) / scale,
                      "off_share": float(off.float().mean()),
                      "off_bound": int(bad.sum()),
                      "max_abs": float(err.max())}
    for k in final:
        if isinstance(final[k], dict):
            for n in final[k]:
                one(f"{k}.{n}", got[k][n], final[k][n], noise[k][n],
                    sh[k][n])
        else:
            one(k, got[k], final[k], noise[k], sh[k])
    ok = all(r["off_bound"] == 0 for r in rows.values())
    worst = max(rows.values(), key=lambda r: r["max_rel"])
    return ok, {"worst_max_rel": worst["max_rel"],
                "worst_off_share": max(r["off_share"]
                                       for r in rows.values()),
                "worst_max_abs": max(r["max_abs"] for r in rows.values()),
                "band": band, "leaves": rows}


def d_norm_ok(run, ref):
    """The first step's global gradient norm (from the same params) within
    1e-5 relative of the single rank's: a gradient off by a factor (a
    missing 1/dp, a double reduce) moves it, where AdamW's update and the
    clipped loss may not show it."""
    return abs(run["gnorms"][0] - ref["gnorms"][0]) \
        <= 1e-5 * ref["gnorms"][0]


def d_gap(run, ref):
    """A bf16 recipe's loss gap to the single rank's each step, held to
    ``D_GAP`` of the single rank's loss (``gap_ok``)."""
    run["single_rank_losses"] = ref["losses"]
    run["single_rank_gnorms"] = ref["gnorms"]
    run["loss_gap"] = [a - b for a, b in zip(run["losses"], ref["losses"])]
    run["gap_ok"] = all(abs(g) <= D_GAP * abs(b)
                        for g, b in zip(run["loss_gap"], ref["losses"]))


def d_tokens(cfg, batch, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S = batch
    return torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev)


def d1_rank(llama, build, rank, card):
    """(d1) on this rank (phase docstring at :func:`dp_phases`)."""
    import dataclasses

    from paddle_tpu_torch import distributed as pd

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(llama_2_6b(llama), num_layers=D1_LAYERS,
                              dtype=torch.float32)
    params0 = llama.init_params(cfg, SEED, device=dev)
    tokens = d_tokens(cfg, D1_BATCH, dev, SEED + 1)
    t0 = time.perf_counter()
    ref, final = d_reference(llama, llama, cfg, params0, tokens, D_STEPS,
                             keep=True)
    res = {"config": f"llama-2.6b widths (bench.py:89-92), {D1_LAYERS} "
           f"layers, f32, full remat, adamw lr {D_LR}, batch "
           f"{D1_BATCH[0]} x {D1_BATCH[1]}", "card": card,
           "single_rank": ref, "single_rank_s": time.perf_counter() - t0,
           "meshes": {}}
    for name, (dp, tp, fsdp) in D1_MESHES.items():
        mesh = d_mesh(dp, tp)
        box = [None]
        t0 = time.perf_counter()
        run, sh = d_steps(llama, llama, build, cfg, params0, tokens, mesh,
                          D_STEPS, box, fsdp=fsdp)
        run["wall_s"] = time.perf_counter() - t0
        loss_ok = all(abs(a - b) <= 1e-5 * abs(b)
                      for a, b in zip(run["losses"], ref["losses"]))
        ok, cmp = d_compare(llama, box[0].params, final, sh, mesh, D_LR,
                            D_STEPS)
        if ok:
            cmp.pop("leaves")
        run.update(loss_within_1e5=loss_ok, slices_ok=ok, slices=cmp,
                   gnorm_within_1e5=d_norm_ok(run, ref))
        res["meshes"][name] = run
        del box
        free_memory()
        pd.barrier()
    del final
    free_memory()
    # phase 8's recipe on one mesh beside the single rank's
    dp, tp, fsdp = D1_MESHES[D1_RECIPE_MESH]
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    ref16, _ = d_reference(llama, llama, cfg16, params0, tokens, D_STEPS,
                           param_dtype=torch.bfloat16, **D_RECIPE)
    box = [None]
    t0 = time.perf_counter()
    run16, _ = d_steps(llama, llama, build, cfg16, params0, tokens,
                       d_mesh(dp, tp), D_STEPS, box, fsdp=fsdp,
                       param_dtype=torch.bfloat16, **D_RECIPE)
    run16["wall_s"] = time.perf_counter() - t0
    d_gap(run16, ref16)
    res["recipe_bf16"] = {"mesh": D1_RECIPE_MESH, **run16}
    del box, params0
    free_memory()
    pd.barrier()
    return res


def d2_rank(moe, llama, build, rank, card):
    """(d2) on this rank: the single-rank f32 reference runs one rank at
    a time (its adamw state is ~26 GB), the meshes on both."""
    import dataclasses

    from paddle_tpu_torch import distributed as pd

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(moe.deepseek_moe_16b(), num_layers=D2_LAYERS,
                              dtype=torch.float32, remat=False,
                              dispatch="fused")
    params0 = moe.init_params(cfg, SEED, device=dev)
    params0 = {k: ({n: t.cpu() for n, t in v.items()}
                   if isinstance(v, dict) else v.cpu())
               for k, v in params0.items()}
    free_memory()
    tokens = d_tokens(cfg, D2_BATCH, dev, SEED + 3)
    t0 = time.perf_counter()
    for turn in range(2):
        if turn == rank:
            ref, final = d_reference(moe, llama, cfg, params0, tokens,
                                     D_STEPS, keep=True)
        pd.barrier()
    res = {"config": f"DeepSeekMoE-16B widths (64 experts, top-6, expert "
           f"width 1408), {D2_LAYERS} layers (the first dense), f32, no "
           f"remat, the fused dispatch, adamw lr {D_LR}, batch "
           f"{D2_BATCH[0]} x {D2_BATCH[1]}", "card": card,
           "single_rank": ref, "single_rank_s": time.perf_counter() - t0,
           "meshes": {}}
    for name, (dp, tp, fsdp) in D2_MESHES.items():
        mesh = d_mesh(dp, tp)
        box = [None]
        t0 = time.perf_counter()
        run, sh = d_steps(moe, llama, build, cfg, params0, tokens, mesh,
                          D_STEPS, box, fsdp=fsdp)
        run["wall_s"] = time.perf_counter() - t0
        run["loss_within_1e5"] = all(
            abs(a - b) <= 1e-5 * abs(b)
            for a, b in zip(run["losses"], ref["losses"]))
        run["aux_within_1e5"] = abs(run["aux"] - ref["aux"]) \
            <= 1e-5 * abs(ref["aux"])
        ok, cmp = d_compare(llama, box[0].params, final, sh, mesh, D_LR,
                            D_STEPS)
        if ok:
            cmp.pop("leaves")
        run.update(slices_ok=ok, slices=cmp,
                   gnorm_within_1e5=d_norm_ok(run, ref))
        res["meshes"][name] = run
        del box
        free_memory()
        pd.barrier()
    del final
    free_memory()
    dp, tp, fsdp = D2_MESHES[D2_RECIPE_MESH]
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    ref16, _ = d_reference(moe, llama, cfg16, params0, tokens, D_STEPS,
                           param_dtype=torch.bfloat16, **D_RECIPE)
    box = [None]
    t0 = time.perf_counter()
    run16, _ = d_steps(moe, llama, build, cfg16, params0, tokens,
                       d_mesh(dp, tp), D_STEPS, box, fsdp=fsdp,
                       param_dtype=torch.bfloat16, widths=True, **D_RECIPE)
    run16["wall_s"] = time.perf_counter() - t0
    d_gap(run16, ref16)
    res["recipe_bf16"] = {"mesh": D2_RECIPE_MESH, **run16}
    del box, params0
    free_memory()
    pd.barrier()
    return res


def d_kernel_shapes(llama, moe):
    """The shapes and dtypes the (d1)/(d2) ranks give B1-B3 ((B, S, Hq,
    Hkv, D): a rank's batch rows and heads) and B9/B10 ((T, h, f, E, k):
    a rank's tokens and expert width), f32 on every mesh and bf16 on the
    recipes' meshes, each with the meshes that give it."""
    flash, grouped = {}, {}
    for ph, c, (B, S), meshes, recipe in (
            ("d1", llama_2_6b(llama), D1_BATCH, D1_MESHES, D1_RECIPE_MESH),
            ("d2", moe.deepseek_moe_16b(), D2_BATCH, D2_MESHES,
             D2_RECIPE_MESH)):
        for name, (dp, tp, _) in meshes.items():
            fs = (B // dp, S, c.num_heads // tp, c.num_kv_heads // tp,
                  c.head_dim)
            gs = (B // dp * S, c.hidden_size, c.moe_intermediate_size // tp,
                  c.num_experts, c.top_k) if ph == "d2" else None
            for dt in ((torch.float32, torch.bfloat16) if name == recipe
                       else (torch.float32,)):
                flash.setdefault((fs, dt), []).append(f"{ph} {name}")
                if gs is not None:
                    grouped.setdefault((gs, dt), []).append(f"{ph} {name}")
    return flash, grouped


def d_check_flash(tfa, dev, shape, dt):
    """B1 forward and B2/B3 backward (causal) at ``shape`` against their
    plain versions: the largest errors (out and lse absolute, the grads
    relative to the plain grad's largest magnitude)."""
    B, S, hq, hkv, D = shape
    g = torch.Generator(device=dev).manual_seed(S + hq + B)
    q, k, v, do = (torch.randn(sh, generator=g, device=dev).to(dt)
                   for sh in ((B, S, hq, D), (B, S, hkv, D), (B, S, hkv, D),
                              (B, S, hq, D)))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    err = {"flash_fwd": max(max_err(out, ref), max_err(lse, ref_lse))}
    del ref, ref_lse
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    err["flash_dq"] = rel_err(got[0], want[0])
    err["flash_dkv"] = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
    return err


def d_check_grouped(tmdisp, tmf, dev, shape, dt):
    """Every B9/B10 call of the fused dispatch's forward and backward at
    ``shape`` (the tile-padded layout of a skewed top-k routing), at both
    tile widths, against their plain versions: the largest error of each
    kernel relative to the plain result's largest magnitude. B9's gate|up
    (n = 2f); gmm's down projection (N = h), its dgrad (N = f) and
    gate|up's dgrad (N = h); tgmm's gate|up and down wgrads."""
    T, h, f, E, k = shape
    g = torch.Generator(device=dev).manual_seed(T + f)
    logits = torch.randn(T, E, generator=g, device=dev)
    logits[:, 0] += 1.0
    r = tmdisp.routing_from_logits(logits, k)
    inv2d = tmf._inverse_permutation(r.order).reshape(T, k)
    tok_pad, _, _, _, gs_pad = tmf._pad_layout(
        r.gs, r.tok, r.weights.reshape(-1)[r.order], r.flat_e[r.order],
        inv2d, E)
    gid = tmf._tile_gids(gs_pad, tok_pad.shape[0], 128)
    rows = tok_pad.shape[0]

    def rnd(*sh, scale=1.0):
        return (torch.randn(sh, generator=g, device=dev) * scale).to(dt)
    x = rnd(T, h)
    wcat, wd = rnd(E, h, 2 * f, scale=h ** -0.5), rnd(E, f, h,
                                                      scale=f ** -0.5)
    zw, dys, dgu = rnd(rows, f), rnd(rows, h), rnd(rows, 2 * f)
    xs = x.index_select(0, tok_pad)
    calls = {
        "gather_gmm": [(tmf.gather_gmm, tmf.gather_gmm_plain,
                        (x, tok_pad, wcat, gid))],
        "gmm": [(tmdisp.gmm, tmdisp.gmm_plain, (zw, wd, gs_pad, False)),
                (tmdisp.gmm, tmdisp.gmm_plain, (dys, wd, gs_pad, True)),
                (tmdisp.gmm, tmdisp.gmm_plain, (dgu, wcat, gs_pad, True))],
        "tgmm": [(tmdisp.tgmm, tmdisp.tgmm_plain, (xs.t(), dgu, gs_pad, dt)),
                 (tmdisp.tgmm, tmdisp.tgmm_plain, (zw.t(), dys, gs_pad, dt))]}
    err = {}
    for name, runs in calls.items():
        for kern, plain, args in runs:
            want = plain(*args)
            for bn in (128, 256):
                err[name] = max(err.get(name, 0.0),
                                rel_err(kern(*args, bn=bn), want))
            del want
    return err


def d_kernel_checks(dev):
    """B1-B3, B9 and B10 called on the card at each shape and dtype that
    (d1)/(d2)'s ranks give them (:func:`d_kernel_shapes`: 12/4 and 8/8
    heads at tp=2, expert width 704 at tp=2, whose last column tile is
    ragged at both tile widths) against their plain versions within
    ``D_FLASH_TOL``/``D_GROUPED_TOL``; raises on a miss. These launches
    are no (d) rank's."""
    from paddle_tpu_torch.kernels import moe_dispatch as tmdisp
    from paddle_tpu_torch.kernels import moe_fused as tmf
    from paddle_tpu_torch.kernels import pallas_attention as tfa
    from paddle_tpu_torch.models import llama, moe

    flash, grouped = d_kernel_shapes(llama, moe)
    out = []
    for table, check, tol in (
            (flash, functools.partial(d_check_flash, tfa), D_FLASH_TOL),
            (grouped, functools.partial(d_check_grouped, tmdisp, tmf),
             D_GROUPED_TOL)):
        for (shape, dt), runs in table.items():
            err = check(dev, shape, dt)
            free_memory()
            row = {"shape": list(shape), "dtype": str(dt).split(".")[-1],
                   "runs": runs, "max_err": err, "tol": tol[dt]}
            out.append(row)
            if any(e > tol[dt] for e in err.values()):
                raise AssertionError(f"(d) kernel against plain: {row}")
    return out


def dp_rank(out_dir, card):
    """A rank of (d1)-(d2), started by ``distributed.spawn``: the card,
    then the gloo group (the backend the parent named), then the phases;
    its results go to ``out_dir/rank<r>.json``."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch import distributed as pd
    from paddle_tpu_torch.kernels import _build as build
    from paddle_tpu_torch.models import llama, moe

    pd.init_parallel_env()
    rank = pd.get_rank()
    build.library()          # the parent's build: no rank runs nvcc
    res = {"rank": rank, "backend": pd.get_backend()}
    t0 = time.perf_counter()
    res["d1"] = d1_rank(llama, build, rank, card)
    res["d1"]["seconds"] = time.perf_counter() - t0
    log(f"  [rank {rank}] (d1) done in {res['d1']['seconds']:.1f} s")
    t0 = time.perf_counter()
    res["d2"] = d2_rank(moe, llama, build, rank, card)
    res["d2"]["seconds"] = time.perf_counter() - t0
    log(f"  [rank {rank}] (d2) done in {res['d2']['seconds']:.1f} s")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pd.barrier()
    pd.destroy_process_group()


def start_example():
    """(d3)'s command started in the background: ``python -m
    paddle_tpu_torch.examples.llama_pretrain`` with ``D3_ARGS`` under
    ``PADDLE_DISTRI_BACKEND=gloo`` (it starts its two ranks itself; its
    output goes to ``chip_smoke_out/llama_pretrain_dp2.log``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "chip_smoke_out"), exist_ok=True)
    path = os.path.join(root, "chip_smoke_out", "llama_pretrain_dp2.log")
    f = open(path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.examples.llama_pretrain",
         *D3_ARGS], stdout=f, stderr=subprocess.STDOUT, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=root, PADDLE_DISTRI_BACKEND="gloo"))
    return proc, f, path, time.perf_counter()


def finish_example(started, card):
    """(d3): exit 0 and the example's loss and tokens/s lines."""
    proc, f, path, t0 = started
    try:
        proc.wait(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()
    secs = time.perf_counter() - t0
    with open(path) as g:
        out = g.read().splitlines()
    lines = [x for x in out if x.startswith("loss ") or "tokens/s over" in x]
    if proc.returncode != 0 or len(lines) != 2:
        raise AssertionError(f"(d3): exit {proc.returncode}, lines {lines}, "
                             f"tail {out[-3:]}")
    loss = float(lines[0].split()[1])
    if not math.isfinite(loss):
        raise AssertionError(f"(d3): loss {loss}")
    return {"command": "python -m paddle_tpu_torch.examples.llama_pretrain "
            + " ".join(D3_ARGS), "backend": "gloo", "lines": lines,
            "loss": loss, "seconds": secs, "log": path, "card": card}


def dp_phases(build, card):
    """(d1)-(d3). Two ranks share the one card over gloo
    (``distributed.spawn(nprocs=2, backend="gloo")``; NCCL takes one rank
    a device), each running ``train_step`` under ``llama.activation_mesh``
    on its slices and rows:

    (d1) llama-2.6b at full width (hidden 3072, 24/8 heads, vocab 32768,
         full remat) cut to ``D1_LAYERS`` layers, batch 8 x 2048, f32
         adamw: ``D_STEPS`` steps at dp=2 with fsdp, tp=2, and dp=2
         without fsdp from the single-rank state and batch; each rank's
         losses within 1e-5 relative of the single-rank ``train_step`` on
         the card and its slices within the CPU tests' f32 bound (every
         element within 2e-5 of its leaf's largest magnitude, or within
         2 lr a step for at most one in a thousand, AdamW's noise around
         0); then phase 8's recipe (adafactor, bf16 params, lr 3e-5) at
         dp=2 with fsdp, its loss gap against the single rank's;
    (d2) DeepSeekMoE-16B's widths (64 experts, top-6, width 1408) cut to
         ``D2_LAYERS`` layers (the first dense), batch 4 x 2048, the same
         checks at dp=2 (fsdp) and tp=2, the aux loss of each rank's rows
         equal to the single rank's, then phase 12's recipe at tp=2 (the
         experts' width 704 a rank), with the tile width each B9/B10 call
         ran at;
    (d3) ``examples/llama_pretrain.py --size 740m --dp 2 --batch-size 4
         --steps 2`` (its full depth) prints its loss and tokens/s.

    Per rank: B1-B3 (B9/B10) launches a step, the collectives a step by
    kind and bytes, step seconds. (d3) runs beside (d1)-(d2) (its two
    ranks and theirs share the card and the host). Processes that
    time-share one card through host-staged collectives: the times are
    no dp or tp speed."""
    import tempfile

    from paddle_tpu_torch import distributed as pd

    out_dir = tempfile.mkdtemp(prefix="ptt_dp_")
    log("phase (d1)-(d3): two ranks on the one card over gloo: llama-2.6b "
        "and DeepSeekMoE-16B widths, sharded train steps against the "
        "single rank's; beside them examples/llama_pretrain.py --size "
        "740m --dp 2")
    example = start_example()
    try:
        t0 = time.perf_counter()
        checks = d_kernel_checks(torch.device("cuda", 0))
        log(f"  (d) B1-B3, B9, B10 at the ranks' shapes vs plain in "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{json.dumps([(c['runs'], c['dtype'], c['max_err']) for c in checks])}")
        pd.spawn(dp_rank, args=(out_dir, card), nprocs=2, backend="gloo")
    except BaseException:
        example[0].kill()
        example[0].wait()
        example[1].close()
        raise
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if any(x["backend"] != "gloo" for x in ranks):
        raise AssertionError(f"(d) backends {[x['backend'] for x in ranks]}")
    summary = {"backend": "gloo", "card": card, "kernel_checks": checks}
    for phase, kernels in (("d1", ("flash_fwd", "flash_dq", "flash_dkv")),
                           ("d2", ("flash_fwd", "flash_dq", "flash_dkv",
                                   "gather_gmm", "gmm", "tgmm"))):
        rows = {"config": ranks[0][phase]["config"],
                "single_rank": ranks[0][phase]["single_rank"],
                "seconds_per_rank": [x[phase]["seconds"] for x in ranks],
                "single_rank_s_per_rank": [x[phase]["single_rank_s"]
                                           for x in ranks],
                "meshes": {}}
        runs = dict(ranks[0][phase]["meshes"],
                    recipe_bf16=ranks[0][phase]["recipe_bf16"])
        for name in runs:
            per = [x[phase]["meshes"][name] if name != "recipe_bf16"
                   else x[phase]["recipe_bf16"] for x in ranks]
            launches = [{k: v for k, v in p["launches_per_step"][-1].items()
                         if k in kernels} for p in per]
            if not all(all(ln.get(k, 0) > 0 for k in kernels)
                       for ln in launches):
                raise AssertionError(f"({phase}) {name}: a rank launched "
                                     f"none of a kernel: {launches}")
            if per[0]["losses"] != per[1]["losses"]:
                raise AssertionError(f"({phase}) {name}: the ranks' losses "
                                     f"differ: {[p['losses'] for p in per]}")
            if name != "recipe_bf16":
                bad = [p for p in per if not (p["loss_within_1e5"]
                                              and p["gnorm_within_1e5"]
                                              and p["slices_ok"]
                                              and p.get("aux_within_1e5",
                                                        True))]
                if bad:
                    raise AssertionError(
                        f"({phase}) {name}: against the single rank "
                        f"{rows['single_rank']}: "
                        f"{[{k: p.get(k) for k in ('losses', 'gnorms', 'aux', 'slices')} for p in bad]}")
            elif not all(p["gap_ok"] for p in per):
                raise AssertionError(
                    f"({phase}) {name}: loss gap {per[0]['loss_gap']} past "
                    f"{D_GAP} of the single rank's losses "
                    f"{per[0]['single_rank_losses']}")
            rows["meshes"][name] = {
                "losses": per[0]["losses"],
                "gnorms": per[0]["gnorms"],
                "launches_per_step_per_rank": launches,
                "collectives_per_step": per[0]["collectives_per_step"],
                "step_s_per_rank": [p["step_s"] for p in per],
                "wall_s_per_rank": [p.get("wall_s") for p in per],
                **{k: per[0][k] for k in ("aux", "slices", "loss_gap",
                                          "single_rank_losses",
                                          "single_rank_gnorms",
                                          "local_heads")
                   if k in per[0]},
                **({"tile_widths_per_rank": [p["tile_widths"]
                                             for p in per]}
                   if "tile_widths" in per[0] else {})}
            log(f"  ({phase}) {name}: losses {per[0]['losses']} (single "
                f"rank {per[0].get('single_rank_losses', rows['single_rank']['losses'])}); "
                f"launches a step per rank {launches}; collectives a step "
                f"{ {k: round(v, 1) for k, v in per[0]['collectives_per_step'].items()} }; "
                f"gnorms {per[0]['gnorms']}; "
                f"step s {[round(s, 2) for s in per[0]['step_s']]}")
        summary[phase] = rows
    summary["d3"] = finish_example(example, card)
    log(f"  (d3): {summary['d3']['lines']} in "
        f"{summary['d3']['seconds']:.1f} s")
    return summary


def dp_only(build, card) -> int:
    """``--dp``: phases (d1)-(d3) alone, then their line; no device
    line."""
    dp = dp_phases(build, card)
    log(f"total {time.perf_counter() - T0:.1f} s")
    log(card)
    log(json.dumps({"dp": dp}))
    return 0


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
    dev = torch.device("cuda", 0)
    # the measured tile widths and dispatch forms of this run persist in a
    # directory of its own (removed at exit), never in an earlier run's
    import tempfile
    from paddle_tpu_torch.framework.flags import set_flags
    jit_dir = tempfile.TemporaryDirectory(prefix="ptt_jit_cache_")
    set_flags({"jit_cache_dir": jit_dir.name})

    log("phase 1: device")
    card = nvidia_smi()
    log(f"  {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    log(f"  kernels built in {build.build_seconds:.1f} s")

    if sys.argv[1:] == ["--serving"]:
        return serving_only(llama, LLMEngine, build, dev, card)
    if sys.argv[1:] == ["--resilience"]:
        return resilience_only(llama, moe, build, dev, card)
    if sys.argv[1:] == ["--tp"]:
        return tp_only(tpa, llama, LLMEngine, build, dev, card)
    if sys.argv[1:] == ["--dp"]:
        return dp_only(build, card)

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

    cfg8, params8, runs = serving_runs(llama, LLMEngine, build, dev, card)
    launches, serving, bf16_streams, num_blocks = runs["phase4_ragged_8"]
    mega_launches, mega, m_streams, _ = runs["phase6c_mega_4"]
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
    mega["B5"] = b5

    tiers, tier_launches = serving_tiers(
        llama, LLMEngine, build, dev, card, cfg8, params8, serving,
        bf16_streams)
    resilience, r_launches = serving_resilience(
        llama, LLMEngine, build, dev, card, cfg8, params8, serving,
        bf16_streams)
    tier_launches.update(r_launches)
    observed, o_launches = observability_phases(
        LLMEngine, build, dev, card, cfg8, params8, serving, tiers)
    tier_launches.update(o_launches)
    front, h_launches = front_door_phases(
        llama, LLMEngine, build, dev, card, cfg8, params8, tiers,
        mega["ragged_same_mix"])
    tier_launches.update(h_launches)

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

    log("phase (g1): generate and generate_fused, Llama-3-8B, batch 8")
    generation = {"g1_full_width": generation_full_width(
        llama, LLMEngine, dev, card, cfg8, params8)}
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

    log("phase (g2): card vs CPU generation and the HF round trip (phase "
        "5's cut model)")
    generation["g2_cross_device"] = generation_cross_device(
        llama, LLMEngine, dev)
    CUT.clear()
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

    log("phase (c1): the resilient loop around llama-2.6b's train step")
    c_launches, c1 = resilient_train(llama, build, dev, card, training)
    free_memory()
    log("phase (c2): chaos_run --train on the card")
    train_resilience = {"c1": c1, "c2": chaos_on_card(card)}
    log(f"  {train_resilience['c2']}")

    log("phase 11: B9 gather_gmm, B10 gmm and tgmm vs plain")
    grouped_errs = check_grouped(tmdisp, tmf, dev)
    free_memory()

    log("phase (m3): the grouped GEMMs' tile widths measured at phase 12's "
        "shapes")
    tiles = tile_autotune(tmdisp, tmf, dev)
    free_memory()

    log("phase (m1): the dispatch form measured at phase 12's routing shape")
    forms = {"m1_form_pick": form_pick(tmdisp, dev)}
    free_memory()

    log("phase 12: moe.train_step trains DeepSeekMoE-16B widths")
    hold = {}
    moe_launches, moe_training = train_moe(moe, build, tmf, dev, card,
                                           hold=hold)
    free_memory()

    log("phase (m2)-(m4): the dense form's step, tuned against heuristic "
        "widths, what remat outs keeps (phase 12's state)")
    forms.update(moe_phase12_forms(moe, llama, tmdisp, build, dev, card,
                                   hold, moe_training))
    log("phase (c3): the MoE probes at phase 12's state")
    c3_launches, train_resilience["c3"] = moe_probes(moe, build, dev, card,
                                                     hold)
    del hold
    free_memory()
    forms["m2_cross_device"] = moe_dense_cross_device(
        moe, llama, tmdisp, tmf, build, dev)
    forms["m3_tiles"] = tiles
    moe_training["forms"] = forms
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

    tp, tp_kernels = tp_phases(tpa, llama, LLMEngine, build, dev, card)
    free_memory()
    dp = dp_phases(build, card)

    # B5's static schedules: printed apart from the kernels line, whose
    # numbers (bound_ms aside) are measured in this run
    schedules = {"mega_decode": b5.pop("schedule"),
                 "mega_decode_int8": b5_int8.pop("schedule"),
                 "mega_decode_loop": b5_multi["schedule"]}
    # the tile width each B9/B10 call of phase 12's step ran at (m3)
    won = {name: site["winner"] for name, site in tiles.items()}
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
             tile_widths={"gate|up forward": won["fused gate|up"][0]},
             **grouped["gather_gmm"]),
        dict(name="gmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/gmm.cu",
             replaces="paddle_tpu/kernels/moe_dispatch.py:434",
             launches=moe_launches.get("gmm", 0),
             train8b_launches=t_launch["gmm"],
             tile_widths={"down forward": won["fused down"][0],
                          "down dgrad": won["fused down"][1],
                          "gate|up dgrad": won["fused gate|up"][1],
                          "gmm form": won["gmm gate|up"]
                          + won["gmm down"]},
             **grouped["gmm"]),
        dict(name="tgmm", route="cuda",
             source="paddle_tpu_torch/kernels/csrc/tgmm.cu",
             replaces="paddle_tpu/kernels/moe_dispatch.py:445",
             launches=moe_launches.get("tgmm", 0),
             train8b_launches=t_launch["tgmm"],
             tile_widths={"gate|up wgrad": won["fused gate|up"][2],
                          "down wgrad": won["fused down"][2]},
             **grouped["tgmm"]),
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
    kernels += tp_kernels
    # each kernel's launches a step per rank in (d1)/(d2)'s runs, and the
    # tile width each B9/B10 call of (d2)'s bf16 run resolved
    for k in kernels:
        for ph in ("d1", "d2"):
            per = {m: [n.get(k["name"], 0)
                       for n in row["launches_per_step_per_rank"]]
                   for m, row in dp[ph]["meshes"].items()}
            if any(any(v) for v in per.values()):
                k[f"{ph}_launches_per_step_per_rank"] = per
        errs = {f"{'/'.join(row['runs'])} {row['dtype']}":
                row["max_err"][k["name"]] for row in dp["kernel_checks"]
                if k["name"] in row["max_err"]}
        if errs:
            k["d_max_err_vs_plain"] = errs
        if k["name"] in ("gather_gmm", "gmm", "tgmm"):
            k["d2_tile_widths_per_rank"] = [
                {w: n for w, n in widths.items()
                 if w.startswith(k["name"] + " ")}
                for widths in dp["d2"]["meshes"]["recipe_bf16"]
                ["tile_widths_per_rank"]]
    tier_launches["c1_faulted"] = c_launches
    tier_launches["c3_moe_forward"] = c3_launches
    # each kernel's launches in the runs of phases (p1)-(p3), (r1)-(r3),
    # (o1)-(o3), (h1)-(h3), (c1) and (c3)
    for k in kernels:
        k["tier_launches"] = {run: n[k["name"]] for run, n in
                              tier_launches.items() if n.get(k["name"])}
    log(f"serving: {json.dumps(serving)}")
    log(f"serving_tiers: {json.dumps(tiers)}")
    log(f"serving_resilience: {json.dumps(resilience)}")
    log(f"mega: {json.dumps(mega)}")
    log(f"training: {json.dumps(training)}")
    log(f"moe_training: {json.dumps(moe_training)}")
    log(f"int8: {json.dumps(int8_res)}")
    log(f"training_memory: {json.dumps(tm_res)}")
    spec["paged_api_checks"] = paged["checks"]
    log(f"spec: {json.dumps(spec)}")
    log(f"generation: {json.dumps(generation)}")
    log(f"total {time.perf_counter() - T0:.1f} s")
    log(card)
    log(json.dumps({"static_schedule": schedules}))
    log(json.dumps({"observability": observed}))
    log(json.dumps({"front_door": front}))
    log(json.dumps({"train_resilience": train_resilience}))
    log(json.dumps({"tp": tp}))
    log(json.dumps({"dp": dp}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
