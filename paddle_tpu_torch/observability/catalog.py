"""Metric-name catalogue — the documented contract; the port's copy of
paddle_tpu/observability/catalog.py, row for row.

One place naming every metric the framework emits, its kind, and its
labels. The rows equal the reference's (names, kinds, labels, help and
bucket ranges), so one dashboard reads either package; rows no port
module instruments yet (the router, the HTTP front door, the fleet view,
the training half) wait for their queue items and are listed in
tests/test_torch_observability.py. The help strings keep the
reference's wording, TPU terms included: they name the same quantity.

Conventions:
- snake_case, subsystem prefix first (``serving_``, ``train_``, ...);
- counters end in ``_total``; durations are ``_seconds`` histograms;
- labels are LOW-cardinality enums (reason, tag, phase) — never ids.
"""
from __future__ import annotations

# name -> (kind, labels, help)
CATALOG = {
    # -- serving (LLMEngine) ----------------------------------------------
    "serving_queue_depth": (
        "gauge", (), "requests waiting for a slot"),
    "serving_active_slots": (
        "gauge", (), "slots currently decoding"),
    "serving_kv_pool_used_blocks": (
        "gauge", (), "KV-pool blocks allocated to live sequences"),
    "serving_kv_pool_blocks": (
        "gauge", (), "usable KV-pool block capacity (excludes trash block)"),
    "serving_admissions_total": (
        "counter", (), "requests admitted to a slot (incl. re-admissions)"),
    "serving_preemptions_total": (
        "counter", (), "recompute-preemptions under KV-pool pressure"),
    "serving_requests_finished_total": (
        "counter", (), "requests completed (eos or budget)"),
    "serving_tokens_total": (
        "counter", (), "generated tokens delivered to the host"),
    "serving_ttft_seconds": (
        "histogram", (), "time from add_request to first host-visible token"),
    "serving_tokens_per_second": (
        "histogram", (),
        "host-visible generation throughput per engine step"),
    # ^ throughput, not a duration: gets its own bucket range below
    "serving_step_seconds": (
        "histogram", (), "wall time of one LLMEngine.step call"),
    "serving_decode_prefix_bucket": (
        "gauge", (), "prefix horizon (tokens) of the decode dispatched "
                     "last — power-of-two bucket ceiling on the "
                     "bucketed path, true max(lengths) rounded to a "
                     "block on the ragged-kernel path"),
    "serving_decode_recompiles_total": (
        "counter", (), "decode program variants compiled (ragged path: "
                       "one per sampling-flag tuple, <= 8; bucketed "
                       "fallback: (prefix bucket, flags) tuples, "
                       "bounded at log2(blocks/slot) x 8)"),
    "serving_decode_kv_read_bytes": (
        "gauge", (), "K/V pool bytes one decode attention pass reads — "
                     "bucket ceiling x slots on the bucketed path, the "
                     "slots' true-length block walks on the ragged path "
                     "(int8 pools halve either)"),
    "serving_decode_kernel_total": (
        "counter", ("path",),
        "decode dispatches by attention path (mega = persistent fused "
        "megakernel, one launch per decode step; ragged = true-length "
        "Pallas block-walk kernel, one launch per layer; bucketed = "
        "power-of-two dense gather, dense = gather at the full "
        "allocation horizon) — the off-TPU fallback is counted here, "
        "never silent"),
    "serving_decode_variants": (
        "gauge", (), "compiled decode program variants currently cached "
                     "(mega/ragged paths: exactly one per (batch, "
                     "sampling-flags) set — test-enforced)"),
    "serving_mega_fallback_total": (
        "counter", ("reason",),
        "decode dispatches that wanted the mega megakernel but fell "
        "back to the ragged walk (vmem = the kernel's scratch envelope "
        "exceeds the ~12 MiB budget, mixed_weights = partially "
        "quantized layer stack, mesh = tp-sharded serving runs the "
        "shard_mapped ragged walk instead; draft_* = the speculative "
        "draft's own screen) — the fallback is counted, never silent"),
    # -- serving speculative decoding (draft-then-verify waves) ------------
    "serving_spec_proposed_total": (
        "counter", (), "draft tokens proposed to the target's batched "
                       "verify (spec_tokens per slot per wave, clamped "
                       "to each slot's remaining budget)"),
    "serving_spec_accepted_total": (
        "counter", (), "proposed draft tokens the target's greedy "
                       "verify agreed with (the accepted prefix; "
                       "acceptance rate = accepted / proposed)"),
    "serving_spec_acceptance_rate": (
        "gauge", (), "cumulative draft-token acceptance rate "
                     "(accepted / proposed since engine start) — the "
                     "speculative speedup's one load-bearing number"),
    "serving_spec_tokens_per_wave": (
        "gauge", (), "cumulative committed tokens per draft-verify "
                     "wave (> 1 means each target verify call emits "
                     "more than one token — the mechanism working)"),
    # -- serving HTTP/SSE front door (serving.http) -------------------------
    "serving_http_requests_total": (
        "counter", ("code",),
        "HTTP responses by status code (200 streams, 400 bad request, "
        "429 rate_limited, 503 queue_full/pool_pressure/draining, "
        "408 client gone before the response)"),
    "serving_http_active_streams": (
        "gauge", (), "in-flight /v1/generate requests the front door "
                     "currently owns (admitted, not yet terminal)"),
    "serving_http_client_disconnects_total": (
        "counter", (), "requests cancelled server-side because the "
                       "client vanished — mid-stream EOF, failed "
                       "write, or a reader stalled past "
                       "FLAGS_serve_client_stall_s (terminal reason "
                       "client_disconnected; KV blocks free within "
                       "one engine step)"),
    "serving_http_send_queue_depth": (
        "gauge", (), "deepest per-connection SSE send queue at the "
                     "last stall sweep — frames produced by the "
                     "engine but not yet drained to the client "
                     "(backpressure evidence; above "
                     "FLAGS_serve_send_queue_hwm the stall clock "
                     "runs)"),
    "serving_http_drain_seconds": (
        "histogram", (), "graceful-drain duration: begin_drain/SIGTERM "
                         "to the last in-flight stream retiring "
                         "(bounded by FLAGS_serve_drain_s + one "
                         "cut-straggler step)"),
    # -- serving survivability (admission, deadlines, kv_swap, recovery) ---
    "serving_shed_total": (
        "counter", ("reason",),
        "requests rejected by admission control (queue_full / "
        "rate_limited / pool_pressure) — overload degrades, never "
        "collapses"),
    "serving_deadline_exceeded_total": (
        "counter", (), "requests evicted at their per-request deadline "
                       "(queued or mid-decode; KV blocks freed, partial "
                       "tokens delivered)"),
    "serving_kv_swap_out_total": (
        "counter", (), "preempted slots whose KV blocks moved to the "
                       "host-RAM swap tier instead of being discarded"),
    "serving_kv_swap_in_total": (
        "counter", (), "re-admissions restored from the host swap tier "
                       "(one h2d block copy instead of a full "
                       "re-prefill)"),
    "serving_kv_swap_fallback_total": (
        "counter", ("reason",),
        "preemptions that fell back to recompute (host_pool_full / "
        "nothing_to_keep)"),
    "serving_kv_swap_host_bytes": (
        "gauge", (), "bytes resident in the pinned host-RAM KV swap "
                     "pool"),
    "serving_engine_recoveries_total": (
        "counter", (), "crashed engine steps recovered by "
                       "ResilientEngine (poisoned in-flight wave "
                       "dropped, requests re-enqueued)"),
    # -- serving async KV offload tier (serving.offload) --------------------
    "serving_kv_offload_prefetch_hits_total": (
        "counter", (), "restores (swap-in re-admissions / spilled "
                       "prefix-node matches) whose payload the "
                       "prefetch-ahead engine had already staged on "
                       "device — consumed with zero inline h2d wait"),
    "serving_kv_offload_stalls_total": (
        "counter", (), "restores that found nothing staged and paid "
                       "the h2d transfer inline (plus admissions that "
                       "had to force-land a still-in-flight spill); "
                       "counted in async AND forced-sync modes, so the "
                       "async/sync bench comparison reads one counter"),
    "serving_kv_offload_stall_seconds_total": (
        "counter", (), "observed seconds restores spent blocked on "
                       "inline transfers (the latency the prefetch "
                       "tier exists to hide). Async mode measures the "
                       "full transfer wait; forced-sync mode records "
                       "only host-side dispatch time — its transfer "
                       "wait overlaps into the scatter, as pre-r15 — "
                       "so compare stall COUNTS across modes, never "
                       "seconds"),
    "serving_kv_offload_inflight_bytes": (
        "gauge", (), "bytes of async d2h spill transfers currently in "
                     "flight (their source blocks ride the block "
                     "ledger's transient in_flight term until the "
                     "step-boundary completion sweep lands them)"),
    "serving_kv_offload_proactive_spills_total": (
        "counter", (), "refcount-0 LRU cached blocks whose payload was "
                       "copied host-side in the BACKGROUND under pool "
                       "pressure — a later reclaim then frees the "
                       "device block instantly instead of paying the "
                       "d2h inline"),
    # -- serving replica router (serving.router) ---------------------------
    "serving_router_dispatch_total": (
        "counter", ("replica",),
        "streams placed on each replica (initial placement, failover "
        "resumes and drain migrations all count — placement evidence "
        "for the affinity/least-loaded policy)"),
    "serving_router_affinity_total": (
        "counter", ("outcome",),
        "placement decisions by prefix-affinity outcome (hit = a "
        "replica's shadow index held >= 1 leading block key of the "
        "prompt and won placement; miss = no replica had any, "
        "least-loaded fallback chose)"),
    "serving_router_shed_total": (
        "counter", (), "router-level sheds: every healthy replica "
                       "refused the request (admission ShedError or "
                       "death mid-dispatch on all candidates) — maps "
                       "to 503 + Retry-After at the front door"),
    "serving_router_failovers_total": (
        "counter", (), "in-flight streams orphaned by a replica death "
                       "and handed to the resume path (each increments "
                       "once per death event it survives)"),
    "serving_router_resumed_streams_total": (
        "counter", (), "streams re-dispatched to a survivor with "
                       "prompt + delivered tokens as the new prompt "
                       "(greedy parity keeps the spliced stream "
                       "token-identical to an uninterrupted run)"),
    "serving_router_dedup_drops_total": (
        "counter", (), "tokens emitted by a zombie replica for a "
                       "stream the router already failed over — "
                       "dropped at the router so the client never "
                       "sees a duplicate (the exactly-once guard)"),
    "serving_router_state_transitions_total": (
        "counter", ("state",),
        "replica health-state entries (healthy / suspect / dead / "
        "half_open / draining / drained) — the circuit breaker's "
        "audit trail"),
    "serving_router_healthy_replicas": (
        "gauge", (), "replicas currently in the healthy state (the "
                     "placeable pool; 0 means every submit sheds)"),
    # -- disaggregated prefill/decode (serving.router roles) ---------------
    "serving_disagg_handoffs_total": (
        "counter", ("outcome",),
        "prefill→decode stream handoffs by outcome (ok = the prefill "
        "replica spilled the slot's KV bit-exact into the shared host "
        "relay; restored = a decode replica consumed the entry with one "
        "batched h2d scatter instead of re-prefilling; relay_full = the "
        "relay refused the spill; missing = the entry vanished before "
        "restore — both degradations re-prefill the handed-off context, "
        "streams stay identical, counted never silent)"),
    "serving_disagg_kv_relay_bytes": (
        "gauge", (), "bytes resident in the shared prefill→decode host "
                     "relay pool (HostKVPool kind=\"relay\"); a healthy "
                     "disagg fleet drains this to 0 between bursts"),
    "serving_disagg_handoff_seconds": (
        "histogram", (), "prefill-side handoff latency: slot KV "
                         "fetch + relay publish, per handed-off "
                         "stream (the d2h leg of the disagg "
                         "transfer)"),
    # -- fleet observability (observability.fleet) -------------------------
    "serving_fleet_slo_attainment": (
        "gauge", ("replica", "slo"),
        "per-replica SLO attainment (slo=ttft|tpot) computed from the "
        "replica-labeled latency histograms against the FLAGS_obs_slo_* "
        "targets — the burn-rate input (refreshed on every fleet SLO "
        "check / router health tick)"),
    "serving_fleet_slo_breaches_total": (
        "counter", ("replica", "slo"),
        "transitions of one replica INTO SLO-budget breach (burn rate "
        "> 1 with enough samples) — each also lands an slo_breach "
        "flight event and, with FLAGS_obs_fleet_slo_advisory on, "
        "advises the router's health machine to stop placing on it"),
    "serving_fleet_scrapes_total": (
        "counter", ("endpoint",),
        "fleet federation reads by endpoint (metrics / replicas / "
        "placements) — evidence the aggregation layer is actually "
        "being consumed"),
    "serving_cancel_noop_total": (
        "counter", (), "cancel_request / _finish_expired calls against "
                       "an already-terminal rid — counted no-ops (the "
                       "router's failover path races natural finishes "
                       "by design; this must never double-free)"),
    # -- serving prefix cache + chunked prefill (serving.prefix_cache) -----
    "serving_prefix_cache_hits_total": (
        "counter", (), "admissions whose prompt matched >= 1 cached "
                       "prefix block (the matched blocks are pinned, "
                       "only the suffix prefills)"),
    "serving_prefix_cache_misses_total": (
        "counter", (), "admissions with no cached prefix block "
                       "(cold prefill of the full prompt)"),
    "serving_prefix_cache_evictions_total": (
        "counter", ("kind",),
        "cached blocks reclaimed under pool pressure (spill = payload "
        "moved to the pinned-host tier, node stays matchable; drop = "
        "node + subtree discarded)"),
    "serving_prefill_tokens_skipped_total": (
        "counter", (), "prompt tokens served from the prefix cache "
                       "instead of being re-prefilled (the cache's "
                       "FLOP savings, in tokens)"),
    "serving_prefix_cache_blocks": (
        "gauge", (), "device-resident KV blocks owned by the prefix "
                     "cache (refcounted; evicted LRU at refcount 0)"),
    "serving_prefix_cache_host_bytes": (
        "gauge", (), "bytes of spilled prefix-cache blocks resident in "
                     "the pinned host tier (HostKVPool kind=\"prefix\")"),
    # -- training (ResilientTrainLoop) ------------------------------------
    "train_steps_total": (
        "counter", (), "committed optimizer steps"),
    "train_step_seconds": (
        "histogram", (), "wall time of one train-step attempt "
                         "(committed or rolled back)"),
    "train_rollbacks_total": (
        "counter", ("reason",),
        "uncommitted steps (non_finite_loss / loss_spike)"),
    "train_retries_total": (
        "counter", (), "same-batch retries after a rollback"),
    "train_batches_skipped_total": (
        "counter", (), "batches dropped after exhausting the retry budget"),
    "train_checkpoints_total": (
        "counter", ("tag",),
        "checkpoints written (periodic / final / emergency-*)"),
    "train_emergency_saves_total": (
        "counter", (), "emergency checkpoints (SIGTERM or watchdog)"),
    "train_checkpoint_save_seconds": (
        "histogram", (), "atomic checkpoint commit duration"),
    "train_checkpoint_load_seconds": (
        "histogram", (), "resume (load_latest_valid) duration"),
    # -- data loading ------------------------------------------------------
    "dataloader_batches_total": (
        "counter", (), "batches yielded to the consumer"),
    "dataloader_batch_wait_seconds": (
        "histogram", (), "time the consumer blocked waiting on the loader"),
    "dataloader_result_queue_depth": (
        "gauge", (), "mp-loader result-queue occupancy at last get"),
    # -- distributed runtime ----------------------------------------------
    "dist_store_connect_retries_total": (
        "counter", (), "TCPStore client connect retries"),
    "dist_init_retries_total": (
        "counter", (), "jax.distributed.initialize bootstrap retries"),
    "watchdog_heartbeat_age_seconds": (
        "gauge", (), "age of the oldest in-flight guarded region (0: idle)"),
    "watchdog_timeouts_total": (
        "counter", (), "guarded regions that exceeded their timeout"),
    # -- jit / compile -----------------------------------------------------
    "jit_cache_hits_total": (
        "counter", (), "to_static calls served by a cached program"),
    "jit_cache_misses_total": (
        "counter", (), "to_static calls that traced a new program"),
    "jit_compile_seconds": (
        "histogram", (), "trace+compile+first-run time of a new program"),
    # -- MoE dispatch hot path (kernels/moe_dispatch, gmm_autotune) --------
    "moe_tiling_cache_hits_total": (
        "counter", (), "grouped-matmul tiling lookups served by a "
                       "remembered winner (in-process or persisted)"),
    "moe_tiling_cache_misses_total": (
        "counter", (), "first-encounter tiling keys (each triggers one "
                       "autotune or a heuristic fallback)"),
    "moe_tiling_autotune_seconds": (
        "histogram", (), "wall time of one candidate-grid measurement "
                         "(fwd+dgrad+wgrad) for a new tiling key"),
    "moe_plan_cache_hits_total": (
        "counter", (), "MoE dispatch plans reused across layers/steps "
                       "that share a routing shape"),
    "moe_plan_cache_misses_total": (
        "counter", (), "routing shapes that derived a fresh dispatch plan"),
    "moe_dispatch_fallbacks_total": (
        "counter", ("reason",),
        "dispatch decisions off the fast path (shape_unaligned / "
        "dense_buffer_too_big / ep_shape_mismatch)"),
    "moe_tiling_autotune_rejected_total": (
        "counter", (),
        "autotune results rejected by the never-worse guard: measured "
        "winners inside the heuristic's noise band, and persisted "
        "entries that failed validation at load (re-measured on next "
        "encounter)"),
    "moe_gmm_fused_dispatch_total": (
        "counter", ("path",),
        "fused-dispatch entries by implementation path; the port emits "
        "padded = the tile-padded pipeline through B9 (the gather-fused "
        "kernel on the card, its plain version on the CPU) and "
        "unpadded:<reason> = B9 screened out (dtype / width / rows), "
        "gather + B10 gmm; the reference's pallas / xla / xla_fallback "
        "never fire here"),
    "moe_overlap_bypass_total": (
        "counter", (),
        "expert-parallel overlap bypasses: per-rank token slices below "
        "FLAGS_moe_overlap_min_tokens ran single-buffered (halving "
        "overhead would beat the collective hiding)"),
    # -- goodput / efficiency (observability.goodput, .perf) --------------
    "goodput_ratio": (
        "gauge", (), "fraction of wall-clock spent in productive train "
                     "steps (GoodputTracker.report)"),
    "goodput_time_seconds_total": (
        "counter", ("bucket",),
        "wall-clock accounted per goodput bucket (productive_step / "
        "compile / checkpoint_save / checkpoint_load / data_wait / "
        "rollback_retry / resume)"),
    "goodput_stragglers_total": (
        "counter", (), "straggler flags raised by the per-host step-time "
                       "exchange (step time > k x cross-host median)"),
    "train_mfu": (
        "gauge", (), "model FLOP utilization of the last committed step "
                     "(cost-model FLOPs / step time / device peak)"),
    "train_tokens_per_second": (
        "gauge", (), "training tokens/s of the last committed step "
                     "(integer-dtype batch elements / step time)"),
    "hbm_used_bytes": (
        "gauge", (), "device-0 HBM bytes in use at last update "
                     "(PJRT memory_stats; 0 where unavailable)"),
    "hbm_peak_bytes": (
        "gauge", (), "device-0 HBM allocator high-water mark"),
    "serving_mfu": (
        "gauge", (), "decode-program FLOP utilization over the last "
                     "engine step (cost-model FLOPs of the dispatched "
                     "decode variant / step wall time / device peak)"),
    "serving_tpot_seconds": (
        "histogram", (), "per-request decode seconds per output token "
                         "(time-per-output-token, observed at finish; "
                         "pipelined readback batches flatten it)"),
    "serving_slo_ttft_attainment": (
        "gauge", (), "fraction of requests with TTFT <= "
                     "FLAGS_obs_slo_ttft_ms (from the TTFT histogram)"),
    "serving_slo_tpot_attainment": (
        "gauge", (), "fraction of requests with TPOT <= "
                     "FLAGS_obs_slo_tpot_ms (from the TPOT histogram)"),
    # -- crash flight recorder --------------------------------------------
    "flight_recorder_dumps_total": (
        "counter", ("trigger",),
        "post-mortem JSON dumps written (exception / watchdog / sigterm "
        "/ manual)"),
    # -- per-request tracing (observability.request_trace) -----------------
    "serving_request_queue_seconds": (
        "histogram", (), "time from add_request to first slot admission "
                         "(queue wait; re-admissions after preemption "
                         "don't re-observe)"),
    "serving_request_traces_total": (
        "counter", (), "finished request timelines moved to the "
                       "retention ring (serve via /request/<id>.json)"),
    "serving_request_slo_audits_total": (
        "counter", ("reason",),
        "finished requests breaching FLAGS_obs_slo_{ttft,tpot}_ms whose "
        "full timeline was auto-dumped to the audit log"),
    "serving_request_exemplars_total": (
        "counter", (), "TTFT/TPOT exemplar attachments — extreme "
                       "histogram observations linked to a request_id"),
    "serving_request_events_dropped_total": (
        "counter", (), "per-request timeline events dropped by "
                       "FLAGS_obs_request_events_max (decode ticks only; "
                       "lifecycle events always record)"),
    # -- on-demand device profiling (observability.profiling) --------------
    "obs_profile_captures_total": (
        "counter", (), "windowed jax.profiler device captures completed "
                       "(/control/profile, SIGUSR2, or request_capture)"),
    # -- numerics observatory (observability.numerics) ----------------------
    "numerics_quant_error": (
        "gauge", ("site",),
        "relative RMS int8 reconstruction error of the last paired "
        "pre/post-quant probe per site (weight_only / expert_int8 / "
        "kv_int8) — the per-site error budget"),
    "numerics_events_total": (
        "counter", ("site",),
        "numerics stat vectors landed in the host ring (async outfeed "
        "from in-graph probes; FLAGS_obs_numerics)"),
    "numerics_nan_total": (
        "counter", ("site",),
        "landed stat vectors whose NaN/Inf count was nonzero — the "
        "alertable health signal behind the provenance walk"),
    # -- time-series layer (observability.timeseries) ----------------------
    "obs_ts_samples_total": (
        "counter", (), "registry snapshots landed in the time-series "
                       "ring (the engine/router step tick, throttled "
                       "by FLAGS_obs_ts_interval_s)"),
    "obs_ts_ring_size": (
        "gauge", (), "samples currently resident in the time-series "
                     "ring (bounded by FLAGS_obs_ts_capacity)"),
    "obs_alerts_total": (
        "counter", ("alert", "state"),
        "alert-state EDGES by alert name (state=firing|cleared) — one "
        "increment per transition, never per evaluation, so the pair "
        "reads as a fire->clear ledger"),
    "obs_ts_window_fallbacks_total": (
        "counter", ("query",),
        "windowed queries answered by the CUMULATIVE fallback because "
        "ring history was too short (query=slo: fleet burn-rate check "
        "judged lifetime attainment instead of the fast window)"),
}

# Histogram bucket overrides: (lo, hi, per_decade) for metrics whose
# range is NOT the default duration window (100 us .. 100 s). A large
# serving batch legitimately hits 10^3..10^4 tokens/s — on duration
# buckets every such observation would collapse into +Inf.
BUCKETS = {
    "serving_tokens_per_second": (1.0, 1e5, 3),
}

# Span names the framework emits (chrome-trace `name` field).
SPANS = (
    "serving.step", "serving.prefill", "serving.decode", "serving.readback",
    "train.run", "train.step", "train.checkpoint", "train.resume",
    "jit.compile",
    # MoE hot path: moe.dispatch wraps one layer's routing+dispatch BUILD
    # (host-side trace cost; the device time lives inside the compiled
    # step), moe.autotune wraps a first-encounter tiling measurement,
    # moe.gmm one candidate's timed run (real device time).
    "moe.dispatch", "moe.autotune", "moe.gmm",
    # one completed span per finished request (t0 = add_request, t1 =
    # finish) whose request_id arg lets Perfetto filter a single
    # request's lifetime out of /trace.json
    "serving.request",
    # speculative decoding: one spec_draft (the k-step draft
    # proposal call) + one spec_verify (the batched target scoring
    # call) per wave, nested inside serving.step
    "serving.spec_draft", "serving.spec_verify",
    # HTTP front door: one span per HTTP exchange (method/path/
    # code args), recorded flat (depth 0) from the asyncio loop thread
    # — interleaved coroutines would corrupt the thread-local nesting
    # stack, so the front door records completed spans directly
    "serving.http_request",
)


def describe(name: str):
    return CATALOG[name]


def instrument(name: str):
    """Create (or fetch) the registered instrument for a catalogued name —
    instrumented modules declare metrics through here, so an emitted name
    can never drift from the documented contract."""
    from . import metrics

    kind, _labels, help_ = CATALOG[name]
    if kind == "counter":
        return metrics.counter(name, help_)
    if kind == "gauge":
        return metrics.gauge(name, help_)
    rng = BUCKETS.get(name)
    return metrics.histogram(
        name, help_,
        buckets=metrics.log_buckets(*rng) if rng else None)
