"""Chaos run: seeded fault schedules against the training loop or the
serving engine, asserting recovery invariants — the port of
tools/chaos_run.py, with its four modes, invariants and output lines.

    python -m paddle_tpu_torch.tools.chaos_run --train --steps 12 --seed 7
    python -m paddle_tpu_torch.tools.chaos_run --serving --device cpu

Training mode (default; ``--train`` names it explicitly) — the tool
plays the role of the elastic launcher: every SimulatedCrash kills the
"process" (the ResilientTrainLoop) and a fresh loop auto-resumes from the
newest valid checkpoint; after the first crash the newest checkpoint is
deliberately corrupted to exercise the fallback tier. A run passes when
the faulted job reaches the same final parameters (allclose 1e-6), the
same final eval loss, and the same data position as an uninterrupted run
of equal total steps, with no batch skipped. The schedule also carries a
targeted ``nan_inject`` whose rollback must carry NaN provenance: the
numerics stats ladder has to name exactly the injected layer
(``llama.layer:1``) in the rollback's flight event and the post-mortem.

Serving mode (``--serving``) — readback crashes, pool squeezes, slow
steps and an offload crash inside an over-offered LLMEngine with the
prefix cache, chunked prefill and the host tiers on: every request ends
in exactly one of {finished, shed, deadline_exceeded}, the block ledger
balances at every step, the tiers drain, the shared prefix hits the
cache and the windowed shed-rate alert fires and clears. Then a
speculative engine under ``spec_verify_fail`` crashes and a forced-mega
engine (the draft's multi-step launch in play) under mid-wave crashes
must stream exactly what clean runs stream.

HTTP mode (``--http``) — seeded socket clients (mid-stream disconnects,
stalled readers, a 2x overload burst, short deadlines) against a live
HTTPFrontDoor over a ResilientEngine, and a SIGTERM drain mid-stream:
one terminal reason per minted id, the ledger balanced at every engine
step, exactly-once SSE streams, a shed, a disconnect-cancel and a
recovered crash seen, and a clean drain.

Router mode (``--router``) — a replica killed mid-stream behind a
ReplicaRouter: failed-over streams finish token-identical to a clean
single-engine run, fleet counters are conserved at every tick, the
victim's tok/s-divergence alert fires and clears, the revived victim
rejoins through the half-open probe; then a disaggregated
prefill/decode fleet with a prefill and a decode replica killed must
stream what one colocated engine streams, and the relay drains.

Everything runs on the card (``--device cuda``, the default) or, with
``--device cpu``, on the kernels' plain versions. The serving modes'
tiny model has head_dim 64 (hidden 128, 2 heads), the smallest the
card's attention and mega kernels take; the reference's runs 8.

Any failed run prints a one-line ``repro: ...`` command with the seeded
invocation, then ``<MODE>_CHAOS: FAIL`` (``CHAOS_PARITY: FAIL`` for
--train); a passing run ends ``... : OK``.
"""
import argparse
import os
import sys
import tempfile

import numpy as np


def _repro(args, mode):
    """The one-line reproduction command printed on any failed run —
    the seeded invocation itself, not a traceback to reverse-engineer."""
    parts = [f"repro: python -m paddle_tpu_torch.tools.chaos_run --{mode}",
             f"--seed {args.seed}", f"--device {args.device}"]
    if mode == "router":
        parts.append(f"--replicas {args.replicas}")
    if mode in ("serving", "http", "router"):
        parts.append(f"--requests {args.requests}")
    if mode in ("train", "serving"):
        parts += [f"--steps {args.steps}", f"--rate {args.rate}"]
    return " ".join(parts)


def _tiny_model(args):
    """(config, params, device) of the serving modes' tiny f32 model,
    random weights from ``--seed`` on ``--device``."""
    import dataclasses

    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import llama

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        llama.tiny_llama(vocab=64, hidden=128, layers=2, heads=2, kv_heads=1,
                         seq=128, ffn=128),
        dtype=torch.float32)
    return cfg, llama.init_params(cfg, args.seed, device=dev), dev


def serving_main(args):
    import time

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.distributed.resilience import FaultInjector
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.observability import timeseries
    from paddle_tpu_torch.serving import (AdmissionConfig, LLMEngine,
                                    ResilientEngine, ShedError)

    cfg, params, dev = _tiny_model(args)

    # seeded random schedule over the serving fault menu, with the
    # canonical pair guaranteed: a readback crash and a pool squeeze
    inj = FaultInjector.random_schedule(
        seed=args.seed, n_steps=args.steps,
        kinds=("readback_fail", "pool_squeeze", "slow_step"),
        rate=args.rate)
    menu = [("readback_fail", max(2, args.steps // 3)),
            ("pool_squeeze", max(3, args.steps // 2)),
            # fired right after a squeeze so the preempt-swap it forces
            # is likely still in flight — the mid-transfer crash
            ("offload_crash", max(4, args.steps // 2 + 1))]
    inj = FaultInjector(inj.pending + menu)
    print(f"fault schedule: {inj.pending}")

    obs.enable()
    # time-series sampler on the engine's own step tick: sample every
    # step and shrink the alert windows so the shed storm is judged on
    # windowed evidence inside this short seeded run (the port's tiny
    # engine steps in milliseconds: the whole storm is shorter than the
    # reference's 0.4 s window, so the windows are 0.05 / 0.2 s here)
    set_flags({"obs_ts_interval_s": 0.0, "obs_ts_fast_window_s": 0.05,
               "obs_ts_slow_window_s": 0.2})
    timeseries.reset()
    # num_blocks=7 with two slots decoding 6-15 fresh tokens each: pool
    # pressure (and the injected squeezes) MUST preempt — the swap tier
    # is load-bearing in this run, not decorative. The prefix cache
    # + chunked prefill run ON here: half the prompts share an 8-token
    # system prefix, so cache hits, refcount-0 evictions under squeeze,
    # and host spill/restore all fire inside the fault storm.
    eng = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                    max_model_len=64, num_blocks=7, prompt_buckets=[8, 32],
                    kv_swap_bytes=1 << 20,
                    admission=AdmissionConfig(max_queue=3),
                    injector=inj, prefix_cache=True, prefill_chunk=8,
                    prefix_cache_host_bytes=1 << 20)
    reng = ResilientEngine(eng)
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(1, 64, size=8).tolist()

    all_ids, streamed = [], {}
    submitted = 0
    ok = True
    saw_inflight = False
    while eng.has_work() or submitted < args.requests:
        # offered load: up to two submissions per step (over capacity for
        # 2 slots), every 5th with a deadline that cannot be met, every
        # 2nd sharing the system prefix (the cache's food)
        for _ in range(2):
            if submitted >= args.requests:
                break
            submitted += 1
            kw = {"deadline_s": 0.0} if submitted % 5 == 0 else {}
            tail = rng.integers(1, 64,
                                size=int(rng.integers(3, 14))).tolist()
            prompt = shared + tail if submitted % 2 == 0 else tail
            try:
                rid = eng.add_request(
                    prompt, max_new_tokens=int(rng.integers(6, 16)), **kw)
                streamed[rid] = []
            except ShedError as e:
                rid = e.req_id
            all_ids.append(rid)
        for rid, tok in reng.step():
            streamed[rid].append(tok)
        acct = eng.block_accounting()
        if acct["free"] + acct["backed"] + acct["cached"] \
                + acct["squeezed"] + acct["in_flight"] != acct["total"]:
            print(f"block ledger out of balance at step "
                  f"{eng._step_idx}: {acct}")
            ok = False
            break
        saw_inflight = saw_inflight or acct["in_flight"] > 0

    eng.drain_offload()
    reasons = eng.finish_reasons
    counts = {}
    for r in reasons.values():
        counts[r] = counts.get(r, 0) + 1
    reg = obs.get_registry()
    pc = eng.prefix_cache
    print(f"serving chaos: {submitted} offered, {counts} | "
          f"recoveries={reng.recoveries} "
          f"swap_out={int(reg.counter('serving_kv_swap_out_total').labels().value)} "
          f"swap_in={int(reg.counter('serving_kv_swap_in_total').labels().value)} "
          f"faults fired={inj.fired}")
    print(f"prefix cache: hits={pc.hits} misses={pc.misses} "
          f"prefill_tokens_skipped={pc.tokens_skipped} "
          f"device_blocks={pc.device_blocks} host_blocks={pc.host_blocks}")
    off = eng.offload
    print(f"kv offload: sync={off.sync} saw_inflight={saw_inflight} "
          f"prefetch_hits={off.prefetch_hits} stalls={off.stalls} "
          f"stall_seconds={off.stall_seconds:.4f} "
          f"proactive_spills={off.proactive_spills}")

    terminal = {"finished", "shed", "deadline_exceeded"}
    if set(reasons) != set(all_ids):
        missing = set(all_ids) - set(reasons)
        print(f"requests without a terminal state: {sorted(missing)}")
        ok = False
    if not set(reasons.values()) <= terminal:
        print(f"non-terminal reasons: {set(reasons.values()) - terminal}")
        ok = False
    # exactly-once streaming for every request that was never crash-hit:
    # results must extend what was streamed (a recovered crash loses only
    # never-host-visible tokens)
    for rid, toks in streamed.items():
        if rid in eng.results and eng.results[rid][:len(toks)] != toks:
            print(f"request {rid}: stream/result mismatch")
            ok = False
    acct = eng.block_accounting()
    # drained: every block is free or parked in the (refcount-0) cache —
    # cached blocks are a feature at idle, backed/squeezed are leaks
    if not (acct["free"] + acct["cached"] == acct["total"]
            and acct["backed"] == 0 and acct["squeezed"] == 0
            and acct["swapped_host_blocks"] == 0):
        print(f"drained ledger not clean: {acct}")
        ok = False
    if any(nd.refcount for nd in pc._iter_nodes()):
        print("drained cache still holds pinned nodes")
        ok = False
    if eng.swap_pool.bytes_used != 0:
        print(f"host swap pool leaked {eng.swap_pool.bytes_used} bytes")
        ok = False
    if acct["in_flight"] != 0 or off.held_blocks != 0:
        print(f"drained engine still holds in-flight transfer blocks: "
              f"{acct['in_flight']}")
        ok = False
    if eng.swap_pool.reserved_bytes != 0 \
            or (pc.host is not None and pc.host.reserved_bytes != 0):
        print("host tier leaked async-spill reservations")
        ok = False
    if pc.hits < 1 or pc.tokens_skipped < 1:
        print(f"shared-prefix workload never hit the cache "
              f"(hits={pc.hits}, skipped={pc.tokens_skipped})")
        ok = False

    # alert edges: the overload/pool_squeeze storm sheds requests,
    # and the windowed shed-rate watcher — fed by the per-step sampler
    # the engine itself drives — must FIRE while the storm is live,
    # then CLEAR once the engine drains and the fast window slides
    # past the last shed
    aeng = timeseries.get_alert_engine()
    shed_fired = aeng.edge_count("shed_rate", "firing")
    if shed_fired < 1:
        print("the shed storm never fired the shed_rate alert")
        ok = False
    deadline = time.monotonic() + 10
    while aeng.edge_count("shed_rate", "cleared") < 1 \
            and time.monotonic() < deadline:
        timeseries.tick()
        time.sleep(0.05)
    shed_cleared = aeng.edge_count("shed_rate", "cleared")
    print(f"alerts: shed_rate firing_edges={shed_fired} "
          f"cleared_edges={shed_cleared} "
          f"samples={len(timeseries.get_store())}")
    if shed_cleared < 1:
        print("the shed_rate alert never cleared after the drain")
        ok = False

    # -- phase 2: speculative chaos ---------------------------------------
    # a fault injected MID-VERIFY (between the verify dispatch and its
    # readback) must roll the engine back to the last committed token:
    # the recovered run's streams must equal a clean non-speculative
    # run's token-for-token, and the block ledger must balance through
    # the crash + squeeze storm with the draft pools in play.
    spec_inj = FaultInjector([("spec_verify_fail", 2),
                              ("spec_verify_fail", 3),
                              ("spec_verify_fail", 7),
                              ("pool_squeeze", 5)])
    prompts = [rng.integers(1, 64, size=int(rng.integers(3, 14))).tolist()
               for _ in range(6)]
    news = [int(rng.integers(6, 16)) for _ in range(6)]
    ref = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                    max_model_len=64, prompt_buckets=[8, 32])
    ref_ids = [ref.add_request(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
    ref_out = ref.run()
    spec = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                     max_model_len=64, num_blocks=9,
                     prompt_buckets=[8, 32], kv_swap_bytes=1 << 20,
                     injector=spec_inj, draft_params=params,
                     draft_config=cfg, spec_tokens=4)
    rspec = ResilientEngine(spec)
    sids = [spec.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    streamed2 = {rid: [] for rid in sids}
    while spec.has_work():
        for rid, tok in rspec.step():
            streamed2[rid].append(tok)
        acct = spec.block_accounting()
        if acct["free"] + acct["backed"] + acct["cached"] \
                + acct["squeezed"] + acct["in_flight"] != acct["total"]:
            print(f"spec ledger out of balance at step "
                  f"{spec._step_idx}: {acct}")
            ok = False
            break
    print(f"spec chaos: recoveries={rspec.recoveries} "
          f"waves={spec.spec_waves} committed={spec.spec_committed} "
          f"accepted={spec.spec_accepted}/{spec.spec_proposed} "
          f"faults fired={spec_inj.fired}")
    if rspec.recoveries < 1:
        print("no mid-verify crash was recovered — the fault never fired")
        ok = False
    for rid, refid in zip(sids, ref_ids):
        if spec.results.get(rid) != ref_out[refid]:
            print(f"spec request {rid} diverged from the clean greedy "
                  f"stream: {spec.results.get(rid)} != {ref_out[refid]}")
            ok = False
        if streamed2[rid] != spec.results.get(rid):
            print(f"spec request {rid}: streamed/result mismatch")
            ok = False

    # -- phase 3: megakernel chaos ----------------------------------------
    # the fused decode path under fire: decode_kernel="mega" forced on
    # (B5 on the card, its plain version on the CPU), the draft's
    # fused multi-step launch in play, and seeded readback crashes
    # timed to land mid-wave (spec_verify_fail raises at the wave's
    # blocking readback sync). Recovery must roll back to the last
    # committed token, the 5-term block ledger must balance at every
    # step, and the recovered streams must equal a clean forced-ragged
    # run's token-for-token (the acceptance parity, under faults).
    mega_inj = FaultInjector([("spec_verify_fail", 2),
                              ("spec_verify_fail", 4),
                              ("pool_squeeze", 6)])
    prompts = [rng.integers(1, 64, size=int(rng.integers(3, 14))).tolist()
               for _ in range(4)]
    news = [int(rng.integers(6, 16)) for _ in range(4)]
    rag = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                    max_model_len=64, prompt_buckets=[8, 32],
                    decode_kernel="ragged", draft_params=params,
                    draft_config=cfg, spec_tokens=3)
    rag_ids = [rag.add_request(p, max_new_tokens=n)
               for p, n in zip(prompts, news)]
    rag_out = rag.run()
    mega = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                     max_model_len=64, num_blocks=9,
                     prompt_buckets=[8, 32], kv_swap_bytes=1 << 20,
                     injector=mega_inj, decode_kernel="mega",
                     draft_params=params, draft_config=cfg,
                     spec_tokens=3)
    rmega = ResilientEngine(mega)
    mids = [mega.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    streamed3 = {rid: [] for rid in mids}
    while mega.has_work():
        for rid, tok in rmega.step():
            streamed3[rid].append(tok)
        acct = mega.block_accounting()
        if acct["free"] + acct["backed"] + acct["cached"] \
                + acct["squeezed"] + acct["in_flight"] != acct["total"]:
            print(f"mega ledger out of balance at step "
                  f"{mega._step_idx}: {acct}")
            ok = False
            break
    print(f"mega chaos: recoveries={rmega.recoveries} "
          f"waves={mega.spec_waves} committed={mega.spec_committed} "
          f"faults fired={mega_inj.fired}")
    if rmega.recoveries < 1:
        print("no mid-wave crash was recovered — the fault never fired")
        ok = False
    if not all(k[0] == "mega" for k in mega._decode_variants):
        print(f"forced mega engine built non-mega variants: "
              f"{sorted(mega._decode_variants, key=str)}")
        ok = False
    if mega.spec_draft_paths["mega"] < 1:
        print("the fused multi-step draft launch never ran")
        ok = False
    for rid, refid in zip(mids, rag_ids):
        if mega.results.get(rid) != rag_out[refid]:
            print(f"mega request {rid} diverged from the clean ragged "
                  f"stream: {mega.results.get(rid)} != {rag_out[refid]}")
            ok = False
        if streamed3[rid] != mega.results.get(rid):
            print(f"mega request {rid}: streamed/result mismatch")
            ok = False

    if not ok:
        print(_repro(args, "serving"))
    print("SERVING_CHAOS: OK" if ok else "SERVING_CHAOS: FAIL")
    return 0 if ok else 1


def http_main(args):
    """Network-layer chaos: seeded client misbehavior against a live
    HTTPFrontDoor, engine invariants asserted from the socket inward."""
    import json
    import signal
    import socket
    import threading
    import time

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.distributed.resilience import FaultInjector
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import (AdmissionConfig, HTTPFrontDoor,
                                    LLMEngine, ResilientEngine)

    obs.enable()
    set_flags({"serve_drain_s": 20.0})
    cfg, params, dev = _tiny_model(args)
    eng = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                    max_model_len=64, num_blocks=9, prompt_buckets=[8, 32],
                    kv_swap_bytes=1 << 20,
                    admission=AdmissionConfig(max_queue=3))
    # warm the engine BEFORE opening traffic (threads not started yet,
    # so driving the engine here is safe): a cold first step (kernel
    # loads, allocator growth) would otherwise stall the first burst and
    # turn the whole offered load into queue_full sheds — chaos should
    # exercise a SERVING engine, not a warming one
    wrng = np.random.default_rng(args.seed)
    for _ in range(2):
        eng.add_request(wrng.integers(1, 64, size=6).tolist(),
                        max_new_tokens=4)
    eng.run()
    # the injector arms only now, with steps keyed past the warmup:
    # readback crashes timed to hit live streams (retrying comment
    # frames + recovery), one squeeze for pool pressure
    base = eng._step_idx
    inj = FaultInjector([("readback_fail", base + 4),
                         ("readback_fail", base + 12),
                         ("pool_squeeze", base + 8)])
    eng.injector = inj
    reng = ResilientEngine(eng)

    violations = []

    def ledger_hook(e):
        acct = e.block_accounting()
        if acct["free"] + acct["backed"] + acct["cached"] \
                + acct["squeezed"] + acct.get("in_flight", 0) \
                != acct["total"]:
            violations.append((e._step_idx, acct))

    front = HTTPFrontDoor(reng, step_hook=ledger_hook)
    host, port = front.start()
    # SIGTERM mid-stream = the orchestrator's restart signal: drain
    signal.signal(signal.SIGTERM, lambda *_a: front.begin_drain())

    rng = np.random.default_rng(args.seed)
    records = []
    rec_lock = threading.Lock()

    def draw_workload(behavior):
        # drawn on the MAIN thread only: numpy Generators are not
        # thread-safe, and same-seed reruns must offer the same
        # prompts whatever the client-thread scheduling
        doc = {"prompt": rng.integers(
                   1, 64, size=int(rng.integers(3, 12))).tolist(),
               "max_new_tokens": int(rng.integers(8, 20))}
        if behavior == "deadline":
            doc["timeout_s"] = 0.05
        return doc

    def run_client(i, behavior, doc):
        rec = {"i": i, "behavior": behavior, "code": None,
               "streamed": [], "terminal": None, "reason": None}
        try:
            body = json.dumps(doc).encode()
            s = socket.create_connection((host, port), timeout=30)
            s.sendall((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                       f"Content-Length: {len(body)}\r\n"
                       f"X-Tenant: t{i % 3}\r\n\r\n").encode() + body)
            buf = b""
            while b"\r\n\r\n" not in buf:
                c = s.recv(4096)
                if not c:
                    break
                buf += c
            rec["code"] = int(buf.split(b" ", 2)[1]) if buf else None
            if rec["code"] != 200:
                s.close()
                return
            if behavior == "disconnect":
                # slam the connection after the first token frame: the
                # server must cancel the request and free its blocks
                while buf.count(b"data:") < 1:
                    c = s.recv(1)
                    if not c:
                        break
                    buf += c
                s.close()
                return
            if behavior == "stall":
                # never consume the stream: the server must not wedge
                # (tiny streams fit the kernel buffers, so the engine
                # finishes the request; the stall-cancel sweep itself
                # is white-box-tested — tests/test_http_server.py)
                time.sleep(0.6)
                s.close()
                return
            while True:                    # normal / deadline readers
                c = s.recv(65536)
                if not c:
                    break
                buf += c
            s.close()
            for chunk in buf.split(b"data: ")[1:]:
                payload = chunk.split(b"\n", 1)[0]
                obj = json.loads(payload)
                if "token" in obj:
                    rec["streamed"].append(obj["token"])
                elif obj.get("done"):
                    rec["terminal"] = obj["tokens"]
                    rec["reason"] = obj["reason"]
        except (OSError, ValueError) as e:
            rec.setdefault("error", repr(e))
        finally:
            with rec_lock:
                records.append(rec)

    # seeded behavior mix; bursts of 6 concurrent clients offer ~2x the
    # 2-slot + 3-queue capacity, so the bounded queue MUST shed
    behaviors = []
    for i in range(args.requests):
        r = rng.random()
        behaviors.append("disconnect" if r < 0.2 else
                         "stall" if r < 0.35 else
                         "deadline" if r < 0.5 else "normal")
    workloads = [draw_workload(b) for b in behaviors]
    late_doc = draw_workload("normal")
    threads = []
    for burst_start in range(0, len(behaviors), 6):
        burst = behaviors[burst_start:burst_start + 6]
        for j, b in enumerate(burst):
            t = threading.Thread(
                target=run_client,
                args=(burst_start + j, b, workloads[burst_start + j]))
            t.start()
            threads.append(t)
        time.sleep(0.4)
    # SIGTERM while the last burst's streams are in flight: drain must
    # let them finish and 503 every later arrival
    os.kill(os.getpid(), signal.SIGTERM)
    late = threading.Thread(target=run_client,
                            args=(len(behaviors), "normal", late_doc))
    late.start()
    threads.append(late)
    for t in threads:
        t.join(60)
    ok = front.wait_drained(30)
    front.stop()

    reasons = dict(eng.finish_reasons)
    counts = {}
    for r in reasons.values():
        counts[r] = counts.get(r, 0) + 1
    codes = {}
    for rec in records:
        codes[rec["code"]] = codes.get(rec["code"], 0) + 1
    reg = obs.get_registry()
    disconnects = int(reg.counter(
        "serving_http_client_disconnects_total").labels().value)
    print(f"http chaos: {args.requests} clients {codes} | terminal "
          f"{counts} | recoveries={reng.recoveries} "
          f"disconnect_cancels={disconnects} faults fired={inj.fired}")

    if not ok:
        print("drain never completed")
    terminal = {"finished", "shed", "deadline_exceeded",
                "client_disconnected", "drained"}
    minted = set(range(eng._next_id))
    if set(reasons) != minted:
        print(f"requests without a terminal state: "
              f"{sorted(minted - set(reasons))}")
        ok = False
    if not set(reasons.values()) <= terminal:
        print(f"non-terminal reasons: {set(reasons.values()) - terminal}")
        ok = False
    if violations:
        print(f"block ledger violations: {violations[:3]}")
        ok = False
    for rec in records:
        if rec["behavior"] in ("normal", "deadline") \
                and rec["terminal"] is not None \
                and rec["reason"] == "finished" \
                and rec["streamed"] != rec["terminal"]:
            print(f"client {rec['i']}: streamed/terminal mismatch "
                  f"{rec['streamed']} != {rec['terminal']}")
            ok = False
    eng.drain_offload()
    acct = eng.block_accounting()
    if not (acct["free"] + acct["cached"] == acct["total"]
            and acct["backed"] == 0 and acct["squeezed"] == 0
            and acct["swapped_host_blocks"] == 0):
        print(f"drained ledger not clean: {acct}")
        ok = False
    if front.active_streams != 0:
        print(f"{front.active_streams} streams survived the drain")
        ok = False
    if eng.swap_pool.bytes_used != 0:
        print(f"host swap pool leaked {eng.swap_pool.bytes_used} bytes")
        ok = False
    if acct["in_flight"] != 0 or eng.offload.held_blocks != 0 \
            or eng.swap_pool.reserved_bytes != 0:
        print("drained front-door engine still holds in-flight "
              "transfer state")
        ok = False
    if counts.get("shed", 0) < 1:
        print("the 2x overload burst never hit the bounded queue")
        ok = False
    draining_503 = any(rec["code"] == 503 for rec in records
                       if rec["i"] >= len(behaviors))
    if not draining_503:
        print("the post-SIGTERM arrival was not refused with 503")
        ok = False
    if disconnects < 1:
        print("no disconnect was cancelled server-side")
        ok = False
    if reng.recoveries < 1:
        print("the injected readback crash never fired/recovered")
        ok = False

    if not ok:
        print(_repro(args, "http"))
    print("HTTP_CHAOS: OK" if ok else "HTTP_CHAOS: FAIL")
    return 0 if ok else 1


def router_main(args):
    """Kill-a-replica chaos: a seeded mid-stream replica death under a
    ReplicaRouter, exactly-once resume parity asserted against a clean
    single-engine run."""
    import time

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.observability import fleet
    from paddle_tpu_torch.observability import timeseries
    from paddle_tpu_torch.serving import LLMEngine, ReplicaRouter

    obs.enable()
    # time-series sampler: every health tick / engine step samples,
    # and the divergence watcher judges the kill on a window short
    # enough to resolve inside this seeded run
    set_flags({"obs_ts_interval_s": 0.0, "obs_ts_fast_window_s": 0.5,
               "obs_ts_slow_window_s": 2.0})
    timeseries.reset()
    cfg, params, dev = _tiny_model(args)

    def mk_engine():
        return LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                         max_model_len=64, prompt_buckets=[8, 48])

    engines = [mk_engine() for _ in range(args.replicas)]
    # warm every replica BEFORE the step threads exist (both prefill
    # buckets + the decode wave): a slow cold first step would let
    # wall-clock health timers mistake warm-up for death — chaos should
    # kill a SERVING replica, not a warming one
    wrng = np.random.default_rng(args.seed)
    for eng in engines:
        eng.add_request(wrng.integers(1, 64, size=6).tolist(),
                        max_new_tokens=4)
        eng.add_request(wrng.integers(1, 64, size=20).tolist(),
                        max_new_tokens=4)
        eng.run()

    violations = []

    def ledger_hook(name, eng):
        acct = eng.block_accounting()
        if acct["free"] + acct["backed"] + acct["cached"] \
                + acct["squeezed"] + acct.get("in_flight", 0) \
                != acct["total"]:
            violations.append((name, eng._step_idx, acct))

    names = [f"r{i}" for i in range(args.replicas)]
    # generous wall-clock thresholds: this run drives death/revival
    # explicitly (kill_replica/revive_replica), and a CI box under load
    # must not see a slow-but-alive replica declared dead on its own
    router = ReplicaRouter(engines, names=names, step_hook=ledger_hook,
                           suspect_s=15.0, dead_s=30.0, halfopen_s=0.2)
    router.start()

    # counter conservation: at EVERY health tick, for every counter
    # in the merged fleet snapshot, the fleet-aggregated value must
    # equal the sum over the per-replica scoped series OF THE SAME
    # snapshot set (one atomic registry read per tick — comparing
    # against a later live read would race in-flight increments)
    import math

    agg = fleet.get_aggregator()
    conservation_failures = []
    conservation_ticks = [0]

    def _counter_sums(snaps):
        sums = {}
        for snap in snaps.values():
            for fam in snap.get("metrics", []):
                if fam["kind"] != "counter":
                    continue
                for s in fam.get("series", []):
                    labels = {k: v for k, v
                              in s.get("labels", {}).items()
                              if k != "replica"}
                    key = (fam["name"], tuple(sorted(labels.items())))
                    sums[key] = sums.get(key, 0.0) \
                        + float(s.get("value", 0.0))
        return sums

    def conservation_tick():
        conservation_ticks[0] += 1
        snaps = agg.snapshots()
        merged = fleet.merge_snapshots(snaps)
        expect = _counter_sums(snaps)
        got = {}
        for fam in merged["metrics"]:
            if fam["kind"] != "counter":
                continue
            for s in fam["series"]:
                key = (fam["name"], tuple(sorted(s["labels"].items())))
                got[key] = float(s["value"])
        bad = {k: (got.get(k), expect.get(k))
               for k in set(got) | set(expect)
               if not math.isclose(got.get(k, 0.0), expect.get(k, 0.0),
                                   rel_tol=1e-9, abs_tol=1e-12)}
        if bad and len(conservation_failures) < 3:
            conservation_failures.append(bad)

    def wait_ticking(rids, timeout=120.0):
        """Wait for every rid, calling a health tick + the conservation
        check every ~25ms — the check runs DURING the kill/failover
        window, not just at quiescence."""
        deadline = time.monotonic() + timeout
        pending = list(rids)
        while pending and time.monotonic() < deadline:
            pending = [rid for rid in pending
                       if not router._streams[rid].done.is_set()]
            router.check()
            conservation_tick()
            time.sleep(0.025)
        for rid in rids:
            router.wait(rid, timeout=max(0.0,
                                         deadline - time.monotonic()))

    # seeded workload: half the prompts share an 8-token system prefix
    # (the affinity scorer's food), long-ish decodes so the kill lands
    # mid-stream; prompt(<=20) + delivered(<16) stays inside bucket 48
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(1, 64, size=8).tolist()
    workload = []
    for i in range(args.requests):
        tail = rng.integers(1, 64, size=int(rng.integers(3, 12))).tolist()
        prompt = shared + tail if i % 2 == 0 else tail
        workload.append((prompt, int(rng.integers(8, 16))))

    ok = True
    first = workload[:max(2, args.requests // 2)]
    rest = workload[len(first):]
    rids = [router.submit(p, max_new_tokens=n) for p, n in first]

    # wait for a mid-stream moment: some replica owns a stream that has
    # already delivered tokens but is not finished
    victim = None
    deadline = time.monotonic() + 30
    while victim is None and time.monotonic() < deadline:
        with router._lock:
            live = [rec for rec in router._streams.values()
                    if rec.replica is not None and not rec.done.is_set()
                    and len(rec.delivered) >= 2]
            if live:
                # seeded victim choice among replicas with live streams
                owners = sorted({rec.replica for rec in live})
                victim = owners[int(rng.integers(0, len(owners)))]
        time.sleep(0.002)
    if victim is None:
        print("no stream was ever mid-flight — workload too small")
        ok = False
        victim = names[0]
    pre_kill = {n: rep.dispatches for n, rep in router.replicas.items()}
    print(f"killing {victim} mid-stream "
          f"(dispatches so far: {pre_kill})")
    router.kill_replica(victim)

    # post-kill offered load must land on survivors only; the wait runs
    # health ticks + the conservation check straight through the kill
    rids += [router.submit(p, max_new_tokens=n) for p, n in rest]
    wait_ticking(rids, timeout=120)

    reasons = dict(router.finish_reasons)
    counts = {}
    for r in reasons.values():
        counts[r] = counts.get(r, 0) + 1
    print(f"router chaos: {len(rids)} offered, {counts} | "
          f"failovers={router.failovers} resumed={router.resumed_streams} "
          f"affinity={router.affinity_hits}/{router.affinity_misses} "
          f"dedup_drops={router.dedup_drops} sheds={router.router_sheds}")

    # every minted id: exactly one terminal reason, from the closed set
    terminal = {"finished", "shed", "deadline_exceeded",
                "client_disconnected", "drained"}
    if set(reasons) != set(rids):
        print(f"requests without a terminal state: "
              f"{sorted(set(rids) - set(reasons))}")
        ok = False
    if not set(reasons.values()) <= terminal:
        print(f"non-terminal reasons: {set(reasons.values()) - terminal}")
        ok = False
    if router.failovers < 1 or router.resumed_streams < 1:
        print("the kill never orphaned a live stream — nothing failed over")
        ok = False
    if router.affinity_hits < 1:
        print("shared-prefix workload never scored an affinity hit")
        ok = False

    # alert edge: the dead victim's token counter froze while the
    # survivors kept decoding — the tok/s-divergence watcher must fire
    # FOR THE VICTIM on windowed evidence. Paired keep-alive traffic
    # holds both survivors' rates (and so the fleet median) above the
    # watcher's floor until the fast window slides fully past the kill.
    aeng = timeseries.get_alert_engine()

    def _victim_diverged():
        return any(r["alert"] == "replica_tok_s_divergence"
                   and r["instance"] == victim for r in aeng.firing())

    deadline = time.monotonic() + 20
    while not _victim_diverged() and time.monotonic() < deadline:
        kas = [router.submit(rng.integers(1, 64, size=4).tolist(),
                             max_new_tokens=6) for _ in range(2)]
        for ka in kas:
            router.wait(ka, timeout=30)
        router.check()
    div_fired = aeng.edge_count("replica_tok_s_divergence", "firing")
    print(f"alerts: tok/s divergence firing_edges={div_fired} "
          f"victim_firing={_victim_diverged()} "
          f"samples={len(timeseries.get_store())}")
    if not _victim_diverged():
        print(f"the kill never fired the tok/s-divergence alert for "
              f"{victim}")
        ok = False

    # exactly-once resume parity: EVERY finished stream — resumed or
    # not — must be token-identical to an uninterrupted single-engine
    # greedy run of the same workload
    ref = mk_engine()
    ref_ids = [ref.add_request(p, max_new_tokens=n) for p, n in workload]
    ref_out = ref.run()
    for rid, refid in zip(rids, ref_ids):
        if reasons.get(rid) != "finished":
            continue
        if router.results[rid] != ref_out[refid]:
            print(f"request {rid} diverged from the clean greedy run: "
                  f"{router.results[rid]} != {ref_out[refid]}")
            ok = False

    # fleet conservation verdict: the per-tick merge-vs-sum checks
    # ran through the kill window, plus one quiescent check against the
    # live registry now that streams are terminal
    conservation_tick()
    print(f"fleet conservation: {conservation_ticks[0]} ticks, "
          f"{len(conservation_failures)} violation(s)")
    if conservation_failures:
        print(f"counter conservation violated: "
              f"{conservation_failures[0]}")
        ok = False
    if conservation_ticks[0] < 3:
        print("too few conservation ticks — the check never ran "
              "through the kill window")
        ok = False

    # failover-continuous traces: every resumed stream keeps ONE
    # timeline — reachable under its new engine rid AND the old one
    # (alias), carrying a structured failover hop with the delivered
    # count, its summary totals spanning both legs
    tracer = obs.request_trace.get_request_tracer()
    resumed_recs = [rec for rec in router._streams.values()
                    if rec.resumes >= 1 and not rec.cancelled
                    and reasons.get(rec.rid) == "finished"]
    if not resumed_recs:
        print("no resumed stream finished — trace continuity unchecked")
        ok = False
    for rec in resumed_recs:
        doc = tracer.get(rec.engine_rid)
        if doc is None:
            print(f"resumed stream {rec.rid}: no timeline under engine "
                  f"rid {rec.engine_rid}")
            ok = False
            continue
        kinds = [ev["kind"] for ev in doc["events"]]
        hops = [ev for ev in doc["events"] if ev["kind"] == "failover"]
        if not hops:
            print(f"resumed stream {rec.rid}: timeline has no failover "
                  f"hop: {kinds}")
            ok = False
            continue
        hop = hops[0]
        if hop.get("to") != rec.replica or "from" not in hop \
                or "delivered" not in hop:
            print(f"resumed stream {rec.rid}: malformed failover hop "
                  f"{hop}")
            ok = False
        if doc.get("summary", {}).get("failovers", 0) < rec.resumes:
            print(f"resumed stream {rec.rid}: summary counts "
                  f"{doc.get('summary', {}).get('failovers')} failovers,"
                  f" router counts {rec.resumes}")
            ok = False
        if doc.get("summary", {}).get("tokens") != len(rec.delivered):
            print(f"resumed stream {rec.rid}: grafted summary tokens "
                  f"{doc.get('summary', {}).get('tokens')} != delivered "
                  f"{len(rec.delivered)}")
            ok = False

    # exemplars stay valid through the kill: the p99 TTFT exemplar must
    # resolve to a request the (grafted) tracer still knows
    reg = obs.get_registry()
    ex = obs.exemplar_for_quantile(
        reg.histogram("serving_ttft_seconds"), 0.99)
    if ex is None:
        print("no TTFT p99 exemplar after the chaos run")
        ok = False
    elif tracer.get(ex["request_id"]) is None:
        print(f"TTFT p99 exemplar points at unknown request "
              f"{ex['request_id']}")
        ok = False

    # rebalance: the dead victim took no post-kill dispatches; every
    # survivor kept serving
    post_kill = {n: rep.dispatches for n, rep in router.replicas.items()}
    if post_kill[victim] != pre_kill[victim]:
        print(f"dead replica {victim} was dispatched to after the kill: "
              f"{pre_kill[victim]} -> {post_kill[victim]}")
        ok = False
    survivors = [n for n in names if n != victim]
    if rest and not any(post_kill[n] > pre_kill[n] for n in survivors):
        print(f"post-kill traffic never landed on a survivor: "
              f"{pre_kill} -> {post_kill}")
        ok = False

    # circuit breaker: the revived victim rejoins through the half-open
    # probe under fresh traffic, never by fiat
    router.revive_replica(victim)
    router.check()
    if router.states()[victim] not in ("dead", "half_open"):
        print(f"revived {victim} skipped the circuit breaker: "
              f"{router.states()[victim]}")
        ok = False
    probe_rids = []
    deadline = time.monotonic() + 30
    while router.states()[victim] != "healthy" \
            and time.monotonic() < deadline:
        router.check()
        probe_rids.append(router.submit(
            rng.integers(1, 64, size=4).tolist(), max_new_tokens=4))
        for rid in probe_rids[-1:]:
            router.wait(rid, timeout=60)
    router.check()
    if router.states()[victim] != "healthy":
        print(f"revived {victim} never closed the circuit: "
              f"{router.states()}")
        ok = False

    # full drain: every replica's ledger clean, no stream left behind
    if not router.drain_all(timeout=60):
        print("drain never completed")
        ok = False
    for name, rep in router.replicas.items():
        acct = rep.raw.block_accounting()
        if not (acct["free"] + acct["cached"] == acct["total"]
                and acct["backed"] == 0 and acct["squeezed"] == 0):
            print(f"replica {name} drained ledger not clean: {acct}")
            ok = False
    if router.live_streams():
        print(f"streams survived the drain: {router.live_streams()}")
        ok = False
    if violations:
        print(f"per-replica ledger violations: {violations[:3]}")
        ok = False
    noops = sum(rep.raw.cancel_noops for rep in router.replicas.values())
    print(f"post-drain states: {router.states()} | "
          f"cancel_noops={noops} ledger_checks_per_replica="
          f"{ {n: rep.steps for n, rep in router.replicas.items()} }")

    # cleared edge: with the fleet drained every replica's token
    # rate decays to zero, the median falls below the watcher's floor,
    # and the divergence alert must CLEAR (one cleared edge per
    # transition — the revived victim must not stay marked diverged)
    deadline = time.monotonic() + 10
    while (_victim_diverged()
           or aeng.edge_count("replica_tok_s_divergence",
                              "cleared") < 1) \
            and time.monotonic() < deadline:
        timeseries.tick()
        time.sleep(0.05)
    div_cleared = aeng.edge_count("replica_tok_s_divergence", "cleared")
    print(f"alerts: tok/s divergence cleared_edges={div_cleared}")
    if _victim_diverged() or div_cleared < 1:
        print("the tok/s-divergence alert never cleared after the drain")
        ok = False
    router.stop()

    # ---- disaggregated prefill/decode phase ------------------------------
    # A fresh 4-replica fleet: 2 prefill-role + 2 decode-role replicas
    # over ONE shared host relay. Two seeded kills: a prefill replica
    # while it still owns streams (some may sit spilled in the relay,
    # unobserved by the router — those entries must be discarded, the
    # streams re-prefilled from the prompt), then a decode replica
    # mid-decode on relayed KV (failover re-prefills prompt+delivered).
    # Asserted: every stream finishes exactly once, token-identical to
    # a clean COLOCATED single-engine greedy run; per-replica 5-term
    # ledgers balance at every step; the relay pool drains to zero.
    from paddle_tpu_torch.serving.kv_swap import HostKVPool

    print()
    drng = np.random.default_rng(args.seed + 1)
    relay = HostKVPool(1 << 30, kind="relay")

    def mk_role(role):
        return LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                         max_model_len=64, prompt_buckets=[8, 48],
                         role=role, relay=relay)

    droles = {"p0": "prefill", "p1": "prefill",
              "d0": "decode", "d1": "decode"}
    d_engines = {n: mk_role(r) for n, r in droles.items()}
    # warm the engines before the step threads exist; a prefill-role
    # warmup hands its KV off — drop those entries, they have no
    # consumer
    for eng in d_engines.values():
        w1 = eng.add_request(wrng.integers(1, 64, size=6).tolist(),
                             max_new_tokens=4)
        w2 = eng.add_request(wrng.integers(1, 64, size=20).tolist(),
                             max_new_tokens=4)
        eng.run()
        relay.discard(w1)
        relay.discard(w2)
    if len(relay):
        print(f"warmup left {len(relay)} relay entries behind")
        ok = False

    d_violations = []

    def d_ledger_hook(name, eng):
        acct = eng.block_accounting()
        if acct["free"] + acct["backed"] + acct["cached"] \
                + acct["squeezed"] + acct.get("in_flight", 0) \
                != acct["total"]:
            d_violations.append((name, eng._step_idx, acct))

    drouter = ReplicaRouter(list(d_engines.values()),
                            names=list(d_engines),
                            step_hook=d_ledger_hook,
                            suspect_s=15.0, dead_s=30.0, halfopen_s=0.2)
    drouter.start()

    dworkload = []
    for _ in range(args.requests):
        prompt = drng.integers(
            1, 64, size=int(drng.integers(4, 12))).tolist()
        dworkload.append((prompt, int(drng.integers(8, 16))))
    dfirst = dworkload[:max(2, args.requests // 2)]
    drest = dworkload[len(dfirst):]
    drids = [drouter.submit(list(p), max_new_tokens=n)
             for p, n in dfirst]

    # seeded prefill-replica kill: the handoff machinery must be LIVE
    # (>= 1 spill already happened) and the victim must still own
    # streams — those die before their own handoff and re-prefill
    p_victim = None
    deadline = time.monotonic() + 30
    while p_victim is None and time.monotonic() < deadline:
        with drouter._lock:
            owners = sorted(n for n, rep in drouter.replicas.items()
                            if droles[n] == "prefill" and rep.owned)
        spilled = sum(d_engines[n].handoffs for n, r in droles.items()
                      if r == "prefill")
        if spilled >= 1 and owners:
            p_victim = owners[int(drng.integers(0, len(owners)))]
        time.sleep(0.001)
    if p_victim is None:
        print("no prefill replica ever owned a stream post-handoff")
        ok = False
        p_victim = "p0"
    print(f"disagg: killing prefill replica {p_victim} mid-handoff "
          f"(handoffs so far: "
          f"{ {n: d_engines[n].handoffs for n in ('p0', 'p1')} })")
    drouter.kill_replica(p_victim)

    drids += [drouter.submit(list(p), max_new_tokens=n)
              for p, n in drest]

    # seeded decode-replica kill: a stream must be decoding ON relayed
    # KV (owner is a decode replica, >= 2 tokens out — the handoff
    # token plus at least one decoded there)
    d_victim = None
    deadline = time.monotonic() + 30
    while d_victim is None and time.monotonic() < deadline:
        with drouter._lock:
            live = sorted({rec.replica
                           for rec in drouter._streams.values()
                           if rec.replica in ("d0", "d1")
                           and not rec.done.is_set()
                           and len(rec.delivered) >= 2})
        if live:
            d_victim = live[int(drng.integers(0, len(live)))]
        time.sleep(0.001)
    if d_victim is None:
        print("no stream was ever mid-decode on a decode replica")
        ok = False
        d_victim = "d0"
    print(f"disagg: killing decode replica {d_victim} post-handoff")
    drouter.kill_replica(d_victim)

    deadline = time.monotonic() + 120
    pending = list(drids)
    while pending and time.monotonic() < deadline:
        pending = [rid for rid in pending
                   if not drouter._streams[rid].done.is_set()]
        drouter.check()
        time.sleep(0.02)
    for rid in drids:
        drouter.wait(rid, timeout=max(0.0,
                                      deadline - time.monotonic()))

    dreasons = {rid: drouter.finish_reasons.get(rid) for rid in drids}
    dcounts = {}
    for r in dreasons.values():
        dcounts[r] = dcounts.get(r, 0) + 1
    total_handoffs = sum(e.handoffs for e in d_engines.values())
    print(f"disagg chaos: {len(drids)} offered, {dcounts} | "
          f"handoffs={total_handoffs} "
          f"handoff_resumes={drouter.handoff_resumes} "
          f"failovers={drouter.failovers} "
          f"resumed={drouter.resumed_streams} relay_len={len(relay)}")

    # exactly-once, and in THIS phase (no overload, no cancels, two
    # survivors) every stream must land in "finished"
    if any(dreasons.get(rid) != "finished" for rid in drids):
        print(f"disagg streams not all finished: {dcounts}")
        ok = False
    if total_handoffs < 1 or drouter.handoff_resumes < 1:
        print("the disagg fleet never handed a stream off")
        ok = False
    if drouter.failovers < 1:
        print("neither kill orphaned a live stream")
        ok = False

    # greedy parity: disagg + two kills must equal a clean COLOCATED
    # single-engine run of the same workload, token for token
    dref = mk_engine()
    dref_ids = [dref.add_request(list(p), max_new_tokens=n)
                for p, n in dworkload]
    dref_out = dref.run()
    for rid, refid in zip(drids, dref_ids):
        if dreasons.get(rid) != "finished":
            continue
        if drouter.results[rid] != dref_out[refid]:
            print(f"disagg request {rid} diverged from the colocated "
                  f"run: {drouter.results[rid]} != {dref_out[refid]}")
            ok = False

    # the relay must drain: every spill was either restored on a decode
    # replica or discarded on the failover path — an entry left behind
    # is a leak
    if len(relay):
        print(f"relay pool not drained: {len(relay)} entries, "
              f"{relay.bytes_used} bytes")
        ok = False
    if not drouter.drain_all(timeout=60):
        print("disagg drain never completed")
        ok = False
    for name, rep in drouter.replicas.items():
        if name in (p_victim, d_victim):
            continue       # dead mid-flight: recovered only on revive
        acct = rep.raw.block_accounting()
        if not (acct["free"] + acct["cached"] == acct["total"]
                and acct["backed"] == 0 and acct["squeezed"] == 0):
            print(f"disagg replica {name} drained ledger not clean: "
                  f"{acct}")
            ok = False
    if drouter.live_streams():
        print(f"disagg streams survived the drain: "
              f"{drouter.live_streams()}")
        ok = False
    if d_violations:
        print(f"disagg per-replica ledger violations: "
              f"{d_violations[:3]}")
        ok = False
    print(f"disagg post-drain states: {drouter.states()}")
    drouter.stop()

    if not ok:
        print(_repro(args, "router"))
    print("ROUTER_CHAOS: OK" if ok else "ROUTER_CHAOS: FAIL")
    return 0 if ok else 1


def train_main(args):
    """The train-loop chaos parity run (module docstring)."""
    import functools
    import json

    import torch

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed.resilience import (FaultInjector,
                                                         ResilientTrainLoop,
                                                         ResumableIterator,
                                                         SimulatedCrash,
                                                         atomic_ckpt)
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.observability import numerics

    # numerics on for BOTH runs (stat probes never change the math, so
    # parity still holds bit-exactly) — the nan_inject below must leave
    # a provenance trail naming its layer
    dev = resolve_device(args.device)
    obs.enable()
    numerics.enable()
    cfg = llama.tiny_llama(vocab=64, hidden=128, layers=2, heads=2,
                           kv_heads=1, seq=16, ffn=128)
    steps = args.steps
    rng = np.random.RandomState(args.seed)
    batches = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16))
                                .astype(np.int32)).to(dev)
               for _ in range(steps + 4)]
    eval_batch = batches[-1]
    step_fn = functools.partial(llama.train_step, config=cfg, lr=1e-3)

    def eval_loss(params):
        with torch.no_grad():
            return float(llama.loss_fn(params, eval_batch, cfg))

    def init_state():
        return llama.init_train_state(cfg, args.seed, device=dev)

    def data_iter():
        return ResumableIterator(lambda e: iter(batches))

    # -- clean reference ---------------------------------------------------
    clean = ResilientTrainLoop(step_fn, init_state(), data_iter())
    s_clean = clean.run(steps)
    clean_pos = clean.data.state_dict()
    clean_loss = eval_loss(s_clean.params)
    print(f"clean run: {steps} steps, eval loss {clean_loss:.6f}")

    # -- chaos run ---------------------------------------------------------
    # seeded random schedule, with the canonical menu guaranteed present:
    # a NaN gradient in the first half and a crash in the second
    inj = FaultInjector.random_schedule(
        seed=args.seed, n_steps=steps,
        kinds=("nan_grad", "storage_fail"), rate=args.rate)
    nan_layer = 1
    menu = [("nan_grad", max(1, steps // 3)),
            (f"nan_inject:{nan_layer}", max(2, steps // 2)),
            ("crash", 2 * steps // 3)]
    inj = FaultInjector(inj.pending + menu)
    print(f"fault schedule: {inj.pending}")

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_run_")
    ckpt_dir = os.path.join(workdir, "ckpt")
    crashes = 0
    corrupted = args.no_corrupt_newest
    while True:
        loop = ResilientTrainLoop(step_fn, init_state(), data_iter(),
                                  ckpt_dir=ckpt_dir, ckpt_every=2,
                                  injector=inj)
        try:
            s_chaos = loop.run(steps)
            break
        except SimulatedCrash as e:
            crashes += 1
            print(f"worker died ({e}); relaunching (auto-resume)")
            if not corrupted:
                ckpts = atomic_ckpt.list_checkpoints(ckpt_dir)
                if ckpts:
                    victim = os.path.join(ckpts[-1][1], "a00000.bin")
                    with open(victim, "r+b") as f:
                        f.write(b"bitrot!!")
                    print(f"corrupted newest checkpoint "
                          f"(step {ckpts[-1][0]}) to exercise fallback")
                    corrupted = True
        if crashes > 8:
            print(_repro(args, "train"))
            print("CHAOS_PARITY: FAIL (crash loop)")
            return 1

    chaos_loss = eval_loss(s_chaos.params)
    chaos_pos = loop.data.state_dict()
    events = [e["kind"] for e in loop.events]
    print(f"chaos run: {crashes} crashes, {loop.total_retries} retries, "
          f"{loop.skipped_batches} skipped, final events {events}")
    print(f"chaos eval loss {chaos_loss:.6f}")

    ok = True
    # NaN provenance end-to-end: the nan_inject rollback must have named
    # the injected layer, in the rollback event AND the post-mortem
    want = f"llama.layer:{nan_layer}"
    pm_path = os.path.join(workdir, "postmortem.json")
    obs.flight_recorder.dump(pm_path)
    with open(pm_path) as f:
        pm = json.load(f)
    got = (pm.get("numerics") or {}).get("provenance")
    print(f"nan_inject provenance: post-mortem names {got!r} "
          f"(injected {want!r})")
    if got != want:
        print(f"PROVENANCE: FAIL (expected {want!r})")
        ok = False
    named = [e for e in pm.get("events", [])
             if e.get("kind") == "rollback" and e.get("first_bad") == want]
    if not named:
        print("PROVENANCE: FAIL (no rollback flight event carries "
              f"first_bad={want!r})")
        ok = False
    for a, b in zip(atomic_ckpt.flatten(s_clean.params)[0],
                    atomic_ckpt.flatten(s_chaos.params)[0]):
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-6):
            diff = float((a.double() - b.double()).abs().max())
            print(f"param mismatch: max abs diff {diff}")
            ok = False
    if chaos_pos != clean_pos:
        print(f"dataloader position mismatch: {chaos_pos} != {clean_pos}")
        ok = False
    if abs(chaos_loss - clean_loss) > 1e-6:
        print(f"final-loss mismatch: {chaos_loss} != {clean_loss}")
        ok = False
    if loop.skipped_batches != 0:
        print(f"unexpected skipped batches: {loop.skipped_batches}")
        ok = False

    if not ok:
        print(_repro(args, "train"))
    print("CHAOS_PARITY: OK" if ok else "CHAOS_PARITY: FAIL")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--serving", action="store_true",
                      help="run the serving-engine chaos suite instead "
                           "of the train-loop parity run")
    mode.add_argument("--http", action="store_true",
                      help="run the network-layer chaos suite against a "
                           "live HTTP/SSE front door")
    mode.add_argument("--router", action="store_true",
                      help="run the kill-a-replica chaos suite against a "
                           "ReplicaRouter over N in-process replicas")
    mode.add_argument("--train", action="store_true",
                      help="run the train-loop chaos parity suite "
                           "(the default; the flag names it explicitly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's kernels) or cpu "
                         "(their plain versions)")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rate", type=float, default=0.2,
                    help="per-step fault probability for the random schedule")
    ap.add_argument("--requests", type=int, default=14,
                    help="--serving/--http/--router: requests offered "
                         "over the run")
    ap.add_argument("--replicas", type=int, default=3,
                    help="--router: engine replicas behind the router")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--no-corrupt-newest", action="store_true",
                    help="skip the corrupt-newest-checkpoint tier")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.device import resolve_device

    resolve_device(args.device)      # no card: fail before any state
    if args.serving:
        return serving_main(args)
    if args.http:
        return http_main(args)
    if args.router:
        return router_main(args)
    return train_main(args)


if __name__ == "__main__":
    sys.exit(main())
