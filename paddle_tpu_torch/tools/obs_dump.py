"""obs dump: print a metrics table and write a Chrome trace — the port of
tools/obs_dump.py, with its modes, tables and output lines.

- attach to a snapshot file (written by ``observability.dump_snapshot``
  or scraped from the exposition server's ``/snapshot.json``) and print
  the table::

      python -m paddle_tpu_torch.tools.obs_dump --snapshot /tmp/obs/metrics.json

- run a tiny built-in workload with observability enabled, print the
  resulting table, and write ``snapshot.json`` + ``trace.json`` (open
  the latter in chrome://tracing or ui.perfetto.dev); the serving, moe
  and numerics demos run on the card (``--device cuda``, the default) or
  on the kernels' plain versions (``--device cpu``)::

      python -m paddle_tpu_torch.tools.obs_dump --demo serving --out /tmp/obs
      python -m paddle_tpu_torch.tools.obs_dump --demo train --out /tmp/obs
      python -m paddle_tpu_torch.tools.obs_dump --demo moe --device cpu
      python -m paddle_tpu_torch.tools.obs_dump --demo goodput --out /tmp/obs
      python -m paddle_tpu_torch.tools.obs_dump --demo numerics --out /tmp/obs

- pretty-print a crash flight-recorder dump (written on unhandled
  exception / watchdog timeout / SIGTERM when FLAGS_obs_postmortem_dir
  is set, or by ``observability.flight_recorder.dump``)::

      python -m paddle_tpu_torch.tools.obs_dump --postmortem /tmp/obs/postmortem-1234-1.json

- print the per-request table (timelines + TTFT/TPOT exemplars) from a
  live exposition server's ``/requests.json`` — or a saved copy — worst
  request first; ``--watch`` refreshes it top-style::

      python -m paddle_tpu_torch.tools.obs_dump --requests http://127.0.0.1:9464

- print the live fleet dashboard from a server's
  ``/fleet/replicas.json``, or the windowed alert table from its
  ``/alerts.json`` (``--watch`` as above)::

      python -m paddle_tpu_torch.tools.obs_dump --fleet http://127.0.0.1:9464
      python -m paddle_tpu_torch.tools.obs_dump --alerts http://127.0.0.1:9464

- print the registered ``FLAGS_*`` with ``--flags [PREFIX]``.

The readers print the same tables as the reference's for the same input
files, so either tool reads either package's dumps.
"""
import argparse
import os
import sys


def _fresh_ckpt_dir(workdir):
    """Checkpoint dir for a demo run, cleared first — a leftover
    checkpoint from a prior run with the same --out would auto-resume
    past the whole demo workload."""
    import shutil

    path = os.path.join(workdir, "ckpt")
    shutil.rmtree(path, ignore_errors=True)
    return path


def _tiny_model(device):
    """(config, f32 params, device) of the demos' tiny llama, random
    weights from seed 0: head_dim 64 (hidden 128, 2 heads), the smallest
    the card's attention and decode kernels take."""
    import dataclasses

    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import llama

    dev = resolve_device(device)
    cfg = dataclasses.replace(
        llama.tiny_llama(vocab=64, hidden=128, layers=2, heads=2, kv_heads=1,
                         seq=128, ffn=128),
        dtype=torch.float32)
    return cfg, llama.init_params(cfg, 0, device=dev), dev


def print_table(snap, out=sys.stdout):
    """Render a snapshot dict (exposition.snapshot format) as a table."""
    from paddle_tpu_torch.observability.exposition import snapshot_rows

    rows = snapshot_rows(snap)
    if not rows:
        out.write("(no non-zero series)\n")
        return rows
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    w2 = max(len(r[2]) for r in rows)
    out.write(f"{'metric':{w0}}  {'kind':{w1}}  {'labels':{w2}}  value\n")
    out.write("-" * (w0 + w1 + w2 + 12) + "\n")
    for name, kind, lbl, val in rows:
        out.write(f"{name:{w0}}  {kind:{w1}}  {lbl:{w2}}  {val}\n")
    return rows


def _fmt_ms(v):
    return f"{v:.1f}" if isinstance(v, (int, float)) else "-"


def print_request_table(payload, out=sys.stdout):
    """Render a ``/requests.json`` payload (requests_payload format):
    one row per request, worst first, plus the exemplar pointers that
    turn a p99 reading into a request_id."""
    rows = payload.get("requests") or []
    out.write(f"requests: {len(rows)} traced, "
              f"{payload.get('live', 0)} live "
              f"(sort={payload.get('sort', 'ttft')})\n")
    if not rows:
        out.write("(no traced requests — enable observability and "
                  "serve traffic)\n")
        return rows
    hdr = (f"{'request':>8} {'state':>6} {'tenant':>8} {'replica':>7} "
           f"{'queue_ms':>9} "
           f"{'ttft_ms':>9} {'tpot_ms':>8} {'tok/s':>8} {'tokens':>6} "
           f"{'cached':>6} {'offload':>7} {'preempt':>7} {'reason':>9}\n")
    out.write(hdr)
    out.write("-" * (len(hdr) - 1) + "\n")
    for r in rows:
        tps = r.get("decode_tps")
        tps_s = f"{tps:.1f}" if isinstance(tps, (int, float)) else "-"
        # terminal disposition (finished/shed/deadline_exceeded/
        # client_disconnected/drained); live rows and older payloads
        # have none
        reason = r.get("reason") or "-"
        reason = {"deadline_exceeded": "deadline",
                  "client_disconnected": "gone"}.get(reason, reason)
        out.write(f"{str(r.get('request_id')):>8} "
                  f"{'live' if r.get('live') else 'done':>6} "
                  f"{str(r.get('tenant') or '-')[:8]:>8} "
                  # which router replica hosted the stream
                  # (RequestTracer.annotate; "-" = single-engine)
                  f"{str(r.get('replica') or '-')[:7]:>7} "
                  f"{_fmt_ms(r.get('queue_ms')):>9} "
                  f"{_fmt_ms(r.get('ttft_ms')):>9} "
                  f"{_fmt_ms(r.get('tpot_ms')):>8} "
                  f"{tps_s:>8} "
                  f"{r.get('tokens', 0):>6} "
                  f"{r.get('cached_tokens', 0):>6} "
                  # how the last swap-in restore met the offload
                  # tier ("hit" = prefetch-staged, "stall" = inline h2d;
                  # "-" = never swapped in)
                  f"{str(r.get('offload') or '-')[:7]:>7} "
                  f"{r.get('preemptions', 0):>7} "
                  f"{reason[:9]:>9}\n")
    for name, qs in (payload.get("exemplar_quantiles") or {}).items():
        for q, ex in qs.items():
            out.write(f"{q} {name} exemplar: request "
                      f"{ex.get('request_id')} "
                      f"({ex.get('value', 0) * 1e3:.1f} ms) — "
                      f"GET /request/{ex.get('request_id')}.json\n")
    audits = payload.get("audit") or []
    if audits:
        out.write(f"SLO audit entries: {len(audits)} (latest: request "
                  f"{audits[-1].get('request_id')} "
                  f"{'+'.join(audits[-1].get('reasons', []))})\n")
    return rows


def print_numerics_table(rows, out=sys.stdout):
    """Render the numerics stats table (observability.numerics.rows
    format): one row per (site, layer) with absmax/rms/NaN-count/
    overflow columns, plus the relative quant error for the paired
    pre/post-quant probe sites."""
    out.write(f"numerics: {len(rows)} stat row(s)\n")
    if not rows:
        out.write("(no landed stats — set FLAGS_obs_numerics and run an "
                  "instrumented workload)\n")
        return rows
    w = max([len(r["site"]) for r in rows] + [len("site")])
    hdr = (f"{'site':{w}} {'layer':>5} {'absmax':>10} {'rms':>10} "
           f"{'nan/inf':>7} {'overflow':>8} {'quant_err':>9}\n")
    out.write(hdr)
    out.write("-" * (len(hdr) - 1) + "\n")
    for r in rows:
        layer = str(r["layer"]) if r["layer"] >= 0 else "-"
        qerr = (f"{r['quant_err']:.2e}" if r["quant_err"] is not None
                else "-")
        out.write(f"{r['site']:{w}} {layer:>5} {r['absmax']:>10.4g} "
                  f"{r['rms']:>10.4g} {r['nan_inf']:>7d} "
                  f"{r['overflow_frac']:>8.2%} {qerr:>9}\n")
    return rows


def _fetch_requests(src, sort):
    """The payload behind --requests: a URL (live server, ?sort= added)
    or a saved JSON file."""
    import json
    import urllib.parse
    import urllib.request

    if src.startswith(("http://", "https://")):
        # append /requests.json to the PATH (a caller-supplied query
        # string must survive, not have the path glued onto it)
        parts = urllib.parse.urlsplit(src)
        path = parts.path.rstrip("/")
        if not path.endswith("/requests.json"):
            path += "/requests.json"
        query = f"{parts.query}&sort={sort}" if parts.query \
            else f"sort={sort}"
        url = urllib.parse.urlunsplit(
            (parts.scheme, parts.netloc, path, query, ""))
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.load(r)
    with open(src) as f:
        return json.load(f)


def requests_mode(src, sort, watch, interval):
    if not watch:
        print_request_table(_fetch_requests(src, sort))
        return 0
    import io as _io
    import time as _time

    try:
        while True:
            payload = _fetch_requests(src, sort)
            buf = _io.StringIO()
            print_request_table(payload, out=buf)
            # top-style refresh: clear + home, one atomic write
            sys.stdout.write("\x1b[2J\x1b[H" + buf.getvalue())
            sys.stdout.flush()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _spark(values, width=12):
    """Render a value series as a unicode sparkline: scaled to
    the series' own max, newest value last."""
    vals = [v for v in (values or [])[-width:]
            if isinstance(v, (int, float))]
    if not vals:
        return "-"
    hi = max(vals)
    if hi <= 0:
        return _SPARK_GLYPHS[0] * len(vals)
    return "".join(
        _SPARK_GLYPHS[min(len(_SPARK_GLYPHS) - 1,
                          int(v / hi * (len(_SPARK_GLYPHS) - 1)))]
        for v in vals)


def print_alert_table(doc, out=sys.stdout):
    """Render an ``/alerts.json`` payload: one row per (alert,
    instance) with its windowed signal value vs threshold, firing
    rows first."""
    rows = doc.get("alerts") or []
    firing = doc.get("firing")
    if firing is None:      # embedded post-mortem tails carry only rows
        firing = sorted({r.get("alert") for r in rows
                         if r.get("state") == "firing"})
    out.write(f"alerts: {len(rows)} row(s), "
              f"{len(firing)} firing{' (' + ', '.join(firing) + ')' if firing else ''} "
              f"[windows {doc.get('window_fast_s', '-')}s/"
              f"{doc.get('window_slow_s', '-')}s, "
              f"ring {doc.get('ring_size', '-')}/"
              f"{doc.get('samples', '-')} samples]\n")
    if not rows:
        out.write("(no alert specs evaluated — enable observability "
                  "and serve traffic)\n")
        return rows
    hdr = (f"{'alert':>24} {'instance':>9} {'state':>7} "
           f"{'value':>10} {'threshold':>10} {'window':>7}\n")
    out.write(hdr)
    out.write("-" * (len(hdr) - 1) + "\n")
    order = {"firing": 0, "ok": 1, "no_data": 2}
    for r in sorted(rows, key=lambda r: (order.get(r.get("state"), 3),
                                         r.get("alert", ""),
                                         r.get("instance", ""))):
        val = r.get("value")
        val_s = f"{val:.4g}" if isinstance(val, (int, float)) else "-"
        out.write(f"{str(r.get('alert'))[:24]:>24} "
                  f"{str(r.get('instance') or '-')[:9]:>9} "
                  f"{str(r.get('state')):>7} "
                  f"{val_s:>10} "
                  f"{r.get('threshold', 0):>10.4g} "
                  f"{r.get('window_s', 0):>6.0f}s\n")
    return rows


def _fetch_alerts(src):
    """The payload behind --alerts: a base URL (live obs server or
    serving front door; /alerts.json appended) or a saved JSON file."""
    import json
    import urllib.parse
    import urllib.request

    if src.startswith(("http://", "https://")):
        parts = urllib.parse.urlsplit(src)
        path = parts.path.rstrip("/")
        if not path.endswith("/alerts.json"):
            path += "/alerts.json"
        url = urllib.parse.urlunsplit(
            (parts.scheme, parts.netloc, path, parts.query, ""))
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.load(r)
    with open(src) as f:
        return json.load(f)


def alerts_mode(src, watch, interval):
    if not watch:
        print_alert_table(_fetch_alerts(src))
        return 0
    import io as _io
    import time as _time

    try:
        while True:
            doc = _fetch_alerts(src)
            buf = _io.StringIO()
            print_alert_table(doc, out=buf)
            sys.stdout.write("\x1b[2J\x1b[H" + buf.getvalue())
            sys.stdout.flush()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def print_fleet_table(doc, out=sys.stdout):
    """Render a ``/fleet/replicas.json`` payload: one row per replica
    (state, disagg role, streams, queue/slots, tokens, p95 latencies,
    cache hit rate, SLO burn) plus the fleet totals line."""
    rows = doc.get("replicas") or []
    totals = doc.get("totals") or {}
    out.write(f"fleet: {totals.get('replicas', len(rows))} replica(s), "
              f"{totals.get('healthy', '-')} healthy, "
              f"{totals.get('live_streams', '-')} live stream(s), "
              f"{totals.get('tokens', 0)} tokens"
              f"{'' if doc.get('router') else ' (no router attached)'}\n")
    if not rows:
        out.write("(no replicas in view — run a router with "
                  "observability enabled)\n")
        return rows
    hdr = (f"{'replica':>8} {'state':>9} {'role':>7} {'hb_age':>7} "
           f"{'streams':>7} {'queue':>5} {'slots':>5} {'tokens':>7} "
           f"{'ttft_p95':>9} {'tpot_p95':>9} {'cache':>6} {'burn':>6} "
           f"{'tok/s':>12}\n")
    out.write(hdr)
    out.write("-" * (len(hdr) - 1) + "\n")
    for r in rows:
        slo = r.get("slo") or {}
        burn = slo.get("burn_rate")
        cache = r.get("cache_hit_rate")
        cache_s = f"{cache:.0%}" if isinstance(cache, (int, float)) \
            else "-"
        burn_s = f"{burn:.2f}" if isinstance(burn, (int, float)) else "-"
        out.write(
            f"{str(r.get('replica')):>8} "
            f"{str(r.get('state') or '-'):>9} "
            f"{str(r.get('role') or '-'):>7} "
            f"{_fmt_ms(r.get('hb_age_s')):>7} "
            f"{r.get('streams', 0):>7} "
            f"{r.get('queue_depth', 0):>5} "
            f"{r.get('active_slots', 0):>5} "
            f"{r.get('tokens', 0):>7} "
            f"{_fmt_ms(r.get('ttft_p95_ms')):>9} "
            f"{_fmt_ms(r.get('tpot_p95_ms')):>9} "
            f"{cache_s:>6} {burn_s:>6} "
            f"{_spark(r.get('spark')):>12}\n")
    return rows


def _fetch_fleet(src):
    """The payload behind --fleet: a base URL (live obs server or
    serving front door; /fleet/replicas.json appended) or a saved JSON
    file."""
    import json
    import urllib.parse
    import urllib.request

    if src.startswith(("http://", "https://")):
        parts = urllib.parse.urlsplit(src)
        path = parts.path.rstrip("/")
        if not path.endswith("/fleet/replicas.json"):
            path += "/fleet/replicas.json"
        url = urllib.parse.urlunsplit(
            (parts.scheme, parts.netloc, path, parts.query, ""))
        with urllib.request.urlopen(url, timeout=10) as r:
            return json.load(r)
    with open(src) as f:
        return json.load(f)


def fleet_mode(src, watch, interval):
    if not watch:
        print_fleet_table(_fetch_fleet(src))
        return 0
    import io as _io
    import time as _time

    try:
        while True:
            doc = _fetch_fleet(src)
            buf = _io.StringIO()
            print_fleet_table(doc, out=buf)
            sys.stdout.write("\x1b[2J\x1b[H" + buf.getvalue())
            sys.stdout.flush()
            _time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def demo_serving(device):
    """int8-everywhere serving demo under fire: int8 weight-only params
    AND int8 KV pools through the decode path (the path each dispatch
    took is counted in serving_decode_kernel_total{path} — the choice is
    never silent), with the survivability layer engaged — a bounded
    admission queue sheds the over-offered request, one request expires
    at its deadline, and pool pressure preempts a slot whose KV swaps to
    the host tier and back — and the prefix cache on: a follow-up
    request re-sends the first prompt and skips its cached prefix blocks
    entirely. The table shows the decode metrics plus
    serving_{shed,deadline_exceeded,kv_swap_*}_total and the
    serving_prefix_cache_* family. A second, speculative engine then
    runs a synthetic high-agreement draft and prints the serving_spec_*
    line — multiple committed tokens per verify call; one HTTP round
    trip, a two-replica router, a disaggregated pair and the alert
    table follow."""
    import numpy as np

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import AdmissionConfig, LLMEngine, ShedError

    # sample the time-series ring on EVERY engine step (the demo runs
    # seconds, not minutes — the default 1s throttle would leave the
    # sparkline/alert tail empty)
    set_flags({"obs_ts_interval_s": 0.0})
    cfg, dense_params, dev = _tiny_model(device)
    params = llama.quantize_params(dense_params)
    rng = np.random.default_rng(0)
    # num_blocks=5 with two 8-token prompts decoding 16 fresh tokens each:
    # the pool MUST preempt mid-run — with the host tier enabled the
    # victim swaps out and back instead of re-prefilling
    eng = LLMEngine(params, cfg, device=dev, max_slots=2, block_size=8,
                    max_model_len=64, num_blocks=5, prompt_buckets=[8, 32],
                    kv_dtype="int8", kv_swap_bytes=1 << 20,
                    admission=AdmissionConfig(max_queue=3),
                    prefix_cache=True, prefix_cache_host_bytes=1 << 20)
    first_prompt = rng.integers(1, 64, size=12).tolist()
    eng.add_request(first_prompt, max_new_tokens=16)
    eng.add_request(rng.integers(1, 64, size=8).tolist(),
                    max_new_tokens=16)
    # third queued request: a deadline that has already passed — evicted
    # with finish reason deadline_exceeded on its trace
    eng.add_request(rng.integers(1, 64, size=4).tolist(),
                    max_new_tokens=4, deadline_s=0.0)
    # fourth: the bounded queue (max_queue=3) sheds it with a typed error
    try:
        eng.add_request(rng.integers(1, 64, size=4).tolist(),
                        max_new_tokens=4)
    except ShedError as e:
        print(f"load shed: {e}")
    results = eng.run()
    # re-send the first prompt: its full blocks stayed in the prefix
    # cache after the request finished, so this admission pins them and
    # prefills only the one-block suffix (a cache HIT)
    eng.add_request(first_prompt, max_new_tokens=4)
    results = eng.run()
    reg = obs.get_registry()
    print(f"demo serving: {len(results)} requests, "
          f"{sum(len(v) for v in results.values())} tokens "
          "(int8 weights + int8 KV pools)")
    print("decode prefix bucket: "
          f"{int(reg.gauge('serving_decode_prefix_bucket').labels().value)}"
          " tokens; decode recompiles: "
          f"{int(reg.counter('serving_decode_recompiles_total').labels().value)}"
          "; kv bytes/call: "
          f"{int(reg.gauge('serving_decode_kv_read_bytes').labels().value)}")

    def _c(name, **lbl):
        return int(reg.counter(name).labels(**lbl).value)

    # which decode path served the dispatches ("auto" picks the mega
    # kernel on the card at <= 4 slots and the ragged walk elsewhere; the
    # choice is never silent) and how many decode variants the engine
    # built
    print("decode kernel paths: "
          f"mega={_c('serving_decode_kernel_total', path='mega')} "
          f"ragged={_c('serving_decode_kernel_total', path='ragged')} "
          f"bucketed={_c('serving_decode_kernel_total', path='bucketed')} "
          f"dense={_c('serving_decode_kernel_total', path='dense')}; "
          "decode variants: "
          f"{int(reg.gauge('serving_decode_variants').labels().value)}")

    print("degraded modes: "
          f"shed={_c('serving_shed_total', reason='queue_full')} "
          f"deadline_exceeded={_c('serving_deadline_exceeded_total')} "
          f"kv_swap_out={_c('serving_kv_swap_out_total')} "
          f"kv_swap_in={_c('serving_kv_swap_in_total')}")
    # the async offload tier behind the swap/spill traffic above —
    # prefetch hits consumed staged payloads, stalls paid h2d inline,
    # proactive spills moved cold cached blocks host-side in the
    # background (in-flight bytes are 0 at this drained point)
    print("kv offload: "
          f"prefetch_hits={_c('serving_kv_offload_prefetch_hits_total')} "
          f"stalls={_c('serving_kv_offload_stalls_total')} "
          "stall_seconds="
          f"{reg.counter('serving_kv_offload_stall_seconds_total').labels().value:.4f} "
          "proactive_spills="
          f"{_c('serving_kv_offload_proactive_spills_total')} "
          "inflight_bytes="
          f"{int(reg.gauge('serving_kv_offload_inflight_bytes').labels().value)}")
    print("prefix cache: "
          f"hits={_c('serving_prefix_cache_hits_total')} "
          f"misses={_c('serving_prefix_cache_misses_total')} "
          f"prefill_tokens_skipped="
          f"{_c('serving_prefill_tokens_skipped_total')} "
          "cached_blocks="
          f"{int(reg.gauge('serving_prefix_cache_blocks').labels().value)}")
    # a speculative engine over the same model — the draft here is the
    # target itself (the synthetic high-agreement draft), so every wave
    # commits spec_tokens per slot off ONE batched verify call
    seng = LLMEngine(dense_params, cfg, device=dev, max_slots=2, block_size=8,
                     max_model_len=64, prompt_buckets=[8, 32],
                     draft_params=dense_params, draft_config=cfg,
                     spec_tokens=4)
    for _ in range(2):
        seng.add_request(rng.integers(1, 64, size=6).tolist(),
                         max_new_tokens=12)
    seng.run()
    print("speculative: "
          f"proposed={_c('serving_spec_proposed_total')} "
          f"accepted={_c('serving_spec_accepted_total')} "
          "acceptance="
          f"{reg.gauge('serving_spec_acceptance_rate').labels().value:.2f} "
          "tokens/wave="
          f"{reg.gauge('serving_spec_tokens_per_wave').labels().value:.2f} "
          f"draft_steps={seng.spec_draft_steps} "
          f"verify_calls={seng.spec_verify_calls}")
    # one real HTTP round-trip through the SSE front door — the
    # speculative engine serves one request over a socket, then the
    # serving_http_* family has non-zero evidence in the table
    import json as _json
    import urllib.request

    from paddle_tpu_torch.serving import HTTPFrontDoor
    front = HTTPFrontDoor(seng)
    host, port = front.start()
    req = urllib.request.Request(
        f"http://{host}:{port}/v1/generate",
        data=_json.dumps({"prompt": rng.integers(1, 64, size=6).tolist(),
                          "max_new_tokens": 6,
                          "stream": False}).encode(),
        headers={"X-Tenant": "demo"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        doc = _json.loads(resp.read())
    ready = urllib.request.urlopen(
        f"http://{host}:{port}/readyz", timeout=30).status
    front.stop()
    print(f"http front door: one round-trip -> {len(doc['tokens'])} "
          f"tokens ({doc['reason']}), readyz={ready}; "
          f"requests_total[200]={_c('serving_http_requests_total', code='200')} "
          f"client_disconnects={_c('serving_http_client_disconnects_total')} "
          "active_streams="
          f"{int(reg.gauge('serving_http_active_streams').labels().value)} "
          "send_queue_depth="
          f"{int(reg.gauge('serving_http_send_queue_depth').labels().value)}")
    print(f"finish reasons: {eng.finish_reasons}")

    # two replicas behind a ReplicaRouter, then ONE fleet scrape —
    # every engine metric above lands replica-labeled from the router's
    # step threads, counters sum fleet-wide, gauges stay per-replica
    from paddle_tpu_torch.observability import fleet as _fleet
    from paddle_tpu_torch.serving import ReplicaRouter

    def _mk(**kw):
        return LLMEngine(dense_params, cfg, device=dev, max_slots=2, block_size=8, max_model_len=64,
                         prompt_buckets=[8, 32], **kw)

    router = ReplicaRouter([_mk(), _mk()], idle_wait=0.001).start()
    shared = rng.integers(1, 64, size=16).tolist()
    rids = [router.submit(shared[:8] + shared[8:][:4 * i],
                          max_new_tokens=6) for i in range(4)]
    for rid in rids:
        router.wait(rid, timeout=120)
    router.check()
    fdoc = _fleet.replicas_payload()
    per = {r["replica"]: r.get("tokens", 0) for r in fdoc["replicas"]}
    fleet_tokens = _fleet.get_aggregator().fleet_counter_value(
        "serving_router_dispatch_total")
    print(f"fleet scrape: {fdoc['totals']['replicas']} replicas "
          f"({fdoc['totals'].get('healthy')} healthy), per-replica "
          f"tokens {per}, dispatches fleet-wide "
          f"{int(fleet_tokens)}")
    print_fleet_table(fdoc)
    router.stop()

    # disaggregated prefill/decode — one prefill-role replica spills
    # finished prefills into the shared host relay, one decode-role
    # replica restores them with a batched h2d scatter and streams the
    # decode; the handoff line is the disagg evidence (outcomes counted,
    # relay drained back to 0 bytes)
    from paddle_tpu_torch.serving.kv_swap import HostKVPool
    relay = HostKVPool(64 << 20, kind="relay")
    p_eng = _mk(role="prefill", relay=relay)
    d_eng = _mk(role="decode", relay=relay)
    drouter = ReplicaRouter([p_eng, d_eng], names=["p0", "d0"],
                            idle_wait=0.001).start()
    drids = [drouter.submit(rng.integers(1, 64, size=6).tolist(),
                            max_new_tokens=6) for _ in range(2)]
    for rid in drids:
        drouter.wait(rid, timeout=120)
    drouter.stop()
    # the handoff outcomes land replica-scoped (p0 spills, d0 restores)
    # — read them fleet-aggregated, like any dashboard would
    agg = _fleet.get_aggregator()
    print("disagg handoff: "
          "ok="
          f"{int(agg.fleet_counter_value('serving_disagg_handoffs_total', outcome='ok'))} "
          "restored="
          f"{int(agg.fleet_counter_value('serving_disagg_handoffs_total', outcome='restored'))} "
          f"bytes={p_eng.handoff_bytes} "
          "relay_bytes="
          f"{int(reg.gauge('serving_disagg_kv_relay_bytes').labels().value)} "
          f"handoff_resumes={drouter.handoff_resumes}")
    print()
    print_request_table(obs.requests_payload())

    # the windowed alert table (burn-rate + anomaly watchers) over
    # everything the demo just did, plus the process-wide tok/s trend
    # from the time-series ring — the same rows /alerts.json serves
    from paddle_tpu_torch.observability import timeseries as _tsmod

    print()
    print_alert_table(_tsmod.alerts_payload())
    rates = _tsmod.get_store().rate_series("serving_tokens_total", n=16)
    print(f"tok/s spark: {_spark(rates, width=16)} "
          f"(last {len(rates)} sample intervals)")


def demo_moe(device):
    """Two dropless-MoE programs over one routing shape on the dense-base
    form: the second reuses the dispatch plan — the table shows
    moe_plan_cache_{hits,misses}_total and moe_dispatch_fallbacks_total
    (the tiny shape's base buffer would dwarf the work:
    dense_buffer_too_big); a forward on the fused form counts
    moe_gmm_fused_dispatch_total{path}. On the card the grouped GEMMs'
    tile widths are measured on first encounter (moe_tiling_*)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.kernels import moe_dispatch
    from paddle_tpu_torch.models import moe

    dev = resolve_device(device)
    moe_dispatch.clear_plan_cache()
    cfg = dataclasses.replace(moe.tiny_moe(hidden=128, heads=2),
                              dispatch="dense")
    state = moe.init_train_state(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                           device=dev)
    # two programs over the same routing shape: the eval forward derives
    # the dispatch plan (miss), the train steps reuse it (hit)
    with torch.no_grad():
        moe.loss_fn(state.params, tokens, cfg)
    for _ in range(2):
        state, loss = moe.train_step(state, tokens, cfg)
    fused = dataclasses.replace(cfg, dispatch="fused")
    with torch.no_grad():
        moe.forward(state.params, tokens, fused)
    print(f"demo moe: {cfg.num_layers} layers x {cfg.num_experts} experts, "
          f"loss {float(loss):.3f}")


def _toy_step(state, batch):
    import torch

    w = state["w"] - 0.1 * batch.mean()
    return {"w": w}, torch.abs(w).sum()


def _toy_batches():
    import torch

    return [torch.full((2,), 0.1 * (i + 1)) for i in range(8)]


def demo_train(workdir):
    import torch

    from paddle_tpu_torch.distributed.resilience import ResilientTrainLoop

    batches = _toy_batches()
    loop = ResilientTrainLoop(
        _toy_step, {"w": torch.ones((2,))}, batches,
        ckpt_dir=_fresh_ckpt_dir(workdir), ckpt_every=2,
        rng_key=None)
    loop.run(len(batches))
    print(f"demo train: {loop.step} steps, "
          f"{len([e for e in loop.events if e['kind']=='checkpoint_saved'])}"
          " checkpoints")


def demo_goodput(workdir):
    """Chaos-injected goodput demo: a resilient train run with an
    injected NaN (one rollback-retry) and periodic checkpoints, then the
    goodput report — bucket fractions summing to 1.0 — and a manual
    flight-recorder post-mortem dump."""
    import torch

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.distributed.resilience import (FaultInjector,
                                                         ResilientTrainLoop)

    batches = _toy_batches()
    loop = ResilientTrainLoop(
        _toy_step, {"w": torch.ones((2,))}, batches,
        ckpt_dir=_fresh_ckpt_dir(workdir), ckpt_every=3,
        rng_key=None, injector=FaultInjector("nan_grad@4"))
    loop.run(len(batches))
    rep = obs.goodput.get_tracker().report()
    print(f"demo goodput: {loop.step} steps, "
          f"{loop.total_retries} rollback(s)")
    print(f"goodput ratio {rep['goodput_ratio']:.3f} over "
          f"{rep['total_seconds']:.3f}s:")
    for b, frac in rep["fractions"].items():
        if frac > 0:
            print(f"  {b:16s} {frac:7.2%}  "
                  f"({rep['seconds'][b]:.3f}s)")
    pm = obs.flight_recorder.dump(
        os.path.join(workdir, "postmortem.json"))
    print(f"post-mortem: {pm} "
          "(pretty-print with python -m paddle_tpu_torch.tools.obs_dump "
          "--postmortem)")


def demo_numerics(workdir, device):
    """Numerics-observatory demo: all three int8 sites report their
    quant-error budget (weight_only from llama.quantize_params,
    expert_int8 from moe.quantize_expert_params, kv_int8 from an int8-KV
    engine run), then a seeded ``nan_inject`` chaos step shows the
    per-layer stats ladder naming the poisoned layer in the rollback's
    provenance — the stats table prints it all."""
    import functools

    import numpy as np
    import torch

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.distributed.resilience import (FaultInjector,
                                                         ResilientTrainLoop)
    from paddle_tpu_torch.models import llama, moe
    from paddle_tpu_torch.observability import numerics
    from paddle_tpu_torch.serving import LLMEngine

    numerics.enable()
    cfg, params, dev = _tiny_model(device)

    # site 1: weight-only int8 (quantize pairs the pre/post tensors)
    qparams = llama.quantize_params(params)
    # site 2: int8 expert weights
    moe.quantize_expert_params(moe.init_params(moe.tiny_moe(), 1,
                                               device=dev))
    # site 3: int8 KV pools through a short int8-everywhere serving run
    rng = np.random.default_rng(0)
    eng = LLMEngine(qparams, cfg, device=dev, max_slots=2, block_size=8,
                    max_model_len=64, prompt_buckets=[8, 32],
                    kv_dtype="int8")
    for _ in range(2):
        eng.add_request(rng.integers(1, 64, size=8).tolist(),
                        max_new_tokens=8)
    results = eng.run()

    # provenance: a seeded nan_inject poisons layer 1 for one attempt;
    # the ladder names it on the rollback, the retry recovers
    state = llama.init_train_state(cfg, 2, device=dev)
    batches = [torch.from_numpy(rng.integers(1, 64, size=(2, 16))
                                .astype(np.int32)).to(dev)
               for _ in range(4)]
    step = functools.partial(llama.train_step, config=cfg, lr=1e-3)
    loop = ResilientTrainLoop(step, state, batches,
                              injector=FaultInjector("nan_inject:1@1"))
    loop.run(len(batches))
    rollbacks = [e for e in loop.events if e["kind"] == "rollback"]
    numerics.flush()
    print(f"demo numerics: {len(results)} requests served int8-KV, "
          f"{loop.step} train steps, {len(rollbacks)} rollback(s)")
    first_bad = rollbacks[0].get("first_bad") if rollbacks else None
    print(f"nan_inject provenance: first bad layer = {first_bad}")
    reg = obs.get_registry()
    for site in ("weight_only", "expert_int8", "kv_int8"):
        v = reg.gauge("numerics_quant_error").labels(site=site).value
        print(f"quant-error budget {site}: {v:.2e}")
    print()
    print_numerics_table(numerics.rows())
    pm = obs.flight_recorder.dump(os.path.join(workdir, "postmortem.json"))
    print(f"\npost-mortem (numerics section embedded): {pm}")


def print_postmortem(path, out=sys.stdout):
    """Pretty-print one flight-recorder post-mortem JSON."""
    import json
    import time as _time

    with open(path) as f:
        doc = json.load(f)
    when = _time.strftime("%Y-%m-%d %H:%M:%S",
                          _time.localtime(doc.get("unix_time", 0)))
    out.write(f"post-mortem  trigger={doc.get('trigger')}  "
              f"pid={doc.get('pid')}  {when}\n")
    err = doc.get("error")
    if err:
        out.write(f"error: {err.get('type')}: {err.get('message')}\n")
    gp = doc.get("goodput")
    if gp:
        out.write(f"goodput ratio {gp.get('goodput_ratio', 0):.3f} "
                  f"over {gp.get('total_seconds', 0):.3f}s (")
        out.write(", ".join(
            f"{b} {f:.1%}" for b, f in gp.get("fractions", {}).items()
            if f > 0.0005) + ")\n")
    spans = doc.get("open_spans") or {}
    if any(spans.values()):
        out.write("open spans at dump:\n")
        for tid, names in spans.items():
            out.write(f"  thread {tid}: {' > '.join(names)}\n")
    events = doc.get("events") or []
    out.write(f"\nlast {len(events)} events:\n")
    t_end = events[-1]["t"] if events else 0.0
    for ev in events:
        rest = {k: v for k, v in ev.items() if k not in ("t", "kind")}
        detail = "  ".join(f"{k}={v}" for k, v in rest.items())
        out.write(f"  {ev['t'] - t_end:+9.3f}s  {ev['kind']:20s} "
                  f"{detail}\n")
    reqs = doc.get("requests")
    if reqs:
        out.write("\nrequests at dump:\n")
        print_request_table(reqs, out=out)
    num = doc.get("numerics")
    if num:
        out.write("\nnumerics at dump:\n")
        if num.get("provenance"):
            out.write(f"NaN provenance: first bad layer = "
                      f"{num['provenance']}\n")
        print_numerics_table(num.get("rows") or [], out=out)
    ts = doc.get("timeseries")
    if ts:
        out.write("\ntimeseries tail at dump (the trajectory into the "
                  "failure):\n")
        entries = ts.get("entries") or []
        # one sparkline per watched signal over the embedded tail,
        # newest value printed beside it
        signals = {}
        for e in entries:
            for k, v in (e.get("signals") or {}).items():
                signals.setdefault(k, []).append(
                    v if isinstance(v, (int, float)) else None)
        t_end = entries[-1]["t"] if entries else 0.0
        if entries:
            out.write(f"  {len(entries)} entries spanning "
                      f"{t_end - entries[0]['t']:.1f}s\n")
        for k in sorted(signals):
            vals = [v for v in signals[k] if v is not None]
            last = f"{vals[-1]:.4g}" if vals else "-"
            out.write(f"  {k:32s} {_spark(signals[k], width=24):>24} "
                      f"last={last}\n")
        fired = [e for e in entries if e.get("firing")]
        for e in fired[-5:]:
            out.write(f"  {e['t'] - t_end:+9.3f}s firing: "
                      f"{', '.join(e['firing'])}\n")
        if ts.get("alerts"):
            out.write("final alert table:\n")
            print_alert_table({"alerts": ts["alerts"]}, out=out)
    metrics = doc.get("metrics")
    if metrics:
        out.write("\nmetrics at dump:\n")
        print_table(metrics, out=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snapshot", default=None,
                    help="print the table from an existing JSON snapshot")
    ap.add_argument("--postmortem", default=None,
                    help="pretty-print a flight-recorder post-mortem dump")
    ap.add_argument("--requests", default=None, metavar="URL_OR_FILE",
                    help="print the per-request table from a live "
                         "exposition server base URL (/requests.json is "
                         "appended) or a saved payload file")
    ap.add_argument("--sort", default="ttft",
                    choices=("ttft", "tpot", "queue", "tokens",
                             "finished"),
                    help="--requests sort column (worst/highest first)")
    ap.add_argument("--fleet", default=None, metavar="URL_OR_FILE",
                    help="print the per-replica fleet table from a live "
                         "server base URL (/fleet/replicas.json is "
                         "appended; obs server or serving front door) "
                         "or a saved payload file")
    ap.add_argument("--alerts", default=None, metavar="URL_OR_FILE",
                    help="print the windowed alert table from a live "
                         "server base URL (/alerts.json is appended; "
                         "obs server or serving front door) or a saved "
                         "payload file")
    ap.add_argument("--watch", action="store_true",
                    help="with --requests/--fleet/--alerts URL: refresh "
                         "the table top-style until interrupted")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--watch refresh period in seconds")
    ap.add_argument("--flags", default=None, metavar="PREFIX",
                    nargs="?", const="obs_",
                    help="print registered FLAGS_* (value/default/help); "
                         "optional prefix filter, default obs_")
    ap.add_argument("--demo", choices=("serving", "train", "moe",
                                       "goodput", "numerics"),
                    default=None,
                    help="run a tiny built-in workload with obs enabled")
    ap.add_argument("--out", default="./obs_dump",
                    help="demo mode: directory for snapshot.json/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="demo mode: cuda (the default: the card's "
                         "kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    if args.snapshot:
        from paddle_tpu_torch.observability import load_snapshot

        print_table(load_snapshot(args.snapshot))
        return 0
    if args.postmortem:
        print_postmortem(args.postmortem)
        return 0
    if args.requests:
        return requests_mode(args.requests, args.sort, args.watch,
                             args.interval)
    if args.fleet:
        return fleet_mode(args.fleet, args.watch, args.interval)
    if args.alerts:
        return alerts_mode(args.alerts, args.watch, args.interval)
    if args.flags is not None:
        import paddle_tpu_torch.observability  # noqa: F401  (registers FLAGS_obs_*)
        from paddle_tpu_torch.framework.flags import flag_entries

        for name, (value, default, help_) in flag_entries(
                args.flags).items():
            mark = "" if value == default else f"  (default {default!r})"
            print(f"FLAGS_{name} = {value!r}{mark}\n    {help_}")
        return 0
    if args.demo is None:
        ap.error("pass --snapshot PATH, --postmortem PATH, --requests "
                 "URL_OR_FILE, --fleet URL_OR_FILE, --alerts "
                 "URL_OR_FILE or --demo {serving,train,moe,goodput}")

    import paddle_tpu_torch.observability as obs

    if args.demo in ("serving", "moe", "numerics"):
        from paddle_tpu_torch.device import resolve_device

        resolve_device(args.device)      # no card: fail before any state
    obs.enable()
    os.makedirs(args.out, exist_ok=True)
    if args.demo == "serving":
        demo_serving(args.device)
    elif args.demo == "moe":
        demo_moe(args.device)
    elif args.demo == "goodput":
        demo_goodput(args.out)
    elif args.demo == "numerics":
        demo_numerics(args.out, args.device)
    else:
        demo_train(args.out)
    snap_path = obs.dump_snapshot(os.path.join(args.out, "snapshot.json"))
    trace_path = obs.export_chrome_trace(os.path.join(args.out,
                                                      "trace.json"))
    print_table(obs.snapshot())
    print(f"\nsnapshot: {snap_path}\nchrome trace: {trace_path} "
          "(open in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:       # `obs_dump ... | head` is fine
        os._exit(0)
