"""Serve: launch the HTTP/SSE front door over an LLMEngine — the port of
tools/serve.py, with the same flags and output lines.

The production entrypoint shape over ``paddle_tpu_torch.serving.http``:
build a model (``--model tiny`` initializes random weights from
``--seed`` at the configured size; ``--params`` is reserved and raises,
as the reference's does), wire the engine
(``--decode-kernel/--spec-tokens/--prefix-cache/--kv-int8`` pass
straight through), and serve until SIGTERM/Ctrl-C — both of which DRAIN:
admission stops (503 + Connection: close), in-flight streams finish up
to FLAGS_serve_drain_s, then the process exits 0.

    python -m paddle_tpu_torch.tools.serve --port 8000 --hidden 1024 \\
        --heads 8 --kv-heads 8 --dtype bfloat16 --block-size 64 \\
        --max-len 512
    curl -N -XPOST localhost:8000/v1/generate \\
         -d '{"prompt": [1,2,3], "max_new_tokens": 8}'
    curl localhost:8000/readyz

It runs on the card (``--device cuda``, the default; head_dim
``hidden / heads`` must be 64 or 128 for the card's attention kernels);
``--device cpu`` runs the kernels' plain versions. Engine/obs flags ride
``--flags name=value,...`` (set_flags names, e.g.
``--flags serve_drain_s=5,obs_enabled=true``). ``--port 0`` binds an
ephemeral port; the bound address is printed as ``serving on
http://HOST:PORT``.
"""
import argparse
import signal
import sys


def build_engine(args):
    import dataclasses

    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import (AdmissionConfig, LLMEngine,
                                          ResilientEngine)

    if args.model != "tiny":
        raise SystemExit(f"unknown --model {args.model!r} (have: tiny)")
    if args.params:
        raise SystemExit("--params loading is not wired yet; "
                         "--model tiny serves random weights")
    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    cfg = dataclasses.replace(
        llama.tiny_llama(vocab=args.vocab, hidden=args.hidden,
                         layers=args.layers, heads=args.heads,
                         kv_heads=args.kv_heads, seq=args.max_len,
                         ffn=args.hidden * 2),
        dtype=dtype)
    params = llama.init_params(cfg, seed=args.seed, device=dev, dtype=dtype)
    if args.int8:
        params = llama.quantize_params(params)
    draft_params = draft_cfg = None
    if args.spec_tokens > 0 and args.draft_layers > 0:
        draft_cfg = llama.draft_config(cfg, num_layers=args.draft_layers)
        draft_params = llama.init_params(draft_cfg, seed=args.seed + 1,
                                         device=dev, dtype=dtype)
    admission = AdmissionConfig(
        max_queue=args.max_queue,
        rate_tokens_per_s=args.rate_tokens_per_s,
        shed_free_frac=args.shed_free_frac)
    eng = LLMEngine(
        params, cfg, max_slots=args.max_slots,
        block_size=args.block_size, max_model_len=args.max_len,
        decode_steps=args.decode_steps,
        kv_dtype="int8" if args.kv_int8 else None,
        admission=admission,
        kv_swap_bytes=args.kv_swap_bytes,
        prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk,
        decode_kernel=args.decode_kernel,
        draft_params=draft_params, draft_config=draft_cfg,
        spec_tokens=max(1, args.spec_tokens), seed=args.seed, device=dev)
    return ResilientEngine(eng)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="tiny",
                    help="model preset (tiny = random-weight tiny llama "
                         "at the --vocab/--hidden/... size)")
    ap.add_argument("--params", default=None,
                    help="reserved: path to saved weights")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 binds an ephemeral port (printed)")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--decode-steps", type=int, default=1)
    ap.add_argument("--decode-kernel", default="auto",
                    choices=("auto", "ragged", "bucketed", "mega"))
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only params")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV pools")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative decoding: draft proposal depth "
                         "(0 = off; needs --draft-layers)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers of the random-init draft model")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--rate-tokens-per-s", type=float, default=0.0)
    ap.add_argument("--shed-free-frac", type=float, default=0.0)
    ap.add_argument("--kv-swap-bytes", type=int, default=0)
    ap.add_argument("--obs", action="store_true",
                    help="enable the observability registry + tracer")
    ap.add_argument("--obs-port", type=int, default=None,
                    help="also start the standalone observability HTTP "
                         "server on this port (0 = ephemeral, printed; "
                         "implies --obs). The front door itself serves "
                         "/metrics and /fleet/* too — this adds the "
                         "full obs surface: /trace.json, /requests.json,"
                         " /control/profile")
    ap.add_argument("--flags", default=None,
                    help="comma list of name=value flags "
                         "(e.g. serve_drain_s=5)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.serving import HTTPFrontDoor

    if args.flags:
        staged = {}
        for item in filter(None, args.flags.split(",")):
            name, _, val = item.partition("=")
            staged[name.strip()] = val.strip()
        set_flags(staged)
    if args.obs or args.obs_port is not None:
        obs.enable()

    reng = build_engine(args)
    front = HTTPFrontDoor(reng, host=args.host, port=args.port)
    host, port = front.start()
    print(f"serving on http://{host}:{port}", flush=True)
    if args.obs_port is not None:
        srv = obs.start_http_server(port=args.obs_port)
        print(f"observability on http://{srv.host}:{srv.port}",
              flush=True)

    # SIGTERM (orchestrator) and SIGINT (Ctrl-C) both drain: stop
    # admission, finish in-flight streams up to FLAGS_serve_drain_s,
    # then exit cleanly. A second signal cuts the drain budget to 0.
    def on_signal(signum, _frame):
        if front.draining:
            front._drain_budget = 0.0
            return
        print(f"signal {signum}: draining "
              "(in-flight streams finish, new requests 503)", flush=True)
        front.begin_drain()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    while not front.wait_drained(timeout=0.2):
        pass
    front.stop()
    print("drained; bye", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
