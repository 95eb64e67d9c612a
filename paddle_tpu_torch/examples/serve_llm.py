"""Continuous-batching LLM serving on one NVIDIA Hopper card — the port of
examples/serve_llm.py, with the same flags.

Drives ``paddle_tpu_torch.serving.LLMEngine``: paged KV, bucketed
prefill, mid-decode admission, EOS reclamation and recompute preemption,
on random bf16 weights from a seed and synthetic prompts.

    python -m paddle_tpu_torch.examples.serve_llm --slots 2 --requests 6
    python -m paddle_tpu_torch.examples.serve_llm --hidden 2048 \\
        --heads 16 --kv-heads 8 --layers 16 --int8

(head_dim is hidden / heads; the port's attention kernels take 64 and
128.)

``--int8`` serves int8 weight-only params (``llama.quantize_params``), as
the JAX example does; the int8 KV pools (``kv_dtype="int8"``) are driven
by ``chip_smoke.py``. It runs on the card; ``main(device="cpu")`` runs the
kernels' plain versions.
"""
import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.serving import LLMEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="decode iterations per engine call")
    ap.add_argument("--int8", action="store_true",
                    help="weight-only int8 decode (quantize_params)")
    return ap.parse_args(argv)


def main(argv=None, device="cuda"):
    """Serve the synthetic requests; returns the tokens generated."""
    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = llama.LlamaConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=args.hidden * 2, num_layers=args.layers,
        num_heads=args.heads, num_kv_heads=args.kv_heads,
        head_dim=args.hidden // args.heads, max_seq_len=args.max_len,
        remat=False, use_flash=False)
    params = llama.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    if args.int8:
        params = llama.quantize_params(params)
        print("int8 weight-only decode enabled")

    eng = LLMEngine(params, cfg, max_slots=args.slots,
                    block_size=args.block_size, max_model_len=args.max_len,
                    decode_steps=args.decode_steps, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(4, args.max_len - args.max_new, size=args.requests)
    ids = [eng.add_request(rng.integers(1, args.vocab, size=n).tolist(),
                           max_new_tokens=args.max_new,
                           temperature=args.temperature)
           for n in lens]
    print(f"{args.requests} requests (prompt lens {lens.tolist()}) on "
          f"{args.slots} slots, pool {eng.nb - 1} blocks x "
          f"{args.block_size} tokens, on {dev}")

    t0 = time.perf_counter()
    n_tokens = 0
    steps = 0
    while eng.has_work():
        n_tokens += len(eng.step())
        steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for rid in ids:
        toks = eng.results[rid]
        print(f"  req {rid}: {len(toks)} tokens  head={toks[:8]}")
    print(f"{n_tokens} tokens in {steps} engine steps, {dt:.2f}s "
          f"-> {n_tokens / dt:.0f} tok/s aggregate; decode paths "
          f"{dict(eng.decode_paths)}")
    return n_tokens


if __name__ == "__main__":
    main()
