"""Llama text generation with the fused decode loop on one NVIDIA Hopper
card — the port of examples/llama_generate.py, with the same flags.

``llama.generate_fused`` runs one prefill, then every decode step as a
replay of one CUDA graph (the forward, the sampling and the eos
bookkeeping captured once a call), so the host dispatches nothing per
token. Weights are random from a seed.

    python -m paddle_tpu_torch.examples.llama_generate [--max-new 64] \\
        [--temperature 0.8]

``--load`` reads a ``paddle.save``d parameter tree in the JAX package;
that format comes with the port's ``io`` (ROADMAP A11), so here it raises
``NotImplementedError``. It runs on the card; ``main(device="cpu")`` runs
the same steps as a plain loop.
"""
import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=["tiny", "740m"])
    ap.add_argument("--load", default=None,
                    help="a paddle.save'd parameter tree (not ported: "
                    "ROADMAP A11)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--eos", type=int, default=None,
                    help="eos token id: rows stop early once all emit it")
    return ap.parse_args(argv)


def main(argv=None, device="cuda"):
    """Generate twice (the first run warms up); returns the second run's
    token ids [batch, prompt_len + n] on the CPU."""
    args = parse_args(argv)
    if args.load:
        raise NotImplementedError(
            "--load reads a paddle.save'd tree, the io format of ROADMAP "
            "A11, which is not ported yet")
    dev = resolve_device(device)
    if args.size == "tiny":
        cfg = llama.tiny_llama(vocab=512, hidden=128, layers=4, heads=4,
                               kv_heads=2, seq=256, ffn=256)
    else:
        cfg = llama.LlamaConfig(
            vocab_size=32768, hidden_size=2048, intermediate_size=6144,
            num_layers=12, num_heads=16, num_kv_heads=8, head_dim=128,
            max_seq_len=2048, remat=False, dtype=torch.bfloat16)
    # weights stored in the compute dtype (the forward casts per use
    # either way)
    params = llama.init_params(cfg, seed=0, device=dev, dtype=cfg.dtype)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), device=dev)

    def run(seed):
        out = llama.generate_fused(
            params, prompt, cfg, max_new_tokens=args.max_new,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            eos_token_id=args.eos,
            generator=torch.Generator(device=dev).manual_seed(seed))
        return out.cpu()                  # waits for the card

    run(7)
    t0 = time.perf_counter()
    out = run(8)
    dt = time.perf_counter() - t0
    n_new = out.shape[1] - args.prompt_len
    print(f"generated {out.shape[0]}x{n_new} tokens in {dt:.2f}s "
          f"({out.shape[0] * n_new / dt:,.0f} tok/s) on {dev}")
    print("first row token ids:", out[0, args.prompt_len:][:16].tolist())
    return out


if __name__ == "__main__":
    main()
