"""Train Llama-3-8B on one NVIDIA Hopper card with host-streamed layers —
the port of examples/train_8b_single_chip.py.

The host-streamed layer-wise step (``optimizer/offload.py``,
``make_streaming_train_step``) keeps each layer's bf16 parameters and
adafactor moments in its own pinned host block: the forward pass copies
layer l+1 in while layer l computes; the backward pass re-runs each
layer, takes its gradients, applies the adafactor update and copies the
updated layer back while the next one computes. The card holds the
embedding, the head, the saved layer inputs and a few layers in flight.

Run (one H100):

    python -m paddle_tpu_torch.examples.train_8b_single_chip \\
        [--batch 8] [--seq 2048] [--steps 5]

It builds random weights from a seed and one random token batch, runs one
first step (which builds the kernels), then ``--steps`` steps, printing
each step's tokens/s and loss (the loss read back ends each step's
timing). ``--device cpu`` runs the plain versions (with ``--size tiny``,
a small model, for a check without a card); without ``--device cpu`` it
needs a capability-(9, 0) card and raises otherwise.
"""
import argparse
import time

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.optimizer.offload import (
    init_streaming_train_state, make_streaming_train_step, pinned_bytes)

SIZES = {
    "8b": lambda seq: llama.LlamaConfig(max_seq_len=seq, remat=True,
                                        loss_chunks=16),
    "tiny": lambda seq: llama.tiny_llama(vocab=512, hidden=128, layers=4,
                                         heads=4, kv_heads=2, seq=seq,
                                         ffn=256),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--size", default="8b", choices=sorted(SIZES),
                    help="'8b' (Llama-3-8B, default) or 'tiny'")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SIZES[args.size](args.seq)
    print(f"initializing {args.size} (per layer on {dev}, then parked)...")
    state = init_streaming_train_state(cfg, 0, device=dev)
    if dev.type == "cuda":
        print(f"pinned host bytes: "
              f"{pinned_bytes([state.layers, state.nu_layers])}")
    step = make_streaming_train_step(cfg, lr=3e-4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq + 1),
                           generator=gen, device=dev)
    state, loss = step(state, tokens)          # builds the kernels
    print(f"first step done; loss={loss.item():.3f}")
    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(loss.item())             # waits for the step
        dt = time.perf_counter() - t0
        print(f"step {i}: {args.batch * args.seq / dt:,.0f} tok/s  "
              f"loss={losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
