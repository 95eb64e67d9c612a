"""Llama pretraining on one NVIDIA Hopper card — the port of
examples/llama_pretrain.py (its single-device path).

Run (one H100, the repo's 2.6B training configuration):

    python -m paddle_tpu_torch.examples.llama_pretrain --size 2.6b \\
        --optimizer adafactor --bf16-params

It builds random weights from a seed and one random token batch, runs
``train_step`` ``--steps`` times on that batch and prints every step's
loss and the tokens/s of the timed steps (the first step, which builds
the kernels and warms the libraries, is not timed). ``--lr`` and
``--adafactor-eps2`` (adafactor's step-size floor, 1e-3 by default as in
the JAX package) set the step size; at the defaults a random-init 2.6b
model's loss on one batch oscillates rather than falls (PERF.md), at
``--lr 3e-5 --adafactor-eps2 0`` it falls. ``--device cpu`` runs the
kernels' plain versions.

``--layerwise`` trains with the layer-wise optimizer-in-backward
(``optimizer/offload.py``: adafactor, bf16 parameters, no gradient tree
ever formed): one first step, then ``--steps`` timed ones, printing the
loss and tokens/s, as the JAX example does. Meshes (``--tp/--pp/--dp/--sp``
above 1) and the 1F1B schedule (``--microbatches``) are not ported yet
and raise.
"""
import argparse
import time

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import llama

SIZES = {
    "tiny": lambda: llama.tiny_llama(vocab=512, hidden=128, layers=4,
                                     heads=4, kv_heads=2, seq=128, ffn=256),
    "740m": lambda: llama.LlamaConfig(
        vocab_size=32768, hidden_size=2048, intermediate_size=6144,
        num_layers=12, num_heads=16, num_kv_heads=8, head_dim=128,
        max_seq_len=2048, remat=True),
    "2.6b": lambda: llama.LlamaConfig(
        vocab_size=32768, hidden_size=3072, intermediate_size=8192,
        num_layers=24, num_heads=24, num_kv_heads=8, head_dim=128,
        max_seq_len=2048, remat=True, loss_chunks=8),
    "8b": llama.llama3_8b,
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="740m", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq", type=int, default=0, help="0 = config max")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=0,
                    help=">0 enables the 1F1B pipeline schedule over pp")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--adafactor-eps2", type=float, default=1e-3,
                    help="floor of adafactor's step size")
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 parameter memory mode")
    ap.add_argument("--layerwise", action="store_true",
                    help="layer-wise optimizer-in-backward: no full grad "
                         "tree ever exists (single device, adafactor, "
                         "bf16 params)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mesh = {k: getattr(args, k) for k in ("dp", "sp", "tp", "pp")}
    if any(n > 1 for n in mesh.values()):
        raise NotImplementedError(
            f"device meshes ({mesh}) are not ported yet (ROADMAP A10)")
    if args.microbatches > 0:
        raise NotImplementedError(
            "the 1F1B pipeline schedule is not ported yet (ROADMAP A10)")
    dev = resolve_device(args.device)
    cfg = SIZES[args.size]()
    seq = args.seq or cfg.max_seq_len
    if args.layerwise:
        return layerwise(args, cfg, seq, dev)
    state = llama.init_train_state(
        cfg, 0, optimizer=args.optimizer,
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch_size, seq + 1),
                           generator=gen, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(st):
        return llama.train_step(st, tokens, cfg, lr=args.lr,
                                optimizer=args.optimizer,
                                adafactor_eps2=args.adafactor_eps2)

    state, loss = step(state)
    losses = [loss]
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        state, loss = step(state)
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0
    print(f"losses {[round(x.item(), 4) for x in losses]}")
    print(f"loss {loss.item():.4f}")
    if args.steps > 1:
        tps = args.batch_size * seq * (args.steps - 1) / dt
        print(f"{tps:,.0f} tokens/s on {dev}")
    return loss.item()


def layerwise(args, cfg, seq, dev):
    """The ``--layerwise`` run: ``make_layerwise_train_step`` on a
    ``init_layerwise_train_state`` (bf16 parameters)."""
    from paddle_tpu_torch.optimizer.offload import (
        init_layerwise_train_state, make_layerwise_train_step)
    state = init_layerwise_train_state(cfg, 0, device=dev)
    step = make_layerwise_train_step(cfg, lr=args.lr,
                                     adafactor_eps2=args.adafactor_eps2)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch_size, seq + 1),
                           generator=gen, device=dev)
    state, loss = step(state, tokens)      # builds the kernels
    loss.item()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, tokens)
    print(f"loss {loss.item():.4f}")       # waits for the last step
    dt = time.perf_counter() - t0
    tps = args.batch_size * seq * args.steps / dt
    print(f"{tps:,.0f} tokens/s on {dev} (layer-wise "
          "optimizer-in-backward)")
    return loss.item()


if __name__ == "__main__":
    main()
