"""DeepSeekMoE-class pretraining on one NVIDIA Hopper card — the port of
examples/moe_pretrain.py (its single-device path).

Run (one H100, DeepSeekMoE-16B's widths cut to 12 layers, the depth that
fits one card with bf16 params and adafactor):

    python -m paddle_tpu_torch.examples.moe_pretrain --size 16b \\
        --layers 12 --batch-size 4 --seq 2048 --optimizer adafactor \\
        --bf16-params --lr 3e-5 --adafactor-eps2 0

It builds random weights from a seed and one random token batch, runs
``moe.train_step`` ``--steps`` times on that batch and prints every
step's loss and the tokens/s of the steps after the first (which builds
the kernels). ``--size tiny`` runs ``moe.tiny_moe()``; ``--device cpu``
runs the kernels' plain versions. Meshes (``--dp/--ep/--tp`` above 1)
are not ported yet and raise.
"""
import argparse
import dataclasses
import time

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.models import moe

SIZES = {"tiny": moe.tiny_moe, "16b": moe.deepseek_moe_16b}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="tiny", choices=sorted(SIZES))
    ap.add_argument("--layers", type=int, default=0,
                    help="0 = the config's depth")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq", type=int, default=0, help="0 = config max")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--adafactor-eps2", type=float, default=1e-3,
                    help="floor of adafactor's step size")
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 parameter memory mode")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mesh = {k: getattr(args, k) for k in ("dp", "ep", "tp")}
    if any(n > 1 for n in mesh.values()):
        raise NotImplementedError(
            f"device meshes ({mesh}) are not ported yet (ROADMAP A10)")
    dev = resolve_device(args.device)
    cfg = SIZES[args.size]()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    seq = args.seq or cfg.max_seq_len
    state = moe.init_train_state(
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
        return moe.train_step(st, tokens, cfg, lr=args.lr,
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


if __name__ == "__main__":
    main()
