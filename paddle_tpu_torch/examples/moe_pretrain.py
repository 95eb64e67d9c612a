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
runs the kernels' plain versions.

``--dp``/``--tp`` above 1 run on ``dp * tp`` ranks, as
``examples/llama_pretrain.py`` does (spawned unless launched; the backend
from ``PADDLE_DISTRI_BACKEND``): each rank builds the (dp, 1, tp) mesh,
its slices with ``moe.init_sharded_train_state`` and its rows of one
global batch, and runs ``moe.train_step`` under ``llama.activation_mesh``
(each expert split over tp). ``--ep`` above 1 (expert parallelism,
ROADMAP A10.5) is not ported yet and raises.
"""
import argparse
import dataclasses

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.examples.llama_pretrain import (on_mesh, rank_mesh,
                                                      report_mesh,
                                                      timed_steps)
from paddle_tpu_torch.models import llama, moe

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


def config(args):
    cfg = SIZES[args.size]()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg, args.seq or cfg.max_seq_len


def mesh_rank(argv):
    """One rank of the ``--dp``/``--tp`` run (module docstring)."""
    args = parse_args(argv)
    dev, mesh = rank_mesh(args)
    cfg, seq = config(args)
    state = moe.init_sharded_train_state(
        cfg, 0, moe.make_shardings(cfg, mesh, fsdp=True),
        optimizer=args.optimizer,
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch_size, seq + 1),
                           generator=gen, device=dev)
    with llama.activation_mesh(mesh):
        rows = llama.shard_batch(tokens)
        _, losses, dt = timed_steps(
            lambda st: moe.train_step(st, rows, cfg, lr=args.lr,
                                      optimizer=args.optimizer,
                                      adafactor_eps2=args.adafactor_eps2),
            state, args.steps, dev)
    return report_mesh(args, seq, losses, dt, args.dp * args.tp)


def main(argv=None):
    args = parse_args(argv)
    if args.ep > 1:
        raise NotImplementedError(
            "expert parallelism (--ep > 1) is not ported yet "
            "(ROADMAP A10.5)")
    if args.dp * args.tp > 1:
        return on_mesh(args, argv, mesh_rank)
    dev = resolve_device(args.device)
    cfg, seq = config(args)
    state = moe.init_train_state(
        cfg, 0, optimizer=args.optimizer,
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch_size, seq + 1),
                           generator=gen, device=dev)

    def step(st):
        return moe.train_step(st, tokens, cfg, lr=args.lr,
                              optimizer=args.optimizer,
                              adafactor_eps2=args.adafactor_eps2)

    state, losses, dt = timed_steps(step, state, args.steps, dev)
    loss = losses[-1]
    print(f"losses {[round(x.item(), 4) for x in losses]}")
    print(f"loss {loss.item():.4f}")
    if args.steps > 1:
        tps = args.batch_size * seq * (args.steps - 1) / dt
        print(f"{tps:,.0f} tokens/s on {dev}")
    return loss.item()


if __name__ == "__main__":
    main()
