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
loss and tokens/s, as the JAX example does.

``--dp``/``--tp`` above 1 run the hybrid-parallel recipe on ``dp * tp``
ranks, one process a device: outside a launched world (the PADDLE_* env
contract) the example starts the ranks itself through
``paddle_tpu_torch.distributed.spawn``, with the backend from
``PADDLE_DISTRI_BACKEND`` (gloo for two ranks that share one card, or on
the CPU). Each rank builds the (dp, 1, tp) mesh, its slices of the state
with ``init_sharded_train_state`` (fsdp on) and its rows of one global
token batch (every rank draws the same batch from a generator seeded 1,
then keeps its rows), and runs ``train_step`` under
``llama.activation_mesh``; the first rank prints the loss and tokens/s
over the devices. Two ranks on one card share it, so that is no
parallel speed. ``--sp`` (ROADMAP A10.4), ``--pp`` and ``--microbatches``
(A10.3) above 1 are not ported yet and raise.
"""
import argparse
import os
import sys
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


def on_mesh(args, argv, rank_main):
    """Run ``rank_main(argv)`` on every one of the ``--dp * --tp`` ranks:
    here when this process is a rank of a launched world of that size,
    else in ranks started by ``distributed.spawn`` (the kernels built
    first, here, so no two ranks run ``nvcc`` into one directory).
    Returns the rank's result, or None after a spawn."""
    import torch.distributed as dist

    n = args.dp * args.tp
    if dist.is_initialized() or (
            int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) == n
            and "PADDLE_MASTER" in os.environ):
        return rank_main(argv)
    from paddle_tpu_torch import distributed as pd

    if resolve_device(args.device).type == "cuda":
        from paddle_tpu_torch.kernels import _build
        _build.library()
    pd.spawn(rank_main, args=(list(sys.argv[1:] if argv is None
                                   else argv),), nprocs=n)
    return None


def rank_mesh(args):
    """This rank's device and its (dp, 1, tp) ``DeviceMesh``: the card
    picked first, then the process group (the backend from
    ``PADDLE_DISTRI_BACKEND``; gloo for CPU tensors when it is unset),
    then the mesh over it."""
    from paddle_tpu_torch import distributed as pd

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("PADDLE_LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    env = os.environ.get("PADDLE_DISTRI_BACKEND")
    pd.init_parallel_env(backend=env or ("gloo" if dev.type == "cpu"
                                         else None))
    mesh = llama.make_mesh(args.dp * args.tp, shape=(args.dp, 1, args.tp),
                           device_type=dev.type)
    return dev, mesh


def timed_steps(step, state, steps, dev):
    """``steps`` steps, the first untimed: (state, losses, seconds of
    the others)."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state, loss = step(state)
    losses = [loss]
    sync()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, loss = step(state)
        losses.append(loss)
    sync()
    return state, losses, time.perf_counter() - t0


def report_mesh(args, seq, losses, dt, n):
    """The first rank's lines: the losses, the loss and tokens/s over the
    ``n`` devices."""
    from paddle_tpu_torch import distributed as pd

    if pd.get_rank() == 0:
        print(f"losses {[round(x.item(), 4) for x in losses]}")
        print(f"loss {losses[-1].item():.4f}", flush=True)
        if args.steps > 1:
            tps = args.batch_size * seq * (args.steps - 1) / dt
            print(f"{tps:,.0f} tokens/s over {n} device(s) "
                  f"({tps / n:,.0f} tokens/s/device)", flush=True)
    pd.barrier()
    pd.destroy_process_group()
    return losses[-1].item()


def mesh_rank(argv):
    """One rank of the ``--dp``/``--tp`` run (module docstring)."""
    args = parse_args(argv)
    dev, mesh = rank_mesh(args)
    cfg = SIZES[args.size]()
    seq = args.seq or cfg.max_seq_len
    state = llama.init_sharded_train_state(
        cfg, 0, llama.make_shardings(cfg, mesh, fsdp=True),
        optimizer=args.optimizer,
        param_dtype=torch.bfloat16 if args.bf16_params else torch.float32,
        device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch_size, seq + 1),
                           generator=gen, device=dev)
    with llama.activation_mesh(mesh):
        rows = llama.shard_batch(tokens)
        _, losses, dt = timed_steps(
            lambda st: llama.train_step(st, rows, cfg, lr=args.lr,
                                        optimizer=args.optimizer,
                                        adafactor_eps2=args.adafactor_eps2),
            state, args.steps, dev)
    return report_mesh(args, seq, losses, dt, args.dp * args.tp)


def check_mesh(args):
    """Raise for the mesh axes not ported yet."""
    if args.sp > 1:
        raise NotImplementedError(
            "context parallelism (--sp > 1) is not ported yet "
            "(ROADMAP A10.4)")
    if args.pp > 1 or args.microbatches > 0:
        raise NotImplementedError(
            "pipeline parallelism (--pp > 1, --microbatches) is not ported "
            "yet (ROADMAP A10.3)")


def main(argv=None):
    args = parse_args(argv)
    check_mesh(args)
    if args.dp * args.tp > 1:
        if args.layerwise:
            raise ValueError("--layerwise trains on one device")
        return on_mesh(args, argv, mesh_rank)
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

    def step(st):
        return llama.train_step(st, tokens, cfg, lr=args.lr,
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
