"""Collective rates between two ranks that share one card over gloo.

    python -m paddle_tpu_torch.tools.gloo_bandwidth [--mb 64 256]

Starts two ranks (``distributed.spawn``, gloo) on the first CUDA device
(``--device cpu``: CPU tensors) and times, for payloads of ``--mb``
megabytes of f32: torch's ``all_reduce`` and list ``all_gather`` of one
tensor; ``all_reduce`` in 8 chunks issued together; ``all_reduce`` of a
pinned host copy; and the port's ``collective.all_gather_dim`` and
``reduce_scatter_dim`` (blocks exchanged point to point through pinned
host memory). Prints one JSON line from the first rank: GB/s of each
rank's payload (the tensor it passes in), the mean of 3 timed calls after
a warm-up.
"""
import argparse
import json
import time

import torch


def _timed(fn, sync, reps=3):
    import torch.distributed as dist

    fn()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def rank_main(sizes, device):
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as pd
    from paddle_tpu_torch.distributed import collective as coll

    if device == "cuda":
        torch.cuda.set_device(0)
    pd.init_parallel_env(backend="gloo")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    res = {}
    for mb in sizes:
        n = mb * (1 << 20) // 4
        x = torch.randn(n, device=device)
        gb = mb / 1024
        res[f"all_reduce_{mb}MB"] = gb / _timed(lambda: dist.all_reduce(x),
                                                sync)
        parts = list(x.chunk(8))

        def chunked():
            for w in [dist.all_reduce(p, async_op=True) for p in parts]:
                w.wait()
        res[f"all_reduce_8_chunks_{mb}MB"] = gb / _timed(chunked, sync)
        if device == "cuda":
            h = torch.empty(n, pin_memory=True)

            def staged():
                h.copy_(x)
                dist.all_reduce(h)
                x.copy_(h)
            res[f"all_reduce_pinned_host_{mb}MB"] = gb / _timed(staged, sync)
        outs = [torch.empty_like(x) for _ in range(2)]
        res[f"all_gather_{mb}MB"] = gb / _timed(
            lambda: dist.all_gather(outs, x), sync)
        res[f"all_gather_dim_{mb}MB"] = gb / _timed(
            lambda: coll.all_gather_dim(x, 0), sync)
        res[f"reduce_scatter_dim_{mb}MB"] = gb / _timed(
            lambda: coll.reduce_scatter_dim(x, 0), sync)
    if pd.get_rank() == 0:
        print(json.dumps({"gloo_gb_per_s": res, "device": device,
                          "card": torch.cuda.get_device_name(0)
                          if device == "cuda" else None}), flush=True)
    pd.barrier()
    pd.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from paddle_tpu_torch import distributed as pd

    pd.spawn(rank_main, args=(args.mb, args.device), nprocs=2,
             backend="gloo")


if __name__ == "__main__":
    main()
