"""ckpt_io: time the atomic checkpoint writer and reader on a full-size
training state — llama-2.6b (bench.py's row: adafactor, bf16 params) on
the card, the tree ``chip_smoke.py`` phase (c1) saves — at 1 and at
``atomic_ckpt.WORKERS`` threads, in the order threaded, serial, serial,
threaded, and break one serial save down into its parts (the copies off
the card, the crc32s, the writes with their fsyncs).

    python -m paddle_tpu_torch.tools.ckpt_io [--dir DIR] [--device cuda]

Prints one JSON line with the seconds, the tree's bytes and the card's
name and power limit. The snapshots go to a fresh directory under
``--dir`` (default: the system temp dir), removed at the end.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=tempfile.gettempdir())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="2.6b", choices=("2.6b", "tiny"))
    args = ap.parse_args(argv)

    import torch

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed.resilience import atomic_ckpt as ac
    from paddle_tpu_torch.models import llama

    dev = resolve_device(args.device)
    if args.size == "2.6b":
        cfg = llama.LlamaConfig(
            vocab_size=32768, hidden_size=3072, intermediate_size=8192,
            num_layers=24, num_heads=24, num_kv_heads=8, head_dim=128,
            max_seq_len=2048, remat=True)
    else:
        cfg = llama.tiny_llama()
    state = llama.init_train_state(cfg, 0, optimizer="adafactor",
                                   param_dtype=torch.bfloat16, device=dev)
    tree = {"state": state}
    nbytes = ac.tree_nbytes(tree)
    root = tempfile.mkdtemp(prefix="ptt_ckpt_io_", dir=args.dir)
    free = shutil.disk_usage(root).free
    if free < 3 * nbytes:
        raise SystemExit(f"{free} bytes free at {root}, need {3 * nbytes}")
    out = {"tree_bytes": nbytes, "workers": ac.WORKERS, "runs": [],
           "card": _card(), "dir": root}
    threads = ac.WORKERS
    try:
        for i, workers in enumerate((threads, 1, 1, threads)):
            ac.WORKERS = workers
            d = os.path.join(root, f"run{i}")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ac.save_checkpoint(tree, d, 1, keep=1)
            t1 = time.perf_counter()
            ac.validate_checkpoint(ac.list_checkpoints(d)[0][1])
            t2 = time.perf_counter()
            got, _ = ac.load_latest_valid(d, tree)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t3 = time.perf_counter()
            del got
            shutil.rmtree(d)
            out["runs"].append({"workers": workers, "save_s": t1 - t0,
                                "validate_s": t2 - t1, "load_s": t3 - t2})
        ac.WORKERS = threads
        # one serial save in parts
        leaves = ac.flatten(tree)[0]
        t0 = time.perf_counter()
        raws = [ac._host(leaf)[0] for leaf in leaves]
        t1 = time.perf_counter()
        for raw in raws:
            zlib.crc32(memoryview(raw))
        t2 = time.perf_counter()
        d = os.path.join(root, "parts")
        os.makedirs(d)
        for i, raw in enumerate(raws):
            with open(os.path.join(d, f"a{i:05d}.bin"), "wb") as f:
                f.write(memoryview(raw))
                f.flush()
                os.fsync(f.fileno())
        t3 = time.perf_counter()
        out["parts_serial"] = {"d2h_s": t1 - t0, "crc32_s": t2 - t1,
                               "write_fsync_s": t3 - t2,
                               "leaves": len(raws)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
