#!/usr/bin/env python3
"""B5's single-step kernel of two source trees timed side by side on the card.

Builds the port's kernel library from this checkout's
``paddle_tpu_torch/kernels/csrc`` and from another tree's (``--parent``:
the root of another checkout, e.g. the parent commit unpacked with
``git archive``) at the same time, then times ``mega_decode_step`` — one
decode step of Llama-3-8B at full width and depth (random bf16 weights,
seed 0) at the serving mix's walk lengths — with each library in turn,
parent, change, change, parent, ``--rounds`` times (CUDA events, ``--iters``
launches each). Prints one JSON object with every run, the medians and
the card's name and power limit.

    python3 tools/mega_decode_ab.py --parent _archive/parent [--slots 4]

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402
from mega_decode_phases import use  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import mega_decode as tmd  # noqa: E402
from paddle_tpu_torch.models import llama  # noqa: E402


def build_both(parent: Path):
    """(parent library, this tree's library), compiled concurrently."""
    libs = {"parent": _build.BUILD_DIR / "ab_parent.so",
            "change": _build.BUILD_DIR / "ab_change.so"}
    srcs = {"parent": parent / "paddle_tpu_torch" / "kernels" / "csrc",
            "change": _build.SRC_DIR}
    errors = []

    def one(name):
        try:
            _build._compile(libs[name], srcs[name])
        except RuntimeError as exc:
            errors.append(f"{name}: {exc}")
    threads = [threading.Thread(target=one, args=(n,)) for n in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    libs = build_both(args.parent.resolve())
    build_s = time.perf_counter() - t0
    cfg, params = cs.llama3_8b_bf16(llama, dev)
    walk = [len(p) + 24 for p in cs.serving_mix(cfg, args.slots)]
    kw, toks = cs.mega_inputs(cfg, dev, walk)
    x0 = params["embed"][toks].to(cfg.dtype)
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            use(libs[name])
            runs[name].append(cs.time_ms(
                lambda i=0: tmd.mega_decode_step(params, cfg, x0=x0, **kw),
                args.iters))
    print(json.dumps({
        "config": "Llama-3-8B bf16 (random weights, seed 0), one step of "
                  "mega_decode_step", "slots": args.slots, "walk": walk,
        "t": kw["t"], "runs_ms": runs,
        "median_ms": {k: float(np.median(v)) for k, v in runs.items()},
        "build_s": build_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
