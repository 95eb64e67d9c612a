#!/usr/bin/env python3
"""B1, the flash forward, of two source trees timed side by side on the card.

Builds the port's kernel library of this checkout and of another tree
(``--parent``: the root of another checkout, e.g. the parent commit
unpacked with ``git archive``) at the same time, then times B1's bf16
kernel, causal, through each tree's C entry point ``ptt_flash_fwd`` at the
main paths' shapes: Llama-3-8B's serving prefill [8, 1024, 32/8, 128], the
llama-2.6b train step's [8, 2048, 24/8, 128], the DeepSeekMoE train step's
[4, 2048, 16/16, 128] and the Llama-3.2-1B-shaped draft's D=64 at
[8, 1024, 32/8, 64]. Each shape's runs are adjacent, parent, change,
change, parent, ``--rounds`` times (CUDA events, ``--iters`` launches
each); both trees' outputs are compared, and SDPA's time is taken beside
them. Prints one JSON object with every run, the medians, each shape's
bound and the card's name and power limit.

    python3 tools/flash_fwd_ab.py --parent _archive/parent

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from grouped_gemm_ab import build_both  # noqa: E402

BF16 = 1   # the kernels' dtype code of bf16
# (B, S, Hq, Hkv, D) of each main path's call
SHAPES = {
    "serving prefill, Llama-3-8B": (8, 1024, 32, 8, 128),
    "llama-2.6b train step": (8, 2048, 24, 8, 128),
    "DeepSeekMoE train step": (4, 2048, 16, 16, 128),
    "spec draft prefill, D=64": (8, 1024, 32, 8, 64),
}


class Lib:
    """One tree's B1 entry point."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        self.lib.ptt_error_string.argtypes = [ctypes.c_int]
        self.lib.ptt_error_string.restype = ctypes.c_char_p
        fn = self.lib.ptt_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fn = fn

    def flash(self, q, k, v):
        B, S, H, D = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        err = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), B, S, H, k.shape[2], D,
                      BF16, 1, 1.0 / D ** 0.5,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ptt_flash_fwd: CUDA error {err} "
                               f"({self.lib.ptt_error_string(err).decode()})")
        return out, lse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    libs = {k: Lib(p) for k, p in build_both(args.parent.resolve()).items()}
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    order = ("parent", "change", "change", "parent")
    result = {}
    for name, (B, S, Hq, Hkv, D) in SHAPES.items():
        q, k, v = (torch.randn(s, generator=g, device=dev,
                               dtype=torch.bfloat16)
                   for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
        outs = {t: libs[t].flash(q, k, v) for t in libs}
        agree = {"out": cs.max_err(outs["change"][0], outs["parent"][0]),
                 "lse": cs.max_err(outs["change"][1], outs["parent"][1])}
        del outs
        runs = {"parent": [], "change": []}
        for _ in range(args.rounds):
            for tree in order:
                runs[tree].append(cs.time_ms(
                    lambda i=0, t=tree: libs[t].flash(q, k, v), args.iters))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_ms = cs.time_ms(
            lambda i=0: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
            args.iters)
        med = {t: float(np.median(r)) for t, r in runs.items()}
        bound = 2.0 * B * Hq * S * S * D / cs.BF16_FLOPS * 1e3
        result[name] = {"shape": [B, S, Hq, Hkv, D], "runs_ms": runs,
                        "median_ms": med,
                        "speedup": med["parent"] / med["change"],
                        "bound_ms": bound,
                        "bound_share": {t: bound / m for t, m in med.items()},
                        "sdpa_ms": sdpa_ms,
                        "change_vs_parent_max_abs_err": agree}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps({
        "config": "B1 bf16, causal, random q/k/v (seed 1)",
        "calls": result, "build_s": build_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
