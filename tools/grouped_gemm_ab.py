#!/usr/bin/env python3
"""B9 and B10's grouped GEMMs of two source trees timed side by side on the card.

Builds the port's kernel library of this checkout and of another tree
(``--parent``: the root of another checkout, e.g. the parent commit
unpacked with ``git archive``) at the same time, then times every
grouped-GEMM call of a MoE layer of the DeepSeekMoE train step at its
shapes (``chip_smoke.deepseek_routing``: 8192 tokens, top-6 of 64 experts,
h 2048, expert FFN 1408, the tile-padded layout) with each library in turn,
parent, change, change, parent, ``--rounds`` times, one call after the
other (CUDA events, ``--iters`` launches each): B9 with bf16 and with int8
weights, B10 ``gmm``
(down forward, down dgrad, gate|up dgrad) and ``tgmm`` (both wgrads).
Each library is called through its own tree's C interface: a tree whose
wrappers pick the tile width (``moe_dispatch.tile_width``) passes it, and
B9's expert count, as its entry points take them (``tgmm`` takes the tile
width since it runs on the Hopper kernel). Both libraries' results
are compared. With ``--step``, the MoE train step of each tree
(``paddle_tpu_torch.examples.moe_pretrain`` at 12 layers, batch 4 x 2048,
run from the tree's root) is timed too: parent, change, change, parent.
Prints one JSON object with every run, the medians, each call's bound and
the card's name and power limit.

    python3 tools/grouped_gemm_ab.py --parent _archive/parent [--step]

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import moe_dispatch as tmdisp  # noqa: E402
from paddle_tpu_torch.kernels import moe_fused as tmf  # noqa: E402
from paddle_tpu_torch.kernels import quant_matmul  # noqa: E402

BF16 = 1   # the kernels' dtype code of bf16
STEP_ARGS = ["--size", "16b", "--layers", "12", "--batch-size", "4",
             "--seq", "2048", "--optimizer", "adafactor", "--bf16-params",
             "--lr", "3e-5", "--adafactor-eps2", "0", "--steps", "5"]


def build_both(parent: Path):
    """{tree: library path}: this tree's library built in this process, the
    parent's in a process started from its root (each in its own tree's
    build directory, where its train-step run finds it), concurrently."""
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from paddle_tpu_torch.kernels import _build; _build.library(); "
         "print(_build.BUILD_DIR / f'libptt_kernels_{_build._digest()}.so')"],
        cwd=parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    errors = []

    def build_change():
        try:
            _build.library()
        except RuntimeError as exc:
            errors.append(str(exc))

    th = threading.Thread(target=build_change)
    th.start()
    out, _ = proc.communicate()
    th.join()
    if proc.returncode:
        errors.append(f"parent:\n{out}")
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    change = _build.BUILD_DIR / f"libptt_kernels_{_build._digest()}.so"
    return {"parent": Path(out.strip().splitlines()[-1]), "change": change}


class Lib:
    """One tree's B9/B10 entry points, called with that tree's arguments."""

    def __init__(self, path: Path, tree: Path):
        self.lib = ctypes.CDLL(str(path))
        self.lib.ptt_error_string.argtypes = [ctypes.c_int]
        self.lib.ptt_error_string.restype = ctypes.c_char_p
        wrappers = (tree / "paddle_tpu_torch" / "kernels" /
                    "moe_dispatch.py").read_text()
        self.tiled = "def tile_width" in wrappers
        # tgmm on the Hopper kernel takes the tile width too
        self.tgmm_tiled = "_DTYPES[out_dtype], tile_width(N)" in wrappers
        P, I = ctypes.c_void_p, ctypes.c_int
        extra = 1 if self.tiled else 0
        self.fns = {}
        for name, n_ptr, n_int in (("ptt_gmm", 4, 6 + extra),
                                   ("ptt_gather_gmm", 5, 6 + 2 * extra),
                                   ("ptt_tgmm", 4, 6 + self.tgmm_tiled)):
            fn = getattr(self.lib, name)
            fn.argtypes = [P] * n_ptr + [I] * n_int + [P]
            fn.restype = I
            self.fns[name] = fn

    def _call(self, name, *args):
        err = self.fns[name](*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} "
                               f"({self.lib.ptt_error_string(err).decode()})")

    def gmm(self, lhs, rhs, gs, tr):
        M, K = lhs.shape
        N = rhs.shape[1] if tr else rhs.shape[2]
        out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
        tail = [tmdisp.tile_width(N)] if self.tiled else []
        self._call("ptt_gmm", lhs.data_ptr(), rhs.data_ptr(), gs.data_ptr(),
                   out.data_ptr(), M, K, N, rhs.shape[0], int(tr), BF16,
                   *tail)
        return out

    def gather_gmm(self, x, idx, rhs, gid, tm=128):
        rows, (E, K, N) = idx.shape[0], rhs.shape
        out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
        e = [E] if self.tiled else []
        bn = [tmdisp.tile_width(N)] if self.tiled else []
        self._call("ptt_gather_gmm", x.data_ptr(), idx.data_ptr(),
                   rhs.data_ptr(), gid.data_ptr(), out.data_ptr(), rows, K,
                   N, *e, tm, BF16, int(rhs.dtype == torch.int8), *bn)
        return out

    def tgmm(self, lhs, rhs, gs):   # lhs [m, k] (lhs^T's storage), bf16 out
        (M, K), N, E = lhs.shape, rhs.shape[1], gs.shape[0]
        out = torch.empty((E, K, N), dtype=lhs.dtype, device=lhs.device)
        tail = [tmdisp.tile_width(N)] if self.tgmm_tiled else []
        self._call("ptt_tgmm", lhs.data_ptr(), rhs.data_ptr(), gs.data_ptr(),
                   out.data_ptr(), M, K, N, E, BF16, BF16, *tail)
        return out


def step_tokens_per_s(tree: Path) -> float:
    """tokens/s of the MoE example's timed steps, run from ``tree``."""
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.moe_pretrain",
         *STEP_ARGS], cwd=tree, capture_output=True, text=True, check=True)
    return float(re.search(r"([\d,.]+) tokens/s", res.stdout)
                 .group(1).replace(",", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--step", action="store_true",
                    help="also time each tree's MoE train step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grouped_gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    parent = args.parent.resolve()
    t0 = time.perf_counter()
    trees = {"parent": parent, "change": REPO}
    libs = {k: Lib(p, trees[k]) for k, p in build_both(parent).items()}
    build_s = time.perf_counter() - t0

    d = cs.deepseek_routing(tmdisp, tmf, dev)
    x, gs, tok, gid = d["x"], d["gs_pad"], d["tok_pad"], d["gid"]
    Ap, h, f = tok.shape[0], d["h"], d["f"]
    rows = int(gs.sum().item())
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 10)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    zw, dys, dgu = rnd(Ap, f), rnd(Ap, h), rnd(Ap, 2 * f)
    xs = x.index_select(0, tok)
    Wcat, Wd = d["Wcat"], d["ed"]
    Wq = quant_matmul.quantize_grouped(Wcat, 1)["q"]
    # call: (run with a library, FLOPs, bytes of inputs read once and the
    # output written once), as chip_smoke.py's phases 13 and (e) count them
    calls = {
        "gather_gmm gate|up fwd": (
            lambda L: L.gather_gmm(x, tok, Wcat, gid), 2.0 * Ap * h * 2 * f,
            2 * (x.numel() + Wcat.numel() + Ap * 2 * f)
            + 4 * (Ap + gid.numel())),
        "gather_gmm_int8 gate|up fwd": (
            lambda L: L.gather_gmm(x, tok, Wq, gid), 2.0 * Ap * h * 2 * f,
            2 * x.numel() + Wq.numel() + 2 * Ap * 2 * f
            + 4 * (Ap + gid.numel())),
        "gmm down fwd": (
            lambda L: L.gmm(zw, Wd, gs, False), 2.0 * rows * f * h,
            2 * (zw.numel() + Wd.numel() + Ap * h)),
        "gmm down dgrad": (
            lambda L: L.gmm(dys, Wd, gs, True), 2.0 * rows * h * f,
            2 * (dys.numel() + Wd.numel() + Ap * f)),
        "gmm gate|up dgrad": (
            lambda L: L.gmm(dgu, Wcat, gs, True), 2.0 * rows * 2 * f * h,
            2 * (dgu.numel() + Wcat.numel() + Ap * h)),
        "tgmm gate|up wgrad": (
            lambda L: L.tgmm(xs, dgu, gs), 2.0 * rows * h * 2 * f,
            2 * (xs.numel() + dgu.numel() + Wcat.numel())),
        "tgmm down wgrad": (
            lambda L: L.tgmm(zw, dys, gs), 2.0 * rows * f * h,
            2 * (zw.numel() + dys.numel() + Wd.numel())),
    }
    agree = {name: cs.rel_err(run(libs["change"]), run(libs["parent"]))
             for name, (run, _, _) in calls.items()}
    # each call's runs adjacent, so that the card's clocks after the other
    # calls (the change's denser ones draw more power) weigh on neither tree
    order = ("parent", "change", "change", "parent")
    runs = {name: {"parent": [], "change": []} for name in calls}
    for name, (run, _, _) in calls.items():
        for _ in range(args.rounds):
            for tree in order:
                runs[name][tree].append(cs.time_ms(
                    lambda i=0: run(libs[tree]), args.iters))
    result = {}
    for name, (_, flops, nbytes) in calls.items():
        med = {k: float(np.median(v)) for k, v in runs[name].items()}
        bound = max(flops / cs.BF16_FLOPS, nbytes / cs.HBM_BYTES_PER_S) * 1e3
        result[name] = {"runs_ms": runs[name], "median_ms": med,
                        "speedup": med["parent"] / med["change"],
                        "bound_ms": bound,
                        "bound_share": {k: bound / v for k, v in med.items()},
                        "change_vs_parent_rel_err": agree[name]}
    step = None
    if args.step:
        del d, x, gs, tok, gid, zw, dys, dgu, xs, Wcat, Wd, Wq, calls
        cs.free_memory()
        step = {"parent": [], "change": []}
        for tree in order:
            step[tree].append(step_tokens_per_s(trees[tree]))
        step = {"tokens_per_s": step, "median_tokens_per_s": {
            k: float(np.median(v)) for k, v in step.items()},
            "config": "moe_pretrain " + " ".join(STEP_ARGS)}
    print(json.dumps({
        "config": "DeepSeekMoE train step's grouped GEMMs (8192 tokens, "
                  "top-6 of 64 experts, h 2048, f 1408; padded layout, "
                  "random bf16 operands, seed 0)",
        "calls": result, "moe_step": step, "build_s": build_s,
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
