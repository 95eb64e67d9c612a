#!/usr/bin/env python3
"""B2 and B3, the flash backward, of two source trees timed side by side on
the card.

Builds the port's kernel library of this checkout and of another tree
(``--parent``: the root of another checkout, e.g. the parent commit
unpacked with ``git archive``) at the same time, then runs each tree's
bf16 backward, causal, through its C entry points ``ptt_flash_dq`` and
``ptt_flash_dkv`` at the training paths' shapes: the llama-2.6b train
step's [8, 2048, 24/8, 128], the DeepSeekMoE train step's [4, 2048,
16/16, 128] and a D=64 shape, [8, 1024, 32/8, 64]. A tree whose
wrapper ``flash_dq`` takes ``out`` computes Delta = rowsum(O * dO) inside
``ptt_flash_dq``; for an older one Delta is the torch reduction
``_delta``, timed with it. Per shape and tree: the whole backward (Delta,
B2, B3), B2 alone given Delta and B3 alone, in adjacent rounds, parent,
change, change, parent, ``--rounds`` times (CUDA events, ``--iters``
calls each), beside SDPA's backward; each tree's gradients against the
plain versions. Prints one JSON object with every run, the medians, the
bounds and the card's name and power limit.

    python3 tools/flash_bwd_ab.py --parent _archive/parent

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import ast
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
from paddle_tpu_torch.kernels import pallas_attention as tfa  # noqa: E402

BF16 = 1   # the kernels' dtype code of bf16
# (B, S, Hq, Hkv, D) of each call
SHAPES = {
    "llama-2.6b train step": (8, 2048, 24, 8, 128),
    "DeepSeekMoE train step": (4, 2048, 16, 16, 128),
    "D=64": (8, 1024, 32, 8, 64),
}
P, I = ctypes.c_void_p, ctypes.c_int


def takes_out(tree: Path) -> bool:
    """Whether the tree's ``flash_dq`` wrapper takes ``out`` (its
    ``ptt_flash_dq`` then takes the forward's output and computes Delta),
    read from the wrapper's source."""
    src = tree / "paddle_tpu_torch" / "kernels" / "pallas_attention.py"
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == "flash_dq":
            return any(a.arg == "out" for a in node.args.args
                       + node.args.kwonlyargs)
    raise RuntimeError(f"{src}: no flash_dq")


class Lib:
    """One tree's B2 and B3 entry points."""

    def __init__(self, path: Path, fused: bool):
        self.lib = ctypes.CDLL(str(path))
        self.lib.ptt_error_string.argtypes = [I]
        self.lib.ptt_error_string.restype = ctypes.c_char_p
        self.fused = fused
        self.dq_fn = self.lib.ptt_flash_dq
        self.dq_fn.argtypes = [P] * (8 if self.fused else 7) + [I] * 7 \
            + [ctypes.c_float, P]
        self.dkv_fn = self.lib.ptt_flash_dkv
        self.dkv_fn.argtypes = [P] * 8 + [I] * 7 + [ctypes.c_float, P]
        for fn in (self.dq_fn, self.dkv_fn):
            fn.restype = I

    def check(self, err, name):
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} "
                               f"({self.lib.ptt_error_string(err).decode()})")

    @staticmethod
    def _tail(q, k):
        B, S, H, D = q.shape
        return (B, S, H, k.shape[2], D, BF16, 1, 1.0 / D ** 0.5,
                torch.cuda.current_stream().cuda_stream)

    def dq(self, q, k, v, do, lse, delta, out=None):
        """B2; with ``out`` (a fused tree only) it writes Delta."""
        dq = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr()]
        if self.fused:
            ptrs.append(None if out is None else out.data_ptr())
        ptrs += [lse.data_ptr(), delta.data_ptr(), dq.data_ptr()]
        self.check(self.dq_fn(*ptrs, *self._tail(q, k)), "ptt_flash_dq")
        return dq

    def dkv(self, q, k, v, do, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self.check(self.dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), *self._tail(q, k)),
                   "ptt_flash_dkv")
        return dk, dv

    def bwd(self, q, k, v, out, lse, do):
        """The whole backward as the tree's flash_attention_bwd runs it."""
        if self.fused:
            B, S, H, _ = q.shape
            delta = torch.empty((B, H, S), dtype=torch.float32,
                                device=q.device)
            dq = self.dq(q, k, v, do, lse, delta, out)
        else:
            delta = tfa._delta(out, do)
            dq = self.dq(q, k, v, do, lse, delta)
        return (dq, *self.dkv(q, k, v, do, lse, delta))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    parent = args.parent.resolve()
    trees = {"parent": parent, "change": REPO}
    libs = {k: Lib(p, takes_out(trees[k]))
            for k, p in build_both(parent).items()}
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    order = ("parent", "change", "change", "parent")
    result = {}
    for name, (B, S, Hq, Hkv, D) in SHAPES.items():
        q, k, v, do = (torch.randn(s, generator=g, device=dev,
                                   dtype=torch.bfloat16)
                       for s in ((B, S, Hq, D), (B, S, Hkv, D),
                                 (B, S, Hkv, D), (B, S, Hq, D)))
        out, lse = tfa.flash_attention_fwd(q, k, v, True)
        delta = tfa._delta(out, do)
        want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
        got = {t: libs[t].bwd(q, k, v, out, lse, do) for t in libs}
        rel = {t: [cs.rel_err(a, b) for a, b in zip(got[t], want)]
               for t in libs}
        agree = [cs.max_err(a, b) for a, b in zip(got["change"],
                                                  got["parent"])]
        del want, got
        torch.cuda.empty_cache()
        calls = {
            "bwd": lambda L: L.bwd(q, k, v, out, lse, do),
            "flash_dq": lambda L: L.dq(q, k, v, do, lse, delta),
            "flash_dkv": lambda L: L.dkv(q, k, v, do, lse, delta)}
        runs = {c: {"parent": [], "change": []} for c in calls}
        for _ in range(args.rounds):
            for c, fn in calls.items():
                for tree in order:
                    runs[c][tree].append(cs.time_ms(
                        lambda i=0, L=libs[tree], f=fn: f(L), args.iters))
        sdpa, note = cs.sdpa_backward(q, k, v, do)
        sdpa_ms = cs.time_ms(sdpa, args.iters)
        del sdpa
        pairs = B * Hq * S * S / 2.0            # causal (query, key) pairs
        # the backward as a function does 5 products (S, dP, dV, dK, dQ);
        # B2 does 3 and B3 4, recomputing S and dP each
        bound = {c: n * 2.0 * pairs * D / cs.BF16_FLOPS * 1e3
                 for c, n in (("bwd", 5), ("flash_dq", 3),
                              ("flash_dkv", 4))}
        med = {c: {t: float(np.median(r)) for t, r in tr.items()}
               for c, tr in runs.items()}
        result[name] = {
            "shape": [B, S, Hq, Hkv, D], "runs_ms": runs, "median_ms": med,
            "speedup": {c: m["parent"] / m["change"] for c, m in med.items()},
            "bound_ms": bound,
            "bound_share": {c: {t: bound[c] / x for t, x in m.items()}
                            for c, m in med.items()},
            "sdpa_bwd_ms": sdpa_ms, "sdpa": note,
            "rel_err_vs_plain": rel,
            "change_vs_parent_max_abs_err": agree,
            "fused_delta": {t: L.fused for t, L in libs.items()}}
        print(json.dumps({name: {k: result[name][k] for k in (
            "median_ms", "sdpa_bwd_ms", "rel_err_vs_plain")}}), flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps({
        "config": "B2+B3 bf16, causal, random q/k/v/dout (seed 6); bounds: "
                  "operations over 989 TFLOP/s",
        "calls": result, "build_s": build_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
