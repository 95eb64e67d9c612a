#!/usr/bin/env python3
"""B5 of two source trees timed side by side on the card.

Builds the port's kernel library from this checkout's
``paddle_tpu_torch/kernels/csrc`` and from another tree's (``--parent``:
the root of another checkout, e.g. the parent commit unpacked with
``git archive``) at the same time, then times ``mega_decode_step`` — one
decode step of Llama-3-8B at full width and depth (random bf16 weights,
seed 0) at the serving mix's walk lengths — with each library in turn,
parent, change, change, parent, ``--rounds`` times (CUDA events, ``--iters``
launches each). ``--int8`` times the int8 form too: the weights through
``llama.quantize_params`` and int8 pools with f32 scales. ``--multi``
times the multi-step form too, in the same turns, at ``chip_smoke.py``
(s1)'s shapes: one k = 4 wave of ``mega_decode_loop`` at 4 slots with the
serving mix's first four walk lengths, for Llama-3-8B widened to f32 and
for the Llama-3.2-1B-shaped draft (tied head, random bf16 weights, seed
1) with its bf16 weights, with its weights through
``llama.quantize_params`` and widened to f32 (each run the mean of
``--iters`` waves on fresh rings, as (s1) times it). Prints one JSON
object for each form and slot count with every run, the medians and the
card's name and power limit.

    python3 tools/mega_decode_ab.py --parent _archive/parent [--slots 4 8]
        [--int8] [--multi]

Both trees' kernels take the same C arguments; the scratch is sized for
either design (``roomy_buffers``).

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import dataclasses
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


def roomy_buffers(buffers):
    """The wrapper's scratch, large enough for this tree's kernel and for
    a parent whose split sums are [8, N, widest] floats and whose
    counters are one a 32-column tile or walk."""
    def bufs(config, x0, *args):
        out = list(buffers(config, x0, *args))
        c, N = config, x0.shape[0]
        widest = max((c.num_heads + 2 * c.num_kv_heads) * c.head_dim,
                     2 * c.intermediate_size, c.hidden_size)
        part = max(out[4].numel(), 8 * N * widest)
        count = max(out[5].numel(), widest // 32 + N * c.num_kv_heads)
        out[4] = torch.empty(part, dtype=torch.float32, device=x0.device)
        out[5] = torch.zeros(count, dtype=torch.int32, device=x0.device)
        return tuple(out)
    return bufs


def time_form(libs, cfg, params, dev, slots, iters, rounds, int8):
    """Parent and change in turns at ``slots`` rows: the runs' ms."""
    walk = [len(p) + 24 for p in cs.serving_mix(cfg, slots)]
    kw, toks = cs.mega_inputs(cfg, dev, walk)
    if int8:
        qk, qv, ks, vs = cs.int8_pools(kw.pop("k_pool"), kw.pop("v_pool"))
        kw.update(k_pool=qk, v_pool=qv, ks_pool=ks, vs_pool=vs)
    x0 = params["embed"][toks].to(cfg.dtype)
    runs = {"parent": [], "change": []}
    for _ in range(rounds):
        for name in ("parent", "change", "change", "parent"):
            use(libs[name])
            runs[name].append(cs.time_ms(
                lambda i=0: tmd.mega_decode_step(params, cfg, x0=x0, **kw),
                iters))
    return walk, kw["t"], runs


def time_multi(libs, cfg, params, dev, walk, iters, rounds):
    """Parent and change in turns on one k = 4 draft wave: the runs' ms."""
    kw = cs.loop_inputs(cfg, dev, walk)
    runs = {"parent": [], "change": []}
    for _ in range(rounds):
        for name in ("parent", "change", "change", "parent"):
            use(libs[name])
            runs[name].append(cs.time_ms(
                lambda i=0: cs.run_loop(tmd.mega_decode_loop, params, cfg,
                                        kw), iters))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--slots", type=int, nargs="+", default=[4])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--int8", action="store_true",
                    help="also int8 weights and int8 pools")
    ap.add_argument("--multi", action="store_true",
                    help="also the multi-step form: k=4 waves of "
                         "Llama-3-8B in f32 and of the 1B-shaped draft in "
                         "bf16, int8 weights and f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    t0 = time.perf_counter()
    libs = build_both(args.parent.resolve())
    build_s = time.perf_counter() - t0
    tmd._buffers = roomy_buffers(tmd._buffers)
    cfg, params = cs.llama3_8b_bf16(llama, dev)
    forms = [("bf16 weights and pools", False)]
    if args.int8:
        forms.append(("int8 weights and int8 pools", True))
    for label, int8 in forms:
        tree = llama.quantize_params(params) if int8 else params
        for slots in args.slots:
            walk, t, runs = time_form(libs, cfg, tree, dev, slots,
                                      args.iters, args.rounds, int8)
            print(json.dumps({
                "config": "Llama-3-8B (random weights, seed 0), one step "
                          f"of mega_decode_step, {label}",
                "slots": slots, "walk": walk, "t": t, "runs_ms": runs,
                "median_ms": {k: float(np.median(v))
                              for k, v in runs.items()},
                "build_s": build_s, "card": card}), flush=True)
        del tree
        cs.free_memory()
    if args.multi:
        walk = [len(p) + 24 for p in cs.serving_mix(cfg, 4)]
        dcfg, dparams = cs.llama32_1b_draft(llama, cfg, dev)
        forms = [
            ("Llama-3-8B (random weights, seed 0) widened to f32, dense "
             "head", dataclasses.replace(cfg, dtype=torch.float32),
             lambda: cs.widen_params(params)),
            ("Llama-3.2-1B-shaped draft of Llama-3-8B (random weights, "
             "seed 1, tied head), bf16 weights", dcfg, lambda: dparams),
            ("the same draft, int8 weights", dcfg,
             lambda: llama.quantize_params(dparams)),
            ("the same draft widened to f32",
             dataclasses.replace(dcfg, dtype=torch.float32),
             lambda: cs.widen_params(dparams))]
        for i, (label, c, make) in enumerate(forms):
            runs = time_multi(libs, c, make(), dev, walk, args.iters,
                              args.rounds)
            if i == 0:
                del params
            cs.free_memory()
            print(json.dumps({
                "config": f"{label}: one k=4 wave of mega_decode_loop",
                "slots": len(walk), "walk": walk, "runs_ms": runs,
                "median_ms": {k: float(np.median(v))
                              for k, v in runs.items()},
                "build_s": build_s, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
