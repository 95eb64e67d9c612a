#!/usr/bin/env python3
"""B6 (paged decode attention) and B8 (the block append) of two source
trees timed side by side on the card.

Builds the paged-cache unit (``paged_decode.cu``, ``paged_cache.cu``,
``errors.cu`` and the headers) from this checkout's
``paddle_tpu_torch/kernels/csrc`` and from another tree's (``--parent``:
the root of another checkout, e.g. the parent commit unpacked with ``git
archive``), both at once, then times each tree's kernels in the order
parent, change, change, parent, ``--rounds`` times:

- B6 in bf16 and f32 at Llama-3-8B's heads (Hq=32, Hkv=8, D=128,
  64-position pool blocks, a 2048-position table) and four shapes:
  ``s4`` (``chip_smoke.py`` (s4)'s lengths 0, 1, 64, 2000, 777, 128,
  1500, 33), ``n1x2000``, ``n8x2000`` and ``short64`` (64 slots of 1-128
  positions, numpy seed 5); one call a pool layer over 32 layers in turn,
  so each call finds its layer cold in L2;
- B8 writing 32 blocks of [64, 8, 128] bf16 (one 2048-token prefill) into
  [4, 512, 64, 8, 128] pools: ``warm`` (the same source blocks and
  destination every call, so L2 holds them) and ``cold`` (eight source
  sets and destinations in turn, 134 MB a cycle against the 50 MB L2).

Each run records the kernels alone (torch.profiler: the union of the
call's kernel intervals, and their sum, which counts twice what two
overlapping kernels share) and the CUDA-event mean over back-to-back calls
of the tree's C entry point (its host cost included). Each tree's entry
point is called with its own arguments: a ``paged_decode.cu`` that takes
``wmax`` takes the split walk's scratch and flags. Each result is checked
against the plain version first (B6 per slot within 2e-2 bf16 / 1e-5 f32
of the slot's largest magnitude; B8 bit-equal). ``--wrapper`` also times
the host cost of this checkout's ``paged_decode_attention``,
``paged_append_blocks`` and ``paged_append_token`` (a host clock over
``--host-calls`` calls with no synchronize between them: few enough that
the launch queue does not fill and hold the host to the device's pace),
once before the process first runs the profiler and once after it (a
process that has run the profiler pays more host time a launch).
``--variant NAME=TREE`` adds more trees (e.g. a copy of this checkout
with one change) to the same turns.

Prints one JSON line a form and shape (medians and every run), each with
the card's name and power limit.

    python3 tools/paged_decode_ab.py --parent _archive/parent [--wrapper]
        [--shapes s4 n1x2000] [--forms bf16] [--b8 warm cold]
        [--variant nopdl=_archive/nopdl]

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

HKV, G, D, BS, MB, LAYERS = 8, 4, 128, 64, 2048 // 64, 32
UNIT = ("paged_decode.cu", "paged_cache.cu", "errors.cu")


def shapes():
    short = np.random.default_rng(5).integers(1, 129, size=64).tolist()
    return {"s4": [0, 1, 64, 2000, 777, 128, 1500, 33], "n1x2000": [2000],
            "n8x2000": [2000] * 8, "short64": short}


def unit_dir(tree: Path, tmp: Path, name: str) -> Path:
    """The paged-cache unit of ``tree`` copied into ``tmp/name``."""
    src = tree / "paddle_tpu_torch" / "kernels" / "csrc"
    d = tmp / name
    d.mkdir()
    for f in list(src.glob("*.cuh")) + [src / u for u in UNIT]:
        shutil.copy(f, d / f.name)
    return d


def build(dirs):
    """One library a directory, all nvcc processes at once."""
    procs = {}
    for name, d in dirs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), *(str(d / u) for u in UNIT)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
    return {name: ctypes.CDLL(str(d / "lib.so")) for name, d in dirs.items()}


def kernel_ms(run, iters, key):
    """(union, sum, by kernel name) of the device intervals of the kernels
    whose name holds ``key``, in ms a call, over ``iters`` calls after a
    warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            run(i)
        torch.cuda.synchronize()
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and key in e.name]
    if not events:
        return None, None, {}
    spans = sorted((a, b) for a, b, _n in events)
    union, end = 0, spans[0][0]
    for a, b in spans:
        union += max(0, b - max(a, end))
        end = max(end, b)
    total = sum(b - a for a, b in spans)
    names = {}
    for a, b, n in events:
        short = re.search(r"\w*(paged_decode|append_blocks)\w*", n).group(0)
        names[short] = names.get(short, 0) + (b - a) / 1e3 / iters
    return union / 1e3 / iters, total / 1e3 / iters, names


def decode_inputs(lengths, form, dev, seed):
    """q, pools, table and lengths for ``lengths``: each slot its own
    random blocks of a pool just large enough, over LAYERS layers."""
    N = len(lengths)
    need = [max(1, math.ceil(n / BS)) for n in lengths]
    nb = sum(need) + 1
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, nb))
    table = np.zeros((N, MB), np.int32)
    at = 0
    for i, k in enumerate(need):
        table[i, :k] = ids[at:at + k]
        at += k
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.float32 if form == "f32" else torch.bfloat16
    kp, vp = (torch.randn(LAYERS, nb, BS, HKV, D, generator=g, device=dev,
                          dtype=dt) for _ in range(2))
    q = torch.randn(N, HKV * G, D, generator=g, device=dev, dtype=dt)
    return dict(q=q, kp=kp, vp=vp, table=torch.as_tensor(table, device=dev),
                lens=torch.tensor(lengths, dtype=torch.int32, device=dev),
                tokens=int(sum(lengths)))


class Tree:
    """One library's C entry points, called with its own arguments."""

    def __init__(self, lib, tree: Path):
        self.lib = lib
        text = (tree / "paddle_tpu_torch/kernels/csrc/paged_decode.cu") \
            .read_text()
        self.split = "wmax" in text
        n_ptr = 9 if self.split else 6
        fn = lib.ptt_paged_decode_attention
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.decode = fn
        fn = lib.ptt_paged_append_blocks
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.append = fn

    def decode_call(self, x):
        """A closure running B6 on layer ``i % LAYERS``, and its output."""
        q, kp, vp = x["q"], x["kp"], x["vp"]
        N = q.shape[0]
        dev = q.device
        out = torch.empty_like(q)
        keep = [out]
        ptrs = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                x["table"].data_ptr(), x["lens"].data_ptr(), out.data_ptr()]
        if self.split:
            parts = tpa._PARTS_FLOATS
            scratch = torch.empty(parts + N * HKV * 8, device=dev)
            flags = torch.zeros(N * HKV, dtype=torch.int32, device=dev)
            keep += [scratch, flags]
            ptrs += [scratch.data_ptr(), scratch.data_ptr() + 4 * parts,
                     flags.data_ptr()]
        nb = kp.shape[1]
        dtype = 0 if q.dtype == torch.float32 else 1
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = self.decode

        def run(i=0):
            err = fn(*ptrs, N, i % LAYERS, nb, BS, HKV, G, D, MB, dtype,
                     stream)
            if err:
                raise RuntimeError(f"ptt_paged_decode_attention: CUDA error "
                                   f"{err}")
        return run, keep

    def append_call(self, sets):
        """A closure running B8 with source set and destination
        ``i % len(sets)``."""
        stream = torch.cuda.current_stream().cuda_stream
        fn = self.append

        def run(i=0):
            kp, vp, kb, vb, ids, layer = sets[i % len(sets)]
            err = fn(kb.data_ptr(), vb.data_ptr(), kp.data_ptr(),
                     vp.data_ptr(), ids.data_ptr(), kb.shape[0], layer,
                     kp.shape[1], kb[0].numel() * kb.element_size(), stream)
            if err:
                raise RuntimeError(f"ptt_paged_append_blocks: CUDA error "
                                   f"{err}")
        return run


def check_decode(tree, x, name):
    """A tree's B6 result on layer 0 against the plain version: the largest
    per-slot error over the slot's largest magnitude."""
    run, keep = tree.decode_call(x)
    run(0)
    torch.cuda.synchronize()
    out = keep[0]
    cache = tpa.PagedKVCache(x["kp"], x["vp"], x["table"], x["lens"])
    ref = tpa.paged_decode_attention_plain(x["q"], cache, 0)
    live = x["lens"] > 0
    if not bool((out[~live] == 0).all()):
        raise AssertionError(f"{name}: a zero-length slot is not 0")
    err = ((out.float() - ref.float()).abs().flatten(1).amax(1)[live]
           / ref.float().abs().flatten(1).amax(1)[live]).max().item()
    tol = 2e-2 if x["q"].dtype == torch.bfloat16 else 1e-5
    if err > tol:
        raise AssertionError(f"{name} disagrees with the plain version: "
                             f"{err} > {tol}")
    return err


def decode_bound_ms(x):
    q, N = x["q"], x["q"].shape[0]
    item = q.element_size()
    nbytes = 2 * x["tokens"] * HKV * D * item + 2 * q.numel() * item \
        + N * MB * 4 + N * 4
    return nbytes / cs.HBM_BYTES_PER_S * 1e3


def append_sets(dev, cold, seed=7):
    """B8's (pools, source blocks, ids, layer) sets: one for ``warm``; for
    ``cold`` eight, each its own source blocks and destination blocks and
    layers, 134 MB of traffic a cycle."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    kp, vp = (torch.zeros(4, 512, BS, HKV, D, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    sets = []
    for i in range(8 if cold else 1):
        kb, vb = (torch.randn(MB, BS, HKV, D, generator=g, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        ids = torch.as_tensor(rng.permutation(np.arange(1, 512))[:MB]
                              .astype(np.int32), device=dev)
        sets.append((kp, vp, kb, vb, ids, i % 4))
    return sets


def check_append(tree, sets, name):
    """A tree's B8 writes equal the plain version's, bit for bit."""
    kp, vp = sets[0][0], sets[0][1]
    want = [kp.clone(), vp.clone()]
    run = tree.append_call(sets)
    for i, (_kp, _vp, kb, vb, ids, layer) in enumerate(sets):
        run(i)
        tpa.paged_append_blocks_plain(*want, kb, vb, ids, layer)
    torch.cuda.synchronize()
    if not (torch.equal(kp, want[0]) and torch.equal(vp, want[1])):
        raise AssertionError(f"{name}: B8 differs from the plain version")


def host_us(fn, calls):
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def wrapper_host_us(dev, calls, tree):
    """Host microseconds a call of this checkout's B6 (bf16, the ``s4``
    shape), B8 (the ``warm`` set) and B7 (8 rows of [8, 128] bf16)
    wrappers costs, and B6's and B8's C entry points alone (``tree``,
    this checkout's paged unit, called with prepared arguments)."""
    x = decode_inputs(shapes()["s4"], "bf16", dev, seed=2)
    cache = tpa.PagedKVCache(x["kp"], x["vp"], x["table"], x["lens"])
    kp, vp, kb, vb, ids, _layer = append_sets(dev, False)[0]
    k_new, v_new = (torch.randn(8, HKV, D, device=dev, dtype=torch.bfloat16)
                    for _ in range(2))
    blk = torch.arange(1, 9, dtype=torch.int32, device=dev)
    off = torch.zeros(8, dtype=torch.int32, device=dev)
    sets = [(kp, vp, kb, vb, ids, 2)]
    return {
        "c_entry_paged_decode_attention": host_us(tree.decode_call(x)[0],
                                                  calls),
        "c_entry_paged_append_blocks": host_us(tree.append_call(sets),
                                               calls),
        "paged_decode_attention": host_us(
            lambda i: tpa.paged_decode_attention(x["q"], cache,
                                                 layer=i % LAYERS), calls),
        "paged_append_blocks": host_us(
            lambda i: tpa.paged_append_blocks(kp, vp, kb, vb, ids, layer=2),
            calls),
        "paged_append_token": host_us(
            lambda i: tpa.paged_append_token(kp, vp, k_new, v_new, blk, off,
                                             layer=1), calls)}


def rounds(calls, n_rounds, key, iters):
    """Each tree's times in turns (parent, change, the variants, change,
    parent), ``n_rounds`` times; their medians and every run."""
    order = ["parent", "change"] + [n for n in calls
                                    if n not in ("parent", "change")]
    order += ["change", "parent"]
    runs = {name: {"kernel_ms": [], "kernel_sum_ms": [], "events_ms": [],
                   "by_kernel": []}
            for name in calls}
    for _ in range(n_rounds):
        for name in order:
            union, total, names = kernel_ms(calls[name], iters, key)
            runs[name]["kernel_ms"].append(union)
            runs[name]["kernel_sum_ms"].append(total)
            runs[name]["by_kernel"].append(names)
            runs[name]["events_ms"].append(cs.time_ms(calls[name], 2 * iters))
    med = {name: {k: float(np.median([v for v in vals if v is not None]))
                  for k, vals in r.items() if k != "by_kernel"}
           for name, r in runs.items()}
    return med, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--variant", nargs="*", default=[],
                    metavar="NAME=TREE",
                    help="more trees timed in the same turns (a checkout "
                         "root, e.g. a copy of this one with a patch)")
    ap.add_argument("--shapes", nargs="*", default=list(shapes()))
    ap.add_argument("--forms", nargs="*", default=["bf16", "f32"])
    ap.add_argument("--b8", nargs="*", default=["warm", "cold"])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--wrapper", action="store_true")
    ap.add_argument("--host-calls", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    trees = {"parent": args.parent.resolve(), "change": REPO}
    for spec in args.variant:
        name, tree = spec.split("=", 1)
        trees[name] = Path(tree).resolve()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        dirs = {name: unit_dir(t, tmp, name) for name, t in trees.items()}
        t0 = time.perf_counter()
        libs = {name: Tree(lib, trees[name])
                for name, lib in build(dirs).items()}
        build_s = time.perf_counter() - t0
        lens_of = shapes()
        if args.wrapper:
            before = wrapper_host_us(dev, args.host_calls, libs["change"])
        for shape in args.shapes:
            for form in args.forms:
                x = decode_inputs(lens_of[shape], form, dev, seed=len(shape))
                errs = {name: check_decode(libs[name], x, name)
                        for name in libs}
                calls = {name: tree.decode_call(x)[0]
                         for name, tree in libs.items()}
                med, runs = rounds(calls, args.rounds, "paged_decode",
                                   2 * LAYERS)
                rec = {"kernel": "B6", "form": form, "shape": shape,
                       "tokens": x["tokens"], "bound_ms": decode_bound_ms(x),
                       "median": med, "runs": runs, "max_rel_err": errs,
                       "build_s": build_s, "card": card}
                print(json.dumps(rec), flush=True)
                del x, calls
                torch.cuda.empty_cache()
        for temp in args.b8:
            sets = append_sets(dev, temp == "cold")
            for name in libs:
                check_append(libs[name], sets, name)
            calls = {name: tree.append_call(sets)
                     for name, tree in libs.items()}
            med, runs = rounds(calls, args.rounds, "append_blocks", 48)
            kb = sets[0][2]
            nbytes = 2 * 2 * kb.numel() * kb.element_size() + MB * 4
            rec = {"kernel": "B8", "temperature": temp,
                   "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                   "median": med, "runs": runs, "build_s": build_s,
                   "card": card}
            print(json.dumps(rec), flush=True)
            del sets, calls
            torch.cuda.empty_cache()
        if args.wrapper:
            print(json.dumps({
                "kernel": "wrappers", "host_calls": args.host_calls,
                "host_us_before_profiler": before,
                "host_us_after_profiler": wrapper_host_us(
                    dev, args.host_calls, libs["change"]),
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
