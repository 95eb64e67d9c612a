#!/usr/bin/env python3
"""B4 (the ragged paged-decode kernel) of two source trees timed side by
side on the card.

Builds B4's unit (``ragged_decode.cu`` with the headers and
``errors.cu``) from this checkout's ``paddle_tpu_torch/kernels/csrc`` and
from another tree's (``--parent``: the root of another checkout, e.g. the
parent commit unpacked with ``git archive``), all builds at once, then
times each tree's kernel in the order parent, change, change, parent,
``--rounds`` times, for three forms (bf16 queries and pools; bf16
queries over int8 pools with f32 scales; f32 queries and pools) at four
shapes of Llama-3-8B's decode attention (Hq=32, Hkv=8, D=128, 64-position
pool blocks, a 2048-position table):

- ``phase4``: ``chip_smoke.py`` phase 4's decode lengths (the serving
  mix's first eight prompts plus 32);
- ``n1x2000``: one slot of 2000 positions;
- ``n8x2000``: eight slots of 2000;
- ``short64``: 64 slots of 1-128 positions (numpy seed 5).

Each run records the kernel alone (torch.profiler's device time of the
kernels named ``ragged_decode``) and the CUDA-event mean over
back-to-back calls of the tree's C entry point (its host cost included),
one launch a layer over 32 pool layers in turn, so each call finds its
layer cold in L2. Each tree's C entry point is called with that tree's
own arguments: a tree that exports ``ptt_ragged_decode_grid`` takes one
output buffer, the split walk's scratch and its flags.

``--probe parent|change`` also builds two knocked-out copies of that
tree's kernel (a compile-time switch in the tool's own build; the
shipped sources are unchanged): ``copies`` (the copies run, the scoring
does not) and ``scoring`` (the scoring runs on tiles that are never
copied), timed in the same turns. In a tree whose ``ragged_split.cuh``
(or, before it, ``ragged_decode.cu``) carries the switches they knock
out its bf16-query kernel only (its f32-query forms walk with
``ragged_walk.cuh``, which the copies leave as it is); in the older
design they knock out ``ragged_walk.cuh``. ``--wrapper`` times the host cost of
this checkout's ``paged_attention.ragged_decode_partial`` (a host clock
over ``--host-calls`` calls with no synchronize between them).

Prints one JSON line a form and shape (medians and every run) and one
for the wrapper, each with the card's name and power limit.

    python3 tools/ragged_decode_ab.py --parent _archive/parent
        [--probe change] [--wrapper] [--shapes phase4 n1x2000]

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import ctypes
import json
import math
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
FORMS = ("bf16", "int8", "f32")

# knock-outs of a tree's kernel: (text, replacement) in the file of the
# tree that carries the switches (ragged_split.cuh, or ragged_decode.cu
# before the split walk moved into that header), else in the walk of
# ragged_walk.cuh (the parent design)
PROBES = {
    "copies": ("kScore = true;", "kScore = false;"),
    "scoring": ("kCopy = true;", "kCopy = false;"),
}
PROBES_WALK = {
    "copies": [("ragged_walk.cuh", "if (warp < G) {", "if (false) {")],
    "scoring": [("ragged_walk.cuh", "const bool live = p < end;",
                 "const bool live = false;")],
}


def shapes():
    rng = np.random.default_rng(0)
    phase4 = (rng.integers(64, 1001, size=16)[:8] + 32).tolist()
    short = np.random.default_rng(5).integers(1, 129, size=64).tolist()
    return {"phase4": phase4, "n1x2000": [2000], "n8x2000": [2000] * 8,
            "short64": short}


def unit_dir(tree: Path, tmp: Path, name: str, patches=()):
    """B4's unit of ``tree`` copied into ``tmp/name`` with ``patches``."""
    src = tree / "paddle_tpu_torch" / "kernels" / "csrc"
    d = tmp / name
    d.mkdir()
    for f in list(src.glob("*.cuh")) + [src / "ragged_decode.cu",
                                         src / "errors.cu"]:
        shutil.copy(f, d / f.name)
    for fname, old, new in patches:
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} has no {old!r}")
        (d / fname).write_text(text.replace(old, new))
    return d


def build(dirs):
    """One library a directory, all nvcc processes at once."""
    procs = {}
    for name, d in dirs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / "ragged_decode.cu"),
               str(d / "errors.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
    return {name: ctypes.CDLL(str(d / "lib.so")) for name, d in dirs.items()}


def probe_patches(tree: Path, kind: str):
    src = tree / "paddle_tpu_torch/kernels/csrc"
    for name in ("ragged_split.cuh", "ragged_decode.cu"):
        f = src / name
        if f.exists() and "kCopy = true;" in f.read_text():
            return [(name, *PROBES[kind])]
    return PROBES_WALK[kind]


def inputs(lengths, form, dev, seed):
    """q, pools (and scales), table and lengths for ``lengths``: each slot
    its own random blocks of a pool just large enough, over LAYERS
    layers."""
    N = len(lengths)
    need = [math.ceil(n / BS) for n in lengths]
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
    kp = torch.randn(LAYERS, nb, BS, HKV, D, generator=g, device=dev,
                     dtype=dt)
    vp = torch.randn(LAYERS, nb, BS, HKV, D, generator=g, device=dev,
                     dtype=dt)
    ks = vs = None
    if form == "int8":
        kp, vp, ks, vs = cs.int8_pools(kp, vp)
    q = torch.randn(N, HKV * G, D, generator=g, device=dev, dtype=dt)
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs,
                table=torch.as_tensor(table, device=dev),
                lens=torch.tensor(lengths, dtype=torch.int32, device=dev),
                nb=nb, tokens=int(sum(lengths)))


class Tree:
    """One library's C entry point, called with its own arguments."""

    def __init__(self, lib):
        self.lib = lib
        self.split = hasattr(lib, "ptt_ragged_decode_grid")
        fn = lib.ptt_ragged_decode
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fn = fn
        if self.split:
            lib.ptt_ragged_decode_grid.argtypes = [ctypes.c_int] * 3
            lib.ptt_ragged_decode_grid.restype = ctypes.c_int

    def call(self, x):
        """A closure launching the kernel on layer ``i % LAYERS``, and the
        buffers it writes."""
        q, kp, vp = x["q"], x["kp"], x["vp"]
        N = q.shape[0]
        dtype = 0 if q.dtype == torch.float32 else 1
        pool = 2 if x["ks"] is not None else dtype
        dev = q.device
        if self.split:
            grid = self.lib.ptt_ragged_decode_grid(dtype, pool, D)
            out = torch.empty(N * HKV * G * (D + 2), device=dev)
            scratch = torch.empty(2 * grid * G * (D + 2), device=dev)
            flags = torch.zeros(N * HKV, dtype=torch.int32, device=dev)
            bufs = (out.data_ptr(), scratch.data_ptr(), flags.data_ptr())
            keep = (out, scratch, flags)
        else:
            acc = torch.empty(N * HKV * G * D, device=dev)
            ml = torch.empty(2 * N * HKV * G, device=dev)
            bufs = (acc.data_ptr(), ml.data_ptr(),
                    ml.data_ptr() + N * HKV * G * 4)
            keep = (acc, ml)
        ptrs = [t.data_ptr() if t is not None else None
                for t in (q, kp, vp, x["ks"], x["vs"], x["table"],
                          x["lens"])]
        nb = kp.shape[1]
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn, scale = self.fn, 1.0 / math.sqrt(D)

        def run(i=0):
            err = fn(*ptrs, *bufs, N, i % LAYERS, nb, BS, HKV, G, D, MB,
                     dtype, pool, scale, stream)
            if err:
                raise RuntimeError(f"ptt_ragged_decode: CUDA error {err}")
        return run, keep

    def result(self, x):
        """(acc, m, l) of one call on layer 0."""
        run, keep = self.call(x)
        run(0)
        torch.cuda.synchronize()
        N = x["q"].shape[0]
        if self.split:
            out = keep[0]
            a = N * HKV * G
            return (out[:a * D].view(N, HKV, G, D),
                    out[a * D:a * D + a].view(N, HKV, G),
                    out[a * D + a:].view(N, HKV, G))
        acc, ml = keep
        a = N * HKV * G
        return (acc.view(N, HKV, G, D), ml[:a].view(N, HKV, G),
                ml[a:].view(N, HKV, G))


def check(tree, x, name):
    """A tree's result at this shape against the plain version (layer 0)."""
    got = tree.result(x)
    want = tpa.ragged_decode_partial_plain(
        x["q"], x["kp"], x["vp"], x["table"], x["lens"], 0, x["ks"],
        x["vs"])
    live = x["lens"] > 0
    out = got[0][live] / got[2][live][..., None]
    ref = want[0][live] / want[2][live][..., None]
    err = cs.max_err(out, ref) / ref.abs().max().item()
    tol = 1e-2 if x["q"].dtype == torch.bfloat16 and x["ks"] is None \
        else 1e-4
    if err > tol:
        raise AssertionError(f"{name} disagrees with the plain version: "
                             f"{err} > {tol}")
    return err


def bound_ms(x):
    tokens, N = x["tokens"], x["q"].shape[0]
    item = x["kp"].element_size()
    row = D * item + (4 if x["ks"] is not None else 0)
    nbytes = 2 * tokens * HKV * row + x["q"].numel() * x["q"].element_size() \
        + N * HKV * G * (D + 2) * 4 + x["table"].numel() * 4 + N * 4
    return nbytes / cs.HBM_BYTES_PER_S * 1e3


def host_us(x, calls):
    """Host microseconds a call of this checkout's wrapper costs (no
    synchronize between calls), after a warm-up call."""
    kw = dict(ks_pool=x["ks"], vs_pool=x["vs"])
    tpa.ragged_decode_partial(x["q"], x["kp"], x["vp"], x["table"],
                              x["lens"], layer=0, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        tpa.ragged_decode_partial(x["q"], x["kp"], x["vp"], x["table"],
                                  x["lens"], layer=i % LAYERS, **kw)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--shapes", nargs="+", default=list(shapes()))
    ap.add_argument("--forms", nargs="+", default=list(FORMS))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--probe", choices=["parent", "change"])
    ap.add_argument("--wrapper", action="store_true")
    ap.add_argument("--host-calls", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ragged_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    trees = {"parent": args.parent.resolve(), "change": REPO}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        dirs = {name: unit_dir(t, tmp, name) for name, t in trees.items()}
        if args.probe:
            for kind in ("copies", "scoring"):
                tree = trees[args.probe]
                dirs[f"{args.probe}_{kind}"] = unit_dir(
                    tree, tmp, f"{args.probe}_{kind}",
                    probe_patches(tree, kind))
        t0 = time.perf_counter()
        libs = {name: Tree(lib) for name, lib in build(dirs).items()}
        build_s = time.perf_counter() - t0
        lens_of = shapes()
        for shape in args.shapes:
            for form in args.forms:
                x = inputs(lens_of[shape], form, dev, seed=len(shape))
                errs = {name: check(libs[name], x, name)
                        for name in ("parent", "change")}
                runs = {name: {"kernel_ms": [], "events_ms": []}
                        for name in libs}
                calls = {name: tree.call(x)[0] for name, tree in libs.items()}
                order = ["parent", "change", "change", "parent"]
                if args.probe:
                    order += [n for n in libs if n.startswith(args.probe + "_")]
                for _ in range(args.rounds):
                    for name in order:
                        run = calls[name]
                        runs[name]["kernel_ms"].append(cs.kernel_device_ms(
                            run, 2 * LAYERS, "ragged_decode"))
                        runs[name]["events_ms"].append(
                            cs.time_ms(run, 4 * LAYERS))
                # a profiler window now and then records no kernel (None)
                med = {name: {k: float(np.median([x for x in v
                                                  if x is not None]))
                              for k, v in r.items()}
                       for name, r in runs.items()}
                rec = {"form": form, "shape": shape,
                       "lengths": lens_of[shape], "tokens": x["tokens"],
                       "bound_ms": bound_ms(x), "median": med,
                       "runs": runs, "max_rel_err": errs,
                       "build_s": build_s, "card": card}
                if args.wrapper:
                    rec["wrapper_host_us"] = host_us(x, args.host_calls)
                print(json.dumps(rec), flush=True)
                del x, calls
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
