#!/usr/bin/env python3
"""B6 (paged decode attention), B7 (the token append) and B8 (the block
append) of two source trees timed side by side on the card.

Builds the paged-cache unit (``paged_decode.cu``, ``paged_cache.cu``,
``errors.cu`` and the headers) from this checkout's
``paddle_tpu_torch/kernels/csrc`` and from another tree's (``--parent``:
the root of another checkout, e.g. the parent commit unpacked with ``git
archive``), both at once, with an empty kernel of its own, then times
each tree's kernels in the order parent, change, change, parent,
``--rounds`` times:

- B6 in bf16 and f32 at Llama-3-8B's heads (Hq=32, Hkv=8, D=128,
  64-position pool blocks, a 2048-position table) and four shapes:
  ``s4`` (``chip_smoke.py`` (s4)'s lengths 0, 1, 64, 2000, 777, 128,
  1500, 33), ``n1x2000``, ``n8x2000`` and ``short64`` (64 slots of 1-128
  positions, numpy seed 5); one call a pool layer over 32 layers in turn,
  so each call finds its layer cold in L2;
- B7 (``--b7``) appending rows of [Hkv=8, D=128] bf16 into [4, 512, 64,
  8, 128] pools: ``s4`` (8 rows at (s4)'s lengths), ``n64`` and ``n256``
  (64 and 256 rows on distinct random blocks), ``f32`` (``s4`` in f32)
  and ``d64`` (``s4`` at D=64);
- B8 writing 32 blocks of [64, 8, 128] bf16 (one 2048-token prefill) into
  [4, 512, 64, 8, 128] pools: ``warm`` (the same source blocks and
  destination every call, so L2 holds them) and ``cold`` (eight source
  sets and destinations in turn, 134 MB a cycle against the 50 MB L2);
- the chain (``--chain``): the paged-cache API's decode sequence over 32
  pool layers of [32, 512, 64, 8, 128] bf16 (4.3 GB of K and V, so each
  layer is cold in L2), a layer being B7 appending 8 rows at (s4)'s
  lengths and then B6 attending at lengths + 1; a spin kernel
  (``torch.cuda._sleep``) ahead of the 32 layers lets the host enqueue
  every launch before the card reaches them. Each run records the device
  span a layer: from the spin kernel's end to the last B6 kernel's end,
  over 32 (the profiler; ``chip_smoke.spans_behind_spin``).

Each run records the kernels alone (torch.profiler: the union of the
call's kernel intervals, and their sum, which counts twice what two
overlapping kernels share) and the CUDA-event mean over back-to-back calls
of the tree's C entry point (its host cost included); B7's runs also the
host microseconds a call of the C entry (``--host-calls`` calls, no
synchronize). Each tree's entry
point is called with its own arguments: a ``paged_decode.cu`` that takes
``wmax`` takes the split walk's scratch and flags. Each result is checked
against the plain version first (B6 per slot within 2e-2 bf16 / 1e-5 f32
of the slot's largest magnitude; B7 and B8 bit-equal; the chain's rows
bit-equal and its B6 outputs within B6's tolerance of the plain chain's).
B7 and B8 carry the launch floor E beside their bounds: the profiler's
time of the tool's empty kernel (one block of 32 threads), timed in the
same turns (``floor_ms``; ``sleep0_ms``: ``torch.cuda._sleep(0)``'s),
``floor_bound_ms`` = E + the bytes bound and ``share_of_floor_bound`` =
that over each tree's kernel time. ``--wrapper`` also times the host
cost of this checkout's ``paged_decode_attention``,
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
        [--b7 s4 n64 n256 f32 d64] [--chain]
        [--variant nopdl=_archive/nopdl]

``--b7`` alone times every B7 shape; ``--shapes`` and ``--b8`` with no
names time no B6 or B8. Needs an NVIDIA Hopper card and the CUDA toolkit;
run from the root of a checkout.
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
S4 = [0, 1, 64, 2000, 777, 128, 1500, 33]
CHAIN_REPS = 5                       # traced runs of the chain a turn
B7_SHAPES = {"s4": (8, torch.bfloat16, 128), "n64": (64, torch.bfloat16, 128),
             "n256": (256, torch.bfloat16, 128),
             "f32": (8, torch.float32, 128), "d64": (8, torch.bfloat16, 64)}
# the launch floor: an empty kernel, built beside the trees' units
EMPTY_CU = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int ptt_ab_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""


def shapes():
    short = np.random.default_rng(5).integers(1, 129, size=64).tolist()
    return {"s4": S4, "n1x2000": [2000],
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
    """One library a directory (its ``.cu`` files), all nvcc processes at
    once."""
    procs = {}
    for name, d in dirs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), *(str(u) for u in sorted(d.glob("*.cu")))]
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
        short = re.search(r"\w*(paged_decode|append_\w+|empty|spin)\w*", n)
        short = short.group(0) if short else n
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
        fn = lib.ptt_paged_append_token
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.token = fn

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


    def token_call(self, y):
        """A closure running B7 on ``y``'s pools at layer ``i % L``."""
        kp, vp, kn, vn = y["kp"], y["vp"], y["k_new"], y["v_new"]
        ptrs = [kn.data_ptr(), vn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                y["blk"].data_ptr(), y["off"].data_ptr()]
        N, L, nb = kn.shape[0], kp.shape[0], kp.shape[1]
        row = kn[0].numel() * kn.element_size()
        stream = torch.cuda.current_stream().cuda_stream
        fn = self.token

        def run(i=0):
            err = fn(*ptrs, N, i % L, nb, kp.shape[2], row, stream)
            if err:
                raise RuntimeError(f"ptt_paged_append_token: CUDA error "
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


def token_inputs(shape, dev, seed=4):
    """B7's pools [4, 512, 64, Hkv, D], new rows and destinations at
    ``shape``: (s4)'s lengths on a random table, or N rows on distinct
    random blocks at random offsets."""
    N, dt, d = B7_SHAPES[shape]
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = 512
    if N == len(S4):
        table = rng.permutation(np.arange(1, nb))[:N * MB].reshape(N, MB)
        lens = np.array(S4)
        blk, off = table[np.arange(N), lens // BS], lens % BS
    else:
        blk = rng.permutation(np.arange(1, nb))[:N]
        off = rng.integers(0, BS, size=N)
    kp, vp = (torch.randn(4, nb, BS, HKV, d, generator=g, device=dev,
                          dtype=dt) for _ in range(2))
    k_new, v_new = (torch.randn(N, HKV, d, generator=g, device=dev,
                                dtype=dt) for _ in range(2))
    return dict(kp=kp, vp=vp, k_new=k_new, v_new=v_new,
                blk=torch.as_tensor(blk.astype(np.int32), device=dev),
                off=torch.as_tensor(off.astype(np.int32), device=dev),
                bytes=2 * 2 * k_new.numel() * k_new.element_size() + 2 * N * 4)


def check_token(tree, y, name):
    """A tree's B7 writes (layer 1) equal the plain version's, bit for
    bit."""
    got = [y["kp"].clone(), y["vp"].clone()]
    want = [y["kp"].clone(), y["vp"].clone()]
    run = tree.token_call(dict(y, kp=got[0], vp=got[1]))
    run(1)
    tpa.paged_append_token_plain(*want, y["k_new"], y["v_new"], y["blk"],
                                 y["off"], 1)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{name}: B7 differs from the plain version")


def floor_calls(empty):
    """The launch floor's kernels: the tool's empty kernel (``empty``, its
    C entry) and ``torch.cuda._sleep(0)``."""
    stream = torch.cuda.current_stream().cuda_stream

    def run(i=0):
        err = empty(stream)
        if err:
            raise RuntimeError(f"ptt_ab_empty: CUDA error {err}")
    return {"empty": run, "sleep0": lambda i=0: torch.cuda._sleep(0)}


def floor_ms(floors, iters):
    """E (the empty kernel) and ``_sleep(0)``'s time by the profiler."""
    return {"floor_ms": kernel_ms(floors["empty"], iters, "empty")[0],
            "sleep0_ms": kernel_ms(floors["sleep0"], iters, "")[0]}


def chain_inputs(dev, seed=12):
    """The chain's 32 pool layers [32, 512, 64, 8, 128] bf16, q, the new
    rows at (s4)'s lengths, their destinations and lengths + 1."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    nb, N = 512, len(S4)
    table = rng.permutation(np.arange(1, nb))[:N * MB].reshape(N, MB)
    lens = np.array(S4)
    kp, vp = (torch.randn(LAYERS, nb, BS, HKV, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    k_new, v_new = (torch.randn(N, HKV, D, generator=g, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(N, HKV * G, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(kp=kp, vp=vp, k_new=k_new, v_new=v_new, q=q,
                table=torch.as_tensor(table.astype(np.int32), device=dev),
                lens=torch.as_tensor(lens + 1, **i32),
                blk=torch.as_tensor(table[np.arange(N), lens // BS]
                                    .astype(np.int32), device=dev),
                off=torch.as_tensor(lens % BS, **i32), tokens=int(sum(lens)))


class Chain:
    """One tree's chain over ``x``'s 32 layers: B7 then B6 a layer, each
    through the tree's C entry points."""

    def __init__(self, tree, x):
        self.b7 = tree.token_call(x)
        self.b6, keep = tree.decode_call(x)
        self.out = keep[0]
        self.keep = keep

    def layers(self, outs=None):
        for layer in range(LAYERS):
            self.b7(layer)
            self.b6(layer)
            if outs is not None:
                outs.append(self.out.clone())


def check_chain(chain, x, want_rows, ref, name):
    """A tree's chain from the pools' original rows: the appended rows
    bit-equal to the new rows, each layer's B6 output per slot within 2e-2
    of the plain chain's ``ref``; the original rows put back after."""
    kp, vp, blk, off = x["kp"], x["vp"], x["blk"].long(), x["off"].long()
    outs = []
    chain.layers(outs)
    torch.cuda.synchronize()
    ok = (torch.equal(kp[:, blk, off], x["k_new"].expand(LAYERS, -1, -1, -1))
          and torch.equal(vp[:, blk, off],
                          x["v_new"].expand(LAYERS, -1, -1, -1)))
    err = max(((o.float() - r.float()).abs().flatten(1).amax(1)
               / r.float().abs().flatten(1).amax(1)).max().item()
              for o, r in zip(outs, ref))
    kp[:, blk, off], vp[:, blk, off] = want_rows
    if not ok or err > 2e-2:
        raise AssertionError(f"{name}: the chain disagrees with the plain "
                             f"chain (rows equal {ok}, B6 error {err})")
    return err


def plain_chain(x):
    """The plain chain's B6 outputs a layer, from the pools' original
    rows (put back after), and those rows."""
    kp, vp, blk, off = x["kp"], x["vp"], x["blk"].long(), x["off"].long()
    rows = (kp[:, blk, off].clone(), vp[:, blk, off].clone())
    cache = tpa.PagedKVCache(kp, vp, x["table"], x["lens"])
    ref = []
    for layer in range(LAYERS):
        tpa.paged_append_token_plain(kp, vp, x["k_new"], x["v_new"],
                                     x["blk"], x["off"], layer)
        ref.append(tpa.paged_decode_attention_plain(x["q"], cache, layer))
    kp[:, blk, off], vp[:, blk, off] = rows
    torch.cuda.synchronize()
    return ref, rows


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


def turns(names):
    """The order of one round: parent, change, the variants, change,
    parent."""
    order = ["parent", "change"] + [n for n in names
                                    if n not in ("parent", "change")]
    return order + ["change", "parent"]


def medians(runs):
    return {name: {k: float(np.median([v for v in vals if v is not None]))
                   for k, vals in r.items()
                   if vals and not isinstance(vals[0], (dict, list))}
            for name, r in runs.items()}


def rounds(calls, n_rounds, key, iters, floors=None, host_calls=0):
    """Each tree's times in turns, ``n_rounds`` times; their medians and
    every run. With ``floors``, the launch floor too, before each tree's
    turn (``floor_ms``, ``sleep0_ms``); with ``host_calls``, the host
    microseconds a call of the tree's C entry (``host_us``)."""
    runs = {name: {"kernel_ms": [], "kernel_sum_ms": [], "events_ms": [],
                   "host_us": [], "by_kernel": []}
            for name in calls}
    for _ in range(n_rounds):
        for name in turns(calls):
            if floors is not None:
                for k, v in floor_ms(floors, iters).items():
                    runs[name].setdefault(k, []).append(v)
            union, total, names = kernel_ms(calls[name], iters, key)
            runs[name]["kernel_ms"].append(union)
            runs[name]["kernel_sum_ms"].append(total)
            runs[name]["by_kernel"].append(names)
            runs[name]["events_ms"].append(cs.time_ms(calls[name], 2 * iters))
            if host_calls:
                runs[name]["host_us"].append(host_us(calls[name],
                                                     host_calls))
    return medians(runs), runs


def with_floor(rec, bound_ms, med):
    """``rec`` with the launch floor E (the median over every turn),
    E + the bytes bound, and that over each tree's kernel time."""
    e = float(np.median([m["floor_ms"] for m in med.values()]))
    rec.update(floor_ms=e, floor_bound_ms=e + bound_ms, share_of_floor_bound={
        name: (e + bound_ms) / m["kernel_ms"] for name, m in med.items()})
    return rec


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
    ap.add_argument("--b7", nargs="*", choices=list(B7_SHAPES),
                    help="B7's shapes (all of them when none is named)")
    ap.add_argument("--chain", action="store_true")
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
        (tmp / "empty").mkdir()
        (tmp / "empty" / "empty.cu").write_text(EMPTY_CU)
        t0 = time.perf_counter()
        built = build({**dirs, "empty": tmp / "empty"})
        build_s = time.perf_counter() - t0
        empty = built.pop("empty").ptt_ab_empty
        empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
        floors = floor_calls(empty)
        libs = {name: Tree(lib, trees[name]) for name, lib in built.items()}
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
            med, runs = rounds(calls, args.rounds, "append_blocks", 48,
                               floors)
            kb = sets[0][2]
            nbytes = 2 * 2 * kb.numel() * kb.element_size() + MB * 4
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            rec = with_floor({"kernel": "B8", "temperature": temp,
                              "bound_ms": bound, "median": med, "runs": runs,
                              "build_s": build_s, "card": card}, bound, med)
            print(json.dumps(rec), flush=True)
            del sets, calls
            torch.cuda.empty_cache()
        for shape in ([] if args.b7 is None else args.b7 or list(B7_SHAPES)):
            y = token_inputs(shape, dev)
            for name in libs:
                check_token(libs[name], y, name)
            calls = {name: tree.token_call(y) for name, tree in libs.items()}
            med, runs = rounds(calls, args.rounds, "append_token", 64,
                               floors, args.host_calls)
            bound = y["bytes"] / cs.HBM_BYTES_PER_S * 1e3
            N, dt, d = B7_SHAPES[shape]
            rec = with_floor({"kernel": "B7", "shape": shape, "N": N,
                              "dtype": str(dt)[6:], "D": d,
                              "bytes": y["bytes"], "bound_ms": bound,
                              "median": med, "runs": runs,
                              "build_s": build_s, "card": card}, bound, med)
            print(json.dumps(rec), flush=True)
            del y, calls
            torch.cuda.empty_cache()
        if args.chain:
            x = chain_inputs(dev)
            ref, rows = plain_chain(x)
            chains = {name: Chain(tree, x) for name, tree in libs.items()}
            errs = {name: check_chain(c, x, rows, ref, name)
                    for name, c in chains.items()}
            runs = {name: {"span_us": [], "host_enqueue_ms": [],
                           "spin_ms": []} for name in chains}
            for _ in range(args.rounds):
                for name in turns(chains):
                    for key, vals in zip(runs[name], cs.spans_behind_spin(
                            chains[name].layers, CHAIN_REPS, LAYERS)):
                        runs[name][key] += vals
            print(json.dumps({
                "kernel": "chain", "layers": LAYERS, "N": len(S4),
                "tokens": x["tokens"], "median_us_a_layer": {
                    name: float(np.median(r["span_us"]))
                    for name, r in runs.items()},
                "queued_ahead": all(h < t for r in runs.values() for h, t
                                    in zip(r["host_enqueue_ms"],
                                           r["spin_ms"])),
                "runs": runs, "max_rel_err": errs, "card": card}),
                flush=True)
            del x, chains
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
