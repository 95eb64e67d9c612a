#!/usr/bin/env python3
"""Where one layer's time goes inside the mega decode kernel, block by block.

Builds a copy of the kernel's units (``paddle_tpu_torch/kernels/csrc/
mega_decode.cuh``) with ``kTrace`` on: consumer thread 0 of every block then
records ``clock64()`` at the phase boundaries of layer 1 of the first step
(after the norm, after the products, after each grid barrier) and the
cycles it spends in each phase's parts: staging the input rows, the ring
stages, the split-sum settle and the epilogue; attention's RoPE, walk,
merge and ring combine; the settle's contributor write and flag, and the
finisher's wait and combine; and in the draft's wave the first step's
head. Runs one decode step of Llama-3-8B (random bf16 weights, seed 0,
the serving mix's walk lengths; form ``int8``: int8 weights and pools),
or (form ``draft``) one k = 4 wave of the Llama-3.2-1B-shaped draft
through ``mega_decode_loop``, and prints one JSON object a form: each
interval's mean and largest value over the blocks in microseconds at the
SM clock ``nvidia-smi`` reports after the run, and the card's name and
power limit. The traced build takes a few more registers than the real
one; read its times as shares.

    python3 tools/mega_decode_trace.py [--slots 4] [--forms bf16 int8 draft]

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke as cs  # noqa: E402
from mega_decode_phases import build, use  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import mega_decode as tmd  # noqa: E402
from paddle_tpu_torch.models import llama  # noqa: E402

# the layer's marks in slot order (mega_decode.cuh's mark(0) .. mark(12))
MARKS = ["start", "qkv_norm", "qkv", "barrier_1", "attention", "barrier_2",
         "wo", "barrier_3", "gate_up_norm", "gate_up", "barrier_4", "down",
         "barrier_5"]
PARTS = ["stage", "units", "settle", "epilogue"]
KINDS = ["qkv", "wo", "gate_up", "down", "head"]
ATTENTION = ["rope", "walk", "merge", "ring"]
SETTLE = ["contribute", "wait", "combine"]
# the trace's layout, read from the kernel source
LAYOUT = ("kTraceOffset", "kTraceSlots", "kTrHead", "kTrParts",
          "kTrAttention", "kTrSettle")


def layout(src: str) -> dict:
    """The ``constexpr int`` trace constants ``LAYOUT`` of the source."""
    out = {}
    for name in LAYOUT:
        m = re.findall(rf"constexpr int {name} = ([^;]+);", src)
        if len(m) != 1:
            raise RuntimeError(f"the kernel no longer defines {name} once")
        out[name] = int(eval(m[0], {"__builtins__": {}}))
    if out["kTrHead"] != len(MARKS):
        raise RuntimeError("the kernel's layer marks no longer match MARKS")
    return out


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0])


def stats(v, mhz):
    v = np.asarray(v, dtype=np.float64) / mhz
    return {"mean_us": float(v.mean()), "max_us": float(v.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--forms", nargs="+", default=["bf16"],
                    choices=["bf16", "int8", "draft"],
                    help="bf16: one Llama-3-8B step; int8: the same with "
                         "int8 weights and pools; draft: one k=4 wave of "
                         "the 1B-shaped draft")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_decode_trace: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    src = (_build.SRC_DIR / "mega_decode.cuh").read_text()
    flag = "constexpr bool kTrace = false;"
    if src.count(flag) != 1:
        raise RuntimeError(f"the kernel no longer has {flag!r}")
    lay = layout(src)
    OFFSET, SLOTS = lay["kTraceOffset"], lay["kTraceSlots"]
    buffers = tmd._buffers
    kept = []

    def traced_buffers(config, x0, *rest):
        out = list(buffers(config, x0, *rest))
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        out[5] = torch.zeros(OFFSET + 2 * SLOTS * blocks, dtype=torch.int32,
                             device=dev)
        kept.append(out[5])
        return tuple(out)

    with tempfile.TemporaryDirectory() as tmp:
        build({"trace": src.replace(flag, flag.replace("false", "true"))},
              Path(tmp))
        use(Path(tmp) / "trace" / "lib.so")
        tmd._buffers = traced_buffers
        cfg8, params8 = cs.llama3_8b_bf16(llama, dev)
        walk = [len(p) + 24 for p in cs.serving_mix(cfg8, args.slots)]
        for form in args.forms:
            if form == "draft":
                cfg, params = cs.llama32_1b_draft(llama, cfg8, dev)
                kw = cs.loop_inputs(cfg, dev, walk)
                run = lambda: cs.run_loop(tmd.mega_decode_loop, params, cfg,
                                          kw)
                label = "Llama-3.2-1B-shaped draft, k=4 wave"
            else:
                cfg, params = cfg8, params8
                if form == "int8":
                    params = llama.quantize_params(params8)
                kw, toks = cs.mega_inputs(cfg, dev, walk)
                if form == "int8":
                    qk, qv, ks, vs = cs.int8_pools(kw.pop("k_pool"),
                                                   kw.pop("v_pool"))
                    kw.update(k_pool=qk, v_pool=qv, ks_pool=ks, vs_pool=vs)
                x0 = params["embed"][toks].to(cfg.dtype)
                run = lambda: tmd.mega_decode_step(params, cfg, x0=x0, **kw)
                label = "Llama-3-8B one step" + (
                    ", int8 weights and pools" if form == "int8" else "")
            for _ in range(3):
                kept.clear()
                run()
            torch.cuda.synchronize()
            mhz = sm_clock_mhz()
            tr = kept[-1][OFFSET:].view(torch.int64).view(-1, SLOTS)
            print(json.dumps({"config": label, "slots": args.slots,
                              "walk": walk, "layer": 1, "sm_clock_mhz": mhz,
                              **summary(tr.cpu().numpy(), mhz, form, lay),
                              "card": card}), flush=True)
            del params, kw, run
            cs.free_memory()
    return 0


def summary(tr, mhz, form, lay):
    """The marks' intervals, the parts' cycles, over the blocks, at the
    slots ``lay`` (:func:`layout`) gives."""
    marks = tr[:, :len(MARKS)]
    parts, att, settle = (lay["kTrParts"], lay["kTrAttention"],
                          lay["kTrSettle"])
    out = {"intervals": {MARKS[i]: stats(marks[:, i] - marks[:, i - 1], mhz)
                         for i in range(1, len(MARKS))},
           "layer_us": stats(marks[:, -1] - marks[:, 0], mhz),
           "parts": {f"{KINDS[k]}.{PARTS[j]}": stats(
                         tr[:, parts + len(PARTS) * k + j], mhz)
                     for k in range(len(KINDS)) for j in range(len(PARTS))},
           "attention": {ATTENTION[j]: stats(tr[:, att + j], mhz)
                         for j in range(len(ATTENTION))},
           "settle": {SETTLE[j]: stats(tr[:, settle + j], mhz)
                      for j in range(len(SETTLE))}}
    if form == "draft":
        head = lay["kTrHead"]
        out["head_us"] = stats(tr[:, head + 1] - tr[:, head], mhz)
        out["commit_us"] = stats(tr[:, head + 2] - tr[:, head + 1], mhz)
    return out

if __name__ == "__main__":
    sys.exit(main())
