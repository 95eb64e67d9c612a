#!/usr/bin/env python3
"""The serving engine of two source trees timed side by side on the card.

Runs ``chip_smoke.py``'s serving cells (``SERVING_CELLS``: phase 4,
16 greedy requests of its serving mix at 8 slots, ragged decode, 64 new
tokens each; phase 6(c), its first 8 requests through a mega engine and
a ragged engine at 4 slots) on its Llama-3-8B random bf16 weights
(``llama3_8b_bf16``) and engine geometry (``SERVE_ENGINE``), all taken
from this tree's ``chip_smoke.py``, with
each tree's ``paddle_tpu_torch`` in its own process, parent, change,
change, parent (``--order``). Each process serves a short warm-up first,
then times ``LLMEngine.run()`` up to a synchronize (tokens/s), each
step's wall time with no synchronize inside (the median of the steps
that dispatched a decode call and no prefill, over the call's 16 steps)
and its decode calls. Prints one JSON line a run, the medians of each
tree, and the card's name and power limit.

    python3 tools/serving_ab.py --parent _archive/parent [--order PCCP]

The kernel sources of the two trees must be equal (the tool copies this
tree's built library into the parent's build directory; a tree whose
sources differ builds its own). Needs an NVIDIA Hopper card and the CUDA
toolkit; run from the root of a checkout.
"""
import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def smoke():
    """This tree's ``chip_smoke.py``, loaded from its file so that the
    ``paddle_tpu_torch`` a child imports stays the one on its
    PYTHONPATH."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child() -> None:
    """Serve the cells with the ``paddle_tpu_torch`` on ``sys.path``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import LLMEngine

    cs = smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    cfg, params = cs.llama3_8b_bf16(llama, dev)
    out = {"tree": str(Path(llama.__file__).resolve().parents[2])}
    for name, kernel, slots, n in cs.SERVING_CELLS:
        eng = LLMEngine(params, cfg, max_slots=slots, **cs.SERVE_ENGINE,
                        decode_kernel=kernel, seed=cs.SEED, device=dev)
        prompts = cs.serving_mix(cfg, n)
        for p in prompts[:2]:                       # warm-up
            eng.add_request(p[:100], max_new_tokens=32)
        eng.run()
        calls, prefills, steps = [0], [0], []
        dispatch, prefill, step = (eng._dispatch_decode,
                                   eng._dispatch_prefill, eng.step)

        def counted(*a, **k):
            calls[0] += 1
            return dispatch(*a, **k)

        def prefill_counted(*a, **k):
            prefills[0] += 1
            return prefill(*a, **k)

        def timed():
            n0, p0 = calls[0], prefills[0]
            t0 = time.perf_counter()
            res = step()
            steps.append((time.perf_counter() - t0, calls[0] - n0,
                          prefills[0] - p0))
            return res

        eng._dispatch_decode, eng._dispatch_prefill = counted, prefill_counted
        eng.step = timed
        ids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(res[i]) for i in ids)
        if tokens != 64 * n:
            raise AssertionError(f"{name}: {tokens} tokens")
        # steps that dispatched a decode call and no prefill
        decode_only = [1e3 * t / cs.SERVE_ENGINE["decode_steps"]
                       for t, c, p in steps if c and not p]
        out[name] = {"output_tok_per_s": tokens / wall, "wall_s": wall,
                     "decode_calls": calls[0], "prefill_calls": prefills[0],
                     "median_step_ms": float(np.median(decode_only)),
                     "readbacks": dict(getattr(eng, "readbacks", {}))}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child()
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    trees = {"C": REPO, "P": args.parent.resolve()}
    # build this tree's library once; the parent's sources are the same,
    # so its build directory gets a copy under the same digest name
    subprocess.run([sys.executable, "-c",
                    "from paddle_tpu_torch.kernels import _build; "
                    "_build.library()"], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO)))
    src = REPO / "paddle_tpu_torch" / "_build"
    dst = trees["P"] / "paddle_tpu_torch" / "_build"
    dst.mkdir(parents=True, exist_ok=True)
    for so in src.glob("*.so"):
        shutil.copy2(so, dst / so.name)
    runs = {"P": [], "C": []}
    for t in args.order:
        res = subprocess.run(
            [sys.executable, str(REPO / "tools" / "serving_ab.py"),
             "--child"], cwd=trees[t], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(trees[t])))
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["run"] = t
        runs[t].append(line)
        print(json.dumps(line), flush=True)
    medians = {}
    for t, name in (("P", "parent"), ("C", "change")):
        medians[name] = {
            cell: {k: statistics.median(r[cell][k] for r in runs[t])
                   for k in ("output_tok_per_s", "median_step_ms")}
            for cell, *_ in smoke().SERVING_CELLS}
    print(json.dumps({"medians": medians, "order": args.order,
                      "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
