#!/usr/bin/env python3
"""What turning the port's observability on costs the serving path.

One process, one card: ``chip_smoke.py``'s Llama-3-8B random bf16 weights
(``llama3_8b_bf16``), its engine geometry (``SERVE_ENGINE``) and phase
4's 16-request serving mix (``serving_mix``), served through ``serve``
(its checks: launch counts, the drained ledger, 64 tokens a request) by a
mega and a ragged engine at 8 slots, observability off, on, on, off
after one warm-up run a path that is not reported. Each run reports
tokens/s up to a synchronize and the median chained decode step (a step
that dispatched a decode call and no prefill, over the call's 16 steps),
both with no synchronize inside the run. Prints one JSON line a run, the
medians of each setting (O off, N on) with on/off ratios, and the card's
name and power limit.

    python3 tools/obs_overhead.py

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import importlib.util
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ORDER = "ONNO"       # O: observability off, N: on


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("obs_overhead: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.kernels import _build as build
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import LLMEngine

    cs = smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    build.library()
    cfg, params = cs.llama3_8b_bf16(llama, dev)
    prompts = cs.serving_mix(cfg, 16)
    runs = {}
    for kernel in ("mega", "ragged"):
        # a warm-up run a path (not reported): the process's first runs
        # pay one-time set-up costs
        cs.serve(LLMEngine, build, dev, card, cfg, params, prompts,
                 max_slots=8, decode_kernel=kernel, trace=False)
        cs.free_memory()
        for mode in ORDER:
            cs.obs_reset(obs)
            (obs.enable if mode == "N" else obs.disable)()
            try:
                _, res, _, _ = cs.serve(LLMEngine, build, dev, card, cfg,
                                        params, prompts, max_slots=8,
                                        decode_kernel=kernel, trace=False)
            finally:
                obs.disable()
                cs.obs_reset(obs)
            row = {"kernel": kernel, "observability": mode == "N",
                   "tok_per_s": res["output_tok_per_s"],
                   "median_step_ms": res["median_decode_step_ms"],
                   "readbacks": res["readbacks"]}
            print(json.dumps(row), flush=True)
            runs.setdefault((kernel, mode), []).append(res)
            cs.free_memory()
    summary = {}
    for kernel in ("mega", "ragged"):
        med = {m: {k: statistics.median(r[k] for r in runs[(kernel, m)])
                   for k in ("output_tok_per_s", "median_decode_step_ms")}
               for m in "ON"}
        med["on_over_off_tok_per_s"] = (med["N"]["output_tok_per_s"]
                                       / med["O"]["output_tok_per_s"])
        med["on_over_off_step"] = (med["N"]["median_decode_step_ms"]
                                  / med["O"]["median_decode_step_ms"])
        summary[kernel] = med
    print(json.dumps({"obs_overhead": summary}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
