#!/usr/bin/env python3
"""Where the mega decode kernel's time goes, phase by phase, on the card.

Builds copies of the kernel (``paddle_tpu_torch/kernels/csrc/mega_decode.cuh``
and its units) side by side (one ``nvcc`` each, all started together): the
kernel as it is, and
one copy per phase with that phase switched off (q/k/v, attention, wo,
gate/up, down: the producer streams none of its tiles and the consumers
skip it), plus one with every phase off (the grid barriers alone). With
the weight stream running ahead of the barriers, a knocked-out phase
also takes its share of the overlap with its neighbours away, so the
phases' times need not add up to the whole. Each runs one decode step of Llama-3-8B (random bf16 weights,
seed 0) at the serving mix's walk lengths, timed with CUDA events in two
rounds of opposite order; a phase's time is the full kernel's minus its
knocked-out copy's. Prints, for each slot count asked for, one JSON
object with the times, each phase's bytes and their time at the card's
HBM rate, and the card's name and power limit. ``--int8`` runs the
kernel's int8 branches: int8 weights (``llama.quantize_params``) and int8
pools with f32 scales.

    python3 tools/mega_decode_phases.py [--slots 4 8] [--iters 10] [--int8]

Needs an NVIDIA Hopper card and the CUDA toolkit; run from the root of a
checkout.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import mega_decode as tmd  # noqa: E402
from paddle_tpu_torch.models import llama  # noqa: E402

# each phase's switch in the kernel source (the producer and the
# consumers both skip a phase that is off)
PHASES = {
    "qkv": "kRunQkv = true;",
    "attention": "kRunAttention = true;",
    "wo": "kRunWo = true;",
    "gate_up": "kRunGateUp = true;",
    "down": "kRunDown = true;",
}


def variants(src: str):
    out = {"full": src}
    for name, on in PHASES.items():
        if src.count(on) != 1:
            raise RuntimeError(f"the kernel no longer has the switch {on!r}")
        out[f"no_{name}"] = src.replace(on, on.replace("true", "false"))
    barriers = src
    for on in PHASES.values():
        barriers = barriers.replace(on, on.replace("true", "false"))
    out["barriers_only"] = barriers
    return out


def build(srcs, tmp: Path):
    """One shared library per variant, built in parallel."""
    csrc = _build.SRC_DIR
    units = sorted(p.name for p in csrc.glob("mega_decode*.cu"))
    procs = {}
    for name, text in srcs.items():
        d = tmp / name
        d.mkdir()
        for f in ["common.cuh", "hopper.cuh", "ragged_walk.cuh",
                  "errors.cu"] + units:
            (d / f).write_bytes((csrc / f).read_bytes())
        (d / "mega_decode.cuh").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), *(str(d / u) for u in units),
               str(d / "errors.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")


def use(path: Path):
    """Route the package's kernel wrappers to the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _build._lib, _build._fns = lib, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, nargs="+", default=[4])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights and int8 pools")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mega_decode_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    srcs = variants((_build.SRC_DIR / "mega_decode.cuh").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        build(srcs, Path(tmp))
        build_s = time.perf_counter() - t0
        cfg, params = cs.llama3_8b_bf16(llama, dev)
        if args.int8:
            params = llama.quantize_params(params)
            cs.free_memory()
        for slots in args.slots:
            print(json.dumps(measure(cfg, params, dev, srcs, Path(tmp),
                                     slots, args.iters, build_s, card,
                                     args.int8)), flush=True)
    return 0


def measure(cfg, params, dev, srcs, tmp, slots, iters, build_s, card,
            int8=False):
    """Every variant's time for one step at ``slots`` rows, and the
    phases' times, bytes and bounds (int8 pools with ``int8``)."""
    walk = [len(p) + 24 for p in cs.serving_mix(cfg, slots)]
    kw, toks = cs.mega_inputs(cfg, dev, walk)
    if int8:
        qk, qv, ks, vs = cs.int8_pools(kw.pop("k_pool"), kw.pop("v_pool"))
        kw.update(k_pool=qk, v_pool=qv, ks_pool=ks, vs_pool=vs)
    x0 = params["embed"][toks].to(cfg.dtype)
    ms = {name: [] for name in srcs}
    for order in (list(srcs), list(srcs)[::-1]):
        for name in order:
            use(tmp / name / "lib.so")
            ms[name].append(cs.time_ms(
                lambda i=0: tmd.mega_decode_step(params, cfg, x0=x0, **kw),
                iters))
    use(tmp / "full" / "lib.so")
    per_sm = tmd.blocks_per_sm(cfg.dtype, cfg.head_dim, slots, int8)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    lay = params["layers"]
    L = cfg.num_layers
    kv_row = cfg.num_kv_heads * cfg.head_dim * 2
    pool_row = cfg.num_kv_heads * (cfg.head_dim + 4) if int8 else kv_row

    def wb(*keys):       # a matrix's bytes: int8 values and bf16 scales
        return sum(t.numel() * t.element_size() for k in keys
                   for t in (lay[k].values() if isinstance(lay[k], dict)
                             else [lay[k]]))
    nbytes = {
        "qkv": wb("wq", "wk", "wv"),
        "attention": 2 * L * (sum(walk) * pool_row
                              + slots * (kw["t"] + 1) * kv_row),
        "wo": wb("wo"),
        "gate_up": wb("w_gate", "w_up"),
        "down": wb("w_down"),
    }
    phases = {name: {"ms": mean["full"] - mean[f"no_{name}"],
                     "bytes": nbytes[name],
                     "bound_ms": nbytes[name] / cs.HBM_BYTES_PER_S * 1e3}
              for name in PHASES}
    return {"config": "Llama-3-8B bf16 (random weights, seed 0)"
            + (", int8 weights and int8 pools" if int8 else ""),
            "slots": slots, "walk": walk, "t": kw["t"],
            "full_ms": mean["full"], "runs_ms": ms, "phases": phases,
            "barriers_only_ms": mean["barriers_only"],
            "barriers": 5 * L - 1, "blocks_per_sm": per_sm,
            "schedule": tmd.schedule(
                cfg, per_sm * torch.cuda.get_device_properties(
                    dev).multi_processor_count, w_int8=int8),
            "build_s": build_s, "card": card}


if __name__ == "__main__":
    sys.exit(main())
