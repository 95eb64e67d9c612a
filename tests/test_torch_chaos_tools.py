"""The port's operator tools ``python -m paddle_tpu_torch.tools.chaos_run``
and ``python -m paddle_tpu_torch.tools.obs_dump`` on the CPU
(``--device cpu``), held to the JAX package's tools/chaos_run.py and
tools/obs_dump.py:

- chaos_run passes in all four modes (``CHAOS_PARITY: OK``,
  ``SERVING_CHAOS: OK``, ``HTTP_CHAOS: OK``, ``ROUTER_CHAOS: OK``), draws
  the reference's seeded fault schedule and prints the repro line;
- obs_dump's readers print the reference's tables for the same input
  documents (snapshot, post-mortem, /requests.json, /fleet/replicas.json,
  /alerts.json, the numerics rows, the flags), and its demos run.

Each run is a subprocess: the tools' global enables and signal handlers
must not leak into this test process."""
import argparse
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300, module=True):
    cmd = [sys.executable] + (["-m"] if module else []) + args
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, timeout=timeout,
                          cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    out = proc.stdout.decode(errors="replace")
    return proc.returncode, out


@pytest.mark.parametrize("mode,extra,ok", [
    ("--train", ["--steps", "12"], "CHAOS_PARITY: OK"),
    ("--serving", [], "SERVING_CHAOS: OK"),
    ("--http", ["--requests", "18"], "HTTP_CHAOS: OK"),
    ("--router", ["--requests", "12"], "ROUTER_CHAOS: OK")])
def test_chaos_run_passes_every_mode(mode, extra, ok, tmp_path):
    args = ["paddle_tpu_torch.tools.chaos_run", mode, "--device", "cpu",
            "--seed", "7"] + extra
    if mode == "--train":
        args += ["--workdir", str(tmp_path)]
    rc, out = _run(args)
    assert rc == 0, out[-3000:]
    assert ok in out
    if mode == "--train":
        assert "post-mortem names 'llama.layer:1'" in out
        assert "corrupted newest checkpoint" in out
        assert "0 skipped" in out


def test_chaos_run_fault_schedule_and_repro_line_equal_reference():
    from paddle_tpu.distributed.resilience import FaultInjector as J
    from paddle_tpu_torch.distributed.resilience import FaultInjector as T
    from paddle_tpu_torch.tools import chaos_run

    for seed in (3, 7):
        for kinds in (("nan_grad", "storage_fail"),
                      ("readback_fail", "pool_squeeze", "slow_step")):
            assert T.random_schedule(seed=seed, n_steps=12, kinds=kinds,
                                     rate=0.2).pending \
                == J.random_schedule(seed=seed, n_steps=12, kinds=kinds,
                                     rate=0.2).pending
    ns = argparse.Namespace(seed=3, replicas=2, requests=9, steps=5,
                            rate=0.1, device="cpu")
    head = "repro: python -m paddle_tpu_torch.tools.chaos_run"
    assert chaos_run._repro(ns, "router") == \
        f"{head} --router --seed 3 --device cpu --replicas 2 --requests 9"
    assert chaos_run._repro(ns, "train") == \
        f"{head} --train --seed 3 --device cpu --steps 5 --rate 0.1"


def test_chaos_run_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    import paddle_tpu_torch.observability as tobs
    from paddle_tpu_torch.tools import chaos_run, obs_dump

    with pytest.raises(RuntimeError, match="CUDA"):
        chaos_run.main(["--train"])
    with pytest.raises(RuntimeError, match="CUDA"):
        obs_dump.main(["--demo", "moe", "--out", os.devnull + "_x"])
    # refused before any global state was switched on
    assert not tobs.enabled() and not tobs.numerics.enabled()


# ---------------------------------------------------------------------------
# obs_dump: the readers
# ---------------------------------------------------------------------------
def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "_ref_obs_dump", os.path.join(REPO, "tools", "obs_dump.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    buf = io.StringIO()
    fn(*args, out=buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def documents(tmp_path_factory):
    """Input documents made by the port: a post-mortem and a snapshot of
    a chaos-injected resilient loop with numerics on, a served request
    table, the fleet and alert payloads."""
    tmp = tmp_path_factory.mktemp("docs")
    code = f"""
import json, torch
import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import numerics, timeseries, fleet
from paddle_tpu_torch.distributed.resilience import (FaultInjector,
    ResilientTrainLoop)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.framework.flags import set_flags
obs.enable(); numerics.enable()
set_flags({{"obs_ts_interval_s": 0.0}})
def step(s, b):
    w = s["w"] - 0.1 * b.mean()
    return {{"w": w}}, torch.abs(w).sum()
loop = ResilientTrainLoop(step, {{"w": torch.ones(2)}},
    [torch.full((2,), 0.1 * i) for i in range(6)],
    ckpt_dir={str(tmp / "ckpt")!r}, ckpt_every=2,
    injector=FaultInjector("nan_grad@2"))
loop.run(6)
cfg = llama.tiny_llama(vocab=64, hidden=32, layers=1, heads=4, kv_heads=2)
eng = LLMEngine(llama.init_params(cfg, 0, device="cpu"), cfg, device="cpu",
                max_slots=2, block_size=8, max_model_len=64,
                prompt_buckets=[8, 32], kv_dtype="int8")
for n in (5, 9, 3):
    eng.add_request(list(range(1, n + 1)), max_new_tokens=4)
eng.run()
numerics.flush()
docs = {{"requests": obs.requests_payload(),
        "alerts": timeseries.alerts_payload(),
        "fleet": fleet.replicas_payload(),
        "rows": numerics.rows()}}
json.dump(docs, open({str(tmp / "docs.json")!r}, "w"))
obs.dump_snapshot({str(tmp / "snapshot.json")!r})
obs.flight_recorder.dump({str(tmp / "postmortem.json")!r})
print("OK")
"""
    rc, out = _run(["-c", code], module=False)
    assert rc == 0 and out.strip().endswith("OK"), out[-3000:]
    docs = json.load(open(tmp / "docs.json"))
    docs["snapshot"] = str(tmp / "snapshot.json")
    docs["postmortem"] = str(tmp / "postmortem.json")
    return docs


@pytest.mark.parametrize("reader", [
    "print_table", "print_postmortem", "print_request_table",
    "print_numerics_table", "print_alert_table", "print_fleet_table"])
def test_obs_dump_readers_print_the_reference_s_tables(documents, reader):
    from paddle_tpu_torch.observability import load_snapshot
    from paddle_tpu_torch.tools import obs_dump

    ref = _reference_tool()
    arg = {"print_table": lambda: load_snapshot(documents["snapshot"]),
           "print_postmortem": lambda: documents["postmortem"],
           "print_request_table": lambda: documents["requests"],
           "print_numerics_table": lambda: documents["rows"],
           "print_alert_table": lambda: documents["alerts"],
           "print_fleet_table": lambda: documents["fleet"]}[reader]()
    got = _printed(getattr(obs_dump, reader), arg)
    want = _printed(getattr(ref, reader), arg)
    assert got == want
    assert len(got.splitlines()) >= 2
    if reader == "print_postmortem":
        assert "rollback" in got and "goodput ratio" in got
        assert "numerics at dump" in got
    if reader == "print_request_table":
        assert "requests: 3 traced" in got


def test_obs_dump_flags_listing_equals_reference():
    """The same flags with the same values and defaults, in the same
    order (the help lines are the port's own where its mechanism
    differs)."""
    rc, got = _run(["paddle_tpu_torch.tools.obs_dump", "--flags", "obs_"])
    assert rc == 0, got[-2000:]
    rc, want = _run([os.path.join("tools", "obs_dump.py"), "--flags",
                     "obs_"], module=False)
    assert rc == 0, want[-2000:]

    def flag_lines(out):
        return [line for line in out.splitlines()
                if line.startswith("FLAGS_")]
    assert flag_lines(got) == flag_lines(want)
    assert "FLAGS_obs_numerics = False" in got


# ---------------------------------------------------------------------------
# obs_dump: the demos
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("demo,want", [
    ("train", ["demo train: 8 steps, 5 checkpoints"]),
    ("goodput", ["demo goodput: 8 steps, 1 rollback(s)", "goodput ratio",
                 "rollback_retry"]),
    ("moe", ["demo moe: 2 layers x 8 experts", "moe_plan_cache_hits_total",
             "moe_plan_cache_misses_total",
             "moe_dispatch_fallbacks_total",
             "moe_gmm_fused_dispatch_total  counter  path=padded"]),
    ("numerics", ["first bad layer = llama.layer:1",
                  "quant-error budget weight_only",
                  "quant-error budget expert_int8",
                  "quant-error budget kv_int8", "quant_err",
                  "llama.layer"]),
    ("serving", ["int8 weights + int8 KV pools", "decode kernel paths:",
                 "serving_shed_total", "serving_kv_swap_out_total",
                 "serving_prefix_cache_hits_total", "speculative:",
                 "http front door: one round-trip", "fleet scrape:",
                 "disagg handoff: ok=2", "alerts:"])])
def test_obs_dump_demos_run_on_the_cpu(demo, want, tmp_path):
    rc, out = _run(["paddle_tpu_torch.tools.obs_dump", "--demo", demo,
                    "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0, out[-3000:]
    for s in want:
        assert s in out, (s, out[-3000:])
    assert (tmp_path / "snapshot.json").exists()
    assert (tmp_path / "trace.json").exists()
    if demo == "goodput":
        pm = tmp_path / "postmortem.json"
        rc, out = _run(["paddle_tpu_torch.tools.obs_dump", "--postmortem",
                        str(pm)])
        assert rc == 0, out[-2000:]
        assert "trigger=manual" in out and "rollback" in out
        # re-running into the same --out must not resume the old run
        rc, out = _run(["paddle_tpu_torch.tools.obs_dump", "--demo",
                        "goodput", "--out", str(tmp_path)])
        assert rc == 0 and "1 rollback(s)" in out, out[-2000:]
