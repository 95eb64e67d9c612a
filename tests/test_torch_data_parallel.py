"""The port's eager data-parallel wrappers on two gloo ranks:
``distributed.DataParallel`` over a small ``torch.nn.Module`` (its
``apply_collective_grads`` averages each ``.grad``; inside ``no_sync`` it
averages nothing) and ``fleet.distributed_model`` /
``distributed_optimizer`` at dp=2 (``DataParallel`` over the
data-parallel group, ``HybridParallelOptimizer`` averaging the grads
before its SGD steps, ``minimize``, ``clear_grad`` and the lr and state
pass-throughs). Each rank holds half the rows of one batch; the averaged
grads equal ``jax.grad`` of the same mean-squared-error over the whole
batch (f32, within 1e-6 of each leaf's largest magnitude), the
``no_sync`` grads ``jax.grad`` over the rank's own rows."""
import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from torch_dist_workers import data_parallel_worker, spawn_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 0.1


def _data():
    rng = np.random.default_rng(3)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((16, 8), (16,), (4, 16), (4,))]
    x = rng.standard_normal((6, 8)).astype(np.float32)
    t = rng.standard_normal((6, 4)).astype(np.float32)
    return w, x, t


def _loss(w, x, t):
    h = jnp.tanh(x @ w[0].T + w[1])
    return jnp.mean((h @ w[2].T + w[3] - t) ** 2)


_grad = jax.jit(jax.grad(_loss))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    w, x, t = _data()
    return spawn_ranks(data_parallel_worker, 2,
                       tmp_path_factory.mktemp("dp"), w, x, t, LR)


def _close(got, want):
    for g, e in zip(got, want):
        e = np.asarray(e)
        np.testing.assert_allclose(g, e, rtol=0,
                                   atol=1e-6 * float(np.abs(e).max()))


def test_data_parallel_averages_grads_over_the_batch(ranks):
    w, x, t = _data()
    want = _grad(w, x, t)
    for res in ranks:
        _close(res["avg"], want)


def test_no_sync_keeps_each_ranks_grads(ranks):
    w, x, t = _data()
    for r, res in enumerate(ranks):
        _close(res["no_sync"], _grad(w, x[3 * r:3 * r + 3],
                                     t[3 * r:3 * r + 3]))
    assert not np.allclose(ranks[0]["no_sync"][0], ranks[1]["no_sync"][0])


def test_state_dict_and_parameters_are_the_modules(ranks):
    names = ["0.weight", "0.bias", "2.weight", "2.bias"]
    for res in ranks:
        assert res["names"] == (names, names)


def test_fleet_wrappers_step_on_the_averaged_grads(ranks):
    """distributed_model at dp=2 is a DataParallel over the dp group;
    the HybridParallelOptimizer's step and minimize are SGD on the whole
    batch's grads; clear_grad drops the grads; the lr and state dict pass
    through."""
    w, x, t = _data()
    g = _grad(w, x, t)
    once = [a - LR * np.asarray(b) for a, b in zip(w, g)]
    twice = [a - LR * np.asarray(b)
             for a, b in zip(once, _grad(once, x, t))]
    for res in ranks:
        assert res["wrappers"] == ("DataParallel", [0, 1],
                                   "HybridParallelOptimizer")
        _close(res["step"], once)
        _close(res["minimize"], twice)
        assert res["cleared"]
        assert res["lr"] == (LR / 2, LR / 2, ["param_groups", "state"],
                             LR / 2)


def test_mesh_examples_run_on_cpu_ranks():
    """``examples/llama_pretrain.py --dp 2`` and ``moe_pretrain.py --tp 2``
    on the CPU start their ranks themselves (gloo), print the loss and
    tokens/s over 2 devices, and their losses are the single-device
    run's (the sharded init is the whole init's cut and every rank draws
    the same batch) within 2e-3 relative: the tiny configs compute in
    bf16, where the tp partial sums and the dp gradient sums round per
    rank."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path

    from paddle_tpu_torch.examples import llama_pretrain, moe_pretrain

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("PADDLE_DISTRI_BACKEND", None)
    flags = ["--size", "tiny", "--device", "cpu", "--seq", "32",
             "--batch-size", "4", "--steps", "2"]
    runs = {"llama_pretrain": (llama_pretrain, ["--dp", "2"]),
            "moe_pretrain": (moe_pretrain, ["--tp", "2"])}
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"paddle_tpu_torch.examples.{name}", *flags,
         *mesh], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, (_, mesh) in runs.items()}
    for name, (mod, _) in runs.items():
        out, err = procs[name].communicate(timeout=300)
        assert procs[name].returncode == 0, err[-2000:]
        assert "tokens/s over 2 device(s)" in out, out
        got = [float(v) for v in re.search(r"losses \[(.*)\]", out)
               .group(1).split(",")]
        want = mod.main(flags)
        assert abs(got[-1] - want) <= 2e-3 * abs(want), (name, got, want)
