"""Sharded MoE training of the port (``moe.train_step`` under
``llama.activation_mesh`` over two gloo ranks on the CPU) held to the JAX
package's ``moe.train_step`` under GSPMD on the same mesh shape, as
tests/test_torch_sharded_train.py holds llama's: tiny_moe (2 layers, the
first dense, hidden 64, 4 heads, 8 experts of width 64, top-2, one shared
expert), f32, batch 4 x 32, fsdp, adamw, 2 steps, at dp=2 and at tp=2,
with dropless routing (the fused dispatch: "auto" picks it on the CPU, on
the world's first rank) and with capacity routing at a capacity factor of
1.0, where the batch overflows experts (its loss differs from the
dropless model's). Also the aux loss of each rank's rows against the JAX
forward's over the whole batch, and the collectives a step.

Tolerances as llama's (f32): losses and grad norms within 1e-5 relative,
every leaf's slices after 2 steps within 2e-5 of the leaf's largest
magnitude (AdamW's noise-around-0 elements excepted, held to 2 lr a
step); the aux loss within 1e-5 relative."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import moe as jm
from paddle_tpu_torch.models import moe as tm
from test_torch_sharded_train import check_case, jax_run
from torch_dist_workers import sharded_train_worker, start_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=256, hidden=64, layers=2, heads=4, experts=8, top_k=2,
             seq=32)
LR = 3e-4
CASES = {
    f"{routing}_{name}": dict(model="moe", mesh=mesh, fsdp=True,
                              optimizer="adamw", lr=LR, aux=True,
                              config=dict(routing=routing,
                                          capacity_factor=1.0))
    for routing in ("dropless", "capacity")
    for name, mesh in (("dp2", (2, 1)), ("tp2", (1, 2)))}


def _configs(**kw):
    base = dict(first_dense_layers=1, **kw)
    return (dataclasses.replace(jm.tiny_moe(**SIZES), dtype=jnp.float32,
                                **base),
            dataclasses.replace(tm.tiny_moe(**SIZES), dtype=torch.float32,
                                **base))


TOKS = np.random.default_rng(11).integers(
    0, SIZES["vocab"], (4, SIZES["seq"] + 1)).astype(np.int64)


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def results(tmp_path_factory, tree):
    """The two ranks' runs (started first) and the JAX runs of every
    case, with the JAX forward's aux loss over the whole batch."""
    _, tcfg = _configs()
    ranks = start_ranks(sharded_train_worker, 2,
                        tmp_path_factory.mktemp("moe_sharded"), tree, TOKS,
                        tcfg, CASES, {})
    want = {}
    for name, case in CASES.items():
        jcfg, _ = _configs(**case["config"])
        want[name] = jax_run(tree, jcfg, case, mod=jm, tokens=TOKS)
        _, aux = jm.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(TOKS[:, :-1], jnp.int32), jcfg,
                            return_aux=True)
        want[name]["aux"] = float(aux)
    return want, ranks.results()


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_train_steps_match_reference(results, name):
    want, got = results
    check_case([{"cases": r["cases"][name]} for r in got], want[name],
               CASES[name], 2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_aux_loss_is_the_global_batchs(results, name):
    """Each rank's aux loss, from its rows only, is the whole batch's."""
    want, got = results
    for r in got:
        np.testing.assert_allclose(r["cases"][name]["aux"],
                                   want[name]["aux"], rtol=1e-5)


def test_capacity_batch_drops_tokens(results):
    """At capacity factor 1.0 the batch overflows experts: the capacity
    model's first loss differs from the dropless model's (the same
    weights, nothing else differs), on both meshes alike."""
    want, got = results
    for mesh in ("dp2", "tp2"):
        drop = want[f"capacity_{mesh}"]["losses"][0]
        full = want[f"dropless_{mesh}"]["losses"][0]
        assert abs(drop - full) > 1e-4 * abs(full)
        for r in got:
            assert abs(r["cases"][f"capacity_{mesh}"]["losses"][0]
                       - drop) <= 1e-5 * abs(drop)


def test_moe_collectives_a_step(results):
    """fsdp at dp=2: every matrix that the step reads is gathered and
    reduce-scattered once a step — 4 attention matrices and 3 shared
    experts a layer, the MoE layer's router and 3 routed experts, embed
    and head (the dense layer's unused experts and router are never
    gathered) — and capacity routing gathers the expert counts once a
    MoE layer; tp=2 all-reduces the same number of times on both ranks
    and gathers nothing."""
    _, got = results
    L = SIZES["layers"]
    mats = 7 * L + 4 + 2
    for name in CASES:
        counts = [r["cases"][name]["counts"] for r in got]
        assert counts[0] == counts[1], name
        calls = {k: v for k, v in counts[0].items()
                 if not k.endswith("_bytes")}
        if name.endswith("dp2"):
            extra = 1 if name.startswith("capacity") else 0
            assert calls["all_gather"] == 2 * (mats + extra), name
            assert calls["reduce_scatter"] == 2 * mats, name
        else:
            assert set(calls) == {"all_reduce"}, name
