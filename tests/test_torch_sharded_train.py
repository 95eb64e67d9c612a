"""Sharded training of the port (``llama.train_step`` under
``llama.activation_mesh`` over gloo ranks on the CPU, each holding its
slices of the state and its rows of the batch) held to the JAX package's
``train_step`` under GSPMD on the same mesh shape: ``Mesh(devs[:n]
.reshape(dp, 1, tp), ("dp", "sp", "tp"))`` with ``make_shardings(fsdp=)``,
tiny_llama (2 layers, hidden 64, 4/2 heads, seq 32, batch 4), f32.

One 2-rank and one 4-rank spawn (module fixture, started before the JAX
side runs) train every case for 2 steps from the same numpy state: dp=2
with and without fsdp, tp=2 (fsdp has no ``dp`` axis to split there), and
dp=2 x tp=2 with and without fsdp, each with adamw and adafactor; dp=2
with ``accum_steps=2``, and with full remat. Tolerances (f32): each
step's loss within 1e-5 relative, the grad norm before each step (the
plan's ``global_norm`` of ``loss_and_grads``' slices against the JAX
norm of the whole grads) within 1e-5 relative, each leaf's slices after
2 steps (params and moments) within 2e-5 of the leaf's largest
magnitude. Also: the collectives a step by kind, ``init_sharded_train_
state`` against ``shard_params(init_params)`` bit for bit,
``moment_shardings`` against the reference's spec trees, ``shard_batch``,
and the refusals of ``sp``, ``pp`` and ``ep`` meshes."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu.models import llama as jl
from paddle_tpu.optimizer import functional as jf
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.optimizer import functional as tf
from torch_dist_workers import sharded_train_worker, start_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, seq=32)
LR = 3e-4


def _case(mesh, fsdp, optimizer, **kw):
    return dict(mesh=mesh, fsdp=fsdp, optimizer=optimizer, lr=LR, **kw)


CASES2 = {
    **{f"dp2_{'fsdp' if f else 'nofsdp'}_{o}": _case((2, 1), f, o)
       for f in (True, False) for o in ("adamw", "adafactor")},
    **{f"tp2_{o}": _case((1, 2), True, o) for o in ("adamw", "adafactor")},
    "dp2_fsdp_adamw_accum2": _case((2, 1), True, "adamw", accum=2),
    "dp2_fsdp_adamw_remat": _case((2, 1), True, "adamw",
                                  config=dict(remat=True)),
}
CASES4 = {f"dp2tp2_{'fsdp' if f else 'nofsdp'}_{o}": _case((2, 2), f, o)
          for f in (True, False) for o in ("adamw", "adafactor")}
INITS2 = {"dp2_fsdp_adafactor": _case((2, 1), True, "adafactor"),
          "tp2_adamw": _case((1, 2), True, "adamw")}
INITS4 = {"dp2tp2_fsdp_adamw": _case((2, 2), True, "adamw"),
          "dp2tp2_nofsdp_adafactor": _case((2, 2), False, "adafactor")}
# (mesh shape, axes, model): each must refuse, naming its queue
REFUSALS = [((1, 2, 1), ("dp", "sp", "tp"), "llama"),
            ((2, 1, 1, 1), ("pp", "dp", "sp", "tp"), "llama"),
            ((1, 2, 1), ("dp", "ep", "tp"), "moe")]
QUEUES = ["A10.4", "A10.3", "A10.5"]


def _configs(**kw):
    j = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32, **kw)
    t = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32,
                            **kw)
    return j, t


TOKS = np.random.default_rng(7).integers(
    0, SIZES["vocab"], (4, SIZES["seq"] + 1)).astype(np.int64)


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tree):
    """Both spawns, started before the JAX side is computed (the
    reference fixture), collected here."""
    _, tcfg = _configs()
    runs = {
        2: start_ranks(sharded_train_worker, 2,
                       tmp_path_factory.mktemp("sharded2"), tree, TOKS,
                       tcfg, CASES2, INITS2, REFUSALS),
        4: start_ranks(sharded_train_worker, 4,
                       tmp_path_factory.mktemp("sharded4"), tree, TOKS,
                       tcfg, CASES4, INITS4)}
    return runs


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jcfg):
    return jax.jit(jax.grad(lambda p, t: jl.loss_fn(p, t, jcfg)))


def jax_run(tree, jcfg, case, mod=jl, tokens=TOKS):
    """The JAX package's train steps for one case on its mesh: each
    step's loss, the whole grads' norm and the grads before it, and the
    final state (numpy)."""
    dp, tp = case["mesh"]
    opt = case["optimizer"]
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, 1, tp),
                ("dp", "sp", "tp"))
    sh = mod.make_shardings(jcfg, mesh, fsdp=case["fsdp"])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mu, nu = jf.init_moments(params, opt)
    mu_sh, nu_sh = jf.moment_shardings(sh, params, opt)
    out_sh = jl.TrainState(sh, mu_sh, nu_sh, NamedSharding(mesh, JP()))
    # put_train_state's placement, with the step's as well, so the second
    # step reuses the first one's program
    st = jax.device_put(jl.put_train_state(
        jl.TrainState(params, mu, nu, jnp.zeros((), jnp.int32)), sh, opt),
        out_sh)
    toks = jax.device_put(jnp.asarray(tokens, jnp.int32),
                          NamedSharding(mesh, JP("dp", None)))
    grad = _jax_grad_fn(jcfg) if mod is jl else _moe_grad_fn(jcfg)
    losses, gnorms, grads = [], [], []
    with jl.activation_mesh(mesh):
        step = jax.jit(
            lambda s, t: mod.train_step(s, t, jcfg, lr=case["lr"],
                                        optimizer=opt,
                                        accum_steps=case.get("accum", 1)),
            out_shardings=(out_sh, NamedSharding(mesh, JP())))
        for _ in range(case.get("steps", 2)):
            g = grad(jax.tree_util.tree_map(np.asarray, st.params),
                     tokens.astype(np.int32))
            grads.append(jax.tree_util.tree_map(np.asarray, g))
            gnorms.append(float(np.sqrt(sum(
                np.sum(np.square(np.asarray(x, np.float64)))
                for x in jax.tree_util.tree_leaves(g)))))
            st, loss = step(st, toks)
            losses.append(float(loss))
    return {"losses": losses, "gnorms": gnorms, "grads": grads,
            "state": jax.tree_util.tree_map(
                np.asarray, {"params": st.params, "mu": st.mu,
                             "nu": st.nu})}


@functools.lru_cache(maxsize=None)
def _moe_grad_fn(jcfg):
    from paddle_tpu.models import moe as jm

    return jax.jit(jax.grad(lambda p, t: jm.loss_fn(p, t, jcfg)))


def np_cut(a, spec, sizes, coords):
    """This rank's slice of the numpy array ``a`` under ``spec`` (mesh
    dim sizes ``sizes``, the rank's ``coords``) — ``llama._cut``."""
    for d, entry in enumerate(spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n, idx = 1, 0
        for nm in names:
            idx, n = idx * sizes.get(nm, 1) + coords[nm], n * sizes.get(nm, 1)
        if n > 1:
            w = a.shape[d] // n
            a = np.take(a, np.arange(idx * w, (idx + 1) * w), axis=d)
    return a


def assert_slices_close(got, want, spec, sizes, coords, rel, path="",
                        noise=None, cap=None):
    """Each leaf of the rank's numpy tree ``got`` within ``rel`` times the
    whole JAX leaf's largest magnitude of that leaf's slice. ``noise`` (a
    tree like ``want`` of boolean masks) marks elements exempt from that
    bound, held to ``cap`` instead."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_slices_close(got[k], want[k], spec[k], sizes, coords, rel,
                                f"{path}.{k}",
                                None if noise is None else noise[k], cap)
        return
    w = np.asarray(want, np.float32)
    part = np_cut(w, spec, sizes, coords)
    assert got.shape == part.shape, (path, got.shape, part.shape)
    err = np.abs(got - part)
    off = err > rel * float(np.abs(w).max())
    if noise is not None:
        off &= ~np_cut(noise, spec, sizes, coords)
        assert float(err.max(initial=0.0)) <= cap, path
    assert not off.any(), (path, float(err.max()))


def grad_noise(grads):
    """Where a step's JAX gradient is f32 noise around 0 (nonzero and
    below 1e-5 of its leaf's largest): there AdamW's first steps move an
    element by up to lr whatever its sign, so two frameworks' updates may
    differ by up to 2 lr a step (tests/test_torch_train.py holds the
    single-device step to the same rule)."""
    def one(*gs):
        out = np.zeros(gs[0].shape, bool)
        for g in gs:
            a = np.abs(np.asarray(g, np.float32))
            out |= (a > 0) & (a < 1e-5 * a.max())
        return out
    return jax.tree_util.tree_map(one, *grads)


def check_case(res, want, case, world):
    """Every rank of one case against the JAX run ``want``."""
    dp, tp = case["mesh"]
    sizes = {"dp": dp, "sp": 1, "tp": tp}
    adamw = case["optimizer"] == "adamw"
    for r in range(world):
        got = res[r]["cases"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorms"], want["gnorms"], rtol=1e-5)
        mu_spec, nu_spec = got["moment_specs"]
        assert_slices_close(
            got["state"]["params"], want["state"]["params"], got["specs"],
            sizes, got["coords"], 2e-5, "params",
            grad_noise(want["grads"]) if adamw else None,
            2 * case["lr"] * len(want["losses"]))
        for key, spec in (("mu", mu_spec), ("nu", nu_spec)):
            assert_slices_close(got["state"][key], want["state"][key], spec,
                                sizes, got["coords"], 2e-5, key)


@pytest.fixture(scope="module")
def results(ranks, tree):
    """The JAX runs of every case (computed while the ranks run), then
    the ranks' results."""
    want = {}
    for name, case in {**CASES2, **CASES4}.items():
        jcfg, _ = _configs(**case.get("config", {}))
        want[name] = jax_run(tree, jcfg, case)
    return want, {n: r.results() for n, r in ranks.items()}


def _case_res(got, name):
    return [r["cases"][name] for r in got]


@pytest.mark.parametrize("name", sorted(CASES2))
def test_two_rank_train_steps_match_reference(results, name):
    want, got = results
    check_case([{"cases": c} for c in _case_res(got[2], name)], want[name],
               CASES2[name], 2)


@pytest.mark.parametrize("name", sorted(CASES4))
def test_four_rank_train_steps_match_reference(results, name):
    want, got = results
    check_case([{"cases": c} for c in _case_res(got[4], name)], want[name],
               CASES4[name], 4)


def test_collectives_a_step(results):
    """The plan's collectives over the 2 steps, by kind: fsdp gathers and
    reduce-scatters each of the 7L + 2 matrices once a step (the remat
    case gathers the layers' again in the recompute), the 3 unsplit leaves'
    grads (all 12 leaves' without fsdp), the loss and the norm ride
    all-reduces over dp; tp=2 adds 4 all-reduces a layer, one for the
    embedding, one for the head's input and 3 in the split cross-entropy,
    and the norm's over tp. Every rank counts the same."""
    _, got = results
    L = SIZES["layers"]
    want = {
        "dp2_fsdp_adamw": {"all_gather": 7 * L + 2, "reduce_scatter":
                           7 * L + 2, "all_reduce": 5},
        "dp2_fsdp_adamw_remat": {"all_gather": 14 * L + 2,
                                 "reduce_scatter": 7 * L + 2,
                                 "all_reduce": 5},
        "dp2_nofsdp_adamw": {"all_reduce": 9 + 3 + 2},
        "tp2_adamw": {"all_reduce": 4 * L + 1 + 1 + 3 + 1},
        "dp2tp2_fsdp_adamw": {"all_gather": 7 * L + 2,
                              "reduce_scatter": 7 * L + 2,
                              "all_reduce": 4 * L + 5 + 3 + 2 + 1},
    }
    for name, per_step in want.items():
        world = 4 if name.startswith("dp2tp2") else 2
        for res in _case_res(got[world], name):
            counts = {k: v for k, v in res["counts"].items()
                      if not k.endswith("_bytes")}
            assert res["plan_steps"] == 2
            assert counts == {k: 2 * v for k, v in per_step.items()}, name
    for name in CASES2:
        a, b = _case_res(got[2], name)
        assert a["counts"] == b["counts"], name


def test_local_config_and_specs(results):
    """The plan's config holds the rank's heads (4/2 over tp=2: 2/1) and
    the specs are make_shardings' (fsdp adds 'dp' on the other matrix
    axis; a mesh without dp > 1 drops it)."""
    _, got = results
    res = _case_res(got[2], "tp2_adamw")[0]
    assert res["local_config"] == (2, 1)
    assert res["specs"]["layers"]["wq"] == (None, None, "tp")
    specs = _case_res(got[4], "dp2tp2_fsdp_adamw")[0]["specs"]
    assert specs["layers"]["wq"] == (None, "dp", "tp")
    assert specs["layers"]["wo"] == (None, "tp", "dp")
    assert specs["embed"] == ("tp", "dp")
    assert specs["lm_head"] == ("dp", "tp")
    assert specs["layers"]["attn_norm"] == (None, None)
    nofsdp = _case_res(got[4], "dp2tp2_nofsdp_adamw")[0]["specs"]
    assert nofsdp["layers"]["wq"] == (None, None, "tp")


def test_sharded_init_equals_cut_init(results):
    """init_sharded_train_state's slices equal shard_params(init_params)
    bit for bit on every rank, are cut (not whole), its moments have
    put_train_state's shapes, and its step is 0."""
    _, got = results
    for world, inits in ((2, INITS2), (4, INITS4)):
        for res in got[world]:
            for name in inits:
                assert res["inits"][name] == {"equal": True,
                                              "moment_shapes": True,
                                              "cut": True, "step": 0}, name


def test_unported_meshes_raise_naming_their_queue(results):
    _, got = results
    for res in got[2]:
        errs = res["refusals"]
        assert len(errs) == len(QUEUES)
        for err, queue in zip(errs, QUEUES):
            assert err is not None and queue in err, (err, queue)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_moment_shardings_match_reference(optimizer, fsdp):
    """The port's moment spec trees over its make_shardings equal the
    reference's over its NamedShardings, leaf for leaf (each padded with
    None to the longer)."""
    jcfg, tcfg = _configs()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 1, 2),
                ("dp", "sp", "tp"))
    jsh = jl.make_shardings(jcfg, mesh, fsdp=fsdp)
    params = jl.init_params(jcfg, jax.random.PRNGKey(0))
    jmu, jnu = jf.moment_shardings(jsh, params, optimizer)
    tsh = tl.make_shardings(tcfg, {"dp": 2, "sp": 1, "tp": 2}, fsdp=fsdp)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    tmu, tnu = tf.moment_shardings(tsh, shapes, optimizer)

    def check(t, j):
        if isinstance(j, dict):
            assert set(t) == set(j)
            for k in j:
                check(t[k], j[k])
            return
        nd = max(len(t), len(j.spec))
        pad = (None,) * nd
        assert (tuple(t) + pad)[:nd] == (tuple(j.spec) + pad)[:nd], \
            (t, j.spec)

    check(tmu, jmu)
    check(tnu, jnu)


def test_shard_batch_takes_this_ranks_rows():
    """shard_batch cuts P("dp", None) (a mapping of sizes stands for a
    mesh: rank 0's rows); with no mesh active it raises."""
    toks = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(tl.shard_batch(toks, {"dp": 2}), toks[:4])
    with pytest.raises(ValueError, match="no mesh"):
        tl.shard_batch(toks)
