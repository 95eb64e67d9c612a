"""The port's per-layer numerics ladders (``llama.layer``, ``moe.layer``),
its MoE probes (``moe.router_logits``, ``moe.routed_out``,
``expert_int8``) and its MoE dispatch counters held to the JAX package's
on the CPU (the reference's tests/test_numerics.py ladder and probe
cases), on the same numpy-made weights and tokens:

- the ladders land one rung per layer under grad, equal to the
  reference's rungs; the provenance walk names the same first bad layer;
  the MoE ladder covers a dense head at offset 0;
- the probes land in a forward, with the reference's stats; the expert
  quant error equals the reference's;
- with numerics off no torch op is added to a train step or a forward; on,
  a remat'd step adds only the ladder's forward ops (a recompute lands no
  second rung and the rungs add no backward op);
- the plan-cache, fallback, fused-dispatch and tiling counters count the
  reference's values for the same calls."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

import paddle_tpu.observability as jobs
import paddle_tpu_torch.observability as tobs
from paddle_tpu.distributed.resilience import FaultInjector as JInj
from paddle_tpu.framework import flags as jflags
from paddle_tpu.kernels import gmm_autotune as jga
from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu.kernels import moe_fused as jmf
from paddle_tpu.models import llama as jl
from paddle_tpu.models import moe as jm
from paddle_tpu_torch.distributed.resilience import FaultInjector as TInj
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.kernels import gmm_autotune as tga
from paddle_tpu_torch.kernels import moe_dispatch as tmd
from paddle_tpu_torch.kernels import moe_fused as tmf
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import moe as tm
from paddle_tpu_torch.optimizer.functional import init_moments
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=64,
             ffn=64)


@pytest.fixture
def numerics_on():
    for pkg in (jobs, tobs):
        pkg.get_registry().reset()
        pkg.flight_recorder.get_recorder().clear()
        pkg.numerics.clear()
        pkg.enable()
        pkg.numerics.enable()
    try:
        yield
    finally:
        for pkg in (jobs, tobs):
            pkg.numerics.disable()
            pkg.disable()
            pkg.numerics.clear()
            pkg.get_registry().reset()
            pkg.flight_recorder.get_recorder().clear()


@pytest.fixture(scope="module")
def llama_model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.RandomState(0).randint(0, 64, (2, 17)).astype(np.int32)
    return jcfg, tcfg, tree, toks


def _rows(pkg, site):
    pkg.numerics.flush()
    return [r for r in pkg.numerics.rows() if r["site"] == site]


def _rows_close(got, want, rel=1e-4):
    assert [(r["layer"], r["nan_inf"]) for r in got] \
        == [(r["layer"], r["nan_inf"]) for r in want]
    for g, w in zip(got, want):
        for f in ("absmax", "rms"):
            assert abs(g[f] - w[f]) <= rel * max(abs(w[f]), 1e-6), (f, g, w)


def test_llama_ladder_lands_per_layer_rungs_under_grad(llama_model,
                                                       numerics_on):
    jcfg, tcfg, tree, toks = llama_model
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(p, jnp.asarray(toks), jcfg)))(jp)
    tl.loss_and_grads(tl.params_from_numpy(tree, device="cpu"),
                      torch.from_numpy(toks), tcfg)
    got, want = _rows(tobs, "llama.layer"), _rows(jobs, "llama.layer")
    assert [r["layer"] for r in got] == [0, 1]
    assert all(r["nan_inf"] == 0 and r["rms"] > 0 for r in got)
    _rows_close(got, want)


@pytest.mark.parametrize("poison", [(1,), (1, 0), (1,)], ids=[
    "layer1", "layers1and0", "layer1_remat"])
def test_provenance_names_the_reference_s_first_bad_layer(
        llama_model, numerics_on, poison, request):
    jcfg, tcfg, tree, toks = llama_model
    if request.node.callspec.id == "layer1_remat":
        jcfg = dataclasses.replace(jcfg, remat=True)
        tcfg = dataclasses.replace(tcfg, remat=True)
    js = jl.init_train_state(jcfg, jax.random.PRNGKey(0))
    js = jl.TrainState(jax.tree_util.tree_map(jnp.asarray, tree), js.mu,
                       js.nu, js.step)
    tp = tl.params_from_numpy(tree, device="cpu")
    ts = tl.TrainState(tp, *init_moments(tp),
                       torch.zeros((), dtype=torch.int32))
    for layer in poison:
        js = JInj.poison_layer(js, layer)
        ts = TInj.poison_layer(ts, layer)
    got = []
    for pkg, run in (
            (jobs, lambda: jax.jit(lambda s, t: jl.train_step(s, t, jcfg))(
                js, jnp.asarray(toks))),
            (tobs, lambda: tl.train_step(ts, torch.from_numpy(toks),
                                         tcfg))):
        ep = pkg.numerics.step_mark()
        run()
        got.append(pkg.numerics.provenance(ep))
    assert got[1] == got[0] == f"llama.layer:{min(poison)}"
    # one rung per layer per attempt: a remat recompute lands no second
    assert len(_rows(tobs, "llama.layer")) == 2
    c = tobs.get_registry().counter("numerics_events_total")
    assert c.labels(site="llama.layer").value == 2


@pytest.fixture(scope="module")
def moe_model():
    base = dict(vocab=64, hidden=32, layers=2, heads=4, experts=8, top_k=2,
                seq=64)
    jcfg = dataclasses.replace(jm.tiny_moe(**base), first_dense_layers=1,
                               dtype=jnp.float32, dispatch="fused")
    tcfg = dataclasses.replace(tm.tiny_moe(**base), first_dense_layers=1,
                               dtype=torch.float32, dispatch="fused")
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(0, 64, (2, 16)).astype(
        np.int32)
    return jcfg, tcfg, tree, toks


def test_moe_ladder_offset_and_probes_equal_reference(moe_model,
                                                      numerics_on):
    """The dense head's rung lands at 0 and the MoE tail's at 1 (offset
    first_dense_layers); the router-logit and routed-output probes land
    in a forward with the reference's stats."""
    jcfg, tcfg, tree, toks = moe_model
    jax.jit(lambda p, t: jm.forward(p, t, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(toks))
    with torch.no_grad():
        tm.forward(tm.params_from_numpy(tree, device="cpu"),
                   torch.from_numpy(toks), tcfg)
    got, want = _rows(tobs, "moe.layer"), _rows(jobs, "moe.layer")
    assert [r["layer"] for r in got] == [0, 1]
    _rows_close(got, want)
    for site in ("moe.router_logits", "moe.routed_out"):
        _rows_close(_rows(tobs, site), _rows(jobs, site))
        assert len(_rows(tobs, site)) == 1


def test_moe_provenance_names_the_reference_s_first_bad_layer(
        moe_model, numerics_on):
    """A NaN injected into the MoE tail's layer (1) is named by both
    packages' ladders: ``moe.layer:1``, past the clean dense head."""
    jcfg, tcfg, tree, toks = moe_model
    jp = JInj.poison_layer(jax.tree_util.tree_map(jnp.asarray, tree), 1)
    tp = TInj.poison_layer(tm.params_from_numpy(tree, device="cpu"), 1)
    got = []
    for pkg, run in (
            (jobs, lambda: jax.jit(lambda p, t: jm.forward(p, t, jcfg))(
                jp, jnp.asarray(toks))),
            (tobs, lambda: tm.forward(tp, torch.from_numpy(toks), tcfg))):
        ep = pkg.numerics.step_mark()
        with torch.no_grad():
            run()
        got.append(pkg.numerics.provenance(ep))
    assert got[1] == got[0] == "moe.layer:1"


def test_expert_int8_quant_error_equals_reference(moe_model, numerics_on):
    jcfg, tcfg, tree, _ = moe_model
    jm.quantize_expert_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tm.quantize_expert_params(tm.params_from_numpy(tree, device="cpu"))
    jobs.numerics.flush()
    tobs.numerics.flush()
    want = jobs.get_registry().gauge("numerics_quant_error").labels(
        site="expert_int8").value
    got = tobs.get_registry().gauge("numerics_quant_error").labels(
        site="expert_int8").value
    assert 0 < want < 0.1
    assert abs(got - want) <= 1e-5 * want
    _rows_close(_rows(tobs, "expert_int8"), _rows(jobs, "expert_int8"))


# ---------------------------------------------------------------------------
# the cost contract: no op added while off
# ---------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _Ops() as rec:
        fn()
    return rec.ops


@pytest.fixture
def obs_only():
    tobs.get_registry().reset()
    tobs.enable()
    try:
        yield
    finally:
        tobs.numerics.disable()
        tobs.disable()
        tobs.numerics.clear()
        tobs.get_registry().reset()


def test_ladders_and_probes_add_no_op_when_off(llama_model, moe_model,
                                               obs_only):
    _, tcfg, tree, toks = llama_model
    tcfg = dataclasses.replace(tcfg, remat=True)
    tp = tl.params_from_numpy(tree, device="cpu")
    ts = tl.TrainState(tp, *init_moments(tp),
                       torch.zeros((), dtype=torch.int32))
    t = torch.from_numpy(toks)
    _, mcfg, mtree, mtoks = moe_model
    mp = tm.params_from_numpy(mtree, device="cpu")
    mt = torch.from_numpy(mtoks)

    def step():
        tl.train_step(ts, t, tcfg)

    def fwd():
        with torch.no_grad():
            tl.hidden_states(tp, t[:, :-1], tcfg)

    def moe_fwd():
        with torch.no_grad():
            tm.forward(mp, mt, mcfg)

    runs = {}
    for mode in ("obs_on", "obs_off", "numerics_on"):
        if mode == "obs_off":
            tobs.disable()
        if mode == "numerics_on":
            tobs.enable()
            tobs.numerics.enable()
        runs[mode] = {name: _ops(fn) for name, fn in
                      (("step", step), ("fwd", fwd), ("moe", moe_fwd))}
    for name in ("step", "fwd", "moe"):
        assert runs["obs_on"][name] == runs["obs_off"][name]
        assert len(runs["numerics_on"][name]) > len(runs["obs_off"][name])
    # the remat'd step's extra ops are exactly the forward ladder's: the
    # recompute in the backward pass runs no probe and no rung op
    extra = len(runs["numerics_on"]["step"]) - len(runs["obs_off"]["step"])
    assert extra == len(runs["numerics_on"]["fwd"]) \
        - len(runs["obs_off"]["fwd"])


# ---------------------------------------------------------------------------
# the MoE dispatch counters
# ---------------------------------------------------------------------------
def _counter_values(pkg, names):
    reg = pkg.get_registry()
    out = {}
    for name in names:
        fam = reg.counter(name)
        out[name] = {tuple(sorted(c.labels.items())): c.value
                     for c in fam.series() if c.value}
    return out


_PLAN_CALLS = [(64, 2, 8, 32), (64, 2, 8, 32), (4096, 6, 64, 2048),
               (64, 2, 8, 32), (4096, 6, 64, 2048), (128, 2, 8, 32)]


def test_plan_cache_and_fallback_counters_equal_reference(obs_only):
    jobs.get_registry().reset()
    jobs.enable()
    try:
        for md in (jmd, tmd):
            md.clear_plan_cache()
            for T, k, E, h in _PLAN_CALLS:
                md.plan_dispatch(T, k, E, h)
            md.plan_dispatch(64, 2, 8, 32, dense_base=False)
        names = ("moe_plan_cache_hits_total", "moe_plan_cache_misses_total",
                 "moe_dispatch_fallbacks_total")
        got = _counter_values(tobs, names)
        assert got == _counter_values(jobs, names)
        assert got["moe_plan_cache_misses_total"][()] == 4
        assert got["moe_dispatch_fallbacks_total"] == {
            (("reason", "dense_buffer_too_big"),): 1}
    finally:
        jobs.disable()
        jobs.get_registry().reset()
        jmd.clear_plan_cache()
        tmd.clear_plan_cache()


def test_fused_dispatch_counts_every_call_as_reference(moe_model, obs_only):
    """The same fused-form calls are counted once each in both packages,
    under the port's path label (the reference's CPU route is "xla")."""
    jobs.get_registry().reset()
    jobs.enable()
    try:
        rng = np.random.default_rng(0)
        for T in (16, 40):
            x = rng.standard_normal((T, 32)).astype(np.float32)
            rw = rng.standard_normal((32, 8)).astype(np.float32) * 0.1
            eg, eu = (rng.standard_normal((8, 32, 16)).astype(np.float32)
                      for _ in range(2))
            ed = rng.standard_normal((8, 16, 32)).astype(np.float32)
            r = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), 2)
            jmf.fused_moe_ffn(jnp.asarray(x), r.weights, r.idx,
                              jnp.asarray(eg), jnp.asarray(eu),
                              jnp.asarray(ed), routing=r)
            tr = tmd.fused_routing(torch.from_numpy(x),
                                   torch.from_numpy(rw), 2)
            tmf.fused_moe_ffn(torch.from_numpy(x), tr.weights, tr.idx,
                              torch.from_numpy(eg), torch.from_numpy(eu),
                              torch.from_numpy(ed), routing=tr)
        name = "moe_gmm_fused_dispatch_total"
        got = _counter_values(tobs, (name,))[name]
        want = _counter_values(jobs, (name,))[name]
        assert want == {(("path", "xla"),): 2}
        assert got == {(("path", "padded"),): 2}
    finally:
        jobs.disable()
        jobs.get_registry().reset()


_SHAPE = dict(m=1024, k=256, n=512, E=8)


def _tiling_calls(ga, flags, tmp, dtype):
    """A miss that measures (each pass's non-heuristic candidate within
    the noise band: rejected), a hit, and a second key's miss."""
    flags.set_flags({"jit_cache_dir": str(tmp)})
    ga.clear()

    def noisy(pass_, tiling):
        heur = ga.heuristic_tilings(_SHAPE["m"], _SHAPE["k"], _SHAPE["n"])
        return 1.0 if tiling in heur else 0.99

    for _ in range(2):
        ga.get_tilings(_SHAPE["m"], _SHAPE["k"], _SHAPE["n"], _SHAPE["E"],
                       dtype, True, measure=noisy)
    ga.get_tilings(_SHAPE["m"], _SHAPE["k"], _SHAPE["n"], _SHAPE["E"],
                   dtype, False, measure=noisy)
    ga.clear()


def test_tiling_counters_equal_reference(tmp_path, obs_only):
    jobs.get_registry().reset()
    jobs.enable()
    jold, told = jflags.get_flag("jit_cache_dir"), \
        tflags.get_flag("jit_cache_dir")
    try:
        _tiling_calls(jga, jflags, tmp_path / "j", jnp.bfloat16)
        tga.counters.clear()
        _tiling_calls(tga, tflags, tmp_path / "t", torch.bfloat16)
        names = ("moe_tiling_cache_hits_total",
                 "moe_tiling_cache_misses_total",
                 "moe_tiling_autotune_rejected_total")
        got = _counter_values(tobs, names)
        assert got == _counter_values(jobs, names)
        assert got["moe_tiling_cache_misses_total"][()] == 2
        assert got["moe_tiling_autotune_rejected_total"][()] == 6
        for name in names:
            assert tga.counters[name] == got[name][()]
        hist = [pkg.get_registry().histogram(
            "moe_tiling_autotune_seconds").labels().count
            for pkg in (jobs, tobs)]
        assert hist[1] == hist[0] == 2
    finally:
        jflags.set_flags({"jit_cache_dir": jold})
        tflags.set_flags({"jit_cache_dir": told})
        jobs.disable()
        jobs.get_registry().reset()
