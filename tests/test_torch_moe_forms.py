"""The rest of single-device MoE in the port, held to the JAX package on the
CPU: the measured dispatch-form pick and its persisted cache
(``pick_dispatch_form`` on injected timings), the dense-base form
(``_dense_meta`` and ``dropless_moe_ffn_dense``'s values and gradients,
on its dense path and on an overflowing batch that takes the gmm form),
train steps with ``dispatch="dense"``, and what remat "outs" keeps. The
same numpy-made inputs go through both packages; f32."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags as jflags
from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu.models import moe as jm
from paddle_tpu.optimizer import functional as jf
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.kernels import moe_dispatch as tmd
from paddle_tpu_torch.kernels import moe_fused as tmf
from paddle_tpu_torch.models import moe as tm
from paddle_tpu_torch.optimizer import functional as tf
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 3e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, rel):
    """``got`` within ``rel`` of ``want``'s largest magnitude."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=rel * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# the measured form pick, against the reference on the same timings
# ---------------------------------------------------------------------------

@pytest.fixture
def form_caches(tmp_path):
    """Both packages' form caches, fresh, persisting under one directory
    each (the same file name in both)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    old = (jflags.get_flag("jit_cache_dir"), tflags.get_flag("jit_cache_dir"))
    jflags.set_flags({"jit_cache_dir": str(jdir)})
    tflags.set_flags({"jit_cache_dir": str(tdir)})
    jmd.clear_form_cache()
    tmd.clear_form_cache()
    yield jdir, tdir
    jmd.clear_form_cache()
    tmd.clear_form_cache()
    jflags.set_flags({"jit_cache_dir": old[0]})
    tflags.set_flags({"jit_cache_dir": old[1]})


_FORM_ARGS = dict(T=512, k=2, E=8, h=64, f=32)


def _pick_both(measure, dense_ok=True):
    """The same pick in both packages with the same injected timings."""
    a = _FORM_ARGS
    j = jmd.pick_dispatch_form(a["T"], a["k"], a["E"], a["h"], a["f"],
                               jnp.float32, dense_ok=dense_ok,
                               measure=measure)
    t = tmd.pick_dispatch_form(a["T"], a["k"], a["E"], a["h"], a["f"],
                               torch.float32, dense_ok=dense_ok,
                               measure=measure)
    return j, t


def _doc(d):
    path = os.path.join(str(d), "moe_dispatch_forms.json")
    return json.load(open(path)) if os.path.exists(path) else None


def _boom(form):
    raise AssertionError("a cached pick must not measure")


def _case_persist(dirs):
    calls = []

    def measure(form):
        calls.append(form)
        return {"fused": 1.0, "gmm": 0.5, "dense": 2.0}[form]

    assert _pick_both(measure) == ("gmm", "gmm")
    assert sorted(calls) == sorted(["fused", "gmm", "dense"] * 2)
    assert _pick_both(_boom) == ("gmm", "gmm")
    jmd.clear_form_cache()
    tmd.clear_form_cache()                 # a fresh process: disk answers
    assert _pick_both(_boom) == ("gmm", "gmm")


def _case_never_worse(dirs):
    assert _pick_both(lambda f: 0.995 if f == "gmm" else 1.0) \
        == ("fused", "fused")


def _case_dense_excluded(dirs):
    assert _pick_both(lambda f: {"fused": 1.0, "gmm": 0.8,
                                 "dense": 0.1}[f]) == ("dense", "dense")
    calls = []

    def measure(form):
        calls.append(form)
        return {"fused": 1.0, "gmm": 0.5}[form]

    assert _pick_both(measure, dense_ok=False) == ("gmm", "gmm")
    assert "dense" not in calls
    assert _pick_both(_boom, dense_ok=False) == ("gmm", "gmm")
    assert _pick_both(_boom, dense_ok=True) == ("dense", "dense")


def _case_static(dirs):
    # no CUDA here and no TPU there: the static default, nothing persisted
    assert _pick_both(None) == ("fused", "fused")
    jflags.set_flags({"moe_dispatch_autotune": False})
    tflags.set_flags({"moe_dispatch_autotune": False})
    try:
        assert _pick_both(lambda f: 0.0) == ("fused", "fused")
    finally:
        jflags.set_flags({"moe_dispatch_autotune": True})
        tflags.set_flags({"moe_dispatch_autotune": True})


@pytest.mark.parametrize("case", [_case_persist, _case_never_worse,
                                  _case_dense_excluded, _case_static],
                         ids=["persist", "never_worse", "dense_excluded",
                              "static"])
def test_form_pick_matches_reference(form_caches, case):
    """The reference's cases (tests/test_moe_dispatch.py): a decisive
    winner is measured, cached and persisted (a cleared cache answers from
    the file with no measurement); a winner within 2% of the static
    default loses to it; a dense winner never answers a caller that
    excluded dense, whose own pick is cached too; no measurement (or the
    flag off) answers "fused". Both packages answer alike and persist the
    same document (both device tags read "cpu" here)."""
    case(form_caches)
    jdoc, tdoc = (_doc(d) for d in form_caches)
    assert jdoc == tdoc


def test_form_pick_absorbs_only_a_dense_out_of_memory(form_caches):
    """The one deliberate difference from the reference: only the dense
    candidate's ``torch.cuda.OutOfMemoryError`` drops it from the pick;
    any other error, or an out-of-memory error of another form,
    propagates (the reference skips a form on any exception)."""
    a = _FORM_ARGS

    def pick(measure):
        return tmd.pick_dispatch_form(a["T"], a["k"], a["E"], a["h"],
                                      a["f"], torch.float32, dense_ok=True,
                                      measure=measure)

    def dense_oom(form):
        if form == "dense":
            raise torch.cuda.OutOfMemoryError("dense staging")
        return {"fused": 1.0, "gmm": 0.5}[form]

    assert pick(dense_oom) == "gmm"
    tmd.clear_form_cache()
    tflags.set_flags({"jit_cache_dir": str(form_caches[1] / "other")})
    for form, exc in (("dense", RuntimeError("CUDA error")),
                      ("gmm", torch.cuda.OutOfMemoryError("gmm"))):
        def failing(f, form=form, exc=exc):
            if f == form:
                raise exc
            return 1.0
        with pytest.raises(type(exc)):
            pick(failing)


# ---------------------------------------------------------------------------
# the dense-base form
# ---------------------------------------------------------------------------

def _ffn_arrays(T=256, h=32, E=8, f=16, seed=0, skew=0.0):
    """x [T, h], router [h, E] (expert 0's column raised by ``skew``),
    experts and a cotangent, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, h)).astype(np.float32)
    rw = (rng.standard_normal((h, E)) * 0.1).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + skew
    rw[0, 0] += skew
    eg, eu = (rng.standard_normal((2, E, h, f)) * 0.1).astype(np.float32)
    ed = (rng.standard_normal((E, f, h)) * 0.1).astype(np.float32)
    ct = rng.standard_normal((T, h)).astype(np.float32)
    return x, rw, eg, eu, ed, ct


@pytest.mark.parametrize("skew", [0.0, 3.0], ids=["balanced", "overflow"])
def test_dense_meta_matches_reference(skew):
    """``_dense_meta``'s slot map r, source tokens, slot -> assignment map
    and overflow flag equal the reference's (an overflowing batch's extra
    assignments get the out-of-range slot E*Q on both sides)."""
    x, rw, *_ = _ffn_arrays(skew=skew)
    k, E = 2, 8
    jr = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    Q = jmd.plan_dispatch(x.shape[0], k, E, x.shape[1]).Q
    want = jmd._dense_meta(jr.idx, E, Q)
    got = tmd._dense_meta(torch.from_numpy(np.array(jr.idx)), E, Q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert bool(got[3]) == (skew == 0.0)


@pytest.mark.parametrize("skew", [0.0, 3.0], ids=["dense", "overflow"])
def test_dense_form_matches_reference_values_and_grads(skew):
    """``dropless_moe_ffn_dense`` against the reference's on the same
    gate weights and expert ids: y and the gradients of x, the gate
    weights and the three expert leaves within 1e-5 of each one's largest
    magnitude (f32), with the plan passed as the model passes it. The
    balanced batch takes the dense base; the skewed one (expert 0 in
    every token's top 2) overflows Q and takes the gmm form (B10's plain
    versions here), counted in ``dense_paths``."""
    x, rw, eg, eu, ed, ct = _ffn_arrays(skew=skew)
    T, h = x.shape
    k, E = 2, 8
    jr = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    plan = jmd.plan_dispatch(T, k, E, h)
    assert plan.use_dense

    def jloss(x, w, eg, eu, ed):
        y = jmd.dropless_moe_ffn_dense(x, w, jr.idx, eg, eu, ed,
                                       routing=jr, plan=plan)
        return jnp.sum(y * jnp.asarray(ct)), y

    jargs = (jnp.asarray(x), jr.weights, jnp.asarray(eg), jnp.asarray(eu),
             jnp.asarray(ed))
    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                         has_aux=True)(*jargs)
    tx, teg, teu, ted = (torch.as_tensor(a).requires_grad_(True)
                         for a in (x, eg, eu, ed))
    w = torch.from_numpy(np.array(jr.weights)).requires_grad_(True)
    idx = torch.from_numpy(np.array(jr.idx)).long()
    tmd.dense_paths.clear()
    y = tmd.dropless_moe_ffn_dense(tx, w, idx, teg, teu, ted,
                                   plan=tmd.plan_dispatch(T, k, E, h))
    grads = torch.autograd.grad((y * torch.as_tensor(ct)).sum(),
                                (tx, w, teg, teu, ted))
    _close(y, jy, 1e-5)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, 1e-5)
    assert dict(tmd.dense_paths) == ({"dense": 1} if skew == 0.0
                                     else {"gmm": 1})


def test_dense_form_skips_the_base_where_the_plan_says_so():
    """Where E*Q would exceed 4A the plan refuses the dense base and the
    form is the gmm form, with the routing reused (no dense_paths
    count), equal to the reference's."""
    x, rw, eg, eu, ed, _ = _ffn_arrays(T=16, E=8)
    k = 2
    plan = tmd.plan_dispatch(16, k, 8, 32)
    assert not plan.use_dense
    jr = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    want = jmd.dropless_moe_ffn_dense(
        jnp.asarray(x), jr.weights, jr.idx, jnp.asarray(eg), jnp.asarray(eu),
        jnp.asarray(ed), routing=jr)
    tr = tmd.fused_routing(torch.as_tensor(x), torch.as_tensor(rw), k)
    tmd.dense_paths.clear()
    got = tmd.dropless_moe_ffn_dense(
        torch.as_tensor(x), tr.weights, tr.idx, torch.as_tensor(eg),
        torch.as_tensor(eu), torch.as_tensor(ed), routing=tr, plan=plan)
    _close(got, want, 1e-5)
    assert not tmd.dense_paths


# ---------------------------------------------------------------------------
# the model with dispatch="dense"
# ---------------------------------------------------------------------------

def _configs(**kw):
    """tiny_moe with 4 experts, top-2, hidden 32, f = 16, layer 0 dense,
    f32: at B=2 x S=32 (T = 64) the plan takes the dense base (Q = 128,
    E*Q = 4A)."""
    base = dict(vocab=64, hidden=32, layers=2, heads=4, experts=4, top_k=2,
                seq=64)
    j = dataclasses.replace(jm.tiny_moe(**base), first_dense_layers=1,
                            dtype=jnp.float32, dispatch="dense", **kw)
    t = dataclasses.replace(tm.tiny_moe(**base), first_dense_layers=1,
                            dtype=torch.float32, dispatch="dense", **kw)
    return j, t


def _tokens(seed, B=2, S=32, vocab=64):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference_steps(tree):
    """The reference's loss, grads and states after one and three adamw
    steps with dispatch="dense" on one fixed batch."""
    jcfg, _ = _configs()
    assert jmd.plan_dispatch(64, 2, 4, 32).use_dense
    toks = jnp.asarray(_tokens(5))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jm.loss_fn(p, t, jcfg)))(jp, toks)
    mu, nu = jf.init_moments(jp, "adamw")
    state = jm.TrainState(jp, mu, nu, jnp.zeros((), jnp.int32))
    step = jax.jit(lambda s, t: jm.train_step(s, t, jcfg, lr=LR))
    states, losses = [], []
    for _ in range(3):
        state, l = step(state, toks)
        states.append(state)
        losses.append(float(l))
    return dict(loss=float(loss), grads=grads, states=states, losses=losses)


def _trees_close(got, want, rel):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_close(got[k], want[k], rel)
        return
    _close(got, want, rel)


def test_dense_loss_and_grads_match_reference(tree, reference_steps):
    """dispatch="dense" through the model: the loss within 1e-5 relative
    and every gradient leaf within 1e-4 of its largest magnitude; every
    MoE layer took the dense base."""
    _, tcfg = _configs()
    params = tm.params_from_numpy(tree, device="cpu")
    tmd.dense_paths.clear()
    loss, grads = tm._llama.loss_and_grads(
        params, torch.as_tensor(_tokens(5)), tcfg, tm.loss_fn)
    want = reference_steps["loss"]
    assert abs(loss.item() - want) <= 1e-5 * abs(want)
    _trees_close(grads, reference_steps["grads"], 1e-4)
    assert dict(tmd.dense_paths) == {"dense": 1}


@pytest.mark.parametrize("n_steps", [1, 3])
def test_dense_train_step_matches_reference(tree, reference_steps, n_steps):
    """One and three adamw steps with dispatch="dense": each loss within
    1e-5 relative, the new params within 1e-6 + 1e-2 * lr of the
    reference's but for at most one in a thousand elements of a leaf
    (f32 gradient noise around 0, as test_torch_moe holds it), never
    farther than 2 * lr a step."""
    _, tcfg = _configs()
    params = tm.params_from_numpy(tree, device="cpu")
    mu, nu = tf.init_moments(params, "adamw")
    state = tm.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))
    toks = torch.as_tensor(_tokens(5))
    for i in range(n_steps):
        state, loss = tm.train_step(state, toks, tcfg, lr=LR)
        want = reference_steps["losses"][i]
        assert abs(loss.item() - want) <= 1e-5 * abs(want)
    ref = reference_steps["states"][n_steps - 1]

    def params_close(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                params_close(got[k], want[k])
            return
        err = np.abs(_np(got) - _np(want))
        assert (err > 1e-6 + 1e-2 * LR).mean() < 1e-3
        assert err.max() <= 2 * LR * n_steps

    params_close(state.params, ref.params)


def test_auto_resolves_to_the_static_default_on_the_cpu(tree):
    """On the CPU "auto" is the static "fused" (no measurement): its loss
    equals dispatch="fused"'s exactly, and the pick cache stays empty."""
    _, tcfg = _configs()
    params = tm.params_from_numpy(tree, device="cpu")
    toks = torch.as_tensor(_tokens(5))
    tmd.clear_form_cache()
    a = tm.loss_fn(params, toks, dataclasses.replace(tcfg, dispatch="auto"))
    b = tm.loss_fn(params, toks, dataclasses.replace(tcfg, dispatch="fused"))
    assert a.item() == b.item()
    assert not tmd._FORM_CACHE


# ---------------------------------------------------------------------------
# remat "outs": what a MoE layer keeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["fused", "dense"])
def test_outs_keeps_the_routed_output_not_the_padded_rows(tree, monkeypatch,
                                                          dispatch):
    """Under remat "outs" the policy keeps, a MoE layer, the routed FFN's
    output [T, h] (``routed_out``) beside the flash forward's outputs, and
    no tensor with the padded layout's A_pad rows (the grouped GEMM's
    output it kept before); the loss and gradients equal remat "full"'s
    exactly."""
    _, tcfg = _configs(remat=True)
    tcfg = dataclasses.replace(tcfg, dispatch=dispatch)
    params = tm.params_from_numpy(tree, device="cpu")
    toks = torch.as_tensor(_tokens(4))
    T, h = 2 * 32, tcfg.hidden_size
    A = T * tcfg.top_k
    A_pad = -(-(A + tcfg.num_experts * (tmf._KTM - 1)) // tmf._KTM) \
        * tmf._KTM
    probe = []
    monkeypatch.setattr(tm, "saved_probe", probe)
    runs = {}
    for pol in ("full", "outs"):
        c = dataclasses.replace(tcfg, remat_policy=pol)
        runs[pol] = tm._llama.loss_and_grads(params, toks, c, tm.loss_fn)
    kept = [(name, shape) for name, shape, _ in probe]
    n_layers = tcfg.num_layers
    assert kept.count(("paddle_tpu_torch::routed_out", (T, h))) == \
        n_layers - tcfg.first_dense_layers
    assert sum(n == "paddle_tpu_torch::flash_fwd" for n, _ in kept) == \
        n_layers
    assert len(kept) == 2 * n_layers - tcfg.first_dense_layers
    assert not any(s and s[0] == A_pad for _, s in kept)
    assert runs["outs"][0].item() == runs["full"][0].item()
    for a, b in zip(tf.tree_leaves(runs["outs"][1]),
                    tf.tree_leaves(runs["full"][1])):
        assert torch.equal(a, b)


def test_default_form_measure_runs_every_form_off_the_card(form_caches):
    """The forward-plus-backward measurement the card uses (operands from
    ``make_moe_operands``, the sum-of-squares loss through
    ``fused_routing``), run on the CPU with a host clock, under
    ``torch.no_grad`` as a caller may hold it: each form returns a time
    and the pick persists a measured winner from them."""
    import time

    def host_timer(fn, *args, n=3):
        fn(*args)
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    T, k, E, h, f = 256, 2, 8, 32, 16
    assert tmd.plan_dispatch(T, k, E, h).use_dense
    runner = tmd._default_form_measure(T, k, E, h, f, torch.float32,
                                       device="cpu", timer=host_timer)
    with torch.no_grad():
        times = {form: runner(form) for form in ("fused", "gmm", "dense")}
        assert all(t > 0 for t in times.values())
        won = tmd.pick_dispatch_form(T, k, E, h, f, torch.float32,
                                     dense_ok=True, measure=runner)
    assert won in times
    doc = _doc(form_caches[1])
    (ent,) = (v for key, v in doc.items() if key != "__schema__")
    assert ent["source"] == "measured" and set(ent["ms"]) == set(times)
