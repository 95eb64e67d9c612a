"""The port's MoE path (paddle_tpu_torch.kernels.moe_dispatch, moe_fused
and models.moe) held to the JAX package on the CPU: the same numpy-made
inputs go through both. The megablox grouped GEMMs run in Pallas
interpret mode as the reference; the port runs the plain versions of its
kernels (B9 gather_gmm, B10 gmm and tgmm), and its fused form runs the
tile-padded pipeline that the card runs, where the JAX package runs its
XLA rewrite off a TPU."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu.kernels import moe_fused as jmf
from paddle_tpu.models import moe as jm
from paddle_tpu.optimizer import functional as jf
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


def _close(got, want, rel, atol=0.0):
    """``got`` within ``rel`` of ``want``'s largest magnitude (+ atol)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=atol + rel * float(np.abs(w).max()))


def _trees_close(got, want, rel):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_close(got[k], want[k], rel)
        return
    _close(got, want, rel)


# ---------------------------------------------------------------------------
# B10: gmm / tgmm plain versions against megablox in interpret mode
# ---------------------------------------------------------------------------

# 256 rows: a 100-row group, an empty one, then 60 and 40; 56 tail rows
_GS = np.array([100, 0, 60, 40], np.int32)


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_plain_matches_megablox(transpose_rhs):
    """f32 within 1e-5 of the largest magnitude on the grouped rows; the
    port writes the tail rows (past sum(gs)) as zeros, which megablox
    leaves unwritten."""
    from jax.experimental.pallas.ops.tpu.megablox.gmm import gmm
    rng = np.random.default_rng(1)
    lhs = rng.standard_normal((256, 128)).astype(np.float32)
    rhs = rng.standard_normal((4, 128, 128)).astype(np.float32)
    want = gmm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(_GS),
               preferred_element_type=jnp.float32, tiling=(128, 128, 128),
               transpose_rhs=transpose_rhs, interpret=True)
    got = tmd.gmm(torch.as_tensor(lhs), torch.as_tensor(rhs),
                  torch.as_tensor(_GS), transpose_rhs)
    n = int(_GS.sum())
    _close(got[:n], np.asarray(want)[:n], 1e-5)
    assert torch.all(got[n:] == 0)


def test_tgmm_plain_matches_megablox():
    """f32 within 1e-5; the empty group's block is zeros in both."""
    from jax.experimental.pallas.ops.tpu.megablox.gmm import tgmm
    rng = np.random.default_rng(2)
    lhs = rng.standard_normal((256, 128)).astype(np.float32)
    rhs = rng.standard_normal((256, 128)).astype(np.float32)
    want = np.asarray(tgmm(jnp.asarray(lhs.T), jnp.asarray(rhs),
                           jnp.asarray(_GS),
                           preferred_element_type=jnp.float32,
                           tiling=(128, 128, 128), num_actual_groups=4,
                           interpret=True))
    got = tmd.tgmm(torch.as_tensor(lhs).t(), torch.as_tensor(rhs),
                   torch.as_tensor(_GS))
    assert np.all(want[1] == 0) and torch.all(got[1] == 0)
    _close(got, want, 1e-5)


def test_tgmm_plain_matches_megablox_on_ragged_groups():
    """Group boundaries off 64 and off 8 (rows 3, 64, 141, 150), so groups
    straddle the Hopper kernel's 64-row stages and megablox's 128-row
    tiles, an empty group and 106 rows past sum(gs): f32 within 1e-5, the
    empty group's block zero in both."""
    from jax.experimental.pallas.ops.tpu.megablox.gmm import tgmm
    gs = np.array([3, 61, 0, 77, 9], np.int32)
    rng = np.random.default_rng(3)
    lhs = rng.standard_normal((256, 128)).astype(np.float32)
    rhs = rng.standard_normal((256, 128)).astype(np.float32)
    want = np.asarray(tgmm(jnp.asarray(lhs.T), jnp.asarray(rhs),
                           jnp.asarray(gs),
                           preferred_element_type=jnp.float32,
                           tiling=(128, 128, 128), num_actual_groups=5,
                           interpret=True))
    got = tmd.tgmm(torch.as_tensor(lhs).t(), torch.as_tensor(rhs),
                   torch.as_tensor(gs))
    assert np.all(want[2] == 0) and torch.all(got[2] == 0)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# routing, layout and B9
# ---------------------------------------------------------------------------

def _ffn_arrays(T=64, h=32, E=8, f=16, seed=37, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, h)).astype(np.float32)
    rw = (rng.standard_normal((h, E)) * 0.3).astype(np.float32)
    if skew:
        rw[:, 0] += 0.6                   # expert 0 hoards assignments
    eg, eu = ((rng.standard_normal((E, h, f)) * 0.1).astype(np.float32)
              for _ in range(2))
    ed = (rng.standard_normal((E, f, h)) * 0.1).astype(np.float32)
    ct = rng.standard_normal((T, h)).astype(np.float32)
    return x, rw, eg, eu, ed, ct


@pytest.mark.parametrize("skew", [False, True])
def test_routing_layout_and_tile_gids_match_reference(skew):
    """fused_routing, _pad_layout (tm 128 and 8) and _tile_gids: every
    integer output equal, the gate weights, the aux loss and the padded
    combine weights within 1e-6."""
    x, rw, *_ = _ffn_arrays(skew=skew)
    T, k, E = 64, 2, 8
    jr = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    tr = tmd.fused_routing(torch.as_tensor(x), torch.as_tensor(rw), k)
    for name in ("idx", "order", "tok", "flat_e", "gs"):
        np.testing.assert_array_equal(_np(getattr(tr, name)),
                                      np.asarray(getattr(jr, name)), name)
    _close(tr.weights, jr.weights, 1e-6)
    assert abs(tr.aux.item() - float(jr.aux)) <= 1e-6
    jinv = jmf._inverse_permutation(jr.order).reshape(T, k)
    tinv = tmf._inverse_permutation(tr.order).reshape(T, k)
    np.testing.assert_array_equal(_np(tinv), np.asarray(jinv))
    jws = jr.weights.reshape(T * k)[jr.order]
    tws = tr.weights.reshape(T * k)[tr.order]
    for tm_ in (128, 8):
        want = jmf._pad_layout(jr.gs, jr.tok, jws, jr.flat_e[jr.order], jinv,
                               E, tm=tm_)
        got = tmf._pad_layout(tr.gs, tr.tok, tws, tr.flat_e[tr.order], tinv,
                              E, tm=tm_)
        for i, (a, b) in enumerate(zip(got, want)):
            if i == 1:                    # ws_pad
                _close(a, b, 1e-6)
            else:
                np.testing.assert_array_equal(_np(a), np.asarray(b))
        A_pad = int(want[0].shape[0])
        np.testing.assert_array_equal(
            _np(tmf._tile_gids(got[4], A_pad, tm_)),
            np.asarray(jmf._tile_gids(want[4], A_pad, tm_)))


@pytest.mark.parametrize("T,k,E,h", [(64, 2, 8, 32), (8192, 6, 64, 2048),
                                     (512, 2, 4, 64)])
def test_plan_dispatch_matches_reference(T, k, E, h):
    """The plan's slot count Q and dense-base decision, memoized."""
    want = jmd.plan_dispatch(T, k, E, h)
    got = tmd.plan_dispatch(T, k, E, h)
    assert (got.Q, got.use_dense) == (want.Q, want.use_dense)
    assert tmd.plan_dispatch(T, k, E, h) is got


@pytest.mark.parametrize("tm", [8, 128])
def test_gather_gmm_plain_matches_take_and_ragged_dot(tm):
    """B9's plain version on the reference's padded layout against
    take + ragged_dot on the valid rows (the JAX test's oracle; its own
    interpret-mode run of the Pallas kernel is skipped on this jax), f32
    within 1e-5."""
    T, h, E, f, k = 64, 128, 4, 64, 2
    x, rw, eg, eu, *_ = _ffn_arrays(T, h, E, f, seed=53)
    r = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    inv2d = jmf._inverse_permutation(r.order).reshape(T, k)
    ws = r.weights.reshape(T * k)[r.order]
    tok_pad, _, _, _, gs_pad = jmf._pad_layout(
        r.gs, r.tok, ws, r.flat_e[r.order], inv2d, E, tm=tm)
    Wcat = jnp.concatenate([jnp.asarray(eg), jnp.asarray(eu)], -1)
    gid = jmf._tile_gids(gs_pad, tok_pad.shape[0], tm)
    want = jax.lax.ragged_dot(jnp.take(jnp.asarray(x), tok_pad, axis=0),
                              Wcat, gs_pad)
    got = tmf.gather_gmm(*(torch.from_numpy(np.array(a)) for a in (
        x, tok_pad, Wcat, gid)), tm=tm)
    n = int(np.asarray(gs_pad).sum())
    _close(got[:n], np.asarray(want)[:n], 1e-5)


# ---------------------------------------------------------------------------
# the fused and gmm forms, values and gradients
# ---------------------------------------------------------------------------

def _form_run(arrays, form, k=2):
    """The port's form ``form`` ('fused', 'gmm' or 'unpadded') and the
    reference's (fused_moe_ffn for the fused forms, dropless_moe_ffn for
    gmm): (y, grads of x, w, gate, up, down) of both."""
    x, rw, eg, eu, ed, ct = arrays
    jr = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    jfn = jmd.dropless_moe_ffn if form == "gmm" else jmf.fused_moe_ffn

    def jloss(x, w, eg, eu, ed):
        return jnp.sum(jfn(x, w, jr.idx, eg, eu, ed, routing=jr)
                       * jnp.asarray(ct))

    jargs = (jnp.asarray(x), jr.weights, jnp.asarray(eg), jnp.asarray(eu),
             jnp.asarray(ed))
    want = [jfn(*jargs[:2], jr.idx, *jargs[2:], routing=jr)] + list(
        jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs))
    tr = tmd.fused_routing(torch.as_tensor(x), torch.as_tensor(rw), k)
    targs = [torch.as_tensor(a).requires_grad_(True) for a in (x, eg, eu, ed)]
    w = tr.weights.detach().requires_grad_(True)
    tx, teg, teu, ted = targs
    if form == "unpadded":
        T, h = x.shape
        inv2d = tmf._inverse_permutation(tr.order).reshape(T, k)
        ws = w.reshape(-1)[tr.order].float()
        f = eg.shape[-1]
        y = tmf._fused_unpadded(tx, ws, tr.tok, tr.gs, inv2d,
                                tmf._gate_up(teg, teu, tx.dtype)[0], ted, f,
                                tx.dtype).to(tx.dtype)
    else:
        fn = tmd.dropless_moe_ffn if form == "gmm" \
            else tmd.dropless_moe_ffn_fused
        y = fn(tx, w, tr.idx, teg, teu, ted, routing=tr)
    grads = torch.autograd.grad((y * torch.as_tensor(ct)).sum(),
                                (tx, w, teg, teu, ted))
    return [y] + list(grads), want


@pytest.mark.parametrize("form,skew", [("fused", False), ("fused", True),
                                       ("gmm", False), ("unpadded", True)])
def test_dispatch_forms_match_reference_values_and_grads(form, skew):
    """The fused form (its tile-padded kernel pipeline, counted as
    "padded"), the unpadded fused route and the gmm form against the
    reference's fused_moe_ffn / dropless_moe_ffn: y and the gradients of x,
    the gate weights and the three expert weights within 1e-5 of each
    one's largest magnitude (f32)."""
    tmf.fused_paths.clear()
    got, want = _form_run(_ffn_arrays(skew=skew), form)
    for name, a, b in zip(("y", "x", "w", "gate", "up", "down"), got, want):
        _close(a, b, 1e-5)
    if form == "fused":
        assert dict(tmf.fused_paths) == {"padded": 1}


def test_padding_rows_get_exactly_zero_gradient():
    """Through the combine-weight fold, the padding rows of B9's output get
    gradients of exactly 0, so they add nothing to tgmm's sums."""
    x, rw, eg, eu, ed, ct = (torch.as_tensor(a)
                             for a in _ffn_arrays(skew=True))
    T, k, E, f = 64, 2, 8, 16
    r = tmd.fused_routing(x, rw, k)
    inv2d = tmf._inverse_permutation(r.order).reshape(T, k)
    ws = r.weights.reshape(-1)[r.order]
    tok_pad, ws_pad, _, inv_pad, gs_pad = tmf._pad_layout(
        r.gs, r.tok, ws, r.flat_e[r.order], inv2d, E)
    gu = tmf._GatherGmm.apply(x, tok_pad, inv_pad, tmf._gate_up(eg, eu, x.dtype)[0],
                              gs_pad).detach().requires_grad_(True)
    zw = tmf._elementwise_core(gu, ws_pad, f, x.dtype)
    ys = tmf._grouped(zw, ed, gs_pad, full_rows=False)
    y = tmf._CombineRows.apply(ys, inv_pad, tok_pad)
    (d_gu,) = torch.autograd.grad((y * ct).sum(), (gu,))
    real = torch.zeros(tok_pad.shape[0], dtype=torch.bool)
    real[inv_pad.reshape(-1)] = True
    assert torch.all(d_gu[~real] == 0)
    assert torch.any(d_gu[real] != 0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _configs(**kw):
    """tiny_moe (hidden 32, 4 heads of 8, 8 experts, top-2, f = 16, one
    shared expert) with layer 0 dense, f32, in both packages."""
    base = dict(vocab=64, hidden=32, layers=2, heads=4, experts=8, top_k=2,
                seq=64)
    j = dataclasses.replace(jm.tiny_moe(**base), first_dense_layers=1,
                            dtype=jnp.float32, **kw)
    t = dataclasses.replace(tm.tiny_moe(**base), first_dense_layers=1,
                            dtype=torch.float32, **kw)
    return j, t


def _tokens(seed, B=2, S=32, vocab=64):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("routing", ["dropless", "capacity"])
def test_forward_logits_match_reference(tree, routing):
    """Logits within 1e-4 of their largest magnitude and the aux loss
    within 1e-5, layer 0 dense (f32)."""
    jcfg, tcfg = _configs(routing=routing)
    toks = _tokens(3)[:, :-1]
    jl, jaux = jm.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(toks), jcfg, return_aux=True)
    params = tm.params_from_numpy(tree, device="cpu")
    tl_, taux = tm.forward(params, torch.as_tensor(toks), tcfg,
                           return_aux=True)
    _close(tl_, jl, 1e-4)
    assert abs(taux.item() - float(jaux)) <= 1e-5


def test_dense_layer_runs_the_shared_ffn_at_its_own_width(tree):
    """The reference's dense layer 0 is the shared FFN, n_shared * f wide;
    the config's intermediate_size is never used (the published
    DeepSeekMoE layer 0 is 10944 wide): the port keeps that. Its init
    makes no [h, intermediate_size] weight, and changing
    intermediate_size changes no logit."""
    _, tcfg = _configs()
    shapes = {k: tuple(v.shape) for k, v in tm.init_params(
        tcfg, device="cpu")["layers"].items()}
    fs = tcfg.n_shared_experts * tcfg.moe_intermediate_size
    assert shapes["s_gate"] == (2, 32, fs) and shapes["s_down"] == (2, fs, 32)
    assert all(tcfg.intermediate_size not in s for s in shapes.values())
    params = tm.params_from_numpy(tree, device="cpu")
    toks = torch.as_tensor(_tokens(3)[:, :-1])
    a = tm.forward(params, toks, tcfg)
    b = tm.forward(params, toks,
                   dataclasses.replace(tcfg, intermediate_size=999))
    assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["attn", "outs"])
def test_remat_policies_equal_full(tree, monkeypatch, policy):
    """remat "attn" and "outs" give the loss and every gradient of "full"
    exactly. Under "full" the forward's grouped GEMM (the down projection)
    and B9 run twice a MoE layer; under "outs" the down projection runs
    once (its output kept, the recompute stopped there) and B9 twice."""
    _, tcfg = _configs(remat=True)
    params = tm.params_from_numpy(tree, device="cpu")
    toks = torch.as_tensor(_tokens(4))
    calls = {}
    gmm, gather_gmm = tmd.gmm, tmf.gather_gmm

    def forward_gmm(lhs, rhs, gs, transpose_rhs=False):
        if not transpose_rhs:            # the backward's dgrads transpose
            calls["gmm"] = calls.get("gmm", 0) + 1
        return gmm(lhs, rhs, gs, transpose_rhs)

    def b9(*a, **k):
        calls["gather_gmm"] = calls.get("gather_gmm", 0) + 1
        return gather_gmm(*a, **k)

    monkeypatch.setattr(tmd, "gmm", forward_gmm)
    monkeypatch.setattr(tmf, "gather_gmm", b9)
    runs = {}
    for pol in ("full", policy):
        calls.clear()
        c = dataclasses.replace(tcfg, remat_policy=pol)
        runs[pol] = tm._llama.loss_and_grads(params, toks, c, tm.loss_fn)
        runs[pol + "_calls"] = dict(calls)
    assert runs[policy][0].item() == runs["full"][0].item()
    for a, b in zip(tf.tree_leaves(runs[policy][1]),
                    tf.tree_leaves(runs["full"][1])):
        assert torch.equal(a, b)
    assert runs["full_calls"] == {"gmm": 2, "gather_gmm": 2}
    if policy == "outs":
        assert runs["outs_calls"] == {"gmm": 1, "gather_gmm": 2}


@pytest.fixture(scope="module")
def reference_steps(tree):
    """The reference's loss and grads, and its states after one and three
    steps of adamw and of adafactor on one fixed batch."""
    jcfg, _ = _configs()
    toks = jnp.asarray(_tokens(5))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jm.loss_fn(p, t, jcfg)))(jp, toks)
    out = dict(loss=float(loss), grads=grads)
    for opt in ("adamw", "adafactor"):
        mu, nu = jf.init_moments(jp, opt)
        state = jm.TrainState(jp, mu, nu, jnp.zeros((), jnp.int32))
        step = jax.jit(lambda s, t, o=opt: jm.train_step(
            s, t, jcfg, lr=LR, optimizer=o))
        states, losses = [], []
        for _ in range(3):
            state, l = step(state, toks)
            states.append(state)
            losses.append(float(l))
        out[opt] = (states, losses)
    return out


def test_loss_and_grads_match_reference(tree, reference_steps):
    """Loss within 1e-5 relative; every gradient leaf within 1e-4 of its
    largest magnitude (the dense layer's unused expert slices are zeros on
    both sides)."""
    _, tcfg = _configs()
    params = tm.params_from_numpy(tree, device="cpu")
    loss, grads = tm._llama.loss_and_grads(
        params, torch.as_tensor(_tokens(5)), tcfg, tm.loss_fn)
    want = reference_steps["loss"]
    assert abs(loss.item() - want) <= 1e-5 * abs(want)
    _trees_close(grads, reference_steps["grads"], 1e-4)
    for key in ("e_gate", "e_up", "e_down", "router"):
        assert torch.all(grads["layers"][key][0] == 0)


def _assert_params_close(got, want, grads, n_steps):
    """New params within 1e-6 + 1e-2*lr of the reference's, except where a
    gradient is f32 noise around 0 (AdamW's update may then take any size
    up to 2*lr a step): at most one in a thousand of each leaf (as the
    llama train-step test holds it)."""
    for k in want:
        if isinstance(want[k], dict):
            _assert_params_close(got[k], want[k], grads[k], n_steps)
            continue
        err = np.abs(_np(got[k]) - _np(want[k]))
        off = err > 1e-6 + 1e-2 * LR
        assert off.mean() < 1e-3, (k, off.sum())
        assert err.max() <= 2 * LR * n_steps, k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(tree, reference_steps, optimizer,
                                      n_steps):
    """One and three steps: each loss within 1e-5 relative, the new params
    as _assert_params_close holds them, the moments within 1e-4 of each
    leaf's largest magnitude."""
    _, tcfg = _configs()
    params = tm.params_from_numpy(tree, device="cpu")
    mu, nu = tf.init_moments(params, optimizer)
    state = tm.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))
    toks = torch.as_tensor(_tokens(5))
    states, losses = reference_steps[optimizer]
    for i in range(n_steps):
        state, loss = tm.train_step(state, toks, tcfg, lr=LR,
                                    optimizer=optimizer)
        assert abs(loss.item() - losses[i]) <= 1e-5 * abs(losses[i])
    ref = states[n_steps - 1]
    _assert_params_close(state.params, ref.params, reference_steps["grads"],
                         n_steps)
    _trees_close(state.nu, ref.nu, 1e-4)
    if optimizer == "adamw":
        _trees_close(state.mu, ref.mu, 1e-4)


# ---------------------------------------------------------------------------
# adafactor on the experts' rank-4 leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adafactor_rank4_leaves_match_reference(monkeypatch, param_dtype):
    """Three adafactor steps on an [L, E, h, f] leaf (factored over the
    last two axes: vr [L, E, h], vc [L, E, f]) and an [L, h, E] one,
    whole-leaf and updated in leading-axis slices (the path of the
    full-width experts): the params within 1e-5 (f32) or two bf16 ulps of
    the reference's, the moments within 1e-5."""
    rng = np.random.default_rng(9)
    jdt, tdt = getattr(jnp, param_dtype), getattr(torch, param_dtype)

    def tree_(r):
        return {"e": r.standard_normal((3, 4, 16, 24)),
                "r": r.standard_normal((3, 16, 4))}

    init = tree_(rng)
    grads = [tree_(rng) for _ in range(3)]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), init)
    jmu, jnu = jf.init_moments(jp, "adafactor")
    for step, g in enumerate(grads):
        jp, jmu, jnu = jf.optimizer_update(
            jp, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g),
            jmu, jnu, jnp.int32(step), optimizer="adafactor", lr=1e-2,
            scale=0.7)
    for whole in (1 << 30, 16 * 24):     # whole leaves; one slice a pass
        monkeypatch.setattr(tf, "_ADAFACTOR_WHOLE", whole)
        monkeypatch.setattr(tf, "_ADAFACTOR_CHUNK", 16 * 24)
        tp = tf.tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32)
                         .to(tdt), init)
        tmu, tnu = tf.init_moments(tp, "adafactor")
        for step, g in enumerate(grads):
            tp, tmu, tnu = tf.optimizer_update(
                tp, tf.tree_map(lambda a: torch.as_tensor(
                    a, dtype=torch.float32).to(tdt), g),
                tmu, tnu, torch.tensor(step, dtype=torch.int32),
                optimizer="adafactor", lr=1e-2, scale=torch.tensor(0.7),
                adafactor_eps2=1e-3)
        assert tuple(tnu["e"]["vr"].shape) == (3, 4, 16)
        assert tuple(tnu["e"]["vc"].shape) == (3, 4, 24)
        _trees_close(tp, jp, 8e-3 if param_dtype == "bfloat16" else 1e-5)
        _trees_close(tnu, jnu, 1e-5)
