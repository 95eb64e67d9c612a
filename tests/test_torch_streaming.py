"""The port's host-streamed layer-wise train steps
(paddle_tpu_torch.optimizer.offload: make_streaming_train_step and its MoE
twin) held to the JAX package's on the CPU, where neither package has a
second memory and both keep the layers in place: the same numpy-made
weights and tokens go through both, and the port's streaming step is also
held to its own layer-wise step (the reference's
test_streaming_matches_layerwise_exactly). Tolerances: losses within 2e-5
relative (1e-4 for MoE, whose grouped GEMMs sum in another order), every
parameter and second-moment leaf within 1e-4 of its largest magnitude
(_assert_trees_close, tests/test_torch_train.py) after three (MoE: two)
adafactor steps at lr 1e-2, f32."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.models import moe as jm
from paddle_tpu.optimizer import offload as jo
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import moe as tm
from paddle_tpu_torch.optimizer import offload as to
from test_torch_train import _assert_trees_close
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-2
FIELDS = ("layers", "nu_layers", "embed", "final_norm", "lm_head",
          "nu_embed", "nu_fn", "nu_head")


def _configs():
    """tiny_llama(vocab=128, hidden=32, layers=3, heads=4, kv_heads=2,
    seq=32, ffn=64) in f32 in both packages."""
    kw = dict(vocab=128, hidden=32, layers=3, heads=4, kv_heads=2, seq=32,
              ffn=64)
    return (dataclasses.replace(jl.tiny_llama(**kw), dtype=jnp.float32),
            dataclasses.replace(tl.tiny_llama(**kw), dtype=torch.float32))


def _numpy_params(cfg, seed=0):
    """f32 llama weights made with numpy, scaled as init_params does."""
    rng = np.random.default_rng(seed)
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(h)

    def rnd(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "embed": rnd((cfg.vocab_size, h), s),
        "layers": {
            "attn_norm": 1 + rnd((L, h), 0.1),
            "wq": rnd((L, h, nq * d), s), "wk": rnd((L, h, nkv * d), s),
            "wv": rnd((L, h, nkv * d), s), "wo": rnd((L, nq * d, h), s),
            "mlp_norm": 1 + rnd((L, h), 0.1),
            "w_gate": rnd((L, h, f), s), "w_up": rnd((L, h, f), s),
            "w_down": rnd((L, f, h), 1 / np.sqrt(f)),
        },
        "final_norm": 1 + rnd((h,), 0.1),
        "lm_head": rnd((h, cfg.vocab_size), s),
    }


def _tokens(seed, vocab=128, B=2, S=32):
    return np.random.default_rng(100 + seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_layerwise(jcfg, tree):
    """A JAX layer-wise state holding ``tree``'s weights."""
    st = jo.init_layerwise_train_state(jcfg, jax.random.PRNGKey(0),
                                       param_dtype=jnp.float32)
    st.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return st


def _port_stream_from_jax(jst):
    return to.streaming_state_from_numpy(
        *(_np(getattr(jst, k)) for k in FIELDS), step=jst.step,
        device="cpu")


def _assert_stream_close(got, want, rel=1e-4):
    """Every layer's parameters and second moments and the tail of the
    port's StreamTrainState ``got`` against the JAX one ``want``."""
    assert got.step == want.step
    assert len(got.layers) == len(want.layers)
    for k in FIELDS:
        _assert_trees_close_any(getattr(got, k), getattr(want, k), rel)


def _assert_trees_close_any(got, want, rel):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_close(g, w, rel)
    else:
        _assert_trees_close(got, want, rel)


@pytest.fixture(scope="module")
def jax_streaming_run():
    """Three JAX streaming steps from the numpy weights; the states before
    and after and the losses."""
    jcfg, _ = _configs()
    tree = _numpy_params(jcfg)
    jst = jo.streaming_state_from_layerwise(_jax_layerwise(jcfg, tree))
    start = _np({k: getattr(jst, k) for k in FIELDS})
    step = jo.make_streaming_train_step(jcfg, lr=LR)
    losses = []
    for i in range(3):
        jst, loss = step(jst, jnp.asarray(_tokens(i)))
        losses.append(float(loss))
    return dict(tree=tree, start=start, state=jst, losses=losses)


def test_streaming_step_matches_reference(jax_streaming_run):
    """Three port streaming steps (state carried over with
    streaming_state_from_numpy) against the JAX streaming step."""
    _, tcfg = _configs()
    run = jax_streaming_run
    st = to.streaming_state_from_numpy(
        *(run["start"][k] for k in FIELDS), device="cpu")
    step = to.make_streaming_train_step(tcfg, lr=LR, device="cpu")
    losses = []
    for i in range(3):
        st, loss = step(st, torch.as_tensor(_tokens(i)))
        assert loss.dtype == torch.float32 and loss.shape == ()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, run["losses"], rtol=2e-5)
    _assert_stream_close(st, run["state"])


def test_streaming_matches_layerwise(jax_streaming_run):
    """The port's streaming step against the port's layer-wise step from
    the same weights: equal losses and trees within the same rule (the
    layer-wise step computes adafactor's decay on the device in f32, the
    streaming step on the host)."""
    _, tcfg = _configs()
    tree = jax_streaming_run["tree"]
    zeros = _np(_jax_layerwise(_configs()[0], tree).nu)
    lw = to.layerwise_state_from_numpy(tree, zeros, device="cpu")
    st = to.streaming_state_from_layerwise(
        to.layerwise_state_from_numpy(tree, zeros, device="cpu"))
    step_l = to.make_layerwise_train_step(tcfg, lr=LR)
    step_s = to.make_streaming_train_step(tcfg, lr=LR, device="cpu")
    for i in range(3):
        toks = torch.as_tensor(_tokens(i))
        lw, loss_l = step_l(lw, toks)
        st, loss_s = step_s(st, toks)
        np.testing.assert_allclose(loss_s.item(), loss_l.item(), rtol=2e-5)
    back = to.layerwise_state_from_streaming(st)
    assert int(back.step) == int(lw.step) == 3
    _assert_trees_close(back.params, lw.params, 1e-4)
    _assert_trees_close(back.nu, lw.nu, 1e-4)


def test_streaming_init_matches_reference_layout():
    """init_streaming_train_state: per-layer trees with the JAX package's
    keys, shapes and dtypes, second moments per _nu_like_perlayer (the
    norms' full {"v": [h]}), the tail's too; step 0. The RNGs differ, so
    values are not compared."""
    jcfg, tcfg = _configs()
    want = jo.init_streaming_train_state(jcfg, jax.random.PRNGKey(0))
    got = to.init_streaming_train_state(tcfg, 0, device="cpu")
    assert got.step == want.step == 0
    for k in FIELDS:
        w, g = getattr(want, k), getattr(got, k)
        wl = w if isinstance(w, list) else [w]
        gl = g if isinstance(g, list) else [g]
        assert len(gl) == len(wl), k
        for gt, wt in zip(gl, wl):
            jflat = {jax.tree_util.keystr(p): v for p, v in
                     jax.tree_util.tree_flatten_with_path(wt)[0]}
            tflat = {jax.tree_util.keystr(p): v for p, v in
                     jax.tree_util.tree_flatten_with_path(gt)[0]}
            assert set(jflat) == set(tflat), k
            for p, v in jflat.items():
                assert tuple(tflat[p].shape) == v.shape, (k, p)
                assert str(tflat[p].dtype)[6:] == str(v.dtype), (k, p)
    assert set(got.nu_layers[0]["attn_norm"]) == {"v"}
    assert set(got.nu_layers[0]["wq"]) == {"vr", "vc"}


def test_streaming_init_trains():
    """The port's own init and step memorize a fixed batch (the
    reference's test_streaming_init_trains)."""
    _, tcfg = _configs()
    st = to.init_streaming_train_state(tcfg, 0, param_dtype=torch.float32,
                                       device="cpu")
    step = to.make_streaming_train_step(tcfg, lr=5e-2, device="cpu")
    toks = torch.as_tensor(_tokens(0))
    losses = []
    for _ in range(8):
        st, loss = step(st, toks)
        losses.append(loss.item())
    assert st.step == 8
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0] - 0.5, losses


def test_state_conversions_round_trip():
    """layerwise -> streaming -> layerwise gives back every parameter and
    second moment exactly, and the streaming state's layers are copies
    (a step on it leaves the layer-wise state's layers as they were)."""
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    nu = jax.tree_util.tree_map(
        lambda a: rng.random(a.shape).astype(np.float32),
        _np(_jax_layerwise(jcfg, tree).nu))
    lw = to.layerwise_state_from_numpy(tree, nu, step=5, device="cpu")
    st = to.streaming_state_from_layerwise(lw)
    assert st.step == 5 and len(st.layers) == tcfg.num_layers
    back = to.layerwise_state_from_streaming(st)
    assert int(back.step) == 5
    for a, b in ((back.params, lw.params), (back.nu, lw.nu)):
        _assert_trees_close(a, b, 0.0)
    before = lw.params["layers"]["wq"].clone()
    to.make_streaming_train_step(tcfg, lr=LR, device="cpu")(
        st, torch.as_tensor(_tokens(0)))
    assert torch.equal(lw.params["layers"]["wq"], before)


def test_streaming_refusals_match_reference():
    """Tied embeddings, adamw and pipeline schedules raise
    NotImplementedError from both packages' streaming steps, with the same
    messages; adamw from both MoE streaming steps too."""
    jcfg, tcfg = _configs()
    for cfg_kw, kw in ((dict(tie_embeddings=True), {}),
                       ({}, dict(optimizer="adamw")),
                       (dict(pipeline_microbatches=2), {})):
        with pytest.raises(NotImplementedError) as ref:
            jo.make_streaming_train_step(dataclasses.replace(jcfg, **cfg_kw),
                                         **kw)
        with pytest.raises(NotImplementedError) as got:
            to.make_streaming_train_step(dataclasses.replace(tcfg, **cfg_kw),
                                         device="cpu", **kw)
        assert str(got.value) == str(ref.value)
    with pytest.raises(NotImplementedError) as ref:
        jo.make_streaming_moe_train_step(jm.tiny_moe(), optimizer="adamw")
    with pytest.raises(NotImplementedError) as got:
        to.make_streaming_moe_train_step(tm.tiny_moe(), optimizer="adamw",
                                         device="cpu")
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the MoE streaming step
# ---------------------------------------------------------------------------
def _moe_configs():
    """tiny_moe(layers=3, experts=8, top_k=2) with a dense first layer,
    f32, in both packages."""
    kw = dict(vocab=128, hidden=32, layers=3, heads=4, experts=8, top_k=2,
              seq=32)
    return (dataclasses.replace(jm.tiny_moe(**kw), first_dense_layers=1,
                                dtype=jnp.float32),
            dataclasses.replace(tm.tiny_moe(**kw), first_dense_layers=1,
                                dtype=torch.float32))


def _moe_layer_trees(cfg, seed=0):
    """Per-layer numpy trees (the dense layer without router and experts)
    and the tail, scaled as the streaming init does."""
    rng = np.random.default_rng(seed)
    h, E, fm = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fs = cfg.n_shared_experts * fm
    s = 1.0 / np.sqrt(h)

    def rnd(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    layers = []
    for l in range(cfg.num_layers):
        lp = {"attn_norm": 1 + rnd((h,), 0.1), "wq": rnd((h, nq * d), s),
              "wk": rnd((h, nkv * d), s), "wv": rnd((h, nkv * d), s),
              "wo": rnd((nq * d, h), s), "mlp_norm": 1 + rnd((h,), 0.1),
              "s_gate": rnd((h, fs), s), "s_up": rnd((h, fs), s),
              "s_down": rnd((fs, h), s)}
        if l >= cfg.first_dense_layers:
            lp.update({"router": rnd((h, E), 1.0),
                       "e_gate": rnd((E, h, fm), s),
                       "e_up": rnd((E, h, fm), s),
                       "e_down": rnd((E, fm, h), 1 / np.sqrt(fm))})
        layers.append(lp)
    tail = (rnd((cfg.vocab_size, h), s), 1 + rnd((h,), 0.1),
            rnd((h, cfg.vocab_size), s))
    return layers, tail


def _jax_moe_state(jcfg, layers, tail):
    st = jo.init_streaming_moe_train_state(jcfg, jax.random.PRNGKey(0),
                                           param_dtype=jnp.float32)
    st.layers = [jax.tree_util.tree_map(jnp.asarray, lp) for lp in layers]
    st.embed, st.final_norm, st.lm_head = (jnp.asarray(t) for t in tail)
    return st


def _routing_of_first_step(layers, tail, tokens):
    """Each package's expert assignment (top-k indices) of every MoE layer
    in the first step's forward pass, from the same weights."""
    jcfg, tcfg = _moe_configs()
    jmd = importlib.import_module("paddle_tpu.kernels.moe_dispatch")
    from paddle_tpu_torch.kernels import moe_dispatch as tmd
    out = {}
    for name, mod, run in (("jax", jmd, None), ("torch", tmd, None)):
        seen = []
        real = mod.fused_routing

        def spy(*a, real=real, seen=seen, **k):
            r = real(*a, **k)
            seen.append(np.asarray(r.idx))
            return r

        mod.fused_routing = spy
        try:
            inp = tokens[:, :-1]
            if name == "jax":
                x = jnp.asarray(tail[0])[jnp.asarray(inp)]
                cos, sin = jm._rope_tables(inp.shape[1], jcfg.head_dim,
                                           jcfg.rope_theta)
                carry = (x, jnp.zeros((), jnp.float32))
                for l, lp in enumerate(layers):
                    carry = jm._layer_body(
                        carry, jax.tree_util.tree_map(jnp.asarray, lp),
                        cos, sin, jcfg, 0, l < jcfg.first_dense_layers)
            else:
                x = torch.as_tensor(tail[0])[torch.as_tensor(inp).long()]
                cos, sin = tl._rope_tables(inp.shape[1], tcfg.head_dim,
                                           tcfg.rope_theta)
                aux = torch.zeros(())
                with torch.no_grad():
                    for l, lp in enumerate(layers):
                        x, aux = tm._layer_body(
                            x, aux, {k: torch.as_tensor(v)
                                     for k, v in lp.items()},
                            cos, sin, tcfg, l < tcfg.first_dense_layers)
        finally:
            mod.fused_routing = real
        out[name] = seen
    return out["jax"], out["torch"]


def test_streaming_moe_step_matches_reference():
    """Two port MoE streaming steps against the JAX package's, with a
    dense first layer (no router or experts in its tree): the first step's
    expert assignment equal in both packages, losses within 1e-4
    relative, layers, second moments and tail within 1e-4 of each leaf's
    largest magnitude."""
    jcfg, tcfg = _moe_configs()
    layers, tail = _moe_layer_trees(jcfg)
    toks = [_tokens(i) for i in range(2)]
    want_idx, got_idx = _routing_of_first_step(layers, tail, toks[0])
    assert len(want_idx) == len(got_idx) == 2
    for w, g in zip(want_idx, got_idx):
        np.testing.assert_array_equal(g, w)

    jst = _jax_moe_state(jcfg, layers, tail)
    assert "router" not in jst.layers[0] and "router" in jst.layers[1]
    st = _port_stream_from_jax(jst)
    jstep = jo.make_streaming_moe_train_step(jcfg, lr=LR)
    tstep = to.make_streaming_moe_train_step(tcfg, lr=LR, device="cpu")
    for t in toks:
        jst, jloss = jstep(jst, jnp.asarray(t))
        st, loss = tstep(st, torch.as_tensor(t))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _assert_stream_close(st, jst)


def test_streaming_moe_init_matches_reference_layout():
    """init_streaming_moe_train_state: the dense layer's tree has no
    router or experts, the others do, with the JAX package's shapes and
    dtypes."""
    jcfg, tcfg = _moe_configs()
    want = jo.init_streaming_moe_train_state(jcfg, jax.random.PRNGKey(0))
    got = to.init_streaming_moe_train_state(tcfg, 0, device="cpu")
    for gl, wl in ((got.layers, want.layers),
                   (got.nu_layers, want.nu_layers)):
        for g, w in zip(gl, wl):
            jflat = {jax.tree_util.keystr(p): v.shape for p, v in
                     jax.tree_util.tree_flatten_with_path(w)[0]}
            tflat = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                     jax.tree_util.tree_flatten_with_path(g)[0]}
            assert tflat == jflat
    assert "e_gate" not in got.layers[0] and "e_gate" in got.layers[1]
    assert all(t.dtype == torch.bfloat16 for t in got.layers[1].values())
