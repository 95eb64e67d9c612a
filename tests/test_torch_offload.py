"""The port's layer-wise and host-offloaded train steps
(paddle_tpu_torch.optimizer.offload) held to the JAX package's
(paddle_tpu.optimizer.offload) on the CPU: the same numpy-made weights
and tokens go through both. On the CPU neither package has a second
memory, so the gradient/moment offload degrades to device staging in
both (the math is what is compared). Tolerances: losses within 2e-5
relative, every parameter and second-moment leaf within 1e-4 of its
largest magnitude (_assert_trees_close, tests/test_torch_train.py), f32;
the offload step equals the port's own llama.train_step exactly (the
same ops in the same order)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.optimizer import offload as jo
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.optimizer import offload as to
from test_torch_streaming import (LR, _configs, _jax_layerwise, _np,
                                  _numpy_params, _tokens)
from test_torch_train import _assert_trees_close
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def test_exports_cover_the_reference():
    assert set(jo.__all__) <= set(to.__all__)
    for name in to.__all__:
        assert hasattr(to, name), name


def test_layerwise_step_matches_reference():
    """Three port layer-wise steps (state from layerwise_state_from_numpy)
    against paddle_tpu's make_layerwise_train_step, lr 1e-2."""
    jcfg, tcfg = _configs()
    tree = _numpy_params(jcfg)
    jst = _jax_layerwise(jcfg, tree)
    st = to.layerwise_state_from_numpy(tree, _np(jst.nu), device="cpu")
    layers_before = st.params["layers"]["wq"]
    jstep = jo.make_layerwise_train_step(jcfg, lr=LR)
    tstep = to.make_layerwise_train_step(tcfg, lr=LR)
    for i in range(3):
        jst, jloss = jstep(jst, jnp.asarray(_tokens(i)))
        st, loss = tstep(st, torch.as_tensor(_tokens(i)))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    assert int(st.step) == int(jst.step) == 3
    # the stacked layers are updated in place (the port's donation)
    assert st.params["layers"]["wq"] is layers_before
    _assert_trees_close(st.params, jst.params, 1e-4)
    _assert_trees_close(st.nu, jst.nu, 1e-4)
    assert all(t.shape == () for t in to.tree_leaves(st.mu))


def test_layerwise_init_matches_reference_layout():
    """init_layerwise_train_state: params, mu placeholders and the
    per-layer nu (matrices factored with the stack dim kept, the [L, h]
    norms' full {"v": [L, h]}, the tail per _nu_like_perlayer) have the
    JAX package's shapes and dtypes; step a 0-d int32. The RNGs differ, so
    values are not compared."""
    jcfg, tcfg = _configs()
    want = jax.eval_shape(
        lambda k: jo.init_layerwise_train_state(jcfg, k),
        jax.random.PRNGKey(0))
    st = to.init_layerwise_train_state(tcfg, 0, device="cpu")
    for got, ref in ((st.params, want.params), (st.mu, want.mu),
                     (st.nu, want.nu)):
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(ref)[0]}
        tflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(got)[0]}
        assert set(jflat) == set(tflat)
        for k, v in jflat.items():
            assert tuple(tflat[k].shape) == v.shape, k
            assert str(tflat[k].dtype)[6:] == str(v.dtype), k
    L, h = tcfg.num_layers, tcfg.hidden_size
    assert set(st.nu["layers"]["attn_norm"]) == {"v"}
    assert tuple(st.nu["layers"]["attn_norm"]["v"].shape) == (L, h)
    assert st.step.dtype == torch.int32 and st.step.shape == ()


def test_layerwise_refusals_match_reference():
    """adamw, tied embeddings and pipeline schedules: NotImplementedError
    in both packages, with the same messages."""
    jcfg, tcfg = _configs()
    for cfg_kw, kw in ((dict(tie_embeddings=True), {}),
                       ({}, dict(optimizer="adamw")),
                       (dict(pipeline_microbatches=2), {})):
        with pytest.raises(NotImplementedError) as ref:
            jo.make_layerwise_train_step(
                dataclasses.replace(jcfg, **cfg_kw), **kw)
        with pytest.raises(NotImplementedError) as got:
            to.make_layerwise_train_step(
                dataclasses.replace(tcfg, **cfg_kw), **kw)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_offload_step_matches_reference(optimizer):
    """Two steps of make_offload_train_step (gradient offload; moments
    offloaded for adamw) against paddle_tpu's, from the same weights
    (tiny_llama(vocab=64, hidden=32, layers=2), f32, default lr and
    clip), and against the port's llama.train_step."""
    kw = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=32,
              ffn=64)
    jcfg = dataclasses.replace(jl.tiny_llama(**kw), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**kw), dtype=torch.float32)
    tree = _numpy_params(jcfg, seed=5)
    toks = np.random.default_rng(7).integers(0, 64, (4, 33)).astype(
        np.int32)
    offload_moments = optimizer == "adamw"

    jst = jo.init_offload_train_state(jl, jcfg, jax.random.PRNGKey(0),
                                      optimizer=optimizer,
                                      offload_moments=offload_moments)
    jst.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstep = jo.make_offload_train_step(jl, jcfg, optimizer=optimizer,
                                       offload_grads=True,
                                       offload_moments=offload_moments)
    st = to.init_offload_train_state(tl, tcfg, 0, optimizer=optimizer,
                                     offload_moments=offload_moments,
                                     device="cpu")
    st.params = tl.params_from_numpy(tree, device="cpu")
    tstep = to.make_offload_train_step(tl, tcfg, optimizer=optimizer,
                                       offload_grads=True,
                                       offload_moments=offload_moments)
    mu, nu = to.tree_map(torch.clone, st.mu), to.tree_map(torch.clone, st.nu)
    ref = tl.TrainState(tl.params_from_numpy(tree, device="cpu"), mu, nu,
                        torch.zeros((), dtype=torch.int32))
    for _ in range(2):
        jst, jloss = jstep(jst, jnp.asarray(toks))
        st, loss = tstep(st, torch.as_tensor(toks))
        ref, rloss = tl.train_step(ref, torch.as_tensor(toks), tcfg,
                                   optimizer=optimizer)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
        assert loss.item() == rloss.item()
    _assert_trees_close(st.params, jst.params, 1e-4)
    _assert_trees_close(st.nu, jst.nu, 1e-4)
    for a, b in zip(to.tree_leaves(st.params), to.tree_leaves(ref.params)):
        assert torch.equal(a, b)
    assert int(st.step) == 2


def test_cpu_has_no_host_memory_space():
    """On the CPU the steps keep everything in place, as the JAX package's
    CPU backend does; supports_compiled_host_memory is False in both."""
    assert not jo.supports_compiled_host_memory()
    assert not to.supports_host_memory("cpu")
    assert not to.supports_compiled_host_memory("cpu")
    st = to.init_offload_train_state(tl, _configs()[1], 0, device="cpu")
    assert all(t.device.type == "cpu" and not t.is_pinned()
               for t in to.tree_leaves(st.mu))
    assert to.pinned_bytes(st.mu) == 0


def test_example_layerwise_runs_on_the_cpu():
    """``llama_pretrain --layerwise`` runs the layer-wise step and prints a
    finite loss and tokens/s."""
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.llama_pretrain",
         "--size", "tiny", "--device", "cpu", "--layerwise", "--seq", "32",
         "--batch-size", "2", "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = [x for x in res.stdout.splitlines() if x.startswith("loss ")][-1]
    assert np.isfinite(float(line.split()[1]))
    assert "tokens/s" in res.stdout and "layer-wise" in res.stdout


def test_example_8b_single_chip_runs_a_cut_model_on_the_cpu():
    """``train_8b_single_chip`` takes --batch, --seq, --steps and
    --device; on the CPU (--layers cuts the depth, --size tiny the widths)
    it runs the streaming step and prints finite losses."""
    res = subprocess.run(
        [sys.executable, "-m",
         "paddle_tpu_torch.examples.train_8b_single_chip", "--device", "cpu",
         "--size", "tiny", "--batch", "2", "--seq", "32", "--steps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [x for x in res.stdout.splitlines() if "loss=" in x]
    assert len(lines) == 3
    assert all(np.isfinite(float(x.split("loss=")[1])) for x in lines)
