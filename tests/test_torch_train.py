"""The port's training path (paddle_tpu_torch.models.llama loss and
train_step, paddle_tpu_torch.optimizer.functional) held to the JAX package
on the CPU: the same numpy-made weights, gradients and tokens go through
both. The JAX flash attention runs its Pallas kernels (forward, dQ,
dK/dV) in interpret mode; the port runs their plain versions."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.optimizer import functional as jf
from paddle_tpu_torch.kernels import pallas_attention as tpa
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.optimizer import functional as tf
from paddle_tpu_torch.serving import LLMEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 3e-4


def _np(x):
    """A JAX array or a torch tensor as a float32 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_trees_close(got, want, rel, atol=0.0):
    """Every leaf of the torch tree ``got`` within ``rel`` of the largest
    magnitude of the matching JAX leaf (plus ``atol``)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_close(got[k], want[k], rel, atol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=atol + rel * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    """A stacked [2, 16, 24] matrix (factored by adafactor), a [24] vector
    and a plain [8, 12] matrix."""
    return {"layers": {"w": rng.standard_normal((2, 16, 24)),
                       "b": rng.standard_normal((24,))},
            "m": rng.standard_normal((8, 12))}


@pytest.mark.parametrize("optimizer,moment_dtype,param_dtype", [
    ("adamw", "float32", "float32"), ("adamw", "bfloat16", "float32"),
    ("adafactor", "float32", "float32"), ("adamw", "float32", "bfloat16"),
    ("adafactor", "float32", "bfloat16")])
def test_optimizer_update_matches_reference(optimizer, moment_dtype,
                                            param_dtype):
    """Three steps of optimizer_update over the same params and grads
    (grads in the params' dtype, a clip scale of 0.7): f32 storage within
    1e-5 of each leaf's max (the f32 math sums in another order); bf16
    storage within two bf16 ulps, for a rounding that lands on the other
    side of a tie."""
    rng = np.random.default_rng(0)
    jdt, tdt = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    jmd, tmd = getattr(jnp, moment_dtype), getattr(torch, moment_dtype)
    tree = _opt_tree(rng)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
    tp = tf.tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32)
                     .to(tdt), tree)
    jmu, jnu = jf.init_moments(jp, optimizer, jmd)
    tmu, tnu = tf.init_moments(tp, optimizer, tmd)
    kw = dict(optimizer=optimizer, lr=1e-2, beta1=0.9, beta2=0.95,
              eps=1e-8, wd=0.1)
    for step in range(3):
        grads = _opt_tree(rng)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), grads)
        tg = tf.tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32)
                         .to(tdt), grads)
        jp, jmu, jnu = jf.optimizer_update(jp, jg, jmu, jnu,
                                           jnp.int32(step), scale=0.7, **kw)
        tp, tmu, tnu = tf.optimizer_update(
            tp, tg, tmu, tnu, torch.tensor(step, dtype=torch.int32),
            scale=torch.tensor(0.7), **kw)
    assert all(t.dtype == tdt for t in tf.tree_leaves(tp))
    rel = 8e-3 if param_dtype == "bfloat16" else 1e-5
    _assert_trees_close(tp, jp, rel)
    _assert_trees_close(tnu, jnu, 8e-3 if moment_dtype == "bfloat16"
                        else 1e-5)
    if optimizer == "adamw":
        assert all(t.dtype == tmd for t in tf.tree_leaves(tmu))
        _assert_trees_close(tmu, jmu, 8e-3 if moment_dtype == "bfloat16"
                            else 1e-5)
    else:
        assert all(t.shape == () for t in tf.tree_leaves(tmu))
        assert set(tnu["layers"]["w"]) == {"vr", "vc"}
        assert set(tnu["layers"]["b"]) == {"v"}


def test_init_train_state_matches_reference_shapes():
    """adafactor with bf16 params: the params, the scalar mu placeholders
    and the factored nu have the reference's shapes and dtypes; the step is
    a 0-d int32 tensor."""
    jcfg, tcfg = _configs()
    want = jax.eval_shape(lambda key: jl.init_train_state(
        jcfg, key, optimizer="adafactor", param_dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    st = tl.init_train_state(tcfg, optimizer="adafactor",
                             param_dtype=torch.bfloat16, device="cpu")
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
    assert st.step.dtype == torch.int32 and st.step.shape == ()


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

def _configs(**kw):
    """2 layers, hidden 256, 2 query heads over 1 kv head of 128, f32,
    flash attention and full remat (JAX runs its Pallas kernels)."""
    base = dict(vocab_size=128, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                max_seq_len=256, use_flash=True, remat=True, **kw)
    return (jl.LlamaConfig(dtype=jnp.float32, **base),
            tl.LlamaConfig(dtype=torch.float32, **base))


def _tokens(seed, B=2, S=128, vocab=128):
    return np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def reference_run():
    """Weights from the JAX init; its grads at the first step and its
    state after one and three AdamW steps on one fixed batch."""
    jcfg, _ = _configs()
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    toks = _tokens(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jl.loss_fn(p, t, jcfg)))(jp, jnp.asarray(toks))
    mu, nu = jf.init_moments(jp, "adamw")
    state = jl.TrainState(jp, mu, nu, jnp.zeros((), jnp.int32))
    step = jax.jit(lambda s, t: jl.train_step(s, t, jcfg, lr=LR))
    states, losses = [], []
    for _ in range(3):
        state, l = step(state, jnp.asarray(toks))
        states.append(state)
        losses.append(float(l))
    return dict(tree=tree, tokens=toks, loss=float(loss), grads=grads,
                states=states, losses=losses)


def _port_state(tree):
    params = tl.params_from_numpy(tree, device="cpu")
    mu, nu = tf.init_moments(params, "adamw")
    return tl.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))


def test_loss_and_grads_match_reference(reference_run):
    """Loss within 1e-5 relative; each gradient leaf within 1e-4 of its
    largest magnitude."""
    _, tcfg = _configs()
    params = tl.params_from_numpy(reference_run["tree"], device="cpu")
    loss, grads = tl.loss_and_grads(
        params, torch.as_tensor(reference_run["tokens"]), tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - reference_run["loss"]) \
        <= 1e-5 * abs(reference_run["loss"])
    _assert_trees_close(grads, reference_run["grads"], 1e-4)


def _assert_params_close(got, want, grads, n_steps):
    """New params within 1e-6 + 1e-2*lr of the reference's, except where
    a gradient is within f32 noise of 0: there the two frameworks'
    gradients differ in sign or in size against eps (1e-8), so AdamW's
    update u = m/(sqrt(v)+eps) may take any size up to its bound, and such
    an element is held to 2*lr a step. After one step these are exactly
    the elements whose gradient is below 1e-5 of its leaf's largest (an
    exact 0, an embedding row no token reads, is 0 on both sides); over
    more steps a gradient may pass near 0 later, so there they are held to
    be under one in a thousand of each leaf."""
    for k in want:
        if isinstance(want[k], dict):
            _assert_params_close(got[k], want[k], grads[k], n_steps)
            continue
        g, w, gr = _np(got[k]), _np(want[k]), np.abs(_np(grads[k]))
        err = np.abs(g - w)
        off = err > 1e-6 + 1e-2 * LR
        assert off.mean() < 1e-3, (k, off.sum())
        assert err.max() <= 2 * LR * n_steps, k
        if n_steps == 1:
            noise = (gr > 0) & (gr < 1e-5 * gr.max())
            assert not (off & ~noise).any(), k


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_reference(reference_run, n_steps):
    """One and three AdamW steps: the losses within 1e-5 relative, the new
    params within 1e-6 + 1e-2*lr (elements whose gradient is noise around
    0: _assert_params_close), the moments within 1e-4 of each leaf's max,
    the step count equal."""
    _, tcfg = _configs()
    state = _port_state(reference_run["tree"])
    toks = torch.as_tensor(reference_run["tokens"])
    for i in range(n_steps):
        state, loss = tl.train_step(state, toks, tcfg, lr=LR)
        want = reference_run["losses"][i]
        assert abs(loss.item() - want) <= 1e-5 * abs(want)
    ref = reference_run["states"][n_steps - 1]
    assert int(state.step) == int(ref.step) == n_steps
    _assert_params_close(state.params, ref.params, reference_run["grads"],
                         n_steps)
    _assert_trees_close(state.mu, ref.mu, 1e-4)
    _assert_trees_close(state.nu, ref.nu, 1e-4)


def test_train_step_leaves_its_input_state_alone(reference_run):
    _, tcfg = _configs()
    state = _port_state(reference_run["tree"])
    before = tf.tree_map(torch.clone, state.params)
    new, _ = tl.train_step(state, torch.as_tensor(reference_run["tokens"]),
                           tcfg)
    assert int(state.step) == 0 and int(new.step) == 1
    for a, b in zip(tf.tree_leaves(state.params), tf.tree_leaves(before)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# port-side equalities: remat, chunked loss, gradient accumulation
# ---------------------------------------------------------------------------

def _small(**kw):
    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, max_seq_len=64, dtype=torch.float32,
                         remat=False)
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="module")
def small_run():
    cfg = _small()
    params = tl.init_params(cfg, seed=3, device="cpu")
    toks = torch.as_tensor(_tokens(4, B=4, S=32, vocab=64))
    return cfg, params, toks, tl.loss_and_grads(params, toks, cfg)


@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
def test_remat_policies_equal_no_remat(small_run, monkeypatch, policy):
    """Recomputing each layer in the backward pass changes no number.
    Under "full" the attention forward runs twice a layer (once again in
    the backward pass); under "attn" once, its outputs kept."""
    cfg, params, toks, (loss, grads) = small_run
    calls = []
    plain = tpa.flash_attention_fwd_plain
    monkeypatch.setattr(tpa, "flash_attention_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    rl, rg = tl.loss_and_grads(
        params, toks, dataclasses.replace(cfg, remat=True,
                                          remat_policy=policy))
    assert abs(rl.item() - loss.item()) <= 1e-6
    _assert_trees_close(rg, tf.tree_map(_np, grads), 1e-6)
    if policy != "dots":
        assert len(calls) == (2 if policy == "full" else 1) * cfg.num_layers


def test_chunked_loss_equals_dense(small_run):
    cfg, params, toks, (loss, grads) = small_run
    cl, cg = tl.loss_and_grads(params, toks,
                               dataclasses.replace(cfg, loss_chunks=4))
    assert abs(cl.item() - loss.item()) <= 1e-6
    _assert_trees_close(cg, tf.tree_map(_np, grads), 1e-6)


def test_grad_accumulation_matches_full_batch(small_run):
    """accum_steps=2 over two half batches equals the full batch: the mean
    of the halves' mean losses is the full mean (equal halves)."""
    cfg, params, toks, _ = small_run
    mu, nu = tf.init_moments(params, "adamw")
    st = tl.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))
    s_full, l_full = tl.train_step(st, toks, cfg)
    s_acc, l_acc = tl.train_step(st, toks, cfg, accum_steps=2)
    assert abs(l_full.item() - l_acc.item()) <= 1e-6
    _assert_params_close(s_acc.params, tf.tree_map(_np, s_full.params),
                         small_run[3][1], 1)


def test_adafactor_bf16_train_step_lowers_the_loss():
    """The 2.6b recipe (adafactor, bf16 params, full remat) at a tiny size:
    the loss on one repeated batch falls."""
    cfg = _small(remat=True, dtype=torch.bfloat16)
    st = tl.init_train_state(cfg, seed=1, optimizer="adafactor",
                             param_dtype=torch.bfloat16, device="cpu")
    toks = torch.as_tensor(_tokens(5, B=2, S=32, vocab=64))
    losses = []
    for _ in range(4):
        st, loss = tl.train_step(st, toks, cfg, optimizer="adafactor",
                                 lr=1e-2)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(t.dtype == torch.bfloat16 for t in tf.tree_leaves(st.params))


# ---------------------------------------------------------------------------
# tied embeddings (the fault this slice repairs)
# ---------------------------------------------------------------------------

def test_tied_embeddings_match_reference():
    """A tied JAX tree has no lm_head: params_from_numpy used to raise
    KeyError('lm_head') on it and forward always read lm_head. Now the tree
    loads, forward and the loss use embed.T, and logits, loss and grads
    (embed's from both of its uses) match the reference."""
    jcfg = dataclasses.replace(jl.tiny_llama(vocab=64, hidden=64),
                               dtype=jnp.float32, tie_embeddings=True)
    tcfg = dataclasses.replace(tl.tiny_llama(vocab=64, hidden=64),
                               dtype=torch.float32, tie_embeddings=True)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(2))
    assert "lm_head" not in jp
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = tl.params_from_numpy(tree, device="cpu")
    assert "lm_head" not in tp
    assert tl.num_params(tp) == jl.num_params(jp)
    toks = _tokens(6, B=2, S=24, vocab=64)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks[:, :-1]), jcfg))
    got = tl.forward(tp, torch.as_tensor(toks[:, :-1]), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(jp, jnp.asarray(toks),
                                                   jcfg)
    loss, grads = tl.loss_and_grads(tp, torch.as_tensor(toks), tcfg)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_trees_close(grads, jgrads, 1e-4)
    untied = {k: v for k, v in tree.items() if k != "embed"}
    with pytest.raises(KeyError, match="embed"):
        tl.params_from_numpy(untied, device="cpu")


def test_tied_engine_streams_equal_untied_with_embed_transposed():
    """The serving engine reads the head through head_weight too: a tied
    model serves the same greedy streams as an untied one whose lm_head is
    embed.T."""
    cfg = dataclasses.replace(tl.tiny_llama(vocab=64, hidden=32, heads=4,
                                            kv_heads=2, ffn=64),
                              dtype=torch.float32)
    tied_cfg = dataclasses.replace(cfg, tie_embeddings=True)
    tied = tl.init_params(tied_cfg, seed=7, device="cpu")
    untied = dict(tied, lm_head=tied["embed"].t().contiguous())
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
    streams = []
    for params, c in ((tied, tied_cfg), (untied, cfg)):
        eng = LLMEngine(params, c, max_slots=2, block_size=8,
                        max_model_len=32, prompt_buckets=[8],
                        decode_steps=2, device="cpu")
        ids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
        out = eng.run()
        streams.append([out[i] for i in ids])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# what is not ported raises
# ---------------------------------------------------------------------------

def test_unported_training_paths_raise(small_run):
    cfg, params, toks, _ = small_run
    mu, nu = tf.init_moments(params, "adamw")
    st = tl.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="A10"):    # 1F1B / ZB
        tl.train_step(st, toks, dataclasses.replace(
            cfg, pipeline_microbatches=2))
    with pytest.raises(NotImplementedError, match="A10"):
        tl.train_step(st, toks, dataclasses.replace(
            cfg, context_parallel=True))
    # the reference config's pipeline fields exist (ROADMAP fault C1) and
    # raise naming A10 when set
    for kw in (dict(pipeline_chunks=2), dict(pipeline_schedule="1f1b")):
        with pytest.raises(NotImplementedError, match="A10"):
            tl.train_step(st, toks, dataclasses.replace(cfg, **kw))
    tl.LlamaConfig(pipeline_chunks=1, pipeline_schedule="gpipe")
    with pytest.raises(ValueError, match="remat_policy"):
        tl.loss_fn(params, toks, dataclasses.replace(
            cfg, remat=True, remat_policy="everything"))
    with pytest.raises(ValueError, match="array batch"):
        tl.train_step(st, (toks, toks), cfg, accum_steps=2,
                      loss_function=lambda p, t, c: torch.zeros(()))
    with pytest.raises(ValueError, match="accum_steps"):
        tl.train_step(st, toks[:3], cfg, accum_steps=2)
    with pytest.raises(ValueError, match="loss_chunks"):
        tl.loss_fn(params, toks, dataclasses.replace(cfg, loss_chunks=5))
    with pytest.raises(ValueError, match="optimizer"):
        tl.train_step(st, toks, cfg, optimizer="sgd")


def test_flops_per_token_matches_reference():
    for jcfg, tcfg in (_configs(), _configs(tie_embeddings=True)):
        assert tl.flops_per_token(tcfg, 2048) == jl.flops_per_token(jcfg,
                                                                    2048)
    size = dict(vocab_size=32768, hidden_size=3072, intermediate_size=8192,
                num_layers=24, num_heads=24, num_kv_heads=8, head_dim=128,
                max_seq_len=2048)
    assert tl.flops_per_token(tl.LlamaConfig(**size), 2048) \
        == jl.flops_per_token(jl.LlamaConfig(**size), 2048)


def test_pretrain_entry_point_runs_on_cpu_and_rejects_unported_flags(
        capsys):
    from paddle_tpu_torch.examples import llama_pretrain
    loss = llama_pretrain.main(["--size", "tiny", "--steps", "2",
                                "--batch-size", "2", "--seq", "32",
                                "--optimizer", "adafactor", "--bf16-params",
                                "--device", "cpu"])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "loss" in out and "tokens/s on cpu" in out
    # --dp/--tp run on a mesh (tests/test_torch_data_parallel.py); the
    # axes not ported yet raise naming their queue
    for flags, queue in ((["--sp", "2"], "A10.4"), (["--pp", "2"], "A10.3"),
                         (["--microbatches", "4"], "A10.3")):
        with pytest.raises(NotImplementedError, match=queue):
            llama_pretrain.main(["--size", "tiny", "--device", "cpu",
                                 *flags])
    # the layer-wise optimizer (optimizer/offload.py) is ported: it runs
    loss = llama_pretrain.main(["--size", "tiny", "--device", "cpu",
                                "--layerwise", "--steps", "1",
                                "--batch-size", "2", "--seq", "32"])
    assert np.isfinite(loss)
    assert "layer-wise" in capsys.readouterr().out


def test_adafactor_eps2_floors_the_step_size():
    """adafactor moves each element by max(eps2, lr) times an update of
    RMS at most 1: the default floor (the JAX package's 1e-3) overrides a
    smaller lr; with the floor at 0 the step is lr."""
    rng = np.random.default_rng(1)
    params = tf.tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32),
                         _opt_tree(rng))
    grads = tf.tree_map(lambda a: torch.as_tensor(a, dtype=torch.float32),
                        _opt_tree(rng))
    mu, nu = tf.init_moments(params, "adafactor")
    step = torch.zeros((), dtype=torch.int32)
    moves = {}
    for eps2 in (1e-3, 0.0):
        new, _, _ = tf.optimizer_update(params, grads, mu, nu, step,
                                        optimizer="adafactor", lr=1e-5,
                                        wd=0.0, adafactor_eps2=eps2)
        moves[eps2] = max((a - b).abs().max().item() for a, b in zip(
            tf.tree_leaves(new), tf.tree_leaves(params)))
    assert 3e-4 < moves[1e-3] <= 1e-2
    assert 3e-6 < moves[0.0] <= 1e-4
