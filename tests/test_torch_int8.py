"""The port's int8 serving and int8-expert paths held to the JAX package
on the CPU, on the same numpy-made weights and inputs:

- the plain ``mega_decode_step`` with int8 weights (``quantize_params``),
  int8 pools and both, against the JAX ``mega_decode_step`` (Pallas in
  interpret mode), f32 within 1e-5;
- greedy streams of the port's ragged and mega engines with int8 weights
  and ``kv_dtype="int8"`` against the JAX ``LLMEngine(kv_dtype="int8")``,
  decode_steps 1 and 4, a pool small enough to preempt, f32;
- the plain B9 with an int8 rhs against the reference's widening route,
  ``fused_moe_ffn`` and ``moe.forward`` with int8
  experts against the reference (f32 1e-5 / logits 1e-4), and the int8
  leaves' frozen gradients.

The CUDA kernels are held to these plain versions in
test_torch_kernels_cuda.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu.kernels import moe_fused as jmf
from paddle_tpu.kernels import quant_matmul as jqm
from paddle_tpu.kernels.mega_decode import mega_decode_step as jax_mega_step
from paddle_tpu.models import llama as jl
from paddle_tpu.models import moe as jm
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu_torch.kernels import mega_decode as tmd
from paddle_tpu_torch.kernels import moe_dispatch as tmdisp
from paddle_tpu_torch.kernels import moe_fused as tmf
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import moe as tm
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
ENGINE = dict(max_slots=2, block_size=8, max_model_len=64, num_blocks=6,
              prompt_buckets=[8, 32])


def _tree(a):
    return jax.tree_util.tree_map(np.asarray, a)


def _close(got, want, rel):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=rel * float(np.abs(w).max()))


@pytest.fixture(scope="module")
def model():
    """tiny_llama in f32 with quantize_params weights (bf16 scales) in
    both packages."""
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jq = jl.quantize_params(jl.init_params(jcfg, jax.random.PRNGKey(0)))
    tq = tl.params_from_numpy(_tree(jq), device="cpu")
    return jcfg, jq, tcfg, tq


def _step_inputs(seed, t, kv_int8):
    """One step's inputs for 3 slots (walk lengths 5, 0 and the full
    table), as test_torch_mega_decode.py builds them, with the pools
    quantized (``quantize_kv``) when ``kv_int8``."""
    rng = np.random.default_rng(seed)
    N, L, S, Hkv, D, bs, mb = 3, 2, 4, 2, 8, 4, 4
    nb = N * mb + 1
    walk = np.array([5, 0, mb * bs], np.int32)
    arrays = dict(
        x0=rng.standard_normal((N, 32)).astype(np.float32),
        ring_k=rng.standard_normal((L, N, S, Hkv, D)).astype(np.float32),
        ring_v=rng.standard_normal((L, N, S, Hkv, D)).astype(np.float32))
    pools = {k: rng.standard_normal((L, nb, bs, Hkv, D)).astype(np.float32)
             for k in ("k_pool", "v_pool")}
    if kv_int8:
        qk, sk = jqm.quantize_kv(jnp.asarray(pools["k_pool"]))
        qv, sv = jqm.quantize_kv(jnp.asarray(pools["v_pool"]))
        pools = dict(k_pool=qk, v_pool=qv, ks_pool=sk, vs_pool=sv)
    ints = dict(block_table=rng.permutation(np.arange(1, nb))
                .reshape(N, mb).astype(np.int32),
                walk_lens=walk, lens=walk + 2)
    ints.update({k: np.asarray(v) for k, v in pools.items()})
    return arrays, ints


@pytest.mark.parametrize("t", [0, 2])
@pytest.mark.parametrize("w_int8,kv_int8", [(True, False), (False, True),
                                            (True, True)])
def test_plain_int8_step_matches_jax_mega_decode_step(model, w_int8,
                                                      kv_int8, t):
    """The hidden state and both rings after one step of all layers with
    int8 weights, int8 pools or both, f32, within 1e-5 (values are O(1));
    ring rows of other steps stay."""
    jcfg, jq, tcfg, tq = model
    jp, tp = jq, tq
    if not w_int8:
        jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tl.params_from_numpy(_tree(jp), device="cpu")
    arrays, ints = _step_inputs(7 + t, t, kv_int8)
    want = jax_mega_step(
        jp, jcfg, t=t, **{k: jnp.asarray(v) for k, v in arrays.items()},
        **{k: jnp.asarray(v) for k, v in ints.items()})
    got = tmd.mega_decode_step(
        tp, tcfg, t=t, **{k: torch.as_tensor(v) for k, v in arrays.items()},
        **{k: torch.as_tensor(v) for k, v in ints.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    keep = [s for s in range(4) if s != t]
    assert np.array_equal(got[1].numpy()[:, :, keep],
                          arrays["ring_k"][:, :, keep])


def _prompts(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(k)).tolist()
            for k in rng.integers(3, 20, size=n)]


def _port_streams(tq, tcfg, kernel, prompts, decode_steps, monkeypatch):
    eng = LLMEngine(tq, tcfg, decode_steps=decode_steps, decode_kernel=kernel,
                    kv_dtype="int8", device="cpu", **ENGINE)
    preempted = []
    free_slot = eng._free_slot

    def counting_free_slot(slot, requeue=False):
        preempted.append(requeue)
        return free_slot(slot, requeue)

    monkeypatch.setattr(eng, "_free_slot", counting_free_slot)
    ids = [eng.add_request(p, max_new_tokens=16) for p in prompts]
    out = eng.run()
    assert any(preempted), "the pool was meant to force a preemption"
    assert eng.block_accounting() == {"total": 6, "free": 6, "backed": 0}
    assert dict(eng.decode_paths) == {kernel: eng.decode_paths[kernel]}
    assert not eng.mega_fallbacks
    return [out[i] for i in ids], eng


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_int8_streams_equal_jax_engine(model, decode_steps, monkeypatch):
    """int8 weights and int8 pools, f32 activations, more requests than
    slots and a pool small enough to preempt: the port's ragged and mega
    engines and the JAX engine with ``kv_dtype="int8"`` agree token for
    token."""
    jcfg, jq, tcfg, tq = model
    prompts = _prompts()
    jax_eng = JaxEngine(jq, jcfg, decode_steps=decode_steps,
                        decode_kernel="bucketed", kv_dtype="int8", **ENGINE)
    jids = [jax_eng.add_request(p, max_new_tokens=16) for p in prompts]
    jout = jax_eng.run()
    want = [jout[j] for j in jids]
    ragged, eng = _port_streams(tq, tcfg, "ragged", prompts, decode_steps,
                                monkeypatch)
    assert eng.pools["k"].dtype == torch.int8
    assert eng.pools["ks"].shape == eng.pools["k"].shape[:-1]
    # the tiny model's head_dim 8 is outside the CUDA kernel's screen; the
    # plain version takes any head_dim, so let the screen pass here
    monkeypatch.setattr(teng, "mega_supported", lambda *a, **k: (True, "ok"))
    mega, _ = _port_streams(tq, tcfg, "mega", prompts, decode_steps,
                            monkeypatch)
    assert ragged == mega == want


def test_int8_screen_takes_int8_weights_and_pools():
    """mega_supported takes int8 weights (int8 matrices, bf16 scales) and
    int8 pools, each alone or both; it still refuses mixed weights and
    other scale dtypes."""
    cfg = dataclasses.replace(tl.tiny_llama(hidden=256, heads=4, kv_heads=2,
                                            ffn=512), dtype=torch.float32)
    params = tl.init_params(cfg, seed=0, device="cpu")
    q8 = tl.quantize_params(params)
    kw = dict(n_slots=2, n_steps=3, block_size=8)
    for p in (params, q8):
        for kv_int8 in (False, True):
            assert tmd.mega_supported(p, cfg, kv_int8=kv_int8, **kw) \
                == (True, "ok")
    mixed = dict(q8, layers=dict(q8["layers"], wq=params["layers"]["wq"]))
    assert tmd.mega_supported(mixed, cfg, kv_int8=False, **kw) \
        == (False, "mixed_weights")
    lay = {k: (dict(v, s=v["s"].float()) if isinstance(v, dict) else v)
           for k, v in q8["layers"].items()}
    assert tmd.mega_supported(dict(q8, layers=lay), cfg, kv_int8=False,
                              **kw) == (False, "dtype")


# ---------------------------------------------------------------------------
# int8 experts
# ---------------------------------------------------------------------------

def _ffn_arrays(seed=21, T=24, h=128, E=4, f=64, k=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((T, h), 1.0), ((h, E), 0.3), ((E, h, f), 0.1), ((E, h, f), 0.1),
        ((E, f, h), 0.1), ((T, h), 1.0))]


def _quantized(eg, eu, ed):
    """The experts as int8 leaves of both packages (the JAX package's
    quantize_grouped, carried over through numpy)."""
    j = (jqm.quantize_grouped(jnp.asarray(eg), 1),
         jqm.quantize_grouped(jnp.asarray(eu), 1),
         jqm.quantize_grouped(jnp.asarray(ed), 2))
    t = tuple({k: torch.as_tensor(np.asarray(v)) for k, v in leaf.items()}
              for leaf in j)
    return j, t


def test_plain_int8_gather_gmm_matches_jax_widening():
    """B9's plain version with an int8 rhs on the reference's padded
    layout (8-row tiles) against the reference's int8 route: the gathered
    rows times the int8 rhs widened to the rows' dtype (``jmf._grouped``,
    ragged_dot; the JAX test's own interpret-mode run of the Pallas kernel
    is skipped on this jax), f32 within 1e-5 on the valid rows."""
    x, rw, eg, eu, ed, _ = _ffn_arrays()
    T, k, E = x.shape[0], 2, eg.shape[0]
    r = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), k)
    inv2d = jmf._inverse_permutation(r.order).reshape(T, k)
    tok_pad, _, _, _, gs_pad = jmf._pad_layout(
        r.gs, r.tok, r.weights.reshape(T * k)[r.order], r.flat_e[r.order],
        inv2d, E, tm=8)
    gid = jmf._tile_gids(gs_pad, tok_pad.shape[0], 8)
    rhs = jqm.quantize_grouped(jnp.asarray(np.concatenate([eg, eu], -1)),
                               1)["q"]
    want = jax.lax.ragged_dot(jnp.take(jnp.asarray(x), tok_pad, axis=0),
                              rhs.astype(jnp.float32), gs_pad)
    got = tmf.gather_gmm(*(torch.from_numpy(np.array(a)) for a in (
        x, tok_pad, rhs, gid)), tm=8)
    n = int(np.asarray(gs_pad).sum())
    _close(got[:n], np.asarray(want)[:n], 1e-5)


@pytest.mark.parametrize("form", ["fused", "gmm"])
def test_int8_fused_moe_ffn_matches_jax(form):
    """``fused_moe_ffn`` (the padded pipeline with B9's int8 branch) with
    int8 experts against the reference's ``fused_moe_ffn``: y and x's
    gradient within 1e-5 (f32); the port's gmm form with the same int8
    leaves agrees too. The int8 leaves get no gradient."""
    x, rw, eg, eu, ed, ct = _ffn_arrays(seed=22)
    (jg, ju, jd), (tg, tu, td) = _quantized(eg, eu, ed)
    jr = jmd.fused_routing(jnp.asarray(x), jnp.asarray(rw), 2)

    def jloss(xx):
        return jnp.sum(jmf.fused_moe_ffn(xx, jr.weights, jr.idx, jg, ju, jd,
                                         routing=jr) * jnp.asarray(ct))
    want_y = jmf.fused_moe_ffn(jnp.asarray(x), jr.weights, jr.idx, jg, ju,
                               jd, routing=jr)
    want_dx = jax.grad(jloss)(jnp.asarray(x))
    # the routing is a constant of both losses, as jr is of jloss
    tr = tmdisp.fused_routing(torch.as_tensor(x), torch.as_tensor(rw), 2)
    tx = torch.as_tensor(x).requires_grad_(True)
    fn = tmdisp.dropless_moe_ffn_fused if form == "fused" \
        else tmdisp.dropless_moe_ffn
    tmf.fused_paths.clear()
    y = fn(tx, tr.weights, tr.idx, tg, tu, td, routing=tr)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(ct)).sum(), (tx,))
    _close(y, want_y, 1e-5)
    _close(dx, want_dx, 1e-5)
    if form == "fused":
        assert dict(tmf.fused_paths) == {"padded": 1}
    assert not any(t.requires_grad for w in (tg, tu, td) for t in w.values())


def test_int8_grad_flows_scales_frozen():
    """As tests/test_moe_dispatch.py::test_int8_grad_flows_scales_frozen:
    x's gradient through int8 experts tracks the dense one (within 5% of
    its largest magnitude), and scales made to require a gradient receive
    none — the port detaches q and s at the use site."""
    x, rw, eg, eu, ed, ct = (torch.as_tensor(a)
                             for a in _ffn_arrays(seed=23))
    qg, qu, qd = (tqm.quantize_grouped(eg, 1), tqm.quantize_grouped(eu, 1),
                  tqm.quantize_grouped(ed, 2))
    sg = qg["s"].clone().requires_grad_(True)
    sd = qd["s"].clone().requires_grad_(True)
    r = tmdisp.fused_routing(x, rw, 2)
    x8 = x.clone().requires_grad_(True)
    y8 = tmf.fused_moe_ffn(x8, r.weights, r.idx, dict(qg, s=sg), qu,
                           dict(qd, s=sd), routing=r)
    loss8 = (y8 * ct).sum()
    assert not loss8.grad_fn is None
    g8 = torch.autograd.grad(loss8, (x8, sg, sd), allow_unused=True)
    assert g8[1] is None and g8[2] is None
    x16 = x.clone().requires_grad_(True)
    y16 = tmf.fused_moe_ffn(x16, r.weights, r.idx, eg, eu, ed, routing=r)
    (g16,) = torch.autograd.grad((y16 * ct).sum(), (x16,))
    scale = g16.abs().max().item()
    assert (g8[0] - g16).abs().max().item() < 0.05 * scale


def _moe_configs(**kw):
    base = dict(vocab=64, hidden=128, layers=2, heads=4, experts=8, top_k=2,
                seq=64)
    j = dataclasses.replace(jm.tiny_moe(**base), first_dense_layers=1,
                            dtype=jnp.float32, **kw)
    t = dataclasses.replace(tm.tiny_moe(**base), first_dense_layers=1,
                            dtype=torch.float32, **kw)
    return j, t


def test_int8_moe_forward_matches_jax():
    """moe.forward with quantize_expert_params on tiny_moe (hidden 128,
    layer 0 dense, f32): the quantized leaves equal the reference's, the
    logits within 1e-4 of their largest magnitude and the aux loss within
    1e-5; ``expert_dtype="int8"`` quantizes, None leaves the params as
    they are, and capacity routing refuses int8 experts."""
    jcfg, tcfg = _moe_configs(expert_dtype="int8")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(1))
    jq = jm.quantize_expert_params(jp, jcfg)
    tp = tm.params_from_numpy(_tree(jp), device="cpu")
    tq = tm.quantize_expert_params(tp, tcfg)
    for k in ("e_gate", "e_up", "e_down"):
        for part in ("q", "s"):
            np.testing.assert_array_equal(tq["layers"][k][part].numpy(),
                                          np.asarray(jq["layers"][k][part]))
    assert tm.params_from_numpy(_tree(jq), device="cpu")["layers"][
        "e_gate"]["q"].dtype == torch.int8
    toks = np.random.default_rng(5).integers(0, 64, (2, 16)).astype(np.int32)
    jlog, jaux = jm.forward(jq, jnp.asarray(toks), jcfg, return_aux=True)
    tlog, taux = tm.forward(tq, torch.as_tensor(toks), tcfg, return_aux=True)
    _close(tlog, jlog, 1e-4)
    assert abs(taux.item() - float(jaux)) <= 1e-5
    assert tm.quantize_expert_params(tp, dataclasses.replace(
        tcfg, expert_dtype=None)) is tp
    with pytest.raises(ValueError, match="dropless"):
        tm.quantize_expert_params(tp, dataclasses.replace(
            tcfg, routing="capacity"))
    lp = {k: (v[1] if not isinstance(v, dict)
              else {kk: vv[1] for kk, vv in v.items()})
          for k, v in tq["layers"].items()}
    with pytest.raises(ValueError, match="dropless"):
        tm.moe_ffn(torch.zeros(4, 128), lp["router"], lp["e_gate"],
                   lp["e_up"], lp["e_down"],
                   dataclasses.replace(tcfg, routing="capacity"))


def test_serve_llm_example_int8_on_the_cpu():
    """The serving example's ``--int8`` (quantize_params weights) serves
    every request on the CPU when asked; without a card its default
    device raises."""
    from paddle_tpu_torch.examples import serve_llm
    argv = ["--int8", "--vocab", "64", "--hidden", "64", "--layers", "1",
            "--requests", "3", "--max-new", "4", "--max-len", "64",
            "--decode-steps", "2"]
    assert serve_llm.main(argv, device="cpu") == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_llm.main(argv)
