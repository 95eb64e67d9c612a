"""Tensor-parallel serving of the port (``LLMEngine(mesh=)`` over two gloo
ranks on the CPU) held to the JAX engine on its 2-device ``'tp'`` mesh and
to the unsharded engines of both packages, mirroring the JAX package's tp
tests with their configs, prompts and seeds:
tests/test_serving.py::test_tp_sharded_engine_matches_dense,
tests/test_serving_engine.py::test_tp_sharded_int8_engine_matches_unsharded,
::test_tp_sharded_ragged_decode_matches_unsharded (f32, bf16 at seed 5,
int8 KV), ::test_tp_sharded_ragged_int8_weights_matches_unsharded,
::test_tp_sharded_prefix_cache_chunked_matches_unsharded,
tests/test_spec_decode.py::test_spec_tp_sharded_parity and
tests/test_mega_decode.py::test_engine_mega_mesh_path_choice_counted /
::test_engine_mega_mesh_counted_fallback.

One spawn of two ranks (module fixture) serves every workload through the
port's tp engine (B4's tp form on each rank's kv heads, the Megatron
collectives) and runs B4's plain tp form on each rank's slice; the test
process runs the JAX engines and the port's unsharded engine. The JAX
engine's ragged walk under a mesh calls ``shard_map(axis_names=tuple)``,
which this jax refuses (TypeError), so its tp engine serves through its
bucketed walk here — the reference pins the two paths' greedy streams
equal.

Also: the port's ``param_specs``, ``make_serving_shardings`` (dense and
int8), ``_fit_spec`` and ``make_mesh``'s factorization against the
reference's, leaf for leaf."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu.kernels.paged_attention import ragged_decode_partial as jrdp
from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import llama as tl
from torch_dist_workers import (port_params, serve_case, spawn_ranks,
                                tp_serving_worker)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
ENG = dict(max_slots=2, block_size=8, max_model_len=64,
           prompt_buckets=[8, 32])


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=n).tolist() for n in sizes]


def _ragged_case(params, seed, **kw):
    return dict(params=params, prompts=_prompts(seed, (3, 9, 14)),
                n_new=[6, 5, 4],
                engine=dict(ENG, max_slots=3, decode_steps=3,
                            decode_kernel="ragged", **kw))


# each JAX tp test, as a workload: params kind, engine, prompts, budgets
CASES = {
    # test_serving.py:208 (the engine's default decode path)
    "engine_dense": dict(params="f32", prompts=_prompts(7, (4, 11)),
                         n_new=[6, 6], engine=dict(ENG)),
    # test_serving_engine.py:219
    "int8_weights": dict(params="int8w", prompts=_prompts(7, (4, 11)),
                         n_new=[6, 6], engine=dict(ENG)),
    # test_serving_engine.py:247, its three variants and seeds
    "ragged_f32": _ragged_case("f32", 11),
    "ragged_bf16": _ragged_case("bf16", 5),
    "ragged_int8kv": _ragged_case("f32", 11, kv_dtype="int8"),
    # test_serving_engine.py:287
    "ragged_int8_weights": dict(
        params="int8w", prompts=_prompts(1, (5, 13)), n_new=[5, 5],
        engine=dict(ENG, decode_steps=3, decode_kernel="ragged")),
    # test_serving_engine.py:310: a cache-hit resume of the same prompt
    "prefix_chunked": dict(
        params="f32", prompts=_prompts(5, (26,)), n_new=[4], rounds=2,
        engine=dict(ENG, decode_steps=2, kv_dtype="int8", prefix_cache=True,
                    prefill_chunk=8, decode_kernel="ragged")),
    # test_spec_decode.py:127: the draft (the target itself) replicated
    "spec": dict(params="f32", prompts=_prompts(6, (4, 9, 15)),
                 n_new=[8, 7, 10], spec=3,
                 engine=dict(ENG, max_model_len=128,
                             decode_kernel="ragged")),
    # test_mega_decode.py:246/269: mega bows out counted, reason "mesh"
    "mega_fallback": dict(params="f32", prompts=_prompts(2, (6,)), n_new=[4],
                          engine=dict(ENG, decode_steps=3,
                                      decode_kernel="mega")),
}

# B4 inputs: 8 query heads over 4 kv heads, mixed lengths, 2 pool layers
B4_BS, B4_MB = 4, 5


def _b4_inputs(seed, int8=False):
    rng = np.random.default_rng(seed)
    n, hkv, g, d = 4, 4, 2, 16
    nb = n * B4_MB + 1
    shape = (2, nb, B4_BS, hkv, d)
    q = rng.standard_normal((n, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = rng.permutation(np.arange(1, nb)).reshape(n, B4_MB)
    lens = np.asarray([0, 1, 2 * B4_BS + 3, B4_MB * B4_BS], np.int32)
    out = [q, kp, vp, table.astype(np.int32), lens]
    if int8:
        out[1] = rng.integers(-127, 128, shape).astype(np.int8)
        out[2] = rng.integers(-127, 128, shape).astype(np.int8)
        out += [rng.uniform(0.01, 0.1, shape[:4]).astype(np.float32),
                rng.uniform(0.01, 0.1, shape[:4]).astype(np.float32)]
    return out


B4 = {"f32": _b4_inputs(0), "bf16": _b4_inputs(1),
      "int8": _b4_inputs(2, int8=True)}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    params = jl.init_params(cfg, jax.random.PRNGKey(0))
    qparams = jax.jit(jl.quantize_params)(params)
    f32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    # int8 leaves' bf16 scales cross to the ranks widened (exact)
    q8 = jax.tree_util.tree_map(
        lambda a: np.asarray(a) if a.dtype == jnp.int8
        else np.asarray(a, np.float32), qparams)
    return cfg, params, qparams, {"f32": f32, "int8w": q8}


@pytest.fixture(scope="module")
def ranks(model, tmp_path_factory):
    trees = model[3]
    return spawn_ranks(tp_serving_worker, 2, tmp_path_factory.mktemp("tp"),
                       trees, SIZES, CASES, B4)


def _jax_model(model, kind):
    cfg, params, qparams, _ = model
    if kind == "bf16":
        return (dataclasses.replace(cfg, dtype=jnp.bfloat16),
                jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                       params))
    return cfg, (qparams if kind == "int8w" else params)


def _jax_streams(model, case, mesh=None):
    cfg, params = _jax_model(model, case["params"])
    kw = dict(case["engine"])
    if mesh is not None and kw.get("decode_kernel") == "ragged":
        kw["decode_kernel"] = "bucketed"     # module docstring
    if case.get("spec"):
        kw.update(draft_params=params, draft_config=cfg,
                  spec_tokens=case["spec"])
    eng = JaxEngine(params, cfg, mesh=mesh, **kw)
    streams = []
    for _ in range(case.get("rounds", 1)):
        ids = [eng.add_request(list(p), max_new_tokens=k)
               for p, k in zip(case["prompts"], case["n_new"])]
        out = eng.run()
        streams += [out[i] for i in ids]
    return streams


def _port_streams(model, case):
    kind = case["params"]
    cfg = dataclasses.replace(
        tl.tiny_llama(**SIZES),
        dtype=torch.bfloat16 if kind == "bf16" else torch.float32)
    params = port_params(model[3]["int8w" if kind == "int8w" else "f32"],
                         kind)
    return serve_case(params, cfg, case)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_streams_equal_jax_tp_and_unsharded(model, ranks, name):
    """The port's 2-rank tp streams == the JAX engine's on its 2-device
    'tp' mesh == both packages' unsharded engines, and every rank
    returns the same streams."""
    case = CASES[name]
    got = [r["cases"][name]["streams"] for r in ranks]
    assert got[0] == got[1], "the ranks' streams differ"
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    want_tp = _jax_streams(model, case, mesh)
    want = _jax_streams(model, case)
    port, _eng = _port_streams(model, case)
    assert want_tp == want
    assert port == want
    assert got[0] == want, (got[0], want)
    if name == "engine_dense":
        # test_serving.py holds this one to the dense generate path
        cfg, params = _jax_model(model, "f32")
        for p, k, s in zip(case["prompts"], case["n_new"], got[0]):
            toks = jnp.asarray(np.asarray(p, np.int32)[None])
            ref = jl.generate(params, toks, cfg, max_new_tokens=k,
                              temperature=0.0)
            assert s == np.asarray(ref)[0, len(p):].tolist()


def test_tp_engine_shards_and_collectives(ranks):
    """Each rank holds its kv-head half of the pools and its column half
    of wq; the collectives per decode step are the plan's: per layer two
    all-reduces, plus the embedding's, one logits all-gather and one
    token broadcast."""
    r0 = ranks[0]["cases"]
    assert r0["ragged_f32"]["pools"]["k"] == (2, 3 * 8 + 1, 8, 1, 8)
    assert r0["ragged_int8kv"]["pools"]["ks"] == (2, 3 * 8 + 1, 8, 1)
    assert r0["ragged_f32"]["wq"] == (2, 32, 16)
    assert r0["ragged_int8_weights"]["wq"] == (2, 32, 16)
    # the spec draft is replicated: its pools keep both kv heads
    assert r0["spec"]["pools"]["dk"][3] == 2
    c = r0["ragged_f32"]["collectives"]
    L = SIZES["layers"]
    assert c["all_gather"] == c["broadcast"]
    assert c["all_reduce"] == (2 * L + 1) * c["all_gather"]
    assert r0["spec"]["spec_waves"] > 0
    assert r0["prefix_chunked"]["prefix_hits"] >= 1


def test_tp_mega_bows_out_counted(ranks):
    """decode_kernel="mega" under the mesh falls back counted with
    reason "mesh" and never dispatches mega; the screen itself reads the
    DeviceMesh."""
    for r in ranks:
        case = r["cases"]["mega_fallback"]
        assert case["mega_fallbacks"].get("mesh", 0) >= 1
        assert "mega" not in case["decode_paths"]
        assert r["mega_screen"] == (False, "mesh")


def test_tp_refuses_what_the_reference_refuses(ranks):
    assert ranks[0]["odd_heads"] == "tp=2 must divide num_kv_heads=3"


def test_tp_engine_raises_when_the_group_cannot_carry_its_tensors(ranks):
    for r in ranks:
        assert "'gloo' process group cannot carry torch.float32" \
            in r["no_carry"]
        assert "takes no such tensor" in r["no_carry"]


def _ref_tp_partials(arrs):
    """The reference's tp form: its kernel (interpret mode) under a
    shard_map over 'tp' with its own in/out specs
    (paddle_tpu/kernels/paged_attention.py:506-534); its wrapper's own
    call passes axis_names as a tuple, which this jax refuses."""
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    pool_s = P(None, None, None, "tp", None)
    scale_s = P(None, None, None, "tp")
    args = [jnp.asarray(a) for a in arrs]
    int8 = len(arrs) > 5
    if int8:
        def inner(q, k, v, t, ln, ks, vs):
            return jrdp(q, k, v, t, ln, layer=1, ks_pool=ks, vs_pool=vs)
    else:
        inner = functools.partial(jrdp, layer=1)
    fn = jmd._shard_map(
        inner, mesh,
        in_specs=(P(None, "tp", None), pool_s, pool_s, P(), P())
        + ((scale_s, scale_s) if int8 else ()),
        out_specs=(P(None, "tp", None, None), P(None, "tp", None),
                   P(None, "tp", None)), axis_names=frozenset({"tp"}))
    sharded = [np.asarray(o) for o in fn(*args)]
    whole = [np.asarray(o) for o in jrdp(*args[:5], layer=1, **(
        dict(ks_pool=args[5], vs_pool=args[6]) if int8 else {}))]
    return sharded, whole


@pytest.mark.parametrize("form", list(B4))
def test_b4_tp_form_bit_equal(ranks, form):
    """B4's plain tp form: the two ranks' partials side by side are the
    unsharded call's bit for bit (the reference's contract,
    paged_attention.py:499-505), and agree with the reference's
    shard_mapped kernel in interpret mode (itself bit-equal to its
    unsharded call) within 1e-5, relative or absolute (the int8 walk's
    accumulators reach the hundreds)."""
    arrs = B4[form]
    got = [np.concatenate([r["b4"][form][i] for r in ranks], axis=1)
           for i in range(3)]
    q, kp, vp, table, lens = (torch.as_tensor(a) for a in arrs[:5])
    kw = {}
    if form == "bf16":
        q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    if form == "int8":
        kw = dict(ks_pool=torch.as_tensor(arrs[5]),
                  vs_pool=torch.as_tensor(arrs[6]))
    whole = tpa.ragged_decode_partial(q, kp, vp, table, lens, layer=1, **kw)
    for g, w in zip(got, whole):
        assert np.array_equal(g, w.numpy())
    if form == "bf16":
        return
    sharded, ref_whole = _ref_tp_partials(arrs)
    for s, w, g in zip(sharded, ref_whole, got):
        assert np.array_equal(s, w)
        np.testing.assert_allclose(g, s, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_b4_shard_schedule_is_the_whole_split(tp):
    """The kernel's tp form walks a shard on the whole launch's schedule:
    in the kernel's split mirror (its parts merged in part order), the
    shards' partials side by side are the whole split's bit for bit, at
    lengths whose long walks are cut into parts over many blocks."""
    rng = np.random.default_rng(tp)
    N, hkv, G, D, BS, MB = 8, 8, 4, 16, 16, 128
    nb = N * MB + 1
    kp = torch.as_tensor(rng.standard_normal((2, nb, BS, hkv, D))
                         .astype(np.float32))
    vp = torch.as_tensor(rng.standard_normal((2, nb, BS, hkv, D))
                         .astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((N, hkv * G, D))
                        .astype(np.float32))
    table = torch.as_tensor(rng.permutation(np.arange(1, nb))[:N * MB]
                            .reshape(N, MB).astype(np.int32))
    lens = torch.tensor([0, 1, 64, 2000, 777, 128, 1500, 33],
                        dtype=torch.int32)
    whole = tpa.ragged_decode_partial_split_plain(q, kp, vp, table, lens, 1)
    w = hkv // tp
    outs = [tpa.ragged_decode_partial_split_plain(
        tpa.shard_kv_heads(q, tp, r, 1), tpa.shard_kv_heads(kp, tp, r, 3),
        tpa.shard_kv_heads(vp, tp, r, 3), table, lens, 1, heads=hkv,
        h0=r * w) for r in range(tp)]
    for i in range(3):
        assert torch.equal(torch.cat([o[i] for o in outs], 1), whole[i])


def test_b4_mesh_form_raises_on_what_is_not_a_device_mesh():
    q, kp, vp, table, lens = (torch.as_tensor(a) for a in B4["f32"][:5])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpa.ragged_decode_partial(q, kp, vp, table, lens, mesh=object())
    with pytest.raises(ValueError, match="tp=3 must divide num_kv_heads=4"):
        tpa.shard_kv_heads(kp, 3, 0, 3)
    with pytest.raises(ValueError, match="rank 2 outside a 2-way split"):
        tpa.ragged_decode_shard(q, kp, vp, table, lens, tp=2, rank=2)


# ---------------------------------------------------------------------------
# the sharding recipe against the reference's
# ---------------------------------------------------------------------------
def _specs_equal(port, ref):
    """Leaf for leaf: the port's PartitionSpec tree against the
    reference's (PartitionSpecs or NamedShardings)."""
    if isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            _specs_equal(port[k], ref[k])
        return
    ref = getattr(ref, "spec", ref)
    assert tuple(port) == tuple(ref), (port, ref)


CFG_SHAPES = [dict(SIZES), dict(SIZES, vocab=66, ffn=72),
              dict(SIZES, heads=8, kv_heads=4, hidden=64, ffn=192)]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("tie", [False, True])
def test_param_specs_equal_reference(fsdp, tie):
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), tie_embeddings=tie)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), tie_embeddings=tie)
    _specs_equal(tl.param_specs(tcfg, fsdp), jl.param_specs(jcfg, fsdp))
    assert tuple(tl.act_spec()) == tuple(jl.act_spec())


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_equal_reference(n):
    assert tl.mesh_shape(n) == jl.make_mesh(n).devices.shape


@pytest.mark.parametrize("sizes", CFG_SHAPES)
@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 2), (1, 2, 4),
                                   (3, 1, 2)])
def test_shardings_equal_reference(sizes, shape):
    """make_shardings (fsdp) and make_serving_shardings (dense and int8)
    over meshes whose axes divide some dims and not others: _fit_spec
    drops the same axes, leaf for leaf."""
    n = int(np.prod(shape))
    jmesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                 ("dp", "sp", "tp"))
    tmesh = dict(zip(("dp", "sp", "tp"), shape))
    jcfg = dataclasses.replace(jl.tiny_llama(**sizes), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**sizes), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp_ = tl.init_params(tcfg, seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _specs_equal(tl.make_shardings(tcfg, tmesh),
                     jl.make_shardings(jcfg, jmesh))
        for fsdp in (False, True):
            _specs_equal(
                tl.make_serving_shardings(tp_, tcfg, tmesh, fsdp=fsdp),
                jl.make_serving_shardings(jp, jcfg, jmesh, fsdp=fsdp))
            _specs_equal(
                tl.make_serving_shardings(tl.quantize_params(tp_), tcfg,
                                          tmesh, fsdp=fsdp),
                jl.make_serving_shardings(jl.quantize_params(jp), jcfg,
                                          jmesh, fsdp=fsdp))
        _specs_equal(tl.make_replicated_shardings(tp_, tmesh),
                     jl.make_replicated_shardings(jp, jmesh))


def test_fit_spec_drops_and_warns_once():
    from paddle_tpu_torch.distributed.mesh import P

    tl._FIT_SPEC_WARNED.clear()

    jmesh = Mesh(np.asarray(jax.devices()[:6]).reshape(3, 1, 2),
                 ("dp", "sp", "tp"))
    tmesh = {"dp": 3, "sp": 1, "tp": 2}
    from jax.sharding import PartitionSpec as JP
    for spec, shape in (((("dp", "tp"), None), (12, 5)),
                        ((("dp", "tp"), "tp"), (4, 6)),
                        (("tp", "dp"), (7, 9)), (("sp", None), (4, 4))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = tl._fit_spec(P(*spec), shape, tmesh)
            again = tl._fit_spec(P(*spec), shape, tmesh)
        want = jl._fit_spec(JP(*spec), shape, jmesh)
        assert tuple(got) == tuple(want) == tuple(again)
        dropped = sum(1 for e in spec for nm in
                      (e if isinstance(e, tuple) else (e,))
                      if nm and tmesh[nm] > 1) - sum(
            1 for e in got for nm in (e if isinstance(e, tuple) else (e,))
            if nm)
        # warned once per dropped axis, not again on the second call
        assert len(w) == dropped


def test_shard_params_cuts_each_rank_slice(model, ranks):
    """shard_params gives rank r the r-th contiguous slice of every split
    dim (int8 leaves: q by the dense spec, s by the output axis) and
    keeps unsplit leaves whole."""
    full = model[3]["int8w"]
    parts = [r["shards"] for r in ranks]
    lay = full["layers"]
    for k in ("wq", "w_gate"):
        for leaf in ("q", "s"):
            np.testing.assert_array_equal(
                np.concatenate([p["layers"][k][leaf] for p in parts], -1),
                lay[k][leaf])
    np.testing.assert_array_equal(
        np.concatenate([p["layers"]["wo"]["q"] for p in parts], 1),
        lay["wo"]["q"])
    for p in parts:
        # a row-parallel leaf's scale and the norms stay whole
        np.testing.assert_array_equal(p["layers"]["wo"]["s"],
                                      lay["wo"]["s"])
        np.testing.assert_array_equal(p["final_norm"], full["final_norm"])
    np.testing.assert_array_equal(
        np.concatenate([p["embed"] for p in parts], 0), full["embed"])
    np.testing.assert_array_equal(
        np.concatenate([p["lm_head"]["q"] for p in parts], -1),
        full["lm_head"]["q"])
