"""The port's grouped-GEMM tile autotuner (paddle_tpu_torch.kernels
.gmm_autotune) and its persistent cache (paddle_tpu_torch.jit.cache), on
the CPU with injected timings: the reference's cases
(tests/test_moe_dispatch.py) on the port's candidate set — the bf16
kernels' output tile widths, 128 and 256 columns — and the port's cache
module against the reference's on the same documents."""
import json
import os

import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)

from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import cache as jcache
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import cache as tcache
from paddle_tpu_torch.kernels import gmm_autotune as ga
from paddle_tpu_torch.kernels import moe_dispatch as tmd

# phase 12's shapes (DeepSeekMoE-16B, 4 x 2048 tokens, top-6 of 64): the
# fused form's gate|up (A_pad rows, h -> 2f) and the down projection
# (A_pad rows, f -> h); the gmm form's down projection (A rows)
SHAPES = {"gate_up": dict(m=57344, k=2048, n=2816, E=64),
          "down": dict(m=57344, k=1408, n=2048, E=64),
          "down_gmm": dict(m=49152, k=1408, n=2048, E=64)}
_SHAPE = SHAPES["gate_up"]
_PASSES = ("fwd", "dgrad", "wgrad")


@pytest.fixture
def tiling_cache(tmp_path):
    """A fresh in-process cache persisting under a temporary directory."""
    old = tflags.get_flag("jit_cache_dir")
    tflags.set_flags({"jit_cache_dir": str(tmp_path)})
    ga.clear()
    ga.counters.clear()
    yield tmp_path
    ga.clear()
    tflags.set_flags({"jit_cache_dir": old})


def _get(measure=None, full_rows=True, dtype=torch.bfloat16, shape=_SHAPE,
         variant="gmm"):
    return ga.get_tilings(shape["m"], shape["k"], shape["n"], shape["E"],
                          dtype, full_rows, measure=measure, variant=variant)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_candidates_respect_envelope_and_seed_with_heuristic(name):
    """Each pass's candidates start with the heuristic — ``tile_width`` of
    that pass's output columns (fwd n, dgrad k, wgrad n) — and hold only
    widths the kernels take: tm 128, tk 64, tn 128 or 256 (n = 1408 is
    not a whole number of 256-wide tiles; the kernels clip the last
    tile). f32 has the heuristic alone: its kernels take no width."""
    s = SHAPES[name]
    heur = ga.heuristic_tilings(s["m"], s["k"], s["n"])
    assert heur == ((128, 64, tmd.tile_width(s["n"])),
                    (128, 64, tmd.tile_width(s["k"])),
                    (128, 64, tmd.tile_width(s["n"])))
    cands = ga.candidate_tilings(s["m"], s["k"], s["n"])
    for i, pass_ in enumerate(_PASSES):
        assert cands[pass_][0] == heur[i]
        assert sorted(t[2] for t in cands[pass_]) == [128, 256]
        assert all(ga._fits(*t) for t in cands[pass_])
    f32 = ga.candidate_tilings(s["m"], s["k"], s["n"], itemsize=4)
    assert all(f32[p] == [heur[i]] for i, p in enumerate(_PASSES))
    # widths the kernels refuse have no tiling at all
    assert ga.heuristic_tilings(100, 60, 64) is None
    assert ga.candidate_tilings(100, 64, 1410) is None


def test_autotune_picks_measured_winner(tiling_cache):
    """With an injected measure the winner is each pass's fastest
    candidate (here the one that is not the heuristic), and the second
    lookup is a cache hit that never measures."""
    target = {}

    def measure(pass_, tiling):
        cands = ga.candidate_tilings(_SHAPE["m"], _SHAPE["k"],
                                     _SHAPE["n"])[pass_]
        target[pass_] = cands[-1]
        return 1e-3 if tiling == cands[-1] else 1.0

    tri = _get(measure)
    assert tri == tuple(target[p] for p in _PASSES)
    assert tri != ga.heuristic_tilings(_SHAPE["m"], _SHAPE["k"], _SHAPE["n"])

    def poisoned(pass_, tiling):
        raise AssertionError("cache hit must not re-measure")

    assert _get(poisoned) == tri
    assert ga.counters["moe_tiling_cache_hits_total"] == 1
    assert ga.counters["moe_tiling_cache_misses_total"] == 1


def test_autotune_heuristic_fallback_without_measurement(tiling_cache):
    """No CUDA: the heuristic answers, is remembered in-process, and is
    never persisted; a shape the kernels do not take has no tiling."""
    tri = _get()
    assert tri == ga.heuristic_tilings(_SHAPE["m"], _SHAPE["k"], _SHAPE["n"])
    entries = ga.entries()
    assert len(entries) == 1 and entries[0][1] == "heuristic"
    assert entries[0][0].startswith("cpu|")
    assert not os.path.exists(os.path.join(str(tiling_cache),
                                           "gmm_tilings.json"))
    assert ga.get_tilings(100, 60, 64, 8, torch.float32, False) is None
    # f32: one candidate a pass, nothing to measure even with a measure
    f32 = _get(measure=lambda p, t: 1 / 0, dtype=torch.float32)
    assert f32 == tri and len(ga.entries()) == 2
    # the flag off: the heuristic, nothing cached
    tflags.set_flags({"moe_gmm_autotune": False})
    try:
        ga.clear()
        assert _get(lambda p, t: 0.0) == tri
        assert ga.entries() == []
    finally:
        tflags.set_flags({"moe_gmm_autotune": True})


def test_tiling_cache_persist_roundtrip(tiling_cache):
    """Measured winners survive the process: persist, clear the in-memory
    cache (a fresh process), and the file answers the next lookup with no
    measurement; ``clear(persisted=True)`` empties the file. The two
    variants never share an entry."""
    tri = _get(lambda p, t: 0.5, full_rows=False)    # ties: heuristic wins
    path = os.path.join(str(tiling_cache), "gmm_tilings.json")
    doc = json.load(open(path))
    assert doc.pop("__schema__") == ga.SCHEMA
    (key,) = doc
    assert f"m={_SHAPE['m']}|k={_SHAPE['k']}|n={_SHAPE['n']}" in key
    assert key.endswith("|bfloat16|full_rows=False|v=gmm")
    assert doc[key] == {"source": "measured",
                        "tilings": {p: list(t) for p, t in
                                    zip(_PASSES, tri)}}
    ga.clear()

    def poisoned(pass_, tiling):
        raise AssertionError("persisted winner must not re-measure")

    assert _get(poisoned, full_rows=False) == tri
    calls = []
    _get(lambda p, t: calls.append(p) or 1.0, full_rows=False,
         variant="fused")
    assert calls                          # the fused variant measures anew
    ga.clear(persisted=True)
    doc = json.load(open(path))
    doc.pop("__schema__", None)
    assert doc == {}


def test_autotune_never_worse_rejects_noise_band_winner(tiling_cache):
    """A candidate that wins by less than the 3% noise margin proves
    nothing: the heuristic is kept and each pass counts a rejection."""
    def measure(pass_, tiling):
        cands = ga.candidate_tilings(_SHAPE["m"], _SHAPE["k"],
                                     _SHAPE["n"])[pass_]
        return 0.99 if tiling == cands[-1] else 1.0       # a 1% "win"

    assert _get(measure) == ga.heuristic_tilings(_SHAPE["m"], _SHAPE["k"],
                                                 _SHAPE["n"])
    assert ga.counters["moe_tiling_autotune_rejected_total"] == 3


def test_poisoned_persisted_entry_is_remeasured(tiling_cache):
    """A width outside the kernels' envelope planted in the file is
    dropped at load (counted as rejected) and its key measured again."""
    key = ga._key(ga._device_tag(), _SHAPE["m"], _SHAPE["k"], _SHAPE["n"],
                  _SHAPE["E"], "bfloat16", True, "gmm")
    absurd = [128, 64, 512]               # no kernel takes 512 columns
    tcache.store_json(ga.PERSIST_NAME, {key: {
        "tilings": {p: absurd for p in _PASSES}, "source": "measured"}},
        schema=ga.SCHEMA)
    ga.clear()
    calls = []

    def measure(pass_, tiling):
        calls.append(pass_)
        return 1.0                        # ties: the heuristic wins

    tri = _get(measure)
    assert calls, "a poisoned entry must be measured again, not served"
    assert all(list(t) != absurd for t in tri)
    assert ga.counters["moe_tiling_autotune_rejected_total"] == 1


def test_persist_schema_mismatch_reads_empty(tmp_path):
    """A document of another schema version reads as {} (discarded whole,
    never misread under a new key format)."""
    old = tflags.get_flag("jit_cache_dir")
    tflags.set_flags({"jit_cache_dir": str(tmp_path)})
    try:
        tcache.store_json("doc", {"a": 1}, schema=1)
        assert tcache.load_json("doc", schema=1) == {"a": 1}
        assert tcache.load_json("doc", schema=2) == {}
        assert tcache.load_json("doc") == {"a": 1}   # unversioned read
    finally:
        tflags.set_flags({"jit_cache_dir": old})


@pytest.fixture
def both_caches(tmp_path):
    """Both packages' cache modules pointed at one directory."""
    old = (jflags.get_flag("jit_cache_dir"), tflags.get_flag("jit_cache_dir"))
    jflags.set_flags({"jit_cache_dir": str(tmp_path)})
    tflags.set_flags({"jit_cache_dir": str(tmp_path)})
    yield tmp_path
    jflags.set_flags({"jit_cache_dir": old[0]})
    tflags.set_flags({"jit_cache_dir": old[1]})


@pytest.mark.parametrize("schema", [None, 2])
def test_jit_cache_matches_reference_on_the_same_documents(both_caches,
                                                           schema):
    """What either package writes, the other reads back the same (with
    and without a schema stamp); both write the same bytes; a corrupt, a
    non-object or a missing document reads as {} in both."""
    doc = {"k|m=1": {"tilings": {"fwd": [128, 64, 256]}, "source": "x"},
           "n": 3}
    assert tcache.store_json("a", doc, schema=schema)
    assert jcache.load_json("a", schema=schema) == doc
    assert jcache.store_json("b", doc, schema=schema)
    assert tcache.load_json("b", schema=schema) == doc
    assert open(tcache.cache_path("a")).read() == \
        open(jcache.cache_path("b")).read()
    for name, text in (("bad", "{not json"), ("list", "[1, 2]")):
        with open(os.path.join(str(both_caches), name + ".json"), "w") as f:
            f.write(text)
        assert tcache.load_json(name) == jcache.load_json(name) == {}
    assert tcache.load_json("missing", schema=schema) == {} \
        == jcache.load_json("missing", schema=schema)
    assert not [p for p in os.listdir(str(both_caches))
                if p.startswith(".tmp-")]


def test_cache_dir_keeps_the_reference_order_under_its_own_name(
        monkeypatch, tmp_path):
    """The flag first, then $PADDLE_TPU_CACHE_DIR/torch, then
    $XDG_CACHE_HOME/paddle_tpu_torch, then ~/.cache/paddle_tpu_torch: the
    reference's order, with the port's documents apart from the JAX
    package's (whose gmm_tilings.json holds other kernels' tilings)."""
    old = tflags.get_flag("jit_cache_dir")
    tflags.set_flags({"jit_cache_dir": ""})
    try:
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        monkeypatch.delenv("PADDLE_TPU_CACHE_DIR", raising=False)
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        assert tcache.cache_dir() == str(tmp_path / "home" / ".cache" /
                                         "paddle_tpu_torch")
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        assert tcache.cache_dir() == str(tmp_path / "xdg" /
                                         "paddle_tpu_torch")
        monkeypatch.setenv("PADDLE_TPU_CACHE_DIR", str(tmp_path / "c"))
        assert tcache.cache_dir() == str(tmp_path / "c" / "torch")
        assert jcache.cache_dir() != tcache.cache_dir()
        tflags.set_flags({"jit_cache_dir": str(tmp_path / "flag")})
        assert tcache.cache_dir() == str(tmp_path / "flag")
    finally:
        tflags.set_flags({"jit_cache_dir": old})


def test_each_pass_runs_at_its_tuned_width(monkeypatch):
    """``_GmmTuned`` hands each pass its width: the forward ``gmm`` the
    first tiling's, the dgrad ``gmm(transpose_rhs)`` the second's, the
    wgrad ``tgmm`` the third's (recorded here around the plain versions);
    without tilings each takes ``tile_width`` (None)."""
    seen = []
    gmm, tgmm = tmd.gmm, tmd.tgmm

    def rec_gmm(lhs, rhs, gs, transpose_rhs=False, bn=None):
        seen.append(("dgrad" if transpose_rhs else "fwd", bn))
        return gmm(lhs, rhs, gs, transpose_rhs, bn)

    def rec_tgmm(lhs_t, rhs, gs, out_dtype=torch.float32, bn=None):
        seen.append(("wgrad", bn))
        return tgmm(lhs_t, rhs, gs, out_dtype, bn)

    monkeypatch.setattr(tmd, "gmm", rec_gmm)
    monkeypatch.setattr(tmd, "tgmm", rec_tgmm)
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(40, 16, generator=g, requires_grad=True)
    w = torch.randn(3, 16, 24, generator=g, requires_grad=True)
    gs = torch.tensor([10, 0, 30], dtype=torch.int32)
    tilings = ((128, 64, 256), (128, 64, 128), (128, 64, 256))
    for tl, want in ((tilings, [("fwd", 256), ("dgrad", 128),
                                ("wgrad", 256)]),
                     (None, [("fwd", None), ("dgrad", None),
                             ("wgrad", None)])):
        seen.clear()
        out = tmd._GmmTuned.apply(xs, w, gs, True, tl)
        out.sum().backward()
        assert seen == want


@pytest.mark.parametrize("variant", ["gmm", "fused"])
def test_default_measure_times_every_pass_off_the_card(tiling_cache,
                                                       variant):
    """The measurement closure the card uses (its operands, balanced
    groups, B9's padded layout for "fused", each pass at the width it is
    given), run on the CPU with a host clock in place of CUDA events:
    every candidate of every pass returns a time, and ``get_tilings``
    persists a measured winner from it."""
    import time

    def host_timer(fn, *args, n=3):
        fn(*args)
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    m, k, n, E = 512, 64, 96, 4
    runner = ga._default_measure(m, k, n, E, torch.bfloat16, False, variant,
                                 device="cpu", timer=host_timer)
    for pass_, cands in ga.candidate_tilings(m, k, n).items():
        for tiling in cands:
            assert runner(pass_, tiling) > 0
    tri = ga.get_tilings(m, k, n, E, torch.bfloat16, False, measure=runner,
                         variant=variant)
    assert all(ga._fits(*t) for t in tri)
    assert [e[1] for e in ga.entries()] == ["measured"]
