"""Measured tile-width autotuner for the grouped GEMMs — the port of
paddle_tpu/kernels/gmm_autotune, aimed at the port's kernels.

A tiling is the reference's ``(tm, tk, tn)`` triple. The port's bf16
Hopper kernels (B9 ``gather_gmm``, B10 ``gmm`` and ``tgmm``, on
``csrc/grouped_gemm_sm90.cuh``) have fixed 128-row tiles and 64-deep
stages, so tm = 128 and tk = 64 always, and the knob is tn, the output
tile's width: 128 or 256 columns (``moe_dispatch.tile_width`` is the
static pick). The f32 forms run on CUDA cores and take no width, so their
one candidate is the heuristic.

On the first encounter of each ``(m, k, n, E, dtype, full_rows, variant)``
key on a CUDA device, :func:`get_tilings` times every candidate width for
all three passes (forward, dgrad ``gmm(transpose_rhs=True)``, wgrad
``tgmm``; for ``variant="fused"`` the forward is B9's gather-fused GEMM),
keeps the winner in-process, and persists it through
:mod:`paddle_tpu_torch.jit.cache` (``gmm_tilings.json``), so later steps
and later processes on the same card pay nothing. Where nothing can be
measured (no CUDA, ``FLAGS_moe_gmm_autotune`` off) the heuristic answers;
unmeasured answers stay in-process, so the file holds measured winners
only.

Trust guards, as in the reference:

* **Never worse than the heuristic**: the heuristic is always candidate
  0 and is always timed; another winner is kept only when it beats it by
  more than ``_NOISE_MARGIN`` (3%), else the heuristic is served and the
  rejection counted.
* **Persisted entries are validated**: an entry outside the kernels'
  envelope (``_fits``: tm 128, tk 64, tn 128 or 256) is dropped at load,
  counted as rejected, and its key re-measured on its next encounter;
  the file carries a schema version (:data:`SCHEMA`).

A candidate is only ever a width the kernels' own argument checks take,
so no launch error is expected or caught: an error while measuring
propagates. The reference's metrics (``moe_tiling_cache_{hits,misses}
_total``, ``moe_tiling_autotune_seconds``,
``moe_tiling_autotune_rejected_total``) are emitted at the reference's
sites; :data:`counters` keeps the same counts (and the seconds summed)
on the host whether observability is on or not.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..framework.flags import define_flag, get_flag
from ..jit import cache as _jcache
from ..observability.catalog import instrument as _instrument

define_flag("moe_gmm_autotune", True,
            "measure grouped-GEMM tile widths on first encounter of each "
            "shape (CUDA only); off = the static tile_width pick")

__all__ = [
    "heuristic_tilings", "get_tilings", "candidate_tilings", "clear",
    "entries", "PERSIST_NAME", "SCHEMA", "counters", "time_best",
]

Tiling = Tuple[int, int, int]
TriTiling = Tuple[Tiling, Tiling, Tiling]          # (fwd, dgrad, wgrad)

PERSIST_NAME = "gmm_tilings"
# the port's first document format: (128, 64, tn) tilings of its kernels
SCHEMA = 1
_PASSES = ("fwd", "dgrad", "wgrad")

# a non-heuristic winner must beat the heuristic by more than this
# fraction, else measurement noise could swap in a worse width
_NOISE_MARGIN = 0.03

_TM, _TK = 128, 64          # the kernels' row tile and stage depth
_WIDTHS = (256, 128)        # the bf16 kernels' output tile widths

_M_HITS = _instrument("moe_tiling_cache_hits_total")
_M_MISSES = _instrument("moe_tiling_cache_misses_total")
_M_TUNE = _instrument("moe_tiling_autotune_seconds")
_M_REJECTED = _instrument("moe_tiling_autotune_rejected_total")

# the same counts on the host (the seconds summed), observability on or off
counters: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_CACHE: Dict[str, dict] = {}
_LOADED = False

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _fits(tm: int, tk: int, tn: int) -> bool:
    """The kernels' envelope: 128-row tiles, 64-deep stages, and an
    output tile 128 or 256 columns wide."""
    return tm == _TM and tk == _TK and tn in _WIDTHS


def _aligned(t) -> bool:
    """Sanity check of a (t1, t2, t3) tiling from an untrusted source
    (the persisted file): three positive ints."""
    if not isinstance(t, (list, tuple)) or len(t) != 3:
        return False
    return all(isinstance(v, int) and not isinstance(v, bool) and v > 0
               for v in t)


def heuristic_tilings(m: int, k: int, n: int) -> Optional[TriTiling]:
    """The static per-pass tilings: ``tile_width`` of each pass's output
    columns (fwd [m, n], dgrad [m, k], wgrad [E, k, n]). None for widths
    the kernels do not take (not a positive multiple of 8): the wrappers
    raise on those. This is the autotuner's candidate 0 and its fallback
    whenever nothing is measured."""
    from .moe_dispatch import tile_width

    if m < 0 or k <= 0 or n <= 0 or k % 8 or n % 8:
        return None
    return ((_TM, _TK, tile_width(n)), (_TM, _TK, tile_width(k)),
            (_TM, _TK, tile_width(n)))


def candidate_tilings(m: int, k: int, n: int,
                      itemsize: int = 2) -> Optional[Dict[str, list]]:
    """Per-pass candidates, the heuristic first: every width the bf16
    kernels take (256 and 128; a width that is not a whole number of
    tiles clips its last tile, which the kernels handle). f32
    (``itemsize`` 4) has one candidate, the heuristic: its CUDA-core
    kernels take no width."""
    heur = heuristic_tilings(m, k, n)
    if heur is None:
        return None
    out = {}
    for i, pass_ in enumerate(_PASSES):
        seen = [heur[i]]
        if itemsize == 2:
            seen += [(_TM, _TK, tn) for tn in _WIDTHS
                     if (_TM, _TK, tn) != heur[i]]
        out[pass_] = seen
    return out


def _key(device: str, m: int, k: int, n: int, E: int, dtype: str,
         full_rows: bool, variant: str = "gmm") -> str:
    return (f"{device}|m={m}|k={k}|n={n}|E={E}|{dtype}"
            f"|full_rows={full_rows}|v={variant}")


def _ensure_loaded() -> None:
    """Merge the persisted winners into the in-process cache (once).
    Entries outside the kernels' envelope are dropped (counted as
    rejected) and re-measured on their key's next encounter."""
    global _LOADED
    if _LOADED:
        return
    disk = _jcache.load_json(PERSIST_NAME, schema=SCHEMA)
    rejected = 0
    with _LOCK:
        if _LOADED:
            return
        for key, ent in disk.items():
            t = ent.get("tilings") if isinstance(ent, dict) else None
            if not (isinstance(t, dict) and all(p in t for p in _PASSES)):
                rejected += 1
                continue
            if not all(_aligned(t[p]) and _fits(*t[p]) for p in _PASSES):
                rejected += 1          # poisoned or stale: re-measure later
                continue
            if key not in _CACHE:
                _CACHE[key] = {
                    "tilings": {p: tuple(t[p]) for p in _PASSES},
                    "source": ent.get("source", "measured"),
                }
        _LOADED = True
    counters["moe_tiling_autotune_rejected_total"] += rejected
    for _ in range(rejected):
        _M_REJECTED.inc()


def _persist() -> None:
    with _LOCK:
        doc = {key: {"tilings": {p: list(ent["tilings"][p])
                                 for p in _PASSES},
                     "source": ent["source"]}
               for key, ent in _CACHE.items()
               if ent["source"] == "measured"}
    _jcache.store_json(PERSIST_NAME, doc, schema=SCHEMA)


def _as_tri(ent: dict) -> TriTiling:
    t = ent["tilings"]
    return tuple(tuple(t[p]) for p in _PASSES)  # type: ignore[return-value]


def time_best(fn, *args, n: int = 3) -> float:
    """Best-of-``n`` seconds of ``fn(*args)`` on the card after one warm
    call, each call between two CUDA events, synchronized around them
    (the shared timing discipline of the tile and dispatch-form
    measurements)."""
    fn(*args)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _balanced_groups(m: int, E: int, quantum: int = 1):
    """int32 group sizes summing to m, as even as ``quantum``-row blocks
    allow (the load the aux loss maintains); the remainder goes to group
    0."""
    each = (m // quantum // E) * quantum
    gs = [each] * E
    gs[0] += m - each * E
    return gs


def _default_measure(m, k, n, E, dtype, full_rows, variant="gmm",
                     device=None, timer=None):
    """The timing closure ``run(pass_, tiling) -> seconds`` on ``device``
    (default: the current CUDA device), or None without CUDA (then the
    heuristic answers). Operands are normals from a seeded generator in
    ``dtype`` over balanced groups; "fused" times B9 over a 128-row
    tile-padded layout whose rows gather a permutation of the tokens.
    ``timer`` replaces :func:`time_best` (a host clock, to rehearse off
    the card)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    from . import moe_dispatch as _md
    from . import moe_fused as _mf

    dev = torch.device(device)
    time_best_ = timer or time_best
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    lhs, rhs, grad = rnd(m, k), rnd(E, k, n), rnd(m, n)
    quantum = _mf._KTM if variant == "fused" else 1
    gs = torch.tensor(_balanced_groups(m, E, quantum), dtype=torch.int32,
                      device=dev)
    if variant == "fused":
        idx = torch.randperm(m, generator=gen, device=dev).to(torch.int32)
        gid = _mf._tile_gids(gs, m, _mf._KTM)
    lhs_t = lhs.t()

    def run(pass_: str, tiling: Tiling) -> float:
        bn = tiling[2]
        with torch.no_grad():
            if pass_ == "fwd" and variant == "fused":
                return time_best_(lambda: _mf.gather_gmm(lhs, idx, rhs, gid,
                                                        bn=bn))
            if pass_ == "fwd":
                return time_best_(lambda: _md.gmm(lhs, rhs, gs, bn=bn))
            if pass_ == "dgrad":
                return time_best_(lambda: _md.gmm(grad, rhs, gs,
                                                 transpose_rhs=True, bn=bn))
            return time_best_(lambda: _md.tgmm(lhs_t, grad, gs,
                                              out_dtype=rhs.dtype, bn=bn))

    return run


def get_tilings(m: int, k: int, n: int, E: int, dtype, full_rows: bool,
                *, measure: Optional[Callable] = None,
                variant: str = "gmm") -> Optional[TriTiling]:
    """(fwd, dgrad, wgrad) tilings for one grouped-GEMM call site:
    lhs [m, k] @ rhs [E, k, n] (``variant="gmm"``: B10's ``gmm`` forward;
    ``"fused"``: B9's gather-fused forward), the dgrad of width k and the
    wgrad [E, k, n]. Each tiling's third entry is the width the kernels
    take as ``bn``.

    Cache hit → the remembered winner (persisted winners count as hits).
    Miss → measure every candidate when possible, else the heuristic (as
    for f32, whose one candidate a pass leaves nothing to measure).
    ``measure(pass_, tiling) -> seconds`` is injectable for tests and
    tools. The variants never share entries: their kernels differ.

    Never-worse guard: the heuristic is always timed (candidate 0), and a
    different winner is kept only when it beats the heuristic by more
    than the noise margin; each rejection adds to
    ``counters["moe_tiling_autotune_rejected_total"]``.

    Returns None for widths the kernels do not take (their wrappers raise
    there)."""
    heur = heuristic_tilings(m, k, n)
    if heur is None:
        return None
    if not get_flag("moe_gmm_autotune"):
        return heur
    _ensure_loaded()
    dtype_s = _dtype_name(dtype)
    key = _key(_device_tag(), m, k, n, E, dtype_s, bool(full_rows),
               variant)
    with _LOCK:
        ent = _CACHE.get(key)
    if ent is not None:
        counters["moe_tiling_cache_hits_total"] += 1
        _M_HITS.inc()
        return _as_tri(ent)
    counters["moe_tiling_cache_misses_total"] += 1
    _M_MISSES.inc()

    cands = candidate_tilings(m, k, n, itemsize=_ITEMSIZE.get(dtype_s, 2))
    runner = None
    if any(len(c) > 1 for c in cands.values()):
        runner = measure if measure is not None else _default_measure(
            m, k, n, E, dtype, full_rows, variant)
    if runner is None:
        # nothing to time here (no CUDA, or one candidate a pass: f32):
        # serve the heuristic, remember it in-process only (the file holds
        # measured winners only)
        with _LOCK:
            _CACHE.setdefault(key, {"tilings": dict(zip(_PASSES, heur)),
                                    "source": "heuristic"})
        return heur

    picked: Dict[str, Tiling] = {}
    t_start = time.perf_counter()
    for i, pass_ in enumerate(_PASSES):
        best, best_t, heur_t = heur[i], float("inf"), float("inf")
        for tiling in cands[pass_]:
            dt = runner(pass_, tiling)
            if tiling == heur[i]:
                heur_t = dt
            if dt < best_t:
                best, best_t = tiling, dt
        if tuple(best) != tuple(heur[i]) \
                and best_t > heur_t * (1.0 - _NOISE_MARGIN):
            # a winner inside the heuristic's noise band proves nothing
            best = heur[i]
            counters["moe_tiling_autotune_rejected_total"] += 1
            _M_REJECTED.inc()
        picked[pass_] = tuple(best)
    tuned = time.perf_counter() - t_start
    counters["moe_tiling_autotune_seconds"] += tuned
    _M_TUNE.observe(tuned)
    with _LOCK:
        _CACHE.setdefault(key, {"tilings": picked, "source": "measured"})
        ent = _CACHE[key]
    _persist()
    return _as_tri(ent)


def _device_tag() -> str:
    """Tilings are card-specific: the key leads with the CUDA device's
    name (spaces replaced), or "cpu" without CUDA."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().replace(" ", "_")


def clear(persisted: bool = False) -> None:
    """Drop the in-process cache; ``persisted=True`` also empties the file
    (the escape hatch after a kernel change)."""
    global _LOADED
    with _LOCK:
        _CACHE.clear()
        _LOADED = False     # the next lookup re-reads the persisted winners
    if persisted:
            _jcache.store_json(PERSIST_NAME, {}, schema=SCHEMA)


def entries():
    """Snapshot of (key, source, {pass: tiling})."""
    _ensure_loaded()
    with _LOCK:
        return [(key, ent["source"], dict(ent["tilings"]))
                for key, ent in sorted(_CACHE.items())]
