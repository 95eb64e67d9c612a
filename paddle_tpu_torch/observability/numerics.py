"""Numerics observatory: on-device tensor stats + quant-error telemetry — the
port's copy of paddle_tpu/observability/numerics.py.

- :func:`tensor_stats` computes absmax / rms / NaN+Inf count /
  int8-overflow fraction of a tensor as a few torch reductions on the
  tensor's own stream;
- :func:`record_stats` / :func:`ladder_record` / :func:`record_quant_error`
  ship the resulting stat vector to the host: the vector is copied
  ``non_blocking`` into pinned memory behind a CUDA event and stays
  *pending* until a readback the caller already does has completed past
  it — :func:`land` (called right after each of the serving engine's
  readbacks and the resilient train loop's loss readback) moves every
  pending vector whose event has completed into a
  bounded ring (``FLAGS_obs_numerics_capacity``). Never ``.item()``,
  never a ``.cpu()`` inside a dispatch: the reference streams the same
  vector through ``jax.debug.callback``, and neither side ever syncs;
- :func:`record_quant_error` pairs a pre-quant tensor with its int8 form
  and lands the relative RMS reconstruction error in the
  ``numerics_quant_error{site=...}`` gauge — one gauge per int8 site
  (``weight_only`` / ``kv_int8`` / ``expert_int8``);
- :func:`provenance` walks the per-layer stats ladder for the first
  layer whose NaN/Inf count went nonzero.

Cost contract: everything is behind ``FLAGS_obs_numerics`` (the master
obs switch must also be on). With it off the instrumented sites add no
device op — the port's form of the reference's "identical jaxpr"
(asserted in tests/test_torch_obs_engine.py). :func:`flush` — the
counterpart of ``jax.effects_barrier()`` — waits for every pending
vector and lands it; consumers call it at incident time or in tests,
never in the hot path.

Module import stays stdlib-only (torch is imported inside the functions
that compute); the ``FLAGS_obs_numerics*`` flags are defined eagerly in
the package ``__init__``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework.flags import get_flag, set_flags, watch_flag
from . import state
from .catalog import instrument as _instrument

__all__ = [
    "STAT_FIELDS", "enabled", "active", "enable", "disable",
    "tensor_stats", "record_stats", "ladder_record", "record_quant_error",
    "QuantErrorProbe", "land", "step_mark", "epoch", "flush", "entries",
    "rows", "latest", "provenance", "payload", "clear",
]

# one stat vector per landing: the fixed schema every probe emits
# (quant_err is -1 for plain stats probes)
STAT_FIELDS = ("absmax", "rms", "nan_inf", "overflow_frac", "quant_err")

_M_EVENTS = _instrument("numerics_events_total")
_M_NAN = _instrument("numerics_nan_total")
_M_QERR = _instrument("numerics_quant_error")

# hot-path switch: one module-global read per instrumented site (get_flag
# takes a lock); kept in sync with FLAGS_obs_numerics through watch_flag
_ENABLED = bool(get_flag("obs_numerics"))

_lock = threading.Lock()
_RING: collections.deque = collections.deque(
    maxlen=int(get_flag("obs_numerics_capacity")))
# shipped vectors not landed yet: (site, layer offset, host tensor, event
# or None); in ship order, which is stream order
_PENDING: collections.deque = collections.deque()
_EPOCH = 0                       # step counter stamped onto landings
_LAST_PROVENANCE: Optional[str] = None


def _on_flag(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


watch_flag("obs_numerics", _on_flag)


def _resize(capacity) -> None:
    global _RING
    with _lock:
        _RING = collections.deque(_RING, maxlen=int(capacity))


watch_flag("obs_numerics_capacity", _resize)


def enabled() -> bool:
    """True when FLAGS_obs_numerics is on (ignores the master switch)."""
    return _ENABLED


def active() -> bool:
    """The site gate: numerics AND the master obs switch are on.
    Instrumented call sites check this before computing anything — off
    means no device op added."""
    return _ENABLED and state.enabled()


def enable() -> None:
    set_flags({"obs_numerics": True})


def disable() -> None:
    set_flags({"obs_numerics": False})


# ---------------------------------------------------------------------------
# on-device stat reductions
# ---------------------------------------------------------------------------

def _grid(scale, axis: int):
    return scale.float().unsqueeze(axis).clamp_min(1e-30)


def tensor_stats(x, scale=None, axis: int = -1):
    """[5] f32 stat vector of ``x`` on its device: absmax, rms, NaN+Inf
    count, and the int8-overflow fraction. Non-finite elements are
    counted, then masked to 0 so absmax/rms stay meaningful alongside
    them. ``scale`` (with ``axis`` naming the dim it was reduced over)
    measures overflow against the actual quantization grid (``|x| /
    scale`` rounding outside [-127, 127]); without it, against a unit
    grid (|x| > 127). The quant_err slot is -1."""
    import torch

    xf = x.float()
    finite = torch.isfinite(xf)
    n_bad = (~finite).sum().float()
    xz = torch.where(finite, xf, torch.zeros_like(xf))
    ax = xz.abs()
    absmax = ax.max() if ax.numel() else torch.zeros((), device=x.device)
    rms = torch.sqrt((xz * xz).mean())
    if scale is not None:
        over = (ax / _grid(scale, axis) > 127.5).float().mean()
    else:
        over = (ax > 127.0).float().mean()
    return torch.stack([absmax, rms, n_bad, over,
                        torch.full((), -1.0, device=x.device)])


def _ship(site: str, vec, layer) -> None:
    """Queue one stat vector for landing: on the card, a non-blocking
    copy into pinned memory and an event behind it — nothing waits; on
    the CPU the vector is its own host copy."""
    import torch

    vec = vec.detach().float()
    if vec.device.type == "cuda":
        host = torch.empty(vec.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(vec, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(vec.device))
    else:
        host, ev = vec, None
    with _lock:
        _PENDING.append((str(site), -1 if layer is None else int(layer),
                         host, ev))


def record_stats(site: str, x, scale=None, axis: int = -1,
                 layer=None) -> None:
    """Probe one tensor: compute :func:`tensor_stats` on the device and
    ship it under ``site``. A no-op (no device op) unless
    :func:`active`."""
    if not active():
        return
    import torch

    with torch.no_grad():      # a probe is never part of the autograd graph
        _ship(site, tensor_stats(x, scale=scale, axis=axis), layer)


def ladder_record(site: str, stats_rows, offset: int = 0) -> None:
    """Ship a stacked ``[L, 5]`` per-layer stats ladder in ONE landing
    (row ``i`` lands as layer ``offset + i``) — the ladder
    :func:`provenance` walks. The caller checks :func:`active`."""
    _ship(site, stats_rows, -2 - int(offset))


class QuantErrorProbe:
    """Accumulates paired pre/post-quant sums over any number of pairs —
    a layer at a time, so no pre-quant tensor is held past its layer —
    and ships ONE landing: the pre-quant tensors' stats plus the combined
    relative RMS reconstruction error ``sqrt(sum (pre - deq)^2 / sum
    pre^2)``. Build one only when :func:`active`."""

    __slots__ = ("sq_err", "sq", "absmax", "n_bad", "n_over", "n")

    def __init__(self):
        self.sq_err = self.sq = self.absmax = None
        self.n_bad = self.n_over = None
        self.n = 0

    def add(self, pre, q, scale, axis: int) -> None:
        """One pair: the float tensor, its int8 form, the per-channel
        scales and the axis the scale was reduced over (reconstruction is
        ``q * scale.unsqueeze(axis)``)."""
        import torch

        pf = pre.float()
        finite = torch.isfinite(pf)
        pz = torch.where(finite, pf, torch.zeros_like(pf))
        d = pz - q.float() * scale.float().unsqueeze(axis)
        parts = ((~finite).sum().float(), (d * d).sum(), (pz * pz).sum(),
                 pz.abs().max(),
                 (pz.abs() / _grid(scale, axis) > 127.5).sum().float())
        if self.sq is None:
            self.n_bad, self.sq_err, self.sq, self.absmax, self.n_over = \
                parts
        else:
            self.n_bad = self.n_bad + parts[0]
            self.sq_err = self.sq_err + parts[1]
            self.sq = self.sq + parts[2]
            self.absmax = torch.maximum(self.absmax, parts[3])
            self.n_over = self.n_over + parts[4]
        self.n += pre.numel()

    def ship(self, site: str) -> None:
        import torch

        if self.sq is None:
            return
        n = max(self.n, 1)
        rms = torch.sqrt(self.sq / n)
        rel = torch.sqrt(self.sq_err / self.sq.clamp_min(1e-30))
        _ship(site, torch.stack([self.absmax, rms, self.n_bad,
                                 self.n_over / n, rel]), None)


def record_quant_error(site: str, pairs: Sequence[Tuple]) -> None:
    """Paired pre/post-quant probe for one int8 site. ``pairs`` is a
    sequence of ``(pre, q, scale, axis)`` (the ``quantize_kv`` /
    ``quantize_params`` conventions). All pairs aggregate into ONE
    landing whose quant_err lands in ``numerics_quant_error{site=...}``.
    No-op unless :func:`active`."""
    if not active():
        return
    probe = QuantErrorProbe()
    for pre, q, scale, axis in pairs:
        probe.add(pre, q, scale, axis)
    probe.ship(site)


# ---------------------------------------------------------------------------
# host side: the landing ring + consumers
# ---------------------------------------------------------------------------

def _entry(site: str, layer: int, v) -> Dict:
    return {"t": time.time(), "site": str(site), "layer": int(layer),
            "epoch": _EPOCH,
            "absmax": float(v[0]), "rms": float(v[1]),
            "nan_inf": int(v[2]), "overflow_frac": float(v[3]),
            "quant_err": (float(v[4]) if v[4] >= 0 else None)}


def _commit(entry: Dict) -> None:
    with _lock:
        _RING.append(entry)
    site = entry["site"]
    _M_EVENTS.inc(site=site)
    if entry["nan_inf"]:
        _M_NAN.inc(site=site)
    if entry["quant_err"] is not None:
        _M_QERR.set(entry["quant_err"], site=site)


def _land_one(site: str, layer: int, host) -> None:
    if not _ENABLED:               # disabled mid-flight: drop, don't record
        return
    m = host.double().tolist()
    if layer <= -2:                # a ladder: row i is layer offset + i
        for i, row in enumerate(m):
            _commit(_entry(site, -2 - layer + i, row))
    else:
        _commit(_entry(site, layer, m))


def land() -> int:
    """Land every pending vector whose copy has completed, in ship order,
    stopping at the first still in flight (a later one is behind it on
    the stream). Polls events, never waits: the serving engine calls this
    right after each readback, when everything enqueued before that
    readback has completed. Returns the number landed."""
    if not _PENDING:
        return 0
    done = []
    with _lock:
        while _PENDING:
            site, layer, host, ev = _PENDING[0]
            if ev is not None and not ev.query():
                break
            _PENDING.popleft()
            done.append((site, layer, host))
    for site, layer, host in done:
        _land_one(site, layer, host)
    return len(done)


def step_mark() -> int:
    """Advance the step epoch stamped onto subsequent landings. Returns
    the new epoch (0 and free when inactive)."""
    global _EPOCH
    if not _ENABLED:
        return 0
    _EPOCH += 1
    return _EPOCH


def epoch() -> int:
    return _EPOCH


def flush() -> None:
    """Wait for every pending stat vector and land it — the one
    deliberate sync (the reference's ``jax.effects_barrier()``):
    consumers call it at incident time, never inside the hot path."""
    with _lock:
        pending = list(_PENDING)
    for _site, _layer, _host, ev in pending:
        if ev is not None:
            ev.synchronize()
    land()


def entries() -> List[Dict]:
    with _lock:
        return list(_RING)


def rows() -> List[Dict]:
    """Latest landing per (site, layer) — the obs_dump stats table."""
    last: Dict[Tuple[str, int], Dict] = {}
    for e in entries():
        last[(e["site"], e["layer"])] = e
    return [last[k] for k in sorted(last)]


def latest(site: str, layer: Optional[int] = None) -> Optional[Dict]:
    for e in reversed(entries()):
        if e["site"] == site and (layer is None or e["layer"] == layer):
            return e
    return None


def provenance(since_epoch: Optional[int] = None) -> Optional[str]:
    """Walk the stats ladder for the first bad layer: among ladder
    landings (layer >= 0) at ``since_epoch`` or later (default: the
    newest epoch present), the entry with nonzero NaN/Inf count and the
    smallest layer index. Returns ``"<site>:<layer>"`` or ``None``.
    Flushes pending landings first — this runs on the incident path."""
    global _LAST_PROVENANCE
    if not _ENABLED:
        return None
    flush()
    ladder = [e for e in entries() if e["layer"] >= 0]
    if since_epoch is not None:
        ladder = [e for e in ladder if e["epoch"] >= since_epoch]
    elif ladder:
        newest = max(e["epoch"] for e in ladder)
        ladder = [e for e in ladder if e["epoch"] == newest]
    bad = [e for e in ladder if e["nan_inf"] > 0]
    if not bad:
        return None
    first = min(bad, key=lambda e: (e["layer"], e["t"]))
    _LAST_PROVENANCE = f"{first['site']}:{first['layer']}"
    return _LAST_PROVENANCE


def payload() -> Dict:
    """The post-mortem embed: the stats table plus the last provenance
    verdict (what the flight recorder attaches on crash)."""
    return {"rows": rows(), "provenance": _LAST_PROVENANCE}


def clear() -> None:
    """Drop every landed and pending entry and reset the epoch (test
    isolation)."""
    global _EPOCH, _LAST_PROVENANCE
    with _lock:
        _RING.clear()
        _PENDING.clear()
    _EPOCH = 0
    _LAST_PROVENANCE = None
