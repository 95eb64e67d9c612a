"""Roofline telemetry: decode MFU, HBM watermarks, SLO gauges — the port's
copy of paddle_tpu/observability/perf.py.

- **MFU** — the reference takes a call's FLOPs from XLA's cost analysis
  of the lowered program. Nothing here is lowered, so the port counts a
  decode call's FLOPs analytically on the host from what the engine
  already knows (:func:`decode_flops`): two FLOPs per matmul weight
  element per row per step, plus the attention walk over the slots'
  K/V; and a train step's from the model's ``flops_per_token``
  (:func:`train_step_flops`). Either is divided by measured step time x
  the card's peak from :data:`DEVICE_SPECS`. The CPU reports against a nominal 1 TFLOP/s peak
  so MFU stays defined there, as in the reference.
- **HBM** — ``hbm_used_bytes`` / ``hbm_peak_bytes`` from
  ``torch.cuda.memory_allocated`` / ``max_memory_allocated``: host-side
  allocator counters, no device sync (:func:`update_hbm_gauges`); absent
  on the CPU.
- **SLO attainment** — the fraction of requests meeting
  ``FLAGS_obs_slo_ttft_ms`` / ``FLAGS_obs_slo_tpot_ms``, estimated from
  the TTFT/TPOT histograms by log-bucket interpolation
  (:func:`exposition.fraction_at_or_below`).

Module import stays stdlib-only (torch is imported inside the functions
that read the card) so the observability package keeps its
no-heavy-deps contract.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

from ..framework.flags import define_flag, get_flag
from . import state
from .catalog import instrument as _instrument
from .exposition import _hist_state, fraction_at_or_below, \
    merged_hist_state

__all__ = ["DEVICE_SPECS", "peak_flops", "hbm_bytes", "hbm_bandwidth",
           "matmul_params", "decode_flops", "train_step_flops", "mfu",
           "token_count",
           "hbm_stats", "update_hbm_gauges", "slo_attainment",
           "update_serving_slo_gauges"]

define_flag("obs_slo_ttft_ms", 1000.0,
            "serving SLO target for time-to-first-token; the "
            "serving_slo_ttft_attainment gauge is the fraction of "
            "requests at or under it")
define_flag("obs_slo_tpot_ms", 250.0,
            "serving SLO target for time-per-output-token; the "
            "serving_slo_tpot_attainment gauge is the fraction of "
            "requests at or under it")

_M_HBM_USED = _instrument("hbm_used_bytes")
_M_HBM_PEAK = _instrument("hbm_peak_bytes")
_M_SLO_TTFT = _instrument("serving_slo_ttft_attainment")
_M_SLO_TPOT = _instrument("serving_slo_tpot_attainment")

# per-card spec sheet: dense bf16 peak FLOP/s, HBM bytes, HBM B/s —
# matched by substring against torch.cuda.get_device_name (NVIDIA's H100
# SXM data sheet; the same figures chip_smoke.py bounds kernels with)
DEVICE_SPECS: Dict[str, Tuple[float, float, float]] = {
    #          flops    hbm    hbm B/s
    "h100":   (989e12, 80e9, 3.35e12),
}


def _device_name(device=None) -> str:
    """The lower-cased name of ``device`` (a name string, a
    ``torch.device`` or None for card 0); ``"cpu"`` without a card."""
    if isinstance(device, str) and device not in ("cpu", "cuda") \
            and not device.startswith("cuda:"):
        return device.lower()
    torch = sys.modules.get("torch")
    if torch is None:
        return "cpu"
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    try:
        if not torch.cuda.is_available():
            return "cpu"
        index = 0 if device is None else (torch.device(device).index or 0)
        return torch.cuda.get_device_name(index).lower()
    except Exception:
        return "cpu"


def _lookup(name: str, idx: int) -> float:
    for key, vals in DEVICE_SPECS.items():
        if key in name:
            return vals[idx]
    return DEVICE_SPECS["h100"][idx]     # unknown cards: H100-class


def peak_flops(device=None) -> float:
    """Dense bf16 peak FLOP/s of ``device`` (default: card 0). Unknown
    cards assume H100-class; the CPU gets a nominal 1 TFLOP/s so MFU is
    defined everywhere."""
    name = _device_name(device)
    if name == "cpu":
        return 1e12
    return _lookup(name, 0)


def hbm_bytes(device=None) -> float:
    return _lookup(_device_name(device), 1)


def hbm_bandwidth(device=None) -> float:
    return _lookup(_device_name(device), 2)


def matmul_params(config) -> int:
    """Matmul weight elements one token's forward touches: the layers'
    q/k/v/o projections and SwiGLU MLP, plus the lm head."""
    h, d = config.hidden_size, config.head_dim
    hq, hkv = config.num_heads, config.num_kv_heads
    per_layer = (h * hq * d + 2 * h * hkv * d + hq * d * h
                 + 3 * h * config.intermediate_size)
    return config.num_layers * per_layer + h * config.vocab_size


def decode_flops(config, rows: int, steps: int, attn_tokens: int) -> int:
    """FLOPs of one decode call, counted on the host: ``rows`` batch rows
    (every slot row is computed, active or not) for ``steps`` steps at
    two FLOPs per matmul weight element, plus the prefix attention — QK
    and PV, ``4 * Hq * D`` per walked K/V position per layer — over
    ``attn_tokens`` positions a step (the ragged and mega walks: the
    active slots' true-length blocks; the bucketed gather: rows x the
    bucket). The in-call ring's few positions are not counted."""
    walk = 4 * config.num_heads * config.head_dim * config.num_layers
    return steps * (2 * matmul_params(config) * rows + walk * attn_tokens)


def train_step_flops(step_fn, batch) -> Optional[float]:
    """FLOPs of one training step, counted on the host for the step
    functions the port knows: a ``functools.partial`` (nested or not) of a
    function carrying a ``flops_per_token(config, seq_len)`` attribute
    (``llama.train_step``, ``moe.train_step``) with ``config=`` bound,
    over a ``[B, S + 1]`` token batch (B x S trained tokens). ``None``
    for anything else — the caller passes ``flops_per_step`` then; a
    wrong count is never made up."""
    import functools

    fn, kw = step_fn, {}
    while isinstance(fn, functools.partial):
        kw = {**fn.keywords, **kw}
        fn = fn.func
    count = getattr(fn, "flops_per_token", None)
    config = kw.get("config")
    shape = getattr(batch, "shape", None)
    if count is None or config is None or shape is None or len(shape) != 2:
        return None
    B, S = int(shape[0]), int(shape[1]) - 1
    return float(count(config, S)) * B * S


def mfu(flops_per_step: Optional[float], step_seconds: float,
        device=None) -> Optional[float]:
    """Model FLOP utilization: counted FLOPs / (wall x peak)."""
    if not flops_per_step or not step_seconds or step_seconds <= 0:
        return None
    peak = peak_flops(device)
    if peak <= 0:
        return None
    return float(flops_per_step) / (float(step_seconds) * peak)


def _is_integer(dt) -> bool:
    if hasattr(dt, "is_floating_point"):          # a torch dtype
        torch = sys.modules["torch"]
        return not (dt.is_floating_point or dt.is_complex
                    or dt == torch.bool)
    import numpy as np

    return bool(np.issubdtype(np.dtype(dt), np.integer))


def token_count(batch) -> int:
    """Token count of one batch: total elements of its integer-dtype
    tensor/array leaves (token-id tensors), walking dicts, lists and
    tuples; 0 when it has none (the tokens/s gauge then stays unset)."""
    try:
        if isinstance(batch, dict):
            return sum(token_count(v) for v in batch.values())
        if isinstance(batch, (list, tuple)):
            return sum(token_count(v) for v in batch)
        dt = getattr(batch, "dtype", None)
        shape = getattr(batch, "shape", None)
        if dt is None or shape is None or not _is_integer(dt):
            return 0
        n = 1
        for s in shape:
            n *= int(s)
        return n
    except Exception:
        return 0


def hbm_stats(device_id: int = 0) -> Dict[str, int]:
    """``{bytes_in_use, peak_bytes_in_use}`` of one card from the caching
    allocator's host-side counters (no device sync); ``{}`` without a
    card."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_available() \
                or not torch.cuda.is_initialized():
            return {}
        used = int(torch.cuda.memory_allocated(device_id))
        peak = int(torch.cuda.max_memory_allocated(device_id))
    except Exception:
        return {}
    return {"bytes_in_use": used, "peak_bytes_in_use": max(peak, used)}


def update_hbm_gauges(device_id: int = 0) -> Dict[str, int]:
    """Refresh the HBM gauges from card ``device_id``; returns the raw
    stats dict (empty where unavailable). No-op while disabled."""
    if not state.enabled():
        return {}
    s = hbm_stats(device_id)
    if s:
        _M_HBM_USED.set(s["bytes_in_use"])
        _M_HBM_PEAK.set(s["peak_bytes_in_use"])
    return s


def slo_attainment(hist, threshold_seconds: float) -> Optional[float]:
    """Fraction of a histogram's observations at or under the target
    (log-bucket interpolated); ``None`` while it is empty. ``hist`` is a
    Histogram family (read family-wide, merged across children) or a
    single child."""
    if callable(getattr(hist, "series", None)):
        counts, _sum, count = merged_hist_state(hist)
    else:
        counts, _sum, count = _hist_state(hist)
    if not count:
        return None
    return fraction_at_or_below(hist.bounds, counts, threshold_seconds)


def update_serving_slo_gauges(ttft_hist, tpot_hist) -> None:
    """Refresh both SLO-attainment gauges from the live TTFT/TPOT
    histograms against the FLAGS_obs_slo_* targets (written through the
    labelless child: the gauges are process-global)."""
    a = slo_attainment(ttft_hist, float(get_flag("obs_slo_ttft_ms")) / 1e3)
    if a is not None:
        _M_SLO_TTFT.labels().set(a)
    a = slo_attainment(tpot_hist, float(get_flag("obs_slo_tpot_ms")) / 1e3)
    if a is not None:
        _M_SLO_TPOT.labels().set(a)
