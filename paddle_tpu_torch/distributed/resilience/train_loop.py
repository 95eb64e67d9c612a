"""ResilientTrainLoop — a training loop that survives the failure menu;
the port's copy of paddle_tpu/distributed/resilience/train_loop.py.

Wraps a functional ``step_fn(state, batch[, key]) -> (state, loss)``
(e.g. ``models.llama.train_step`` under ``functools.partial``) with the
recovery tiers a production job needs, cheapest first:

1. **rollback + retry** — a non-finite or spiking loss never commits: the
   new state is discarded (the in-memory snapshot is the last accepted
   state) and the SAME batch is retried under a bounded budget. A
   transient fault (injected NaN, flaky interconnect bit) therefore
   recovers bit-exactly; a batch that is bad every time gets skipped
   without an optimizer update.
2. **periodic atomic checkpoints** — step counter, optimizer state, RNG
   base key and dataloader position all land in one manifest
   (:mod:`atomic_ckpt`), plus an EMERGENCY save on SIGTERM (preemption
   notice) and on watchdog timeout (via
   :func:`watchdog.register_emergency_hook`).
3. **crash auto-resume** — ``run()`` first loads the newest VALID
   checkpoint (corrupt ones are skipped) and replays the dataloader to the
   exact batch, so a killed-and-relaunched job converges to the same
   parameters as an uninterrupted one.

**Functional steps only.** Rollback keeps the last accepted state by
reference, so ``step_fn`` must leave its input state as it was:
``llama.train_step`` and ``moe.train_step`` do (they return new tensors).
The layer-wise and streaming steps of ``optimizer/offload.py`` update
their state in place (as do the reference's donated forms); under this
loop a rolled-back attempt would already have changed the state it rolls
back to, so they are not run under it.

**Per-step keys.** The base key is a uint32 ``[2]`` tensor, a leaf under
``"rng"`` of every checkpoint (:func:`prng_key` makes one from a seed, as
``jax.random.PRNGKey``). Step ``n``'s key is :func:`fold_in` ``(base,
n)``: jax's threefry ``fold_in``, computed on the host in plain Python,
so it equals ``jax.random.fold_in(base, n)`` bit for bit. A retry and a
resumed replay of a step therefore get the same key, and
:func:`generator_for` seeds a ``torch.Generator`` from it (seed
``k0 << 32 | k1``).

**MFU.** The reference derives a step's FLOPs from XLA's cost analysis of
``step_fn``. Nothing is lowered here, so the port counts them on the host
(:func:`perf.train_step_flops`) for the step functions it knows — a
``functools.partial`` of ``llama.train_step`` or ``moe.train_step`` with
``config=`` — from their ``flops_per_token``; for any other step it takes
``flops_per_step`` from the caller and, without it, sets no
``train_mfu``.

**Numerics.** The per-layer stats ladders land after a readback
(observability/numerics.py): the loop lands them right after its
``float(loss)`` readback, and the rollback's provenance walk flushes
what is still pending.
"""
from __future__ import annotations

import contextlib
import math
import signal
import sys
import threading
import time
from statistics import median
from typing import Callable, Dict, List, Optional

import torch

from ...observability import flight_recorder as _flight
from ...observability import goodput as _goodput
from ...observability import numerics as _numerics
from ...observability import perf as _perf
from ...observability import profiling as _profiling
from ...observability import state as _obs_state
from ...observability import trace_span
from ...observability.catalog import instrument as _instrument
from . import atomic_ckpt
from .data import ResumableIterator
from .faults import FaultInjector, SimulatedCrash

__all__ = ["ResilientTrainLoop", "is_bad_loss", "prng_key", "fold_in",
           "generator_for"]

# always-on training telemetry (no-ops until FLAGS_obs_enabled; names
# documented in observability.catalog)
_M_STEPS = _instrument("train_steps_total")
_M_STEP_SECONDS = _instrument("train_step_seconds")
_M_ROLLBACKS = _instrument("train_rollbacks_total")
_M_RETRIES = _instrument("train_retries_total")
_M_SKIPPED = _instrument("train_batches_skipped_total")
_M_CKPTS = _instrument("train_checkpoints_total")
_M_EMERGENCY = _instrument("train_emergency_saves_total")
_M_CKPT_SAVE = _instrument("train_checkpoint_save_seconds")
_M_CKPT_LOAD = _instrument("train_checkpoint_load_seconds")
_M_MFU = _instrument("train_mfu")
_M_TPS = _instrument("train_tokens_per_second")


# ---------------------------------------------------------------------------
# per-step keys: jax's threefry PRNGKey / fold_in on the host
# ---------------------------------------------------------------------------
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """Threefry-2x32 (20 rounds) of one counter pair under key (k0, k1),
    as jax's ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key_words(key):
    k = [int(v) for v in torch.as_tensor(key).reshape(-1).tolist()]
    if len(k) != 2:
        raise ValueError(f"a key is 2 uint32 words, got {len(k)}")
    return k[0] & _MASK, k[1] & _MASK


def prng_key(seed: int) -> torch.Tensor:
    """The base key of ``seed`` (0 <= seed < 2**64): uint32 ``[2]`` on the
    CPU, equal to ``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.uint32)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``[2]`` key and an
    integer ``0 <= data < 2**32``: a new uint32 ``[2]`` key on the CPU."""
    k0, k1 = _key_words(key)
    y0, y1 = _threefry2x32(k0, k1, 0, int(data) & _MASK)
    return torch.tensor([y0, y1], dtype=torch.uint32)


def generator_for(key, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``: seed
    ``k0 << 32 | k1``."""
    k0, k1 = _key_words(key)
    return torch.Generator(device=device).manual_seed((k0 << 32) | k1)


def is_bad_loss(loss_val: float, window, spike_factor: float,
                warmup: int) -> Optional[str]:
    """The shared NaN/spike detector: returns a reason string, or None
    when the loss is acceptable. ``window`` is the recent ACCEPTED losses;
    a loss is spiking when it exceeds ``spike_factor`` x their median,
    once at least ``warmup`` of them exist."""
    if not math.isfinite(loss_val):
        return "non_finite_loss"
    if len(window) >= warmup:
        base = median(window)
        if base > 0 and loss_val > spike_factor * base:
            return "loss_spike"
    return None


class ResilientTrainLoop:
    """See module docstring.

    Args:
        step_fn: ``(state, batch) -> (state, loss)`` or, when ``rng_key``
            is given, ``(state, batch, key) -> (state, loss)``; it must
            leave its input state as it was (functional steps only).
        state: initial train state (a nested dict / list / tuple /
            ``TrainState`` of tensors).
        data: batch source — a :class:`ResumableIterator`, or anything it
            accepts (a list of batches, an ``epoch -> iter`` factory).
        ckpt_dir: checkpoint root; ``None`` disables persistence (rollback
            and retry still work).
        ckpt_every: save every N completed steps (0: only emergency/final).
        keep: keep-last-N checkpoint GC.
        rng_key: base key (:func:`prng_key`); per-step keys are
            ``fold_in(base, step)``.
        injector: optional :class:`FaultInjector` (chaos testing).
        watchdog: optional ``CommWatchdog`` guarding each step's blocking
            host sync; its timeout triggers an emergency checkpoint.
        step_timeout: per-step watchdog timeout override.
        max_retries_per_batch / max_total_retries: bounded retry budget.
        max_skips: abort after this many skipped batches (a data problem,
            not a transient).
        spike_factor / spike_window / warmup: loss is "spiking" when it
            exceeds ``spike_factor *`` the median of the last
            ``spike_window`` accepted losses (after ``warmup`` steps).
        on_event: ``fn(event_dict)`` observer for every recovery action.
        flops_per_step: FLOPs one step executes, for the ``train_mfu``
            gauge. ``None`` (default) counts them on the host once, when
            observability is enabled, for a known step function
            (:func:`perf.train_step_flops`); otherwise no MFU is set.
            ``0`` disables the count.
        tokens_per_batch: token count per batch for the
            ``train_tokens_per_second`` gauge. ``None`` infers it from
            the integer-dtype leaves of the batch.
    """

    def __init__(self, step_fn: Callable, state, data, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 keep: int = 3, rng_key=None,
                 injector: Optional[FaultInjector] = None,
                 watchdog=None, step_timeout: Optional[float] = None,
                 hang_seconds: float = 0.5,
                 max_retries_per_batch: int = 2, max_total_retries: int = 16,
                 max_skips: int = 32, spike_factor: float = 10.0,
                 spike_window: int = 32, warmup: int = 5,
                 handle_sigterm: bool = True,
                 on_event: Optional[Callable[[Dict], None]] = None,
                 flops_per_step: Optional[float] = None,
                 tokens_per_batch: Optional[int] = None):
        self.step_fn = step_fn
        self.state = state
        self.data = data if isinstance(data, ResumableIterator) \
            else ResumableIterator(data)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.rng_key = rng_key
        self.injector = injector
        self.watchdog = watchdog
        self.step_timeout = step_timeout
        self.hang_seconds = hang_seconds
        self.max_retries_per_batch = max_retries_per_batch
        self.max_total_retries = max_total_retries
        self.max_skips = max_skips
        self.spike_factor = spike_factor
        self.spike_window = spike_window
        self.warmup = warmup
        self.handle_sigterm = handle_sigterm
        self.on_event = on_event
        self.tokens_per_batch = tokens_per_batch
        self._flops = flops_per_step          # None: count lazily
        self._flops_derivable = flops_per_step is None

        self.step = 0                    # completed optimizer steps
        self.total_retries = 0
        self.skipped_batches = 0
        self.events: List[Dict] = []
        self.resumed_from: Optional[int] = None
        self._loss_window: List[float] = []
        self._sigterm = False
        self._save_lock = threading.Lock()
        # loader position of the last COMMITTED step. Checkpoints record
        # this, not the live position: an emergency save fired mid-step
        # (watchdog thread) must not mark the in-flight batch consumed,
        # or resume would silently drop it
        self._committed_pos = self.data.state_dict()

    # -- events -----------------------------------------------------------
    def _event(self, kind: str, **detail):
        ev = {"step": self.step, "kind": kind, **detail}
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    # -- checkpoint plumbing ----------------------------------------------
    def _ckpt_tree(self):
        tree = {"state": self.state}
        if self.rng_key is not None:
            tree["rng"] = self.rng_key
        return tree

    def _save(self, tag: str = "periodic") -> bool:
        if self.ckpt_dir is None:
            return False
        with self._save_lock:
            hook = None
            if self.injector is not None:
                hook = self.injector.storage_hook(self.step)
            meta = {"step": self.step, "loader": self._committed_pos,
                    "tag": tag, "skipped_batches": self.skipped_batches,
                    "loss_window": self._loss_window[-self.spike_window:]}
            try:
                t0 = time.perf_counter()
                with trace_span("train.checkpoint", tag=tag,
                                step=self.step):
                    atomic_ckpt.save_checkpoint(
                        self._ckpt_tree(), self.ckpt_dir, self.step,
                        meta=meta, keep=self.keep, fail_hook=hook)
                dt = time.perf_counter() - t0
                _M_CKPT_SAVE.observe(dt)
                _goodput.account("checkpoint_save", dt)
                _M_CKPTS.inc(tag=tag)
                if tag.startswith("emergency"):
                    _M_EMERGENCY.inc()
                _flight.record("checkpoint", step=self.step, tag=tag,
                               seconds=round(dt, 6))
                self._event("checkpoint_saved", tag=tag)
                return True
            except (OSError, IOError) as e:
                # previous snapshot stays authoritative; the job goes on
                self._event("checkpoint_failed", tag=tag, error=str(e))
                sys.stderr.write(
                    f"[paddle_tpu_torch resilience] checkpoint at step "
                    f"{self.step} failed ({e}); previous snapshot remains\n")
                return False

    def resume(self) -> bool:
        """Load the newest valid checkpoint, restoring step counter,
        train/optimizer state, RNG base key and dataloader position.
        Returns True when a checkpoint was restored."""
        if self.ckpt_dir is None:
            return False
        t0 = time.perf_counter()
        with trace_span("train.resume"):
            got = atomic_ckpt.load_latest_valid(self.ckpt_dir,
                                                self._ckpt_tree())
        t_load = time.perf_counter() - t0
        if got is None:
            return False
        _M_CKPT_LOAD.observe(t_load)
        _goodput.account("checkpoint_load", t_load)
        t1 = time.perf_counter()
        tree, manifest = got
        self.state = tree["state"]
        if self.rng_key is not None:
            self.rng_key = tree["rng"]
        meta = manifest.get("meta", {})
        self.step = int(meta.get("step", manifest["step"]))
        self.skipped_batches = int(meta.get("skipped_batches", 0))
        self._loss_window = list(meta.get("loss_window", []))
        if meta.get("loader"):
            self.data.load_state_dict(meta["loader"])
        self._committed_pos = self.data.state_dict()
        self.resumed_from = self.step
        # restore + loader replay are resume badput distinct from the
        # checkpoint read itself
        _goodput.account("resume", time.perf_counter() - t1)
        _flight.record("resumed", step=self.step, tag=meta.get("tag"))
        self._event("resumed", tag=meta.get("tag"))
        return True

    # -- fault detection ---------------------------------------------------
    def _is_bad(self, loss_val: float) -> Optional[str]:
        return is_bad_loss(loss_val, self._loss_window, self.spike_factor,
                           self.warmup)

    # -- one guarded step --------------------------------------------------
    def _guard(self):
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.task(f"train-step-{self.step}",
                                  timeout=self.step_timeout)

    def _attempt(self, batch):
        inj = self.injector
        if inj is not None and inj.fires("crash", self.step):
            self._event("crash_injected")
            raise SimulatedCrash(f"injected crash at step {self.step}")
        hang = inj is not None and inj.fires("collective_timeout", self.step)
        state_in = self.state
        if inj is not None:
            tgt = inj.take_arg("nan_inject", self.step)
            if tgt is not None:
                # targeted NaN: poison ONE layer group of this attempt's
                # input state (self.state stays clean — the retry after
                # the rollback recovers bit-exactly; take_arg is
                # one-shot). The forward goes non-finite from exactly
                # that layer, which the numerics provenance ladder must
                # then name.
                layer = int(tgt or 0)
                self._event("nan_injected", layer=layer)
                _flight.record("nan_inject", step=self.step, layer=layer)
                state_in = FaultInjector.poison_layer(self.state, layer)
        with self._guard():
            if hang:
                self._event("hang_injected", seconds=self.hang_seconds)
                time.sleep(self.hang_seconds)
            if self.rng_key is not None:
                key = fold_in(self.rng_key, self.step)
                new_state, loss = self.step_fn(state_in, batch, key)
            else:
                new_state, loss = self.step_fn(state_in, batch)
            poison = None
            if inj is not None:
                if inj.fires("nan_grad", self.step):
                    poison = "nan_grad"
                elif inj.fires("inf_grad", self.step):
                    poison = "inf_grad"
            if poison is not None:
                self._event("grad_fault_injected", fault=poison)
                new_state = FaultInjector.poison(new_state, poison)
                loss_val = float("nan") if poison == "nan_grad" \
                    else float("inf")
            else:
                loss_val = float(loss)               # blocking host sync
            # the step's stat rungs were enqueued before that readback
            _numerics.land()
        return new_state, loss_val

    # -- the run loop ------------------------------------------------------
    def run(self, num_steps: int):
        """Train until ``num_steps`` COMPLETED steps (checkpointed progress
        counts: a resumed run does only the remainder). Returns the final
        state."""
        from ..watchdog import register_emergency_hook, \
            unregister_emergency_hook

        # goodput wall-clock starts here: anything before the first
        # accounted interval (resume included) is visible, not lost
        _goodput.get_tracker().ensure_started()
        self.resume()

        def on_wd_timeout(name, elapsed):
            self._event("watchdog_emergency", task=name, elapsed=elapsed)
            self._save(tag="emergency-watchdog")

        register_emergency_hook(on_wd_timeout)
        old_handler = None
        if self.handle_sigterm:
            def on_sigterm(signum, frame):
                self._sigterm = True
            try:
                old_handler = signal.signal(signal.SIGTERM, on_sigterm)
            except ValueError:       # not the main thread
                old_handler = None
        try:
            with trace_span("train.run", target_steps=num_steps):
                while self.step < num_steps:
                    if self._sigterm:
                        self._event("sigterm")
                        _flight.record("sigterm", step=self.step)
                        self._save(tag="emergency-sigterm")
                        _flight.maybe_dump("sigterm")
                        break
                    batch = next(self.data)
                    self._run_batch(batch)
                    if (self.ckpt_every and self.step > 0
                            and self.step % self.ckpt_every == 0):
                        self._save(tag="periodic")
                else:
                    if self.ckpt_dir is not None:
                        self._save(tag="final")
        except BaseException as e:
            # the crash post-mortem: ring events + metrics snapshot +
            # open spans, written BEFORE the exception propagates (the
            # relaunched process starts from a clean registry)
            _flight.record("exception", step=self.step,
                           error=type(e).__name__,
                           message=str(e)[:500])
            _flight.maybe_dump("exception", error=e)
            raise
        finally:
            unregister_emergency_hook(on_wd_timeout)
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            if _obs_state.enabled():
                _goodput.get_tracker().report()   # refresh goodput_ratio
        return self.state

    def _run_batch(self, batch) -> None:
        """One batch through the rollback/retry tier; commits at most one
        optimizer step."""
        retries = 0
        while True:
            # on-demand device-capture window boundary (profiling
            # control plane; one module-global read when nothing armed)
            _profiling.step_tick()
            # numerics epoch boundary: per-layer stat rungs landed by
            # THIS attempt carry this epoch, scoping the provenance walk
            # below to it (one global read when numerics is off)
            num_epoch = _numerics.step_mark()
            t0 = time.perf_counter()
            with trace_span("train.step", step=self.step, retry=retries):
                new_state, loss_val = self._attempt(batch)
            dt = time.perf_counter() - t0
            _M_STEP_SECONDS.observe(dt)
            bad = self._is_bad(loss_val)
            if bad is None:
                self.state = new_state        # commit
                self.step += 1
                _M_STEPS.inc()
                # a committed attempt is goodput
                _goodput.account("productive_step", dt)
                _flight.record("step", step=self.step,
                               seconds=round(dt, 6))
                self._update_efficiency(batch, dt)
                self._loss_window.append(loss_val)
                del self._loss_window[:-self.spike_window]
                self._committed_pos = self.data.state_dict()
                return
            # roll back: new_state is dropped, self.state is the snapshot
            _goodput.account("rollback_retry", dt)
            # NaN provenance: walk this attempt's stats ladder for the
            # first layer whose NaN/Inf count went nonzero — the answer
            # rides the rollback flight event and (via numerics.payload)
            # the JSON post-mortem. A rollback is an incident: the flush
            # inside provenance() is deliberate.
            first_bad = _numerics.provenance(num_epoch)
            bad_kw = {} if first_bad is None else {"first_bad": first_bad}
            _flight.record("rollback", step=self.step, reason=bad,
                           retry=retries, loss=repr(loss_val), **bad_kw)
            self._event("rollback", reason=bad, loss=loss_val,
                        retry=retries, **bad_kw)
            _M_ROLLBACKS.inc(reason=bad)
            del new_state
            retries += 1
            self.total_retries += 1
            if (retries <= self.max_retries_per_batch
                    and self.total_retries <= self.max_total_retries):
                _M_RETRIES.inc()
                continue                      # retry the SAME batch
            self.skipped_batches += 1
            self._event("batch_skipped", reason=bad)
            _flight.record("batch_skipped", step=self.step, reason=bad)
            _M_SKIPPED.inc()
            # the skip is a decision, not an accident: checkpoints made
            # from here on must not replay the dropped batch
            self._committed_pos = self.data.state_dict()
            if self.skipped_batches > self.max_skips:
                raise RuntimeError(
                    f"resilience: skipped {self.skipped_batches} batches "
                    f"(> max_skips={self.max_skips}); data or numerics "
                    "are systematically bad, refusing to spin")
            return                            # drop batch, no commit

    def _update_efficiency(self, batch, dt: float) -> None:
        """Refresh train_mfu / train_tokens_per_second / HBM gauges after
        a committed step. One boolean check while disabled."""
        if not _obs_state.enabled() or dt <= 0:
            return
        if self._flops is None and self._flops_derivable:
            # counted once on the host for a step function the port
            # knows; anything else sets no MFU rather than a wrong one
            self._flops_derivable = False
            self._flops = _perf.train_step_flops(self.step_fn, batch)
        m = _perf.mfu(self._flops, dt)
        if m is not None:
            _M_MFU.set(m)
        tokens = self.tokens_per_batch
        if tokens is None:
            tokens = self.tokens_per_batch = _perf.token_count(batch)
        if tokens:
            _M_TPS.set(tokens / dt)
        _perf.update_hbm_gauges()

