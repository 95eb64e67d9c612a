"""Crash-surviving wrapper over :class:`~paddle_tpu_torch.serving.LLMEngine`
— the port's copy of paddle_tpu/serving/resilient.py.

The engine's state machine is host-side and consistent at step
boundaries, so recovery from a crashed step is cheap and total: drop the
poisoned in-flight wave (its tokens were never host-visible — the stream
stays exactly-once), requeue every in-flight request from its host state
(``prompt + generated + slot_out``: everything already streamed is kept
and never re-emitted), rebuild the device carry, and keep serving. The
pools' contents are suspect after a crash, so the requeue is always
recompute: the KV swap tier is bypassed on this path.

    eng = LLMEngine(params, cfg, injector=FaultInjector("readback_fail@4"))
    results = ResilientEngine(eng).run()

By default only the injectable
:class:`~paddle_tpu_torch.distributed.resilience.SimulatedCrash` counts
as a crashed step: a CUDA error, a kernel build failure or a launch
failure propagates. A recovery bumps ``serving_engine_recoveries_total``
and lands a ``serving_step_recovered`` flight event (both no-ops while
observability is off); ``recoveries`` counts on the host as well.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

from ..distributed.resilience.faults import SimulatedCrash
from ..observability import flight_recorder as _flight
from ..observability.catalog import instrument as _instrument

__all__ = ["ResilientEngine"]

_M_RECOVERIES = _instrument("serving_engine_recoveries_total")


class ResilientEngine:
    """Catch a crashed ``step()``, recover the engine, keep serving.

    ``recoverable``: exception types treated as a crashed step (default:
    the injectable :class:`SimulatedCrash`). Anything else propagates.
    ``max_recoveries`` bounds the crash budget — a deterministically
    crashing engine must surface, not spin.
    """

    def __init__(self, engine,
                 recoverable: Tuple[Type[BaseException], ...]
                 = (SimulatedCrash,),
                 max_recoveries: int = 8):
        self.engine = engine
        self.recoverable = tuple(recoverable)
        self.max_recoveries = int(max_recoveries)
        self.recoveries = 0

    # -- engine surface ---------------------------------------------------
    def add_request(self, prompt, **kw) -> int:
        return self.engine.add_request(prompt, **kw)

    def has_work(self) -> bool:
        return self.engine.has_work()

    @property
    def results(self) -> Dict[int, List[int]]:
        return self.engine.results

    @property
    def finish_reasons(self) -> Dict[int, str]:
        return self.engine.finish_reasons

    # -- the wrapper ------------------------------------------------------
    def step(self):
        """One engine step; on a recoverable crash, drop the poisoned
        wave, requeue its requests, and return the tokens the step had
        already committed before it died. Those ride the engine's salvage
        buffer and are delivered here exactly once (the requeue moves
        them to ``generated``, so re-admission never re-emits them)."""
        try:
            return self.engine.step()
        except self.recoverable as e:
            self.recoveries += 1
            if self.recoveries > self.max_recoveries:
                raise
            _M_RECOVERIES.inc()
            _flight.record("serving_step_recovered",
                           error=f"{type(e).__name__}: {e}"[:160],
                           recoveries=self.recoveries,
                           salvaged=len(self.engine._step_emitted))
            salvaged = list(self.engine._step_emitted)
            self.engine.recover_crashed_step()
            return salvaged

    def run(self) -> Dict[int, List[int]]:
        while self.engine.has_work():
            self.step()
        if self.engine._inflight is not None:   # defensive, as engine.run
            self.engine._process_inflight()
        self.engine.drain_offload()
        return self.engine.results
