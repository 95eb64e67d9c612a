"""Fault-tolerant training and serving runtime of the port — the port's
copy of paddle_tpu/distributed/resilience, with its names:

- :mod:`atomic_ckpt` — torn-write-proof checkpoints: temp dir + fsync +
  per-array checksums + atomic rename + keep-last-N GC, and
  ``load_latest_valid`` that skips corrupt snapshots; the layout and
  bytes are the reference's, so each package loads the other's;
- :mod:`data` — :class:`ResumableIterator`, the checkpointable
  ``(epoch, index)`` data position;
- :mod:`faults` — seeded :class:`FaultInjector` (``FLAGS_ft_fault_schedule``)
  covering NaN/Inf gradients, targeted per-layer NaNs, simulated worker
  death, hangs, storage write failure and the serving faults;
- :mod:`train_loop` — :class:`ResilientTrainLoop`: loss-spike/NaN rollback
  with a bounded retry budget, periodic + SIGTERM/watchdog emergency
  checkpoints, auto-resume of step counter, optimizer state, RNG key and
  data position;
- :mod:`retry` — exponential-backoff retry with full jitter.

Not ported yet: the hapi ``ResilientTraining`` callback (ROADMAP A11).
"""
from . import atomic_ckpt  # noqa: F401
from .atomic_ckpt import (CheckpointCorrupt, list_checkpoints,  # noqa: F401
                          load_checkpoint, load_latest_valid,
                          save_checkpoint, validate_checkpoint)
from .data import ResumableIterator  # noqa: F401
from .faults import (FAULT_KINDS, SERVING_FAULT_KINDS,  # noqa: F401
                     FaultInjector, SimulatedCrash)
from .retry import retry_call  # noqa: F401
from .train_loop import ResilientTrainLoop, is_bad_loss  # noqa: F401

__all__ = [
    "CheckpointCorrupt", "list_checkpoints", "load_checkpoint",
    "load_latest_valid", "save_checkpoint", "validate_checkpoint",
    "ResumableIterator", "FaultInjector", "SimulatedCrash", "retry_call",
    "ResilientTrainLoop", "is_bad_loss", "FAULT_KINDS",
    "SERVING_FAULT_KINDS",
]


def __getattr__(name):
    if name == "ResilientTraining":
        raise NotImplementedError(
            "the hapi ResilientTraining callback is not ported yet "
            "(ROADMAP A11); drive training with ResilientTrainLoop")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
