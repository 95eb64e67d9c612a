"""Fault tolerance of the port: the seeded :class:`FaultInjector` and
:class:`SimulatedCrash` (``faults``) and :func:`retry_call` (``retry``,
exponential backoff with full jitter), the port's own copies of the JAX
package's ``distributed/resilience/faults.py`` and ``retry.py``. The
checkpoint and train-loop modules of that package are not ported yet."""
from .faults import (FAULT_KINDS, SERVING_FAULT_KINDS,  # noqa: F401
                     FaultInjector, SimulatedCrash)
from .retry import retry_call  # noqa: F401

__all__ = ["FaultInjector", "SimulatedCrash", "FAULT_KINDS",
           "SERVING_FAULT_KINDS", "retry_call"]
