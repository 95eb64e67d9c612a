"""Fault tolerance of the port: the seeded :class:`FaultInjector` and
:class:`SimulatedCrash` (``faults``), the port's own copy of the JAX
package's ``distributed/resilience/faults.py``. The checkpoint, retry and
train-loop modules of that package are not ported yet."""
from .faults import (FAULT_KINDS, SERVING_FAULT_KINDS,  # noqa: F401
                     FaultInjector, SimulatedCrash)

__all__ = ["FaultInjector", "SimulatedCrash", "FAULT_KINDS",
           "SERVING_FAULT_KINDS"]
