"""Distributed runtime pieces of the port. So far only
:mod:`resilience.faults`, the seeded fault injector the serving engine's
chaos surface reads (a copy of the JAX package's
``distributed/resilience/faults.py``)."""
