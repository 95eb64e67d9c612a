"""Distributed runtime pieces of the port: :mod:`resilience` (the seeded
fault injector the serving engine's chaos surface reads, and
``retry_call``) and :mod:`watchdog` (hang detection over guarded blocking
regions, which the serving router's replica steps run under)."""
