"""The port's jit layer: so far only ``cache``, the persistent artifact
cache (a copy of the JAX package's ``jit/cache.py``)."""
from . import cache  # noqa: F401
