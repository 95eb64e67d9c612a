"""Framework pieces of the port: the process-wide flag registry
(``flags``), a copy of the JAX package's ``framework/flags.py``."""
from . import flags  # noqa: F401
