"""Optimizers of the port: the functional updates of the train step
(``functional``)."""
from . import functional  # noqa: F401
