"""Optimizers of the port: the functional updates of the train step
(``functional``) and the host-offloaded memory modes built on them
(``offload``: gradient and moment offload, the layer-wise and the
host-streamed train steps)."""
from . import functional  # noqa: F401
from . import offload  # noqa: F401
