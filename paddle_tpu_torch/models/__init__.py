"""Models of the port: the Llama family (``llama``)."""
from . import llama  # noqa: F401
