"""Serving for the port: the continuous-batching paged-KV ``LLMEngine``."""
from .engine import LLMEngine, Request  # noqa: F401

__all__ = ["LLMEngine", "Request"]
