"""Serving for the port: the continuous-batching paged-KV ``LLMEngine``,
its prefix cache and its host KV tiers."""
from .engine import LLMEngine, Request  # noqa: F401
from .kv_swap import HostKVPool  # noqa: F401
from .offload import OffloadEngine  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401

__all__ = ["LLMEngine", "Request", "HostKVPool", "OffloadEngine",
           "PrefixCache"]
