"""Serving for the port: the continuous-batching paged-KV ``LLMEngine``,
its admission control, its crash-surviving wrapper, its prefix cache and
its host KV tiers."""
from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        ShedError, TokenBucket)
from .engine import LLMEngine, Request  # noqa: F401
from .kv_swap import HostKVPool  # noqa: F401
from .offload import OffloadEngine  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .resilient import ResilientEngine  # noqa: F401

__all__ = ["LLMEngine", "Request", "ResilientEngine", "AdmissionConfig",
           "AdmissionController", "ShedError", "TokenBucket",
           "HostKVPool", "OffloadEngine", "PrefixCache"]
