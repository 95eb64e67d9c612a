"""Serving for the port: the continuous-batching paged-KV ``LLMEngine``,
its admission control, its crash-surviving wrapper, its prefix cache and
host KV tiers, the HTTP/SSE front door (``http``) and the replica router
with failover and disaggregated prefill/decode (``router``)."""
from .admission import (AdmissionConfig, AdmissionController,  # noqa: F401
                        ShedError, TokenBucket)
from .engine import LLMEngine, Request  # noqa: F401
from .http import HTTPFrontDoor  # noqa: F401
from .kv_swap import HostKVPool  # noqa: F401
from .offload import OffloadEngine  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .resilient import ResilientEngine  # noqa: F401
from .router import Replica, ReplicaRouter  # noqa: F401

__all__ = ["LLMEngine", "Request", "ResilientEngine", "AdmissionConfig",
           "AdmissionController", "ShedError", "TokenBucket",
           "HostKVPool", "PrefixCache", "HTTPFrontDoor", "OffloadEngine",
           "Replica", "ReplicaRouter"]
