"""Admission control and load shedding for the serving engine — the
port's copy of paddle_tpu/serving/admission.py.

Under sustained overload an uncontrolled engine queue grows without
bound: every queued request eventually runs, but time to first token
collapses for all of them. Admission control turns that into graceful
degradation: a bounded admission queue, per-tenant token-bucket rate
limits, and a reject-newest shed policy driven by the engine's own
pressure signals (queue depth, KV block-pool headroom). A shed request
fails at once with a typed error a front end can turn into HTTP 429/503
with a retry-after.

Policy order (first breach wins; the stateless checks run BEFORE the
token bucket is charged, so a request shed for queue or pool reasons
never burns its tenant's rate budget):

1. ``queue_full``   — admission queue at ``max_queue`` entries;
2. ``pool_pressure`` — free KV blocks below ``shed_free_frac`` of the
   pool while work is queued. The engine's ``free_frac`` is CACHE-AWARE:
   refcount-0 prefix-cache blocks are reclaimable on demand, so a pool
   that merely looks full of evictable prefixes never sheds;
3. ``rate_limited`` — the request's tenant bucket lacks
   ``prompt + max_new_tokens`` tokens.

The controller is a pure policy object — the engine owns the queue and
raises :class:`ShedError`; tests drive ``check`` directly with an
injected clock. Every shed bumps ``serving_shed_total{reason}`` (no-op
while observability is off) and the host count ``sheds``, which the
metric mirrors.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable, Dict, Optional

from ..observability.catalog import instrument as _instrument

__all__ = ["AdmissionConfig", "AdmissionController", "ShedError",
           "TokenBucket"]

_M_SHED = _instrument("serving_shed_total")


class ShedError(RuntimeError):
    """A request rejected by admission control (load shedding).

    ``reason`` is one of ``queue_full`` / ``rate_limited`` /
    ``pool_pressure``; ``req_id`` is the id the engine minted for the
    rejected request (its finish reason is ``shed``).
    """

    def __init__(self, reason: str, req_id=None):
        super().__init__(
            f"request{'' if req_id is None else f' {req_id}'} shed: "
            f"{reason}")
        self.reason = reason
        self.req_id = req_id


@dataclasses.dataclass
class AdmissionConfig:
    """Shed-policy knobs. Zero values disable the corresponding check
    (``max_queue`` excepted: a bounded queue is the point)."""

    max_queue: int = 64          # admission-queue depth bound
    rate_tokens_per_s: float = 0.0   # per-tenant refill rate (0 = off)
    burst_tokens: float = 0.0    # bucket capacity (0 = 2s of rate)
    shed_free_frac: float = 0.0  # shed when free-block fraction < this
    #                              while the queue is non-empty (0 = off)


class TokenBucket:
    """Classic token bucket; ``take`` is O(1) and monotone in ``now``."""

    __slots__ = ("rate", "capacity", "tokens", "t_last")

    def __init__(self, rate: float, capacity: float, now: float):
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.tokens = float(capacity)    # full bucket: bursts admit
        self.t_last = float(now)

    def take(self, cost: float, now: float) -> bool:
        self.tokens = min(self.capacity,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class AdmissionController:
    """Stateful shed policy: one token bucket per tenant plus the
    stateless queue/pool checks. ``now_fn`` is injectable so rate-limit
    tests advance a virtual clock. ``sheds`` counts every shed by
    reason."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.config = config or AdmissionConfig()
        self._now = now_fn
        self._buckets: Dict[str, TokenBucket] = {}
        self.sheds: Counter = Counter()

    def check(self, req, queue_depth: int,
              free_frac: float = 1.0) -> Optional[str]:
        """Return a shed reason for ``req`` (an ``engine.Request``), or
        ``None`` to admit. Counts every shed in ``sheds``."""
        c = self.config
        reason = None
        if c.max_queue and queue_depth >= c.max_queue:
            reason = "queue_full"
        elif c.shed_free_frac > 0 and queue_depth > 0 \
                and free_frac < c.shed_free_frac:
            reason = "pool_pressure"
        elif c.rate_tokens_per_s > 0:
            # charged LAST: a request shed above never ran and must not
            # drain its tenant's budget
            now = self._now()
            bucket = self._buckets.get(req.tenant)
            if bucket is None:
                cap = c.burst_tokens or 2.0 * c.rate_tokens_per_s
                bucket = self._buckets[req.tenant] = TokenBucket(
                    c.rate_tokens_per_s, cap, now)
            cost = len(req.prompt) + int(req.max_new_tokens)
            if not bucket.take(cost, now):
                reason = "rate_limited"
        if reason is not None:
            self.sheds[reason] += 1
            _M_SHED.inc(reason=reason)
        return reason

    def spill_free_frac(self, default: float) -> float:
        """Proactive-spill pressure threshold derived from this
        controller's own shed signal: background cold-block spilling must
        engage BEFORE ``pool_pressure`` starts shedding, so when a
        ``shed_free_frac`` is configured the spiller arms at twice it
        (never below the engine's flag ``default``)."""
        c = self.config
        if c.shed_free_frac > 0:
            return max(float(default), 2.0 * c.shed_free_frac)
        return float(default)

    def retry_after(self, tenant: str, cost: float) -> float:
        """Seconds until ``tenant``'s bucket could afford ``cost``
        tokens — the ``Retry-After`` of a ``rate_limited`` shed. 0.0 when
        no rate limit applies or the tenant has no bucket yet; a cost
        beyond the bucket's whole capacity reports the time to fill it."""
        c = self.config
        if c.rate_tokens_per_s <= 0:
            return 0.0
        bucket = self._buckets.get(tenant)
        if bucket is None:
            return 0.0
        now = self._now()
        tokens = min(bucket.capacity,
                     bucket.tokens
                     + (now - bucket.t_last) * bucket.rate)
        deficit = min(float(cost), bucket.capacity) - tokens
        return max(0.0, deficit / bucket.rate)
