"""Retry with exponential backoff + full jitter for transient failures —
the port's copy of paddle_tpu/distributed/resilience/retry.py.

Rendezvous, store connects and replica bootstrap are the classic
transient-failure zone: the master's port is in TIME_WAIT, a peer is
still booting, the first connection drops. One policy serves them all;
the serving router re-dispatches streams and boots replicas through it.

Jitter matters at fleet scale: a fleet-wide restart brings N replicas
back off the SAME failure at the SAME instant, and a fixed exponential
schedule has all N reconnect in lockstep — every retry wave is a
synchronized thundering herd. Each delay is therefore drawn uniformly
from ``(0, cap]`` where ``cap`` is the exponential envelope (AWS "full
jitter"): the herd spreads over the whole window while the envelope
still bounds total wait. The flags, defaults and schedule equal the
reference's.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Tuple, Type

from ...framework.flags import define_flag, get_flag

__all__ = ["retry_call"]

define_flag("ft_bootstrap_retries", 3,
            "retry count for store/collective bootstrap (exponential "
            "backoff); 0 disables retries")
define_flag("ft_bootstrap_backoff", 0.1,
            "base delay in seconds for bootstrap retry backoff")
define_flag("ft_bootstrap_jitter", True,
            "full jitter on the bootstrap backoff: each delay is uniform "
            "in (0, envelope] so restarting replicas spread instead of "
            "thundering the store in lockstep")


def retry_call(fn: Callable, *args,
               retries: int = None, base_delay: float = None,
               factor: float = 2.0, max_delay: float = 10.0,
               exceptions: Tuple[Type[BaseException], ...] = (Exception,),
               on_retry: Callable = None, sleep: Callable = time.sleep,
               jitter: bool = None, rand: Callable[[], float] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on an exception in ``exceptions``,
    retry up to ``retries`` more times. The attempt's delay envelope is
    ``min(max_delay, base_delay * factor**attempt)``; with ``jitter``
    (default: ``FLAGS_ft_bootstrap_jitter``) the actual delay is drawn
    uniformly from (0, envelope] — ``rand`` is injectable (a seeded
    ``random.Random(...).random``) for deterministic tests, as is
    ``sleep``. The last failure re-raises; ``on_retry(attempt, exc)``
    observes each retry."""
    if retries is None:
        retries = get_flag("ft_bootstrap_retries")
    if base_delay is None:
        base_delay = get_flag("ft_bootstrap_backoff")
    if jitter is None:
        jitter = get_flag("ft_bootstrap_jitter")
    if rand is None:
        rand = random.random
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            cap = min(max_delay, base_delay * (factor ** attempt))
            sleep(cap * rand() if jitter else cap)
            attempt += 1
