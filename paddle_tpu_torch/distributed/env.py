"""Process/bootstrap environment — the port's copy of
paddle_tpu/distributed/env.py.

Parity: python/paddle/distributed/parallel.py:978 init_parallel_env and the
PADDLE_* env contract (launch/controllers/collective.py:126-241). A torch
process drives one device, so a job of N devices is N ranks of one
``torch.distributed`` process group: ``init_parallel_env`` reads the same
env contract as the reference (``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ID``, ``PADDLE_MASTER``) and calls
``torch.distributed.init_process_group`` with a ``tcp://`` rendezvous at
the master, under the reference's backoff (``retry_call``, counted in
``dist_init_retries_total``).

The backend is explicit: the ``backend`` argument, else Paddle's
``PADDLE_DISTRI_BACKEND``, else ``"nccl"`` when CUDA is available and
``"gloo"`` otherwise. A backend that fails to come up raises; it is never
swapped for another.
"""
from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "is_initialized",
           "init_parallel_env", "device_world_size", "local_device_count",
           "default_backend"]

_initialized = False


class ParallelEnv:
    """parity: paddle.distributed.ParallelEnv."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK", 0))

    @property
    def dev_id(self) -> int:
        return self.local_rank

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def current_endpoint(self) -> str:
        eps = self.trainer_endpoints
        return eps[self.rank] if self.rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")


def get_rank(group=None) -> int:
    """This process's rank in the job (0 without a process group), or
    its rank within ``group`` (-1 when it is not a member)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if group is not None:
        return group.get_group_rank(rank)
    return rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


def is_initialized() -> bool:
    return _initialized or dist.is_initialized()


def default_backend() -> str:
    """``PADDLE_DISTRI_BACKEND`` when set, else ``"nccl"`` with CUDA and
    ``"gloo"`` without."""
    env = os.environ.get("PADDLE_DISTRI_BACKEND")
    if env:
        return env
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_parallel_env(backend=None, timeout=None):
    """parity: paddle.distributed.init_parallel_env (parallel.py:978).

    Reads the PADDLE_* env contract and brings up the default process
    group when a multi-process job is described (``PADDLE_TRAINERS_NUM``
    > 1 and ``PADDLE_MASTER`` set). A single process needs no
    initialization: it is a world of one. ``backend`` overrides
    :func:`default_backend`; ``timeout`` (seconds) bounds each attempt's
    rendezvous (torch's default when None)."""
    global _initialized
    if _initialized:
        return ParallelEnv()
    coord = os.environ.get("PADDLE_MASTER")
    nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    pid = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if coord and nprocs > 1 and not dist.is_initialized():
        # rendezvous bring-up is the classic transient (peer pods still
        # booting, port in TIME_WAIT): retry with exponential backoff
        # before declaring the job dead
        from .resilience.retry import retry_call

        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        chosen = backend or default_backend()

        def init_once():
            try:
                dist.init_process_group(chosen, init_method=f"tcp://{coord}",
                                        world_size=nprocs, rank=pid, **kw)
            except (RuntimeError, ValueError) as e:
                # a previous attempt got partway: that's success, not a
                # failure to retry (retrying would mask the real state)
                if dist.is_initialized() \
                        or "twice" in str(e).lower() \
                        or "already initialized" in str(e).lower():
                    return
                raise

        from ..observability.catalog import instrument

        retry_counter = instrument("dist_init_retries_total")

        def log_retry(attempt, exc):
            retry_counter.inc()
            sys.stderr.write(
                f"[paddle_tpu distributed] init attempt {attempt + 1} "
                f"failed ({exc}); retrying with backoff\n")

        retry_call(init_once, on_retry=log_retry)
    _initialized = True
    return ParallelEnv()


def device_world_size() -> int:
    """Total devices in the job (the SPMD parallel width): one a rank."""
    return get_world_size()


def local_device_count() -> int:
    """Devices on this host: the CUDA devices, or 1 on a CPU host."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
