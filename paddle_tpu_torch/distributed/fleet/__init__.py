"""paddle_tpu_torch.distributed.fleet (parity:
python/paddle/distributed/fleet/) — the collective half of the port of
paddle_tpu/distributed/fleet.

fleet.init (reference fleet.py:218) brings the process group up
(``init_parallel_env``) and builds the hybrid topology: the axis order
comes from hybrid_configs["order"] (default outside→inside
['dp','pp','sharding','sep','mp'] — reference:
fleet/base/distributed_strategy.py:1892-1931), a dp degree left at 1 (or
-1/0) takes the ranks the other axes leave, and
:class:`~.topology.HybridCommunicateGroup` creates every axis's process
groups on every rank.

``distributed_model`` wraps a model by the hybrid group's sizes (pipe
first: ``PipelineParallel``, which raises naming ROADMAP A10.3; then model
parallel: ``TensorParallel``; then data parallel: ``DataParallel`` over
the data-parallel group) and ``distributed_optimizer`` in a
``HybridParallelOptimizer``, as the reference's fleet.py does.

Not ported yet: the parameter-server half (``init_server``,
``run_server``, ``init_worker``, ``stop_worker``; A10.6), which raises
naming its item.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..env import get_rank, get_world_size, init_parallel_env
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, get_hybrid_communicate_group,
    set_hybrid_communicate_group,
)

_AXIS_TO_NAME = {"dp": "data", "pp": "pipe", "sharding": "sharding",
                 "sep": "sep", "mp": "model"}


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"fleet.{what} is not ported yet (ROADMAP {item})")


class DistributedStrategy:
    """parity: fleet/base/distributed_strategy.py:284 (proto-backed config
    re-expressed as a plain attribute bag)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1}
        self.sharding = False
        self.sharding_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class _Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False
        self._role_maker = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level=0):
        """parity: fleet.fleet.init (fleet.py:218), collective mode. A
        parameter-server role maker (``is_collective=False``) raises: the
        PS runtime is ROADMAP A10.6."""
        self._role_maker = role_maker
        if role_maker is not None and not getattr(
                role_maker, "_is_collective", True):
            is_collective = False
        if not is_collective:
            _unported("init(is_collective=False) (parameter-server mode)",
                      "A10.6")
        init_parallel_env()
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        order = hc.get("order", ["dp", "pp", "sharding", "sep", "mp"])
        total = get_world_size()
        degrees = {a: int(hc.get(f"{a}_degree", 1) or 1) for a in order}
        # fill a -1/unset dp axis with the remaining parallelism
        known = int(np.prod([d for a, d in degrees.items() if d > 0 and a != "dp"]))
        if degrees.get("dp", 1) in (-1, 0) or \
                (degrees.get("dp", 1) == 1 and known < total and
                 total % max(known, 1) == 0):
            degrees["dp"] = total // max(known, 1)
        names = [_AXIS_TO_NAME[a] for a in order]
        dims = [degrees[a] for a in order]
        topo = CommunicateTopology(names, dims)
        self._hcg = HybridCommunicateGroup(topo)
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    def is_first_worker(self):
        return get_rank() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    @property
    def worker_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    def distributed_model(self, model):
        """parity: fleet/model.py:33 — ``model`` wrapped by the hybrid
        group's sizes (as it is before ``init`` or on one rank)."""
        from ..parallel import DataParallel
        from .meta_parallel import PipelineParallel, TensorParallel

        hcg = self._hcg
        if hcg is None:
            return model
        if hcg.get_pipe_parallel_world_size() > 1:
            if not isinstance(model, PipelineParallel):
                model = PipelineParallel(model, hcg, self._strategy)
            return model
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, self._strategy)
        if hcg.get_data_parallel_world_size() > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """parity: fleet.py:1448 — ``optimizer`` in a
        ``HybridParallelOptimizer`` (as it is before ``init``)."""
        from .hybrid_optimizer import HybridParallelOptimizer

        self._user_defined_optimizer = optimizer
        if self._hcg is None:
            return optimizer
        return HybridParallelOptimizer(
            optimizer, self._hcg,
            strategy or self._strategy or DistributedStrategy())

    # -- parameter-server mode (ROADMAP A10.6) ------------------------------
    def is_server(self):
        rm = self._role_maker
        return rm is not None and rm._is_server()

    def is_worker(self):
        rm = self._role_maker
        return rm is None or rm._is_worker()

    def init_server(self, *args, **kwargs):
        _unported("init_server", "A10.6")

    def run_server(self):
        _unported("run_server", "A10.6")

    def init_worker(self, *args, **kwargs):
        _unported("init_worker", "A10.6")

    def stop_worker(self):
        _unported("stop_worker", "A10.6")


fleet = _Fleet()

# module-level function parity (paddle.distributed.fleet.init etc.)
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker


# reference fleet/__init__.py __all__ classes
Fleet = _Fleet


class Role:
    """parity: fleet/base/role_maker.py Role constants."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        self._role = Role.WORKER

    def _worker_index(self):
        return get_rank()

    def _worker_num(self):
        return get_world_size()

    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER


class PaddleCloudRoleMaker(RoleMakerBase):
    """parity: fleet/base/role_maker.py PaddleCloudRoleMaker — roles from
    the PADDLE_* env contract. Defaults is_collective=False like the
    reference; collective jobs pass is_collective=True."""

    def __init__(self, is_collective=False, **kwargs):
        super().__init__(is_collective, **kwargs)
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        if not is_collective and role == "PSERVER":
            self._role = Role.SERVER


class UserDefinedRoleMaker(RoleMakerBase):
    """parity: role_maker.py UserDefinedRoleMaker — explicit role config."""

    def __init__(self, is_collective=True, current_id=0, role=Role.WORKER,
                 worker_num=None, server_endpoints=None, **kwargs):
        super().__init__(is_collective, **kwargs)
        self._current_id = current_id
        self._role = role
        self._worker_num_ = worker_num
        self._server_endpoints = server_endpoints or []

    def _worker_index(self):
        return self._current_id

    def _worker_num(self):
        if self._worker_num_ is not None:
            return self._worker_num_
        return super()._worker_num()


class UtilBase:
    """parity: fleet/base/util_factory.py UtilBase — small cross-worker
    utilities over the collective API (numpy in, numpy out)."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        import torch

        from ..collective import ReduceOp, all_reduce

        t = torch.as_tensor(np.array(input))
        op = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
              "min": ReduceOp.MIN}[mode]
        all_reduce(t, op)
        return t.numpy()

    def barrier(self, comm_world="worker"):
        from ..collective import barrier

        barrier()

    def all_gather(self, input, comm_world="worker"):  # noqa: A002
        from ..collective import all_gather_object

        out = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        n, r = get_world_size(), get_rank()
        return [f for i, f in enumerate(sorted(files)) if i % n == r]

    def print_on_rank(self, message, rank_id=0):
        if get_rank() == rank_id:
            print(message)
