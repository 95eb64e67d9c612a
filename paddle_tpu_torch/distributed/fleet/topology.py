"""Hybrid-parallel topology — the port's copy of
paddle_tpu/distributed/fleet/topology.py.

Parity: python/paddle/distributed/fleet/base/topology.py:70
CommunicateTopology, :189 HybridCommunicateGroup — the 5-D axis algebra
(dp/pp/sharding/sep/mp, configurable order, reference:
fleet/base/distributed_strategy.py:1892-1931).

:class:`CommunicateTopology` is the reference's, as it is (plain index
arithmetic). :class:`HybridCommunicateGroup` backs each axis with real
process groups: every rank creates EVERY group of every axis, in the same
order — ``torch.distributed.new_group`` is a collective over the whole
world, and a rank that skipped the groups it is not in would leave the
others waiting — and keeps the ones it belongs to. In place of the
reference's ``process_mesh``/``jax_mesh()`` it holds a
``torch.distributed.device_mesh.DeviceMesh`` (``device_mesh``) with the
axis names ``dp``/``pp``/``sharding``/``sep``/``mp``; ``ProcessMesh``
itself comes with the auto_parallel port (ROADMAP A10.2).
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..collective import Group, new_group
from ..env import get_rank, get_world_size

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

# canonical mesh axis names
_NAME_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
             "sep": "sep", "model": "mp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or
                                    ["data", "pipe", "sharding", "sep", "model"])
        self._dims = list(dims or [1] * len(self._parallel_names))
        self.coordinate = itertools.product(*[range(d) for d in self._dims])
        self._coord2rank = {}
        self._rank2coord = {}
        for rank, coord in enumerate(
                itertools.product(*[range(d) for d in self._dims])):
            self._coord2rank[coord] = rank
            self._rank2coord[rank] = coord

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items() if c[axis] == index)

    def get_comm_list(self, axis_name):
        """All groups along axis_name: ranks varying on that axis only."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [range(d) for i, d in enumerate(self._dims) if i != axis]
        comm_list = []
        for other in itertools.product(*other_dims):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, i)
                ranks.append(self._coord2rank[tuple(coord)])
            comm_list.append(ranks)
        return comm_list

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._coord2rank[tuple(coord)]


class HybridCommunicateGroup:
    """parity: fleet/base/topology.py:189. Every rank builds the same
    groups in the same order (see the module docstring); ``device_mesh`` is
    the ``DeviceMesh`` over the topology (None in a world of one, which
    has no process group)."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        names = topology.get_hybrid_group_names()
        if topology.world_size() != get_world_size():
            raise ValueError(
                f"topology of {topology.world_size()} ranks over a world "
                f"of {get_world_size()}")
        self._dp_degree = topology.get_dim("data") if "data" in names else 1
        self._pp_degree = topology.get_dim("pipe") if "pipe" in names else 1
        self._sharding_degree = topology.get_dim("sharding") if "sharding" in names else 1
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("model") if "model" in names else 1
        dims = [topology.get_dim(n) for n in names]
        self._groups: Dict[str, Group] = {}
        for name in names:
            for ranks in self._topo.get_comm_list(name):
                # groups of one rank carry no collective: no process group
                g = new_group(ranks) if len(ranks) > 1 else Group(ranks)
                if self.global_rank in ranks:
                    self._groups[_NAME_MAP[name]] = g
        self.device_mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh

            dev = "cuda" if torch.cuda.is_available() else "cpu"
            self.device_mesh = DeviceMesh(
                dev, torch.arange(int(np.prod(dims))).reshape(dims),
                mesh_dim_names=tuple(_NAME_MAP[n] for n in names))

    # degrees
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    # ranks within axes
    def _axis_rank(self, axis):
        names = self._topo.get_hybrid_group_names()
        coord = self._topo.get_coord(self.global_rank)
        return coord[names.index(axis)]

    def get_data_parallel_rank(self):
        return self._axis_rank("data")

    def get_model_parallel_rank(self):
        return self._axis_rank("model")

    def get_stage_id(self):
        return self._axis_rank("pipe")

    get_pipe_parallel_rank = get_stage_id

    def get_sharding_parallel_rank(self):
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self):
        return self._axis_rank("sep")

    # groups
    def _group(self, axis):
        g = self._groups.get(axis)
        return g if g is not None else Group([self.global_rank])

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_check_parallel_group(self, sharding=False):
        return Group([self.global_rank])

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    def topology(self):
        return self._topo

    # pipeline helpers
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank, pipe=stage_id)


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
