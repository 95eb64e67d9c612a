"""fleet.meta_parallel — the port of
paddle_tpu/distributed/fleet/meta_parallel (parity:
python/paddle/distributed/fleet/meta_parallel/).

The wrappers mark how a model is parallelized over the hybrid group:
:class:`DataParallel` averages gradients over the data-parallel group,
:class:`TensorParallel` only wraps (its layers, ``fleet.layers.mpu``,
carry their own collectives). Not ported yet: :class:`PipelineParallel`
and the pipeline layers (ROADMAP A10.3), ``SegmentParallel`` (A10.4) and
``ShardingParallel`` (A10.2b); each raises naming its item.
"""
from __future__ import annotations

from ...parallel import DataParallel  # noqa: F401
from ..layers.mpu.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from .pp_parallel import PipelineParallel  # noqa: F401
from .tensor_parallel import TensorParallel  # noqa: F401

_UNPORTED = {"LayerDesc": "A10.3", "PipelineLayer": "A10.3",
             "SharedLayerDesc": "A10.3", "SegmentParallel": "A10.4",
             "ShardingParallel": "A10.2b"}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"fleet.meta_parallel.{name} is not ported yet (ROADMAP "
            f"{_UNPORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
