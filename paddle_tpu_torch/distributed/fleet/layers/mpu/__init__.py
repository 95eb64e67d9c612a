"""Megatron-style tensor-parallel ops, layers and RNG tracking — the port
of paddle_tpu/distributed/fleet/layers/mpu."""
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from . import mp_ops  # noqa: F401
from . import random  # noqa: F401
