"""Tensor-parallel (model-parallel) layers — the port of
paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py.

Parity: python/paddle/distributed/fleet/layers/mpu/mp_layers.py —
VocabParallelEmbedding (:49), ColumnParallelLinear (:336),
RowParallelLinear (:543), ParallelCrossEntropy (:744).

Each layer holds this rank's shard of the weight (Paddle's ``[in, out]``
layout, ``x @ W``) and meets the other ranks through the ``mp_ops``
collectives on ``mp_group`` (the hybrid group's model-parallel group by
default): column-parallel shards the output dim, row-parallel the input
dim, the vocab embedding the vocab dim. Weights start as XavierNormal
draws of the whole matrix's scale, as the reference's.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .mp_ops import (_c_concat, _c_identity, _c_lookup_table,
                     _c_softmax_with_cross_entropy, _c_split, _mp_allreduce,
                     _mp_group)

MP_AXIS = "mp"


def _share(n: int, group, what: str) -> int:
    if n % group.nranks:
        raise ValueError(f"{what}={n} must be divisible by the "
                         f"model-parallel size {group.nranks}")
    return n // group.nranks


def _xavier(shape, fan_in, fan_out):
    w = torch.empty(shape)
    return nn.init.normal_(w, 0.0, math.sqrt(2.0 / (fan_in + fan_out)))


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        rows = _share(num_embeddings, self.group, "num_embeddings")
        self.vocab_start_index = self.group.rank * rows
        self.weight = nn.Parameter(
            _xavier((rows, embedding_dim), num_embeddings, embedding_dim))

    def forward(self, x):
        out = _c_lookup_table(self.weight, x,
                              start_index=self.vocab_start_index)
        return _mp_allreduce(out, group=self.group)


class ColumnParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        cols = _share(out_features, self.group, "out_features")
        self.weight = nn.Parameter(
            _xavier((in_features, cols), in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(cols)) if has_bias else None

    def forward(self, x):
        out = _c_identity(x, self.group) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            return _c_concat(out, self.group)
        return out


class RowParallelLinear(nn.Module):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        rows = _share(in_features, self.group, "in_features")
        self.weight = nn.Parameter(
            _xavier((rows, out_features), in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = _c_split(x, self.group)
        out = _mp_allreduce(x @ self.weight, group=self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over an mp-sharded logits dim (the reference computes
    it with c_softmax_with_cross_entropy)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        return _c_softmax_with_cross_entropy(input, label, group=self.group,
                                             ignore_index=self.ignore_index)
