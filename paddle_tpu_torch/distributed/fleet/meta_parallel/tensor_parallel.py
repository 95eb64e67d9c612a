"""TensorParallel — the port of
paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py (parity:
fleet/meta_parallel/tensor_parallel.py).

A wrapper only, as the reference's: the tensor-parallel layers
(``fleet.layers.mpu``) hold their shards and run their own collectives
on the model-parallel group. The parameters and the state dict are the
wrapped module's, under its own names.
"""
from __future__ import annotations

from torch import nn

__all__ = ["TensorParallel"]


class TensorParallel(nn.Module):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state, *args, **kwargs):
        return self._layers.load_state_dict(state, *args, **kwargs)

    load_state_dict = set_state_dict
