"""DataParallel over a ``torch.nn.Module`` — the port of
paddle_tpu/distributed/parallel.py.

Parity: python/paddle/distributed/parallel.py:219 DataParallel (+ the C++
EagerReducer's bucketed all-reduce, fluid/distributed/collective/
reducer.h:88). Each rank runs the wrapped module on its rows of the batch;
:meth:`DataParallel.apply_collective_grads` averages every ``.grad`` over
the group (the default group when ``group`` is None), skipped inside
:meth:`DataParallel.no_sync`, as the reference's eager path does. The
state dict and the parameters are the wrapped module's, under its own
names.
"""
from __future__ import annotations

import contextlib

from torch import nn

from .collective import ReduceOp, all_reduce

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self._sync = True

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Inside it, :meth:`apply_collective_grads` averages nothing (the
        grads accumulate locally)."""
        prev = self._sync
        self._sync = False
        try:
            yield
        finally:
            self._sync = prev

    def apply_collective_grads(self):
        """Average every parameter's ``.grad`` over the group, in place
        (one all-reduce a parameter; a world of one is the identity)."""
        if not self._sync:
            return
        for p in self._layers.parameters():
            if p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.AVG, group=self._group)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)
