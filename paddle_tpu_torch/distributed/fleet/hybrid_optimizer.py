"""HybridParallelOptimizer over a ``torch.optim.Optimizer`` — the port of
paddle_tpu/distributed/fleet/hybrid_optimizer.py.

Parity: fleet/meta_optimizers/dygraph_optimizer/
hybrid_parallel_optimizer.py:275 — wraps the inner optimizer and averages
the gradients over the data-parallel ranks before each step. The average
runs over the hybrid group's data-parallel group (every rank of a pure
data-parallel job, as the reference's default group), so the
tensor-parallel shards of a layer are never mixed.
"""
from __future__ import annotations

from ..collective import ReduceOp, all_reduce

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._parameter_list = [p for g in optimizer.param_groups
                                for p in g["params"]]

    def _sync_grads(self):
        """Every ``.grad`` averaged over the data-parallel group."""
        group = None if self._hcg is None \
            else self._hcg.get_data_parallel_group()
        for p in self._parameter_list:
            if p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.AVG, group=group)

    def step(self):
        self._sync_grads()
        self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        self._inner_opt.load_state_dict(state)

    def get_lr(self):
        return self._inner_opt.param_groups[0]["lr"]

    def set_lr(self, value):
        for g in self._inner_opt.param_groups:
            g["lr"] = value

    @property
    def _learning_rate(self):
        return self.get_lr()

    @property
    def _learning_rate_scheduler(self):
        return getattr(self._inner_opt, "_learning_rate_scheduler", None)

    def __getattr__(self, name):
        if name == "_inner_opt":
            raise AttributeError(name)
        return getattr(self._inner_opt, name)
