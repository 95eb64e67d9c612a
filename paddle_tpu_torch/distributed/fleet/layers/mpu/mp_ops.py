"""Model-parallel comm primitives — the port of
paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py.

Parity: fleet/layers/mpu/mp_ops.py:76-272 — _c_identity/_c_concat/_c_split/
_mp_allreduce/_c_lookup_table/_c_softmax_with_cross_entropy. The JAX
package writes them as sharding constraints that GSPMD turns into
collectives; here each is a ``torch.autograd.Function`` over a real
collective on the model-parallel group, with the reference's semantics:

- ``_c_identity``: forward identity, backward all-reduce;
- ``_mp_allreduce``: forward all-reduce, backward identity;
- ``_c_split``: forward this rank's slice of the last dim, backward
  all-gather;
- ``_c_concat``: forward all-gather along the last dim (rank order),
  backward this rank's slice;
- ``_c_lookup_table``: the vocab-parallel lookup (rows outside this rank's
  ``[start_index, start_index + rows)`` give 0; the caller all-reduces);
- ``_c_softmax_with_cross_entropy``: cross entropy over logits whose last
  dim is split over the group.

``group`` None is the hybrid group's model-parallel group once
``fleet.init`` ran, else the default group. A group of one makes every op
the identity (or the plain loss).
"""
from __future__ import annotations

import torch

from ....collective import Group, ReduceOp, _get_default_group, all_gather
from ....collective import all_reduce as _all_reduce

MP_AXIS = "mp"


def _mp_group(group) -> Group:
    if group is not None:
        return group
    from ...topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_model_parallel_group()
    return _get_default_group()


def _reduced(x, group, op=ReduceOp.SUM):
    out = x.contiguous().clone()
    _all_reduce(out, op, group)
    return out


def _gathered_last(x, group):
    if group.nranks == 1:
        return x
    parts = []
    all_gather(parts, x.contiguous(), group)
    return torch.cat(parts, dim=-1)


def _own_last(x, group):
    if group.nranks == 1:
        return x
    n = x.shape[-1] // group.nranks
    r = group.rank
    return x[..., r * n:(r + 1) * n].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op, bwd_reduce):
        ctx.group, ctx.bwd_reduce = group, bwd_reduce
        return _reduced(x, group, op)

    @staticmethod
    def backward(ctx, g):
        return (_reduced(g, ctx.group) if ctx.bwd_reduce else g), \
            None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gathered_last(g, ctx.group), None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gathered_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own_last(g, ctx.group), None


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """Forward identity / backward all-reduce over mp."""
    return _Identity.apply(tensor, _mp_group(group))


def _mp_allreduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """Forward all-reduce / backward identity (backward all-reduce too
    when ``use_model_parallel`` is False, as the reference)."""
    g = _mp_group(group)
    if g.nranks == 1:
        return tensor
    return _AllReduce.apply(tensor, g, op, not use_model_parallel)


def _c_split(tensor, group=None):
    """This rank's contiguous slice of the last dim."""
    return _Split.apply(tensor, _mp_group(group))


def _c_concat(tensor, group=None):
    """Every rank's ``tensor`` concatenated along the last dim, in group
    rank order."""
    return _Concat.apply(tensor, _mp_group(group))


def _c_lookup_table(table, index, start_index=0, name=None):
    """Rows ``index - start_index`` of this rank's vocab slice ``table``
    [rows, h]; an index outside the slice gives a zero row (its gradient
    is zero), so the all-reduce of every rank's lookup is the whole
    table's."""
    local = index.long() - start_index
    outside = (local < 0) | (local >= table.shape[0])
    rows = torch.nn.functional.embedding(
        local.clamp(0, table.shape[0] - 1), table)
    return rows.masked_fill(outside.unsqueeze(-1), 0)


class _ParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        x = logits.float()
        m = _reduced(x.amax(dim=-1), group, ReduceOp.MAX)
        e = torch.exp(x - m.unsqueeze(-1))
        s = _reduced(e.sum(dim=-1), group)
        n = x.shape[-1]
        local = label.long() - group.rank * n
        owned = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1).unsqueeze(-1)
        pick = (x - m.unsqueeze(-1)).gather(-1, idx).squeeze(-1)
        target = _reduced(torch.where(owned, pick, torch.zeros_like(pick)),
                          group)
        ignore = label.long() == ignore_index
        loss = torch.where(ignore, torch.zeros_like(s), torch.log(s) - target)
        softmax = e / s.unsqueeze(-1)
        ctx.save_for_backward(softmax, idx, owned, ignore)
        ctx.in_dtype = logits.dtype
        return loss, softmax

    @staticmethod
    def backward(ctx, g_loss, g_softmax):
        softmax, idx, owned, ignore = ctx.saved_tensors
        onehot = torch.zeros_like(softmax).scatter_(
            -1, idx, owned.unsqueeze(-1).to(softmax.dtype))
        grad = (softmax - onehot) * torch.where(
            ignore, torch.zeros_like(g_loss), g_loss).unsqueeze(-1)
        return grad.to(ctx.in_dtype), None, None, None


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False, ignore_index=-100):
    """Per-row cross entropy (f32, shaped as the rows, as the
    reference's) of logits whose last dim is this rank's vocab slice;
    ``label`` holds global ids, shaped as the rows or with a trailing 1.
    Labels equal to ``ignore_index`` give 0. With ``return_softmax`` also
    the softmax of this rank's slice."""
    g = _mp_group(group)
    lab = label.squeeze(-1) if label.dim() == logits.dim() else label
    loss, softmax = _ParallelCE.apply(logits, lab, g, ignore_index)
    return (loss, softmax) if return_softmax else loss
