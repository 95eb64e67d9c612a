"""paddle.distributed.communication.stream (parity:
python/paddle/distributed/communication/stream/) — the port's copy of
paddle_tpu/distributed/communication/stream.py: calc-stream collective
variants. The collectives run on their process group's own stream and
return when done, so ``use_calc_stream`` and ``sync_op`` change nothing;
these delegate to the eager collectives and return a completed task
handle (the reference contract)."""
from __future__ import annotations

from .. import collective as _c

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "recv", "scatter",
           "send", "gather"]


def _task(tensor=None):
    return _c._Task(tensor)


def all_reduce(tensor, op=None, group=None, sync_op=True,
               use_calc_stream=False):
    _c.all_reduce(tensor, op if op is not None else _c.ReduceOp.SUM, group)
    return _task(tensor)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    _c.all_gather(tensor_or_tensor_list, tensor, group)
    return _task(tensor)


def alltoall(out_tensor_or_tensor_list, in_tensor_or_tensor_list,
             group=None, sync_op=True, use_calc_stream=False):
    _c.all_to_all(out_tensor_or_tensor_list, in_tensor_or_tensor_list,
                  group)
    return _task()


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                       out_split_sizes, group)
    return _task(out_tensor)


def broadcast(tensor, src, group=None, sync_op=True, use_calc_stream=False):
    _c.broadcast(tensor, src, group)
    return _task(tensor)


def reduce(tensor, dst=0, op=None, group=None, sync_op=True,  # noqa: A001
           use_calc_stream=False):
    _c.reduce(tensor, dst, op if op is not None else _c.ReduceOp.SUM, group)
    return _task(tensor)


def reduce_scatter(tensor, tensor_or_tensor_list, op=None, group=None,
                   sync_op=True, use_calc_stream=False):
    _c.reduce_scatter(tensor, tensor_or_tensor_list,
                      op if op is not None else _c.ReduceOp.SUM, group)
    return _task(tensor)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    _c.scatter(tensor, tensor_or_tensor_list, src, group)
    return _task(tensor)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    _c.send(tensor, dst, group)
    return _task(tensor)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    _c.recv(tensor, src, group)
    return _task(tensor)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True,
           use_calc_stream=False):
    _c.gather(tensor, gather_list, dst, group)
    return _task(tensor)
