"""paddle.distributed.communication (parity:
python/paddle/distributed/communication/) — the port's copy of
paddle_tpu/distributed/communication: the eager surface lives in
distributed.collective, re-exported here, plus the `stream` sub-namespace
for calc-stream variants."""
from ..collective import (  # noqa: F401
    ReduceOp, all_gather, all_reduce, all_to_all, alltoall, alltoall_single,
    barrier, broadcast, broadcast_object_list, gather, irecv, isend, recv,
    reduce, reduce_scatter, scatter, scatter_object_list, send,
)
from . import stream  # noqa: F401

__all__ = ["stream", "ReduceOp", "all_gather", "all_reduce", "alltoall",
           "alltoall_single", "broadcast", "reduce", "reduce_scatter",
           "recv", "scatter", "send", "gather", "barrier", "isend",
           "irecv", "broadcast_object_list", "scatter_object_list"]
