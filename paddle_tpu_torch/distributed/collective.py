"""Communication groups & eager collectives — the port's copy of
paddle_tpu/distributed/collective.py.

Parity: python/paddle/distributed/collective.py (group management) +
communication/ (all_reduce.py, all_gather.py, all_to_all.py, ...;
reference C++: ProcessGroupNCCL — paddle/fluid/distributed/collective/
process_group_nccl.cc:267 AllReduce).

A torch process drives one device, so the collectives are real: each
runs on the ``torch.distributed`` process group behind its :class:`Group`
(the default group when ``group`` is None) and takes plain
``torch.Tensor``s, in place where the reference replaces a value. A world
of one is the identity, as in the reference (``_multi_process``). Every
eager rendezvous runs under the port's ``watchdog.guarded``, one level
below the public API, so all of them share the dead-peer teardown path.

The reference's semantics are kept where they differ from torch's:
``reduce`` and ``gather`` leave the result on every rank (they ride the
all-reduce / all-gather), ``reduce_scatter`` takes the list form, and
``src``/``dst`` are global ranks. The backend needs to carry only
``all_reduce``, ``all_gather``, ``broadcast`` and point-to-point for the
tensor ops (gloo does on the CPU and on CUDA tensors); ``all_to_all`` rides
``all_to_all_single``.

:data:`traffic` counts every collective this process took part in, by
kind (``all_reduce``, ``all_gather``, ``broadcast``, ``reduce_scatter``,
``all_to_all``) and its payload bytes under ``<kind>_bytes`` (this rank's
input; ``broadcast`` the tensor). :func:`all_gather_dim` and
:func:`reduce_scatter_dim` are the sharded train step's gather and
reduce-scatter along a tensor dim.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import torch
import torch.distributed as dist

from .env import get_rank, get_world_size
from .watchdog import guarded as _guarded

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "is_available",
           "all_reduce", "all_gather", "all_gather_object", "broadcast",
           "reduce", "scatter", "reduce_scatter", "all_to_all", "alltoall",
           "alltoall_single", "send", "recv", "isend", "irecv", "barrier",
           "wait", "destroy_process_group", "get_backend", "gather",
           "broadcast_object_list", "scatter_object_list",
           "all_gather_dim", "reduce_scatter_dim", "traffic"]


# every collective of this process: calls and payload bytes by kind
traffic: collections.Counter = collections.Counter()


def _count(kind: str, tensor=None) -> None:
    traffic[kind] += 1
    if tensor is not None:
        traffic[kind + "_bytes"] += tensor.numel() * tensor.element_size()


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


# AVG rides SUM and a division (gloo has no AVG)
_TORCH_OP = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
             ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "SUM"}


class Group:
    """parity: paddle.distributed.collective.Group — the global ``ranks``
    of a group and the torch process group that carries its collectives
    (None: the default group)."""

    _next_id = 0

    def __init__(self, ranks: Optional[List[int]] = None, pg=None, name=None):
        self.ranks = list(ranks) if ranks is not None else \
            list(range(get_world_size()))
        self.id = Group._next_id
        Group._next_id += 1
        self.name = name or f"group_{self.id}"
        self._pg = pg
        _groups[self.id] = self

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def rank(self):
        return self.get_group_rank(get_rank())

    def is_member(self):
        return get_rank() in self.ranks

    @property
    def process_group(self):
        """The torch process group (None for the default group)."""
        return self._pg

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups: dict = {}
_default_group: Optional[Group] = None


def _get_default_group() -> Group:
    global _default_group
    if _default_group is None or (
            _default_group.nranks != get_world_size()):
        _default_group = Group()
    return _default_group


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over ``ranks`` (global ranks; all when None). Under a
    process group every rank must call it, members or not, in the same
    order — torch's ``new_group`` is itself a collective."""
    ranks = sorted(ranks) if ranks is not None else \
        list(range(get_world_size()))
    pg = None
    if dist.is_initialized() and get_world_size() > 1:
        kw = {}
        if timeout is not None:
            import datetime
            kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                             else datetime.timedelta(seconds=timeout))
        with _guarded("new_group_rendezvous"):
            pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(ranks, pg)


def get_group(gid=0) -> Group:
    """The group with id ``gid``; the default group for 0 or an unknown
    id (the reference returns the default group always)."""
    g = _groups.get(gid)
    if g is None or gid == 0:
        return _get_default_group()
    return g


def is_available() -> bool:
    return dist.is_available()


def _multi_process(group: Optional[Group]) -> bool:
    g = group or _get_default_group()
    return get_world_size() > 1 and g.nranks > 1


def _pg(group: Optional[Group]):
    if group is None or group.process_group is not None:
        return None if group is None else group.process_group
    if group.nranks != get_world_size():
        raise RuntimeError(
            f"{group!r} has no process group to carry its collectives "
            "(create it with new_group on every rank)")
    return None


def _skip(group: Optional[Group]) -> bool:
    """True when this rank takes no part: a world of one, a group of one,
    or a group it is not a member of."""
    return not _multi_process(group) or (
        group is not None and not group.is_member())


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM,
               group: Optional[Group] = None, sync_op: bool = True):
    """Reduce ``tensor`` over the group, in place; returns it."""
    if _skip(group):
        return tensor
    _count("all_reduce", tensor)
    with _guarded("allreduce_rendezvous"):
        dist.all_reduce(tensor, getattr(dist.ReduceOp, _TORCH_OP[op]),
                        group=_pg(group))
    if op == ReduceOp.AVG:
        n = (group or _get_default_group()).nranks
        if tensor.is_floating_point():
            tensor.div_(n)
        else:
            tensor.floor_divide_(n)
    return tensor


def _gather_list(tensor, group):
    outs = [torch.empty_like(tensor)
            for _ in range((group or _get_default_group()).nranks)]
    _count("all_gather", tensor)
    # every eager rendezvous is watchdog-guarded here, one level below the
    # public API (distributed/watchdog.py)
    with _guarded("allgather_rendezvous"):
        dist.all_gather(outs, tensor.contiguous(), group=_pg(group))
    return outs


def all_gather(tensor_list: List[torch.Tensor], tensor: torch.Tensor,
               group: Optional[Group] = None, sync_op: bool = True):
    """Append every member's ``tensor`` to ``tensor_list``, in group rank
    order."""
    if _skip(group):
        tensor_list.extend([tensor.clone()])
        return
    tensor_list.extend(_gather_list(tensor, group))


def all_gather_object(object_list: List, obj, group=None):
    if _skip(group):
        object_list.append(obj)
        return
    out = [None] * (group or _get_default_group()).nranks
    with _guarded("allgather_object_rendezvous"):
        dist.all_gather_object(out, obj, group=_pg(group))
    object_list.extend(out)


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None, sync_op: bool = True):
    """``tensor`` of global rank ``src`` to every member, in place."""
    if _skip(group):
        return tensor
    _count("broadcast", tensor)
    with _guarded("broadcast_rendezvous"):
        dist.broadcast(tensor, src, group=_pg(group))
    return tensor


def reduce(tensor: torch.Tensor, dst: int = 0, op=ReduceOp.SUM,  # noqa: A001
           group: Optional[Group] = None, sync_op: bool = True):
    """As the reference: the all-reduce, so ``dst`` (and every other
    member) holds the result."""
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True):
    """Member i of the group gets ``tensor_list[i]`` of rank ``src``;
    rides ``broadcast`` so any backend carries it."""
    if _skip(group):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    g = group or _get_default_group()
    if get_rank() == src:
        buf = torch.stack([t.to(tensor.dtype) for t in tensor_list])
    else:
        buf = torch.empty((g.nranks,) + tuple(tensor.shape),
                          dtype=tensor.dtype, device=tensor.device)
    broadcast(buf, src, group)
    tensor.copy_(buf[g.rank])
    return tensor


def reduce_scatter(tensor: torch.Tensor, tensor_list: List[torch.Tensor],
                   op=ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True):
    """``tensor`` = the reduction over the members of their
    ``tensor_list[i]``, i this rank's group rank."""
    if _skip(group):
        tensor.copy_(tensor_list[0] if len(tensor_list) == 1
                     else sum(tensor_list))
        return tensor
    g = group or _get_default_group()
    buf = torch.stack([t.to(tensor.dtype) for t in tensor_list])
    all_reduce(buf, op, group)
    tensor.copy_(buf[g.rank])
    return tensor


def _exchange(sends, group: Group):
    """Point-to-point exchange with every other member: ``sends[j]`` (this
    rank's tensor for group rank ``j``; this rank's own entry unused) goes
    to member j, and member j's tensor for this rank comes back as
    ``out[j]`` (``out[rank]`` None), on the sends' device. CUDA tensors
    are staged through pinned host memory (a backend such as gloo carries
    host buffers between processes); every send and receive is posted
    before any is waited on."""
    me = group.rank
    dev = next(t for j, t in enumerate(sends) if j != me).device
    staged = {}
    for j, t in enumerate(sends):
        if j == me:
            continue
        t = t.contiguous()
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            staged[j] = h.copy_(t, non_blocking=True)
        else:
            staged[j] = t
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    recv = {j: torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=dev.type == "cuda")
            for j, t in staged.items()}
    with _guarded("exchange_rendezvous"):
        works = []
        for j in sorted(staged):
            peer = group.ranks[j]
            works.append(dist.isend(staged[j], peer, group=_pg(group)))
            works.append(dist.irecv(recv[j], peer, group=_pg(group)))
        for w in works:
            w.wait()
    return [None if j == me else recv[j].to(dev, non_blocking=True)
            for j in range(group.nranks)]


def all_gather_dim(tensor: torch.Tensor, dim: int,
                   group: Optional[Group] = None) -> torch.Tensor:
    """Every member's ``tensor`` concatenated along ``dim`` in group rank
    order (a new tensor). NCCL runs ``all_gather_into_tensor``; another
    backend exchanges the blocks point to point (:func:`_exchange`: CUDA
    tensors staged through pinned host memory, which gloo's own all-gather
    of CUDA tensors runs at half the rate of on one host)."""
    if _skip(group):
        return tensor.contiguous()
    g = group or _get_default_group()
    _count("all_gather", tensor)
    if dist.get_backend(_pg(group)) == "nccl":
        src = tensor.movedim(dim, 0).contiguous()
        out = torch.empty((g.nranks * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        with _guarded("allgather_rendezvous"):
            dist.all_gather_into_tensor(out, src, group=_pg(group))
        return out.movedim(0, dim).contiguous()
    got = _exchange([tensor] * g.nranks, g)
    return torch.cat([tensor if t is None else t for t in got], dim)


def reduce_scatter_dim(tensor: torch.Tensor, dim: int,
                       group: Optional[Group] = None) -> torch.Tensor:
    """This member's block of the sum over the group of ``tensor``, cut in
    ``nranks`` equal blocks along ``dim`` (group rank order): a new
    contiguous tensor. NCCL runs ``reduce_scatter_tensor``; another
    backend (gloo has no reduce-scatter) sends each member its block point
    to point (:func:`_exchange`) and sums the blocks it gets in group rank
    order."""
    if _skip(group):
        return tensor.contiguous()
    g = group or _get_default_group()
    n = g.nranks
    if tensor.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(tensor.shape)} does "
                         f"not split {n} ways")
    _count("reduce_scatter", tensor)
    w = tensor.shape[dim] // n
    if dist.get_backend(_pg(group)) == "nccl":
        src = tensor.movedim(dim, 0).contiguous()
        out = torch.empty((w,) + tuple(src.shape[1:]), dtype=tensor.dtype,
                          device=tensor.device)
        with _guarded("reduce_scatter_rendezvous"):
            dist.reduce_scatter_tensor(out, src, group=_pg(group))
        return out.movedim(0, dim).contiguous()
    blocks = list(tensor.split(w, dim))
    got = _exchange(blocks, g)
    out = None
    for j in range(n):
        part = blocks[j] if j == g.rank else got[j]
        out = part.clone(memory_format=torch.contiguous_format) \
            if out is None else out.add_(part)
    return out


def all_to_all(out_tensor_list: List[torch.Tensor],
               in_tensor_list: List[torch.Tensor],
               group: Optional[Group] = None, sync_op: bool = True):
    """Member j gets this rank's ``in_tensor_list[j]``; this rank's
    ``out_tensor_list`` gets one tensor from each member, in group rank
    order (the tensors may differ in their first dim)."""
    if _skip(group):
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return
    ref = in_tensor_list[0]
    tail = tuple(ref.shape[1:])
    sizes = torch.tensor([t.shape[0] for t in in_tensor_list],
                         dtype=torch.int64, device=ref.device)
    got = torch.empty_like(sizes)
    with _guarded("alltoall_rendezvous"):
        dist.all_to_all_single(got, sizes, group=_pg(group))
    recv_sizes = got.tolist()
    flat_in = torch.cat([t.reshape((t.shape[0],) + tail)
                         for t in in_tensor_list])
    flat_out = torch.empty((sum(recv_sizes),) + tail, dtype=ref.dtype,
                           device=ref.device)
    alltoall_single(flat_out, flat_in, [int(s) for s in sizes.tolist()],
                    recv_sizes, group)
    out_tensor_list.extend(flat_out.split(recv_sizes))


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """parity: communication/all_to_all.py:26 alltoall (alias of
    all_to_all)."""
    return all_to_all(out_tensor_list, in_tensor_list, group, sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """parity: communication/all_to_all.py alltoall_single — single-tensor
    all-to-all splitting dim 0 across ranks."""
    if _skip(group):
        out_tensor.copy_(in_tensor)
        return out_tensor
    _count("all_to_all", in_tensor)
    with _guarded("alltoall_rendezvous"):
        dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                               output_split_sizes=out_split_sizes,
                               input_split_sizes=in_split_sizes,
                               group=_pg(group))
    return out_tensor


_p2p_buffer: List = []


def send(tensor: torch.Tensor, dst: int = 0, group=None, sync_op=True):
    if _skip(group):
        _p2p_buffer.append(tensor.clone())
        return
    with _guarded("send"):
        dist.send(tensor.contiguous(), dst, group=_pg(group))


def recv(tensor: torch.Tensor, src: int = 0, group=None, sync_op=True):
    if _skip(group):
        if _p2p_buffer:
            tensor.copy_(_p2p_buffer.pop(0))
        return tensor
    with _guarded("recv"):
        dist.recv(tensor, src, group=_pg(group))
    return tensor


def barrier(group: Optional[Group] = None):
    if _skip(group):
        return
    # an installed CommWatchdog (distributed/watchdog.py) tears the
    # process down if a peer died and the rendezvous never completes
    with _guarded("barrier"):
        dist.barrier(group=_pg(group))


def wait(tensor, group=None, use_calc_stream=True):
    """Block until ``tensor`` (or a task's work) is done."""
    if isinstance(tensor, _Task):
        tensor.wait()
    elif isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def destroy_process_group(group=None):
    """Tear down ``group``'s process group, or with None the default one
    (and with it every group)."""
    global _default_group
    if group is not None and group.process_group is not None:
        dist.destroy_process_group(group.process_group)
        _groups.pop(group.id, None)
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _groups.clear()
    _default_group = None


def get_backend(group=None) -> str:
    """The backend carrying ``group`` (``"gloo"``, ``"nccl"``), or the one
    ``init_parallel_env`` would pick before any process group exists."""
    if dist.is_initialized():
        return str(dist.get_backend(_pg(group)))
    from .env import default_backend
    return default_backend()


# -- reference communication/ extras ----------------------------------------
def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """parity: communication/gather.py:29 — collect tensors on dst."""
    if _skip(group):
        if gather_list is not None:
            gather_list.append(tensor.clone())
        return
    outs = _gather_list(tensor, group)
    if get_rank() == dst and gather_list is not None:
        gather_list.extend(outs)


class _Task:
    """Communication handle (the reference returns an async task)."""

    def __init__(self, tensor=None, work=None):
        self._tensor = tensor
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
        if self._tensor is not None:
            wait(self._tensor)

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def isend(tensor, dst, group=None):
    """parity: communication/send.py:68 isend."""
    if _skip(group):
        send(tensor, dst, group)
        return _Task(tensor)
    return _Task(tensor, dist.isend(tensor.contiguous(), dst,
                                    group=_pg(group)))


def irecv(tensor, src=None, group=None):
    """parity: communication/recv.py:68 irecv."""
    src = src if src is not None else 0
    if _skip(group):
        recv(tensor, src, group)
        return _Task(tensor)
    return _Task(tensor, dist.irecv(tensor, src, group=_pg(group)))


def broadcast_object_list(object_list, src=0, group=None):
    """parity: communication/broadcast.py broadcast_object_list."""
    if _skip(group):
        return
    _count("broadcast_object")
    with _guarded("broadcast_object_rendezvous"):
        dist.broadcast_object_list(object_list, src, group=_pg(group))


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """parity: communication/scatter.py scatter_object_list — broadcast the
    src rank's list, keep this rank's element."""
    if _skip(group):
        if in_object_list:
            out_object_list[:] = [in_object_list[0]]
        return
    g = group or _get_default_group()
    objs = (list(in_object_list) if in_object_list
            else [None] * g.nranks)
    broadcast_object_list(objs, src, group)
    out_object_list[:] = [objs[g.rank]]
