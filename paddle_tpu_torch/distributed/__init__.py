"""paddle_tpu_torch.distributed (parity: python/paddle/distributed/; the
port of paddle_tpu/distributed/).

- :mod:`env`, :mod:`collective`, :mod:`communication`, :mod:`store`: the
  process bootstrap (``init_parallel_env`` over ``torch.distributed``),
  eager collectives on plain tensors, and the TCP rendezvous store;
- :mod:`fleet`: ``fleet.init`` and the hybrid topology
  (``CommunicateTopology``, ``HybridCommunicateGroup`` with its per-axis
  process groups and ``DeviceMesh``), and the Megatron ``mpu`` ops and
  layers under ``fleet.layers.mpu``;
- :mod:`resilience` (atomic checkpoints, the resumable data position, the
  resilient train loop, the seeded fault injector, ``retry_call``) and
  :mod:`watchdog` (hang detection over guarded blocking regions).

:func:`spawn` starts ``nprocs`` ranks, one process a device. The names are
loaded on first use, so importing the package (or its torch-free
``watchdog`` and ``resilience`` modules) does not load
``torch.distributed``.

- :mod:`parallel`: ``DataParallel`` over a ``torch.nn.Module`` (the
  sharded functional train steps live with the models:
  ``models.llama.activation_mesh``).

Not ported yet: ``auto_parallel``, ``shard_utils`` and ``sharding``
(ROADMAP A10.2b), pipeline (A10.3), context parallel (A10.4), expert
parallel (A10.5), and the sharded checkpoint, launch, ps and rpc (A10.6)
— among them ``distributed.checkpoint``, which re-exports the atomic
checkpoint API beside the sharded checkpoint.
"""
import importlib

_EXPORTS = {
    "env": ("ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
            "is_initialized", "device_world_size", "local_device_count"),
    "collective": ("Group", "ReduceOp", "all_gather", "all_gather_object",
                   "all_reduce", "all_to_all", "alltoall", "alltoall_single",
                   "barrier", "broadcast", "broadcast_object_list",
                   "destroy_process_group", "gather", "get_backend",
                   "get_group", "irecv", "is_available", "isend",
                   "new_group", "recv", "reduce", "reduce_scatter",
                   "scatter", "scatter_object_list", "send", "wait"),
    "store": ("TCPStore",),
    "parallel": ("DataParallel",),
}
_NAME_TO_MODULE = {n: m for m, names in _EXPORTS.items() for n in names}
_SUBMODULES = ("env", "collective", "communication", "store", "fleet",
               "resilience", "watchdog", "parallel")

__all__ = sorted(_NAME_TO_MODULE) + ["spawn", "stream"] + list(_SUBMODULES)


def __getattr__(name):
    if name == "checkpoint":
        raise NotImplementedError(
            "distributed.checkpoint (the sharded checkpoint, re-exporting "
            "the atomic checkpoint API) is not ported yet (ROADMAP A10.6); "
            "use paddle_tpu_torch.distributed.resilience.atomic_ckpt")
    if name in _NAME_TO_MODULE:
        mod = importlib.import_module(f".{_NAME_TO_MODULE[name]}", __name__)
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name == "stream":       # paddle.distributed.stream
        return importlib.import_module(".communication.stream", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(i, func, args, env):
    import os

    os.environ.update(env)
    os.environ["PADDLE_TRAINER_ID"] = str(i)
    os.environ["PADDLE_LOCAL_RANK"] = str(i)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """parity: paddle.distributed.spawn — run ``func(*args)`` in ``nprocs``
    new processes, one rank each (``nprocs`` -1 or 0: one a CUDA device,
    else one). The reference runs ``func`` inline at ``nprocs <= 1``
    because one JAX process drives every chip; a torch process drives one
    device, so this starts the ranks, as the reference's launcher does.
    ``nprocs`` 1 still runs inline: a world of one.

    Each rank finds the reference's env contract (``PADDLE_TRAINERS_NUM``,
    ``PADDLE_TRAINER_ID``, ``PADDLE_MASTER`` on a free localhost port) and
    brings its process group up with ``init_parallel_env``. Options:
    ``backend`` (sets ``PADDLE_DISTRI_BACKEND`` in the ranks), ``master``
    (``host:port``) and ``start_method`` (``"spawn"``). With ``join`` the
    call returns when every rank has; a rank that raises fails the call
    (``torch.multiprocessing.ProcessRaisedException``). Without ``join`` it
    returns the ``ProcessContext``."""
    import torch
    import torch.multiprocessing as mp

    if nprocs in (-1, 0):
        nprocs = torch.cuda.device_count() if torch.cuda.is_available() \
            else 1
    if nprocs == 1:
        func(*args)
        return None
    unknown = set(options) - {"backend", "master", "start_method"}
    if unknown:
        raise TypeError(f"spawn: unknown options {sorted(unknown)}")
    env = {"PADDLE_TRAINERS_NUM": str(nprocs),
           "PADDLE_MASTER": options.get("master")
           or f"127.0.0.1:{_free_port()}"}
    if options.get("backend"):
        env["PADDLE_DISTRI_BACKEND"] = options["backend"]
    return mp.start_processes(_rank_entry, args=(func, tuple(args), env),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method=options.get("start_method",
                                                       "spawn"))
