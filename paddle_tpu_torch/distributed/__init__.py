"""Distributed runtime pieces of the port: :mod:`resilience` (atomic
checkpoints, the resumable data position, the resilient train loop, the
seeded fault injector and ``retry_call``) and :mod:`watchdog` (hang
detection over guarded blocking regions, which the serving router's
replica steps and the train loop's steps run under).

Not ported yet: the rest of the reference's ``distributed`` package
(ROADMAP A10), among it ``distributed.checkpoint``, which re-exports the
atomic checkpoint API beside the sharded checkpoint.
"""


def __getattr__(name):
    if name == "checkpoint":
        raise NotImplementedError(
            "distributed.checkpoint (the sharded checkpoint, re-exporting "
            "the atomic checkpoint API) is not ported yet (ROADMAP A10); "
            "use paddle_tpu_torch.distributed.resilience.atomic_ckpt")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
