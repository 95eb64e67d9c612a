"""Resumable data position tracking — the port's copy of
paddle_tpu/distributed/resilience/data.py.

Exact crash-resume needs the dataloader to restart mid-epoch at the batch
after the last checkpointed step. :class:`ResumableIterator` wraps any
re-iterable batch source (a loader, a list of batches, or an
``epoch -> iterator`` factory) as an endless stream with a serializable
``(epoch, index)`` position, equal to the reference's at every position.

Resume is exact when the source is deterministic per epoch (fixed order,
or shuffling seeded by epoch via the factory form / ``set_epoch``);
otherwise it is best-effort — same COUNT of batches consumed, different
contents. A source with native ``state_dict/load_state_dict`` position
support (the reference's ``io.DataLoader``; the port's ``io`` comes with
ROADMAP A11) is fast-forwarded at the sampler level.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Union

__all__ = ["ResumableIterator"]


class ResumableIterator:
    """Endless epoch-concatenated iterator with checkpointable position.

    ``source``: an ``epoch -> iterator`` callable, or a re-iterable.
    A re-iterable with ``set_epoch(n)`` (distributed samplers) gets it
    called before each epoch. A source with native
    ``state_dict/load_state_dict`` position support (a DataLoader)
    is fast-forwarded at the sampler level instead of batch-by-batch.
    """

    def __init__(self, source: Union[Callable[[int], Iterator], Any]):
        self._source = source
        self._factory = callable(source) and not hasattr(source, "__iter__")
        self.epoch = 0
        self.index = 0          # batches already consumed in this epoch
        self._skip = 0          # pending fast-forward after load_state_dict
        self._it: Optional[Iterator] = None
        # set when an epoch was opened via a native (sampler-level) skip:
        # an immediate StopIteration then means the source shrank below
        # the checkpointed position and must fail loudly, matching the
        # generic-skip path's guard
        self._native_skip = 0

    def _open_epoch(self) -> Iterator:
        src = self._source
        if self._factory:
            it = src(self.epoch)
        else:
            if hasattr(src, "set_epoch"):
                src.set_epoch(self.epoch)
            if self._skip and hasattr(src, "load_state_dict") \
                    and hasattr(src, "state_dict"):
                # native skip: the loader fast-forwards its own sampler
                # (cheap: no sample fetch for the skipped batches)
                src.load_state_dict({"epoch": self.epoch,
                                     "batch": self._skip})
                self._native_skip = self._skip
                self._skip = 0
            it = iter(src)
        skip = self._skip
        for i in range(skip):           # generic skip: consume and discard
            try:
                next(it)
            except StopIteration:
                # the reopened epoch is SHORTER than the checkpointed
                # position — dataset shrank or the source is not
                # deterministic; fail loudly instead of silently ending
                # the (documented endless) stream
                raise RuntimeError(
                    f"ResumableIterator: cannot fast-forward to index "
                    f"{skip} of epoch {self.epoch} — the source produced "
                    f"only {i} batches; resume requires a deterministic "
                    "per-epoch source") from None
        self._skip = 0
        return it

    def __iter__(self):
        return self

    def __next__(self):
        for attempt in range(2):
            if self._it is None:
                self._it = self._open_epoch()
            try:
                batch = next(self._it)
                self.index += 1
                self._native_skip = 0
                return batch
            except StopIteration:
                if self._native_skip:
                    # position exactly at epoch end is a legitimate
                    # rollover; anything short of that means the source
                    # shrank below the checkpointed position
                    try:
                        n = len(self._source)
                    except TypeError:
                        n = None
                    if n is None or self._native_skip != n:
                        raise RuntimeError(
                            f"ResumableIterator: cannot fast-forward to "
                            f"index {self._native_skip} of epoch "
                            f"{self.epoch} — the source produced fewer "
                            "batches than the checkpointed position; "
                            "resume requires a deterministic per-epoch "
                            "source") from None
                    self._native_skip = 0
                if self.index == 0 and self._skip == 0 and attempt == 1:
                    raise RuntimeError(
                        "ResumableIterator: source produced an empty epoch")
                self.epoch += 1
                self.index = 0
                self._it = None
        raise RuntimeError("unreachable")

    # -- checkpointable position -----------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "index": self.index}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        self.epoch = int(sd["epoch"])
        self.index = int(sd["index"])
        self._skip = self.index
        self._it = None
