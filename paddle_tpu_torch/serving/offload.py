"""Async two-tier KV offload: background spill and prefetch behind
decode — the port of paddle_tpu/serving/offload.py.

The host tiers (``kv_swap.HostKVPool``: the preemption swap tier and the
prefix cache's spill tier) sit under the card's block pool. This module
is the transfer engine that moves their bytes without holding up the
step thread:

- **Async spill (d2h).** A swap-out or a proactive cold-block spill
  gathers the blocks of every pool entry on the compute stream (one
  ``index_select`` an entry) and copies the gathered tensors into pinned
  host memory on a d2h side stream, which waits on an event recorded
  after the gather; the gathered tensors carry ``record_stream`` so the
  allocator keeps them until the copy has read them. Landing is probed
  with ``event.query()``. The spilled blocks stay device-resident and
  ACCOUNTED until the transfer lands: swap-out victims park their
  private blocks in this engine's custody (the ledger's transient
  ``in_flight`` term), proactively spilled cache nodes keep their block
  under ``cached``. The step-boundary :meth:`poll` sweep commits landed
  payloads into the :class:`~paddle_tpu_torch.serving.kv_swap.HostKVPool`
  and returns custody blocks to the free list — the engine never blocks
  on a spill.
- **Prefetch-ahead restore (h2d).** When a swapped request nears the
  head of the admission queue, or a queued prompt's prefix walk would
  land on host-resident trie nodes, :meth:`stage` starts the h2d copy on
  an h2d side stream one or more steps EARLY into staging buffers
  attached to the host entry (``SwapEntry.staged``, with
  ``staged_event`` marking their landing). A restore that finds its
  payload staged is a ``prefetch_hit`` (:func:`take_staged` orders the
  compute stream behind the copy: zero host wait); one that must
  transfer inline is a counted ``stall`` with observed stall seconds.
- **Exactness.** Transfers move every pool entry verbatim (int8 payload
  AND per-entry scales), reservations guarantee a dispatched spill
  always fits its pool, and the gather is enqueued on the compute stream
  before any later pool write — async streams are bit-identical to the
  sync path.

Sync mode copies inline: a spill is one blocking d2h, nothing is staged
and nothing spills proactively. On the CPU every copy is a plain copy
and an async spill has landed as soon as it is made (it still lands at
the next :meth:`poll`, as on the card).

``FLAGS_serve_kv_offload_sync`` forces sync mode; the engine's
``kv_offload="auto"|"async"|"sync"`` argument overrides it per instance.
Host bytes are counted as the tensors hold them (``SwapEntry.nbytes``);
torch's caching host allocator may round a pinned block up to a power of
two, which :func:`torch.cuda.host_memory_stats` shows and the pools do
not count. The ``serving_kv_offload_*`` metrics (prefetch hits, stalls,
stall seconds, in-flight bytes, proactive spills) mirror the host
counters, which stay.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from ..framework.flags import define_flag, get_flag
from ..observability.catalog import instrument as _instrument

__all__ = ["OffloadEngine", "gather_blocks", "take_staged", "upload"]

_M_PREFETCH_HITS = _instrument("serving_kv_offload_prefetch_hits_total")
_M_STALLS = _instrument("serving_kv_offload_stalls_total")
_M_STALL_SECONDS = _instrument("serving_kv_offload_stall_seconds_total")
_M_INFLIGHT = _instrument("serving_kv_offload_inflight_bytes")
_M_PROACTIVE = _instrument("serving_kv_offload_proactive_spills_total")

define_flag("serve_kv_offload_sync", False,
            "force synchronous KV offload transfers (inline d2h/h2d): "
            "spills block the step thread, no prefetch staging, no "
            "proactive spill — the parity-test reference leg")
define_flag("serve_kv_offload_prefetch_depth", 2,
            "how many queued requests from the admission-queue head the "
            "per-step prefetch sweep inspects for host-resident KV "
            "(swap entries / spilled prefix nodes) to stage h2d early; "
            "0 disables prefetch (every restore stalls inline)")
define_flag("serve_kv_offload_staging_bytes", 256 << 20,
            "device-byte budget for prefetch staging buffers (h2d "
            "copies started ahead of admission); staging requests past "
            "the budget wait for earlier stages to be consumed")
define_flag("serve_kv_offload_spill_free_frac", 0.25,
            "proactive-spill pressure threshold: when the allocatable "
            "block fraction falls below this, refcount-0 LRU cached "
            "blocks start background d2h spills so later reclaims free "
            "them without an inline transfer")
define_flag("serve_kv_offload_spill_batch", 4,
            "max proactive cold-block spills dispatched per engine step "
            "(bounds per-step d2h bandwidth spent on background "
            "spilling)")

def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def upload(arr, device: torch.device) -> torch.Tensor:
    """A host tensor (or numpy array) on ``device`` without a host sync:
    through a pinned staging copy and a non-blocking h2d on the card (the
    caching host allocator keeps the staging block until its copy is
    done), a copy on the CPU."""
    t = torch.as_tensor(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def gather_blocks(pools: Dict, block_ids) -> Dict:
    """Blocks ``block_ids`` of every pool entry, stacked on the block axis
    ([L, n, ...] each), gathered on the current stream."""
    dev = next(iter(pools.values())).device
    idx = upload(torch.tensor(list(block_ids), dtype=torch.long), dev)
    return {name: pool.index_select(1, idx) for name, pool in pools.items()}


def _start_d2h(arrays: Dict, d2h):
    """Copy gathered device tensors into pinned host tensors on the side
    stream ``d2h``, behind an event recorded on the current stream after
    the gather. Returns (host tensors, landing event)."""
    dev = next(iter(arrays.values())).device
    gathered = torch.cuda.Event()
    gathered.record(torch.cuda.current_stream(dev))
    host = {}
    with torch.cuda.stream(d2h):
        d2h.wait_event(gathered)
        for n, a in arrays.items():
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            h.copy_(a, non_blocking=True)
            a.record_stream(d2h)
            host[n] = h
    landed = torch.cuda.Event()
    landed.record(d2h)
    return host, landed


def take_staged(ent) -> Dict:
    """Consume an entry's prefetch buffers: order the current stream
    behind their h2d copy (no host wait) and hand them over."""
    staged, ev = ent.staged, ent.staged_event
    ent.staged = ent.staged_event = None
    if ev is not None:
        cur = torch.cuda.current_stream(next(iter(staged.values())).device)
        cur.wait_event(ev)
        for t in staged.values():
            t.record_stream(cur)
    return staged


class _Spill:
    """One in-flight d2h batch: the host tensors it lands in, its landing
    event (None: landed), the blocks parked in custody until landing, and
    the host-pool reservation that guarantees the commit fits."""

    __slots__ = ("key", "arrays", "event", "blocks", "n_tokens", "nbytes",
                 "pool", "on_land", "proactive")

    def __init__(self, key, arrays, event, blocks, n_tokens, nbytes, pool,
                 on_land, proactive):
        self.key = key
        self.arrays = arrays            # name -> host tensor (landing)
        self.event = event
        self.blocks = list(blocks)      # custody (ledger in_flight term)
        self.n_tokens = int(n_tokens)
        self.nbytes = int(nbytes)
        self.pool = pool                # HostKVPool holding the reservation
        self.on_land = on_land          # fn(ok) or None
        self.proactive = proactive


class OffloadEngine:
    """Host-side bookkeeping for the async transfer tier. One instance
    per :class:`~paddle_tpu_torch.serving.engine.LLMEngine`, staging onto
    ``device``; every method runs on the engine's step thread."""

    def __init__(self, sync: Optional[bool] = None, device="cpu"):
        # the sync decision is per-instance and frozen at construction:
        # flipping the flag mid-serve must not strand in-flight state
        self.sync = (bool(get_flag("serve_kv_offload_sync"))
                     if sync is None else bool(sync))
        self.device = torch.device(device)
        self._streams = None            # (d2h, h2d) side streams, made once
        self._spills: Dict = {}         # key -> _Spill
        self._staged: Dict = {}         # key -> (host_pool, entry)
        # host evidence counters
        self.prefetch_hits = 0
        self.stalls = 0
        self.stall_seconds = 0.0
        self.proactive_spills = 0

    def _side(self, kind: int):
        """The d2h (0) or h2d (1) side stream on the card."""
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        return self._streams[kind]

    # -- knobs (read per call so tests can set_flags mid-run) -------------
    def prefetch_depth(self) -> int:
        return max(0, int(get_flag("serve_kv_offload_prefetch_depth")))

    def spill_batch(self) -> int:
        return max(0, int(get_flag("serve_kv_offload_spill_batch")))

    def staging_budget(self) -> int:
        return max(0, int(get_flag("serve_kv_offload_staging_bytes")))

    # -- accounting --------------------------------------------------------
    @property
    def held_blocks(self) -> int:
        """Device blocks custody-parked behind in-flight d2h spills —
        the block ledger's transient ``in_flight`` term (zero whenever
        no transfer is in flight)."""
        return sum(len(t.blocks) for t in self._spills.values())

    @property
    def inflight_bytes(self) -> int:
        return sum(t.nbytes for t in self._spills.values())

    @property
    def staged_bytes(self) -> int:
        return sum(ent.nbytes for _p, ent in self._staged.values()
                   if ent.staged is not None)

    def _gauge(self) -> None:
        _M_INFLIGHT.set(self.inflight_bytes)

    # -- spill (d2h) -------------------------------------------------------
    def spill_async(self, key, pools: Dict, block_ids, n_tokens: int,
                    host_pool, hold_blocks: List[int],
                    on_land: Optional[Callable] = None,
                    proactive: bool = False) -> bool:
        """Dispatch one non-blocking d2h spill of ``block_ids`` from
        every pool entry (payload AND scales move verbatim — the restore
        is bit-exact). Reserves ``host_pool`` capacity up front so a
        dispatched transfer can always commit; ``False`` (nothing
        started, the pool's refusal counted) when it cannot fit.

        ``hold_blocks`` are parked in this engine's custody until the
        transfer lands (the ledger's ``in_flight`` term) — pass ``[]``
        for spills whose source keeps its block (proactive cache
        spills). In sync mode the transfer completes inline (blocking
        d2h + commit) and nothing is ever held."""
        arrays = gather_blocks(pools, block_ids)
        nbytes = sum(_nbytes(a) for a in arrays.values())
        if not host_pool.reserve(key, nbytes):
            return False
        if proactive:
            self.proactive_spills += 1
            _M_PROACTIVE.inc()
        if self.sync:
            # the gather is a fresh tensor: on the CPU it is the copy
            data = {n: a.cpu() for n, a in arrays.items()}
            host_pool.commit(key, data, n_tokens)
            if on_land is not None:
                on_land(True)
            return True
        event = None
        if self.device.type == "cuda":
            arrays, event = _start_d2h(arrays, self._side(0))
        self._spills[key] = _Spill(key, arrays, event, hold_blocks,
                                   n_tokens, nbytes, host_pool, on_land,
                                   proactive)
        self._gauge()
        return True

    def pending(self, key) -> bool:
        return key in self._spills

    def _land(self, t: _Spill) -> List[int]:
        if t.event is not None:
            t.event.synchronize()
        t.pool.commit(t.key, t.arrays, t.n_tokens)
        if t.on_land is not None:
            t.on_land(True)
        return t.blocks

    def poll(self, block: bool = False) -> List[int]:
        """The step-boundary completion sweep: commit every landed spill
        into its host pool and return the custody blocks the caller must
        append to the free list. ``block=True`` waits for everything
        (the run()-exit / test-quiescence drain). Also prunes staging
        records whose host entry was consumed or discarded."""
        freed: List[int] = []
        for key in list(self._spills):
            t = self._spills[key]
            if block or t.event is None or t.event.query():
                del self._spills[key]
                freed.extend(self._land(t))
        for key in list(self._staged):
            pool, ent = self._staged[key]
            if ent.staged is None or pool.get(key) is not ent:
                ent.staged = ent.staged_event = None   # release the buffers
                del self._staged[key]
        self._gauge()
        return freed

    def force_land(self, key) -> Optional[List[int]]:
        """Land one in-flight spill NOW (blocking) — admission reached a
        request whose swap-out has not landed yet; the payload commits
        into the transfer's own recorded pool. The observed wait counts
        toward stall seconds (the caller's restore counts the one stall
        event). Returns the custody blocks to free, or ``None`` when no
        such transfer exists."""
        t = self._spills.pop(key, None)
        if t is None:
            return None
        t0 = time.perf_counter()
        blocks = self._land(t)
        self.note_stall(time.perf_counter() - t0, n=0)
        self._gauge()
        return blocks

    def cancel(self, key) -> List[int]:
        """Drop one in-flight spill (its request went terminal): the
        host-pool reservation is released and the custody blocks return
        to the caller for the free list. The copy itself runs on; its
        pinned buffers free once it is done (the caching host allocator
        waits on the copy)."""
        t = self._spills.pop(key, None)
        if t is None:
            return []
        t.pool.unreserve(key)
        if t.on_land is not None:
            t.on_land(False)
        self._gauge()
        return t.blocks

    def abandon(self) -> List[int]:
        """Crash recovery: drop EVERY in-flight spill and staging buffer
        (a crashed step must not commit a half-landed payload). Each
        host reservation is released at once and each ``on_land`` told
        the spill failed; the copies themselves run on into buffers
        nothing reads (the gathered tensors are kept by
        ``record_stream``, the pinned ones by the caching host
        allocator's event). Returns all custody blocks for the free
        list: the copies read the gathered tensors, not the blocks."""
        freed: List[int] = []
        for t in self._spills.values():
            t.pool.unreserve(t.key)
            if t.on_land is not None:
                t.on_land(False)
            freed.extend(t.blocks)
        self._spills = {}
        for _pool, ent in self._staged.values():
            ent.staged = ent.staged_event = None
        self._staged = {}
        self._gauge()
        return freed

    # -- prefetch staging (h2d) --------------------------------------------
    def stage(self, host_pool, key, ent) -> bool:
        """Start the h2d copy of one host entry's payload into staging
        buffers attached to the entry (``SwapEntry.staged``) so the
        restore that eventually consumes it finds the data already
        device-resident (a ``prefetch_hit``). No-ops in sync mode, when
        already staged, or past the staging budget."""
        if self.sync or ent.staged is not None:
            return False
        if self.staged_bytes + ent.nbytes > self.staging_budget():
            return False
        if self.device.type == "cuda":
            h2d = self._side(1)
            with torch.cuda.stream(h2d):
                ent.staged = {n: a.to(self.device, non_blocking=True)
                              for n, a in ent.data.items()}
            ent.staged_event = torch.cuda.Event()
            ent.staged_event.record(h2d)
        else:
            ent.staged = {n: a.clone() for n, a in ent.data.items()}
        self._staged[key] = (host_pool, ent)
        return True

    def upload_inline(self, datas: Dict) -> Dict:
        """The inline h2d of a restore that found nothing staged. Async
        mode copies on the h2d stream and waits for that copy alone (the
        host wait is the stall the prefetch tier exists to hide; the
        compute stream's queued work is not waited for), then orders the
        current stream behind it. Sync mode enqueues the copies on the
        current stream and does not wait."""
        if self.device.type != "cuda":
            return {n: a.clone() for n, a in datas.items()}
        if self.sync:
            return {n: a.to(self.device, non_blocking=True)
                    for n, a in datas.items()}
        h2d = self._side(1)
        with torch.cuda.stream(h2d):
            out = {n: a.to(self.device, non_blocking=True)
                   for n, a in datas.items()}
        ev = torch.cuda.Event()
        ev.record(h2d)
        ev.synchronize()
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in out.values():
            t.record_stream(cur)
        return out

    # -- restore outcome counters ------------------------------------------
    def note_hit(self, n: int = 1) -> None:
        self.prefetch_hits += n
        _M_PREFETCH_HITS.inc(n)

    def note_stall(self, seconds: float, n: int = 1) -> None:
        self.stalls += n
        self.stall_seconds += float(seconds)
        _M_STALLS.inc(n)
        _M_STALL_SECONDS.inc(float(seconds))
