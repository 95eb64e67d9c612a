"""Host-RAM KV swap tier: preempt → swap out, re-admit → swap in — the
port's copy of paddle_tpu/serving/kv_swap.py.

Recompute preemption frees a victim's blocks and re-prefills ``prompt +
generated`` from scratch on re-admission: correct, but under a sustained
pool squeeze every preemption throws away computed KV and re-buys it at
full prefill FLOPs. The swap tier keeps it instead: a preempted slot's
pool blocks — the int8 payload AND its per-entry scales, so the restore
is bit-exact — move into a bounded :class:`HostKVPool` of host memory,
and re-admission scatters them back into freshly allocated blocks instead
of re-prefilling. When the host pool is full, preemption falls back to
recompute — the tier degrades, it never breaks.

The offload engine (``serving/offload.py``) moves the bytes
asynchronously: spills land at step boundaries, so the pool has a
reservation protocol (:meth:`HostKVPool.reserve` /
:meth:`HostKVPool.commit` / :meth:`HostKVPool.unreserve`) that guarantees
a dispatched transfer can always commit, and :class:`SwapEntry` carries
an optional ``staged`` dict of device-resident prefetch buffers the
restore consumes without an inline h2d wait.

Byte accounting counts the bytes an entry's tensors hold, never what an
allocator rounded them up to (torch's caching host allocator serves
pinned blocks in powers of two).

Accounting contract: swapped KV holds NO device blocks (they were freed
at swap-out, or parked under the ledger's transient ``in_flight`` term
while the async d2h is still moving) — the engine's device invariant
stays ``free + backed + cached + squeezed (+ in_flight) == pool size``
while the host tier tracks its own bytes and blocks. The
``serving_kv_swap_{out,in,fallback}_total``,
``serving_kv_swap_host_bytes``, ``serving_prefix_cache_host_bytes``,
``serving_prefix_cache_evictions_total{kind="drop_host_full"}``,
``serving_disagg_kv_relay_bytes`` and
``serving_disagg_handoffs_total{outcome="relay_full"}`` metrics are kept
here as in the reference; the host counters stay.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..observability.catalog import instrument as _instrument

__all__ = ["HostKVPool", "SwapEntry"]

_M_SWAP_OUT = _instrument("serving_kv_swap_out_total")
_M_SWAP_IN = _instrument("serving_kv_swap_in_total")
_M_SWAP_FALLBACK = _instrument("serving_kv_swap_fallback_total")
_M_SWAP_BYTES = _instrument("serving_kv_swap_host_bytes")
_M_PREFIX_BYTES = _instrument("serving_prefix_cache_host_bytes")
_M_PREFIX_EVICT = _instrument("serving_prefix_cache_evictions_total")
_M_RELAY_BYTES = _instrument("serving_disagg_kv_relay_bytes")
_M_DISAGG_HANDOFFS = _instrument("serving_disagg_handoffs_total")


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


class SwapEntry:
    """One preempted request's KV blocks on the host: a dict of CPU
    tensors (one per engine pool entry — k/v payload plus ks/vs scales
    under int8 pools), each shaped ``[L, n_blocks, block_size, ...]``.

    ``staged`` (prefetch): device-resident h2d copies of ``data`` started
    ahead of admission by the offload engine — a restore that finds them
    consumes them directly (a ``prefetch_hit``) instead of paying the
    transfer inline; ``staged_event`` marks their landing on the copy
    stream. ``None`` when nothing is staged."""

    __slots__ = ("data", "n_tokens", "n_blocks", "nbytes", "staged",
                 "staged_event")

    def __init__(self, data: Dict, n_tokens: int):
        self.data = data
        self.n_tokens = int(n_tokens)
        self.n_blocks = int(next(iter(data.values())).shape[1])
        self.nbytes = int(sum(_nbytes(a) for a in data.values()))
        self.staged = None
        self.staged_event = None


class HostKVPool:
    """Bounded host-RAM pool of swapped-out KV, keyed by req_id.

    ``put`` refuses (and counts a refusal) rather than exceed
    ``capacity_bytes`` — the swap tier must never become the OOM.
    Reservations (:meth:`reserve`) participate in every capacity check,
    so an async spill dispatched against reserved room can never be
    refused at landing time.

    ``kind`` names the tier: ``"swap"`` (default, preemption swap),
    ``"prefix"`` (the prefix cache's spill tier,
    :mod:`paddle_tpu_torch.serving.prefix_cache`) or ``"relay"`` (the
    disaggregated prefill→decode handoff tier SHARED between replicas —
    it drives ``serving_disagg_kv_relay_bytes``). A capacity refusal
    counts in ``refusals`` for each kind — swap: recompute fallbacks,
    prefix: drops, relay: ``serving_disagg_handoffs_total{outcome=
    "relay_full"}`` (the decode replica then re-prefills the handed-off
    context — streams identical, the transfer saving is lost)."""

    def __init__(self, capacity_bytes: int, kind: str = "swap"):
        if kind not in ("swap", "prefix", "relay"):
            raise ValueError(f"HostKVPool kind must be 'swap', 'prefix' "
                             f"or 'relay', got {kind!r}")
        self.capacity_bytes = int(capacity_bytes)
        self.kind = kind
        self._g_bytes = (_M_SWAP_BYTES if kind == "swap"
                         else _M_PREFIX_BYTES if kind == "prefix"
                         else _M_RELAY_BYTES)
        self._entries: Dict = {}
        self._bytes = 0
        # incrementally maintained population counts: block_accounting
        # reads swapped_blocks at EVERY step boundary, so it must never
        # be an O(entries) walk (cross-checked against the walk in tests)
        self._blocks = 0
        # outstanding async-spill reservations (offload engine): counted
        # by every capacity check so a dispatched transfer always fits
        self._resv: Dict = {}
        self._reserved = 0
        # capacity refusals — swap: recompute fallbacks, prefix: drops,
        # relay: handoffs the decode side re-prefills
        self.refusals = 0

    def _count_refusal(self) -> None:
        self.refusals += 1
        if self.kind == "swap":
            _M_SWAP_FALLBACK.inc(reason="host_pool_full")
        elif self.kind == "prefix":
            _M_PREFIX_EVICT.inc(kind="drop_host_full")
        else:
            _M_DISAGG_HANDOFFS.inc(outcome="relay_full")

    # -- async-spill reservation protocol ----------------------------------
    def reserve(self, rid, nbytes: int) -> bool:
        """Reserve room for an in-flight spill of ``nbytes`` keyed
        ``rid``; ``False`` (+ a refusal) when the pool cannot fit it.
        Re-reserving a key replaces its reservation, and an existing
        entry under the same key counts as replaced."""
        nbytes = int(nbytes)
        self._reserved -= self._resv.pop(rid, 0)
        old = self._entries.get(rid)
        occupied = self._bytes + self._reserved \
            - (old.nbytes if old is not None else 0)
        if occupied + nbytes > self.capacity_bytes:
            self._count_refusal()
            return False
        self._resv[rid] = nbytes
        self._reserved += nbytes
        return True

    def commit(self, rid, data: Dict, n_tokens: int) -> bool:
        """Turn ``rid``'s reservation into a stored entry (the async
        spill's landing point). Fits by construction when the
        reservation was honest; falls through to :meth:`put` either way
        so the accounting stays in one place."""
        self._reserved -= self._resv.pop(rid, 0)
        return self.put(rid, data, n_tokens)

    def unreserve(self, rid) -> None:
        """Release a reservation whose transfer was cancelled (
        its request went terminal)."""
        self._reserved -= self._resv.pop(rid, 0)

    @property
    def reserved_bytes(self) -> int:
        return self._reserved

    # -- engine-facing ------------------------------------------------------
    def put(self, rid, data: Dict, n_tokens: int) -> bool:
        """Store one request's blocks; ``False`` (+ a refusal) when the
        pool lacks room. A re-preemption of the same rid replaces its
        previous entry."""
        ent = SwapEntry(data, n_tokens)
        old = self._entries.pop(rid, None)
        if old is not None:
            self._bytes -= old.nbytes
            self._blocks -= old.n_blocks
        # a reservation under THIS key is room held for this very payload
        # (an inline reclaim racing its own in-flight proactive spill) —
        # credit it, or the pool refuses a spill it reserved for and the
        # caller drops a perfectly spillable subtree
        resv_self = self._resv.get(rid, 0)
        if self._bytes + self._reserved - resv_self + ent.nbytes \
                > self.capacity_bytes:
            self._count_refusal()
            self._g_bytes.set(self._bytes)
            return False
        self._entries[rid] = ent
        self._bytes += ent.nbytes
        self._blocks += ent.n_blocks
        if self.kind == "swap":
            _M_SWAP_OUT.inc()
        self._g_bytes.set(self._bytes)
        return True

    def get(self, rid) -> Optional[SwapEntry]:
        """Peek (no removal): the engine checks block availability before
        committing to the swap-in."""
        return self._entries.get(rid)

    def pop(self, rid) -> Optional[SwapEntry]:
        """Remove and return the entry — the swap-in commit point."""
        ent = self._entries.pop(rid, None)
        if ent is not None:
            self._bytes -= ent.nbytes
            self._blocks -= ent.n_blocks
            if self.kind == "swap":
                _M_SWAP_IN.inc()
            self._g_bytes.set(self._bytes)
        return ent

    def discard(self, rid) -> None:
        """Drop a request's entry without a swap-in (it finished, shed,
        or expired while queued)."""
        ent = self._entries.pop(rid, None)
        if ent is not None:
            ent.staged = None
            ent.staged_event = None
            self._bytes -= ent.nbytes
            self._blocks -= ent.n_blocks
            self._g_bytes.set(self._bytes)

    # -- accounting ---------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def swapped_blocks(self) -> int:
        """Blocks resident in the tier — incrementally maintained (the
        engine ledger reads this per step; tests cross-check it against
        the entry walk)."""
        return self._blocks

    def __len__(self) -> int:
        return len(self._entries)
