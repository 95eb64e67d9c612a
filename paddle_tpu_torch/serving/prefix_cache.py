"""Refcounted radix/prefix KV cache over the engine's paged block pool —
the port's copy of paddle_tpu/serving/prefix_cache.py.

Requests that share a system prompt or a multi-turn prefix would each
recompute its prefill; this module is the host-side index that makes
cached prefill KV shareable, so prefill cost scales with *new* tokens:

- **Token trie at block granularity.** Each node maps one BLOCK of
  ``block_size`` tokens (keyed by the exact token tuple) to the physical
  pool block holding that block's K/V for *every* layer. A path from the
  root spells a prefix; matching walks the trie block-by-block, so
  ``add_request`` finds the longest cached prefix in O(prompt/bs) dict
  hops. Prefixes anchor at position 0 (RoPE bakes absolute positions
  into K), so equal tokens ⇒ bit-equal cached KV.
- **Refcounts, not copies.** A matched block is *pinned* into the new
  slot's block table (refcount++) — many slots read one physical block.
  Slots never write a pinned block: suffix prefill and decode append
  strictly past the matched region (the partial tail block is always
  slot-private, only FULL blocks enter the trie).
- **LRU eviction only at refcount 0, spill before drop.** Under pool
  pressure the engine reclaims cached blocks least-recently-matched
  first. With a host pool attached
  (:class:`~paddle_tpu_torch.serving.kv_swap.HostKVPool`,
  ``kind="prefix"``) the block's payload spills to host RAM and the trie
  node stays matchable — a later match restores it with one h2d copy
  instead of a re-prefill. Only when the host tier is full (or absent) is
  the node dropped, subtree and all (a dropped interior node would
  strand its descendants: a match must walk a contiguous path).

Accounting contract (``engine.block_accounting``): every device block is
in exactly one of {free, slot-private ("backed"), cache-owned device
node ("cached"), squeezed, in flight}; host-spilled nodes hold NO device
block and ride along as ``host_spilled_blocks``.

Speculative decoding widens what one node's physical block HOLDS, not
the trie's structure: with a draft model configured, every pool block
carries BOTH models' KV for its token range (the draft's ``dk``/``dv``
pool entries are indexed by the same block ids), and spill/restore moves
every pool entry verbatim, so a warm hit re-arms the draft too.

The cache holds no device tensors itself: payloads it spills are the
CPU tensors the engine's ``fetch_fn`` returns. The
``serving_prefix_cache_{hits,misses,evictions}_total``,
``serving_prefill_tokens_skipped_total`` and
``serving_prefix_cache_blocks`` metrics mirror the host counters
``hits``, ``misses``, ``evictions`` and ``tokens_skipped``, which stay.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..observability.catalog import instrument as _instrument

__all__ = ["PrefixCache"]

_M_HITS = _instrument("serving_prefix_cache_hits_total")
_M_MISSES = _instrument("serving_prefix_cache_misses_total")
_M_EVICTIONS = _instrument("serving_prefix_cache_evictions_total")
_M_SKIPPED = _instrument("serving_prefill_tokens_skipped_total")
_M_BLOCKS = _instrument("serving_prefix_cache_blocks")

_uid = itertools.count()


class _Node:
    """One cached block: ``key`` is the exact token tuple it spells,
    ``block`` the physical pool block id (``None`` while the payload is
    host-resident), ``refcount`` the number of slots pinning it.

    Proactive-spill states: ``spilling`` marks an in-flight
    background d2h of this node's payload (the node KEEPS its device
    block — still matchable, still ``cached`` in the ledger);
    ``host_clean`` marks a landed one — the payload now lives in BOTH
    tiers, so a later reclaim frees the device block instantly with
    zero inline d2h (cached blocks are immutable, so the host copy can
    never go stale). ``dead`` marks a dropped node so a spill landing
    after the drop discards its host entry instead of leaking it."""

    __slots__ = ("uid", "key", "parent", "children", "block", "refcount",
                 "stamp", "spilling", "host_clean", "dead")

    def __init__(self, key: Tuple[int, ...], parent: "_Node"):
        self.uid = next(_uid)
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block: Optional[int] = None
        self.refcount = 0
        self.stamp = 0
        self.spilling = False
        self.host_clean = False
        self.dead = False


class PrefixCache:
    """Host-side radix index over cached prefill blocks.

    The engine owns the device pools and the free list; the cache owns
    structure, refcounts, LRU order, and (optionally) the host spill
    tier. Device transfers are injected per call (``fetch_fn`` d2h one
    block, ``restore_fn`` h2d one block, ``alloc_fn`` a free device
    block) so the cache itself stays a pure bookkeeping object —
    unit-testable without a device.
    """

    def __init__(self, block_size: int, host_pool=None):
        self.bs = int(block_size)
        self.host = host_pool          # HostKVPool(kind="prefix") or None
        self.root = _Node((), None)
        self._clock = itertools.count(1)
        # host-visible counters (bench evidence without a registry):
        self.hits = 0                  # lookups matching >= 1 block
        self.misses = 0
        self.tokens_skipped = 0        # prefill tokens served from cache
        # device blocks given up, by kind: "spill" (payload moved to the
        # host tier) and "drop" (node and subtree discarded)
        self.evictions = {"spill": 0, "drop": 0}
        # incremental population counts — the engine reads these on the
        # per-add_request / per-allocation hot paths (_avail_blocks, the
        # admission pressure check), so they must never be O(trie) walks
        self._n_device = 0             # nodes holding a device block
        self._n_evictable = 0          # device nodes at refcount 0
        self._n_host = 0               # spilled (host-resident) nodes

    # -- refcount transitions (keep the incremental counts exact) ---------
    def _pin(self, nd: _Node) -> None:
        nd.refcount += 1
        if nd.refcount == 1 and nd.block is not None:
            self._n_evictable -= 1

    def _unpin(self, nd: _Node) -> None:
        if nd.refcount > 0:
            nd.refcount -= 1
            if nd.refcount == 0 and nd.block is not None:
                self._n_evictable += 1

    # -- lookup -----------------------------------------------------------
    def match_and_pin(self, tokens: List[int], max_blocks: int,
                      alloc_fn: Callable[[int], List[int]],
                      restore_fn: Callable[[List[int], List], None]
                      ) -> Tuple[List[_Node], List[int]]:
        """Walk the longest cached path for ``tokens`` (at most
        ``max_blocks`` blocks — the engine caps at ``(len(ctx)-1)//bs``
        so at least one suffix token always prefills and provides the
        sampling hidden state), pinning every matched node. Host-resident
        nodes on the path are pinned DURING the walk (a reclaim fired by
        a later restore allocation can neither spill nor drop them) and
        restored afterwards in ONE batched ``restore_fn(blocks,
        entries)`` h2d scatter — never a transfer per block
        (``entries`` are the host pool's ``SwapEntry`` objects:
        the engine reads ``.staged`` prefetch buffers when present,
        ``.data`` payload dicts otherwise). If allocation runs dry
        mid-restore the match truncates at the first unrestorable node
        (the tail is unpinned; already-restored prefix blocks stay
        cached).

        Returns ``(nodes, blocks)``; the caller places ``blocks`` at the
        head of the slot's block table and remembers ``nodes`` for
        :meth:`unpin` at slot free."""
        nodes: List[_Node] = []
        pend: List[Tuple[int, _Node, object]] = []   # host-resident hits
        node = self.root
        for b in range(max_blocks):
            key = tuple(tokens[b * self.bs:(b + 1) * self.bs])
            child = node.children.get(key)
            if child is None:
                break
            if child.block is None:
                ent = (self.host.get(("pfx", child.uid))
                       if self.host is not None else None)
                if ent is None:
                    # lost host entry: the node is unrestorable — drop it
                    # (subtree included) and treat as a miss from here
                    if child.refcount == 0:
                        self._drop_subtree(child)
                    break
                pend.append((len(nodes), child, ent))
            self._pin(child)
            child.stamp = next(self._clock)
            nodes.append(child)
            node = child
        if pend:
            blks = list(alloc_fn(len(pend)))    # bulk: ONE reclaim sweep
            if len(blks) < len(pend):
                # truncate at the first host node we could not back
                cut = pend[len(blks)][0]
                for nd in nodes[cut:]:
                    self._unpin(nd)
                nodes = nodes[:cut]
                pend = pend[:len(blks)]
            if pend:
                # entries (not raw payloads) ride to the engine so a
                # prefetch-staged restore (SwapEntry.staged) can
                # consume device-resident buffers instead of paying h2d
                restore_fn(blks, [ent for _i, _nd, ent in pend])
                for blk, (_i, nd, _ent) in zip(blks, pend):
                    self.host.pop(("pfx", nd.uid))
                    nd.block = blk
                    nd.host_clean = False
                    self._n_host -= 1
                    self._n_device += 1   # pinned: not evictable
        return nodes, [nd.block for nd in nodes]

    def host_path_entries(self, tokens: List[int], max_blocks: int):
        """Read-only prefetch peek: walk the cached path for
        ``tokens`` and yield ``(key, entry)`` for every host-resident
        node on it — the offload engine stages their payloads h2d ahead
        of the admission that will :meth:`match_and_pin` them. Nothing
        is pinned, restored, or restamped."""
        if self.host is None:
            return
        node = self.root
        for b in range(max_blocks):
            child = node.children.get(
                tuple(tokens[b * self.bs:(b + 1) * self.bs]))
            if child is None:
                return
            if child.block is None:
                ent = self.host.get(("pfx", child.uid))
                if ent is None:
                    return
                yield ("pfx", child.uid), ent
            node = child

    def note_lookup(self, cached_tokens: int) -> None:
        """Count one admission-time lookup (hit ⇔ >= 1 block matched)."""
        if cached_tokens > 0:
            self.hits += 1
            self.tokens_skipped += cached_tokens
            _M_HITS.inc()
            _M_SKIPPED.inc(cached_tokens)
        else:
            self.misses += 1
            _M_MISSES.inc()

    # -- insertion --------------------------------------------------------
    def extend(self, tokens: List[int], start_block: int,
               blocks: List[int], pin: bool) -> List[_Node]:
        """Adopt the slot's freshly written FULL blocks into the trie:
        ``blocks[i]`` holds the KV of token block ``start_block + i``
        (BOTH models' KV under speculative decoding — the pool entries
        share block ids). Walks the existing path to ``start_block`` (it
        exists whenever ``start_block > 0`` was matched or previously
        adopted); adoption stops at the first token block another
        request already cached — the trie keeps ONE physical block per
        prefix and the caller keeps (and later frees) its duplicate.
        Multi-token commits (spec waves, multi-step decode) can hand
        several blocks in one call; the loop adopts them in order.
        Returns the adopted nodes, in table order, ``pin=True`` leaving
        each pinned for the caller (prefill-time adoption) and
        ``pin=False`` leaving them at refcount 0 (finish-time adoption
        by a dying slot)."""
        node = self.root
        for b in range(start_block):
            node = node.children.get(
                tuple(tokens[b * self.bs:(b + 1) * self.bs]))
            if node is None:           # path gone (evicted): nothing to do
                return []
        adopted: List[_Node] = []
        for i, blk in enumerate(blocks):
            b = start_block + i
            key = tuple(tokens[b * self.bs:(b + 1) * self.bs])
            if len(key) < self.bs:
                break                  # partial tail never enters the trie
            if key in node.children:
                break                  # someone already cached this block
            child = _Node(key, node)
            child.block = int(blk)
            child.refcount = 1 if pin else 0
            child.stamp = next(self._clock)
            node.children[key] = child
            self._n_device += 1
            if not pin:
                self._n_evictable += 1
            adopted.append(child)
            node = child
        return adopted

    def unpin(self, nodes: List[_Node]) -> None:
        for nd in nodes:
            self._unpin(nd)

    # -- eviction ---------------------------------------------------------
    def spill_candidates(self, n: int) -> List["_Node"]:
        """Pick up to ``n`` coldest refcount-0 device nodes for a
        PROACTIVE background spill — not yet host-backed and not
        already mid-spill — and mark them ``spilling``. The caller (the
        engine's offload tick, under pool pressure only) dispatches the
        async d2h and reports back via :meth:`finish_spill` /
        :meth:`abort_spill`. The walk is O(trie), same order as one
        reclaim sweep, and runs only while pressure holds."""
        cands = sorted((nd for nd in self._iter_nodes()
                        if nd.block is not None and nd.refcount == 0
                        and not nd.spilling and not nd.host_clean),
                       key=lambda x: x.stamp)[:max(0, n)]
        for nd in cands:
            nd.spilling = True
        return cands

    def finish_spill(self, nd: "_Node", ok: bool) -> None:
        """Landing callback for a proactive spill. ``ok=False`` (the
        transfer was abandoned) just clears the mark. On success the
        node becomes ``host_clean`` — resident in BOTH tiers — unless
        it was dropped (discard the orphaned host entry) or already
        moved host-side by an inline reclaim (nothing to do: the
        commit replaced the entry with identical bytes)."""
        nd.spilling = False
        if not ok:
            return
        if nd.dead:
            if self.host is not None:
                self.host.discard(("pfx", nd.uid))
            return
        if nd.block is not None:
            nd.host_clean = True

    def abort_spill(self, nd: "_Node") -> None:
        """The engine could not dispatch the spill (host tier full):
        unmark, so the node stays an ordinary reclaim candidate."""
        nd.spilling = False

    def reclaim(self, n: int,
                fetch_fn: Optional[Callable[[List[int]], Dict]]
                ) -> List[int]:
        """Free at least ``n`` device blocks (when reclaimable) from
        refcount-0 nodes, least recently matched first: ``host_clean``
        nodes (their payload already landed host-side via a proactive
        background spill) free INSTANTLY — zero inline d2h, the point of
        the offload tier — others spill to the host tier when they fit
        (the node stays matchable), else drop the node and its whole subtree (a
        pinned descendant is impossible — pinning pins the full path).
        ONE LRU sweep and ONE batched d2h (``fetch_fn(blocks)``
        returning per-pool tensors stacked on the block axis — one
        transfer per pool entry) per call, however many blocks move:
        callers needing k blocks must ask for k, not call this k times.
        May over-deliver when a drop frees a subtree."""
        freed: List[int] = []
        # one LRU-ordered sweep (stamps are stable during the reclaim;
        # nodes a subtree drop already freed show block=None and skip)
        cands = sorted((nd for nd in self._iter_nodes()
                        if nd.block is not None and nd.refcount == 0),
                       key=lambda x: x.stamp)
        batch, idx = cands[:n], min(n, len(cands))
        fetch = []
        for nd in batch:
            if nd.host_clean:
                # the proactive spill already paid the d2h in the
                # background: complete the eviction for free
                freed.append(nd.block)
                nd.block = None
                nd.host_clean = False
                nd.spilling = False
                self._n_device -= 1
                self._n_evictable -= 1
                self._n_host += 1
                self.evictions["spill"] += 1
                _M_EVICTIONS.inc(kind="spill")
            else:
                fetch.append(nd)
        if self.host is not None and fetch_fn is not None and fetch:
            datas = fetch_fn([nd.block for nd in fetch])
            for i, nd in enumerate(fetch):
                if nd.block is None:   # freed by an earlier subtree drop
                    continue
                # a copy — a view would keep the whole batch tensor
                # alive behind the host pool's byte accounting
                data = {name: _slice_copy(arr, i)
                        for name, arr in datas.items()}
                if self.host.put(("pfx", nd.uid), data, n_tokens=self.bs):
                    freed.append(nd.block)
                    nd.block = None
                    self._n_device -= 1
                    self._n_evictable -= 1
                    self._n_host += 1
                    self.evictions["spill"] += 1
                    _M_EVICTIONS.inc(kind="spill")
                else:
                    freed.extend(self._drop_subtree(nd))
        else:
            for nd in fetch:
                if len(freed) >= n:
                    break
                if nd.block is None or nd.refcount:
                    continue
                freed.extend(self._drop_subtree(nd))
        for nd in cands[idx:]:
            if len(freed) >= n:
                break
            if nd.block is None or nd.refcount:
                continue
            freed.extend(self._drop_subtree(nd))
        return freed

    def _drop_subtree(self, node: _Node, count: bool = True) -> List[int]:
        """Detach ``node`` and free its whole subtree (device blocks
        returned, host entries discarded). The eviction counter records
        only nodes that actually held a device block, and only when
        ``count`` (pressure-driven drops) — crash-recovery ``clear`` is
        not cache thrash and must not look like it on a dashboard."""
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        freed: List[int] = []
        stack = [node]
        while stack:
            nd = stack.pop()
            assert nd.refcount == 0, "dropping a pinned cache node"
            nd.dead = True          # a spill landing later must discard
            if nd.block is not None:
                freed.append(nd.block)
                nd.block = None
                self._n_device -= 1
                self._n_evictable -= 1
                if count:
                    self.evictions["drop"] += 1
                    _M_EVICTIONS.inc(kind="drop")
                if nd.host_clean and self.host is not None:
                    # dual-resident node: its host copy dies with it
                    self.host.discard(("pfx", nd.uid))
                nd.host_clean = False
            else:
                self._n_host -= 1
                if self.host is not None:
                    self.host.discard(("pfx", nd.uid))
            stack.extend(nd.children.values())
            nd.children = {}
        return freed

    def clear(self) -> List[int]:
        """Drop everything (crash recovery: the pools' contents are
        suspect). Returns all device blocks for the free list."""
        freed: List[int] = []
        for child in list(self.root.children.values()):
            freed.extend(self._drop_subtree(child, count=False))
        return freed

    # -- accounting -------------------------------------------------------
    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    @property
    def device_blocks(self) -> int:
        return self._n_device

    @property
    def evictable_blocks(self) -> int:
        """Device blocks reclaimable right now (refcount 0)."""
        return self._n_evictable

    @property
    def host_blocks(self) -> int:
        return self._n_host

    @property
    def host_bytes(self) -> int:
        return self.host.bytes_used if self.host is not None else 0

    def update_gauges(self) -> None:
        _M_BLOCKS.set(self.device_blocks)


def _slice_copy(arr, i: int):
    """Block ``i`` of a fetched batch ``arr`` [L, n, ...] as a tensor of
    its own, pinned when ``arr`` is (so a later prefetch's h2d copy stays
    asynchronous)."""
    out = torch.empty((arr.shape[0], 1) + tuple(arr.shape[2:]),
                      dtype=arr.dtype, pin_memory=arr.is_pinned())
    return out.copy_(arr[:, i:i + 1])
