"""KV/SSM cache pools for continuous batching, one shard (port of
``repro/serve/cache_pool.py``): dense slots and paged blocks.

:class:`CachePool` (dense) owns one cache tree whose leading axis is the
slot axis: ``n_slots`` sequences decode together, each slot a ring of
``max_len`` rows (windowed layers: ``window`` + the prefill chunk length).
Its memory scales with ``n_slots * max_len`` whatever the live tokens.

:class:`PagedCachePool` replaces the per-slot rings with a shared store of
fixed-size blocks.

SSM state (mamba and hybrid layers) has no sequence axis and stays
slot-major in both pools: ``(n_slots, ...)`` rows that a request's first
prefill chunk (start 0) resets and later chunks resume. It is counted by
``dense_slot_bytes`` and ``paged_slot_bytes``; forks, poisoned pages and
quarantine touch only block-major leaves, and a quarantined slot's state is
reset by the next admission's first chunk, as in the reference.

Attention K/V lives in block-major tensors ``(n_blocks, block_size, Hkv,
D)`` (MLA latents in ``(n_blocks, block_size, r)``); each slot maps its
logical pages to physical blocks through a host-side block table, and blocks
are allocated as prefill and decode cross block boundaries, so memory scales
with live tokens. Admission reserves a request's worst-case block count
(prompt + ``max_new_tokens - 1`` writes), which makes mid-decode allocation
infallible while materializing blocks lazily; :meth:`can_admit` returning
False is the scheduler's backpressure signal. Physical block 0 is never
allocated, indexed or cached: it is the trash block that absorbs writes from
vacant rows and prefill padding.

Blocks are refcounted and may be shared read-only between slots (prefix
caching): prompts are hashed block by block with chained digests
(``h_j = sha256(h_{j-1} || tokens_j)``, byte for byte the reference's), so
one digest match implies the whole prefix up to that block matches. A
request whose chain matches resident blocks claims them (refcount + 1), maps
them into its table and skips their prefill. A write into a shared block
forks it first (copy-on-write, :meth:`ensure_range`): the block is copied on
the device (``LM.paged_copy_block``, in place into the pool's tensors), the
slot's table points at the copy, and the parent chain is never mutated.
Indexed blocks whose refcount drops to zero stay resident in an LRU of
cached blocks, which :meth:`_alloc_block` reclaims (de-indexing each) only
once the free list is empty; ``n_free_blocks`` counts free plus cached.

Fault containment, as in the reference: :meth:`quarantine_slot` takes the
blocks of a slot whose logits went non-finite out of circulation for good
(de-indexed, forked away from live borrowers, never on the free list or in
the cached LRU again), so the pool's capacity shrinks by one block each;
:meth:`poison_block` is the fault injector's NaN page; :meth:`reconcile`
settles the books after a drain that raised. :meth:`size_n_blocks` sizes a
pool from a request profile instead of the worst case.

Mesh sharding, as in the reference: under a serving mesh layout (or with
``data_shards`` for the host accounting alone) the paged pool splits into
per-shard books over the ``data`` axis (:class:`PagedCachePool`), and both
pools hold this rank's shard of the cache tensors
(``serve.parallel.local_specs``).
"""
from __future__ import annotations

import hashlib
from collections import Counter, OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import cache_leaf, cache_tensors
from repro_torch.nn.spec import param_bytes
from repro_torch.quant.formats import cast_to

__all__ = ["CachePool", "PagedCachePool", "dense_slot_bytes",
           "paged_block_bytes", "paged_slot_bytes"]


def dense_slot_bytes(model, max_len: int) -> int:
    """Device bytes one dense cache slot pins at ``max_len``, whether or
    not it holds live tokens."""
    return param_bytes(model.cache_specs(1, max_len))


def paged_block_bytes(model, block_size: int) -> int:
    """Device bytes one KV block adds across all layers (the marginal cost
    of ``block_size`` live tokens under paging)."""
    return (param_bytes(model.paged_cache_specs(1, 2, block_size))
            - param_bytes(model.paged_cache_specs(1, 1, block_size)))


def paged_slot_bytes(model, block_size: int) -> int:
    """Device bytes one slot pins under paging whatever its live tokens:
    the slot-major leaves (SSM state on mamba and hybrid archs; none on
    attention and MLA models)."""
    return (param_bytes(model.paged_cache_specs(2, 1, block_size))
            - param_bytes(model.paged_cache_specs(1, 1, block_size)))


class CachePool:
    """``n_slots`` dense cache slots of ``max_len`` rows for one model.

    ``chunk_extra`` widens windowed rings by the prefill chunk length
    (``LM.cache_specs``). A request's first prefill chunk resets its slot's
    ``pos`` ring, so stale K/V of the slot's last occupant never reaches
    its attention; :meth:`insert` overwrites a whole slot with a batch-1
    cache tree. ``caches`` takes another pool's tensors (the engine keeps
    them, so its steps' CUDA graphs stay bound to them), reset."""

    def __init__(self, model, n_slots: int, max_len: int,
                 chunk_extra: int = 0, device: DeviceLike = None,
                 caches: Optional[dict] = None, mesh_layout=None):
        if n_slots < 1 or max_len < 1:
            raise ValueError((n_slots, max_len))
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk_extra = chunk_extra
        self.layout = mesh_layout
        self.device = resolve_device(device)
        specs = model.cache_specs(n_slots, max_len, chunk_extra=chunk_extra)
        if mesh_layout is not None:
            # this rank's slots (over data) and KV heads (over model)
            from repro_torch.serve.parallel import local_specs
            specs = local_specs(specs, mesh_layout)
        if caches is None:
            caches = model._materialize(specs, self.device)
        else:
            for key, spec in specs.items():
                t = cache_leaf(caches, key)
                if (t is None or tuple(t.shape) != tuple(spec.shape)
                        or t.dtype != spec.dtype):
                    raise ValueError(f"cache tensor {key} does not fit this "
                                     f"pool ({spec.shape}, {spec.dtype})")
                t.fill_(-1 if key.endswith("/pos") else 0)
        self.caches = caches
        self._free = list(range(n_slots - 1, -1, -1))  # pop() gives slot 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    # the uniform pool interface (shared with PagedCachePool)
    @property
    def n_free_slots(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """Claim a free slot; raises RuntimeError when the pool is full."""
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        return self._free.pop()

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots or slot in self._free:
            raise ValueError(f"slot {slot} is not in use")
        self._free.append(slot)

    def free_slot(self, slot: int) -> None:
        self.free(slot)

    def insert(self, slot: int, request_cache: dict) -> None:
        """Copy a batch-1 cache tree into ``slot``, overwriting the whole
        row (its ``pos`` ring included). Not on the engine's path, which
        prefills the pool's rows in place; kept as the reference's cache
        injection API. Not under a mesh, whose rows are split over ranks."""
        if self.layout is not None:
            raise NotImplementedError(
                "CachePool.insert copies a whole batch-1 cache tree; a mesh "
                "pool's rows and heads are split over ranks")
        for layer, node in request_cache.items():
            pairs = zip(cache_tensors({layer: node}),
                        cache_tensors({layer: self.caches[layer]}))
            for (_, t), (_, dst) in pairs:
                dst[slot].copy_(cast_to(t[0], dst.dtype))

    # dense slots carry no state across drains
    def reset_counters(self) -> None:
        pass

    def invalidate_prefix_index(self) -> None:
        pass


class PagedCachePool:
    """``n_blocks`` blocks of ``block_size`` tokens shared by ``n_slots``
    decode rows through per-slot block tables.

    Invariants the attention kernel relies on: a block has one writer at a
    time (a trash block none — it is the sink) but may have many readers: a
    refcounted prefix block sits in several slots' tables, and its contents
    are what each sharer's own prefill would have written there (per-token
    quant scales make K/V a function of the tokens at and before each
    position). A slot never writes a shared block: the one write that could
    land in one (the tail chunk of a fully matched prompt) forks it first,
    and decode writes land past the matched prefix. A slot's pages are
    written contiguously, so the length mask alone separates live keys from
    stale block contents and freed blocks need no scrubbing before reuse.

    Admission: :meth:`alloc_slot` reserves the request's worst-case block
    count less the matched blocks (plus one for the fork a full-prompt hit
    needs); :meth:`ensure_block` / :meth:`ensure_range` draw on the
    reservation as prefill and decode cross block boundaries.

    Shards, as in the reference: with pages sharded over a mesh's ``data``
    axis (``mesh_layout.shard_pages``, or ``data_shards`` for the host
    accounting alone) the pool splits into equal shards. Shard ``d`` owns
    pages ``[d*bps, (d+1)*bps)`` with its own trash block at ``d*bps``, and
    slot ``s`` lives on shard ``s // slots_per_shard`` and draws blocks
    from it alone. Free lists, reservations, the prefix index, the cached
    LRU and quarantine are per shard: a prefix resident on another shard is
    a miss. :meth:`_plan_admission` gates on each shard's own budget and
    places a request on the shard with the longest match (then the most
    free capacity, then the lowest shard). Block tables keep global ids;
    the layers translate them to shard-local ones. With one shard the
    allocator is today's single-device one bit for bit (same lists, same
    pop order). Under a mesh the books are the same on every rank (each
    runs the same scheduler) and ``caches`` holds this rank's shard: its
    data shard's pages (all pages when they are not sharded), its model
    shard of the KV heads, its slots' SSM rows."""

    def __init__(self, model, n_slots: int, max_len: int,
                 block_size: int = 16, n_blocks=None,
                 device: DeviceLike = None, caches: Optional[dict] = None,
                 mesh_layout=None, data_shards: int = 1):
        if n_slots < 1 or max_len < 1 or block_size < 1:
            raise ValueError((n_slots, max_len, block_size))
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.layout = mesh_layout
        self.max_blocks = -(-max_len // block_size)     # table width per slot
        data = mesh_layout.data if mesh_layout is not None else data_shards
        n_blocks, shard_pages, bps = self.plan_blocks(
            n_slots, max_len, block_size, n_blocks=n_blocks, data_shards=data)
        if mesh_layout is not None and (n_blocks, shard_pages) != (
                mesh_layout.n_blocks, mesh_layout.shard_pages):
            raise ValueError("pool geometry disagrees with the serving mesh "
                             "layout")
        self.n_blocks = n_blocks
        self.n_shards = data if shard_pages else 1
        self.blocks_per_shard = bps
        self.slots_per_shard = n_slots // self.n_shards
        self.device = resolve_device(device)
        if caches is None:
            caches = model._materialize(self._specs(), self.device)
        else:
            self._reuse(caches)
        self.caches = caches
        # per-shard free lists; shard d's trash block d*bps is never listed
        # (one shard: blocks [1, n_blocks), trash 0). pop() yields a
        # shard's first block and slot first, as in the reference
        self._free_blocks_by_shard = [
            list(range((d + 1) * bps - 1, d * bps, -1))
            for d in range(self.n_shards)]
        self._free_slots_by_shard = [
            list(range((d + 1) * self.slots_per_shard - 1,
                       d * self.slots_per_shard - 1, -1))
            for d in range(self.n_shards)]
        self._reserved_by_shard = [0] * self.n_shards
        self._slot_reserve: dict = {}       # slot -> outstanding reservation
        self._slot_blocks: dict = {}        # slot -> [referenced block ids]
        self.block_tables = np.full((n_slots, self.max_blocks), -1, np.int32)
        # ---- prefix sharing ----
        self._ref: dict = {}                # block -> refcount (materialized)
        self._index_by_shard = [dict() for _ in range(self.n_shards)]
        self._block_digest: dict = {}       # block -> (shard, digest)
        self._cached_by_shard = [OrderedDict()      # refcount-0 indexed,
                                 for _ in range(self.n_shards)]    # LRU
        self._slot_digests: dict = {}       # slot -> prompt block digests
        self._slot_borrowed: dict = {}      # slot -> {shared page indices}
        self._slot_matched: dict = {}       # slot -> matched prefix tokens
        self._slot_registered: dict = {}    # slot -> pages indexed so far
        # ---- fault containment: poisoned blocks out of circulation ----
        self._quarantined_by_shard = [set() for _ in range(self.n_shards)]
        # blocks awaiting quarantine: still mapped by a borrower that could
        # not be forked off (pool dry); _release quarantines them when the
        # last reference drops
        self._quarantine_pending: set = set()
        self.reset_counters()

    def _specs(self) -> dict:
        """This rank's cache specs (the whole pool's without a mesh)."""
        specs = self.model.paged_cache_specs(self.n_slots, self.n_blocks,
                                             self.block_size)
        if self.layout is None:
            return specs
        from repro_torch.serve.parallel import local_specs
        return local_specs(specs, self.layout)

    def _reuse(self, caches: dict) -> None:
        """Take another pool's cache tensors (the engine keeps them, so its
        decode step's CUDA graph stays bound to them), zeroed: this pool's
        index is empty, so nothing may point at what they held."""
        for key, spec in self._specs().items():
            t = cache_leaf(caches, key)
            if (t is None or tuple(t.shape) != tuple(spec.shape)
                    or t.dtype != spec.dtype
                    or t.device.type != self.device.type):
                raise ValueError(f"cache tensor {key} does not fit this "
                                 f"pool ({spec.shape}, {spec.dtype})")
        for _, t in cache_tensors(caches):
            t.zero_()

    def reset_counters(self) -> None:
        """Zero the per-drain tallies (the engine keeps one pool, and its
        prefix index, across drains)."""
        self.prefix_hit_requests = 0
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.cow_forks = 0
        self.reclaimed_cached_blocks = 0
        self.quarantined_blocks = 0          # this drain's; the set stays

    def invalidate_prefix_index(self) -> None:
        """Forget every indexed block: cached ones return to the free lists,
        ones still mapped by live slots are de-indexed (they rejoin the free
        list on release) and live slots stop registering their pages."""
        for blk in list(self._block_digest):
            d, _ = self._block_digest[blk]
            self._deindex(blk)
            if blk in self._cached_by_shard[d]:
                del self._cached_by_shard[d][blk]
                self._free_blocks_by_shard[d].append(blk)
        for idx in self._index_by_shard:
            idx.clear()
        for slot in self._slot_digests:
            self._slot_digests[slot] = []

    # the single-shard books under their old names (tests and callers
    # that predate the shards); with several shards, merged copies
    @property
    def _free_blocks(self) -> list:
        if self.n_shards == 1:
            return self._free_blocks_by_shard[0]
        return [b for lst in self._free_blocks_by_shard for b in lst]

    @property
    def _cached(self) -> OrderedDict:
        if self.n_shards == 1:
            return self._cached_by_shard[0]
        out: OrderedDict = OrderedDict()
        for c in self._cached_by_shard:
            out.update(c)
        return out

    @property
    def _index(self) -> dict:
        if self.n_shards == 1:
            return self._index_by_shard[0]
        out: dict = {}
        for idx in self._index_by_shard:
            out.update(idx)
        return out

    @property
    def _reserved(self) -> int:
        return sum(self._reserved_by_shard)

    @property
    def _quarantined(self) -> set:
        return set().union(*self._quarantined_by_shard)

    @staticmethod
    def plan_blocks(n_slots: int, max_len: int, block_size: int,
                    n_blocks=None, data_shards: int = 1) -> tuple:
        """The pool geometry ``(n_blocks, shard_pages, blocks_per_shard)``,
        which the pool and ``serve.parallel.make_serving_layout`` share.
        The default size is the worst case (every slot decodes to
        ``max_len``), which never backpressures; a sharded default gives
        every shard its own trash block. Pages shard over ``data`` only
        when the slots and the blocks both split evenly (at least two
        blocks a shard); otherwise the pool stays whole, with the one trash
        block 0, as the ``kv_blocks`` rule's fallback replicates it."""
        max_blocks = -(-max_len // block_size)
        slots_ok = data_shards > 1 and n_slots % data_shards == 0
        if n_blocks is None:
            n_blocks = (data_shards * (1 + (n_slots // data_shards)
                                       * max_blocks)
                        if slots_ok else 1 + n_slots * max_blocks)
        n_blocks = int(n_blocks)
        shard = (slots_ok and n_blocks % data_shards == 0
                 and n_blocks >= 2 * data_shards)
        if n_blocks < 2:
            raise ValueError("need at least the trash block plus one")
        return n_blocks, shard, n_blocks // (data_shards if shard else 1)

    @staticmethod
    def size_n_blocks(profile, n_slots: int, block_size: int, *,
                      percentile: float = 95.0, headroom: float = 1.25,
                      data_shards: int = 1) -> int:
        """``n_blocks`` sized from a request profile (``(prompt_len,
        max_new_tokens)`` pairs) instead of the worst case: the FCFS
        live-block trajectory over ``n_slots`` rows at one decode step per
        tick, its ``percentile`` times ``headroom``, plus the trash
        block(s); clamped to [largest request, worst case] and rounded up
        to a multiple of ``data_shards``. Below the worst case the pool
        trades memory for occasional admission backpressure."""
        profile = [(int(p), int(m)) for p, m in profile]
        if not profile:
            raise ValueError("size_n_blocks needs a non-empty profile")

        def bf(n):
            return max(-(-n // block_size), 1)
        max_blocks_req = max(bf(p + max(m - 1, 0)) for p, m in profile)
        worst = n_slots * max(max_blocks_req, 1)
        # a request holds its slot for max(m, 1) ticks and, at decode tick
        # t, the blocks covering p + t tokens
        free_at = [0] * n_slots
        demand: dict = {}
        for p, m in profile:
            s = min(range(n_slots), key=free_at.__getitem__)
            start, dur = free_at[s], max(m, 1)
            for t in range(dur):
                demand[start + t] = demand.get(start + t, 0) + bf(p + t)
            free_at[s] = start + dur
        live = sorted(demand.values())
        idx = min(int(len(live) * percentile / 100.0), len(live) - 1)
        need = int(np.ceil(live[idx] * headroom))
        need = max(min(need, worst), max_blocks_req)
        n = need + max(data_shards, 1)                     # trash block(s)
        if data_shards > 1:
            n = -(-n // data_shards) * data_shards
        return n

    # ---- budget / accounting ----
    @property
    def n_free_slots(self) -> int:
        return sum(len(s) for s in self._free_slots_by_shard)

    @property
    def n_free_blocks(self) -> int:
        """Allocatable blocks: free plus cached (refcount-0 indexed blocks
        are resident prefix content, reclaimed on demand)."""
        return (sum(len(b) for b in self._free_blocks_by_shard)
                + self.n_cached_blocks)

    @property
    def n_cached_blocks(self) -> int:
        return sum(len(c) for c in self._cached_by_shard)

    @property
    def n_quarantined_blocks(self) -> int:
        return sum(len(q) for q in self._quarantined_by_shard)

    @property
    def blocks_in_use(self) -> int:
        return ((self.n_blocks - self.n_shards - self.n_quarantined_blocks)
                - self.n_free_blocks)

    @property
    def allocatable_blocks(self) -> int:
        """Largest single-request reservation the pool can ever satisfy:
        one shard's blocks but its trash block and its quarantined ones
        (the least quarantined shard's)."""
        return (self.blocks_per_shard - 1
                - min(len(q) for q in self._quarantined_by_shard))

    def _shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard if self.n_shards > 1 else 0

    def _shard_of_block(self, blk: int) -> int:
        return blk // self.blocks_per_shard if self.n_shards > 1 else 0

    def blocks_for(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.block_size), 1)

    def blocks_for_request(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case blocks a request can touch: the prompt plus one KV
        write per decode step (the last generated token is never written)."""
        return self.blocks_for(prompt_len + max(max_new_tokens - 1, 0))

    # ---- prefix hashing / matching ----
    def prefix_digests(self, tokens) -> list:
        """Chained digests of every full block of ``tokens``:
        ``h_j = sha256(h_{j-1} || tokens[j*bs:(j+1)*bs])`` over int32 bytes,
        so one hit at block j implies blocks 0..j all match."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        bs = self.block_size
        out, h = [], b""
        for j in range(toks.shape[0] // bs):
            h = hashlib.sha256(h + toks[j * bs:(j + 1) * bs].tobytes()).digest()
            out.append(h)
        return out

    def _match_blocks(self, digests, d: int = 0) -> list:
        """The longest chain resident on shard ``d``: blocks for
        digests[0..m)."""
        blks = []
        idx = self._index_by_shard[d]
        for h in digests:
            b = idx.get(h)
            if b is None:
                break
            blks.append(b)
        return blks

    def _plan_admission(self, prompt_len: int, max_new_tokens: int,
                        digests=None) -> Optional[tuple]:
        """``(shard, matched blocks, matched tokens, net need)``, or None
        when no shard can admit the request now. For every shard with a
        free slot: the net need is the worst case less the blocks matched
        there, plus one for the fork a full-prompt hit's tail chunk needs;
        it must fit the shard's free + cached blocks less the ones this
        request claims from its cache and less its reservations. The
        longest match wins, then the most free capacity, then the lowest
        shard."""
        total = self.blocks_for_request(prompt_len, max_new_tokens)
        best = None
        for d in range(self.n_shards):
            if not self._free_slots_by_shard[d]:
                continue
            blks = self._match_blocks(digests, d) if digests else []
            m = len(blks)
            matched = m * self.block_size
            cow = 0
            if m and matched >= prompt_len:
                # full-prompt hit: the tail chunk still runs (it produces
                # the first token) and must fork the last shared block
                matched = prompt_len - 1
                cow = 1
            need = total - m + cow
            cached = self._cached_by_shard[d]
            claim_from_cached = sum(1 for b in blks if b in cached)
            avail = (len(self._free_blocks_by_shard[d]) + len(cached)
                     - claim_from_cached - self._reserved_by_shard[d])
            if need > avail:
                continue
            key = (m, avail, -d)
            if best is None or key > best[0]:
                best = (key, (d, blks, matched, need))
        return None if best is None else best[1]

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  digests=None) -> bool:
        return self._plan_admission(prompt_len, max_new_tokens,
                                    digests) is not None

    def matched_tokens(self, slot: int) -> int:
        """Prefix tokens ``slot`` inherited at admission: its prefill starts
        there instead of 0."""
        return self._slot_matched.get(slot, 0)

    # ---- slot lifecycle ----
    def alloc_slot(self, prompt_len: int, max_new_tokens: int,
                   digests=None) -> int:
        """Claim a slot, map any matched prefix blocks into its table
        (refcount + 1 each), and reserve the rest of the request's
        worst-case block budget."""
        total = self.blocks_for_request(prompt_len, max_new_tokens)
        if total > self.allocatable_blocks:
            raise ValueError(f"request needs {total} blocks but the pool only "
                             f"has {self.allocatable_blocks} allocatable "
                             f"blocks"
                             + (" per shard" if self.n_shards > 1 else ""))
        plan = self._plan_admission(prompt_len, max_new_tokens, digests)
        if plan is None:
            raise RuntimeError("paged cache pool exhausted")
        d, blks, matched, need = plan
        slot = self._free_slots_by_shard[d].pop()
        self._reserved_by_shard[d] += need
        self._slot_reserve[slot] = need
        self._slot_blocks[slot] = []
        self._slot_digests[slot] = list(digests) if digests else []
        self._slot_borrowed[slot] = set()
        self._slot_matched[slot] = matched
        self._slot_registered[slot] = 0
        for j, b in enumerate(blks):
            self._claim(d, b)
            self.block_tables[slot, j] = b
            self._slot_blocks[slot].append(b)
            self._slot_borrowed[slot].add(j)
        if blks:
            self.prefix_hit_requests += 1
            self.prefix_hit_blocks += len(blks)
            self.prefix_hit_tokens += matched
        return slot

    def free_slot(self, slot: int) -> None:
        """Return the slot and drop its block references (refcount-0 indexed
        blocks stay cached, others rejoin the free list), with any unused
        reservation."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} is not in use")
        d = self._shard_of(slot)
        if slot in self._free_slots_by_shard[d]:
            raise ValueError(f"slot {slot} is not in use")
        for b in reversed(self._slot_blocks.pop(slot, [])):
            self._release(d, b)
        self._reserved_by_shard[d] -= self._slot_reserve.pop(slot, 0)
        for per_slot in (self._slot_digests, self._slot_borrowed,
                         self._slot_matched, self._slot_registered):
            per_slot.pop(slot, None)
        self.block_tables[slot] = -1
        self._free_slots_by_shard[d].append(slot)

    # ---- refcounted block lifecycle ----
    def _claim(self, d: int, blk: int) -> None:
        """Take a reference on a resident block (a prefix hit)."""
        self._ref[blk] = self._ref.get(blk, 0) + 1
        self._cached_by_shard[d].pop(blk, None)     # in use again

    def _release(self, d: int, blk: int) -> None:
        self._ref[blk] -= 1
        if self._ref[blk] < 0:
            raise RuntimeError(f"block {blk} released more than claimed")
        if self._ref[blk] == 0:
            del self._ref[blk]
            if blk in self._quarantine_pending:
                # a poisoned block whose last borrower let go
                self._quarantine_pending.discard(blk)
                self._quarantine(d, blk)
            elif blk in self._block_digest:
                self._cached_by_shard[d][blk] = None   # resident until
            else:                                      # reclaimed
                self._free_blocks_by_shard[d].append(blk)

    def _deindex(self, blk: int) -> None:
        d, h = self._block_digest.pop(blk)
        if self._index_by_shard[d].get(h) == blk:
            del self._index_by_shard[d][h]

    def _pop_block(self, d: int) -> Optional[int]:
        """A block of shard ``d``: a free one, else the least recently
        released cached one (de-indexing it cuts every chain through it: a
        hit needs every link); None when the shard is dry."""
        if self._free_blocks_by_shard[d]:
            return self._free_blocks_by_shard[d].pop()
        if self._cached_by_shard[d]:
            blk, _ = self._cached_by_shard[d].popitem(last=False)
            self._deindex(blk)
            self.reclaimed_cached_blocks += 1
            return blk
        return None

    def _alloc_block(self, slot: int) -> int:
        d = self._shard_of(slot)
        blk = self._pop_block(d)
        if blk is None:
            raise RuntimeError("paged cache pool out of blocks")
        if self._slot_reserve.get(slot, 0) > 0:
            self._slot_reserve[slot] -= 1
            self._reserved_by_shard[d] -= 1
        self._ref[blk] = 1
        self._slot_blocks[slot].append(blk)
        return blk

    def register_prefix(self, slot: int, upto_tokens: int) -> None:
        """Index ``slot``'s fully written prompt blocks (logical positions
        ``[0, upto_tokens)``) under their chain digests, in its shard's
        index. Incremental: call after each prefill chunk with the
        cumulative length. The first writer wins: a digest already indexed
        (a block this slot borrowed) is skipped. Safe right after the chunk
        is queued: a later reader's chunk is queued after it on the same
        stream."""
        digests = self._slot_digests.get(slot)
        if not digests:
            return
        d = self._shard_of(slot)
        idx = self._index_by_shard[d]
        done = self._slot_registered.get(slot, 0)
        end = min(int(upto_tokens) // self.block_size, len(digests))
        for j in range(done, end):
            h = digests[j]
            blk = int(self.block_tables[slot, j])
            if blk < 0 or blk % self.blocks_per_shard == 0:
                raise RuntimeError(f"slot {slot} page {j} is not allocated")
            if h not in idx:
                idx[h] = blk
                self._block_digest[blk] = (d, h)
        self._slot_registered[slot] = max(done, end)

    def _cow_fork(self, slot: int, page: int) -> None:
        """``slot`` is about to write its shared ``page``: copy the block on
        the device, point the table at the copy and drop the shared
        reference. The parent block, and the chain through it, stay as they
        were."""
        d = self._shard_of(slot)
        src = int(self.block_tables[slot, page])
        dst = self._alloc_block(slot)       # before the release: the fork
        self._copy_block_device(src, dst)   # must never reclaim its source
        self.block_tables[slot, page] = dst
        self._slot_blocks[slot].remove(src)
        self._release(d, src)
        self._slot_borrowed[slot].discard(page)
        self.cow_forks += 1

    def _local_block(self, blk: int) -> Optional[int]:
        """``blk``'s id in this rank's ``caches``: itself without a mesh or
        with unsharded pages, else its shard-local id when this rank holds
        its shard, else None (another data shard's page)."""
        if self.layout is None or not self.layout.shard_pages:
            return int(blk)
        off = self.layout.block_offset()
        if not off <= blk < off + self.blocks_per_shard:
            return None
        return int(blk) - off

    def _copy_block_device(self, src: int, dst: int) -> None:
        s, t = self._local_block(src), self._local_block(dst)
        if s is not None and t is not None:
            self.caches = self.model.paged_copy_block(self.caches, s, t)

    def ensure_block(self, slot: int, pos: int) -> None:
        """Materialize the page for decode write position ``pos`` when it
        crosses a block boundary (covered by the admission reservation)."""
        page, off = divmod(int(pos), self.block_size)
        if off == 0 and self.block_tables[slot, page] < 0:
            self.block_tables[slot, page] = self._alloc_block(slot)
        elif page in self._slot_borrowed.get(slot, ()):
            # matched prefixes end before the first decode position, and a
            # fully matched prompt's last block was forked by its tail chunk
            raise RuntimeError(f"decode would write slot {slot}'s shared "
                               f"page {page}")

    def ensure_range(self, slot: int, start: int, end: int) -> None:
        """Materialize every page covering logical positions [start, end),
        forking a borrowed page in the range before the chunk writes it
        (only the tail chunk of a fully matched prompt has one)."""
        if not 0 <= start < end:
            raise ValueError((start, end))
        borrowed = self._slot_borrowed.get(slot)
        for page in range(int(start) // self.block_size,
                          -(-int(end) // self.block_size)):
            if self.block_tables[slot, page] < 0:
                self.block_tables[slot, page] = self._alloc_block(slot)
            elif borrowed and page in borrowed:
                self._cow_fork(slot, page)

    # ---- fault containment: quarantine, poison, reconcile ----
    def _quarantine(self, d: int, blk: int) -> None:
        """Take ``blk`` out of circulation for good; no table maps it."""
        if blk in self._block_digest:
            self._deindex(blk)
        self._quarantined_by_shard[d].add(blk)
        self.quarantined_blocks += 1

    def _alloc_block_unreserved(self, d: int) -> Optional[int]:
        """A block of shard ``d`` for a quarantine fork-off, charged to no
        reservation (the copy was never part of the borrower's admission
        budget); None when the shard is dry. A later ``_alloc_block`` may
        then raise, which the engine contains as an allocation fault."""
        blk = self._pop_block(d)
        if blk is not None:
            self._ref[blk] = 1
        return blk

    def _fork_off(self, slot: int, page: int) -> bool:
        """Copy ``slot``'s borrowed ``page`` onto a private block so that
        the quarantined source loses this reader (the copy may carry the
        poison too: then the borrower's own tripwire fires). False when the
        pool is dry: the borrower keeps the page, quarantined on its last
        release."""
        d = self._shard_of(slot)
        src = int(self.block_tables[slot, page])
        dst = self._alloc_block_unreserved(d)
        if dst is None:
            return False
        self._slot_blocks[slot].append(dst)
        self._copy_block_device(src, dst)
        self.block_tables[slot, page] = dst
        self._slot_blocks[slot].remove(src)
        self._release(d, src)
        borrowed = self._slot_borrowed.get(slot)
        if borrowed is not None:
            borrowed.discard(page)
        return True

    def quarantine_slot(self, slot: int) -> int:
        """Poisoned-page containment for a faulted slot: every block its
        table maps is de-indexed, forked away from every other slot that
        maps it, dropped from this slot's table and retired to the
        quarantine set, which no allocation path hands out again. The whole
        mapping is suspect: a non-finite logit row does not say which page
        was poisoned. Returns the blocks newly quarantined (a borrowed
        block whose fork failed follows on its last release). Call before
        ``free_slot``."""
        d = self._shard_of(slot)
        before = self.quarantined_blocks
        borrowed = self._slot_borrowed.get(slot, set())
        for page in range(self.max_blocks):
            blk = int(self.block_tables[slot, page])
            if blk < 0:
                continue
            if blk in self._block_digest:
                self._deindex(blk)
            self._quarantine_pending.add(blk)
            for t in range(self.n_slots):
                if t == slot:
                    continue
                for p in np.nonzero(self.block_tables[t] == blk)[0]:
                    self._fork_off(t, int(p))
            self.block_tables[slot, page] = -1
            self._slot_blocks[slot].remove(blk)
            borrowed.discard(page)
            self._release(d, blk)
        return self.quarantined_blocks - before

    def poison_block(self, blk: int) -> None:
        """Fill physical block ``blk`` with NaN in every block-major
        floating-point cache leaf, fp8 ones included (NaN stays NaN in
        e4m3fn and e5m2): the fault injector's NaN page. In place, on the
        current stream; a page of another data shard is not this rank's."""
        local = self._local_block(blk)
        if local is None:
            return
        for key, spec in self.model.paged_cache_specs(1, 1, 1).items():
            if "kv_blocks" not in spec.logical_axes:
                continue
            t = cache_leaf(self.caches, key)
            if t.is_floating_point():
                t.select(spec.logical_axes.index("kv_blocks"),
                         local).fill_(float("nan"))

    def _trash_blocks(self) -> set:
        return {d * self.blocks_per_shard for d in range(self.n_shards)}

    def check_consistency(self) -> dict:
        """Cross-check the books against the block tables: the multiset of
        table entries equals the refcounts, free, cached and quarantined
        blocks are mapped by no table and quarantined ones are neither free
        nor cached, no trash block is anywhere, and every block sits in
        its slot's (or its list's) shard. Returns a report with ``ok`` and
        the mismatches."""
        mat = Counter(int(b) for row in self.block_tables for b in row
                      if b >= 0)
        free = set(self._free_blocks)
        cached = set(self._cached)
        mapped = set(mat)
        quarantined = self._quarantined
        wrong_shard = sorted(
            {int(b) for s, row in enumerate(self.block_tables) for b in row
             if b >= 0 and self._shard_of_block(int(b)) != self._shard_of(s)}
            | {b for d in range(self.n_shards)
               for b in (set(self._free_blocks_by_shard[d])
                         | set(self._cached_by_shard[d])
                         | self._quarantined_by_shard[d])
               if self._shard_of_block(b) != d})
        report = {
            "tables_vs_ref": mat == Counter(self._ref),
            "free_mapped": sorted(free & mapped),
            "cached_mapped": sorted(cached & mapped),
            "quarantined_mapped": sorted(quarantined & mapped),
            "quarantined_free": sorted(quarantined & (free | cached)),
            "free_cached": sorted(free & cached),
            "trash_used": bool(self._trash_blocks() & (
                mapped | free | cached | quarantined
                | set(self._block_digest))),
            "wrong_shard": wrong_shard,
        }
        report["ok"] = (report["tables_vs_ref"] and not report["free_mapped"]
                        and not report["cached_mapped"]
                        and not report["quarantined_mapped"]
                        and not report["quarantined_free"]
                        and not report["free_cached"]
                        and not report["trash_used"]
                        and not report["wrong_shard"])
        return report

    def reconcile(self) -> dict:
        """Repair the books after a drain that re-raised: recompute every
        refcount from the block tables and route blocks no table maps back
        to the cached LRU (indexed), the free list, or quarantine (pending
        quarantine). The engine runs it once every slot has been released,
        so the next drain can reuse the pool. Returns what changed, as the
        reference does."""
        mat = Counter(int(b) for row in self.block_tables for b in row
                      if b >= 0)
        fixed = 0
        for blk, want in mat.items():
            if self._ref.get(blk) != want:
                self._ref[blk] = want
                fixed += 1
        orphans = 0
        for blk in [b for b in self._ref if b not in mat]:
            del self._ref[blk]
            d = self._shard_of_block(blk)
            self._cached_by_shard[d].pop(blk, None)
            if blk in self._free_blocks_by_shard[d]:
                continue
            if blk in self._quarantine_pending:
                self._quarantine_pending.discard(blk)
                self._quarantine(d, blk)
            elif blk in self._block_digest:
                self._cached_by_shard[d][blk] = None
            else:
                self._free_blocks_by_shard[d].append(blk)
            orphans += 1
        return {"ref_fixed": fixed, "orphans_rerouted": orphans,
                "consistent": self.check_consistency()["ok"]}

    def block_tables_device(self) -> torch.Tensor:
        # hand the device a private copy: torch.from_numpy aliases the host
        # array, and the pool mutates block_tables in place
        # (ensure_block/ensure_range/free_slot) while a step may still read
        # it. Global ids: a mesh step's layers translate them per shard
        return host_to_device(self.block_tables.copy(), self.device)


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array built for one step, on ``device`` without blocking the
    host: on CUDA staged in pinned memory and copied with ``non_blocking``
    (PyTorch's caching host allocator records the copy on its stream and
    does not hand the pinned block out again before the copy has run). On
    the CPU the tensor shares the array's memory, so ``arr`` must be
    private to the caller."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
