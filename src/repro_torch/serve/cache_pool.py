"""Paged KV cache pool for continuous batching, one shard (port of
``PagedCachePool`` in ``repro/serve/cache_pool.py``).

Attention K/V lives in block-major tensors ``(n_blocks, block_size, Hkv,
D)`` (MLA latents in ``(n_blocks, block_size, r)``); each slot maps its logical pages to physical blocks through a host-side
block table, and blocks are allocated as prefill and decode cross block
boundaries, so memory scales with live tokens. Admission reserves a request's
worst-case block count (prompt + ``max_new_tokens - 1`` writes), which makes
mid-decode allocation infallible while materializing blocks lazily;
:meth:`can_admit` returning False is the scheduler's backpressure signal.
Physical block 0 is never allocated: it is the trash block that absorbs
writes from vacant rows and prefill padding.

Not ported yet: the prefix index with copy-on-write forks and the cached-LRU
(prefix caching), page quarantine and poisoning (fault tolerance), and mesh
sharding of the pool.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.spec import param_bytes

__all__ = ["PagedCachePool", "paged_block_bytes"]


def paged_block_bytes(model, block_size: int) -> int:
    """Device bytes one KV block adds across all layers (the marginal cost
    of ``block_size`` live tokens under paging)."""
    return (param_bytes(model.paged_cache_specs(1, 2, block_size))
            - param_bytes(model.paged_cache_specs(1, 1, block_size)))


class PagedCachePool:
    """``n_blocks`` blocks of ``block_size`` tokens shared by ``n_slots``
    decode rows through per-slot block tables.

    Invariants the attention kernel relies on: a block has one writer at a
    time (block 0 none — it is the trash sink), and a slot's pages are
    allocated in logical order and written contiguously, so the length mask
    alone separates live keys from stale block contents and freed blocks need
    no scrubbing before reuse."""

    def __init__(self, model, n_slots: int, max_len: int,
                 block_size: int = 16, n_blocks=None,
                 device: DeviceLike = None, caches: Optional[dict] = None):
        if n_slots < 1 or max_len < 1 or block_size < 1:
            raise ValueError((n_slots, max_len, block_size))
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)     # table width per slot
        self.n_blocks = self.plan_blocks(n_slots, max_len, block_size,
                                         n_blocks)
        self.device = resolve_device(device)
        if caches is None:
            caches = model.init_paged_cache(n_slots, self.n_blocks,
                                            block_size, self.device)
        else:
            self._reuse(model, caches)
        self.caches = caches
        # pop() yields block 1 and slot 0 first, as in the reference
        self._free_blocks = list(range(self.n_blocks - 1, 0, -1))
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self._reserved = 0
        self._slot_reserve: dict = {}       # slot -> outstanding reservation
        self._slot_blocks: dict = {}        # slot -> [block ids]
        self.block_tables = np.full((n_slots, self.max_blocks), -1, np.int32)

    def _reuse(self, model, caches: dict) -> None:
        """Take another pool's cache tensors (the engine keeps them across
        drains, so its decode step's CUDA graph stays bound to them),
        zeroed: the drain then sees what a new pool holds."""
        specs = model.paged_cache_specs(self.n_slots, self.n_blocks,
                                        self.block_size)
        for key, spec in specs.items():
            layer, leaf = key.split("@attn/")
            t = caches.get(layer, {}).get(leaf)
            if (t is None or tuple(t.shape) != tuple(spec.shape)
                    or t.dtype != spec.dtype
                    or t.device.type != self.device.type):
                raise ValueError(f"cache tensor {key} does not fit this "
                                 f"pool ({spec.shape}, {spec.dtype})")
        for layer in caches.values():
            for t in layer.values():
                t.zero_()

    @staticmethod
    def plan_blocks(n_slots: int, max_len: int, block_size: int,
                    n_blocks=None) -> int:
        """Pool size incl. the trash block; the default is the worst case
        (every slot decodes to ``max_len``), which never backpressures."""
        if n_blocks is None:
            n_blocks = 1 + n_slots * -(-max_len // block_size)
        if n_blocks < 2:
            raise ValueError("need at least the trash block plus one")
        return int(n_blocks)

    # ---- budget / accounting ----
    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def n_free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def blocks_in_use(self) -> int:
        return (self.n_blocks - 1) - self.n_free_blocks

    @property
    def allocatable_blocks(self) -> int:
        """Largest single-request reservation the pool can ever satisfy."""
        return self.n_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        return max(-(-n_tokens // self.block_size), 1)

    def blocks_for_request(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case blocks a request can touch: the prompt plus one KV
        write per decode step (the last generated token is never written)."""
        return self.blocks_for(prompt_len + max(max_new_tokens - 1, 0))

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        need = self.blocks_for_request(prompt_len, max_new_tokens)
        return (bool(self._free_slots)
                and need <= len(self._free_blocks) - self._reserved)

    # ---- slot lifecycle ----
    def alloc_slot(self, prompt_len: int, max_new_tokens: int) -> int:
        """Claim a slot and reserve the request's worst-case block budget."""
        need = self.blocks_for_request(prompt_len, max_new_tokens)
        if need > self.allocatable_blocks:
            raise ValueError(f"request needs {need} blocks but the pool only "
                             f"has {self.allocatable_blocks} allocatable "
                             f"blocks")
        if not self.can_admit(prompt_len, max_new_tokens):
            raise RuntimeError("paged cache pool exhausted")
        slot = self._free_slots.pop()
        self._reserved += need
        self._slot_reserve[slot] = need
        self._slot_blocks[slot] = []
        return slot

    def free_slot(self, slot: int) -> None:
        """Return the slot, its blocks and any unused reservation."""
        if slot in self._free_slots or not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} is not in use")
        for b in reversed(self._slot_blocks.pop(slot, [])):
            self._free_blocks.append(b)
        self._reserved -= self._slot_reserve.pop(slot, 0)
        self.block_tables[slot] = -1
        self._free_slots.append(slot)

    def _alloc_block(self, slot: int) -> int:
        if not self._free_blocks:
            raise RuntimeError("paged cache pool out of blocks")
        blk = self._free_blocks.pop()
        if self._slot_reserve.get(slot, 0) > 0:
            self._slot_reserve[slot] -= 1
            self._reserved -= 1
        self._slot_blocks[slot].append(blk)
        return blk

    def ensure_block(self, slot: int, pos: int) -> None:
        """Materialize the page for decode write position ``pos`` when it
        crosses a block boundary (covered by the admission reservation)."""
        page, off = divmod(int(pos), self.block_size)
        if off == 0 and self.block_tables[slot, page] < 0:
            self.block_tables[slot, page] = self._alloc_block(slot)

    def ensure_range(self, slot: int, start: int, end: int) -> None:
        """Materialize every page covering logical positions [start, end)."""
        if not 0 <= start < end:
            raise ValueError((start, end))
        for page in range(int(start) // self.block_size,
                          -(-int(end) // self.block_size)):
            if self.block_tables[slot, page] < 0:
                self.block_tables[slot, page] = self._alloc_block(slot)

    def block_tables_device(self) -> torch.Tensor:
        # hand the device a private copy: torch.from_numpy aliases the host
        # array, and the pool mutates block_tables in place
        # (ensure_block/ensure_range/free_slot) while a step may still read it
        return torch.from_numpy(self.block_tables.copy()).to(self.device)
