"""Host-side paged KV-cache management: a block pool and per-slot block
tables (``repro/serve/paged.py`` without the shared-prefix index).

Physical blocks come from a LIFO free list (block 0 first, so allocation
is deterministic); each slot's table lists its blocks in logical order and
holds the sentinel ``pool_blocks`` past them, so every row derived from
an unallocated entry is out of range on the device. One table per slot
serves every layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.numerics.quant import QUANT_KV_DTYPES, kv_code_bytes


def blocks_for(n_tokens: int, page_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` logical tokens."""
    return -(-int(n_tokens) // page_size)


def kv_token_bytes(cfg, kv_dtype: str | None = None) -> int:
    """KV bytes per resident token over every layer: K and V rows of
    ``Hkv * hd`` elements, plus one float32 scale per row when quantized."""
    kv_dtype = kv_dtype if kv_dtype is not None else cfg.kv_dtype
    quant = kv_dtype in QUANT_KV_DTYPES
    elem = (kv_code_bytes(kv_dtype) if quant
            else getattr(torch, cfg.dtype).itemsize)
    rows = 2 * cfg.num_kv_heads
    per_layer = rows * cfg.resolved_head_dim() * elem + (rows * 4 if quant
                                                          else 0)
    return per_layer * cfg.num_layers


class BlockPool:
    """Fixed pool of KV blocks with per-slot block tables."""

    def __init__(self, pool_blocks: int, page_size: int, slots: int,
                 max_blocks_per_seq: int):
        if pool_blocks <= 0 or page_size <= 0:
            raise ValueError(f"pool_blocks and page_size must be positive, "
                             f"got {pool_blocks}, {page_size}")
        self.pool_blocks = pool_blocks
        self.page_size = page_size
        self.slots = slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.sentinel = pool_blocks
        self.free_blocks = list(range(pool_blocks - 1, -1, -1))
        self.tables = np.full((slots, max_blocks_per_seq), self.sentinel,
                              np.int32)
        self.n_blocks = np.zeros((slots,), np.int32)
        self.evictions = 0        # slots freed by preemption

    @property
    def used_blocks(self) -> int:
        return self.pool_blocks - len(self.free_blocks)

    def can_admit(self, n_tokens: int) -> bool:
        """Would a fresh slot fit ``n_tokens``?"""
        return blocks_for(n_tokens, self.page_size) <= len(self.free_blocks)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens`` tokens; all or
        nothing (False allocates nothing)."""
        want = blocks_for(n_tokens, self.page_size)
        if want > self.max_blocks_per_seq:
            raise ValueError(f"{n_tokens} tokens need {want} blocks, more "
                             f"than a table holds ({self.max_blocks_per_seq})")
        have = int(self.n_blocks[slot])
        need = want - have
        if need <= 0:
            return True
        if need > len(self.free_blocks):
            return False
        for i in range(have, want):
            self.tables[slot, i] = self.free_blocks.pop()
        self.n_blocks[slot] = want
        return True

    def free_slot(self, slot: int) -> int:
        """Return every block of ``slot`` to the free list; its table goes
        back to sentinels. Returns the number of blocks freed."""
        n = int(self.n_blocks[slot])
        for i in range(n):
            self.free_blocks.append(int(self.tables[slot, i]))
        self.tables[slot, :n] = self.sentinel
        self.n_blocks[slot] = 0
        return n

    def evict_slot(self, slot: int) -> int:
        """free_slot plus eviction accounting (the preemption path)."""
        self.evictions += 1
        return self.free_slot(slot)
