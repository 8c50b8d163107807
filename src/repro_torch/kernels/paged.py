"""Paged KV-cache primitives (the contract of ``repro/kernels/paged.py``).

A paged cache is a flat pool of ``pool_tokens = pool_blocks * page_size``
physical rows shared by every sequence. Logical position ``p`` of slot
``b`` lives at row ``block_table[b, p // page_size] * page_size +
p % page_size``. Unallocated table entries hold the sentinel
``pool_blocks``, so every row derived from one is out of range: gathers
read zeros and scatters drop.
"""
from __future__ import annotations

import torch

# Row assigned to positions outside the block table (negative, or at/after
# max_blocks * page_size): no pool holds it, so its gathers read the fill
# value and its scatters drop, like a sentinel row.
OUT_OF_TABLE_ROW = 2**30


def slot_rows(block_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B, max_blocks) block ids -> (B, max_blocks * page_size) physical
    rows, ``rows[b, p]`` being the row of logical position p."""
    B, M = block_table.shape
    offs = torch.arange(page_size, dtype=torch.int32,
                        device=block_table.device)
    rows = block_table.to(torch.int32)[:, :, None] * page_size + offs
    return rows.reshape(B, M * page_size)


def token_rows(block_table: torch.Tensor, positions: torch.Tensor,
               page_size: int) -> torch.Tensor:
    """Physical rows of specific logical positions ((B,) or (B, C)).

    Positions outside the table span map to ``OUT_OF_TABLE_ROW``; sentinel
    entries inside the table map past the pool end.
    """
    pos = positions if positions.dim() == 2 else positions[:, None]
    pos = pos.to(torch.int64)
    M = block_table.shape[1]
    blk = torch.div(pos, page_size, rounding_mode="floor")
    in_table = (pos >= 0) & (blk < M)
    phys = torch.gather(block_table.to(torch.int64), 1, blk.clamp(0, M - 1))
    rows = phys * page_size + torch.remainder(pos, page_size)
    rows = torch.where(in_table, rows, torch.full_like(rows, OUT_OF_TABLE_ROW))
    rows = rows.to(torch.int32)
    return rows if positions.dim() == 2 else rows[:, 0]


def gather_rows(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """pool (pool_tokens, ...), rows (B, L) -> (B, L, ...); out-of-range
    rows read as zero (a negative row counts from the end, as in JAX)."""
    n = pool.shape[0]
    rows = rows.to(torch.int64)
    rows = torch.where((rows < 0) & (rows >= -n), rows + n, rows)
    ok = (rows >= 0) & (rows < n)
    out = pool[torch.where(ok, rows, torch.zeros_like(rows))]
    mask = ok.reshape(ok.shape + (1,) * (pool.dim() - 1))
    return torch.where(mask, out, torch.zeros((), dtype=pool.dtype,
                                              device=pool.device))


def scatter_plan(rows: torch.Tensor, pool_rows: int,
                 valid: torch.Tensor | None = None):
    """The (destination rows, source indices) of the writes a scatter keeps:
    rows inside ``[0, pool_rows)`` whose ``valid`` flag is set.

    Finding them syncs with the device once; every layer of a tick writes
    the same rows, so the model computes the plan once per tick. A
    negative row counts from the end, as in JAX.
    """
    rows = rows.to(torch.int64)
    rows = torch.where((rows < 0) & (rows >= -pool_rows), rows + pool_rows,
                       rows)
    keep = (rows >= 0) & (rows < pool_rows)
    if valid is not None:
        keep = keep & valid
    src = torch.nonzero(keep).squeeze(1)
    return rows[src], src


def scatter_rows(pool: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor | None = None, *, plan=None):
    """Write ``values[i]`` into ``pool[rows[i]]`` **in place**; rows out of
    range or with ``valid[i]`` False are dropped. Returns ``pool``.

    The port updates the pools in place (the JAX contract returns a new
    pool) so a tick never copies the whole cache. ``plan`` is a
    precomputed ``scatter_plan(rows, pool.shape[0], valid)``.
    """
    dst, src = plan if plan is not None else scatter_plan(
        rows, pool.shape[0], valid)
    pool.index_copy_(0, dst, values[src].to(pool.dtype))
    return pool
