"""Paged KV-cache primitives (the contract of ``repro/kernels/paged.py``).

A paged cache is a flat pool of ``pool_tokens = pool_blocks * page_size``
physical rows shared by every sequence. Logical position ``p`` of slot
``b`` lives at row ``block_table[b, p // page_size] * page_size +
p % page_size``. Unallocated table entries hold the sentinel
``pool_blocks``, so every row derived from one is out of range: gathers
read zeros and scatters drop.

A serving tick writes at a fixed shape, with no sync, so that it can be
captured in a CUDA graph: ``scatter_index`` sends each write a scatter
drops to a scratch row past the pool's end, which lies in the pool's
storage (``zeros_with_scratch``) but in no view of it that the kernels,
the block tables or a snapshot read, and ``scatter_fixed`` writes them
all. ``scatter_rows`` keeps the reference's contract on any pool.

Quantized pools hold codes plus a parallel float32 scale pool addressed by
the same rows: ``gather_dequant_rows`` and ``quant_scatter_fixed`` are the
fixed-shape counterparts of ``repro/kernels/kvquant.py``'s
``gather_dequant_rows`` and ``quant_scatter_rows``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.numerics.quant import QuantKV, dequantize_kv, quantize_kv

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


def scatter_rows(pool: torch.Tensor, rows: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor | None = None):
    """Write ``values[i]`` into ``pool[rows[i]]`` **in place**; rows out of
    range or with ``valid[i]`` False are dropped (a negative row counts
    from the end, as in JAX). Returns ``pool``.

    The port updates the pools in place (the JAX contract returns a new
    pool) so a tick never copies the whole cache. Finding the kept writes
    syncs with the device; a serving tick writes with ``scatter_fixed``.
    """
    dst = scatter_index(rows, pool.shape[0], valid)
    src = torch.nonzero(dst < pool.shape[0]).squeeze(1)
    pool.index_copy_(0, dst[src], values[src].to(pool.dtype))
    return pool


def zeros_with_scratch(shape, scratch: int, dtype, device) -> torch.Tensor:
    """Zeros of ``shape`` whose storage runs ``scratch`` elements past the
    tensor's end: the scratch rows of ``rows_with_scratch``. The tensor is
    contiguous and no read of it sees them."""
    n = math.prod(shape)
    return torch.zeros(n + scratch, dtype=dtype, device=device)[:n].view(shape)


def rows_with_scratch(t: torch.Tensor, row_shape, extra: int) -> torch.Tensor:
    """The contiguous ``t`` as rows of ``row_shape``, followed by the
    ``extra`` scratch rows its storage holds past its end (a view; raises
    when the storage has no room for them)."""
    row_shape = tuple(row_shape)
    per = math.prod(row_shape)
    strides = tuple(math.prod(row_shape[i + 1:])
                    for i in range(len(row_shape)))
    return t.as_strided((t.numel() // per + extra,) + row_shape,
                        (per,) + strides)


def scatter_index(rows: torch.Tensor, pool_rows: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Each write's destination (int64, the shape of ``rows``): its row
    where ``scatter_rows`` keeps it (a negative row counting from the end),
    else ``pool_rows``, the scratch row. Computed on the device, no sync."""
    rows = rows.to(torch.int64)
    rows = torch.where((rows < 0) & (rows >= -pool_rows), rows + pool_rows,
                       rows)
    keep = (rows >= 0) & (rows < pool_rows)
    if valid is not None:
        keep = keep & valid
    return torch.where(keep, rows, pool_rows)


def scatter_fixed(pool: torch.Tensor, index: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``scatter_rows`` at a fixed shape: ``values[i]`` into row
    ``index[i]`` (``scatter_index``) of ``pool`` and its scratch row, **in
    place**. Only the scratch row can take two writes, and no read sees it,
    so the rows of ``pool`` are exactly ``scatter_rows``'s. Returns
    ``pool``."""
    rows_with_scratch(pool, pool.shape[1:], 1).index_copy_(
        0, index, values.to(pool.dtype))
    return pool


def gather_dequant_rows(code_pool: torch.Tensor, scale_pool: torch.Tensor,
                        rows: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Gather quantized rows through ``rows`` (B, L) and dequantize them:
    float32 (B, L, ...). Out-of-range (sentinel) rows read code 0 and
    scale 0, exactly 0.0."""
    return dequantize_kv(gather_rows(code_pool, rows),
                         gather_rows(scale_pool, rows), kv_dtype)


def gather_history(pool, rows: torch.Tensor,
                   kv_dtype: str = "fp32") -> torch.Tensor:
    """The paged history in logical order, as every gather route reads it:
    the rows ``rows`` (B, L) of a value pool (pool_tokens, Hkv, .), or of a
    ``QuantKV`` pool dequantized to float32 at ``kv_dtype``
    (``gather_dequant_rows``) -> (B, Hkv, L, .); sentinel rows read 0."""
    if isinstance(pool, QuantKV):
        out = gather_dequant_rows(pool.codes, pool.scale, rows, kv_dtype)
    else:
        out = gather_rows(pool, rows)
    return out.transpose(1, 2)


def quant_scatter_fixed(code_pool: torch.Tensor, scale_pool: torch.Tensor,
                        index: torch.Tensor, values: torch.Tensor,
                        kv_dtype: str) -> QuantKV:
    """Quantize-on-write at a fixed shape: encode the rows ``values``
    (N, ..., D) and write their codes and scales to row ``index[i]``
    (``scatter_index``) of both pools, **in place**, as ``scatter_fixed``
    does. Returns the codes and scales written."""
    q = quantize_kv(values, kv_dtype)
    scatter_fixed(code_pool, index, q.codes)
    scatter_fixed(scale_pool, index, q.scale)
    return q
