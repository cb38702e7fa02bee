"""Page-table utilities for paged KV pools (twin of ``repro.ops.paged``).

A physical pool ``(num_pages, page_size, Hkv, D)`` plus a per-slot page
table ``pages: int32[B, max_pages]`` (logical block ``j`` of slot ``b``
-> physical page ``pages[b, j]``; unmapped blocks hold the null page 0).
"""
from __future__ import annotations

import torch


def gather_pages(pool, pages, page_size: int):
    """Gather a paged pool into the contiguous ``(B, max_pages·page_size,
    ...)`` per-slot layout (a copy).  Unmapped blocks read the null page 0,
    whose stale contents sit past ``valid_len`` and are masked."""
    if pool.shape[1] != page_size:
        raise ValueError(f"pool page dim {pool.shape[1]} != page_size "
                         f"{page_size}")
    pages = pages.to(device=pool.device, dtype=torch.long)
    b, m = pages.shape
    flat = pool.index_select(0, pages.reshape(-1))
    return flat.reshape(b, m * page_size, *pool.shape[2:])


def scatter_chunk(pool, chunk, base_pos, pages, page_size: int):
    """Write a prefill chunk's K/V through the page table, **in place**
    (``index_put_``); returns ``pool``.

    ``chunk``: ``(B, C, ...)`` values for slot ``b``'s logical positions
    ``[base_pos[b], base_pos[b] + C)``.  Position ``p`` lands at
    ``(pages[b, p // page_size], p % page_size)``; positions at or past
    the table span (a padded chunk tail) go to the reserved null page 0,
    whose contents are never valid — so overlapping null-page writes from
    several lanes are harmless."""
    if pool.shape[1] != page_size:
        raise ValueError(f"pool page dim {pool.shape[1]} != page_size "
                         f"{page_size}")
    dev = pool.device
    pages = pages.to(device=dev, dtype=torch.long)
    base_pos = base_pos.to(device=dev, dtype=torch.long)
    b, m = pages.shape
    c = chunk.shape[1]
    pos = base_pos[:, None] + torch.arange(c, device=dev)[None]     # (B,C)
    blk = torch.clamp(pos // page_size, max=m - 1)
    page = torch.gather(pages, 1, blk)
    page = torch.where(pos < m * page_size, page, torch.zeros_like(page))
    off = pos % page_size
    pool.index_put_((page, off), chunk.to(pool.dtype))
    return pool
