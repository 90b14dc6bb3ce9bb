"""Paged KV-cache primitives for the decode engine (vLLM-style).

Each block's keys/values live in fixed-size **pages** — pools
``[num_pages, page_size, H, Dh]`` — and a sequence's cache is
addressed through its **block table** row: logical position ``j`` of
row ``b`` lives at page ``table[b, j // page_size]``, row
``j % page_size``.  Page 0 is the scratch page: dead batch slots and
padded prefill rows write there, and nothing ever reads it.

Unlike the JAX package, whose functional scatters return a new pool
(and alias it only when the caller donates the buffer), the two
scatters here write **in place** with ``index_put_`` and return the
same pool tensor.  Duplicate indices can only land on the scratch page
(the allocator gives distinct sequences distinct pages); which of the
colliding rows ``index_put_`` keeps there is unspecified, and harmless,
because the scratch page is never read.
"""

from __future__ import annotations

import torch


def scatter_kv_rows(pool: torch.Tensor, page_ids: torch.Tensor,
                    rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write one cache row per sequence into the pool, in place.
    ``pool`` [num_pages, page_size, H, Dh]; ``page_ids``/``rows`` [B]
    int; ``vals`` [B, H, Dh].  Returns ``pool``."""
    return pool.index_put_((page_ids.long(), rows.long()),
                           vals.to(pool.dtype))


def scatter_prefill_rows(pool: torch.Tensor, page_ids: torch.Tensor,
                         rows: torch.Tensor,
                         vals: torch.Tensor) -> torch.Tensor:
    """Write a whole prompt's rows at once, in place:
    ``page_ids``/``rows`` [B, P] address each prefilled position,
    ``vals`` [B, P, H, Dh].  Pad positions land on rows the decode
    overwrites before any mask exposes them, or on the scratch page.
    Returns ``pool``."""
    b, p = page_ids.shape
    return pool.index_put_(
        (page_ids.reshape(b * p).long(), rows.reshape(b * p).long()),
        vals.reshape((b * p,) + tuple(vals.shape[2:])).to(pool.dtype))


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """The batch's logical KV view: ``block_table`` [B, W] page ids ->
    [B, W*page_size, ...], where index ``j`` along the gathered axis
    is logical position ``j``.  Generic over the trailing dims."""
    b, w = block_table.shape
    ps = pool.shape[1]
    return pool[block_table.long()].reshape((b, w * ps)
                                            + tuple(pool.shape[2:]))


def length_mask(kv_width: int, pos: torch.Tensor) -> torch.Tensor:
    """``[B, kv_width]`` True where logical position ``j`` is readable
    at decode position ``pos[b]`` (attend to ``<= pos``)."""
    j = torch.arange(kv_width, device=pos.device)
    return j[None, :] <= pos[:, None]


def page_row_index(pos: torch.Tensor, block_table: torch.Tensor,
                   page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(page_ids [B], rows [B]) addressing position ``pos[b]`` of each
    sequence through its block-table row."""
    page_slot = torch.div(pos, page_size, rounding_mode="floor").long()
    page_ids = torch.gather(block_table, 1, page_slot[:, None])[:, 0]
    return page_ids, pos % page_size


def prefill_page_rows(lengths_width: int, block_table: torch.Tensor,
                      page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(page_ids [B, P], rows [B, P]) addressing positions
    ``0 .. lengths_width-1`` of every sequence (P = the bucketed prompt
    width)."""
    b = block_table.shape[0]
    j = torch.arange(lengths_width, device=block_table.device)
    slots = torch.div(j, page_size, rounding_mode="floor")
    pages = torch.gather(block_table, 1,
                         slots[None, :].expand(b, lengths_width).long())
    rows = (j % page_size)[None, :].expand(b, lengths_width)
    return pages, rows


__all__ = ["scatter_kv_rows", "scatter_prefill_rows", "gather_kv",
           "length_mask", "page_row_index", "prefill_page_rows"]
