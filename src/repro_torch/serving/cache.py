"""KV cache bookkeeping: batch-axis helpers of the contiguous cache,
the paged pool's page table, and byte accounting.

``gather_batch`` / ``broadcast_batch`` select and replicate branch rows
of the engine loop's contiguous cache ``{"k", "v"}`` of shape (L, B, S,
KV, hd), whose batch is axis 1.

``PageAllocator`` is the host-side (numpy) page table of the shared
device page pool, with per-page reference counts for copy-on-write
sharing of the prompt pages across a request's fan-out (DESIGN.md §5).
``copy_pages`` duplicates pool pages on the device (the COW boundary
copy at chunked-prefill finalize). The byte accounting matches the JAX
package's integer math exactly, so ``GenResult.peak_cache_bytes`` is
comparable between the two.

Bucketed compaction (DESIGN.md §2): when the live branch count falls to
the next bucket of the chain N → 2^⌈log2 N⌉-1 → … → 1, the request's rows
shrink to that bucket.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    """Total bytes held by a cache dict of tensors."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def _kv_token_bytes(cfg) -> int:
    """Bytes one (token, kv-head) K *or* V entry costs: hd values in the
    cache dtype."""
    return cfg.resolved_head_dim * _ITEMSIZE[cfg.dtype]


def used_cache_bytes(cfg, rows: int, pos: int, max_seq: int) -> int:
    """Bytes of KV actually *referenced* by ``rows`` live branch rows after
    ``pos`` positions — the static-shape analogue of the paper's dynamically
    grown PyTorch KV tensors, used for the M_cost metric."""
    n_global = sum(1 for bt in cfg.block_types() if bt == "global")
    return int(n_global * rows * min(pos, max_seq) * cfg.num_kv_heads * 2
               * _kv_token_bytes(cfg))


def per_request_bytes(cfg, rows_pos: Dict[Any, tuple], max_seq: int
                      ) -> Dict[Any, int]:
    """``rows_pos`` maps request id -> (occupied rows, current pos)."""
    return {rid: used_cache_bytes(cfg, r, p, max_seq)
            for rid, (r, p) in rows_pos.items()}


def page_bytes(cfg, page_size: int) -> int:
    """Bytes one physical page holds across every global-attention layer
    (K + V) — the unit of the paged allocator's byte accounting."""
    n_global = sum(1 for bt in cfg.block_types() if bt == "global")
    return n_global * page_size * cfg.num_kv_heads * 2 * _kv_token_bytes(cfg)


def copy_pages(pool: Dict[str, torch.Tensor], src_pages, dst_pages) -> None:
    """In-place device page copy in every layer of the paged pool:
    ``dst_pages[i] <- src_pages[i]``."""
    src = torch.as_tensor(src_pages, dtype=torch.long)
    dst = torch.as_tensor(dst_pages, dtype=torch.long)
    for t in pool.values():
        s, d = src.to(t.device), dst.to(t.device)
        t[:, d] = t[:, s]


def gather_batch(cache: Dict[str, torch.Tensor], idx) -> Dict[str, torch.Tensor]:
    """Select branch rows ``idx`` (a sequence of row indices) from every
    cache tensor: a new, smaller cache (bucketed compaction)."""
    return {key: t[:, torch.as_tensor(idx, dtype=torch.long, device=t.device)]
            for key, t in cache.items()}


def broadcast_batch(cache: Dict[str, torch.Tensor], n: int
                    ) -> Dict[str, torch.Tensor]:
    """Replicate a batch-1 cache to ``n`` branch rows (post-prefill
    fan-out). The rows are copies: decode writes each one in place."""
    return {key: t.repeat(1, n, *([1] * (t.dim() - 2)))
            for key, t in cache.items()}


def bucket_chain(n: int) -> List[int]:
    """Descending bucket sizes: n, then powers of two below n, down to 1."""
    out = [n]
    b = 1
    while b < n:
        b <<= 1
    b >>= 1
    while b >= 1:
        if b < n:
            out.append(b)
        b >>= 1
    return out


def next_bucket(chain: List[int], alive: int, current: int) -> int:
    """Smallest bucket in the chain that still fits ``alive`` branches and
    is smaller than ``current`` (or ``current`` if no shrink is possible)."""
    best = current
    for b in chain:
        if b < best and b >= alive:
            best = b
    return best


class PageAllocator:
    """Host-side page bookkeeping for the shared device page pool, with
    per-page reference counts for copy-on-write prompt sharing.

    ``num_pages`` allocatable physical pages of ``page_size`` token slots;
    physical index ``num_pages`` is the shared *trash* page. Block tables
    are (rows, max_pages) int32: owned logical pages map to real physical
    pages, everything else aliases the trash page, so attention validity
    stays purely positional (kv_pos <= pos). ``ref`` counts the block
    tables referencing each page; a page returns to the free heap when its
    last reference drops. The free list is a min-heap, so allocation hands
    out the smallest free id and placement is a deterministic function of
    the alloc/free history."""

    def __init__(self, num_pages: int, page_size: int, rows: int,
                 max_pages: int):
        if num_pages < 1:
            raise ValueError("need at least one allocatable page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.trash = num_pages
        self.rows = rows
        self.max_pages = max_pages
        self.free_pages: List[int] = list(range(num_pages))  # min-heap
        self.block = np.full((rows, max_pages), self.trash, np.int32)
        self.owned = np.zeros((rows,), np.int32)   # block-table entries/row
        self.ref = np.zeros((num_pages,), np.int32)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions of one row."""
        return -(-int(n_tokens) // self.page_size)

    @property
    def free_count(self) -> int:
        return len(self.free_pages)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self.free_pages)

    def can_alloc(self, n_pages: int) -> bool:
        return len(self.free_pages) >= n_pages

    def row_pages(self, row: int) -> np.ndarray:
        """Physical pages referenced by ``row``'s block table."""
        return self.block[row, :int(self.owned[row])]

    def alloc_pages(self, n_pages: int) -> List[int]:
        """Pop ``n_pages`` free pages (smallest ids first); unreferenced
        until installed into a block table via :meth:`set_row_pages`."""
        if not self.can_alloc(n_pages):
            raise ValueError(f"out of pages: need {n_pages}, "
                             f"free {len(self.free_pages)}")
        return [heapq.heappop(self.free_pages) for _ in range(n_pages)]

    def set_row_pages(self, row: int, pages: Sequence[int]) -> None:
        """Install ``pages`` as ``row``'s block table (shared prompt pages
        may appear in several rows' tables; each installation takes one
        reference)."""
        if self.owned[row]:
            raise ValueError(f"row {row} already owns {self.owned[row]} pages")
        if len(pages) > self.max_pages:
            raise ValueError(f"{len(pages)} pages > max_pages={self.max_pages}")
        n = len(pages)
        self.block[row, :n] = pages
        self.block[row, n:] = self.trash
        self.owned[row] = n
        for p in pages:
            self.ref[int(p)] += 1

    def append_page(self, row: int) -> int:
        """Lazy growth: hand ``row`` one more private page."""
        n = int(self.owned[row])
        if n >= self.max_pages:
            raise ValueError(f"row {row} already at max_pages={self.max_pages}")
        p = self.alloc_pages(1)[0]
        self.block[row, n] = p
        self.owned[row] = n + 1
        self.ref[p] = 1
        return p

    def free_row(self, row: int) -> None:
        """Drop every reference ``row`` holds; pages whose last reference
        this was go back on the free heap."""
        for p in self.block[row, :int(self.owned[row])]:
            p = int(p)
            self.ref[p] -= 1
            if self.ref[p] == 0:
                heapq.heappush(self.free_pages, p)
        self.block[row] = self.trash
        self.owned[row] = 0

    def write_page(self, rows: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Physical page each of ``rows`` writes its token at ``pos`` into,
        with the COW invariant enforced: the page must be inside the row's
        owned table AND referenced by that row alone (refcount 1)."""
        rows = np.asarray(rows)
        lp = np.asarray(pos) // self.page_size
        if np.any(lp >= self.owned[rows]):
            bad = rows[lp >= self.owned[rows]]
            raise AssertionError(
                f"rows {bad.tolist()} write past their allocated pages "
                "(lazy growth missed a page-boundary crossing)")
        phys = self.block[rows, lp]
        shared = self.ref[phys] != 1
        if np.any(shared):
            raise AssertionError(
                f"COW violation: rows {rows[shared].tolist()} would write "
                f"to shared pages {phys[shared].tolist()} "
                f"(refcounts {self.ref[phys][shared].tolist()})")
        return phys.astype(np.int32)
