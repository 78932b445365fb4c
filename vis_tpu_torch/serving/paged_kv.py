"""Paged KV cache: a shared page pool and per-slot page tables.

Counterpart of ``vis_tpu/serving/paged_kv.py``.  One pool of fixed-size
pages, sized to the workload, holds every decode slot's KV:

  pool k/v      [layers, n_pages, page, kv_heads, head_dim]   (on the device)
  page_tables   [slots, max_pages] int32                       (on the device)

Page 0 is a reserved trash page: unmapped table entries point at it, so
every device-side lookup stays in bounds (inactive slots write their
garbage there; reads are masked by the length cursor).  Allocation is
host-side and reservation-based: a request's whole budget is reserved at
admission, so decode never runs out of pages mid-flight.  The host keeps a
mirror of the tables, so neither reserving nor building a decode chunk
reads the device.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from vis_tpu.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="PAGED_KV")


class PagedKVPool:
    """Host-managed page allocator over device-resident page buffers."""

    def __init__(self, num_layers: int, slots: int, max_len: int, kv_heads: int,
                 head_dim: int, page_size: int, pool_tokens: int,
                 dtype=torch.bfloat16, device="cpu"):
        if max_len % page_size:
            raise ValueError(
                f"kv_cache_max_tokens ({max_len}) must be a multiple of "
                f"kv_page_size ({page_size})"
            )
        self.page_size = page_size
        self.max_pages = max_len // page_size
        self.n_pages = pool_tokens // page_size + 1  # +1: trash page 0
        if self.n_pages < 2:
            raise ValueError("kv_pool_tokens must cover at least one page")
        self.device = torch.device(device)
        self._shape = (num_layers, self.n_pages, page_size, kv_heads, head_dim)
        self._dtype = dtype
        self.k = self.v = None
        self.ensure_buffers()
        self.tables_host = np.zeros((slots, self.max_pages), np.int32)
        self.page_tables = torch.zeros((slots, self.max_pages), dtype=torch.int32,
                                       device=self.device)
        self._free: List[int] = list(range(1, self.n_pages))
        self._owned: Dict[int, List[int]] = {}
        self._lock = threading.Lock()

    # -- accounting --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def memory_bytes(self) -> int:
        if self.k is None:
            return 0
        return 2 * self.k.numel() * self.k.element_size()

    # -- elastic buffers ---------------------------------------------------
    def release_buffers(self) -> None:
        """Drop the device page buffers (call only when no slot is active):
        an idle scheduler returns the pool's memory to the other engines."""
        self.k = self.v = None

    def ensure_buffers(self) -> None:
        """Re-allocate the device page buffers if released."""
        if self.k is None:
            self.k = torch.zeros(self._shape, dtype=self._dtype, device=self.device)
            self.v = torch.zeros(self._shape, dtype=self._dtype, device=self.device)

    # -- allocation --------------------------------------------------------
    def _set_row(self, slot: int, row: np.ndarray) -> None:
        """Write one page-table row to the device (the one device op of
        reserve and release; a test replaces it to inject a failure)."""
        self.page_tables[slot] = torch.from_numpy(row).to(self.device)

    def try_reserve(self, slot: int, tokens: int) -> bool:
        """Reserve pages for ``tokens`` on ``slot`` and map them in its table
        row.  Returns False with no side effects when the pool cannot: a
        budget beyond the slot's window (max_pages * page_size) is refused,
        not clamped, since a clamped reservation would let a chunk's
        overhang writes wrap into live KV.  A slot that already owns pages
        has them returned first (re-reserve replaces), and a device failure
        while writing the row rolls the host bookkeeping back."""
        need = self.pages_for(tokens)
        if need > self.max_pages:
            return False
        with self._lock:
            free_before = list(self._free)
            prev = self._owned.pop(slot, [])
            self._free.extend(prev)
            ok = need <= len(self._free)
            if ok:
                pages = [self._free.pop() for _ in range(need)]
                row = np.zeros((self.max_pages,), np.int32)  # unmapped -> trash
                row[:need] = pages
                try:
                    self._set_row(slot, row)
                except Exception:
                    ok = False
                    logger.exception(
                        f"page-table update failed reserving slot {slot}; "
                        "reservation rolled back"
                    )
            if not ok:  # the old mapping and free list stand as they were
                self._free = free_before
                if prev:
                    self._owned[slot] = prev
                return False
            self._owned[slot] = pages
            self.tables_host[slot] = row
        return True

    def release(self, slot: int) -> None:
        """Return a slot's pages to the pool and point its table at trash.
        The host free list is updated even when the device row cannot be
        cleared: the slot is inactive, and the next reserve rewrites the
        whole row before any decode reads it."""
        with self._lock:
            pages = self._owned.pop(slot, [])
            self._free.extend(pages)
            if pages:
                self.tables_host[slot] = 0
                try:
                    self._set_row(slot, self.tables_host[slot])
                except Exception:
                    logger.exception(
                        f"page-table clear failed releasing slot {slot}; "
                        "host free-list updated, device row left stale"
                    )


__all__ = ["PagedKVPool"]
