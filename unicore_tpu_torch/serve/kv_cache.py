"""Paged KV cache: block-allocated pages and per-sequence page tables
(counterpart of ``unicore_tpu/serve/kv_cache.py``).

The decode plane's memory is bounded by TOKENS IN FLIGHT, not by
``max_seq_len x batch``: K and V live in two fixed pools of shape
``(num_pages, n_layers, heads, page_size, head_dim)`` on the device, and
each sequence owns just the pages its tokens have reached, handed out from
a host-side free list.  The engine gathers each batch's pages into a
contiguous ``(n_layers, B, H, L, D)`` view (L = the batch's cache-length
bucket), runs the step, and scatters the new K/V rows back.  The gathered
view is a copy and ephemeral; the pool is the single source of truth.

The sentinel page index is ``num_pages``.  The JAX package's gathers clamp
it to the last page (junk the position mask never lets through) and its
scatters drop it (``mode='drop'``); torch indexing raises on the CPU and
asserts on the card for an index out of range, so here gathers clamp the
page table and scatters drop sentinel rows before ``index_put_``.  Short
sequences in a big bucket need no per-sequence branching.

int8 KV: pools hold int8, quantized on write against STATIC per-(layer,
head, channel) scales (:func:`calibrate_kv_scales`: max-abs over a
calibration prefill / 127, ``ops/quant_matmul.quantize_to_dtype``), dequantized
inside the attention read (``ops/decode_attention.py``).

The scatters update the pool in place (the JAX package donates its pools
for the same effect) and return it.  The JAX package's ``shard_by_plan``
waits for the parallel plane.
"""

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from unicore_tpu_torch.ops.quant_matmul import INT8_QMAX, quantize_to_dtype

#: rows per page; every cache-length bucket is a page multiple
DEFAULT_PAGE_SIZE = 32


def cache_bucket_edges(
    max_seq_len: int,
    num_buckets: int,
    page_size: int = DEFAULT_PAGE_SIZE,
) -> List[int]:
    """Evenly spaced cache-length buckets covering ``max_seq_len``, every
    edge a page multiple."""
    if max_seq_len <= 0:
        raise ValueError(f"max_seq_len must be positive, got {max_seq_len}")
    top = math.ceil(max_seq_len / page_size)
    num_buckets = max(1, min(num_buckets, top))
    step = math.ceil(top / num_buckets)
    return sorted({min(step * i, top) * page_size
                   for i in range(1, num_buckets + 1)} | {top * page_size})


def bucket_for(length: int, edges) -> int:
    """Smallest edge >= length (lengths above the top edge are the
    caller's admission problem)."""
    for e in edges:
        if length <= e:
            return e
    raise ValueError(f"length {length} exceeds top cache bucket {edges[-1]}")


# ---------------------------------------------------------------------------
# pool ops
# ---------------------------------------------------------------------------

def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Contiguous per-batch cache view: ``page_table`` (B, P) page ids
    (sentinel entries clamp to the last page, junk the position mask
    kills) -> a new ``(n_layers, B, H, P*page_size, D)`` tensor."""
    table = torch.as_tensor(page_table).long().clamp(max=pool.shape[0] - 1)
    table = table.to(pool.device)
    view = pool[table]  # (B, P, nl, H, ps, D)
    b, p, nl, h, ps, d = view.shape
    return view.permute(2, 0, 3, 1, 4, 5).reshape(nl, b, h, p * ps, d)


def _scatter(pool, pages, slots, vals):
    """``pool[pages, :, :, slots, :] = vals`` with the sentinel rows
    dropped; ``vals`` is (N, nl, H, D) for N (page, slot) pairs.  Page
    tables made on the host (numpy or CPU tensors) are filtered there, so a
    scatter to the card needs no device sync."""
    pages = torch.as_tensor(pages).reshape(-1).long()
    slots = torch.as_tensor(slots).reshape(-1).long()
    keep = (pages < pool.shape[0]).nonzero()[:, 0]
    dev = pool.device
    pool[pages[keep].to(dev), :, :, slots[keep].to(dev), :] = (
        vals[keep.to(vals.device)].to(pool.dtype))
    return pool


def scatter_rows(
    pool: torch.Tensor,
    pages: torch.Tensor,
    slots: torch.Tensor,
    rows: torch.Tensor,
) -> torch.Tensor:
    """Write one decode step's new K or V row per sequence, in place:
    ``pages``/``slots`` (B,) (page id and row within the page), ``rows``
    (n_layers, B, H, D).  Sentinel pages drop."""
    return _scatter(pool, pages, slots, rows.permute(1, 0, 2, 3))


def scatter_prefill(
    pool: torch.Tensor,
    pages: torch.Tensor,
    slots: torch.Tensor,
    kv: torch.Tensor,
) -> torch.Tensor:
    """Write a whole prompt's K or V, in place: ``pages``/``slots`` (B, Lp)
    per-token page and slot, ``kv`` (n_layers, B, H, Lp, D) from the
    prefill forward.  Pad rows carry the sentinel page and drop."""
    nl, _, h, _, d = kv.shape
    return _scatter(pool, pages, slots, kv.permute(1, 3, 0, 2, 4).reshape(-1, nl, h, d))


def calibrate_kv_scales(
    k: torch.Tensor, v: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static per-(layer, head, channel) dequant scales from a calibration
    prefill's stacks (n_layers, B, H, L, D): ``max-abs / INT8_QMAX``,
    floored so dead channels stay finite.  Returns (n_layers, H, D) fp32
    each."""
    k_scale = torch.clamp(k.float().abs().amax(dim=(1, 3)), min=eps) / INT8_QMAX
    v_scale = torch.clamp(v.float().abs().amax(dim=(1, 3)), min=eps) / INT8_QMAX
    return k_scale, v_scale


def quantize_kv(kv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize a prefill K or V stack (n_layers, B, H, L, D) against
    (n_layers, H, D) scales -> int8 (decode rows quantize in the layer,
    ``modules/multihead_attention.py``)."""
    return quantize_to_dtype(kv, scale[:, None, :, None, :], INT8_QMAX, torch.int8)


# ---------------------------------------------------------------------------
# the pools and the host-side page accounting
# ---------------------------------------------------------------------------

class PagedKVCache:
    """Two device pools and a host free list.

    Page ownership is host state (the scheduler's single thread); the pools
    are device tensors the prefill and decode dispatches update in place.
    ``sentinel`` (== num_pages) marks unused page-table entries."""

    def __init__(
        self,
        num_pages: int,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        dtype=torch.float32,
        kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        device=None,
    ):
        if dtype == torch.int8 and kv_scales is None:
            raise ValueError("int8 KV pools need calibrated kv_scales")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.sentinel = self.num_pages
        self.dtype = dtype
        self.kv_scales = kv_scales
        shape = (self.num_pages, n_layers, n_heads, self.page_size, head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=device)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))

    # -- accounting --------------------------------------------------------

    def pages_for(self, length: int) -> int:
        return math.ceil(length / self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages off the free list, or None when the pool cannot cover
        them (the scheduler sheds or preempts — never a partial grant)."""
        if n > len(self._free):
            return None
        cut = len(self._free) - n
        got = self._free[cut:][::-1]
        del self._free[cut:]
        return got

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 <= p < self.num_pages):
                raise ValueError(f"freeing bogus page {p}")
        self._free.extend(pages)
        if len(self._free) > self.num_pages:
            raise RuntimeError("double-free: free list exceeds pool")

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        """Fraction of pages in use (the /stats gauge)."""
        return 1.0 - len(self._free) / max(1, self.num_pages)

    def table(self, pages: List[int], bucket: int) -> np.ndarray:
        """Fixed-width page table for a sequence in ``bucket``: its pages,
        then sentinel padding (host numpy; batches stack these)."""
        width = bucket // self.page_size
        t = np.full((width,), self.sentinel, np.int32)
        t[: len(pages)] = pages
        return t
