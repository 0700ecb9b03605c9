"""Paged KV cache: one page pool per layer, per-slot block tables, and the
host allocator with refcounts and prompt-prefix sharing.

Counterpart of nfai_tpu/runtime/paged_cache.py. The pool replaces the dense per-slot
cache ([L, B, S, KVD], batch x max_seq reserved up front) for continuous
batching: device memory holds `n_pages` pages per layer, and each request
maps its positions onto pages through a block table. Pages are refcounted,
so requests that share a prompt prefix share its KV pages (the partial tail
page is never shared).

Device layout (`PagedKVCache`): k/v [L, Hkv, P, page_size, D], the JAX
package's layout; the int8 pool (``EngineConfig.kv_dtype="int8"``) holds
int8 codes there and per-(token, kv head) f32 scales ks/vs [L, Hkv, P,
page_size] on the same pages, so the tables and prefix sharing carry over.
The forwards store new rows through `ops.kv_store.kv_store_paged` (one
launch a layer). Its plain version runs `flat_slots` and `scatter_rows`,
as `write_paged` and `write_paged_scales` (the JAX functions'
counterparts) do. The block tables and lengths live on the host in the
scheduler and go to the device once per chunk as [B, max_pages] / [B].
Page 0 is the sink: it is never handed out, and padding lanes write there.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

PAGE_SIZE = 128


@dataclass
class PagedKVCache:
    """Device pool. k/v: [L, Hkv, P, page_size, D]; k[l] is one layer's
    [Hkv, P, page_size, D] pool, the view K7 and `write_paged` take. The
    int8 pool adds ks/vs [L, Hkv, P, page_size] f32 (None otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None

    @classmethod
    def zeros(cls, cfg, n_pages: int, page_size: int = PAGE_SIZE,
              dtype=torch.bfloat16, device="cpu", quantized: bool = False) -> "PagedKVCache":
        shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, page_size, cfg.head_dim)
        if quantized:
            zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)  # noqa: E731
            return cls(zeros(shape, torch.int8), zeros(shape, torch.int8),
                       zeros(shape[:-1], torch.float32), zeros(shape[:-1], torch.float32))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def n_pages(self) -> int:
        return self.k.shape[2]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v, self.ks, self.vs)
                   if t is not None)


class OutOfPages(RuntimeError):
    """Pool exhausted: caller should retry after requests finish."""


def _hash_ids(ids: Sequence[int]) -> bytes:
    return hashlib.blake2b(
        np.asarray(ids, np.int32).tobytes(), digest_size=16
    ).digest()


@dataclass
class PageAllocator:
    """Host-side page bookkeeping: free list, refcounts, prefix cache.

    Prefix sharing: after a prompt is prefilled, every *full* page of prompt
    KV is published under the hash of the token prefix it covers. A later
    request whose prompt starts with the same tokens adopts those pages
    (refcount bump) and prefills only the remainder.

    Published pages are kept alive by the cache even at refcount 0 (LRU
    evicted only when the pool runs dry), so popular system prompts stay
    warm between requests.
    """

    n_pages: int
    page_size: int = PAGE_SIZE
    refs: np.ndarray = field(init=False)
    _free: list[int] = field(init=False)
    # prefix-hash -> page id (one entry covers ONE page, keyed by the hash of
    # all tokens from 0 to its end); insertion order doubles as LRU
    _prefix: dict[bytes, int] = field(init=False, default_factory=dict)
    _prefix_by_page: dict[int, bytes] = field(init=False, default_factory=dict)
    hits: int = field(init=False, default=0)
    misses: int = field(init=False, default=0)

    SINK_PAGE = 0  # reserved: inactive batch lanes write here (never allocated)

    def __post_init__(self):
        self.refs = np.zeros(self.n_pages, np.int32)
        self.refs[self.SINK_PAGE] = 1
        self._free = list(range(self.n_pages - 1, 0, -1))

    # -- raw alloc/free ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free) + sum(
            1 for p in self._prefix.values() if self.refs[p] == 0
        )

    def _pop_free(self) -> int:
        if self._free:
            return self._free.pop()
        # evict the least-recently published refcount-0 cached page
        for h, p in list(self._prefix.items()):
            if self.refs[p] == 0:
                del self._prefix[h]
                del self._prefix_by_page[p]
                return p
        raise OutOfPages(f"all {self.n_pages} KV pages in use")

    def alloc(self, n: int) -> list[int]:
        if n > self.free_pages:
            raise OutOfPages(
                f"need {n} pages, only {self.free_pages} free of {self.n_pages}"
            )
        pages = [self._pop_free() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] < 0:
                raise RuntimeError(f"double free of page {p}")
            if self.refs[p] == 0 and p not in self._prefix_by_page:
                self._free.append(p)
        # refcount-0 pages still in the prefix cache stay resident (warm)

    # -- prefix sharing ------------------------------------------------------
    def lookup_prefix(self, prompt_ids: Sequence[int]) -> tuple[list[int], int]:
        """Longest shared prefix: returns (pages, n_cached_tokens). The pages
        are retained for the caller; n_cached_tokens is a multiple of
        page_size and strictly less than len(prompt_ids) (the final token
        must always be recomputed so the caller gets logits)."""
        ps = self.page_size
        usable = (max(len(prompt_ids) - 1, 0)) // ps  # full pages, last token excluded
        pages: list[int] = []
        for i in range(usable):
            h = _hash_ids(prompt_ids[: (i + 1) * ps])
            p = self._prefix.get(h)
            if p is None:
                break
            pages.append(p)
        for p in pages:
            self.refs[p] += 1
        if pages:
            self.hits += 1
        elif usable:
            self.misses += 1
        return pages, len(pages) * ps

    def publish_prefix(self, prompt_ids: Sequence[int], pages: Sequence[int]) -> None:
        """Publish the full pages covering `prompt_ids` for future sharing.
        `pages[i]` must hold KV for tokens [i*ps, (i+1)*ps)."""
        ps = self.page_size
        for i in range(len(prompt_ids) // ps):
            h = _hash_ids(prompt_ids[: (i + 1) * ps])
            if h not in self._prefix:
                p = pages[i]
                prev = self._prefix_by_page.get(p)
                if prev is not None and prev != h:
                    continue  # page already published under another prefix
                self._prefix[h] = p
                self._prefix_by_page[p] = h


def flat_slots(slot_pages: torch.Tensor, positions: torch.Tensor, page_size: int) -> torch.Tensor:
    """[B, max_pages] block tables + [B, T] positions → [B*T] row indices
    into a layer's pool flattened to [Hkv, P*page_size, D]. The same for
    every layer, so a forward computes it once."""
    positions = positions.long()
    page_idx = torch.gather(slot_pages.long(), 1, positions // page_size)
    return (page_idx * page_size + positions % page_size).reshape(-1)


def scatter_rows(pages: torch.Tensor, new: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """pages [Hkv, P, ps, D] (one layer's pool, contiguous) ← new [B, T, Hkv,
    D] at the flattened rows `flat_idx` [B*T], in place (one index_put_ on
    the [Hkv, P*ps, D] view); returns `pages`."""
    hkv, p, ps, d = pages.shape
    rows = new.to(pages.dtype).movedim(2, 0).reshape(hkv, -1, d)
    pages.view(hkv, p * ps, d)[:, flat_idx] = rows
    return pages


def write_paged(pages: torch.Tensor, new: torch.Tensor, slot_pages: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Scatter new KV rows [B, T, Hkv, D] into one layer's pool [Hkv, P, ps,
    D] through the block tables [B, max_pages] at absolute positions [B, T].

    Unlike the JAX function (an XLA scatter on a donated pool), this updates
    `pages` in place and returns it."""
    return scatter_rows(pages, new, flat_slots(slot_pages, positions, pages.shape[2]))


def write_paged_scales(spool: torch.Tensor, new: torch.Tensor, slot_pages: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """`write_paged` for the int8 pool's scale pages: new [B, T, Hkv]
    per-token scales into one layer's [Hkv, P, ps] at absolute positions
    [B, T] through the block tables (the JAX `write_paged_scales`), in
    place, as one-wide rows; returns `spool`."""
    write_paged(spool[..., None], new[..., None], slot_pages, positions)
    return spool
