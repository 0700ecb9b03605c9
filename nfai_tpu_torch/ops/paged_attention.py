"""Kernel K7: decode attention through block tables over a shared page pool.

Counterpart of the JAX package's `paged_flash_decode_attention` and its
`paged_attention_reference` (nfai_tpu/ops/paged_attention.py). Keys and
values live in one layer's pool [Hkv, P, page_size, D]; row b owns the
pages `tables[b, :]` and attends its first `lengths[b]` positions (the new
token's K/V are written before the call, unlike K2, which folds them in).

The int8 pool (``EngineConfig.kv_dtype="int8"``) holds int8 codes and
per-(token, kv head) f32 scales [Hkv, P, page_size] (``k_scales``/
``v_scales``, found through the same tables) and runs through the kernel's
int8 entry point and launch counter (``paged_attention_i8``): the k scale
multiplies each score column, the v scale each softmax weight after the
denominator is summed. Gemma's ``softcap`` (after the scale and the k
scale) and sliding ``window`` (positions lengths[b] - window <= s <
lengths[b]; 0 = unlimited) take the same entry points; head widths 64, 96,
128 and 256, GQA ratios 1 to 16 (K2's, through the body they share).

On CUDA tensors the wrapper launches ``csrc/paged_attention.cu`` or raises;
on CPU tensors it runs `paged_decode_attention_plain`.
"""
from __future__ import annotations

import torch

from ..kernels import F, I, Kernel, P, ptr, register, stream_ptr
from .fused_decode import (
    HEAD_DIMS, MAX_GQA, check_options, check_scales, decode_split, sm_count, softcap_scores, variant,
)

K7 = register(Kernel(
    "paged_attention", "paged_attention.cu",
    {"nfai_paged_attention": [P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, I, I, P]},
))
K7_I8 = register(Kernel(
    "paged_attention_i8", "paged_attention.cu",
    {"nfai_paged_attention_i8": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, I, I, P]},
))

NEG_INF = -1e30
PAGE_SIZES = (16, 32, 64, 128)


def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[Hkv, P, ps, D] + [B, NP] → [Hkv, B, NP*ps, D]: each row's pages in
    table order (a copy). Scale pages [Hkv, P, ps] give [Hkv, B, NP*ps]."""
    hkv, _, ps, *d = pages.shape
    b, n_p = tables.shape
    return pages[:, tables.long()].reshape(hkv, b, n_p * ps, *d)


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths, scale,
                                 k_scales=None, v_scales=None, softcap: float = 0.0,
                                 window: int = 0):
    """q [B, Hq, D], one layer's pool k_pages/v_pages [Hkv, P, ps, D],
    tables [B, NP], lengths [B] → [B, Hq, D] in q's dtype; f32 math: gather
    each row's pages densely, cap the scores by `softcap`, mask positions
    >= lengths[b] (and < lengths[b] - window where `window` > 0), attend.
    With k_scales/v_scales [Hkv, P, ps] the pool holds int8 codes (see the
    module doc)."""
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    r = hq // hkv
    tables = tables.to(q.device)
    kg = gather_pages(k_pages, tables).float()
    vg = gather_pages(v_pages, tables).float()
    s = kg.shape[2]
    qg = q.float().reshape(b, hkv, r, d)
    logits = torch.einsum("bhrd,hbsd->bhrs", qg, kg) * scale
    if k_scales is not None:
        logits = logits * gather_pages(k_scales, tables).float().transpose(0, 1)[:, :, None, :]
    logits = softcap_scores(logits, softcap)
    span = torch.arange(s, device=q.device)[None, :]
    length = lengths.to(q.device).long()[:, None]
    visible = span < length
    if window:
        visible &= span >= length - window
    logits = logits.masked_fill(~visible[:, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    if v_scales is not None:
        w = w * gather_pages(v_scales, tables).float().transpose(0, 1)[:, :, None, :]
    out = torch.einsum("bhrs,hbsd->bhrd", w, vg)
    return out.reshape(b, hq, d).to(q.dtype)


def _check_index(name, t, shape, device):
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous int32 {list(shape)} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, scale=None,
                           softcap: float = 0.0, window: int = 0,
                           k_scales=None, v_scales=None):
    """One layer's decode attention through block tables (see module doc):
    q [B, Hq, D], k_pages/v_pages [Hkv, P, ps, D], tables [B, NP] int32,
    lengths [B] int32 → [B, Hq, D]; an int8 pool with k_scales/v_scales
    [Hkv, P, ps]."""
    check_options(softcap, window)
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("k_scales and v_scales come together")
    b, hq, d = q.shape
    if scale is None:
        scale = 1.0 / d**0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths, scale,
                                            k_scales, v_scales, softcap, window)
    hkv, n_pages, ps, _ = k_pages.shape
    r = hq // hkv
    if d not in HEAD_DIMS or not 1 <= r <= MAX_GQA or hq != hkv * r:
        raise NotImplementedError(f"paged attention kernel takes D in {HEAD_DIMS} and GQA ratios r = Hq / Hkv "
                                  f"of 1 to {MAX_GQA} (no family the port serves publishes more); "
                                  f"got D={d}, Hq={hq}, Hkv={hkv}")
    if ps not in PAGE_SIZES:
        raise NotImplementedError(f"paged attention kernel takes page sizes {PAGE_SIZES}; got {ps}")
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    for t, dtype in ((q, torch.bfloat16), (k_pages, pool_dtype), (v_pages, pool_dtype)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"paged attention needs contiguous bf16 q and a {pool_dtype} pool on one device")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d:
        raise ValueError("paged attention shape mismatch")
    _check_index("tables", tables, (b, tables.shape[-1]), q.device)
    _check_index("lengths", lengths, (b,), q.device)
    out = torch.empty_like(q)
    max_pages = tables.shape[1]
    c = decode_split(b, hkv, max_pages * ps, sm_count(q.device.index), d)
    if quantized:
        check_scales(k_scales, v_scales, tuple(k_pages.shape[:3]), q.device)
        K7_I8.call(
            "nfai_paged_attention_i8", ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scales),
            ptr(v_scales), ptr(tables), ptr(lengths), ptr(out), b, hkv, r, n_pages, ps,
            max_pages, d, float(scale), float(softcap), int(window), c, stream_ptr(q),
        )
        K7_I8.count(variant(d, softcap, window))
        return out
    K7.call(
        "nfai_paged_attention", ptr(q), ptr(k_pages), ptr(v_pages), ptr(tables),
        ptr(lengths), ptr(out), b, hkv, r, n_pages, ps, max_pages, d,
        float(scale), float(softcap), int(window), c, stream_ptr(q),
    )
    K7.count(variant(d, softcap, window))
    return out
