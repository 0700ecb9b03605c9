"""Kernel K4: flash prefill attention over the merged-lane KV cache.

A prompt chunk of T queries at absolute positions offsets[b] + t attends
cache slots s <= its own position (the chunk's K/V are written first). The
cache arrives in its native [B, S, Hkv*D] layout — one layer's view of the
stacked cache. Counterpart of the JAX package's `flash_prefill_attention`
with kv_layout="full" (nfai_tpu/ops/prefill_attention.py). An int8 cache
comes with its per-(token, kv head) f32 scales ``k_scales``/``v_scales``
(one layer's time-minor [B, Hkv, S] view) and runs through the kernel's
int8 entry point and launch counter (``prefill_attention_i8``): the k scale
multiplies each score column and the v scale each softmax weight after the
denominator is summed, as the JAX kernel applies them. Gemma's ``softcap``
and sliding ``window`` (query t sees slots pos - window < s <= pos; 0 =
unlimited) take the same entry points; head widths 64, 96, 128 and 256
(96 in two 64-column sub-tiles, the second half used).

`kv_layout` follows the JAX function's (default "full", as the JAX
`_PREFILL_KV_LAYOUT`): "full" and "merged" take the native [B, S, Hkv*D]
cache, "headmajor" a [B, Hkv, S, D] copy the caller made (scales stay
[B, Hkv, S]). "headmajor" runs the kernel's head-major addressing through
its own entry points and counters (``prefill_attention_hm``,
``prefill_attention_hm_i8``). "merged" launches the merged-lane instance
("full"'s), tallied under a "merged ..." variant: every K4 block already
reads one kv head's D columns of each key row, the JAX merged BlockSpec's
grid; like the JAX function it refuses D % 128 != 0. Any other layout
raises, where the JAX function takes it as "headmajor".

On CUDA tensors the wrapper launches ``csrc/prefill_attention.cu`` or
raises; on CPU tensors it runs `flash_prefill_attention_plain`.
"""
from __future__ import annotations

import torch

from ..kernels import F, I, Kernel, P, ptr, register, stream_ptr
from .fused_decode import check_options, check_scales, softcap_scores, variant

K4 = register(Kernel(
    "prefill_attention", "prefill_attention.cu",
    {"nfai_prefill_attention": [P, P, P, P, P, I, I, I, I, I, I, F, F, I, P]},
))
K4_I8 = register(Kernel(
    "prefill_attention_i8", "prefill_attention.cu",
    {"nfai_prefill_attention_i8": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I, P]},
))
K4_HM = register(Kernel(
    "prefill_attention_hm", "prefill_attention.cu",
    {"nfai_prefill_attention_hm": [P, P, P, P, P, I, I, I, I, I, I, F, F, I, P]},
))
K4_HM_I8 = register(Kernel(
    "prefill_attention_hm_i8", "prefill_attention.cu",
    {"nfai_prefill_attention_hm_i8": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, F, I, P]},
))

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128, 256)  # the head widths K4 is compiled for
KV_LAYOUTS = ("full", "headmajor", "merged")


def check_layout(kv_layout: str, d: int) -> None:
    """Refuse an unknown layout, and "merged" where D % 128 != 0 (the JAX
    function's ValueError)."""
    if kv_layout not in KV_LAYOUTS:
        raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
    if kv_layout == "merged" and d % 128:
        raise ValueError(f"kv_layout='merged' needs D % 128 == 0 (lane-sliced BlockSpec), "
                         f"got D={d}; use 'full' or 'headmajor'")


def head_major(cache_l: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """One layer's merged-lane cache [B, S, Hkv*D] → a head-major copy
    [B, Hkv, S, D] (the "headmajor" caller's transpose)."""
    b, s, kvd = cache_l.shape
    return cache_l.view(b, s, n_kv_heads, kvd // n_kv_heads).transpose(1, 2).contiguous()


def flash_prefill_attention_plain(q, k_cache, v_cache, offsets, scale,
                                  k_scales=None, v_scales=None, softcap: float = 0.0,
                                  window: int = 0, kv_layout: str = "full"):
    """q [B, T, Hq, D], k_cache/v_cache [B, S, KVD] ([B, Hkv, S, D] for
    "headmajor"), offsets [B] → [B, T, Hq, D] in q's dtype; f32 math with
    the causal mask s <= pos (and s > pos - window where `window` > 0), the
    scores capped by `softcap` first. With k_scales/v_scales [B, Hkv, S] the
    cache holds int8 codes (see the module doc)."""
    b, t, hq, d = q.shape
    check_layout(kv_layout, d)
    if kv_layout == "headmajor":
        k_cache, v_cache = (c.transpose(1, 2).reshape(b, c.shape[2], -1) for c in (k_cache, v_cache))
    _, s, kvd = k_cache.shape
    hkv = kvd // d
    r = hq // hkv
    qg = q.float().reshape(b, t, hkv, r, d)
    kf = k_cache.float().reshape(b, s, hkv, d)
    vf = v_cache.float().reshape(b, s, hkv, d)
    logits = torch.einsum("bthrd,bshd->bhrts", qg, kf) * scale
    if k_scales is not None:
        logits = logits * k_scales.float()[:, :, None, None, :]
    logits = softcap_scores(logits, softcap)
    pos = offsets.to(q.device).long()[:, None] + torch.arange(t, device=q.device)[None]
    span = torch.arange(s, device=q.device)[None, None, :]
    visible = span <= pos[:, :, None]
    if window:
        visible &= span > pos[:, :, None] - window
    logits = logits.masked_fill(~visible[:, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    if v_scales is not None:
        w = w * v_scales.float()[:, :, None, None, :]
    out = torch.einsum("bhrts,bshd->bthrd", w, vf)
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_prefill_attention(q, k_cache, v_cache, offsets, scale=None,
                            softcap: float = 0.0, window: int = 0,
                            k_scales=None, v_scales=None, kv_layout: str = "full"):
    """Offset-causal GQA attention of a prefill chunk (see module doc)."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / d**0.5
    check_options(softcap, window)
    check_layout(kv_layout, d)
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("k_scales and v_scales come together")
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k_cache, v_cache, offsets, scale, k_scales, v_scales,
                                             softcap, window, kv_layout)
    hm = kv_layout == "headmajor"
    if hm:
        if k_cache.dim() != 4 or k_cache.shape[3] != d:
            raise ValueError(f"a head-major cache is [B, Hkv, S, {d}], got {tuple(k_cache.shape)}")
        _, hkv, s, _ = k_cache.shape
        kvd = hkv * d
    else:
        _, s, kvd = k_cache.shape
        hkv = kvd // d
    r = hq // hkv
    if d not in HEAD_DIMS or hq != hkv * r or not 0 < r <= 64:
        raise NotImplementedError(f"prefill attention kernel takes D in {HEAD_DIMS} and r <= 64; "
                                  f"got D={d}, r={r}")
    if s % 64:
        raise ValueError(f"cache length {s} must be a multiple of 64")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    for x, dtype in ((q, torch.bfloat16), (k_cache, cache_dtype), (v_cache, cache_dtype)):
        if x.dtype != dtype or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"prefill attention needs contiguous bf16 q and a {cache_dtype} cache "
                             "on one device")
    if k_cache.shape[0] != b or v_cache.shape != k_cache.shape:
        raise ValueError("prefill attention shape mismatch")
    if offsets.dtype != torch.int32 or offsets.shape != (b,) or not offsets.is_contiguous() or offsets.device != q.device:
        raise ValueError(f"offsets must be contiguous int32 [{b}] on {q.device}; got {offsets.dtype} "
                         f"{tuple(offsets.shape)} on {offsets.device}")
    out = torch.empty_like(q)
    label = ("merged " if kv_layout == "merged" else "") + variant(d, softcap, window)
    dims = (b, t, s, hkv, r, d, float(scale), float(softcap), int(window), stream_ptr(q))
    if quantized:
        check_scales(k_scales, v_scales, (b, hkv, s), q.device)
        kernel, symbol = (K4_HM_I8, "nfai_prefill_attention_hm_i8") if hm else (
            K4_I8, "nfai_prefill_attention_i8")
        kernel.call(symbol, ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scales), ptr(v_scales),
                    ptr(offsets), ptr(out), *dims)
    else:
        kernel, symbol = (K4_HM, "nfai_prefill_attention_hm") if hm else (K4, "nfai_prefill_attention")
        kernel.call(symbol, ptr(q), ptr(k_cache), ptr(v_cache), ptr(offsets), ptr(out), *dims)
    kernel.count(label)
    return out
