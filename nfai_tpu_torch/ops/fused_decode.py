"""Kernels K2 (decode attention) and K3 (per-step K/V row write).

The decode step never writes the new token's K/V before attending: K2
folds the new row in itself, and after the layer loop K3 writes every
layer's new row into the stacked merged-lane cache [L, B, S, Hkv*D] at
``starts[b]`` in one launch, in place. Counterparts of the JAX package's
`layered_decode_attention_slab` / `layered_decode_attention` and
`write_all_layers` (nfai_tpu/ops/fused_decode.py).

On CUDA tensors the wrappers launch ``csrc/decode_attention.cu`` and
``csrc/kv_write.cu`` or raise; on CPU tensors they run the plain versions.
"""
from __future__ import annotations

import torch

from ..kernels import F, I, Kernel, P, ptr, register, stream_ptr

K2 = register(Kernel(
    "decode_attention", "decode_attention.cu",
    {"nfai_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, F, P]},
))
K3 = register(Kernel(
    "kv_write", "kv_write.cu",
    {"nfai_kv_write": [P, P, P, I, I, I, I, P]},
))

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the head widths K2 is compiled for


def _check_starts(starts, b, device):
    """The kernels read starts as int32 [B]; the caller casts once per step."""
    if starts.dtype != torch.int32 or starts.shape != (b,) or not starts.is_contiguous() or starts.device != device:
        raise ValueError(f"starts must be contiguous int32 [{b}] on {device}; got {starts.dtype} "
                         f"{tuple(starts.shape)} on {starts.device}")


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, starts, scale):
    """q [B, Hq, D], k_new/v_new [B, KVD], one layer of the cache
    k_cache/v_cache [B, S, KVD], starts [B] (old tokens per row) →
    [B, Hq, D] in q's dtype; f32 math."""
    b, hq, d = q.shape
    _, s, kvd = k_cache.shape
    hkv = kvd // d
    r = hq // hkv
    qg = q.float().reshape(b, hkv, r, d) * scale
    kf = k_cache.float().reshape(b, s, hkv, d)
    vf = v_cache.float().reshape(b, s, hkv, d)
    logits = torch.einsum("bhrd,bshd->bhrs", qg, kf)
    visible = torch.arange(s, device=q.device)[None, :] < starts.to(q.device)[:, None]
    logits = logits.masked_fill(~visible[:, None, None, :], NEG_INF)
    kn = k_new.float().reshape(b, hkv, d)
    vn = v_new.float().reshape(b, hkv, d)
    s_new = torch.einsum("bhrd,bhd->bhr", qg, kn)[..., None]
    w = torch.softmax(torch.cat([logits, s_new], dim=-1), dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", w[..., :s], vf)
    out = out + w[..., s:] * vn[:, :, None, :]
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention(q, k_new, v_new, k_cache, v_cache, starts, scale=None,
                     softcap: float = 0.0, window: int = 0):
    """One layer's decode attention (see `decode_attention_plain`)."""
    b, hq, d = q.shape
    if scale is None:
        scale = 1.0 / d**0.5
    if softcap or window:
        raise NotImplementedError("attention softcap / sliding window are not ported yet")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, starts, scale)
    _, s, kvd = k_cache.shape
    hkv = kvd // d
    r = hq // hkv
    if d not in HEAD_DIMS or r not in (1, 2, 3, 4, 8) or hq != hkv * r:
        raise NotImplementedError(f"decode attention kernel takes D in {HEAD_DIMS}, r in 1/2/3/4/8; "
                                  f"got D={d}, r={r}")
    for t in (q, k_new, v_new, k_cache, v_cache):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError("decode attention needs contiguous bf16 tensors on one device (int8 KV is not ported yet)")
    if k_new.shape != (b, kvd) or v_cache.shape != k_cache.shape or k_cache.shape[0] != b:
        raise ValueError("decode attention shape mismatch")
    _check_starts(starts, b, q.device)
    out = torch.empty_like(q)
    K2.call(
        "nfai_decode_attention", ptr(q), ptr(k_new), ptr(v_new), ptr(k_cache),
        ptr(v_cache), ptr(starts), ptr(out), b, s, hkv, r, d, float(scale),
        stream_ptr(q),
    )
    K2.launches += 1
    return out


def layered_decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int,
                             starts, scale=None, softcap: float = 0.0,
                             window: int = 0):
    """`decode_attention` over layer `layer` of the stacked [L, B, S, KVD]
    cache (a view: the JAX layer index becomes a pointer offset)."""
    return decode_attention(q, k_new, v_new, k_cache[layer], v_cache[layer],
                            starts, scale, softcap, window)


def write_all_layers_plain(cache, rows, starts):
    """cache[l, b, starts[b]] = rows[l, b] in place; starts >= S dropped."""
    s = cache.shape[2]
    starts = starts.to(cache.device).long()
    keep = (starts >= 0) & (starts < s)
    bi = torch.nonzero(keep).flatten()
    cache[:, bi, starts[bi]] = rows[:, bi].to(cache.dtype)
    return cache


def write_all_layers(cache, rows, starts):
    """Write every layer's new row [L, B, KVD] into cache [L, B, S, KVD] at
    starts[b], in place; returns `cache`."""
    if cache.device.type == "cpu":
        return write_all_layers_plain(cache, rows, starts)
    l, b, s, kvd = cache.shape
    if rows.shape != (l, b, kvd) or rows.dtype != cache.dtype:
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype} do not match cache {tuple(cache.shape)} {cache.dtype}")
    row_bytes = kvd * cache.element_size()
    if row_bytes % 16 or not cache.is_contiguous() or not rows.is_contiguous():
        raise ValueError("kv_write needs contiguous tensors and rows of a multiple of 16 bytes")
    _check_starts(starts, b, cache.device)
    K3.call("nfai_kv_write", ptr(cache), ptr(rows), ptr(starts), l, b, s,
            row_bytes, stream_ptr(cache))
    K3.launches += 1
    return cache
