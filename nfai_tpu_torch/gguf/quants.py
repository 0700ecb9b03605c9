"""Vectorized numpy codecs for the GGML block formats the port loads.

Decoders follow the ggml dequantization semantics exactly (per-block scales,
nibble packing, 6-bit K-quant scale unpacking). The port reads every kind
the JAX package reads (`DEQUANTIZERS`: F32, F16, BF16, F64, I8-I64, Q4_0,
Q4_1, Q5_0, Q5_1, Q8_0, Q8_1, Q2_K-Q6_K, Q8_K, IQ4_NL, IQ4_XS); every other
kind raises NotImplementedError. It writes F32, F16, BF16 (rounded to
nearest even), Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 and the k-quants Q2_K-Q6_K:
every kind the JAX package writes, and BF16.

Encoders exist so tests and tools can fabricate valid GGUF files; they produce
bit-valid blocks (round-trip decode matches within quantization error) but use
simple scale selection rather than ggml's error-minimizing search. Decoding is
the fidelity-critical direction and is exact.

All decoders take a flat uint8 byte array and an element count, returning
float32. All encoders take float32 and return the packed uint8 byte array.
"""
from __future__ import annotations

import numpy as np

from .constants import GGML_BLOCK_LAYOUT, GGMLType

# ---------------------------------------------------------------------------
# helpers


def _f16(u16: np.ndarray) -> np.ndarray:
    return u16.view(np.float16).astype(np.float32)


def _blocks(data: np.ndarray, n_elements: int, t: GGMLType) -> np.ndarray:
    layout = GGML_BLOCK_LAYOUT[t]
    n_blocks = n_elements // layout.block_size
    expected = n_blocks * layout.type_size
    if data.size < expected:
        raise ValueError(
            f"{t.name}: need {expected} bytes for {n_elements} elements, got {data.size}"
        )
    return data[:expected].reshape(n_blocks, layout.type_size)


def _fp16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8)


# ---------------------------------------------------------------------------
# simple formats


def dequant_f32(data: np.ndarray, n: int) -> np.ndarray:
    return data[: n * 4].view(np.float32).copy()


def dequant_f16(data: np.ndarray, n: int) -> np.ndarray:
    return data[: n * 2].view(np.float16).astype(np.float32)


def dequant_f64(data: np.ndarray, n: int) -> np.ndarray:
    return data[: n * 8].view(np.float64).astype(np.float32)


def dequant_bf16(data: np.ndarray, n: int) -> np.ndarray:
    u16 = data[: n * 2].view(np.uint16).astype(np.uint32) << 16
    return u16.view(np.float32)


def dequant_i8(data: np.ndarray, n: int) -> np.ndarray:
    return data[:n].view(np.int8).astype(np.float32)


def dequant_i16(data: np.ndarray, n: int) -> np.ndarray:
    return data[: n * 2].view(np.int16).astype(np.float32)


def dequant_i32(data: np.ndarray, n: int) -> np.ndarray:
    return data[: n * 4].view(np.int32).astype(np.float32)


def dequant_i64(data: np.ndarray, n: int) -> np.ndarray:
    return data[: n * 8].view(np.int64).astype(np.float32)


def quant_bf16(x: np.ndarray) -> np.ndarray:
    """float32 → bf16 bytes, rounded to nearest even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return rounded.view(np.uint8).reshape(-1)


# ---------------------------------------------------------------------------
# 32-element block formats


def dequant_q8_0(data: np.ndarray, n: int) -> np.ndarray:
    """Q8_0: f16 scale d + 32 int8 quants; x = d * q."""
    blocks = _blocks(data, n, GGMLType.Q8_0)
    d = _f16(blocks[:, :2].copy().view(np.uint16))  # (nb, 1)
    q = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return (d * q).reshape(-1)[:n]


def quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = (amax / 127.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(np.rint(x * inv_d), -127, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d.reshape(-1).astype(np.float32)).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequant_q4_0(data: np.ndarray, n: int) -> np.ndarray:
    """Q4_0: f16 d + 16 bytes; low nibbles = elems 0..15, high = 16..31; x = d*(q-8)."""
    blocks = _blocks(data, n, GGMLType.Q4_0)
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.float32) - 8.0
    hi = (qs >> 4).astype(np.float32) - 8.0
    out = np.concatenate([lo, hi], axis=1) * d
    return out.reshape(-1)[:n]


def quant_q4_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    # ggml picks the signed max (value with largest |x|), scale = max / -8
    idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = (maxv / -8.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint(x * inv_d[:, None] + 8.0), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def dequant_q4_1(data: np.ndarray, n: int) -> np.ndarray:
    """Q4_1: f16 d, f16 m + 16 bytes; x = d*q + m."""
    blocks = _blocks(data, n, GGMLType.Q4_1)
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    m = _f16(blocks[:, 2:4].copy().view(np.uint16))
    qs = blocks[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)[:n]


def quant_q4_1(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / 15.0).astype(np.float16).astype(np.float32)
    m = mn.astype(np.float16).astype(np.float32)
    inv_d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint((x - m[:, None]) * inv_d[:, None]), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _fp16_bytes(m).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _q5_high_bits(qh_u32: np.ndarray) -> np.ndarray:
    """Expand the per-block u32 of high bits into (nb, 32) {0,1} array."""
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh_u32[:, None] >> shifts[None, :]) & 1).astype(np.uint8)


def dequant_q5_0(data: np.ndarray, n: int) -> np.ndarray:
    """Q5_0: f16 d, u32 qh, 16 bytes; q = nibble | (bit<<4); x = d*(q-16)."""
    blocks = _blocks(data, n, GGMLType.Q5_0)
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    qh = blocks[:, 2:6].copy().view(np.uint32).reshape(-1)
    qs = blocks[:, 6:22]
    hb = _q5_high_bits(qh)
    lo = (qs & 0x0F) | (hb[:, :16] << 4)
    hi = (qs >> 4) | (hb[:, 16:] << 4)
    out = (np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0) * d
    return out.reshape(-1)[:n]


def quant_q5_0(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = (maxv / -16.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint(x * inv_d[:, None] + 16.0), 0, 31).astype(np.uint8)
    hb = (q >> 4) & 1
    shifts = np.arange(32, dtype=np.uint32)
    qh = (hb.astype(np.uint32) << shifts[None, :]).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    out = np.empty((x.shape[0], 22), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 6:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


def dequant_q5_1(data: np.ndarray, n: int) -> np.ndarray:
    """Q5_1: f16 d, f16 m, u32 qh, 16 bytes; x = d*q + m."""
    blocks = _blocks(data, n, GGMLType.Q5_1)
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    m = _f16(blocks[:, 2:4].copy().view(np.uint16))
    qh = blocks[:, 4:8].copy().view(np.uint32).reshape(-1)
    qs = blocks[:, 8:24]
    hb = _q5_high_bits(qh)
    lo = (qs & 0x0F) | (hb[:, :16] << 4)
    hi = (qs >> 4) | (hb[:, 16:] << 4)
    out = np.concatenate([lo, hi], axis=1).astype(np.float32) * d + m
    return out.reshape(-1)[:n]


def quant_q5_1(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / 31.0).astype(np.float16).astype(np.float32)
    m = mn.astype(np.float16).astype(np.float32)
    inv_d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint((x - m[:, None]) * inv_d[:, None]), 0, 31).astype(np.uint8)
    hb = (q >> 4) & 1
    shifts = np.arange(32, dtype=np.uint32)
    qh = (hb.astype(np.uint32) << shifts[None, :]).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    out = np.empty((x.shape[0], 24), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _fp16_bytes(m).reshape(-1, 2)
    out[:, 4:8] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 8:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.reshape(-1)


def dequant_q8_1(data: np.ndarray, n: int) -> np.ndarray:
    """Q8_1: f16 d, f16 s(=d*sum q) + 32 int8; x = d * q."""
    blocks = _blocks(data, n, GGMLType.Q8_1)
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    q = blocks[:, 4:36].view(np.int8).astype(np.float32)
    return (d * q).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# K-quants (256-element super-blocks)


def _unpack_kquant_scales(scales12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min arrays used by Q4_K.

    Returns (sc, m), each (nb, 8) uint8 in [0, 63].
    ggml layout (get_scale_min_k4): for j<4: sc=q[j]&63, m=q[j+4]&63;
    for j>=4: sc=(q[j+4]&0xF)|((q[j-4]>>6)<<4), m=(q[j+4]>>4)|((q[j]>>6)<<4).
    """
    q = scales12
    sc = np.empty(q.shape[:-1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = q[..., :4] & 63
    m[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0x0F) | ((q[..., 0:4] >> 6) << 4)
    m[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc, m


def _pack_kquant_scales(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of `_unpack_kquant_scales` — pack (nb,8)+(nb,8) 6-bit → (nb,12) bytes."""
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    out[..., :4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (m[..., :4] & 63) | ((m[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0x0F) | ((m[..., 4:] & 0x0F) << 4)
    return out


def dequant_q4_k(data: np.ndarray, n: int) -> np.ndarray:
    """Q4_K: f16 d, f16 dmin, 12B 6-bit scales/mins (8 sub-blocks of 32), 128B qs.

    Per 64 elements, 32 qs bytes: low nibbles = first 32 elems (scale 2j),
    high nibbles = next 32 (scale 2j+1). x = d*sc*q - dmin*m.
    """
    blocks = _blocks(data, n, GGMLType.Q4_K)
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))  # (nb,1)
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
    sc, mi = _unpack_kquant_scales(blocks[:, 4:16])  # (nb,8)
    qs = blocks[:, 16:144].reshape(nb, 4, 32)  # 4 chunks of 64 elems
    lo = (qs & 0x0F).astype(np.float32)  # (nb,4,32) sub-block 2j
    hi = (qs >> 4).astype(np.float32)  # sub-block 2j+1
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)
    scales = (d * sc.astype(np.float32))[:, :, None]  # (nb,8,1)
    mins = (dmin * mi.astype(np.float32))[:, :, None]
    out = q * scales - mins
    return out.reshape(-1)[:n]


def quant_q4_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 8, 32)
    nb = x.shape[0]
    sub_min = np.minimum(x.min(axis=2), 0.0)  # (nb,8) min clamped ≤0 so m≥0
    sub_max = x.max(axis=2)
    sub_scale = np.maximum(sub_max - sub_min, 0.0) / 15.0  # (nb,8)
    d = (sub_scale.max(axis=1) / 63.0).astype(np.float16).astype(np.float32)  # (nb,)
    dmin = ((-sub_min).max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    inv_dmin = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1.0), 0.0)
    sc = np.clip(np.rint(sub_scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    mi = np.clip(np.rint(-sub_min * inv_dmin[:, None]), 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc.astype(np.float32)  # (nb,8)
    eff_min = dmin[:, None] * mi.astype(np.float32)
    inv_es = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(np.rint((x + eff_min[:, :, None]) * inv_es[:, :, None]), 0, 15).astype(np.uint8)
    q = q.reshape(nb, 4, 2, 32)
    packed = q[:, :, 0, :] | (q[:, :, 1, :] << 4)  # (nb,4,32)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _fp16_bytes(dmin).reshape(-1, 2)
    out[:, 4:16] = _pack_kquant_scales(sc, mi)
    out[:, 16:] = packed.reshape(nb, 128)
    return out.reshape(-1)


def dequant_q5_k(data: np.ndarray, n: int) -> np.ndarray:
    """Q5_K: f16 d, f16 dmin, 12B scales, 32B qh, 128B qs; q = nib | (hbit<<4)."""
    blocks = _blocks(data, n, GGMLType.Q5_K)
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
    sc, mi = _unpack_kquant_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]  # (nb,32): bit j of qh[l] is high bit of elem (32j + l)... see below
    qs = blocks[:, 48:176].reshape(nb, 4, 32)
    # ggml: u1 = 1<<(2j), u2 = 2<<(2j) walking 64-element chunks j=0..3:
    #   elem l of sub-block 2j   gets high bit (qh[l] & u1)
    #   elem l of sub-block 2j+1 gets high bit (qh[l] & u2)
    j = np.arange(4)
    hb1 = ((qh[:, None, :] >> (2 * j)[None, :, None]) & 1).astype(np.uint8)  # (nb,4,32)
    hb2 = ((qh[:, None, :] >> (2 * j + 1)[None, :, None]) & 1).astype(np.uint8)
    lo = (qs & 0x0F) | (hb1 << 4)
    hi = (qs >> 4) | (hb2 << 4)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32).astype(np.float32)
    scales = (d * sc.astype(np.float32))[:, :, None]
    mins = (dmin * mi.astype(np.float32))[:, :, None]
    out = q * scales - mins
    return out.reshape(-1)[:n]


def quant_q5_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 8, 32)
    nb = x.shape[0]
    sub_min = np.minimum(x.min(axis=2), 0.0)
    sub_max = x.max(axis=2)
    sub_scale = np.maximum(sub_max - sub_min, 0.0) / 31.0
    d = (sub_scale.max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    dmin = ((-sub_min).max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    inv_dmin = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1.0), 0.0)
    sc = np.clip(np.rint(sub_scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    mi = np.clip(np.rint(-sub_min * inv_dmin[:, None]), 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc.astype(np.float32)
    eff_min = dmin[:, None] * mi.astype(np.float32)
    inv_es = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(np.rint((x + eff_min[:, :, None]) * inv_es[:, :, None]), 0, 31).astype(np.uint8)
    q = q.reshape(nb, 4, 2, 32)  # (nb, chunk j, lo/hi, elem l)
    qs = (q[:, :, 0, :] & 0x0F) | ((q[:, :, 1, :] & 0x0F) << 4)
    j = np.arange(4)
    qh = (((q[:, :, 0, :] >> 4) & 1).astype(np.uint32) << (2 * j)[None, :, None]) | (
        ((q[:, :, 1, :] >> 4) & 1).astype(np.uint32) << (2 * j + 1)[None, :, None]
    )
    qh = qh.sum(axis=1).astype(np.uint8)  # (nb,32) OR across chunks via sum of disjoint bits
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, :2] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _fp16_bytes(dmin).reshape(-1, 2)
    out[:, 4:16] = _pack_kquant_scales(sc, mi)
    out[:, 16:48] = qh
    out[:, 48:] = qs.reshape(nb, 128)
    return out.reshape(-1)


def dequant_q6_k(data: np.ndarray, n: int) -> np.ndarray:
    """Q6_K: 128B ql, 64B qh, 16 int8 scales (per 16 elems), f16 d; x=d*sc*(q-32)."""
    blocks = _blocks(data, n, GGMLType.Q6_K)
    nb = blocks.shape[0]
    ql = blocks[:, 0:128].reshape(nb, 2, 64)  # two 128-element halves
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)  # (nb,16)
    d = _f16(blocks[:, 208:210].copy().view(np.uint16))  # (nb,1)
    # per half: elems 0..31, 32..63, 64..95, 96..127
    q1 = (ql[:, :, :32] & 0x0F) | (((qh[:, :, :] >> 0) & 3) << 4)
    q2 = (ql[:, :, 32:] & 0x0F) | (((qh[:, :, :] >> 2) & 3) << 4)
    q3 = (ql[:, :, :32] >> 4) | (((qh[:, :, :] >> 4) & 3) << 4)
    q4 = (ql[:, :, 32:] >> 4) | (((qh[:, :, :] >> 6) & 3) << 4)
    # flat element order: e = 128*half + 32*quarter + l
    q = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, 256).astype(np.float32) - 32.0
    # element e uses scales[e // 16]
    sc_full = np.repeat(scales, 16, axis=1)  # (nb,256)
    out = d * sc_full * q
    return out.reshape(-1)[:n]


def quant_q6_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 16, 16)  # 16 groups of 16
    nb = x.shape[0]
    gmax = np.abs(x).max(axis=2)  # (nb,16)
    group_scale = gmax / 31.0  # q-32 in [-32,31] → use 31 to stay in range
    d = (group_scale.max(axis=1) / 127.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    sc = np.clip(np.rint(group_scale * inv_d[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc.astype(np.float32)  # (nb,16)
    inv_eff = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1.0), 0.0)
    q = np.clip(np.rint(x * inv_eff[:, :, None] + 32.0), 0, 63).astype(np.uint8)  # (nb,16,16)
    q = q.reshape(nb, 2, 4, 32)  # halves, quarters
    q1, q2, q3, q4 = q[:, :, 0], q[:, :, 1], q[:, :, 2], q[:, :, 3]
    ql = np.concatenate([(q1 & 0x0F) | ((q3 & 0x0F) << 4), (q2 & 0x0F) | ((q4 & 0x0F) << 4)], axis=2)
    qh = ((q1 >> 4) << 0) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = _fp16_bytes(d).reshape(-1, 2)
    return out.reshape(-1)


def dequant_q2_k(data: np.ndarray, n: int) -> np.ndarray:
    """Q2_K: 16B scales (lo4=scale, hi4=min), 64B 2-bit qs, f16 d, f16 dmin.

    x = d*(sc&0xF)*q - dmin*(sc>>4), 16 sub-blocks of 16 elements.
    qs layout: per 128-elem half, 32 bytes; elem (32*s + l) for shift s=0..3.
    """
    blocks = _blocks(data, n, GGMLType.Q2_K)
    nb = blocks.shape[0]
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80].reshape(nb, 2, 32)  # two halves, 32 bytes each
    d = _f16(blocks[:, 80:82].copy().view(np.uint16))
    dmin = _f16(blocks[:, 82:84].copy().view(np.uint16))
    shifts = np.arange(4)
    q = ((qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3).astype(np.float32)
    # q: (nb, half, shift, l) → element (128*half + 32*shift + l)
    sc = (scales & 0x0F).astype(np.float32).reshape(nb, 2, 4, 2)  # 16 scales = 2 per 32-elem row
    mi = (scales >> 4).astype(np.float32).reshape(nb, 2, 4, 2)
    sc_full = np.repeat(sc, 16, axis=3)  # (nb,2,4,32)
    mi_full = np.repeat(mi, 16, axis=3)
    out = d[:, :, None, None] * sc_full * q - dmin[:, :, None, None] * mi_full
    return out.reshape(-1)[:n]


def quant_q2_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 16, 16)
    nb = x.shape[0]
    sub_min = np.minimum(x.min(axis=2), 0.0)
    sub_max = x.max(axis=2)
    sub_scale = np.maximum(sub_max - sub_min, 0.0) / 3.0
    d = (sub_scale.max(axis=1) / 15.0).astype(np.float16).astype(np.float32)
    dmin = ((-sub_min).max(axis=1) / 15.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    inv_dmin = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1.0), 0.0)
    sc = np.clip(np.rint(sub_scale * inv_d[:, None]), 0, 15).astype(np.uint8)
    mi = np.clip(np.rint(-sub_min * inv_dmin[:, None]), 0, 15).astype(np.uint8)
    eff_scale = d[:, None] * sc.astype(np.float32)
    eff_min = dmin[:, None] * mi.astype(np.float32)
    inv_es = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(np.rint((x + eff_min[:, :, None]) * inv_es[:, :, None]), 0, 3).astype(np.uint8)
    q = q.reshape(nb, 2, 4, 32)  # (nb, half, shift, l)
    packed = (q[:, :, 0] | (q[:, :, 1] << 2) | (q[:, :, 2] << 4) | (q[:, :, 3] << 6)).reshape(nb, 64)
    out = np.empty((nb, 84), dtype=np.uint8)
    out[:, 0:16] = (sc | (mi << 4)).reshape(nb, 16)
    out[:, 16:80] = packed
    out[:, 80:82] = _fp16_bytes(d).reshape(-1, 2)
    out[:, 82:84] = _fp16_bytes(dmin).reshape(-1, 2)
    return out.reshape(-1)


def _unpack_q3k_scales(scales12: np.ndarray) -> np.ndarray:
    """Q3_K 12-byte scale unpack → (nb, 16) int8 values in [-32, 31]+32 form.

    ggml (dequantize_row_q3_K): aux words with kmask1=0x03030303, kmask2=0x0f0f0f0f.
    Returns signed scales (already -32 applied).
    """
    nb = scales12.shape[0]
    aux = scales12.copy().view(np.uint32).reshape(nb, 3)
    a0, a1, tmp = aux[:, 0], aux[:, 1], aux[:, 2]
    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    out = np.empty((nb, 4), dtype=np.uint32)
    out[:, 0] = (a0 & kmask2) | (((tmp >> 0) & kmask1) << 4)
    out[:, 1] = (a1 & kmask2) | (((tmp >> 2) & kmask1) << 4)
    out[:, 2] = ((a0 >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4)
    out[:, 3] = ((a1 >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4)
    return out.view(np.uint8).reshape(nb, 16).astype(np.int16) - 32


def dequant_q3_k(data: np.ndarray, n: int) -> np.ndarray:
    """Q3_K: 32B hmask, 64B 2-bit qs, 12B 6-bit scales, f16 d.

    x = d * sc * (q2bit - (hmask_bit ? 0 : 4)); 16 sub-blocks of 16 elements.
    """
    blocks = _blocks(data, n, GGMLType.Q3_K)
    nb = blocks.shape[0]
    hmask = blocks[:, 0:32]  # bit m of hmask[l]: elem (32*m + l)
    qs = blocks[:, 32:96].reshape(nb, 2, 32)
    scales = _unpack_q3k_scales(blocks[:, 96:108]).astype(np.float32)  # (nb,16)
    d = _f16(blocks[:, 108:110].copy().view(np.uint16))
    shifts = np.arange(4)
    q = ((qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3).astype(np.float32)
    # element index e = 128*half + 32*shift + l ; hmask bit index m = e // 32 = 4*half + shift
    m = (4 * np.arange(2)[:, None] + shifts[None, :]).reshape(1, 2, 4, 1)
    hb = ((hmask[:, None, None, :] >> m) & 1).astype(np.float32)
    q = q - (1.0 - hb) * 4.0
    sc = scales.reshape(nb, 2, 4, 2)
    sc_full = np.repeat(sc, 16, axis=3)
    out = d[:, :, None, None] * sc_full * q
    return out.reshape(-1)[:n]


def quant_q3_k(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 16, 16)
    nb = x.shape[0]
    gmax = np.abs(x).max(axis=2)
    group_scale = gmax / 4.0  # q-4 in [-4,3]
    d = (group_scale.max(axis=1) / 31.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    sc = np.clip(np.rint(group_scale * inv_d[:, None]), -32, 31).astype(np.int16)
    eff = d[:, None] * sc.astype(np.float32)
    inv_eff = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1.0), 0.0)
    q = np.clip(np.rint(x * inv_eff[:, :, None] + 4.0), 0, 7).astype(np.uint8)  # (nb,16,16)
    q = q.reshape(nb, 2, 4, 32)
    lo = q & 3
    hb = (q >> 2) & 1  # 1 ⇒ do NOT subtract 4
    packed = (lo[:, :, 0] | (lo[:, :, 1] << 2) | (lo[:, :, 2] << 4) | (lo[:, :, 3] << 6)).reshape(nb, 64)
    m = (4 * np.arange(2)[:, None] + np.arange(4)[None, :]).reshape(1, 2, 4, 1)
    hmask = (hb.astype(np.uint32) << m).sum(axis=(1, 2)).astype(np.uint8)  # (nb,32)
    # pack scales (+32 → [0,63] 6-bit) via inverse of _unpack_q3k_scales
    s6 = (sc + 32).astype(np.uint8).reshape(nb, 16).view(np.uint8)
    w = s6.copy().view(np.uint8).reshape(nb, 4, 4)  # 4 words of 4 bytes
    lo4 = w & 0x0F
    hi2 = (w >> 4) & 0x03
    aux = np.zeros((nb, 3, 4), dtype=np.uint8)
    aux[:, 0] = lo4[:, 0] | (lo4[:, 2] << 4)
    aux[:, 1] = lo4[:, 1] | (lo4[:, 3] << 4)
    aux[:, 2] = hi2[:, 0] | (hi2[:, 1] << 2) | (hi2[:, 2] << 4) | (hi2[:, 3] << 6)
    out = np.empty((nb, 110), dtype=np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = packed
    out[:, 96:108] = aux.reshape(nb, 12)
    out[:, 108:110] = _fp16_bytes(d).reshape(-1, 2)
    return out.reshape(-1)


def dequant_q8_k(data: np.ndarray, n: int) -> np.ndarray:
    """Q8_K: f32 d + 256 int8 + 16 i16 bsums; x = d * q."""
    blocks = _blocks(data, n, GGMLType.Q8_K)
    d = blocks[:, :4].copy().view(np.float32)
    q = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return (d * q).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# IQ4 non-linear formats

IQ4_NL_VALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)


def dequant_iq4_nl(data: np.ndarray, n: int) -> np.ndarray:
    """IQ4_NL: f16 d + 16B nibbles indexing a nonlinear 16-entry LUT."""
    blocks = _blocks(data, n, GGMLType.IQ4_NL)
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    qs = blocks[:, 2:18]
    lo = IQ4_NL_VALUES[qs & 0x0F]
    hi = IQ4_NL_VALUES[qs >> 4]
    out = np.concatenate([lo, hi], axis=1) * d
    return out.reshape(-1)[:n]


def dequant_iq4_xs(data: np.ndarray, n: int) -> np.ndarray:
    """IQ4_XS: f16 d, u16 scales_h, 4B scales_l, 128B qs (256-elem super-block,
    136 bytes: ggml's block_iq4_xs).

    Per 32-elem sub-block ib: ls = (scales_l nibble) | (scales_h 2 bits << 4) - 32.
    (The JAX package's copy reads scales_l as 8 bytes and qs from byte 12,
    past the block, and raises on every IQ4_XS tensor.)
    """
    blocks = _blocks(data, n, GGMLType.IQ4_XS)
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))
    scales_h = blocks[:, 2:4].copy().view(np.uint16).reshape(nb).astype(np.uint32)
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:136].reshape(nb, 8, 16)
    ib = np.arange(8)
    sl = np.where(ib % 2 == 0, scales_l[:, ib // 2] & 0x0F, scales_l[:, ib // 2] >> 4)
    sh = (scales_h[:, None] >> (2 * ib)[None, :]) & 3
    ls = (sl.astype(np.int32) | (sh.astype(np.int32) << 4)) - 32  # (nb,8)
    lo = IQ4_NL_VALUES[qs & 0x0F]  # (nb,8,16) elems 0..15 of sub-block
    hi = IQ4_NL_VALUES[qs >> 4]  # elems 16..31
    q = np.concatenate([lo, hi], axis=2)  # (nb,8,32)
    out = d[:, :, None] * ls[:, :, None].astype(np.float32) * q
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# dispatch tables

DEQUANTIZERS = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.F64: dequant_f64,
    GGMLType.BF16: dequant_bf16,
    GGMLType.I8: dequant_i8,
    GGMLType.I16: dequant_i16,
    GGMLType.I32: dequant_i32,
    GGMLType.I64: dequant_i64,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q8_1: dequant_q8_1,
    GGMLType.Q2_K: dequant_q2_k,
    GGMLType.Q3_K: dequant_q3_k,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.Q8_K: dequant_q8_k,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
}

QUANTIZERS = {
    GGMLType.BF16: quant_bf16,
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q4_1: quant_q4_1,
    GGMLType.Q5_0: quant_q5_0,
    GGMLType.Q5_1: quant_q5_1,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.Q2_K: quant_q2_k,
    GGMLType.Q3_K: quant_q3_k,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
}


def dequantize(data: np.ndarray, n_elements: int, ggml_type: GGMLType) -> np.ndarray:
    """Decode `n_elements` values of `ggml_type` from raw bytes → float32."""
    fn = DEQUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(
            f"dequantization of {ggml_type.name} is not supported (the port reads "
            "the JAX package's kinds: F32/F16/BF16/F64, I8-I64, Q4_0-Q8_1, the "
            "k-quants Q2_K-Q8_K, IQ4_NL and IQ4_XS)"
        )
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return fn(data, n_elements)


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Encode float32 values into `ggml_type` blocks → uint8 bytes."""
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8).reshape(-1)
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).view(np.uint8).reshape(-1)
    fn = QUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(
            f"quantization to {ggml_type.name} is not supported (the port writes "
            "F32, F16, BF16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 and Q2_K-Q6_K)"
        )
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    bs = GGML_BLOCK_LAYOUT[ggml_type].block_size
    if flat.size % bs != 0:
        raise ValueError(
            f"{ggml_type.name}: element count {flat.size} is not a multiple of "
            f"block size {bs}"
        )
    return fn(flat)
