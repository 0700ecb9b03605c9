"""The K/V store: K3 and K10 redesigned as one kernel through which every new
K/V row of the main path reaches a cache (``csrc/kv_write.cu`` over the
device body of ``csrc/kv_store.cuh``).

- `kv_store` stores K and V into the layer-stacked dense cache: one launch a
  decode step for all layers (caches [L, B, S, Hkv*D], rows [L, B, Hkv*D]
  at ``starts[b]``), or one launch a layer for a prefill chunk (one layer's
  caches [B, S, Hkv*D], rows [B, T, Hkv*D] at ``starts[b] + t``).
- `kv_store_paged` stores K and V of one layer's rows [B, T, Hkv, D] into
  its page pool [Hkv, P, ps, D] through the block tables [B, max_pages] at
  ``positions`` [B, T]: one launch a layer, decode and prefill chunks alike.

On the int8 cache (k_scales / v_scales given) the store quantizes the rows in
registers as `quantize_kv` does, per (token, kv head): scale = max(amax,
1e-20) / 127 and codes clip(round(x / scale), -127, 127) with a true
division and rounding half to even, the JAX `quantize_kv`'s bits; the
scales go time-minor ([L, B, Hkv, S] dense, [Hkv, P, ps] paged). A row
whose position falls outside the cache (outside [0, S), or a page outside
[0, P), or a position past the table) is dropped.

Counterparts of the JAX package's writes: `quantize_kv` and
`write_all_layers` / `write_all_layers_t` after the decode scan
(nfai_tpu/models/llama.py:1223, nfai_tpu/ops/fused_decode.py:601, :659),
`_write_cache` at prefill (nfai_tpu/models/llama.py:945), `write_paged` and
`write_paged_scales` in the paged forward (nfai_tpu/runtime/paged_cache.py:
199, :219). The plain versions are those functions' ports: `quantize_kv`,
`write_all_layers_plain` / `write_all_layers_t_plain` (ops/fused_decode.py),
`write_cache`, and `flat_slots` / `scatter_rows` (runtime/paged_cache.py).

On CUDA tensors the wrappers launch the kernel or raise (bf16 rows, D in 64,
128, 256, 16-byte aligned rows, contiguous caches, int32 indices); on CPU
tensors they run the plain versions.
"""
from __future__ import annotations

import torch

from ..kernels import I, Kernel, P, ptr, register, stream_ptr
from ..runtime.paged_cache import flat_slots, scatter_rows
from .fused_decode import HEAD_DIMS, _check_starts, write_all_layers_plain, write_all_layers_t_plain

KV_STORE = register(Kernel(
    "kv_store", "kv_write.cu",
    {"nfai_kv_store": [P, P, P, P, P, P, I, I, I, I, I, I, P, I, I, I, I, I, I, I, P]},
))
KV_STORE_PAGED = register(Kernel(
    "kv_store_paged", "kv_write.cu",
    {"nfai_kv_store_paged": [P, P, P, P, P, P, I, I, I, I, P, P, I, I, I, I, I, I, I, I, P]},
))


def quantize_kv(x: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(..., head) int8 quantization of merged-lane K/V rows
    x [..., H*D] → (int8 [..., H*D], f32 scales [..., H]): scale =
    max(amax, 1e-20) / 127, q = clip(round(x / scale), -127, 127), round
    half to even and a true division, as the JAX `quantize_kv`."""
    lead = x.shape[:-1]
    d = x.shape[-1] // n_heads
    xh = x.reshape(*lead, n_heads, d).float()
    scale = xh.abs().amax(-1).clamp_min(1e-20) / 127.0
    q = torch.round(xh / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(*lead, n_heads * d), scale


def write_cache(cache_l: torch.Tensor, new: torch.Tensor, starts: torch.Tensor) -> None:
    """new [B, T, C] → cache_l [B, S, C] rows starts[b] .. starts[b]+T-1, in
    place (one index_put_); rows outside [0, S) are dropped."""
    b, t, _ = new.shape
    rows = starts.long().to(new.device)[:, None] + torch.arange(t, device=new.device)[None]
    keep = (rows >= 0) & (rows < cache_l.shape[1])
    bi = torch.arange(b, device=new.device)[:, None].expand(b, t)
    cache_l[bi[keep], rows[keep]] = new[keep].to(cache_l.dtype)


def _mode(quantized: bool, d: int) -> str:
    """The label a store launch is tallied under (`Kernel.variants`)."""
    return f"{'int8' if quantized else 'bf16'} D={d}"


def _check_pair(k_scales, v_scales) -> bool:
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    return k_scales is not None


def _check_rows(rows, name: str, device, d: int) -> None:
    """Source rows as the kernel reads them: bf16 on `device`, each head's D
    values contiguous, every other stride of a dimension wider than 1 a
    multiple of 8 elements (16 bytes), the start 16-byte aligned."""
    if rows.dtype != torch.bfloat16 or rows.device != device:
        raise ValueError(f"{name} must be bf16 on {device}; got {rows.dtype} on {rows.device}")
    if rows.stride(-1) != 1 or (rows.ndim == 4 and rows.stride(-2) != d and rows.shape[-2] > 1):
        raise ValueError(f"{name}: each token's heads must be contiguous; strides {rows.stride()}")
    if rows.data_ptr() % 16 or any(s % 8 for s, n in zip(rows.stride()[:-1], rows.shape) if n > 1):
        raise ValueError(f"{name} must start 16-byte aligned with strides of whole 16-byte pieces; "
                         f"strides {rows.stride()}")


def _check_cache(t, dtype, shape, device, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dtype} {list(shape)} on {device}; "
                         f"got {t.dtype} {list(t.shape)} on {t.device}")


def _check_index(t, shape, device, name: str) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be contiguous int32 {list(shape)} on {device}; got {t.dtype} "
                         f"{list(t.shape)} on {t.device}")


def kv_store_plain(k_cache, v_cache, k, v, starts, n_kv_heads: int, k_scales=None, v_scales=None) -> None:
    """`kv_store`'s plain version: a decode step (4-D caches) is
    `quantize_kv` (int8) + `write_all_layers_t_plain` +
    `write_all_layers_plain`; a prefill chunk (one layer's 3-D caches) is
    `quantize_kv` + `write_cache` on the scales' [B, S, Hkv] view and the
    rows."""
    step = k_cache.ndim == 4
    for cache, scales, rows in ((k_cache, k_scales, k), (v_cache, v_scales, v)):
        if scales is not None:
            rows, sc = quantize_kv(rows, n_kv_heads)
            if step:
                write_all_layers_t_plain(scales, sc, starts)
            else:
                write_cache(scales.transpose(1, 2), sc, starts)  # time-minor: columns
        if step:
            write_all_layers_plain(cache, rows, starts)
        else:
            write_cache(cache, rows, starts)


def kv_store(k_cache, v_cache, k, v, starts, n_kv_heads: int, k_scales=None, v_scales=None) -> None:
    """Store new K and V rows in the dense cache, in place. A decode step:
    caches [L, B, S, Hkv*D], rows [L, B, Hkv*D] at starts[b], scales [L, B,
    Hkv, S]; a prefill chunk: one layer's caches [B, S, Hkv*D], rows [B, T,
    Hkv*D] at starts[b] + t, scales [B, Hkv, S]. With k_scales/v_scales the
    caches hold int8 codes and the rows are quantized. One launch."""
    quantized = _check_pair(k_scales, v_scales)
    if k_cache.device.type == "cpu":
        return kv_store_plain(k_cache, v_cache, k, v, starts, n_kv_heads, k_scales, v_scales)
    step = k_cache.ndim == 4
    if step:
        l, b, s, kvd = k_cache.shape
        t = 1
        rows_shape = (l, b, kvd)
    else:
        l, (b, s, kvd) = 1, k_cache.shape
        t = k.shape[1]
        rows_shape = (b, t, kvd)
    hkv = n_kv_heads
    d = kvd // hkv
    if d not in HEAD_DIMS or hkv * d != kvd:
        raise NotImplementedError(f"the K/V store takes D in {HEAD_DIMS}; got Hkv={hkv}, KVD={kvd}")
    dev = k_cache.device
    cache_shape = tuple(k_cache.shape)
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check_cache(c, torch.int8 if quantized else torch.bfloat16, cache_shape, dev, name)
    if quantized:
        sshape = (l, b, hkv, s) if step else (b, hkv, s)
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check_cache(sc, torch.float32, sshape, dev, name)
    strides = []
    for name, rows in (("k", k), ("v", v)):
        if tuple(rows.shape) != rows_shape:
            raise ValueError(f"{name} must be {list(rows_shape)}; got {list(rows.shape)}")
        _check_rows(rows, name, dev, d)
        # (layer, batch row, token) strides in elements
        strides += [rows.stride(0), rows.stride(1), 0] if step else [0, rows.stride(0), rows.stride(1)]
    _check_starts(starts, b, dev)
    KV_STORE.call(
        "nfai_kv_store", ptr(k_cache), ptr(v_cache), ptr(k_scales) if quantized else None,
        ptr(v_scales) if quantized else None, ptr(k), ptr(v), *strides, ptr(starts), l, b, t, s, hkv, d,
        int(quantized), stream_ptr(k_cache),
    )
    KV_STORE.count(_mode(quantized, d))


def kv_store_paged_plain(k_pages, v_pages, k, v, tables, positions, k_scales=None, v_scales=None) -> None:
    """`kv_store_paged`'s plain version: `quantize_kv` (int8), then
    `write_paged_scales` and `write_paged` (`flat_slots` + `scatter_rows`)
    on the rows whose page lies in the pool."""
    hkv, n_pages, ps, d = k_pages.shape
    b, t = positions.shape
    pos = positions.long()
    span = tables.shape[1] * ps
    inside = (pos >= 0) & (pos < span)
    flat = flat_slots(tables, torch.where(inside, pos, 0), ps)
    keep = (inside & ((flat // ps >= 0) & (flat // ps < n_pages)).view(b, t)).reshape(-1)
    flat = flat[keep]
    for pages, scales, rows in ((k_pages, k_scales, k), (v_pages, v_scales, v)):
        rows = rows.reshape(b * t, hkv, d)[keep]
        if scales is not None:
            rows, sc = quantize_kv(rows.reshape(-1, hkv * d), hkv)
            scatter_rows(scales[..., None], sc[None, :, :, None], flat)  # one-wide rows
            rows = rows.view(-1, hkv, d)
        scatter_rows(pages, rows[None], flat)


def kv_store_paged(k_pages, v_pages, k, v, tables, positions, k_scales=None, v_scales=None) -> None:
    """Store one layer's new K and V rows [B, T, Hkv, D] into its pool
    [Hkv, P, ps, D] through the block tables [B, max_pages] at positions
    [B, T], in place; with k_scales/v_scales ([Hkv, P, ps] f32) the pool
    holds int8 codes and the rows are quantized. One launch."""
    quantized = _check_pair(k_scales, v_scales)
    if k_pages.device.type == "cpu":
        return kv_store_paged_plain(k_pages, v_pages, k, v, tables, positions, k_scales, v_scales)
    hkv, n_pages, ps, d = k_pages.shape
    b, t = positions.shape
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"the K/V store takes D in {HEAD_DIMS}; got D={d}")
    dev = k_pages.device
    for name, c in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check_cache(c, torch.int8 if quantized else torch.bfloat16, k_pages.shape, dev, name)
    if quantized:
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check_cache(sc, torch.float32, (hkv, n_pages, ps), dev, name)
    strides = []
    for name, rows in (("k", k), ("v", v)):
        if tuple(rows.shape) != (b, t, hkv, d):
            raise ValueError(f"{name} must be {[b, t, hkv, d]}; got {list(rows.shape)}")
        _check_rows(rows, name, dev, d)
        strides += [rows.stride(0), rows.stride(1)]
    _check_index(positions, (b, t), dev, "positions")
    _check_index(tables, (b, tables.shape[1]), dev, "tables")
    KV_STORE_PAGED.call(
        "nfai_kv_store_paged", ptr(k_pages), ptr(v_pages), ptr(k_scales) if quantized else None,
        ptr(v_scales) if quantized else None, ptr(k), ptr(v), *strides, ptr(tables), ptr(positions), b, t,
        hkv, d, n_pages, ps, tables.shape[1], int(quantized), stream_ptr(k_pages),
    )
    KV_STORE_PAGED.count(_mode(quantized, d))
