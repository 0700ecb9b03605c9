"""Kernels K2 (decode attention), K3 (per-step K/V row write) and K10 (the
int8 cache's per-step scale write).

The decode step never writes the new token's K/V before attending: K2
folds the new row in itself, and after the layer loop the K/V store
(ops.kv_store) writes every layer's new K and V rows into the stacked
merged-lane cache [L, B, S, Hkv*D] at ``starts[b]`` in one launch, in
place. Counterparts of the JAX package's `layered_decode_attention_slab` /
`layered_decode_attention`, `write_all_layers` and `write_all_layers_t`
(nfai_tpu/ops/fused_decode.py). `write_all_layers` (K3) and
`write_all_layers_t` (K10) keep the JAX functions' contracts, one array a
call; on the card they launch the store's device body in its copy mode
(``csrc/kv_write.cu``). The main path stores through `ops.kv_store`, which
computes both (and the quantization before them) in one launch.

The int8 cache (``EngineConfig.kv_dtype="int8"``) stores int8 codes in the
same [L, B, S, Hkv*D] layout and per-(token, kv head) f32 scales time-minor,
[L, B, Hkv, S]. K2 then reads the codes and applies the scales
(``k_scales``/``v_scales``, one layer's [B, Hkv, S] view) through its own
entry point and launch counter (``decode_attention_i8``); the new token is
still folded in at full precision. K3 copies int8 code rows as bytes, and
K10 (``kv_write_t``) writes scales at ``starts[b]``.

Gemma's attention options ride the same entry points: ``softcap`` (the
score becomes softcap * tanh(score / softcap) after the scale and the k
scale, the new token's too) and ``window`` (a sliding window: the old keys
s > starts[b] - window and the new token stay visible; 0 = unlimited), as
the JAX kernels apply them. Head widths 64, 96, 128 and 256; GQA ratios
r = Hq / Hkv of 1 to 16.

On CUDA tensors the wrappers launch ``csrc/decode_attention.cu`` and
``csrc/kv_write.cu`` or raise; on CPU tensors they run the plain versions.
"""
from __future__ import annotations

import functools

import torch

from ..kernels import F, I, Kernel, P, ptr, register, stream_ptr

K2 = register(Kernel(
    "decode_attention", "decode_attention.cu",
    {"nfai_decode_attention": [P, P, P, P, P, P, P, I, I, I, I, I, F, F, I, I, P]},
))
K2_I8 = register(Kernel(
    "decode_attention_i8", "decode_attention.cu",
    {"nfai_decode_attention_i8": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, F, I, I, P]},
))
K3 = register(Kernel(
    "kv_write", "kv_write.cu",
    {"nfai_kv_write": [P, P, P, I, I, I, I, P]},
))
K10 = register(Kernel(
    "kv_write_t", "kv_write.cu",
    {"nfai_kv_write_t": [P, P, P, I, I, I, I, P]},
))

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128, 256)  # the head widths K2 is compiled for
MAX_GQA = 16  # query heads a kv head K2 and K7 take (two groups of 8 head columns)
SPLIT_KEYS = 64  # keys a tile of K2/K7 (csrc/decode_attn.cuh's DA_KEYS)
# blocks a cluster at most: 16 (non-portable) measured slower than 8 at every
# narrow grid (tests/torch_decode_split_probe.py: 1.3-1.5x at B * Hkv = 8)
MAX_SPLIT = 8
LONG_SHARE = 1024  # keys of the capacity each block keeps where the blocks pass one wave


def decode_split(b: int, hkv: int, capacity: int, sms: int, head_dim: int) -> int:
    """The blocks c (1, 2, 4 or 8, one thread-block cluster) across which K2
    and K7 split the keys of each (batch row, kv head) pair, from the grid
    alone (no length is read on the host; the capacity is S for K2,
    max_pages * page_size for K7): doubled while each block keeps at least
    one 64-key tile of the capacity and the b * hkv * c blocks stay within
    sms * 128 / head_dim (two waves at head_dim 64, whose blocks sit two to
    an SM; one at 128; half a wave at 256, whose blocks fill an SM's shared
    memory: 128 of them streamed 7-14% slower than 64), past one wave only
    while each block keeps LONG_SHARE keys (each choice measured by
    tests/torch_decode_split_probe.py). 8 at b * hkv = 8; 4 at 32 (2 at
    head_dim 256); 2 at 64 (4 from 4096 slots at head_dim 64); 1 from 67
    pairs at head_dim 128."""
    limit = sms * 128 // head_dim
    c = 1
    while c < MAX_SPLIT and capacity >= 2 * c * SPLIT_KEYS:
        blocks = b * hkv * 2 * c
        if blocks > limit or (blocks > sms and capacity < 2 * c * LONG_SHARE):
            break
        c *= 2
    return c


def decode_share(lo: int, hi: int, c: int, rank: int) -> range:
    """The 64-key tiles block `rank` of `c` reads of the visible keys
    [lo, hi): the range's tiles cut into c nearly equal runs in rank order
    (`da_share` in csrc/decode_attn.cuh is the same rule); empty where the
    range has fewer tiles than blocks."""
    t_lo = lo // SPLIT_KEYS
    n = max(-(-hi // SPLIT_KEYS) - t_lo, 0)
    return range(t_lo + rank * n // c, t_lo + (rank + 1) * n // c)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def softcap_scores(logits, softcap: float):
    """gemma2's score cap, softcap * tanh(logits / softcap) (the JAX form:
    a multiply by the reciprocal); 0 leaves the scores as they are."""
    return softcap * torch.tanh(logits * (1.0 / softcap)) if softcap else logits


def variant(d: int, softcap: float, window: int) -> str:
    """The label an attention launch is tallied under (`Kernel.variants`)."""
    return f"D={d}" + (" softcap" if softcap else "") + (" window" if window else "")


def check_options(softcap, window) -> None:
    if softcap < 0 or window < 0 or int(window) != window:
        raise ValueError(f"softcap must be >= 0 and window a non-negative int; got {softcap}, {window}")


def _check_starts(starts, b, device):
    """The kernels read starts as int32 [B]; the caller casts once per step."""
    if starts.dtype != torch.int32 or starts.shape != (b,) or not starts.is_contiguous() or starts.device != device:
        raise ValueError(f"starts must be contiguous int32 [{b}] on {device}; got {starts.dtype} "
                         f"{tuple(starts.shape)} on {starts.device}")


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, starts, scale,
                           k_scales=None, v_scales=None, softcap: float = 0.0,
                           window: int = 0):
    """q [B, Hq, D], k_new/v_new [B, KVD], one layer of the cache
    k_cache/v_cache [B, S, KVD], starts [B] (old tokens per row) →
    [B, Hq, D] in q's dtype; f32 math. With k_scales/v_scales [B, Hkv, S]
    the cache holds int8 codes: the k scale multiplies each score column
    and the v scale each softmax weight of an old token after the
    normalisation (so the denominator sums the unscaled weights); the new
    token is at full precision. `softcap` caps every score (the new token's
    too) before the mask; `window` > 0 hides the old keys s <= starts[b] -
    window."""
    b, hq, d = q.shape
    _, s, kvd = k_cache.shape
    hkv = kvd // d
    r = hq // hkv
    qg = q.float().reshape(b, hkv, r, d) * scale
    kf = k_cache.float().reshape(b, s, hkv, d)
    vf = v_cache.float().reshape(b, s, hkv, d)
    logits = torch.einsum("bhrd,bshd->bhrs", qg, kf)
    if k_scales is not None:
        logits = logits * k_scales.float()[:, :, None, :]
    logits = softcap_scores(logits, softcap)
    span = torch.arange(s, device=q.device)[None, :]
    start = starts.to(q.device).long()[:, None]
    visible = span < start
    if window:
        visible &= span > start - window
    logits = logits.masked_fill(~visible[:, None, None, :], NEG_INF)
    kn = k_new.float().reshape(b, hkv, d)
    vn = v_new.float().reshape(b, hkv, d)
    s_new = softcap_scores(torch.einsum("bhrd,bhd->bhr", qg, kn)[..., None], softcap)
    w = torch.softmax(torch.cat([logits, s_new], dim=-1), dim=-1)
    w_old = w[..., :s]
    if v_scales is not None:
        w_old = w_old * v_scales.float()[:, :, None, :]
    out = torch.einsum("bhrs,bshd->bhrd", w_old, vf)
    out = out + w[..., s:] * vn[:, :, None, :]
    return out.reshape(b, hq, d).to(q.dtype)


def check_scales(k_scales, v_scales, shape, device):
    """The int8 cache's scales as the kernels take them: contiguous f32 of
    `shape`, one layer's view (a batch lane of a layer-stacked array is
    contiguous per layer); raises otherwise."""
    for t in (k_scales, v_scales):
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != shape or \
                not t.is_contiguous() or t.device != device:
            raise ValueError(f"k_scales/v_scales must be contiguous f32 {list(shape)} on {device}")


def decode_attention(q, k_new, v_new, k_cache, v_cache, starts, scale=None,
                     softcap: float = 0.0, window: int = 0, k_scales=None,
                     v_scales=None):
    """One layer's decode attention (see `decode_attention_plain`); with
    k_scales/v_scales the cache is int8 and the int8 entry point runs."""
    b, hq, d = q.shape
    if scale is None:
        scale = 1.0 / d**0.5
    check_options(softcap, window)
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("k_scales and v_scales come together")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, starts, scale,
                                      k_scales, v_scales, softcap, window)
    _, s, kvd = k_cache.shape
    hkv = kvd // d
    r = hq // hkv
    if d not in HEAD_DIMS or not 1 <= r <= MAX_GQA or hq != hkv * r:
        raise NotImplementedError(f"decode attention kernel takes D in {HEAD_DIMS} and GQA ratios r = Hq / Hkv "
                                  f"of 1 to {MAX_GQA} (no family the port serves publishes more); "
                                  f"got D={d}, Hq={hq}, Hkv={hkv}")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    for t, dtype in ((q, torch.bfloat16), (k_new, torch.bfloat16), (v_new, torch.bfloat16),
                     (k_cache, cache_dtype), (v_cache, cache_dtype)):
        if t.dtype != dtype or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"decode attention needs contiguous bf16 q/k_new/v_new and a {cache_dtype} "
                             "cache on one device")
    if k_new.shape != (b, kvd) or v_cache.shape != k_cache.shape or k_cache.shape[0] != b:
        raise ValueError("decode attention shape mismatch")
    _check_starts(starts, b, q.device)
    out = torch.empty_like(q)
    c = decode_split(b, hkv, s, sm_count(q.device.index), d)
    if quantized:
        check_scales(k_scales, v_scales, (b, hkv, s), q.device)
        K2_I8.call(
            "nfai_decode_attention_i8", ptr(q), ptr(k_new), ptr(v_new), ptr(k_cache),
            ptr(v_cache), ptr(k_scales), ptr(v_scales), ptr(starts), ptr(out), b, s, hkv, r, d,
            float(scale), float(softcap), int(window), c, stream_ptr(q),
        )
        K2_I8.count(variant(d, softcap, window))
        return out
    K2.call(
        "nfai_decode_attention", ptr(q), ptr(k_new), ptr(v_new), ptr(k_cache),
        ptr(v_cache), ptr(starts), ptr(out), b, s, hkv, r, d, float(scale),
        float(softcap), int(window), c, stream_ptr(q),
    )
    K2.count(variant(d, softcap, window))
    return out


def layered_decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int,
                             starts, scale=None, softcap: float = 0.0,
                             window: int = 0, k_scales=None, v_scales=None):
    """`decode_attention` over layer `layer` of the stacked [L, B, S, KVD]
    cache (a view: the JAX layer index becomes a pointer offset); the int8
    cache's k_scales/v_scales are the stacked [L, B, Hkv, S] arrays."""
    layer_of = lambda t: None if t is None else t[layer]  # noqa: E731
    return decode_attention(q, k_new, v_new, k_cache[layer], v_cache[layer],
                            starts, scale, softcap, window, layer_of(k_scales),
                            layer_of(v_scales))


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
    K3.count()
    return cache


def write_all_layers_t_plain(arr, rows, starts):
    """arr[l, b, :, starts[b]] = rows[l, b] in place (the int8 cache's
    time-minor scales [L, B, H, S], rows [L, B, H]); starts outside [0, S)
    dropped: `write_all_layers_plain` on its [L, B, S, H] view."""
    write_all_layers_plain(arr.transpose(2, 3), rows, starts)
    return arr


def write_all_layers_t(arr, rows, starts):
    """Write every layer's new scales [L, B, H] into arr [L, B, H, S] at
    starts[b], in place; returns `arr`."""
    if arr.device.type == "cpu":
        return write_all_layers_t_plain(arr, rows, starts)
    l, b, h, s = arr.shape
    if rows.shape != (l, b, h) or rows.dtype != torch.float32 or arr.dtype != torch.float32:
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype} do not match f32 scales {tuple(arr.shape)} "
                         f"{arr.dtype}")
    if not arr.is_contiguous() or not rows.is_contiguous() or rows.device != arr.device:
        raise ValueError("kv_write_t needs contiguous tensors on one device")
    _check_starts(starts, b, arr.device)
    K10.call("nfai_kv_write_t", ptr(arr), ptr(rows), ptr(starts), l, b, h, s, stream_ptr(arr))
    K10.count()
    return arr
