"""K2 (decode attention), K3 (K/V row write) and K4 (flash prefill
attention): the port's plain versions against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs, in f32; and K4's
wgmma kernel's shared-memory layouts and fragments, modelled in numpy.

Tolerance: 1e-4 relative to max|want| — both sides compute in f32 and differ
only in summation order (the 2e-2 bf16 rule is not needed here).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.ops.fused_decode import (
    layered_decode_attention as jax_layered_decode_attention,
    layered_decode_attention_slab as jax_layered_decode_attention_slab,
    write_all_layers as jax_write_all_layers,
)
from nfai_tpu.ops.prefill_attention import (
    flash_prefill_attention as jax_flash_prefill_attention,
)
from nfai_tpu_torch.ops.fused_decode import (
    decode_attention, layered_decode_attention, write_all_layers,
)
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention

TOL = 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("impl", ["slab", "grid"])
def test_decode_attention_plain_vs_jax(impl):
    rng = np.random.default_rng(3)
    l, b, s, hkv, r, d = 2, 3, 256, 2, 4, 64
    hq, kvd = hkv * r, hkv * d
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, kvd)).astype(np.float32)
    vn = rng.standard_normal((b, kvd)).astype(np.float32)
    kc = rng.standard_normal((l, b, s, kvd)).astype(np.float32)
    vc = rng.standard_normal((l, b, s, kvd)).astype(np.float32)
    starts = np.array([0, 130, s - 1], np.int32)
    jfn = jax_layered_decode_attention_slab if impl == "slab" else jax_layered_decode_attention
    t = [torch.from_numpy(a) for a in (q, kn, vn, kc, vc)]
    for layer in range(l):
        want = np.asarray(jfn(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
            jnp.asarray(vc), jnp.int32(layer), jnp.asarray(starts),
            s_block=128, interpret=True,
        ))
        got = layered_decode_attention(*t, layer, torch.from_numpy(starts))
        assert got.shape == (b, hq, d)
        assert rel(got.numpy(), want) < TOL


def test_decode_attention_scale_and_unported_options():
    rng = np.random.default_rng(4)
    b, s, d = 2, 128, 64
    q = torch.from_numpy(rng.standard_normal((b, 4, d)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((b, 2 * d)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((b, s, 2 * d)).astype(np.float32))
    starts = torch.tensor([5, 100])
    a = decode_attention(q, kn, kn, kc, kc, starts, scale=0.5)
    want = np.asarray(jax_layered_decode_attention_slab(
        jnp.asarray(q.numpy()), jnp.asarray(kn.numpy()), jnp.asarray(kn.numpy()),
        jnp.asarray(kc.numpy())[None], jnp.asarray(kc.numpy())[None], jnp.int32(0),
        jnp.asarray(starts.numpy(), jnp.int32), s_block=128, interpret=True,
        scale=0.5,
    ))
    assert rel(a.numpy(), want) < TOL
    # softcap and window are ported (tests/test_torch_gemma.py holds them
    # against JAX at every width); values no kernel takes raise
    with pytest.raises(ValueError):
        decode_attention(q, kn, kn, kc, kc, starts, softcap=-30.0)
    with pytest.raises(ValueError):
        decode_attention(q, kn, kn, kc, kc, starts, window=-16)


def test_write_all_layers_plain_vs_jax():
    rng = np.random.default_rng(6)
    l, b, s, kvd = 3, 4, 64, 128
    cache = rng.standard_normal((l, b, s, kvd)).astype(np.float32)
    rows = rng.standard_normal((l, b, kvd)).astype(np.float32)
    starts = np.array([0, 17, s - 1, s], np.int32)  # the last one is dropped
    want = np.asarray(jax_write_all_layers(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(starts), interpret=True,
    ))
    got_t = torch.from_numpy(cache.copy())
    out = write_all_layers(got_t, torch.from_numpy(rows), torch.from_numpy(starts))
    assert out is got_t  # in place
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy()[:, 3], cache[:, 3])


@pytest.mark.parametrize("t,offset", [(64, 0), (64, 100), (128, 0), (128, 64)])
def test_flash_prefill_plain_vs_jax(t, offset):
    rng = np.random.default_rng(t + offset)
    b, s, hkv, r, d = 2, 256, 2, 4, 64
    hq, kvd = hkv * r, hkv * d
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvd)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvd)).astype(np.float32)
    offsets = np.array([offset, max(0, offset - 7)], np.int32)
    want = np.asarray(jax_flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(offsets),
        t_block=64, s_block=128, interpret=True, kv_layout="full",
    ))
    got = flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(offsets),
    )
    assert got.shape == (b, t, hq, d)
    assert rel(got.numpy(), want) < TOL


# K4's wgmma kernel (csrc/prefill_attention.cu), modelled in numpy: its
# shared-memory tiles under the 128-byte swizzle, the K-major (Q K^T) and
# MN-major (P V) operand descriptors, and the fragments of wgmma's
# accumulators and register A operand. Addresses are bytes; a tile is a
# flat array of 2-byte slots.


def _swz(addr):
    """The 128-byte swizzle of a 1024-byte aligned tile: the 16-byte chunk
    (address bits 4-6) XOR the 128-byte row (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _sw_off(rows, rr, c8):
    """The kernel's `sw_off`: 16-byte chunk c8 of row rr in a tile of 64-column
    sub-tiles of [rows][128 B]."""
    return (c8 >> 3) * rows * 128 + rr * 128 + (((c8 & 7) ^ (rr & 7)) << 4)


def _tile(x, conv=False):
    """x [rows, D] as the kernel lays it in shared memory: TMA's 64-column
    boxes under the 128-byte swizzle (the Q stores take `_sw_off`, asserted
    equal), or the int8 conversion's stores (codes 16p..16p+15 of a row's
    sub-tile c to its chunks 2p and 2p + 1)."""
    rows, d = x.shape
    rr, dd = np.meshgrid(np.arange(rows), np.arange(d), indexing="ij")
    tma = _swz((dd // 64) * rows * 128 + rr * 128 + (dd % 64) * 2)
    assert np.array_equal(tma, _sw_off(rows, rr, dd // 8) + (dd % 8) * 2)
    if conv:
        c, p, half = dd // 64, (dd % 64) // 16, (dd % 16) // 8
        off = c * rows * 128 + rr * 128 + (((2 * p + half) ^ (rr & 7)) << 4) + (dd % 8) * 2
    else:
        off = tma
    mem = np.full(rows * d, np.nan)
    mem[off // 2] = x
    assert not np.isnan(mem).any()  # every slot written once
    return mem


def _kmajor(mem, start, rows):
    """The [rows, 16] operand of one k16 step that a K-major descriptor under
    the 128-byte swizzle reads at `start`: 8-row groups 1024 bytes apart
    (the stride byte offset), 128-byte rows, 2 bytes an element."""
    m, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return mem[_swz(start + (m // 8) * 1024 + (m % 8) * 128 + 2 * k) // 2]


def _mnmajor(mem, start, lbo, n):
    """The [16, n] B operand (K x N) of one k16 step that an MN-major
    descriptor under the 128-byte swizzle reads at `start` (wgmma's
    transpose-B): N contiguous in 128-byte rows, 64-wide N blocks `lbo`
    bytes apart (the leading byte offset), 8-row K groups 1024 apart."""
    k, nn = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    return mem[_swz(start + (nn // 64) * lbo + (k // 8) * 1024 + (k % 8) * 128 + 2 * (nn % 64)) // 2]


def _lanes():
    tid = np.arange(128)
    lane = tid % 32
    return tid // 32, lane // 4, lane % 4  # warp, g, t


def _acc_map(n):
    """(row, col) of accumulator element j of thread tid of an m64nN
    product: [128, n / 2] each: rows 16w + g (+ 8), columns 8c + 2t (+ 1)
    for j = 4c + 2hh + e."""
    w, g, t = (x[:, None] for x in _lanes())
    j = np.arange(n // 2)[None, :]
    return 16 * w + g + 8 * ((j >> 1) & 1), 8 * (j >> 2) + 2 * t + (j & 1)


def _a_map(step):
    """(row, k) of the register A operand of k16 step `step`: [128, 4 regs,
    2 halves]: reg 0 (g, 2t + h), 1 (g + 8, 2t + h), 2 (g, 2t + 8 + h),
    3 (g + 8, 2t + 8 + h) of the warp's 16 rows."""
    w, g, t = (x[:, None, None] for x in _lanes())
    e, h = np.arange(4)[None, :, None], np.arange(2)[None, None, :]
    return 16 * w + g + 8 * (e & 1), 16 * step + 2 * t + 8 * (e >> 1) + h


@pytest.mark.parametrize("conv", [False, True], ids=["bf16 tiles", "int8 converted"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_k4_fragment_mapping(d, conv):
    """S = Q K^T from the K-major descriptors (32 bytes a k16 step inside
    the swizzle atom), S's accumulator elements (each (row, key) held once),
    P's A fragments made of the accumulator pairs (8k + 2e, 8k + 2e + 1),
    V through the MN-major descriptor (each B element is V[16 k + kk, n]),
    and the epilogue's stores and 16-byte row reads: the modelled P V
    equals the plain product. Small integers: every sum is exact."""
    rng = np.random.default_rng(d + conv)
    bs = 64  # keys a tile
    q, k, v = (rng.integers(-8, 8, (rows, d)).astype(np.float64) for rows in (64, bs, bs))
    qm, km, vm = _tile(q), _tile(k, conv), _tile(v, conv)
    s = sum(_kmajor(qm, (kk // 4) * 64 * 128 + 32 * (kk % 4), 64)
            @ _kmajor(km, (kk // 4) * bs * 128 + 32 * (kk % 4), bs).T for kk in range(d // 16))
    assert np.array_equal(s, q @ k.T)
    row, col = _acc_map(bs)
    assert np.array_equal(np.bincount((row * bs + col).ravel()), np.ones(64 * bs))
    p = np.floor(s[row, col] / 7) - 3  # the softmax: any function of each element, exact here
    p_full = np.full((64, bs), np.nan)
    p_full[row, col] = p
    a = np.full((64, bs), np.nan)
    for step in range(bs // 16):
        r_, key = _a_map(step)
        a[r_, key] = np.stack([p[:, 8 * step + 2 * e: 8 * step + 2 * e + 2] for e in range(4)], 1)
    assert np.array_equal(a, p_full)
    o = np.zeros((64, d))
    for step in range(bs // 16):
        b = _mnmajor(vm, step * 16 * 128, bs * 128, d)
        assert np.array_equal(b, v[16 * step:16 * step + 16])
        o += a[:, 16 * step:16 * step + 16] @ b
    orow, ocol = _acc_map(d)
    acc = o[orow, ocol]
    # epilogue: lane (w, g, t) stores the pair (4c + 2hh, + 1) of row 16w +
    # g + 8hh at sw_off(64, row, c) + 4t; rows are then read 16 bytes at a time
    w, g, t = (x[:, None, None] for x in _lanes())
    c, hh = np.arange(d // 8)[None, :, None], np.arange(2)[None, None, :]
    rr = 16 * w + g + 8 * hh
    slot = (_sw_off(64, rr, c) + 4 * t) // 2
    mem = np.full(64 * d, np.nan)
    pairs = acc.reshape(128, d // 8, 2, 2)  # [thread, c, hh, e]
    mem[slot], mem[slot + 1] = pairs[..., 0], pairs[..., 1]
    r8, c8 = np.meshgrid(np.arange(64), np.arange(d // 8), indexing="ij")
    out = mem[(_sw_off(64, r8, c8) // 2)[..., None] + np.arange(8)].reshape(64, d)
    assert np.array_equal(out, p_full @ v)
