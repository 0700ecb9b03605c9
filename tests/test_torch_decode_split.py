"""K2 and K7's split design (csrc/decode_attn.cuh), modelled on the CPU.

- `decode_split` (the blocks a (row, kv head) pair's keys are split across,
  from the grid alone) pinned at the shapes the card runs.
- `decode_share`, the per-block share rule the kernel mirrors: for every
  length 0-4096, window 0 / 512 / 4096 and c 1-16 the blocks' tiles cover
  the keys [lo, hi) before the row's last key exactly once, K2's range (old
  keys before starts[b], the new token last) and K7's (keys before
  lengths[b] - 1, key lengths[b] - 1 last) alike.
- The split's arithmetic: per-share partials (m, l, O) from per-warp online
  softmax over 16-key slices of 64-key tiles, merged in the block and then
  across the cluster in rank order, the last key after them, computed in
  torch on the CPU in f64, equal `decode_attention_plain` /
  `paged_decode_attention_plain` within 1e-5, int8 scales, softcap and
  window included.
- The tensor-core fragments: the K tile's chunk layout and the lanes' reads
  (conflict-free), the D order of S^T = K Q^T's A and B fragments (bf16 and
  the int8 byte pairs), P^T by movmatrix, V^T by ldmatrix.trans from the
  swizzled V tile (and from an int8 tile's converted rows), and the O^T
  accumulator's (dim, head) map, all modelled in numpy on small integers so
  every sum is exact.
"""
import numpy as np
import pytest
import torch

from nfai_tpu_torch.ops.fused_decode import (
    decode_attention_plain, decode_share, decode_split,
)
from nfai_tpu_torch.ops.paged_attention import paged_decode_attention_plain

KEYS = 64  # keys a tile
WARPS = 4  # 16 keys of a tile each


# ---------------------------------------------------------------------------
# the split and the shares


@pytest.mark.parametrize("b,hkv,capacity,d,want", [
    (8, 1, 4096, 256, 8),    # Gemma-3-1B / Gemma 2B heads, batch 8, 4096 slots
    (8, 1, 1024, 256, 8),    # Gemma 2B heads at S = 1024: two tiles a block
    (8, 4, 4096, 256, 2),    # model G's heads: half a wave at head_dim 256
    (8, 4, 4096, 128, 4),    # model C's heads
    (8, 4, 1024, 128, 4),
    (8, 8, 1024, 64, 2),     # model A's (Llama-3.2-1B) heads
    (8, 8, 4096, 64, 4),     # A's long context: two waves of 1024-key shares
    (1, 8, 512, 64, 8),      # batch 1 at 512 slots: eight blocks of one tile
    (1, 1, 4096, 256, 8),
    (1, 1, 64, 64, 1),       # one tile: nothing to split
    (1, 1, 128, 64, 2),
    (16, 8, 1024, 64, 1),    # 128 pairs: one wave already, shares too short for two
    (16, 8, 4096, 64, 2),
    (66, 1, 4096, 128, 2),
    (67, 1, 4096, 128, 1),
    (34, 1, 4096, 256, 1),   # past half a wave at head_dim 256
    (4, 8, 2048, 128, 4),
])
def test_decode_split_pinned(b, hkv, capacity, d, want):
    assert decode_split(b, hkv, capacity, 132, d) == want


def test_decode_split_rule():
    """A power of two within [1, 8], within 132 * 128 / D blocks, past one
    wave only with 1024 keys a block, never more blocks than the capacity's
    tiles."""
    for bh in range(1, 300):
        for capacity in (64, 128, 512, 1000, 1024, 4096, 32768):
            for d in (64, 128, 256):
                c = decode_split(bh, 1, capacity, 132, d)
                assert c in (1, 2, 4, 8)
                assert c == 1 or (bh * c * d <= 132 * 128 and capacity >= c * KEYS)
                assert c == 1 or bh * c <= 132 or capacity >= c * 1024


def _k2_range(start, s, window):
    """K2's visible old keys (decode_attention.cu): [lo, n_old)."""
    n_old = min(max(start, 0), s)
    lo = min(max(start - window + 1, 0), n_old) if window else 0
    return lo, n_old


def _k7_range(length, cap, window):
    """K7's tiled keys (paged_attention.cu): [lo, len - 1); key len - 1 is
    merged last."""
    n = min(max(length, 0), cap)
    return (max(n - window, 0) if window else 0), max(n - 1, 0)


@pytest.mark.parametrize("window", [0, 512, 4096])
@pytest.mark.parametrize("kernel", ["K2", "K7"])
def test_shares_cover_the_visible_keys_once(kernel, window):
    for length in range(0, 4097):
        lo, hi = _k2_range(length, 4096, window) if kernel == "K2" else _k7_range(length, 4096, window)
        for c in range(1, 17):
            shares = [decode_share(lo, hi, c, rank) for rank in range(c)]
            tiles = [t for sh in shares for t in sh]
            if hi <= lo:
                assert not tiles, (length, c)
                continue
            # consecutive tiles in rank order, each once, from the one that
            # holds lo to the one that holds hi - 1: [lo, hi) exactly covered
            assert tiles == list(range(lo // KEYS, (hi - 1) // KEYS + 1)), (length, c)
            sizes = [len(sh) for sh in shares]
            assert max(sizes) - min(sizes) <= 1  # shares differ by at most one tile


# ---------------------------------------------------------------------------
# the split's arithmetic


def _softcap(x, cap):
    return cap * torch.tanh(x * (1.0 / cap)) if cap else x


def _split_attention(q, k, v, ks, vs, lo, hi, c, scale, cap, last):
    """One (row, kv head) the way the kernel computes it, in f64: q [r, D],
    k/v [n, D] the pair's key rows, ks/vs [n] (or None); per block its
    share of 64-key tiles of [lo, hi), each tile in four 16-key warp slices
    with an online softmax per warp (the k scale on the score, the v scale
    on p after the denominator), the warps merged in the block, the blocks
    in rank order, then `last` = (k, v, k scale, v scale), the row's last
    key."""
    r, d = q.shape
    parts = []
    for rank in range(c):
        warps = [(torch.full((r,), -1e30, dtype=torch.float64), torch.zeros(r, dtype=torch.float64),
                  torch.zeros(r, d, dtype=torch.float64)) for _ in range(WARPS)]
        for tile in decode_share(lo, hi, c, rank):
            for w in range(WARPS):
                keys = torch.arange(tile * KEYS + 16 * w, tile * KEYS + 16 * w + 16)
                vis = (keys >= lo) & (keys < hi)
                if not vis.any():
                    continue
                idx = keys.clamp(max=k.shape[0] - 1)
                x = q @ k[idx].T * scale
                if ks is not None:
                    x = x * ks[idx]
                x = _softcap(x, cap).masked_fill(~vis, float("-inf"))
                m_run, l_run, o = warps[w]
                m_new = torch.maximum(m_run, x.amax(-1))
                corr = torch.exp(m_run - m_new)
                p = torch.exp(x - m_new[:, None])
                l_run = l_run * corr + p.sum(-1)
                if vs is not None:
                    p = p * vs[idx]
                warps[w] = (m_new, l_run, o * corr[:, None] + p @ v[idx])
        m = torch.stack([wp[0] for wp in warps]).amax(0)
        f = [torch.exp(wp[0] - m) for wp in warps]
        parts.append((m, sum(wp[1] * fw for wp, fw in zip(warps, f)),
                      sum(wp[2] * fw[:, None] for wp, fw in zip(warps, f))))
    k_last, v_last, ks_last, vs_last = last
    s_last = _softcap(q @ k_last * scale * ks_last, cap)
    parts.append((s_last, torch.ones(r, dtype=torch.float64), (v_last * vs_last)[None, :].expand(r, d)))
    m = torch.stack([p[0] for p in parts]).amax(0)
    f = [torch.exp(p[0] - m) for p in parts]
    num = sum(p[2] * fk[:, None] for p, fk in zip(parts, f))
    den = sum(p[1] * fk for p, fk in zip(parts, f))
    return num / den.clamp_min(1e-30)[:, None]


def _codes(x):
    """int8 codes and per-row f32 scales of x [..., D] (the quantize_kv form:
    scale max|x| / 127)."""
    sc = x.abs().amax(-1).clamp_min(1e-8) / 127
    return torch.round(x / sc[..., None]).clamp(-127, 127).to(torch.int8), sc.float()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("cap,window", [(0.0, 0), (50.0, 0), (0.0, 100)])
@pytest.mark.parametrize("c", [1, 2, 4, 16])
def test_k2_split_merge_matches_plain(c, cap, window, quant):
    rng = np.random.default_rng(c + int(cap) + window + quant)
    b, s, hkv, r, d = 4, 320, 2, 3, 64
    q = torch.from_numpy(rng.standard_normal((b, hkv * r, d)) * 2)
    kc = torch.from_numpy(rng.standard_normal((b, s, hkv * d)))
    vc = torch.from_numpy(rng.standard_normal((b, s, hkv * d)))
    kn = torch.from_numpy(rng.standard_normal((b, hkv * d)))
    vn = torch.from_numpy(rng.standard_normal((b, hkv * d)))
    starts = torch.tensor([0, 65, 200, s], dtype=torch.int32)
    ks = vs = None
    if quant:
        kq, ksc = _codes(kc.view(b, s, hkv, d))
        vq, vsc = _codes(vc.view(b, s, hkv, d))
        kc, vc = kq.view(b, s, hkv * d), vq.view(b, s, hkv * d)
        ks, vs = ksc.transpose(1, 2).contiguous(), vsc.transpose(1, 2).contiguous()  # [B, Hkv, S]
    scale = d**-0.5
    want = decode_attention_plain(q.float(), kn.float(), vn.float(), kc, vc, starts, scale,
                                  ks, vs, cap, window).double()
    for bi in range(b):
        lo, hi = _k2_range(int(starts[bi]), s, window)
        for h in range(hkv):
            cols = slice(h * d, (h + 1) * d)
            got = _split_attention(
                q[bi, h * r:(h + 1) * r].double(), kc[bi, :, cols].double(), vc[bi, :, cols].double(),
                None if ks is None else ks[bi, h].double(), None if vs is None else vs[bi, h].double(),
                lo, hi, c, scale, cap, last=(kn[bi, cols].double(), vn[bi, cols].double(), 1.0, 1.0))
            ref = want[bi, h * r:(h + 1) * r]
            assert (got - ref).abs().max() / ref.abs().max() < 1e-5, (bi, h)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("cap,window", [(0.0, 0), (50.0, 0), (0.0, 100)])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("c", [1, 2, 8, 16])
def test_k7_split_merge_matches_plain(c, ps, cap, window, quant):
    rng = np.random.default_rng(100 + c + ps + int(cap) + window + quant)
    b, hkv, r, d, n_p = 4, 2, 4, 64, 512 // ps
    n_pages = b * n_p + 3
    q = torch.from_numpy(rng.standard_normal((b, hkv * r, d)) * 2)
    kp = torch.from_numpy(rng.standard_normal((hkv, n_pages, ps, d)))
    vp = torch.from_numpy(rng.standard_normal((hkv, n_pages, ps, d)))
    tables = torch.from_numpy((rng.permutation(n_pages - 1)[: b * n_p] + 1).reshape(b, n_p)).to(torch.int32)
    lengths = torch.tensor([1, ps + 1, 300, n_p * ps], dtype=torch.int32)
    ks = vs = None
    if quant:
        (kp, ks), (vp, vs) = _codes(kp), _codes(vp)
    scale = d**-0.5
    want = paged_decode_attention_plain(q.float(), kp if quant else kp.float(), vp if quant else vp.float(),
                                        tables, lengths, scale, ks, vs, cap, window).double()
    for bi in range(b):
        lo, hi = _k7_range(int(lengths[bi]), n_p * ps, window)
        rows = (tables[bi].long()[:, None] * ps + torch.arange(ps)).flatten()  # key s -> pool row
        n = int(lengths[bi])
        for h in range(hkv):
            kh, vh = kp[h].reshape(-1, d).double()[rows], vp[h].reshape(-1, d).double()[rows]
            ksh = None if ks is None else ks[h].flatten().double()[rows]
            vsh = None if vs is None else vs[h].flatten().double()[rows]
            last = (kh[n - 1], vh[n - 1], 1.0 if ksh is None else ksh[n - 1], 1.0 if vsh is None else vsh[n - 1])
            got = _split_attention(q[bi, h * r:(h + 1) * r].double(), kh, vh, ksh, vsh, lo, hi, c, scale, cap,
                                   last)
            ref = want[bi, h * r:(h + 1) * r]
            assert (got - ref).abs().max() / ref.abs().max() < 1e-5, (bi, h)


# ---------------------------------------------------------------------------
# the fragments


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3  # g, t


def _mma(a, b):
    """m16n8k16 on the lanes' registers: a [32, 4 regs, 2 halves], b [32,
    2, 2] → C [16, 8] (A[g][2t+h] = a[., 0, h], A[g+8][2t+h] = a[., 1, h],
    A[g][2t+8+h] = a[., 2, h], A[g+8][2t+8+h] = a[., 3, h]; B[2t+h][g] =
    b[., 0, h], B[2t+8+h][g] = b[., 1, h]), returned as the lanes' C
    registers [32, 4] (C[g][2t+e], C[g+8][2t+e] for e = 0, 1)."""
    g, t = _lanes()
    am, bm = np.full((16, 16), np.nan), np.full((16, 8), np.nan)
    for h in range(2):
        am[g, 2 * t + h], am[g + 8, 2 * t + h] = a[:, 0, h], a[:, 1, h]
        am[g, 2 * t + 8 + h], am[g + 8, 2 * t + 8 + h] = a[:, 2, h], a[:, 3, h]
        bm[2 * t + h, g], bm[2 * t + 8 + h, g] = b[:, 0, h], b[:, 1, h]
    assert not np.isnan(am).any() and not np.isnan(bm).any()
    cm = am @ bm
    return np.stack([cm[g, 2 * t], cm[g, 2 * t + 1], cm[g + 8, 2 * t], cm[g + 8, 2 * t + 1]], 1)


def _k_off(key, ch, nc):
    """decode_attn.cuh's k_off: chunk ch of row key, odd rows' chunks ^ 4."""
    return key * nc * 16 + 16 * (ch ^ ((key & 1) << 2) if nc >= 8 else ch)


def _v_off(key, ch, nc):
    return key * nc * 16 + 16 * (ch ^ (key & 7))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_score_fragments(d, quant):
    """S^T = K Q^T from the lanes' 16-byte K reads (chunk 4p + t of rows g
    and g + 8) and the queries' B fragments in the same D order; the K
    tile's chunk layout is a bijection and each quarter-warp's 16-byte reads
    hit eight distinct bank groups."""
    rng = np.random.default_rng(d + quant)
    elem = 1 if quant else 2
    e_chunk, nc = 16 // elem, d * elem // 16
    kpc = e_chunk // 4
    k = rng.integers(-8, 8, (KEYS, d)).astype(np.float64)
    q = np.zeros((8, d))
    q[:3] = rng.integers(-8, 8, (3, d))  # r = 3: heads 3..7 are zero queries
    offs = np.array([[_k_off(key, ch, nc) for ch in range(nc)] for key in range(KEYS)])
    assert sorted(offs.ravel()) == list(range(0, KEYS * nc * 16, 16))
    g, t = _lanes()
    for warp in range(WARPS):
        kr0, kr1 = 16 * warp + g, 16 * warp + g + 8
        sc = np.zeros((32, 4))
        for p in range(nc // 4):
            ch = 4 * p + t
            for phase in range(4):  # lanes 8 phase .. + 7: rows g, chunks 4p + t
                lanes = slice(8 * phase, 8 * phase + 8)
                for rows_ in (kr0, kr1):
                    banks = (_k_off(rows_[lanes], ch[lanes], nc) // 16) % 8
                    assert len(set(banks)) == 8
            for j in range(kpc):
                d0 = ch * e_chunk + 4 * j  # the four dims of step (p, j) for lane t
                if quant:  # i8x2 of word j and of word j >> 8: bytes (0, 2) and (1, 3)
                    pair_lo, pair_hi = (d0, d0 + 2), (d0 + 1, d0 + 3)
                else:  # words 2j and 2j + 1
                    pair_lo, pair_hi = (d0, d0 + 1), (d0 + 2, d0 + 3)
                a = np.stack([np.stack([k[kr0, pair_lo[0]], k[kr0, pair_lo[1]]], 1),
                              np.stack([k[kr1, pair_lo[0]], k[kr1, pair_lo[1]]], 1),
                              np.stack([k[kr0, pair_hi[0]], k[kr0, pair_hi[1]]], 1),
                              np.stack([k[kr1, pair_hi[0]], k[kr1, pair_hi[1]]], 1)], 1)
                # qf: (q[d0], q[d0 + 2]), (q[d0 + 1], q[d0 + 3]) for int8 (two prmt); else as loaded
                b = np.stack([np.stack([q[g, pair_lo[0]], q[g, pair_lo[1]]], 1),
                              np.stack([q[g, pair_hi[0]], q[g, pair_hi[1]]], 1)], 1)
                sc += _mma(a, b)
        want = k[16 * warp:16 * warp + 16] @ q.T  # S^T [16 keys, 8 heads]
        assert np.array_equal(sc[:, 0], want[g, 2 * t]) and np.array_equal(sc[:, 1], want[g, 2 * t + 1])
        assert np.array_equal(sc[:, 2], want[g + 8, 2 * t]) and np.array_equal(sc[:, 3], want[g + 8, 2 * t + 1])


def _movmatrix_trans(x):
    """x [32, 2]: lane (g, t) holds row g, columns 2t, 2t + 1 of an 8 x 8
    matrix → the same positions of its transpose."""
    g, t = _lanes()
    m = np.full((8, 8), np.nan)
    m[g, 2 * t], m[g, 2 * t + 1] = x[:, 0], x[:, 1]
    return np.stack([m.T[g, 2 * t], m.T[g, 2 * t + 1]], 1)


def _ldmatrix_x4_trans(mem, addrs):
    """mem: bf16 elements by byte offset / 2; addrs [32] the lanes' row
    addresses (lanes 8m..8m+7: rows of matrix m) → [32, 4 regs, 2 halves]:
    lane (g, t) gets rows 2t, 2t + 1 of column g of each matrix."""
    g, t = _lanes()
    out = np.zeros((32, 4, 2))
    for m in range(4):
        rows = addrs[8 * m:8 * m + 8] // 2  # element index of each row's first column
        for h in range(2):
            out[:, m, h] = mem[rows[2 * t + h] + g]
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16 tile", "int8 converted"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_pv_fragments(d, quant):
    """O^T += V^T P^T for one warp: P^T's B fragments from S's (key, head)
    pairs by movmatrix, V^T's A fragments by ldmatrix.trans from the
    swizzled V rows (the bf16 tile's rows 16w.., or an int8 tile's rows
    converted into the warp's buffer: codes 16c..16c + 15 of a row to its
    chunks 2c and 2c + 1), the accumulator's (dim, head) map; the
    ldmatrix reads are conflict-free."""
    rng = np.random.default_rng(7 * d + quant)
    warp = 2
    v = rng.integers(-8, 8, (KEYS, d)).astype(np.float64)
    p = rng.integers(0, 5, (16, 8)).astype(np.float64)  # P of the warp's 16 keys x 8 heads
    nc = d // 8  # 16-byte bf16 chunks a row
    mem = np.full(KEYS * d, np.nan)
    if quant:  # the warp's 16 rows from the plain int8 tile into its buffer
        base_row = 0
        for row in range(16):
            for c16 in range(d // 16):
                codes = v[16 * warp + row, 16 * c16:16 * c16 + 16]
                for half in range(2):
                    off = _v_off(row, 2 * c16 + half, nc) // 2
                    mem[off:off + 8] = codes[8 * half:8 * half + 8]
    else:  # the loader: chunk ch of row key at v_off
        base_row = 16 * warp
        for key in range(KEYS):
            for ch in range(nc):
                off = _v_off(key, ch, nc) // 2
                mem[off:off + 8] = v[key, 8 * ch:8 * ch + 8]
    g, t = _lanes()
    # S's C registers: (key g, heads 2t, 2t + 1), (key g + 8, the same)
    b0 = _movmatrix_trans(np.stack([p[g, 2 * t], p[g, 2 * t + 1]], 1))
    b1 = _movmatrix_trans(np.stack([p[g + 8, 2 * t], p[g + 8, 2 * t + 1]], 1))
    b = np.stack([b0, b1], 1)
    lane = np.arange(32)
    vrow, vch = (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1
    want = (p.T @ v[16 * warp:16 * warp + 16]).T  # O^T [D, 8 heads]
    for mb in range(d // 16):
        addrs = _v_off(base_row + vrow, 2 * mb + vch, nc)
        for m in range(4):  # each 8 x 8 matrix's rows in eight distinct bank groups
            assert len(set((addrs[8 * m:8 * m + 8] // 16) % 8)) == 8
        acc = _mma(_ldmatrix_x4_trans(mem, addrs), b)
        for e in range(4):
            dim, head = 16 * mb + g + 8 * (e >> 1), 2 * t + (e & 1)
            assert np.array_equal(acc[:, e], want[dim, head])
