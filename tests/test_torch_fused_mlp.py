"""K5 (the one-kernel quantized MLP) against the JAX package's fused MLP.

The JAX side builds its fused-MLP containers (q4mlpg/q4mlpd) from random raw
Q4_K blocks and runs `fused_mlp_layered`, `fused_mlp` (Pallas, interpret
mode on the CPU, as its own tests run it) and `mlp_prefill`; the port runs
its plain versions on the same weights, carried across by
`from_jax_qtensor`, and the same numpy inputs. Shapes as
tests/test_fused_mlp.py: L=2, K=1024, F=1024, H=256.

Tolerance: max|got - want| / max|want| < 2e-2. The JAX containers keep
their v3 scales (8s, m+16s) in bf16 and its kernels round each scale*q
product to bf16; the port's plain version is f32 throughout (measured
≈1.0-1.6% apart). The port's mlp_prefill rounds gate_up, the activation
and the dequantized down weight to bf16 as the JAX function does; it is
held to its plain f32 counterpart within 1e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.ops import qtensor as jqt
from nfai_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from nfai_tpu.ops.fused_mlp import fused_mlp_layered as jax_fused_mlp_layered
from nfai_tpu.ops.fused_mlp import mlp_prefill as jax_mlp_prefill
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.ops import fused_mlp as tfm
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.testing import random_q4k_bytes

TOL = 2e-2
L, K, F, H = 2, 1024, 1024, 256


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_stack(parts):
    return jqt.QTensor(np.stack([p.qs for p in parts]), np.stack([p.scales for p in parts]),
                       np.stack([p.mins for p in parts]), "q4", parts[0].k, parts[0].n)


def _to_port(qt):
    return tqt.from_jax_qtensor(qt.kind, np.asarray(qt.qs), np.asarray(qt.scales),
                                None if qt.mins is None else np.asarray(qt.mins),
                                qt.k, qt.n, tfb=qt.tfb)


def _slice(qt, i):
    return qt.replace(qs=qt.qs[i], scales=qt.scales[i],
                      mins=None if qt.mins is None else qt.mins[i])


@pytest.fixture(scope="module")
def pair():
    """(JAX q4mlpg, JAX q4mlpd, port gate_up, port down, raw blocks)."""
    rng = np.random.default_rng(0)
    raws = {name: [random_q4k_bytes(rng, n, k) for _ in range(L)]
            for name, (n, k) in (("gate", (F, K)), ("up", (F, K)), ("down", (H, F)))}
    pack = lambda raw, n, k: jqt.pack_gguf_tensor(raw, JGGMLType.Q4_K, (n, k), device_put=False)
    gu = _jax_stack([jqt.concat_qtensors([pack(raws["gate"][i], F, K), pack(raws["up"][i], F, K)])
                     for i in range(L)])
    dn = _jax_stack([pack(raws["down"][i], H, F) for i in range(L)])
    gum, dnm = jqt.to_v3_mlp_stacked(gu, dn)
    assert (gum.kind, dnm.kind) == ("q4mlpg", "q4mlpd")
    return gum, dnm, _to_port(gum), _to_port(dnm), raws


@pytest.mark.parametrize("which", ["q4mlpg", "q4mlpd"])
def test_from_jax_fused_containers_round_trip(pair, which):
    """JAX dequant_qtensor of a layer of each fused-MLP container (natural
    order) == the port's dequant of the converted container; and the port's
    converted weights are the GGUF weights up to the JAX bf16 scale storage."""
    gum, dnm, tgu, tdn, raws = pair
    jt, pt = (gum, tgu) if which == "q4mlpg" else (dnm, tdn)
    assert isinstance(pt, tqt.Q4Tensor) and (pt.k, pt.n) == (jt.k, jt.n)
    for i in range(L):
        want = np.asarray(jqt.dequant_qtensor(_slice(jt, i), jnp.float32))  # [K, N]
        got = tqt.dequant(pt.layer(i)).numpy().T
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-20 * np.abs(want).max())
    if which == "q4mlpg":
        exact = tqt.concat([tqt.pack_gguf_tensor(raws[p][0], GGMLType.Q4_K, (F, K))
                            for p in ("gate", "up")])
    else:
        exact = tqt.pack_gguf_tensor(raws["down"][0], GGMLType.Q4_K, (H, F))
    assert rel(tqt.dequant(pt.layer(0)).numpy(), tqt.dequant(exact).numpy()) < TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_vs_jax_fused_mlp_layered(pair, act):
    gum, dnm, tgu, tdn, _ = pair
    x = np.random.default_rng(1).standard_normal((4, K)).astype(np.float32)
    for layer in range(L):
        want = jax_fused_mlp_layered(jnp.asarray(x, jnp.bfloat16), gum, dnm, jnp.int32(layer), act=act)
        got = tfm.fused_mlp_layered(torch.from_numpy(x).to(torch.bfloat16), tgu, tdn, layer, act)
        assert got.dtype == torch.bfloat16 and got.shape == (4, H)
        assert rel(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_vs_jax_fused_mlp_one_layer(pair, act):
    gum, dnm, tgu, tdn, _ = pair
    x = np.random.default_rng(2).standard_normal((2, 2, K)).astype(np.float32)
    want = jax_fused_mlp(jnp.asarray(x, jnp.bfloat16), _slice(gum, 1), _slice(dnm, 1), act=act)
    got = tfm.fused_mlp(torch.from_numpy(x.reshape(4, K)), tgu.layer(1), tdn.layer(1), act)
    assert rel(got.float().numpy(), np.asarray(want, np.float32).reshape(4, H)) < TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_vs_jax_mlp_prefill(pair, act):
    """1100 rows: above MLP_FUSED_MAX_ROWS, where both packages dequantize
    the down weight once."""
    gum, dnm, tgu, tdn, _ = pair
    rows = 1100
    assert rows > tfm.MLP_FUSED_MAX_ROWS
    x = np.random.default_rng(3).standard_normal((rows, K)).astype(np.float32)
    want = jax_mlp_prefill(jnp.asarray(x, jnp.bfloat16), _slice(gum, 0), _slice(dnm, 0), act=act)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plain = tfm.fused_mlp_plain(xt, tgu.layer(0), tdn.layer(0), act)
    assert rel(plain.float().numpy(), want) < TOL
    got = tfm.mlp_prefill(xt, tgu.layer(0), tdn.layer(0), act)
    assert got.shape == (rows, H)
    assert rel(got.float().numpy(), plain.float().numpy()) < 1e-2


def test_eligibility_follows_the_jax_rule(pair):
    _, _, tgu, tdn, _ = pair
    assert tfm.mlp_eligible(tgu, tdn)
    q8 = tqt.Q8Tensor(torch.zeros(L, H, F, dtype=torch.int8), torch.ones(L, H, F // 16),
                      None, F, H, 16)
    assert not tfm.mlp_eligible(tgu, q8)  # an 8-bit down stack keeps the two-matmul route
    assert not tfm.mlp_eligible(tgu, tqt.LayerList([tdn.layer(0), q8.layer(1)]))
    narrow = tqt.Q4Tensor(tgu.qs[..., :128], tgu.scales[..., :8], tgu.mins[..., :8], 256, 2 * F)
    assert not tfm.mlp_eligible(narrow, tdn)  # K % 1024 != 0, as jqt.mlp_eligible
    with pytest.raises(ValueError):
        tfm.fused_mlp(torch.zeros(2, K), tgu.layer(0), tdn.layer(0), act="relu")


# -- the decode kernel's host plan and index maps (csrc/fused_mlp.cu), on the CPU --------


@pytest.mark.parametrize("m,k,f,h", [(1, 2048, 8192, 2048), (8, 2048, 8192, 2048),
                                     (16, 2048, 8192, 2048), (9, 3072, 8192, 3072),
                                     (16, 256, 256, 256), (2, 256, 512, 256), (3, 1024, 2048, 1024),
                                     (8, 4096, 4096, 4096)])
def test_decode_plan_covers_f_and_h(m, k, f, h):
    """The plan's blocks cover F exactly (64 ffn columns each) and fit on
    the card at once, its ring fits in an H100 block's shared memory, its
    phase-2 items cover H x F exactly, and its workspace is what the kernel
    writes: one f32 partial per (F slice, row, output column), one counter
    per 16 output columns receiving one arrival per slice."""
    p = tfm.decode_plan(m, k, f, h)
    assert p is not None
    assert p["blocks"] * tfm.DECODE_FB == f and p["blocks"] <= 132
    assert tfm.DECODE_FB == 8 * tfm.DECODE_WARPS  # 8 gate (and up) rows a warp
    assert p["slices"] * p["slice"] == f and p["items"] * tfm.DECODE_RB * p["slice"] == h * f
    assert p["part"] == p["slices"] * m * h and p["counters"] == h // 16 + 2 * p["slices"]
    nf = 1 if m <= 8 else 2
    assert p["work"] == nf * f * 16 + (f // 32) * 8 * nf * 4 + 4 * p["part"]
    assert p["smem"] <= tfm.SMEM_MAX and p["stages"] in (3, 4)
    writes, counts = _decode_writes(p, m, h)
    assert writes.shape == (p["slices"], m, h) and (writes == 1).all()
    assert (counts == p["slices"]).all()


@pytest.mark.parametrize("m,k,f,h", [(17, 2048, 8192, 2048), (8, 1152, 8192, 2048),
                                     (8, 2048, 8192 + 128, 2048), (8, 2048, 8192, 2048 + 64),
                                     (16, 4096, 4096, 4096), (8, 4096, 14336, 4096)])
def test_decode_plan_leaves_other_shapes_to_the_tiles(m, k, f, h):
    """More than 16 rows, K % 256, F % 256 or H % 128 not 0, x too wide for
    shared memory beside the ring at two n8 fragments, or more blocks than
    the card holds at once: no plan (the tiles take the shape)."""
    assert tfm.decode_plan(m, k, f, h) is None


@pytest.mark.parametrize("m,k,f,h", [(17, 2048, 8192, 2048), (64, 2048, 8192, 2048),
                                     (256, 2048, 8192, 2048), (1024, 2048, 8192, 2048),
                                     (256, 3072, 8192, 3072), (200, 256, 1280, 256),
                                     (9, 256, 8704, 256)])
def test_tiles_plan_splits_f_within_the_card(m, k, f, h):
    """The tiles' row tile holds m (or tiles it by 128), phase 2's F split
    divides F's 128-code stages and keeps phase 2 within the card's SMs
    where it splits, and the workspace is a [m, F] bf16 plus the slices'
    f32 sums (BM / 2 per consumer thread a tile)."""
    p = tfm.tiles_plan(m, k, f, h)
    bm, n_m, ks = p["bm"], p["row_tiles"], p["ks"]
    assert bm in (16, 32, 64, 128) and (m <= bm or bm == 128) and n_m == -(-m // bm)
    assert bm == 16 or m > bm // 2 or bm == 128
    assert ks in (1, 2, 4, 8) and (f // 128) % ks == 0
    assert ks == 1 or (h // 128) * n_m * ks <= 132
    assert ks == 8 or (f // 128) % (2 * ks) or (h // 128) * n_m * 2 * ks > 132
    part = ks * n_m * (h // 128) * (bm // 2) * 256 if ks > 1 else 0
    assert p["work"] == m * f * 2 + 4 * part and p["counters"] == n_m * (2 + h // 128)
    assert p["blocks"] == (f // 64 + ks * (h // 128)) * n_m


def _decode_writes(plan, m, h):
    """The kernel's phase-2 index map: (number of stores of each partial
    element [F slice, row, output column], arrivals at each row group's
    counter) over every block's items and warps."""
    writes = np.zeros((plan["slices"], m, h), np.int64)
    counts = np.zeros(h // 16, np.int64)
    grid, n_fs = plan["blocks"], plan["slices"]
    for b in range(grid):
        mine = (plan["items"] - b + grid - 1) // grid
        for it in (b + grid * r for r in range(mine)):
            fs = it % n_fs
            for warp in range(tfm.DECODE_WARPS):
                hg = (it // n_fs) * tfm.DECODE_RB + 16 * warp
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for j in range(2 if m > 8 else 1):
                        for e in range(4):
                            row, col = 8 * j + 2 * t + (e & 1), hg + g + 8 * (e >> 1)
                            if row < m:
                                writes[fs, row, col] += 1
                counts[hg // 16] += 1
    return writes, counts


def _nib2(w):
    """The kernel's nib2: the codes at bits 0-3 and 16-19 of w (lo, hi)."""
    return np.stack([w & 0xF, (w >> 16) & 0xF], -1).astype(np.float32)


@pytest.mark.parametrize("mp", [8, 16])
def test_decode_stage_fragment_mapping(mp):
    """One ring stage through the kernel's stage_product, modelled in numpy:
    the ldmatrix lane addresses, nib2 on the words, K1's permuted B
    fragment of x, two m16n8k16 products a 32-block, the f32 scale and the
    min times the block's x sum; the C fragments assembled equal
    (s q - m) @ x^T for the stage's 16 rows."""
    rng = np.random.default_rng(mp)
    codes = rng.integers(0, 256, (16, 128), dtype=np.uint8)  # 16 rows x 256 codes (8 32-blocks)
    sc = rng.random((16, 8), dtype=np.float32) * 1e-2
    mn = rng.random((16, 8), dtype=np.float32) * 5e-2
    x = rng.standard_normal((mp, 256)).astype(np.float32)
    q = np.empty((16, 256), np.float32)  # the natural-order codes of each 32-block
    for b in range(8):
        blk = codes[:, 16 * b:16 * b + 16]
        q[:, 32 * b:32 * b + 16], q[:, 32 * b + 16:32 * b + 32] = blk & 0xF, blk >> 4
    want = (np.repeat(sc, 32, 1) * q - np.repeat(mn, 32, 1)) @ x.T  # [16, mp]
    xsum = x.reshape(mp, 8, 32).sum(-1).T  # [8 blocks][mp]
    words = codes.view("<u4")  # [16 rows, 32 words]: block b word t at 4b + t
    acc = np.zeros((mp // 8, 32, 4))
    for b in range(8):
        bb, hh = b & ~1, b & 1
        A = np.zeros((2, 16, 16), np.float32)  # the two products' A, from every lane's registers
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            # ldmatrix register i of lane (g, t): word t of the row lane 8i + g addresses
            w = [int(words[g + 8 * (i & 1), 4 * (bb + (i >> 1)) + t]) for i in range(4)]
            w0, w1 = w[2 * hh], w[2 * hh + 1]
            a = [_nib2(v) for v in (w0, w1, w0 >> 8, w1 >> 8, w0 >> 4, w1 >> 4, w0 >> 12, w1 >> 12)]
            for mma in range(2):
                A[mma, g, 2 * t:2 * t + 2], A[mma, g + 8, 2 * t:2 * t + 2] = a[4 * mma], a[4 * mma + 1]
                A[mma, g, 2 * t + 8:2 * t + 10] = a[4 * mma + 2]
                A[mma, g + 8, 2 * t + 8:2 * t + 10] = a[4 * mma + 3]
        for j in range(mp // 8):
            B = np.zeros((2, 16, 8), np.float32)  # b_frag: lane (g, t) holds column g
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                row = x[8 * j + g, 32 * b:32 * b + 32]
                for mma in range(2):
                    half = row[16 * mma:]
                    B[mma, 2 * t:2 * t + 2, g] = half[[4 * t, 4 * t + 2]]
                    B[mma, 2 * t + 8:2 * t + 10, g] = half[[4 * t + 1, 4 * t + 3]]
            D = A[0] @ B[0] + A[1] @ B[1]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                p = (D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1])
                xs = xsum[b, 8 * j + 2 * t:8 * j + 2 * t + 2]
                for e in range(4):
                    r = g + 8 * (e >> 1)
                    acc[j, lane, e] += sc[r, b] * p[e] - mn[r, b] * xs[e & 1]
    got = np.zeros((16, mp))
    for j in range(mp // 8):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            got[g, 8 * j + 2 * t:8 * j + 2 * t + 2] = acc[j, lane, :2]
            got[g + 8, 8 * j + 2 * t:8 * j + 2 * t + 2] = acc[j, lane, 2:]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
