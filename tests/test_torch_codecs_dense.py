"""The GGUF codecs the dense route reads, against the JAX package's
(nfai_tpu.gguf.quants, numpy on both sides): every decoder the port took
over gives the same float32 bits on the same random blocks, the encoders
give the same bytes, and the two dispatch tables hold the same kinds.
Blocks are random bytes with finite scales (f16 d in [1e-3, 1e-2), Q8_K's
f32 d likewise), so NaN and infinity never enter the comparison; the
integer and F64/BF16 kinds take every bit pattern they decode to finite
values, and BF16 all of them (the comparison is of bits).
"""
import numpy as np
import pytest

from nfai_tpu.gguf import quants as jq
from nfai_tpu.gguf.constants import GGML_BLOCK_LAYOUT as JLAYOUT
from nfai_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from nfai_tpu_torch.gguf import quants as tq
from nfai_tpu_torch.gguf.constants import GGML_BLOCK_LAYOUT

N_BLOCKS = 37
# kind -> byte offsets of the f16 scales inside a block
F16_SCALES = {
    GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2), GGMLType.Q8_1: (0, 2),
    GGMLType.IQ4_NL: (0,), GGMLType.IQ4_XS: (0,),
    GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q8_0: (0,),
    GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2), GGMLType.Q6_K: (208,),
    GGMLType.Q2_K: (80, 82), GGMLType.Q3_K: (108,),
}
NEW_KINDS = [GGMLType.BF16, GGMLType.F64, GGMLType.I8, GGMLType.I16, GGMLType.I32,
             GGMLType.I64, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_1, GGMLType.Q8_K,
             GGMLType.IQ4_NL, GGMLType.IQ4_XS]
OLD_KINDS = [GGMLType.F32, GGMLType.F16, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q8_0,
             GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]


def _random_blocks(kind: GGMLType, seed: int) -> tuple[np.ndarray, int]:
    """(raw bytes, element count) of N_BLOCKS random blocks of `kind`."""
    rng = np.random.default_rng(seed)
    layout = GGML_BLOCK_LAYOUT[kind]
    n = N_BLOCKS * layout.block_size
    if kind == GGMLType.F64:
        return rng.standard_normal(n).view(np.uint8), n
    if kind == GGMLType.F32:
        return rng.standard_normal(n).astype(np.float32).view(np.uint8), n
    if kind == GGMLType.F16:
        return rng.standard_normal(n).astype(np.float16).view(np.uint8), n
    raw = np.frombuffer(rng.bytes(N_BLOCKS * layout.type_size), np.uint8).reshape(
        N_BLOCKS, layout.type_size).copy()
    for off in F16_SCALES.get(kind, ()):
        d = rng.uniform(1e-3, 1e-2, N_BLOCKS).astype(np.float16)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(N_BLOCKS, 2)
    if kind == GGMLType.Q8_K:
        raw[:, :4] = rng.uniform(1e-3, 1e-2, N_BLOCKS).astype(np.float32).view(np.uint8).reshape(
            N_BLOCKS, 4)
    return raw.reshape(-1), n


@pytest.mark.parametrize("kind", [k for k in NEW_KINDS + OLD_KINDS if k != GGMLType.IQ4_XS],
                         ids=lambda k: k.name)
def test_decoders_give_the_jax_bits(kind):
    raw, n = _random_blocks(kind, seed=int(kind))
    got = tq.dequantize(raw, n, kind)
    want = jq.dequantize(raw, n, kind)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (n,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _iq4_xs_ggml(raw: np.ndarray, n: int) -> np.ndarray:
    """ggml's dequantize_row_iq4_xs, element by element: per 256-weight block
    f16 d, u16 scales_h, 4 bytes of scales_l, 128 bytes of nibbles; sub-block
    ib's scale is d * (low nibble of scales_l | 2 bits of scales_h << 4) - 32),
    16 bytes of nibbles each (low: weights 0-15, high: 16-31)."""
    out = np.empty(n, np.float32)
    for b, blk in enumerate(raw.reshape(-1, 136)):
        d = np.float32(blk[:2].view(np.float16)[0])
        scales_h = int(blk[2:4].view(np.uint16)[0])
        for ib in range(8):
            ls = ((int(blk[4 + ib // 2]) >> 4 * (ib % 2)) & 0xF) | (((scales_h >> 2 * ib) & 3) << 4)
            dl = d * np.float32(ls - 32)
            for j in range(16):
                q = int(blk[8 + 16 * ib + j])
                base = 256 * b + 32 * ib + j
                out[base] = dl * tq.IQ4_NL_VALUES[q & 0xF]
                out[base + 16] = dl * tq.IQ4_NL_VALUES[q >> 4]
    return out


def test_iq4_xs_decodes_ggml_blocks_where_the_jax_copy_raises():
    """The JAX package's IQ4_XS decoder reads its 136-byte blocks as 140
    bytes and raises (a reference fault, ROADMAP §3); the port's gives
    ggml's values bit for bit."""
    raw, n = _random_blocks(GGMLType.IQ4_XS, seed=23)
    with pytest.raises(ValueError):
        jq.dequantize(raw, n, GGMLType.IQ4_XS)
    got = tq.dequantize(raw, n, GGMLType.IQ4_XS)
    assert np.array_equal(got.view(np.uint32), _iq4_xs_ggml(raw, n).view(np.uint32))


def test_dispatch_tables_hold_the_jax_kinds():
    assert set(tq.DEQUANTIZERS) == set(jq.DEQUANTIZERS)
    assert set(tq.QUANTIZERS) - {GGMLType.BF16} == set(jq.QUANTIZERS)
    for k in tq.DEQUANTIZERS:
        mine, theirs = GGML_BLOCK_LAYOUT[k], JLAYOUT[k]
        assert (mine.block_size, mine.type_size) == (theirs.block_size, theirs.type_size), k


# round-trip error bound of each encoder, relative to max|x|: half a code
# step (Q2_K: 4 codes over a range up to 2 max|x|) and the sub-block scale's
# rounding; Q3_K's simple scale (group max / 4) clips a group's largest
# positive value from code 4 to 3, a quarter of the group max
ROUND_TRIP = {GGMLType.Q5_0: 1 / 15, GGMLType.Q5_1: 1 / 30, GGMLType.Q2_K: 0.4,
              GGMLType.Q3_K: 0.3, GGMLType.Q5_K: 1 / 20}
NEW_ENCODERS = [GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q5_K]


@pytest.mark.parametrize("kind", [GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.BF16, GGMLType.F16]
                         + NEW_ENCODERS, ids=lambda k: k.name)
@pytest.mark.parametrize("scale", [0.02, 3.0])
def test_encoders_give_the_jax_bytes(kind, scale):
    rng = np.random.default_rng(int(kind))
    x = (rng.standard_normal(32 * 24) * scale).astype(np.float32)
    x[:max(32, GGML_BLOCK_LAYOUT[kind].block_size)] = 0.0  # an all-zero (super-)block (d = 0)
    got, want = tq.quantize(x, kind), jq.quantize(x, kind)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    back = tq.dequantize(got, x.size, kind)
    step = ROUND_TRIP.get(kind, 2**-7)
    assert np.abs(back - x).max() <= step * np.abs(x).max()


@pytest.mark.parametrize("kind", NEW_ENCODERS, ids=lambda k: k.name)
def test_k_encoders_give_the_jax_bytes_at_subnormal_scales(kind):
    """Values of ~1e-4 put the f16 super-block scales d (d = range / 45,
    max / 124 and range / 1953 for Q2_K, Q3_K and Q5_K) below f16's smallest
    normal (6.1e-5), and above zero: the bytes still equal the JAX
    encoder's, and the subnormal scales decode (not flushed to zero)."""
    rng = np.random.default_rng(40 + int(kind))
    x = (rng.standard_normal(256 * 4) * 1e-4).astype(np.float32)
    got, want = tq.quantize(x, kind), jq.quantize(x, kind)
    assert np.array_equal(got, want)
    layout = GGML_BLOCK_LAYOUT[kind]
    d_off = {GGMLType.Q2_K: 80, GGMLType.Q3_K: 108, GGMLType.Q5_K: 0}[kind]
    d = got.reshape(-1, layout.type_size)[:, d_off:d_off + 2].copy().view(np.float16)
    assert (0 < np.abs(d)).all() and (np.abs(d) < np.finfo(np.float16).tiny).all()
    back = tq.dequantize(got, x.size, kind)
    assert np.array_equal(back.view(np.uint32), jq.dequantize(want, x.size, kind).view(np.uint32))
    assert np.abs(back).max() > 0


def test_bf16_encoder_rounds_to_nearest_even():
    # 1 + 2^-8 is a tie between 1 and 1 + 2^-7 (rounds to the even 1.0);
    # 1 + 3 * 2^-8 a tie between 1 + 2^-7 and 1 + 2^-6 (rounds to 1 + 2^-6)
    x = np.array([1 + 2**-8, 1 + 3 * 2**-8, 1 + 2**-8 + 2**-20, -2.5], np.float32)
    got = tq.dequant_bf16(tq.quant_bf16(x), x.size)
    assert got.tolist() == [1.0, 1 + 2**-6, 1 + 2**-7, -2.5]


def test_new_kinds_round_trip_through_a_gguf_file(tmp_path):
    """A file holding BF16, Q5_0 and Q5_1 tensors (written by the port's
    writer) reads back through the port's reader to what the JAX reader
    decodes from the same file."""
    from nfai_tpu.gguf import GGUFFile as JGGUFFile

    rng = np.random.default_rng(5)
    w = GGUFWriter()
    w.add("general.architecture", "llama")
    arrays = {}
    for kind in (GGMLType.BF16, GGMLType.Q5_0, GGMLType.Q5_1):
        arrays[kind] = (rng.standard_normal((8, 64)) * 0.1).astype(np.float32)
        w.add_tensor(f"t.{kind.name}", arrays[kind], kind)
    path = w.write(tmp_path / "kinds.gguf")
    with GGUFFile.open(path) as g, JGGUFFile.open(path) as jg:
        for kind in arrays:
            name = f"t.{kind.name}"
            assert g.tensors[name].ggml_type == kind and g.tensors[name].shape == (8, 64)
            got, want = g.tensor_f32(name), jg.tensor_f32(name)
            assert np.array_equal(got, want)
            assert np.abs(got - arrays[kind]).max() < 0.1 * np.abs(arrays[kind]).max()
