"""The port's CUDA kernels against their plain versions, and the tiny model on
the card against the CPU. Marked `cuda`: each test skips without a GPU
(decided inside the fixture, never at import). On a machine with a card and
no JAX, run them without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: max|got - want| / max|want| < 2e-2 (bf16 kernels against f32
plain versions), taken per output row for attention (per batch row for
decode, per query token or (token, head) row for prefill) and the matmuls
and MLP (per input row) so a row with a small output is not hidden behind a
large one; the row write is exact. K4's wgmma kernel is checked at every
head width (64, 128, 256; softcap and window at 256), GQA ratios 1, 2, 3,
4 and 8, chunks of 1 to 256 tokens at offsets 0, 40 and 700, on a narrow
and a wide grid (one and two consumer groups a block), bf16 and int8, per
(token, head) row and with the same bits on three launches; K7 at head
widths 64, 128 and 256. K1 and K6 (4-bit and 8-bit dequant-matmul) are
checked on every path: the CUDA-core GEMV (M = 1), the tensor-core GEMV
(M = 2..8) and each wgmma tile width in both K splits, at the path's N
and K, K % 128 != 0 and a ragged N; K6 with codes over all of -128..127,
scale groups of 16 and 32, with and without mins; three launches give the
same bits, and a layer of a stack is read in place. K2, K4 and K7 are also checked at head_dim 128 with
r = 3 and 8, and K8 / K9 (grouped matmul) per routed row, with x random on
the padding rows (written as zeros) and the same bits on three launches, on
a routing with an empty expert, a block of exactly tm rows and the clipped
empty tail blocks at tm = 8, 32 and 128 (K % 128 != 0 and a ragged N too;
g16 and g32, with and without mins), and at model C's widths and layouts
(batch 1, batch 8, 256 tokens, 8 x 128). The tiny
models of every GGUF kind the port loads run on the card and on the CPU,
with K5 launched exactly for the fused-MLP model and K6 exactly for the
8-bit ones. K7 (paged decode attention) is
checked per batch row on shuffled tables with ragged lengths at page sizes
16 and 128, and a small paged BatchEngine serves on the card through K7
without K2/K3. The int8 KV cache: K2, K4 and K7 through their int8 entry
points (int8 codes and f32 scales from `quantize_kv`) at head_dim 64 and
128 against their plain versions within the same tolerance, K10 (the
scale write) exactly, and a tiny int8 engine (dense and paged) on the card
against the CPU through the int8 routes only. Gemma: K2, K4 and K7 at
head_dim 256 with softcap and a sliding window (bf16 and int8, r = 1, 2, 4
and 8) against their plain versions, K5 bit for bit on repeated launches
(and at the edges of its regimes: rows 1, 2, 8, 9 and 16 on the decode
kernel, 17, 40, 64 and 200 on the tiles, one and five F slices, an F
too wide for the decode kernel,
silu and gelu, per row, one launch a call),
and a tiny gemma2 (dense and paged, bf16 and int8) on the card against the
CPU. Dense weights: K11 per input row at the Llama-3.2-1B projection shapes,
Gemma-3-1B's K = 1152 and an odd shape (K = 1000, N = 130), through its
16-byte and its 2-byte loads, twice with the same bits; tiny F16 and
`param_dtype` models (dense and paged, bf16 and int8 caches) on the card
against the CPU, through K11 and no K1/K5/K6. The q8v3 container: K12 per
input row against its plain version at M = 1, 3 and 8 (the GEMV) and every
width of its wgmma tiles with its ragged edge (M = 9 ... 1024), groups 16
and 32 with and without mins, a ragged N and a small N with a long K (the
cluster K split), a layer of a stack, three launches with the same bits; K4 in the "headmajor" and "merged" layouts (bf16 and int8, D = 64,
128 and 256 with softcap and window) against the plain version and
against "full" on the same values; and a tiny hidden-2048 Q8_0 model under
NFAI_Q8V3=1 with each layout, dense and paged, on the card against the CPU,
through K12 and K4-hm / K4 "merged" only. K2's and K7's split kernel
(clusters of 1-16 blocks over a row's keys) at every head width, GQA ratio
1-8, bf16 and int8, with and without softcap and window, on a narrow and a
wide grid of a 4096-slot cache or pool (K7 at page sizes 16 and 128), per
(row, head) and with the same bits on three launches; K7 through tables
and K2 over the same keys give the same bits. The K/V store (dense decode
step and prefill chunk, paged decode and chunk at page sizes 16 and 128,
bf16 and int8, head widths 64, 128 and 256, a dropped row in every case)
equals its plain version run on the CPU bit for bit, one launch a call,
and refuses a head width, a row type or an alignment it does not take;
K3's contract on the store's copy body holds at row widths on both sides
of its 512-byte split, bf16 and int8, exactly. The OpenAI sampling options
(bias, penalties, logprobs) in decode_loop on the card, with no host sync,
against the CPU (tokens up to a near-tie); a ChatSession saved, loaded and
continued on the card (bf16 and int8); eval.perplexity on the card against
the CPU (mean NLL within TOL, INT8_TOL on an int8 cache). Speculative and
constrained decoding: K4 at the verify forward's T = 9 (batch 1 and 8,
ragged offsets, a lane frozen at the cache's length, bf16 and int8); the
store dropping a frozen lane's rows (dense chunk mode) and writing only
the sink page through an all-zero table (paged); the verify forward on the
card against the CPU (no host sync, a frozen lane's rows unchanged); the
BatchEngine speculating (dense and paged, greedy equal to plain decoding
up to a near-tie) and serving constrained slots on the card. The qwen2 /
mistral / phi3 instances: K2 and K7 (bf16 and int8, every option) at GQA
ratios 5, 6, 7, 9 and 16 and at head_dim 96, per (row, head) with the same
bits on three launches; the padded query columns neither read into a
result nor written past the real heads (buffers with a NaN tail); K4 at
head_dim 96 ("full" per (token, head) row, "headmajor" the same bits,
"merged" refused); the K/V store at head_dim 96 bit for bit; tiny Q4_K
qwen2 / mistral / phi3 models on the card against the CPU, dense and
paged, bf16 and int8 caches.
"""
import pytest
import torch

from nfai_tpu_torch.ops import fused_decode as fd
from nfai_tpu_torch.ops import fused_mlp as fm
from nfai_tpu_torch.ops import paged_attention as pga
from nfai_tpu_torch.ops import prefill_attention as pa
from nfai_tpu_torch.ops import qmatmul as qm
from nfai_tpu_torch.ops.qtensor import LayerList, Q4Tensor, Q8Tensor

pytestmark = pytest.mark.cuda
TOL = 2e-2
INT8_TOL = 5e-2  # whole models whose devices quantize their own int8 K/V


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU suite runs the plain versions")
    return torch.Generator(device="cuda").manual_seed(0)


def rel(got, want, row_dims=0):
    """max|got - want| / max|want|; with row_dims > 0 the worst of that
    ratio over the rows formed by the leading row_dims axes."""
    got, want = got.float().flatten(row_dims), want.float().flatten(row_dims)
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def _q4_weight(n, k, gen, layers=None):
    lead = () if layers is None else (layers,)
    return Q4Tensor(
        torch.randint(0, 256, (*lead, n, k // 2), dtype=torch.uint8, device="cuda", generator=gen),
        torch.rand(*lead, n, k // 32, device="cuda", generator=gen) * 1e-2,
        torch.rand(*lead, n, k // 32, device="cuda", generator=gen) * 5e-2, k, n,
    )


# every branch of K1: the CUDA-core GEMV (M = 1), the tensor-core GEMV
# (M = 2..8), the wgmma tiles at each width: 16 (M = 9, 16), 32 (M = 24,
# 32), 64 (M = 40, 64) and 128 (M = 100; 256 and 1024 take several row
# tiles), each in both splits (the K split on the small grids of N <=
# 3072, the row split on the head's 1002 blocks); N of the path (wk/wv 512,
# wo 2048, the head 128256), the 3B's K = 3072, a small ragged case (N =
# 192, K = 512) and K % 128 != 0 (K = 1056 and 2080 with a ragged N: the
# tiles copy the scales, the GEMV reads them one by one)
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 24, 32, 40, 64, 100, 256, 1024])
@pytest.mark.parametrize("k,n", [(512, 192), (2048, 512), (2048, 2048), (2048, 128256), (3072, 3072),
                                 (1056, 200), (2080, 1000)])
def test_q4_matmul_kernel(cuda, m, k, n):
    if n == 128256 and m > 256:
        pytest.skip("the head sees one row per sequence: at most 256 at a time")
    w = _q4_weight(n, k, cuda)
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = qm.K1.launches
    got = qm.q4_matmul(x, w)
    assert qm.K1.launches == before + 1
    assert rel(got, qm.matmul_plain(x, w), row_dims=1) < TOL
    assert all(torch.equal(qm.q4_matmul(x, w), got) for _ in range(2))  # no atomics


@pytest.mark.parametrize("m", [8, 64])
def test_q4_matmul_reads_a_layer_in_place(cuda, m):
    w = _q4_weight(1024, 2048, cuda, layers=3)
    x = torch.randn(m, 2048, device="cuda", dtype=torch.bfloat16, generator=cuda)
    layer = w.layer(2)
    assert layer.qs.data_ptr() == w.qs.data_ptr() + 2 * 1024 * 1024
    assert rel(qm.linear_layered(x, w, 2), qm.matmul_plain(x, layer), row_dims=1) < TOL


def test_q4_matmul_refuses_misaligned_tensors(cuda):
    w = _q4_weight(256, 512, cuda)
    x = torch.randn(4 * 512 + 1, device="cuda", dtype=torch.bfloat16, generator=cuda)[1:].view(4, 512)
    with pytest.raises(ValueError, match="16-byte"):
        qm.q4_matmul(x, w)


def test_decode_attention_and_row_write_kernels(cuda):
    l, b, s, hkv, r, d = 2, 3, 128, 2, 4, 64
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, hkv * r, d, **bf)
    kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
    kc, vc = torch.randn(l, b, s, hkv * d, **bf), torch.randn(l, b, s, hkv * d, **bf)
    starts = torch.tensor([0, 77, s - 1], device="cuda", dtype=torch.int32)
    got = fd.layered_decode_attention(q, kn, vn, kc, vc, 1, starts)
    want = fd.decode_attention_plain(q, kn, vn, kc[1], vc[1], starts, d**-0.5)
    assert rel(got, want, row_dims=1) < TOL
    rows = torch.randn(l, b, hkv * d, **bf)
    starts_w = torch.tensor([3, s, 5], device="cuda", dtype=torch.int32)
    ref = fd.write_all_layers_plain(kc.clone(), rows, starts_w)
    assert torch.equal(fd.write_all_layers(kc.clone(), rows, starts_w), ref)


# every shape class of K4's wgmma kernel: D 64 and 128 (one consumer group
# a block on the narrow grid of 2 rows x 2 kv heads, two where the wide
# grid of 8 x 8 and a long chunk give blocks for every SM) and 256 (one,
# with and without softcap / window), GQA ratios 1-8 (r = 3: padding rows;
# at T = 128 and 256 on the wide grid the last block's second group has no
# real row), chunks of 1 to 256 tokens (17: a ragged tile), offsets 0, 40
# and 700 (tiles skipped, the diagonal crossing a tile), a batch row at half
# the offset; bf16 and int8 (codes and scales from quantize_kv); per
# (token, head) row against the plain version, the same bits on three
# launches
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("offset", [0, 40, 700])
@pytest.mark.parametrize("t", [1, 16, 17, 64, 128, 256])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,hkv", [(2, 2), (8, 8)], ids=["narrow", "wide"])
def test_prefill_attention_kernel(cuda, b, hkv, d, r, t, offset, quant):
    from nfai_tpu_torch.models.llama import quantize_kv

    s = 1024
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, t, hkv * r, d, **bf) * 2
    kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
        sc = dict(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    offs = torch.tensor([offset, offset // 2] * (b // 2), device="cuda", dtype=torch.int32)
    kernel = pa.K4_I8 if quant else pa.K4
    for cap, win in ((0.0, 0), (50.0, 96)) if d == 256 else ((0.0, 0),):
        before = kernel.launches
        got = pa.flash_prefill_attention(q, kc, vc, offs, softcap=cap, window=win, **sc)
        assert kernel.launches == before + 1
        want = pa.flash_prefill_attention_plain(q, kc, vc, offs, d**-0.5, sc.get("k_scales"),
                                                sc.get("v_scales"), cap, win)
        assert rel(got, want, row_dims=3) < (INT8_TOL if quant else TOL), (cap, win)
        assert all(torch.equal(pa.flash_prefill_attention(q, kc, vc, offs, softcap=cap, window=win, **sc),
                               got) for _ in range(2))  # no atomics


def test_tiny_model_cuda_matches_cpu(cuda, tmp_path):
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    path = make_tiny_llama_gguf(tmp_path / "t.gguf", hidden=256, n_heads=4, n_kv_heads=2,
                                ffn_dim=512, vocab_size=512, quant=GGMLType.Q4_K, tied=False)
    cfg = EngineConfig(max_seq_len=256)
    gpu = InferenceEngine(path, cfg, device="cuda")
    cpu = InferenceEngine(path, cfg, device="cpu")
    ids = cpu.tokenizer.encode("a short prompt for both devices")
    lg, _ = gpu.prefill(gpu.new_cache(1), ids)
    lc, _ = cpu.prefill(cpu.new_cache(1), ids)
    assert rel(lg.cpu(), lc) < TOL
    out = list(gpu.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=8)))
    assert len(out) > 0


def _q8_weight(n, k, group, with_mins, gen, layers=None):
    """Codes over the whole int8 range, so an inexact decode of any byte fails."""
    lead = () if layers is None else (layers,)
    return Q8Tensor(
        torch.randint(-128, 128, (*lead, n, k), dtype=torch.int8, device="cuda", generator=gen),
        torch.rand(*lead, n, k // group, device="cuda", generator=gen) * 1e-2,
        torch.rand(*lead, n, k // group, device="cuda", generator=gen) * 5e-2 if with_mins else None,
        k, n, group,
    )


# every branch of K6: the CUDA-core GEMV (M = 1), the tensor-core GEMV
# (M = 2..8), the wgmma tiles at each width: 16 (M = 9, 16), 32 (M = 24,
# 32), 64 (M = 40, 64) and 128 (M = 100; 256 and 1024 take several row
# tiles), each in both splits (the K split on the small grids of N <=
# 2048, the row split on the head's 1002 blocks); N of the path (wv 512,
# w_down 2048, the head 128256), K = 2048, 8192 (w_down) and 2304 (Gemma's
# hidden), and K % 128 != 0 with a ragged N (K = 1056, N = 200: the tiles'
# last stage is short, their g32 scales come by cp.async); scale groups of
# 32 and 16, with and without mins
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 24, 32, 40, 64, 100, 256, 1024])
@pytest.mark.parametrize("k,n", [(2048, 512), (8192, 2048), (2304, 2048), (2048, 128256),
                                 (1056, 200)])
@pytest.mark.parametrize("group,with_mins", [(32, False), (16, False), (32, True), (16, True)])
def test_q8_matmul_kernel(cuda, m, k, n, group, with_mins):
    if n == 128256 and m > 256:
        pytest.skip("the head sees one row per sequence: at most 256 at a time")
    w = _q8_weight(n, k, group, with_mins, cuda)
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = qm.K6.launches
    got = qm.q8_matmul(x, w)
    assert qm.K6.launches == before + 1
    assert rel(got, qm.matmul_plain(x, w), row_dims=1) < TOL
    assert all(torch.equal(qm.q8_matmul(x, w), got) for _ in range(2))  # no atomics


def test_q8_matmul_refuses_misaligned_tensors(cuda):
    w = _q8_weight(256, 512, 32, False, cuda)
    x = torch.randn(4 * 512 + 1, device="cuda", dtype=torch.bfloat16, generator=cuda)[1:].view(4, 512)
    with pytest.raises(ValueError, match="16-byte"):
        qm.q8_matmul(x, w)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_q8_matmul_reads_a_layer_in_place(cuda, m):
    """A layer of a stacked Q8Tensor is a view into the stack; a LayerList's
    Q6_K layer (a Q4_K_M mix) is its own tensor: both multiply in place."""
    w = _q8_weight(1024, 2048, 16, False, cuda, layers=3)
    x = torch.randn(m, 2048, device="cuda", dtype=torch.bfloat16, generator=cuda)
    layer = w.layer(2)
    assert layer.qs.data_ptr() == w.qs.data_ptr() + 2 * 1024 * 2048
    assert layer.scales.data_ptr() == w.scales.data_ptr() + 2 * 1024 * 128 * 4
    assert rel(qm.linear_layered(x, w, 2), qm.matmul_plain(x, layer), row_dims=1) < TOL
    q6 = _q8_weight(1024, 2048, 16, False, cuda)
    mixed = LayerList([_q4_weight(1024, 2048, cuda), q6, _q4_weight(1024, 2048, cuda)])
    before = qm.K6.launches
    got = qm.linear_layered(x, mixed, 1)
    assert qm.K6.launches == before + 1
    assert rel(got, qm.matmul_plain(x, q6), row_dims=1) < TOL


# K5 at the edges of its regimes: the decode kernel at 1, 2, 8 (one n8
# fragment), 9, 16 (two), the tiles at 17, 40, 64, 200 (widths 32, 64, 64,
# 128); F = 256 is one F slice of the decode kernel's down product (4
# blocks) and of the tiles' (ks 1), 1280 five (20 blocks; ks 2); F = 8704
# is more blocks than an H100's SMs, so the tiles take every row count
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 40, 64, 200])
@pytest.mark.parametrize("f", [256, 1280, 8704])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_kernel(cuda, m, f, act):
    k, h = 256, 256

    def q4(n, kk):
        return Q4Tensor(
            torch.randint(0, 256, (n, kk // 2), dtype=torch.uint8, device="cuda", generator=cuda),
            torch.rand(n, kk // 32, device="cuda", generator=cuda) * 1e-2,
            torch.rand(n, kk // 32, device="cuda", generator=cuda) * 7e-2, kk, n,
        )

    gu, dn = q4(2 * f, k), q4(h, f)
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = fm.K5.launches
    got = fm.fused_mlp(x, gu, dn, act)
    assert fm.K5.launches == before + 1
    assert rel(got, fm.fused_mlp_plain(x, gu, dn, act), row_dims=1) < TOL
    assert all(torch.equal(fm.fused_mlp(x, gu, dn, act), got) for _ in range(2))


@pytest.mark.parametrize("kind", ["fused", "q4_k_m", "q8_0", "q4_0_tied"])
def test_tiny_kinds_cuda_match_cpu(cuda, tmp_path, kind):
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.testing import make_tiny_llama_gguf, use_more_bits

    narrow = dict(hidden=256, n_heads=4, n_kv_heads=2, ffn_dim=512, vocab_size=512)
    args = {
        "fused": dict(hidden=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024, vocab_size=512,
                      quant=GGMLType.Q4_K, tied=False, scale=0.01),
        "q4_k_m": dict(narrow, quant=GGMLType.Q4_K, tied=True, quant_overrides={
            "token_embd.weight": GGMLType.Q6_K,
            **{f"blk.{i}.{t}.weight": GGMLType.Q6_K for i in range(2) if use_more_bits(i, 2)
               for t in ("attn_v", "ffn_down")}}),
        "q8_0": dict(narrow, quant=GGMLType.Q8_0, tied=False),
        "q4_0_tied": dict(narrow, quant=GGMLType.Q4_0, tied=True),
    }[kind]
    path = make_tiny_llama_gguf(tmp_path / f"{kind}.gguf", **args)
    cfg = EngineConfig(max_seq_len=256)
    gpu = InferenceEngine(path, cfg, device="cuda")
    cpu = InferenceEngine(path, cfg, device="cpu")
    assert gpu.params["fused_mlp"] == (kind == "fused")
    ids = cpu.tokenizer.encode("a short prompt for both devices")
    before = fm.K5.launches, qm.K6.launches
    lg, _ = gpu.prefill(gpu.new_cache(1), ids)
    lc, _ = cpu.prefill(cpu.new_cache(1), ids)
    assert (fm.K5.launches > before[0]) == (kind == "fused")
    assert (qm.K6.launches > before[1]) == (kind in ("q4_k_m", "q8_0"))
    assert rel(lg.cpu(), lc) < TOL


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("r", [1, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_attention_kernel(cuda, d, ps, r):
    b, hkv, n_p = 5, 2, 256 // ps
    n_pages = b * n_p + 3
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, hkv * r, d, **bf)
    kp, vp = torch.randn(hkv, n_pages, ps, d, **bf), torch.randn(hkv, n_pages, ps, d, **bf)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(ps))[: b * n_p] + 1
    tables = perm.view(b, n_p).to(torch.int32).cuda()  # shuffled, never contiguous
    lengths = torch.tensor([1, ps - 1, ps, ps + 1, n_p * ps], dtype=torch.int32, device="cuda")
    before = pga.K7.launches
    got = pga.paged_decode_attention(q, kp, vp, tables, lengths)
    assert pga.K7.launches == before + 1
    want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5)
    assert rel(got, want, row_dims=1) < TOL


# K2's and K7's split kernel (csrc/decode_attn.cuh) on every instance: D 64,
# 128 and 256, r 1, 2, 3, 4 and 8, bf16 and int8 (codes and scales from
# quantize_kv), without options, with softcap 50 and with window 512; on a
# narrow grid (8 rows x 1 kv head: clusters of 16 blocks) and a wide one (8
# x 8: clusters of 2) of a 4096-slot cache or pool; K2's rows hold 0 (only
# the new token), 1, 63, 64, 65, 1024 (one tile a block at 16), 4000 and
# 4096 (a full cache) old keys, K7's rows 1, 63, 64, 65, 777, 1024, 4000 and
# 4096 keys at page sizes 16 and 128 on shuffled tables. Per (row, head)
# against the plain version, one counter step a call, the same bits on
# three launches.
DECODE_STARTS = [0, 1, 63, 64, 65, 1024, 4000, 4096]
PAGED_LENGTHS = [1, 63, 64, 65, 777, 1024, 4000, 4096]
SPLIT_OPTIONS = dict(argnames="cap,win", argvalues=[(0.0, 0), (50.0, 0), (0.0, 512)],
                     ids=["plain", "softcap", "window"])


@pytest.mark.parametrize(**SPLIT_OPTIONS)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,hkv", [(8, 1), (8, 8)], ids=["narrow", "wide"])
def test_decode_attention_split_kernel(cuda, b, hkv, d, r, quant, cap, win):
    from nfai_tpu_torch.models.llama import quantize_kv

    s = 4096
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
        sc = dict(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    q = torch.randn(b, hkv * r, d, **bf) * (3 if cap else 1)
    kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
    starts = torch.tensor(DECODE_STARTS, device="cuda", dtype=torch.int32)
    kernel = fd.K2_I8 if quant else fd.K2

    def run():
        return fd.decode_attention(q, kn, vn, kc, vc, starts, softcap=cap, window=win, **sc)

    before = kernel.launches
    got = run()
    assert kernel.launches == before + 1
    want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, d**-0.5, sc.get("k_scales"),
                                     sc.get("v_scales"), cap, win)
    assert rel(got, want, row_dims=2) < TOL
    assert all(torch.equal(run(), got) for _ in range(2))  # no atomics


@pytest.mark.parametrize(**SPLIT_OPTIONS)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("b,hkv", [(8, 1), (8, 8)], ids=["narrow", "wide"])
def test_paged_attention_split_kernel(cuda, b, hkv, d, r, ps, quant, cap, win):
    from nfai_tpu_torch.models.llama import quantize_kv

    n_p = 4096 // ps
    n_pages = b * n_p + 3
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    kp, vp = torch.randn(hkv, n_pages, ps, d, **bf), torch.randn(hkv, n_pages, ps, d, **bf)
    sc = {}
    if quant:  # one scale a (kv head, token): the pool's rows as one head each
        (kp, ks), (vp, vs) = quantize_kv(kp, 1), quantize_kv(vp, 1)
        sc = dict(k_scales=ks[..., 0].contiguous(), v_scales=vs[..., 0].contiguous())
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(ps + d + r))[: b * n_p] + 1
    tables = perm.view(b, n_p).to(torch.int32).cuda()  # shuffled, never contiguous
    lengths = torch.tensor(PAGED_LENGTHS, device="cuda", dtype=torch.int32)
    q = torch.randn(b, hkv * r, d, **bf) * (3 if cap else 1)
    kernel = pga.K7_I8 if quant else pga.K7

    def run():
        return pga.paged_decode_attention(q, kp, vp, tables, lengths, softcap=cap, window=win, **sc)

    before = kernel.launches
    got = run()
    assert kernel.launches == before + 1
    want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5, sc.get("k_scales"),
                                            sc.get("v_scales"), cap, win)
    assert rel(got, want, row_dims=2) < TOL
    assert all(torch.equal(run(), got) for _ in range(2))  # no atomics


@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_and_dense_decode_attention_agree_bit_for_bit(cuda, d):
    """K7 through shuffled tables and K2 over the same keys as a dense
    cache, the row's last key as K2's new token: the same split, tiles and
    merge, so the same bits (the server's paged and dense decode agree)."""
    b, hkv, r, ps, n_p = 4, 2, 4, 128, 8
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    n_pages = b * n_p + 1
    kp, vp = torch.randn(hkv, n_pages, ps, d, **bf), torch.randn(hkv, n_pages, ps, d, **bf)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(d))[: b * n_p] + 1
    tables = perm.view(b, n_p).to(torch.int32).cuda()
    lengths = torch.tensor([300, 137, 77, n_p * ps], device="cuda", dtype=torch.int32)
    q = torch.randn(b, hkv * r, d, **bf)
    got = pga.paged_decode_attention(q, kp, vp, tables, lengths)
    kc, vc = (pga.gather_pages(x, tables).permute(1, 2, 0, 3).reshape(b, n_p * ps, hkv * d).contiguous()
              for x in (kp, vp))
    starts = (lengths - 1).contiguous()
    rows = torch.arange(b, device="cuda")
    kn, vn = kc[rows, starts.long()].contiguous(), vc[rows, starts.long()].contiguous()
    assert torch.equal(got, fd.decode_attention(q, kn, vn, kc, vc, starts))


def test_paged_batch_engine_on_the_card(cuda, tmp_path):
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    path = make_tiny_llama_gguf(tmp_path / "t.gguf", hidden=256, n_heads=4, n_kv_heads=1,
                                ffn_dim=512, vocab_size=512, quant=GGMLType.Q4_K, tied=False,
                                context_length=512)
    engine = InferenceEngine(path, EngineConfig(max_seq_len=256, page_size=16, prefill_chunk=64))
    be = BatchEngine(engine, max_batch=4, decode_chunk=4)
    before = pga.K7.launches, fd.K2.launches, fd.K3.launches
    reqs = [be.submit(list(range(5, 5 + n)), SamplingParams(temperature=0.0, max_new_tokens=12))
            for n in (7, 30, 70, 140, 9)]
    for _ in range(300):
        if be.step() == 0 and be.queue.empty():
            break
    assert all(r.state == RequestState.FINISHED and r.output_ids for r in reqs)
    assert pga.K7.launches > before[0]
    assert (fd.K2.launches, fd.K3.launches) == before[1:]


@pytest.mark.parametrize("r", [3, 8])
def test_attention_kernels_head_dim_128(cuda, r):
    b, s, hkv, d = 3, 192, 2, 128
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, hkv * r, d, **bf)
    kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
    kc, vc = torch.randn(1, b, s, hkv * d, **bf), torch.randn(1, b, s, hkv * d, **bf)
    starts = torch.tensor([0, 77, s - 1], device="cuda", dtype=torch.int32)
    got = fd.layered_decode_attention(q, kn, vn, kc, vc, 0, starts)
    assert rel(got, fd.decode_attention_plain(q, kn, vn, kc[0], vc[0], starts, d**-0.5), 1) < TOL
    qp = torch.randn(b, 40, hkv * r, d, **bf)
    offs = torch.tensor([0, 60, 100], device="cuda", dtype=torch.int32)
    got = pa.flash_prefill_attention(qp, kc[0], vc[0], offs)
    assert rel(got, pa.flash_prefill_attention_plain(qp, kc[0], vc[0], offs, d**-0.5), 2) < TOL
    kp, vp = torch.randn(hkv, 20, 16, d, **bf), torch.randn(hkv, 20, 16, d, **bf)
    tables = (torch.randperm(19, generator=torch.Generator().manual_seed(0))[:12] + 1).view(b, 4)
    tables = tables.to(torch.int32).cuda()
    lengths = torch.tensor([1, 17, 64], dtype=torch.int32, device="cuda")
    got = pga.paged_decode_attention(q, kp, vp, tables, lengths)
    assert rel(got, pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5), 1) < TOL


def _expert_stack(cuda, kind, e, n, k):
    if kind == "q4":
        return Q4Tensor(torch.randint(0, 256, (e, n, k // 2), dtype=torch.uint8, device="cuda",
                                      generator=cuda),
                        torch.rand(e, n, k // 32, device="cuda", generator=cuda) * 1e-2,
                        torch.rand(e, n, k // 32, device="cuda", generator=cuda) * 5e-2, k, n)
    g = 32 if kind.startswith("q8_g32") else 16
    return Q8Tensor(torch.randint(-32, 32, (e, n, k), dtype=torch.int8, device="cuda", generator=cuda),
                    torch.rand(e, n, k // g, device="cuda", generator=cuda) * 1e-2,
                    torch.rand(e, n, k // g, device="cuda", generator=cuda) * 5e-2
                    if kind.endswith("mins") else None, k, n, g)


def _check_grouped(cuda, w, flat, e, tm):
    """One launch of K8 / K9 on a routing laid out as moe_ffn lays it out,
    x random on the padding rows too: per routed row against the plain
    version, zeros on every other row, the same bits on three launches."""
    from nfai_tpu_torch.models.llama import moe_group_layout

    order, dst, bg, br, m_pad = moe_group_layout(flat, flat.numel(), e, tm)
    x = torch.randn(m_pad, w.k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    counter = qm.K8 if isinstance(w, Q4Tensor) else qm.K9
    before = counter.launches
    got = qm.qmatmul_grouped(x, w, bg, tm, br)
    assert counter.launches == before + 1
    want = qm.qmatmul_grouped_plain(x, w, bg, tm, br)
    assert rel(got[dst], want[dst], row_dims=1) < TOL
    routed = torch.zeros(m_pad, dtype=torch.bool, device="cuda")
    routed[dst] = True
    assert not got[~routed].any() and bool((got[routed].float().abs().sum(-1) > 0).all())
    for _ in range(2):
        assert torch.equal(qm.qmatmul_grouped(x, w, bg, tm, br), got)
    return bg, br


@pytest.mark.parametrize("n,k", [(256, 512), (192, 544)], ids=["K512", "K544-N192"])
@pytest.mark.parametrize("tm", [8, 32, 128])
@pytest.mark.parametrize("kind", ["q4", "q8_g32", "q8_g16_mins", "q8_g32_mins", "q8_g16"])
def test_grouped_matmul_kernels(cuda, tm, kind, n, k):
    """An empty expert (0), a block with exactly tm real rows and a partial
    one (expert 2), the clipped empty tail blocks; K = 544 has scale rows
    that are not 16-byte strided and N = 192 a last weight tile that runs
    past the expert's rows."""
    e = 4
    w = _expert_stack(cuda, kind, e, n, k)
    flat = torch.tensor([1, 2, 2, 3] + [2] * (tm + 2) + [1, 1], device="cuda")  # expert 0 empty
    bg, br = _check_grouped(cuda, w, flat, e, tm)
    assert bool((br == tm).any()) and bool((br == 0).any()) and int(bg[-1]) == e - 1


@pytest.mark.parametrize("tokens", [1, 8, 256, 1024], ids=["batch1", "batch8", "prefill256", "8x128"])
@pytest.mark.parametrize("kind,n,k", [("q4", 768, 2048), ("q4", 2048, 768), ("q8_g16", 2048, 768)],
                         ids=["K8-gate", "K8-down", "K9-Q6_K-down"])
def test_grouped_matmul_model_c_layouts(cuda, kind, n, k, tokens):
    """Model C's widths (128 experts, 8 a token; gate/up K = 2048, N = 768,
    down K = 768, N = 2048) at the layouts moe_ffn gives a batch-1 and a
    batch-8 decode step (tm 8), a 256-token chunk (tm 32) and the 8 x 128
    prefill (tm 128)."""
    from nfai_tpu_torch.models.llama import group_tm

    e, used = 128, 8
    w = _expert_stack(cuda, kind, e, n, k)
    flat = torch.rand(tokens, e, device="cuda", generator=cuda).argsort(-1)[:, :used].reshape(-1)
    _check_grouped(cuda, w, flat, e, group_tm(flat.numel()))


@pytest.mark.parametrize("d,r", [(64, 4), (128, 3), (128, 8)])
def test_int8_attention_kernels(cuda, d, r):
    from nfai_tpu_torch.models.llama import quantize_kv

    b, s, hkv = 3, 192, 2
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)

    def codes(*lead):  # int8 codes [*lead, Hkv*D] and scales [*lead, Hkv]
        return quantize_kv(torch.randn(*lead, hkv * d, **bf), hkv)

    (kc, ks), (vc, vs) = codes(b, s), codes(b, s)
    ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()  # [B, Hkv, S]
    q = torch.randn(b, hkv * r, d, **bf)
    kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
    starts = torch.tensor([0, 77, s - 1], device="cuda", dtype=torch.int32)
    before = fd.K2_I8.launches, fd.K2.launches
    got = fd.decode_attention(q, kn, vn, kc, vc, starts, k_scales=ks, v_scales=vs)
    assert (fd.K2_I8.launches, fd.K2.launches) == (before[0] + 1, before[1])
    want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, d**-0.5, ks, vs)
    assert rel(got, want, row_dims=1) < TOL
    qp = torch.randn(b, 40, hkv * r, d, **bf)
    offs = torch.tensor([0, 60, 100], device="cuda", dtype=torch.int32)
    before = pa.K4_I8.launches
    got = pa.flash_prefill_attention(qp, kc, vc, offs, k_scales=ks, v_scales=vs)
    assert pa.K4_I8.launches == before + 1
    want = pa.flash_prefill_attention_plain(qp, kc, vc, offs, d**-0.5, ks, vs)
    assert rel(got, want, row_dims=2) < TOL
    n_pages, ps = 20, 16
    (kq, kps), (vq, vps) = codes(n_pages, ps), codes(n_pages, ps)
    kp = kq.view(n_pages, ps, hkv, d).permute(2, 0, 1, 3).contiguous()
    vp = vq.view(n_pages, ps, hkv, d).permute(2, 0, 1, 3).contiguous()
    kps, vps = kps.permute(2, 0, 1).contiguous(), vps.permute(2, 0, 1).contiguous()  # [Hkv, P, ps]
    tables = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(1))[:12] + 1)
    tables = tables.view(b, 4).to(torch.int32).cuda()
    lengths = torch.tensor([1, 17, 64], dtype=torch.int32, device="cuda")
    before = pga.K7_I8.launches, pga.K7.launches
    got = pga.paged_decode_attention(q, kp, vp, tables, lengths, k_scales=kps, v_scales=vps)
    assert (pga.K7_I8.launches, pga.K7.launches) == (before[0] + 1, before[1])
    want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5, kps, vps)
    assert rel(got, want, row_dims=1) < TOL


def test_scale_write_kernel(cuda):
    l, b, h, s = 3, 5, 4, 100
    arr = torch.randn(l, b, h, s, device="cuda", generator=cuda)
    rows = torch.randn(l, b, h, device="cuda", generator=cuda)
    starts = torch.tensor([0, 37, s - 1, s, -1], device="cuda", dtype=torch.int32)  # the last two dropped
    before = fd.K10.launches
    got = fd.write_all_layers_t(arr.clone(), rows, starts)
    assert fd.K10.launches == before + 1
    assert torch.equal(got, fd.write_all_layers_t_plain(arr.clone(), rows, starts))
    assert torch.equal(got[:, 3:], arr[:, 3:])


def test_tiny_int8_engine_cuda_matches_cpu(cuda, tmp_path):
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.models import decode_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    path = make_tiny_llama_gguf(tmp_path / "t.gguf", hidden=256, n_heads=4, n_kv_heads=2,
                                ffn_dim=512, vocab_size=512, quant=GGMLType.Q4_K, tied=False)
    cfg = EngineConfig(max_seq_len=256, kv_dtype="int8", page_size=16, prefill_chunk=64)
    gpu, cpu = InferenceEngine(path, cfg, device="cuda"), InferenceEngine(path, cfg, device="cpu")
    ids = cpu.tokenizer.encode("a short prompt for both devices")
    from nfai_tpu_torch.ops import kv_store as kvs

    # the K/V store writes every row (K3 and K10 in their own contracts run on no path)
    counters = (fd.K2, fd.K2_I8, kvs.KV_STORE, kvs.KV_STORE_PAGED, pa.K4, pa.K4_I8, pga.K7, pga.K7_I8,
                fd.K3, fd.K10)
    before = [k.launches for k in counters]
    # each device quantizes its own K/V, and a code flips by one step where
    # the two bf16 values straddle a rounding point: the int8 rule (5e-2 of
    # the logit scale, the JAX package's int8-vs-bf16 bound) holds between
    # them (2e-2 did not: an H100 sat 2.09e-2 from the CPU at the prefill)
    lg, cg = gpu.prefill(gpu.new_cache(1), ids)
    lc, cc = cpu.prefill(cpu.new_cache(1), ids)
    assert cg.quantized and rel(lg.cpu(), lc) < INT8_TOL
    pos = len(ids)
    for tok in (17, 99):
        lg, cg = decode_step(gpu.params, gpu.model_cfg, torch.tensor([tok], device="cuda"),
                             torch.tensor([pos], device="cuda"), cg)
        lc, cc = decode_step(cpu.params, cpu.model_cfg, torch.tensor([tok]), torch.tensor([pos]), cc)
        assert rel(lg.cpu(), lc) < INT8_TOL
        pos += 1
    dense = [k.launches - b for k, b in zip(counters, before)]
    # no bf16 attention, no paged kernel, no K3 / K10
    assert dense[0] == dense[3] == dense[4] == dense[6] == dense[7] == dense[8] == dense[9] == 0
    assert min(dense[1], dense[2], dense[5]) > 0
    before = [k.launches for k in counters]
    be = BatchEngine(gpu, max_batch=2, decode_chunk=4)
    reqs = [be.submit(list(range(5, 5 + n)), SamplingParams(temperature=0.0, max_new_tokens=8))
            for n in (7, 70, 9)]
    for _ in range(200):
        if be.step() == 0 and be.queue.empty():
            break
    assert all(r.state == RequestState.FINISHED and r.output_ids for r in reqs)
    paged = [k.launches - b for k, b in zip(counters, before)]
    # the paged store, K7 int8 at decode, K4 bf16 on the dequantized pages
    assert paged[3] > 0 and paged[7] > 0 and paged[4] > 0
    assert paged[0] == paged[1] == paged[2] == paged[5] == paged[6] == paged[8] == paged[9] == 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_gemma_attention_kernels_head_dim_256(cuda, r, quant):
    """K2, K4, K7 at D = 256 with softcap 50 and window 96 (and each option
    alone on K2), per row against the plain versions; the launches are
    tallied under their variant."""
    from nfai_tpu_torch.models.llama import quantize_kv

    b, s, hkv, d, cap, win = 3, 320, 2 if r < 8 else 1, 256, 50.0, 96
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)

    def cache(*lead):  # (values, k_scales-style time-minor scales or None)
        x = torch.randn(*lead, hkv * d, **bf) * 3
        if not quant:
            return x, None
        c, sc = quantize_kv(x, hkv)
        return c, sc.transpose(-1, -2).contiguous()

    (kc, ks), (vc, vs) = cache(b, s), cache(b, s)
    sc = dict(k_scales=ks, v_scales=vs) if quant else {}
    q = torch.randn(b, hkv * r, d, **bf) * 3
    kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
    starts = torch.tensor([0, 77, s - 1], device="cuda", dtype=torch.int32)
    k2 = fd.K2_I8 if quant else fd.K2
    for cap_, win_ in ((cap, win), (cap, 0), (0.0, win)):
        before = k2.variants[fd.variant(d, cap_, win_)]
        got = fd.decode_attention(q, kn, vn, kc, vc, starts, softcap=cap_, window=win_, **sc)
        assert k2.variants[fd.variant(d, cap_, win_)] == before + 1
        want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, d**-0.5, ks, vs, cap_, win_)
        assert rel(got, want, 1) < TOL, (cap_, win_)
    qp = torch.randn(b, 130, hkv * r, d, **bf) * 3
    offs = torch.tensor([0, 60, 190], device="cuda", dtype=torch.int32)
    got = pa.flash_prefill_attention(qp, kc, vc, offs, softcap=cap, window=win, **sc)
    want = pa.flash_prefill_attention_plain(qp, kc, vc, offs, d**-0.5, ks, vs, cap, win)
    assert rel(got, want, 2) < TOL
    n_pages, ps = 30, 16
    (kq, kps), (vq, vps) = cache(n_pages, ps), cache(n_pages, ps)
    kp = kq.view(n_pages, ps, hkv, d).permute(2, 0, 1, 3).contiguous()
    vp = vq.view(n_pages, ps, hkv, d).permute(2, 0, 1, 3).contiguous()
    psc = {}
    if quant:
        kps, vps = kps.transpose(-1, -2), vps.transpose(-1, -2)  # back to [P, ps, Hkv]
        psc = dict(k_scales=kps.permute(2, 0, 1).contiguous(), v_scales=vps.permute(2, 0, 1).contiguous())
    tables = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(2))[:27] + 1)
    tables = tables.view(b, 9).to(torch.int32).cuda()
    lengths = torch.tensor([1, 17, 140], dtype=torch.int32, device="cuda")
    got = pga.paged_decode_attention(q, kp, vp, tables, lengths, softcap=cap, window=win, **psc)
    want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5,
                                            psc.get("k_scales"), psc.get("v_scales"), cap, win)
    assert rel(got, want, 1) < TOL


@pytest.mark.parametrize("m", [1, 8, 256])
def test_fused_mlp_is_deterministic(cuda, m):
    """K5 sums its F-tile partials in a fixed order: repeated launches on the
    same inputs give the same bits."""
    k, f, h = 1024, 2048, 1024
    gu = Q4Tensor(torch.randint(0, 256, (2 * f, k // 2), dtype=torch.uint8, device="cuda", generator=cuda),
                  torch.rand(2 * f, k // 32, device="cuda", generator=cuda) * 2e-3,
                  torch.rand(2 * f, k // 32, device="cuda", generator=cuda) * 1.5e-2, k, 2 * f)
    dn = Q4Tensor(torch.randint(0, 256, (h, f // 2), dtype=torch.uint8, device="cuda", generator=cuda),
                  torch.rand(h, f // 32, device="cuda", generator=cuda) * 2e-3,
                  torch.rand(h, f // 32, device="cuda", generator=cuda) * 1.5e-2, f, h)
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    first = fm.fused_mlp(x, gu, dn)
    for _ in range(4):
        assert torch.equal(fm.fused_mlp(x, gu, dn), first)
    assert rel(first, fm.fused_mlp_plain(x, gu, dn), 1) < TOL


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_tiny_gemma_cuda_matches_cpu(cuda, tmp_path, kv_dtype):
    """A tiny gemma2 (head_dim 256, softcaps, window 8 under a 30-token
    prompt) on the card against the CPU, dense then through a paged
    BatchEngine: K2/K4 and K7 run with softcap and window."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.models import decode_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    path = make_tiny_llama_gguf(tmp_path / "g.gguf", arch="gemma2", hidden=256, n_heads=4,
                                n_kv_heads=2, key_length=256, ffn_dim=512, vocab_size=512,
                                post_norms=True, sliding_window=8, attn_softcap=50.0,
                                final_softcap=30.0, quant=GGMLType.Q4_K, scale=0.02)
    cfg = EngineConfig(max_seq_len=256, kv_dtype=kv_dtype, page_size=16, prefill_chunk=64)
    gpu, cpu = InferenceEngine(path, cfg, device="cuda"), InferenceEngine(path, cfg, device="cpu")
    tol = INT8_TOL if kv_dtype == "int8" else TOL
    ids = list(range(5, 35))
    k2 = fd.K2_I8 if kv_dtype == "int8" else fd.K2
    before = k2.variants[fd.variant(256, 50.0, 8)]
    lg, cg = gpu.prefill(gpu.new_cache(1), ids)
    lc, cc = cpu.prefill(cpu.new_cache(1), ids)
    assert rel(lg.cpu(), lc) < tol
    pos = len(ids)
    for tok in (17, 99):
        lg, cg = decode_step(gpu.params, gpu.model_cfg, torch.tensor([tok], device="cuda"),
                             torch.tensor([pos], device="cuda"), cg)
        lc, cc = decode_step(cpu.params, cpu.model_cfg, torch.tensor([tok]), torch.tensor([pos]), cc)
        assert rel(lg.cpu(), lc) < tol
        pos += 1
    assert k2.variants[fd.variant(256, 50.0, 8)] == before + 2  # layer 0 of 2 steps
    k7 = pga.K7_I8 if kv_dtype == "int8" else pga.K7
    before = k7.variants[fd.variant(256, 50.0, 8)]
    be = BatchEngine(gpu, max_batch=2, decode_chunk=4)
    reqs = [be.submit(list(range(5, 5 + n)), SamplingParams(temperature=0.0, max_new_tokens=8))
            for n in (7, 70, 9)]
    for _ in range(200):
        if be.step() == 0 and be.queue.empty():
            break
    assert all(r.state == RequestState.FINISHED and r.output_ids for r in reqs)
    assert k7.variants[fd.variant(256, 50.0, 8)] > before


# M = 1, 3 and 8: the GEMVs. 16, 24 and 32, 40 and 64: the 16-, 32- and
# 64-wide wgmma tiles, with the cluster K split at small N (down 8192 x
# 2048, Gemma-3-1B's 1152 x 1024). 128, 256 and 1024: the 128-wide tiles
# (the two-group split at small N) and the 256-wide ones (gate_up at 256,
# and at 1024 in a grid of more than one wave). 1000 x 130: N % 128 != 0
# and K % 64 != 0 (TMA's zero fill past N and K).
@pytest.mark.parametrize("m", [1, 3, 8, 16, 24, 32, 40, 64, 128, 256, 1024])
@pytest.mark.parametrize("k,n", [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
                                 (1152, 1024), (1000, 130)])
def test_dense_matmul_kernel(cuda, m, k, n):
    w = torch.randn(3, n, k, device="cuda", dtype=torch.bfloat16, generator=cuda) * 0.05
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = qm.K11.launches
    got = qm.dense_matmul_layered(x, w, 2)
    assert qm.K11.launches == before + 1
    assert rel(got, qm.dense_matmul_plain(x, w, 2), row_dims=1) < TOL
    assert torch.equal(qm.dense_matmul_layered(x, w, 2), got)  # no atomics: the same bits


@pytest.mark.parametrize("m", [2, 24])
def test_dense_matmul_kernel_unaligned(cuda, m):
    """x 2 bytes past a 16-byte boundary: the 2-byte-load instantiation."""
    k, n = 512, 192
    w = torch.randn(2, n, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    flat = torch.randn(m * k + 1, device="cuda", dtype=torch.bfloat16, generator=cuda)
    x = flat[1:].view(m, k)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert rel(qm.dense_matmul_layered(x, w, 1), qm.dense_matmul_plain(x, w, 1), row_dims=1) < TOL


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("kind", ["f16", "param_dtype"])
def test_tiny_dense_cuda_matches_cpu(cuda, tmp_path, kind, kv_dtype):
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.models import decode_step, paged_prefill_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    quant = GGMLType.F16 if kind == "f16" else GGMLType.Q4_K
    path = make_tiny_llama_gguf(tmp_path / f"{kind}.gguf", hidden=256, n_heads=4, n_kv_heads=2,
                                ffn_dim=512, vocab_size=512, quant=quant, tied=True)
    cfg = EngineConfig(max_seq_len=256, kv_dtype=kv_dtype, page_size=16,
                       param_dtype="auto" if kind == "f16" else "bfloat16")
    gpu, cpu = InferenceEngine(path, cfg, device="cuda"), InferenceEngine(path, cfg, device="cpu")
    assert gpu.params["embed"] is gpu.params["lm_head"]  # the dense tied table, once
    tol = INT8_TOL if kv_dtype == "int8" else TOL
    ids = cpu.tokenizer.encode("a short prompt for both devices")
    counts = lambda: {k.name: k.launches for k in (qm.K1, qm.K6, fm.K5, qm.K11)}  # noqa: E731
    before = counts()
    lg, _ = gpu.prefill(gpu.new_cache(1), ids)
    lc, _ = cpu.prefill(cpu.new_cache(1), ids)
    assert rel(lg.cpu(), lc) < tol
    quant_pool = kv_dtype == "int8"
    table = torch.tensor([[3, 1, 4, 5]], dtype=torch.int32)  # 64 positions: K4's key tile
    out = {}
    for dev, e in (("cuda", gpu), ("cpu", cpu)):
        pool = PagedKVCache.zeros(e.model_cfg, 6, 16, e.cache_dtype, dev, quantized=quant_pool)
        logits, pool = paged_prefill_step(
            e.params, e.model_cfg, torch.tensor([ids], device=dev), torch.arange(len(ids), device=dev)[None],
            torch.tensor([len(ids) - 1], device=dev), pool, table.to(dev))
        logits, _ = decode_step(e.params, e.model_cfg, torch.tensor([7], device=dev),
                                torch.tensor([len(ids)], device=dev), pool, page_tables=table.to(dev))
        out[dev] = logits
    assert rel(out["cuda"].cpu(), out["cpu"]) < tol
    after = counts()
    assert after["dense_matmul"] > before["dense_matmul"]
    assert all(after[k] == before[k] for k in ("q4_matmul", "q8_matmul", "fused_mlp"))


def _q8v3_weight(n, k, group, with_mins, gen):
    from nfai_tpu_torch.ops.qtensor import to_q8v3_stacked

    qs = torch.randint(-128, 128, (n, k), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(n, k // group, device="cuda", generator=gen) * 1e-3 + 1e-5
    mn = torch.rand(n, k // group, device="cuda", generator=gen) * 1e-2 if with_mins else None
    return to_q8v3_stacked(Q8Tensor(qs, sc, mn, k, n, group))


# every branch of K12: the GEMV (M = 1, 3, 8), the wgmma tiles at each width
# and its ragged edge: 16 (M = 9, 16), 32 (17, 32), 64 (33, 40, 64) and
# 128 (65, 128; 129, 256 and 1024 take several row tiles), at a ragged N
# (1000: the row split, the two-group split at 128) and at a small N with a
# long K (512 x 8192: the K split across a cluster); scale groups of 32 and
# 16, with and without mins
@pytest.mark.parametrize("m,k,n", [(m, 4096, 1000) for m in (1, 3, 8, 9, 16, 17, 32, 33, 40, 64, 65, 128,
                                                                 129, 256, 1024)]
                         + [(m, 8192, 512) for m in (1, 8, 16, 32, 64, 128, 256, 1024)])
@pytest.mark.parametrize("group,with_mins", [(32, False), (32, True), (16, False), (16, True)])
def test_q8v3_matmul_kernel(cuda, m, k, n, group, with_mins):
    w = _q8v3_weight(n, k, group, with_mins, cuda)
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = qm.K12.launches
    got = qm.q8v3_matmul(x, w)
    assert qm.K12.launches == before + 1
    assert rel(got, qm.q8v3_matmul_plain(x, w), row_dims=1) < TOL
    assert all(torch.equal(qm.q8v3_matmul(x, w), got) for _ in range(2))  # no atomics


@pytest.mark.parametrize("m", [8, 256])
def test_q8v3_matmul_reads_a_layer_in_place(cuda, m):
    """A layer of a stacked Q8V3Tensor is a pointer offset into the stack:
    the GEMV and the tiles' TMA maps and scale copies read it in place."""
    from nfai_tpu_torch.ops.qtensor import to_q8v3_stacked

    qs = torch.randint(-128, 128, (3, 256, 2048), dtype=torch.int8, device="cuda", generator=cuda)
    sc = torch.rand(3, 256, 64, device="cuda", generator=cuda) * 1e-3
    w = to_q8v3_stacked(Q8Tensor(qs, sc, None, 2048, 256, 32))
    x = torch.randn(m, 2048, device="cuda", dtype=torch.bfloat16, generator=cuda)
    layer = w.layer(2)
    assert layer.qs.data_ptr() == w.qs.data_ptr() + 2 * 256 * 2048
    assert layer.scales.data_ptr() == w.scales.data_ptr() + 2 * 256 * 64 * 2
    got = qm.linear_layered(x, w, 2)
    assert rel(got, qm.q8v3_matmul_plain(x, layer), row_dims=1) < TOL
    assert all(torch.equal(qm.linear_layered(x, w, 2), got) for _ in range(2))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("layout", ["headmajor", "merged"])
@pytest.mark.parametrize("d,r,softcap,window", [(64, 4, 0.0, 0), (128, 4, 0.0, 0),
                                                (256, 2, 50.0, 96)])
def test_prefill_attention_layouts(cuda, d, r, softcap, window, layout, quant):
    from nfai_tpu_torch.models.llama import quantize_kv

    b, t, s, hkv = 2, 64, 256, 2
    if layout == "merged" and d % 128:
        q = torch.zeros(b, t, hkv * r, d, device="cuda", dtype=torch.bfloat16)
        kc = torch.zeros(b, s, hkv * d, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="merged"):
            pa.flash_prefill_attention(q, kc, kc, torch.zeros(b, dtype=torch.int32, device="cuda"),
                                       kv_layout="merged")
        return
    q = torch.randn(b, t, hkv * r, d, device="cuda", dtype=torch.bfloat16, generator=cuda)
    rows = [torch.randn(b, s, hkv * d, device="cuda", dtype=torch.bfloat16, generator=cuda)
            for _ in range(2)]
    kw = dict(softcap=softcap, window=window)
    if quant:
        (kc, ks), (vc, vs) = (quantize_kv(x, hkv) for x in rows)
        kw.update(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    else:
        kc, vc = rows
    offs = torch.tensor([0, 150], dtype=torch.int32, device="cuda")
    if layout == "headmajor":
        kin, vin = (x.view(b, s, hkv, d).transpose(1, 2).contiguous() for x in (kc, vc))
        kernel = pa.K4_HM_I8 if quant else pa.K4_HM
    else:
        kin, vin = kc, vc
        kernel = pa.K4_I8 if quant else pa.K4
    before = kernel.launches
    got = pa.flash_prefill_attention(q, kin, vin, offs, kv_layout=layout, **kw)
    assert kernel.launches == before + 1
    if layout == "merged":
        assert kernel.variants[f"merged D={d}" + (" softcap window" if softcap else "")] > 0
    plain = pa.flash_prefill_attention_plain(q, kin, vin, offs, d**-0.5, kw.get("k_scales"),
                                             kw.get("v_scales"), softcap, window, layout)
    assert rel(got, plain, row_dims=2) < (INT8_TOL if quant else TOL)
    assert torch.equal(got, pa.flash_prefill_attention(q, kc, vc, offs, **kw))  # as "full"


@pytest.mark.parametrize("layout", ["headmajor", "merged"])
def test_tiny_q8v3_model_cuda_matches_cpu(cuda, tmp_path, monkeypatch, layout):
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.models import decode_step, paged_prefill_step
    from nfai_tpu_torch.models import llama as tllama
    from nfai_tpu_torch.ops.qtensor import Q8V3Tensor
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    path = make_tiny_llama_gguf(tmp_path / "q8v3.gguf", hidden=2048, n_layers=2, n_heads=16,
                                n_kv_heads=4, ffn_dim=2048, vocab_size=512, quant=GGMLType.Q8_0,
                                tied=False, seed=7)
    monkeypatch.setenv("NFAI_Q8V3", "1")
    monkeypatch.setattr(tllama, "_PREFILL_KV_LAYOUT", layout)
    cfg = EngineConfig(max_seq_len=256, page_size=16)
    gpu, cpu = InferenceEngine(path, cfg, device="cuda"), InferenceEngine(path, cfg, device="cpu")
    assert isinstance(gpu.params["lm_head"], Q8V3Tensor)
    assert isinstance(gpu.params["layers"]["wqkv"], Q8V3Tensor)
    kernels = (qm.K1, qm.K6, qm.K11, qm.K12, pa.K4, pa.K4_HM)
    before = {k.name: k.launches for k in kernels}
    ids = cpu.tokenizer.encode("a short prompt for both devices")
    lg, _ = gpu.prefill(gpu.new_cache(1), ids)
    lc, _ = cpu.prefill(cpu.new_cache(1), ids)
    assert rel(lg.cpu(), lc) < TOL
    table = torch.tensor([[3, 1, 4, 5]], dtype=torch.int32)
    out = {}
    for dev, e in (("cuda", gpu), ("cpu", cpu)):
        pool = PagedKVCache.zeros(e.model_cfg, 6, 16, e.cache_dtype, dev)
        logits, pool = paged_prefill_step(
            e.params, e.model_cfg, torch.tensor([ids], device=dev),
            torch.arange(len(ids), device=dev)[None], torch.tensor([len(ids) - 1], device=dev),
            pool, table.to(dev))
        logits, _ = decode_step(e.params, e.model_cfg, torch.tensor([7], device=dev),
                                torch.tensor([len(ids)], device=dev), pool, page_tables=table.to(dev))
        out[dev] = logits
    assert rel(out["cuda"].cpu(), out["cpu"]) < TOL
    got = {k.name: k.launches - before[k.name] for k in kernels}
    attn = "prefill_attention_hm" if layout == "headmajor" else "prefill_attention"
    assert got["q8v3_matmul"] > 0 and got[attn] > 0
    assert all(got[k] == 0 for k in ("q4_matmul", "q8_matmul", "dense_matmul"))
    assert got["prefill_attention" if layout == "headmajor" else "prefill_attention_hm"] == 0


def _same_bits(got, want) -> bool:
    """Bit-for-bit equality of a card tensor with a CPU one (floats as their bits)."""
    got = got.cpu()
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(want.dtype)
    return got.dtype == want.dtype and (got.view(bits).equal(want.view(bits)) if bits else got.equal(want))


def _store_caches(shape, scale_shape, quant, gen):
    """K and V caches (random bf16 rows or int8 codes) and, int8, their scales."""
    if quant:
        caches = [torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
                  for _ in range(2)]
        return caches + [torch.rand(scale_shape, device="cuda", generator=gen) for _ in range(2)]
    return [torch.randn(shape, device="cuda", dtype=torch.bfloat16, generator=gen)
            for _ in range(2)] + [None, None]


# the K/V store on the layer-stacked cache, one launch: a decode step (all
# layers' K and V, T = 1, 4-D caches) and a prefill chunk (one layer, T = 37,
# v a column slice of a fused qkv output); bf16 and int8, every head width,
# ragged starts, a start at S (dropped) and, in the chunk, a tail past S;
# bit for bit against the plain version on the CPU copy of the inputs
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode", ["step", "chunk"])
def test_kv_store_kernel(cuda, d, quant, mode):
    from nfai_tpu_torch.ops import kv_store as kvs

    l, b, s, hkv = 3, 4, 96, 2
    kvd = hkv * d
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    if mode == "step":
        shape, sshape, starts = (l, b, s, kvd), (l, b, hkv, s), [0, 41, s - 1, s]
        k, v = torch.randn(l, b, kvd, **bf) * 4, torch.randn(l, b, kvd, **bf) * 4
    else:
        t = 37
        shape, sshape, starts = (b, s, kvd), (b, hkv, s), [0, 41, s - 20, s]
        qkv = torch.randn(b, t, 3 * kvd, **bf) * 4
        k, v = qkv[..., :kvd].contiguous(), qkv[..., 2 * kvd:]
    starts = torch.tensor(starts, device="cuda", dtype=torch.int32)
    caches = _store_caches(shape, sshape, quant, cuda)
    want = [None if c is None else c.cpu() for c in caches]
    kvs.kv_store_plain(*want[:2], k.cpu(), v.cpu(), starts.cpu(), hkv, *want[2:])
    before = kvs.KV_STORE.launches
    kvs.kv_store(*caches[:2], k, v, starts, hkv, *caches[2:])
    torch.cuda.synchronize()
    assert kvs.KV_STORE.launches == before + 1
    assert all(_same_bits(g, w) for g, w in zip(caches, want) if w is not None)


# the paged store through shuffled block tables: decode (T = 1, ragged
# lengths) and a 37-token chunk across pages, page sizes 16 and 128, bf16
# and int8, every head width; one row's page lies outside the pool (dropped)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t,ps", [(1, 16), (1, 128), (37, 16), (37, 128)])
def test_kv_store_paged_kernel(cuda, d, quant, t, ps):
    from nfai_tpu_torch.ops import kv_store as kvs

    b, hkv, n_p = 4, 2, 4
    n_pages = b * n_p + 3
    tables = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(ps + t))[: b * n_p] + 1)
    tables = tables.view(b, n_p).to(torch.int32)
    span = n_p * ps
    if t == 1:
        positions = torch.tensor([[0], [ps - 1], [ps], [span - 1]], dtype=torch.int32)
    else:
        positions = (torch.arange(t, dtype=torch.int32)[None] + torch.tensor([[0], [5], [ps - 3], [9]])
                     ).to(torch.int32) % span
    tables[3, int(positions[3, -1]) // ps] = n_pages  # outside the pool: dropped
    tables, positions = tables.cuda(), positions.contiguous().cuda()
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    k = torch.randn(b, t, hkv, d, **bf) * 4
    v = (torch.randn(b, t, 3, hkv, d, **bf) * 4)[:, :, 1]  # strided, as a slice of qkv
    caches = _store_caches((hkv, n_pages, ps, d), (hkv, n_pages, ps), quant, cuda)
    want = [None if c is None else c.cpu() for c in caches]
    kvs.kv_store_paged_plain(*want[:2], k.cpu(), v.cpu(), tables.cpu(), positions.cpu(), *want[2:])
    before = kvs.KV_STORE_PAGED.launches
    kvs.kv_store_paged(*caches[:2], k, v, tables, positions, *caches[2:])
    torch.cuda.synchronize()
    assert kvs.KV_STORE_PAGED.launches == before + 1
    assert all(_same_bits(g, w) for g, w in zip(caches, want) if w is not None)


def test_kv_store_refuses_what_it_cannot_store(cuda):
    from nfai_tpu_torch.ops import kv_store as kvs

    b, s, hkv = 2, 64, 2
    starts = torch.zeros(b, device="cuda", dtype=torch.int32)
    for d, dtype in ((80, torch.bfloat16), (64, torch.float32)):  # a head width, a row type it lacks
        cache = torch.zeros(b, s, hkv * d, device="cuda", dtype=dtype)
        rows = torch.zeros(b, 3, hkv * d, device="cuda", dtype=dtype)
        with pytest.raises((NotImplementedError, ValueError)):
            kvs.kv_store(cache, cache.clone(), rows, rows, starts, hkv)
    cache = torch.zeros(b, s, hkv * 64, device="cuda", dtype=torch.bfloat16)
    rows = torch.zeros(b, 3, hkv * 64 + 4, device="cuda", dtype=torch.bfloat16)[..., 4:]  # 8 bytes off
    with pytest.raises(ValueError):
        kvs.kv_store(cache, cache.clone(), rows, rows, starts, hkv)
    with pytest.raises(ValueError):  # int64 positions
        kvs.kv_store_paged(torch.zeros(hkv, 4, 16, 64, device="cuda", dtype=torch.bfloat16),
                           torch.zeros(hkv, 4, 16, 64, device="cuda", dtype=torch.bfloat16),
                           torch.zeros(b, 1, hkv, 64, device="cuda", dtype=torch.bfloat16),
                           torch.zeros(b, 1, hkv, 64, device="cuda", dtype=torch.bfloat16),
                           torch.ones(b, 1, device="cuda", dtype=torch.int32),
                           torch.zeros(b, 1, device="cuda", dtype=torch.int64))


# K3's contract on the store's copy body at row widths on both sides of its
# 512-byte split: 400 and 1040 bytes (one warp a row, 25 and 65 pieces),
# 1024, 2048 and 3072 (2, 4 and 6 warps a row); bf16 rows and int8 codes
@pytest.mark.parametrize("row_bytes", [400, 1040, 1024, 2048, 3072])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_row_write_kernel_row_widths(cuda, row_bytes, dtype):
    l, b, s = 3, 4, 40
    width = row_bytes // (2 if dtype == torch.bfloat16 else 1)
    if dtype == torch.int8:
        cache = torch.randint(-127, 128, (l, b, s, width), dtype=dtype, device="cuda", generator=cuda)
        rows = torch.randint(-127, 128, (l, b, width), dtype=dtype, device="cuda", generator=cuda)
    else:
        cache = torch.randn(l, b, s, width, dtype=dtype, device="cuda", generator=cuda)
        rows = torch.randn(l, b, width, dtype=dtype, device="cuda", generator=cuda)
    starts = torch.tensor([0, 17, s - 1, s], device="cuda", dtype=torch.int32)  # the last dropped
    want = fd.write_all_layers_plain(cache.cpu(), rows.cpu(), starts.cpu())
    assert _same_bits(fd.write_all_layers(cache.clone(), rows, starts), want)


def _tiny_q4k(tmp_path):
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    return make_tiny_llama_gguf(tmp_path / "t.gguf", hidden=256, n_heads=4, n_kv_heads=2, ffn_dim=512,
                                vocab_size=512, quant=GGMLType.Q4_K, tied=False, context_length=512)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_sampling_options_on_the_card_match_the_cpu(cuda, tmp_path, kv_dtype):
    """decode_loop with a logit bias, penalties and logprobs at batch 2 on
    the card (no host sync inside: sync debug mode "error") against the
    CPU: greedy tokens equal up to a near-tie (where they part, the card's
    token lies within TOL x the logit scale of the CPU's top logprob), the
    counts are the sampled tokens', logprobs within 2 x TOL x the logit
    scale (INT8_TOL on int8 caches)."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import decode_loop, prefill_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    path = _tiny_q4k(tmp_path)
    cfg = EngineConfig(max_seq_len=256, kv_dtype=kv_dtype)
    engines = {dev: InferenceEngine(path, cfg, device=dev) for dev in ("cuda", "cpu")}
    prompts = torch.randint(5, 250, (2, 12), generator=torch.Generator().manual_seed(3))
    tol = TOL if kv_dtype == "auto" else INT8_TOL
    out, scale = {}, {}
    for dev, e in engines.items():
        cache = e.new_cache(2)
        logits, cache = prefill_step(e.params, e.model_cfg, prompts.to(dev),
                                     torch.arange(12, device=dev)[None].expand(2, 12),
                                     torch.tensor([11, 11], device=dev), cache)
        scale[dev] = float(logits.abs().max())
        first = torch.tensor([7, 9], device=dev)
        kw = dict(temperature=0.0, bias_ids=torch.tensor([[300, 0], [17, 42]], device=dev),
                  bias_vals=torch.tensor([[100.0, 0.0], [-100.0, -100.0]], device=dev),
                  presence=torch.tensor([0.0, 0.75], device=dev), frequency=torch.tensor([30.0, 0.5], device=dev),
                  counts=torch.zeros((2, 512), dtype=torch.int32, device=dev), n_logprobs=3)
        start = torch.tensor([12, 12], device=dev)
        if dev == "cuda":
            before = (fd.K2.launches, fd.K2_I8.launches)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = decode_loop(e.params, e.model_cfg, first, start, cache, None, 8, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert (fd.K2_I8 if kv_dtype == "int8" else fd.K2).launches - before[kv_dtype == "int8"] == 8 * 2
        else:
            res = decode_loop(e.params, e.model_cfg, first, start, cache, None, 8, **kw)
        out[dev] = [t.cpu() for t in res[:2]] + [t.cpu() for t in res[4:]]
    g, c = out["cuda"], out["cpu"]
    tie, lp_tol = tol * scale["cpu"], 2 * tol * scale["cpu"]
    for r in range(2):
        seq_g = g[0][r, 1:].tolist() + [int(g[1][r])]
        seq_c = c[0][r, 1:].tolist() + [int(c[1][r])]
        d = next((j for j, (a, b) in enumerate(zip(seq_g, seq_c)) if a != b), 8)
        if d < 8:
            ids, lps = c[4][r, d].tolist(), c[5][r, d].tolist()
            assert seq_g[d] in ids and lps[ids.index(seq_g[d])] >= lps[0] - tie
        assert g[2][r].tolist() == torch.bincount(torch.tensor(seq_g), minlength=512).tolist()
        assert (g[3][r, :d + 1] - c[3][r, :d + 1]).abs().max() <= lp_tol
        assert (g[5][r, :d + 1] - c[5][r, :d + 1]).abs().max() <= lp_tol
    assert int(g[0][0, 1]) == 300  # the bias forced row 0's first sample


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_session_round_trip_on_the_card(cuda, tmp_path, kv_dtype):
    """A session saved on the card, loaded back onto it and continued
    gives the tokens of one never saved; the loaded cache holds the saved
    bits on the card; the same file loads into a CPU engine."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine

    path = _tiny_q4k(tmp_path)
    cfg = EngineConfig(max_seq_len=320, kv_dtype=kv_dtype)
    gpu = InferenceEngine(path, cfg, device="cuda")
    greedy = SamplingParams(temperature=0.0, max_new_tokens=6)
    s = ChatSession(gpu, greedy)
    r1 = s.send("hello")
    s.save(tmp_path / "s.npz")
    s2 = ChatSession.load(gpu, tmp_path / "s.npz", greedy)
    assert s2._cache.k.device.type == "cuda"
    for a in ("k", "v", "ks", "vs"):
        saved, loaded = getattr(s._cache, a), getattr(s2._cache, a)
        if saved is not None:
            cut = (slice(None),) * (2 if a in ("k", "v") else 3) + (slice(0, 320),)
            assert torch.equal(loaded[cut], saved[cut])
    r2 = s2.send("again")
    s3 = ChatSession(gpu, greedy)
    assert s3.send("hello") == r1 and s3.send("again") == r2
    cpu = InferenceEngine(path, cfg, device="cpu")
    s4 = ChatSession.load(cpu, tmp_path / "s.npz", greedy)
    assert torch.equal(s4._cache.k[:, :, :320], s._cache.k[:, :, :320].cpu())


def test_perplexity_on_the_card_matches_the_cpu(cuda, tmp_path):
    """eval.perplexity over two 64-token windows, bf16 and int8 caches, on
    the card (the prefill path: K1's tiles, K5, K4 / K4-i8, the store, the
    head at M = 64) against the CPU's plain versions: mean NLL within TOL
    relative (int8: INT8_TOL, each device quantizes its own K/V)."""
    import math

    from nfai_tpu_torch import eval as teval
    from nfai_tpu_torch.gguf import GGUFFile
    from nfai_tpu_torch.models import LlamaConfig, load_params
    from nfai_tpu_torch.ops import kv_store as kvs

    path = _tiny_q4k(tmp_path)
    ids = torch.randint(0, 500, (128,), generator=torch.Generator().manual_seed(4)).numpy()
    with GGUFFile.open(path) as g:
        cfg = LlamaConfig.from_gguf(g)
        params = {dev: load_params(g, cfg, dtype=torch.bfloat16, device=dev) for dev in ("cuda", "cpu")}
    for quant, tol in ((False, TOL), (True, INT8_TOL)):
        before = (pa.K4.launches, pa.K4_I8.launches, kvs.KV_STORE.launches, qm.K1.launches)
        got = teval.perplexity(params["cuda"], cfg, ids, window=64, kv_quant=quant)
        after = (pa.K4.launches, pa.K4_I8.launches, kvs.KV_STORE.launches, qm.K1.launches)
        want = teval.perplexity(params["cpu"], cfg, ids, window=64, kv_quant=quant)
        assert abs(math.log(got) - math.log(want)) <= tol * math.log(want), (quant, got, want)
        k4 = after[1] - before[1] if quant else after[0] - before[0]
        assert k4 == 2 * cfg.n_layers and after[2] - before[2] == 2 * cfg.n_layers and after[3] > before[3]


# -- speculative and constrained decoding: the verify shapes ---------------------


# K4 at the verify forward's shape, T = gamma + 1 = 9 (EngineConfig's default
# spec_tokens 8): batch 1 and 8, every row at its own offset (ragged, across
# key tiles), and at batch 8 a frozen lane at the cache's length (a start
# the store drops; K4 reads no key past the cache), bf16 and int8
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d,r", [(64, 4), (128, 8)])
@pytest.mark.parametrize("b", [1, 8])
def test_prefill_attention_at_the_verify_shape(cuda, b, d, r, quant):
    from nfai_tpu_torch.models.llama import quantize_kv

    s, t, hkv = 1024, 9, 2
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, t, hkv * r, d, **bf) * 2
    kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
        sc = dict(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    offs = [37] if b == 1 else [0, 5, 63, 64, 500, 700, s - t, s]  # the last lane frozen
    offs = torch.tensor(offs, device="cuda", dtype=torch.int32)
    kernel = pa.K4_I8 if quant else pa.K4
    before = kernel.launches
    got = pa.flash_prefill_attention(q, kc, vc, offs, **sc)
    assert kernel.launches == before + 1
    want = pa.flash_prefill_attention_plain(q, kc, vc, offs, d**-0.5, sc.get("k_scales"), sc.get("v_scales"))
    assert rel(got, want, row_dims=3) < (INT8_TOL if quant else TOL)


# the store in chunk mode for 9 rows a layer, a frozen lane at the cache's
# length (and one past it) writing nothing; the paged store through a frozen
# lane's all-zero (sink) table writing page 0 only
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kv_store_drops_a_frozen_lanes_rows(cuda, quant):
    from nfai_tpu_torch.ops import kv_store as kvs

    b, s, t, hkv, d = 4, 96, 9, 2, 64
    kvd = hkv * d
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    k, v = torch.randn(b, t, kvd, **bf) * 4, torch.randn(b, t, kvd, **bf) * 4
    starts = torch.tensor([3, s - t, s, s + 5], device="cuda", dtype=torch.int32)
    caches = _store_caches((b, s, kvd), (b, hkv, s), quant, cuda)
    want = [None if c is None else c.cpu() for c in caches]
    kvs.kv_store_plain(*want[:2], k.cpu(), v.cpu(), starts.cpu(), hkv, *want[2:])
    frozen = [c[2:].clone() for c in caches if c is not None]
    kvs.kv_store(*caches[:2], k, v, starts, hkv, *caches[2:])
    torch.cuda.synchronize()
    assert all(_same_bits(g, w) for g, w in zip(caches, want) if w is not None)
    assert all(torch.equal(c[2:], f) for c, f in zip([c for c in caches if c is not None], frozen))
    n_pages, ps = 6, 16
    tables = torch.tensor([[1, 2, 0, 0], [0, 0, 0, 0]], device="cuda", dtype=torch.int32)  # lane 1: the sink
    positions = (torch.arange(t, dtype=torch.int32)[None] + torch.tensor([[10], [0]], dtype=torch.int32)).cuda()
    pages = _store_caches((hkv, n_pages, ps, d), (hkv, n_pages, ps), quant, cuda)
    kept = [p[:, 3:].clone() for p in pages if p is not None]
    kk, vv = (x[:2].view(2, t, hkv, d) for x in (k, v))
    kvs.kv_store_paged(*pages[:2], kk, vv, tables, positions.contiguous(), *pages[2:])
    torch.cuda.synchronize()
    assert all(torch.equal(p[:, 3:], c) for p, c in zip([p for p in pages if p is not None], kept))


def _verify_inputs(e, b, dev):
    """A batch-b cache after 40-token prompts, and a verify of 9 tokens a row
    at ragged positions (the last row frozen at b > 1)."""
    from nfai_tpu_torch.models import prefill_step

    gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(5, 250, (b, 40), generator=gen)
    cache = e.new_cache(b)
    _, cache = prefill_step(e.params, e.model_cfg, prompts.to(dev), torch.arange(40, device=dev)[None].expand(b, 40),
                            torch.full((b,), 39, device=dev), cache)
    tin = torch.randint(5, 250, (b, 9), generator=gen).to(dev)
    pos = torch.tensor([40 - 3 * (i % 3) for i in range(b)], device=dev)
    act = torch.ones(b, dtype=torch.bool, device=dev)
    act[-1] = b == 1
    return cache, tin, pos, act


@pytest.mark.parametrize("b", [1, 8])
def test_verify_forward_cuda_matches_cpu(cuda, tmp_path, b):
    """The verify forward (K1/K5 at M = 9b, K4 at T = 9 through the store's
    chunk mode, the LM head over every position) on the card against the
    CPU: logits within TOL per position of the active rows; a frozen row
    writes no K/V row on either device; no host sync on the card."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models.llama import _verify_forward
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    path = _tiny_q4k(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        e = InferenceEngine(path, EngineConfig(max_seq_len=256), device=dev)
        cache, tin, pos, act = _verify_inputs(e, b, dev)
        before = cache.k.clone()
        if dev == "cuda":
            k4 = pa.K4.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits = _verify_forward(e.params, e.model_cfg, tin, pos, act, cache, None)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert pa.K4.launches - k4 == e.model_cfg.n_layers
        else:
            logits = _verify_forward(e.params, e.model_cfg, tin, pos, act, cache, None)
        if b > 1:
            assert torch.equal(cache.k[:, -1], before[:, -1])  # the frozen lane
        out[dev] = logits.float().cpu()
    live = slice(0, b if b == 1 else b - 1)
    assert rel(out["cuda"][live], out["cpu"][live], row_dims=2) < TOL


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_and_constrained_batch_engine_on_the_card(cuda, tmp_path, paged):
    """The BatchEngine on the card with speculative="ngram": greedy slots
    equal the same engine's plain BatchEngine up to a near-tie (the card's
    verify and decode matmuls round differently), a sampled slot fills its
    budget, drafts are accepted; then constrained slots (JSON, a regex)
    beside a plain one give text that satisfies them."""
    import json
    import re

    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState

    path = _tiny_q4k(tmp_path)
    prompts = [[3, 4, 5, 3, 4, 5, 3, 4] * 3, [9, 9, 2] * 6, [7, 1] * 9]
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=24)] * 2 + [
        SamplingParams(temperature=0.8, top_k=20, max_new_tokens=24, seed=1)]
    outs = {}
    for spec in ("off", "ngram"):
        e = InferenceEngine(path, EngineConfig(max_seq_len=256, speculative=spec, paged_kv=paged, page_size=16),
                            device="cuda")
        be = BatchEngine(e, max_batch=4)
        reqs = [be.submit(p, s) for p, s in zip(prompts, sampling)]
        for _ in range(500):
            if be.step() == 0 and be.queue.empty():
                break
        outs[spec] = [r.output_ids for r in reqs]
        assert all(r.state == RequestState.FINISHED for r in reqs)
    assert be.spec_drafted > 0 and be.spec_accepted > 0 and len(outs["ngram"][2]) == 24
    for got, want in zip(outs["ngram"][:2], outs["off"][:2]):
        d = next((j for j, (a, c) in enumerate(zip(got, want)) if a != c), len(got))
        assert d >= 4, (got, want)  # the first tokens leave no room for a tie
    checks = [(dict(response_format="json"), lambda t: isinstance(json.loads(t), dict)),
              (dict(regex="(ab|cd)+-[0-9]{2}"), lambda t: re.fullmatch("(ab|cd)+-[0-9]{2}", t)), ({}, None)]
    be = BatchEngine(e, max_batch=4)
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=24, **f)) for p, (f, _) in zip(prompts, checks)]
    for _ in range(500):
        if be.step() == 0 and be.queue.empty():
            break
    for r, (_, ok) in zip(reqs, checks):
        assert r.state == RequestState.FINISHED
        assert ok is None or ok(e.tokenizer.decode(r.output_ids)), r.output_ids


# -- the instances the qwen2 / mistral / phi3 families need ---------------------------

# K2's and K7's new instances: GQA ratios 5, 6, 7, 9 and 16 at head_dim 128
# (Qwen3-14B, Qwen2.5-1.5B, Qwen2.5-7B, a second head group's ragged edge,
# Qwen3-235B-A22B), r = 16 at head_dims 64 and 256 (the two-group shared
# memory at its widest), and head_dim 96 (Phi-3-mini's) at r = 1, 6 and 16;
# bf16 and int8, with and without softcap and window, on the narrow and
# the wide grid; per (row, head) against the plain version, one counter step
# a call, the same bits on three launches
NEW_DECODE_SHAPES = [(5, 128), (6, 128), (7, 128), (9, 128), (16, 128), (16, 64), (16, 256), (1, 96),
                     (6, 96), (16, 96)]


@pytest.mark.parametrize(**SPLIT_OPTIONS)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r,d", NEW_DECODE_SHAPES)
@pytest.mark.parametrize("b,hkv", [(8, 1), (4, 8)], ids=["narrow", "wide"])
def test_decode_attention_new_instances(cuda, b, hkv, r, d, quant, cap, win):
    from nfai_tpu_torch.models.llama import quantize_kv

    s = 2048
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
        sc = dict(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    q = torch.randn(b, hkv * r, d, **bf) * (3 if cap else 1)
    kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
    starts = torch.tensor([0, 1, 63, 65, 777, 1024, 2000, 2048][:b], device="cuda", dtype=torch.int32)
    kernel = fd.K2_I8 if quant else fd.K2

    def run():
        return fd.decode_attention(q, kn, vn, kc, vc, starts, softcap=cap, window=win, **sc)

    before = kernel.launches
    got = run()
    assert kernel.launches == before + 1
    want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, d**-0.5, sc.get("k_scales"),
                                     sc.get("v_scales"), cap, win)
    assert rel(got, want, row_dims=2) < TOL
    assert all(torch.equal(run(), got) for _ in range(2))  # no atomics


@pytest.mark.parametrize(**SPLIT_OPTIONS)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("r,d", NEW_DECODE_SHAPES)
def test_paged_attention_new_instances(cuda, r, d, ps, quant, cap, win):
    from nfai_tpu_torch.models.llama import quantize_kv

    b, hkv = 8, 2
    n_p = 2048 // ps
    n_pages = b * n_p + 3
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    kp, vp = torch.randn(hkv, n_pages, ps, d, **bf), torch.randn(hkv, n_pages, ps, d, **bf)
    sc = {}
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kp, 1), quantize_kv(vp, 1)
        sc = dict(k_scales=ks[..., 0].contiguous(), v_scales=vs[..., 0].contiguous())
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(ps + d + r))[: b * n_p] + 1
    tables = perm.view(b, n_p).to(torch.int32).cuda()
    lengths = torch.tensor([1, 63, 64, 65, 777, 1024, 2000, 2048], device="cuda", dtype=torch.int32)
    q = torch.randn(b, hkv * r, d, **bf) * (3 if cap else 1)
    kernel = pga.K7_I8 if quant else pga.K7

    def run():
        return pga.paged_decode_attention(q, kp, vp, tables, lengths, softcap=cap, window=win, **sc)

    before = kernel.launches
    got = run()
    assert kernel.launches == before + 1
    want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5, sc.get("k_scales"),
                                            sc.get("v_scales"), cap, win)
    assert rel(got, want, row_dims=2) < TOL
    assert all(torch.equal(run(), got) for _ in range(2))  # no atomics


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [5, 16])
@pytest.mark.parametrize("which", ["K2", "K7"])
def test_padded_head_columns_are_neither_read_nor_written(cuda, which, r, quant):
    """The products pad the r query heads to 8 (or 16) columns: the C entry
    point called on buffers that run on past the real heads, NaN there.
    The queries past the last kv head's r heads are never read into a
    result (every output finite and equal to the plain version), and no
    output past the r heads of the last kv head is written (the NaN tail
    stays NaN, bit for bit)."""
    from nfai_tpu_torch.kernels import ptr, stream_ptr
    from nfai_tpu_torch.models.llama import quantize_kv

    b, hkv, d, s, tail = 2, 2, 128, 300, 16 * 128
    hq = hkv * r
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    qbuf = torch.full((b * hq * d + tail,), float("nan"), device="cuda", dtype=torch.bfloat16)
    qbuf[: b * hq * d] = torch.randn(b * hq * d, **bf)
    q = qbuf[: b * hq * d].view(b, hq, d)
    obuf = torch.full((b * hq * d + tail,), float("nan"), device="cuda", dtype=torch.bfloat16)
    out = obuf[: b * hq * d].view(b, hq, d)
    scale = d**-0.5
    if which == "K2":
        kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
        kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
        starts = torch.tensor([0, s - 1], device="cuda", dtype=torch.int32)
        if quant:
            (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
            ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
            fd.K2_I8.call("nfai_decode_attention_i8", ptr(q), ptr(kn), ptr(vn), ptr(kc), ptr(vc), ptr(ks),
                          ptr(vs), ptr(starts), ptr(out), b, s, hkv, r, d, scale, 0.0, 0, 1, stream_ptr(q))
            want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, scale, ks, vs)
        else:
            fd.K2.call("nfai_decode_attention", ptr(q), ptr(kn), ptr(vn), ptr(kc), ptr(vc), ptr(starts),
                       ptr(out), b, s, hkv, r, d, scale, 0.0, 0, 1, stream_ptr(q))
            want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, scale)
    else:
        ps, n_p = 16, 20
        n_pages = b * n_p + 1
        kp, vp = torch.randn(hkv, n_pages, ps, d, **bf), torch.randn(hkv, n_pages, ps, d, **bf)
        tables = (torch.arange(b * n_p, device="cuda", dtype=torch.int32) + 1).view(b, n_p)
        lengths = torch.tensor([1, n_p * ps], device="cuda", dtype=torch.int32)
        if quant:
            (kp, ks), (vp, vs) = quantize_kv(kp, 1), quantize_kv(vp, 1)
            ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
            pga.K7_I8.call("nfai_paged_attention_i8", ptr(q), ptr(kp), ptr(vp), ptr(ks), ptr(vs), ptr(tables),
                           ptr(lengths), ptr(out), b, hkv, r, n_pages, ps, n_p, d, scale, 0.0, 0, 1,
                           stream_ptr(q))
            want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale, ks, vs)
        else:
            pga.K7.call("nfai_paged_attention", ptr(q), ptr(kp), ptr(vp), ptr(tables), ptr(lengths), ptr(out),
                        b, hkv, r, n_pages, ps, n_p, d, scale, 0.0, 0, 1, stream_ptr(q))
            want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert rel(out, want, row_dims=2) < TOL
    assert bool(torch.isnan(obuf[b * hq * d:]).all())


# K4 at head_dim 96 (two 64-column sub-tiles, the second half used): r 1
# (Phi-3-mini) and 6, chunks of 1 to 256 tokens at offsets 0 and 700, the
# narrow and the wide grid, bf16 and int8, softcap and window once; "full"
# per (token, head) row against the plain version with the same bits on
# three launches, "headmajor" the same bits as "full", "merged" refused
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("offset", [0, 700])
@pytest.mark.parametrize("t", [1, 17, 64, 256])
@pytest.mark.parametrize("r", [1, 6])
@pytest.mark.parametrize("b,hkv", [(2, 2), (8, 8)], ids=["narrow", "wide"])
def test_prefill_attention_d96(cuda, b, hkv, r, t, offset, quant):
    from nfai_tpu_torch.models.llama import quantize_kv

    s, d = 1024, 96
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, t, hkv * r, d, **bf) * 2
    kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
        sc = dict(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    offs = torch.tensor([offset, offset // 2] * (b // 2), device="cuda", dtype=torch.int32)
    for cap, win in ((0.0, 0), (50.0, 96)):
        kernel = pa.K4_I8 if quant else pa.K4
        before = kernel.launches
        got = pa.flash_prefill_attention(q, kc, vc, offs, softcap=cap, window=win, **sc)
        assert kernel.launches == before + 1
        want = pa.flash_prefill_attention_plain(q, kc, vc, offs, d**-0.5, sc.get("k_scales"),
                                                sc.get("v_scales"), cap, win)
        assert rel(got, want, row_dims=3) < (INT8_TOL if quant else TOL), (cap, win)
        assert all(torch.equal(pa.flash_prefill_attention(q, kc, vc, offs, softcap=cap, window=win, **sc),
                               got) for _ in range(2))
        hm = pa.flash_prefill_attention(q, pa.head_major(kc, hkv), pa.head_major(vc, hkv), offs, softcap=cap,
                                        window=win, kv_layout="headmajor", **sc)
        assert torch.equal(hm, got)
    with pytest.raises(ValueError):
        pa.flash_prefill_attention(q, kc, vc, offs, kv_layout="merged", **sc)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode", ["step", "chunk"])
def test_kv_store_kernel_d96(cuda, quant, mode):
    """The dense store at head_dim 96 (groups of 16 lanes, 12 of them
    loading and storing): bit for bit against the plain version."""
    test_kv_store_kernel(cuda, 96, quant, mode)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t,ps", [(1, 16), (1, 128), (37, 16), (37, 128)])
def test_kv_store_paged_kernel_d96(cuda, quant, t, ps):
    test_kv_store_paged_kernel(cuda, 96, quant, t, ps)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2", dict(attn_bias=True, hidden=768, n_heads=6, n_kv_heads=1)),
    ("mistral", dict(spm_tokenizer=True, hidden=512, n_heads=4, n_kv_heads=1)),
    ("phi3", dict(fused_tensors=True, hidden=768, n_heads=8, n_kv_heads=8, tied=False)),
], ids=["qwen2", "mistral", "phi3"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_tiny_family_cuda_matches_cpu(cuda, tmp_path, arch, kw, kv_dtype):
    """A tiny Q4_K model of each family (qwen2 at r = 6 with biases, mistral
    at r = 4, phi3 at head_dim 96 with its pre-fused tensors) on the card
    (bf16) against the CPU's f32 forward: prefill logits and a decode step,
    dense and paged. Each output is held to the larger of TOL (INT8_TOL on
    int8 caches) and 1.5 x the CPU's own bf16 forward's distance from the
    same f32 forward: the card's bf16 route may sit no farther from the exact
    function than the plain bf16 route does (on these random weights the
    plain bf16 route is itself 1.3-1.8e-2 from f32)."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.gguf import GGMLType
    from nfai_tpu_torch.models import decode_step, paged_prefill_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
    from nfai_tpu_torch.testing import make_tiny_llama_gguf

    path = make_tiny_llama_gguf(tmp_path / f"{arch}.gguf", arch=arch, ffn_dim=512, vocab_size=512,
                                quant=GGMLType.Q4_K, **kw)
    runs = {"cuda": ("cuda", "bfloat16"), "cpu bf16": ("cpu", "bfloat16"), "cpu f32": ("cpu", "float32")}
    outs = {}
    for name, (dev, dtype) in runs.items():
        e = InferenceEngine(path, EngineConfig(max_seq_len=256, kv_dtype=kv_dtype, dtype=dtype), device=dev)
        ids = e.tokenizer.encode("a short prompt for both devices")
        logits, cache = e.prefill(e.new_cache(1), ids)
        step, _ = decode_step(e.params, e.model_cfg, torch.tensor([7], device=dev),
                              torch.tensor([len(ids)], device=dev), cache)
        pool = PagedKVCache.zeros(e.model_cfg, 9, 16, e.cache_dtype, dev, quantized=kv_dtype == "int8")
        table = torch.tensor([[5, 2, 7, 3]], dtype=torch.int32, device=dev)
        plog, pool = paged_prefill_step(e.params, e.model_cfg, torch.tensor([ids], device=dev),
                                        torch.arange(len(ids), device=dev)[None],
                                        torch.tensor([len(ids) - 1], device=dev), pool, table)
        pstep, _ = decode_step(e.params, e.model_cfg, torch.tensor([7], device=dev),
                               torch.tensor([len(ids)], device=dev), pool, page_tables=table)
        outs[name] = [t.float().cpu() for t in (logits, step, plog, pstep)]
    base = INT8_TOL if kv_dtype == "int8" else TOL
    for i, (g, b16, f32) in enumerate(zip(outs["cuda"], outs["cpu bf16"], outs["cpu f32"])):
        assert rel(g, f32) < max(base, 1.5 * rel(b16, f32)), i
