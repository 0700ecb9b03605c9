"""The port's CUDA kernels against their plain versions, and the tiny model on
the card against the CPU. Marked `cuda`: each test skips without a GPU
(decided inside the fixture, never at import). On a machine with a card and
no JAX, run them without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: max|got - want| / max|want| < 2e-2 (bf16 kernels against f32
plain versions), taken per output row for attention (per batch row for
decode, per query token for prefill) and the matmuls and MLP (per input
row) so a row with a small output is not hidden behind a large one; the
row write is exact. The tiny models of every GGUF kind the port loads run
on the card and on the CPU, with K5 launched exactly for the fused-MLP
model and K6 exactly for the 8-bit ones.
"""
import pytest
import torch

from nfai_tpu_torch.ops import fused_decode as fd
from nfai_tpu_torch.ops import fused_mlp as fm
from nfai_tpu_torch.ops import prefill_attention as pa
from nfai_tpu_torch.ops import qmatmul as qm
from nfai_tpu_torch.ops.qtensor import Q4Tensor, Q8Tensor

pytestmark = pytest.mark.cuda
TOL = 2e-2


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


@pytest.mark.parametrize("m", [1, 3, 8, 40])
def test_q4_matmul_kernel(cuda, m):
    n, k = 192, 512
    w = Q4Tensor(
        torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device="cuda", generator=cuda),
        torch.rand(n, k // 32, device="cuda", generator=cuda) * 1e-2,
        torch.rand(n, k // 32, device="cuda", generator=cuda) * 5e-2, k, n,
    )
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = qm.K1.launches
    assert rel(qm.q4_matmul(x, w), qm.matmul_plain(x, w)) < TOL
    assert qm.K1.launches == before + 1


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


@pytest.mark.parametrize("t,offset", [(16, 0), (12, 40), (64, 64)])
def test_prefill_attention_kernel(cuda, t, offset):
    b, s, hkv, r, d = 2, 192, 2, 4, 64
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=cuda)
    q = torch.randn(b, t, hkv * r, d, **bf)
    kc, vc = torch.randn(b, s, hkv * d, **bf), torch.randn(b, s, hkv * d, **bf)
    offs = torch.tensor([offset, offset // 2], device="cuda", dtype=torch.int32)
    got = pa.flash_prefill_attention(q, kc, vc, offs)
    assert rel(got, pa.flash_prefill_attention_plain(q, kc, vc, offs, d**-0.5), row_dims=2) < TOL


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


@pytest.mark.parametrize("m", [1, 5, 40])
@pytest.mark.parametrize("group,with_mins", [(32, False), (16, False), (16, True)])
def test_q8_matmul_kernel(cuda, m, group, with_mins):
    n, k = 192, 512
    w = Q8Tensor(
        torch.randint(-32, 32, (n, k), dtype=torch.int8, device="cuda", generator=cuda),
        torch.rand(n, k // group, device="cuda", generator=cuda) * 1e-2,
        torch.rand(n, k // group, device="cuda", generator=cuda) * 5e-2 if with_mins else None,
        k, n, group,
    )
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=cuda)
    before = qm.K6.launches
    assert rel(qm.q8_matmul(x, w), qm.matmul_plain(x, w), row_dims=1) < TOL
    assert qm.K6.launches == before + 1


@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_mlp_kernel(cuda, m, act):
    k, f, h = 256, 512, 256

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
