"""The q8v3 container and K12's plain version against the JAX package (port
on the CPU):

- the port's `to_q8v3_stacked` of the same int8 codes, scales and mins
  decodes to exactly (bit for bit, f32) the values of the JAX
  `dequant_qtensor(to_q8v3_stacked(q8))`: groups 16 and 32, with and
  without mins, 2-D and layer-stacked; the nibble planes give the codes
  back; `from_jax_qtensor("q8v3")` carries the JAX container across with
  its bf16 scales and mins bit for bit (N padding dropped);
- the eligibility gates match the JAX `q8v3_eligible` (K % 2048, the
  group, the kind); expert stacks and a tied 8-bit table stay 8-bit
  (through `load_params`);
- `q8v3_matmul_plain` against the JAX `qmatmul_layered` / `qmatmul` on
  the JAX q8v3 container, run as `tests/test_q8v3.py` runs it (bf16 x): per
  input row max|Δ| / max|ref| ≤ 1e-2 (both round the weight to bf16: the
  JAX kernel u0 * 8s before it subtracts the mins' product, the port
  u0 * 8s - m, as K12's tiles do);
- `load_params` under `NFAI_Q8V3=1` (set with `monkeypatch.setenv` for
  both packages) makes the JAX package's container choices key by key: a
  JAX "q8v3" stack is a `Q8V3Tensor`, or a `LayerList` whose 8-bit layers
  are `Q8V3Tensor`s and whose 4-bit layers stay `Q4Tensor` (the JAX
  package promotes the whole stack first); "q8" stays `Q8Tensor`; the
  codes and scales equal the JAX container's;
- a two-layer hidden-2048 Q8_0 model, untied (the JAX test's fixture),
  under `NFAI_Q8V3=1`: prefill logits within 2e-2 of the JAX engine's and
  the same greedy tokens (unless the JAX logits hold a near-tie there);
  `params_from_jax` on the JAX engine's q8v3 leaves gives the port's own
  containers bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models import llama as jllama
from nfai_tpu.ops.qmatmul import qmatmul as jqmatmul
from nfai_tpu.ops.qmatmul import qmatmul_layered as jqmatmul_layered
from nfai_tpu.ops.qtensor import QTensor, dequant_qtensor, pad_qtensor_n
from nfai_tpu.ops.qtensor import q8v3_eligible as jq8v3_eligible
from nfai_tpu.ops.qtensor import to_q8v3_stacked as jto_q8v3
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import KVCache, LlamaConfig, load_params, params_from_jax, prefill_step
from nfai_tpu_torch.ops import qmatmul as tqm
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf, use_more_bits

TOL_KERNEL = 1e-2
TOL = 2e-2
# tests/test_q8v3.py's model: hidden 2048, untied Q8_0
Q8_MODEL = dict(hidden=2048, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=2048, vocab_size=4096,
                quant=GGMLType.Q8_0, tied=False, seed=7)
# a Q4_K_M-like mix at K = 2048: Q6_K attn_v / ffn_down on `use_more_bits` layers of 4, a tied
# Q6_K table (stays 8-bit), Q4_K elsewhere
MIX = dict(hidden=2048, n_layers=4, n_heads=8, n_kv_heads=4, ffn_dim=2048, vocab_size=512,
           quant=GGMLType.Q4_K, tied=True, seed=8, quant_overrides={
               "token_embd.weight": GGMLType.Q6_K,
               **{f"blk.{i}.{t}.weight": GGMLType.Q6_K for i in range(4) if use_more_bits(i, 4)
                  for t in ("attn_v", "ffn_down")}})
# K = 256: nothing eligible; MoE at K = 2048: experts stay 8-bit, attention repacked
NARROW = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512, vocab_size=512,
              quant=GGMLType.Q8_0, tied=False, seed=9)
MOE = dict(arch="qwen3moe", n_experts=4, n_experts_used=2, qk_norm=True, hidden=2048, n_heads=8,
           n_kv_heads=4, ffn_dim=256, vocab_size=512, tied=False, seed=10, n_layers=2,
           quant=GGMLType.Q8_0)
FIXTURES = {"q8_0": Q8_MODEL, "mix": MIX, "narrow": NARROW, "moe": MOE}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops gain nothing from intra-op threads beside the suite's other
    workers; restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_rows(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def _q8(rng, k, n, group, with_mins, layers=0):
    """The same int8 codes, f32 scales and mins as a JAX QTensor [.., K, N]
    and a port Q8Tensor [.., N, K]."""
    lead = (layers,) if layers else ()
    qs = rng.integers(-128, 128, (*lead, k, n), dtype=np.int8)
    sc = (rng.random((*lead, k // group, n)) * 0.01).astype(np.float32)
    mn = (rng.random((*lead, k // group, n)) * 0.05).astype(np.float32) if with_mins else None
    jq = QTensor(jnp.asarray(qs), jnp.asarray(sc), None if mn is None else jnp.asarray(mn), "q8",
                 k, n, group=group)
    nk = lambda a: torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, -1, -2)))  # noqa: E731
    tq = tqt.Q8Tensor(nk(qs), nk(sc), None if mn is None else nk(mn), k, n, group)
    return jq, tq


def _jax_layer(qt, i):
    return qt.replace(qs=qt.qs[i], scales=qt.scales[i], mins=None if qt.mins is None else qt.mins[i])


@pytest.mark.parametrize("layers", [0, 2], ids=["2d", "stacked"])
@pytest.mark.parametrize("group,with_mins", [(32, False), (32, True), (16, False), (16, True)])
def test_q8v3_decodes_to_the_jax_values(group, with_mins, layers):
    rng = np.random.default_rng(group + with_mins + layers)
    jq, tq = _q8(rng, 2048, 256, group, with_mins, layers)
    jv, tv = jto_q8v3(jq), tqt.to_q8v3_stacked(tq)
    assert jv.kind == "q8v3" and isinstance(tv, tqt.Q8V3Tensor)
    assert tv.qs.dtype == torch.uint8 and tv.qs.shape == tq.qs.shape  # K*N bytes, like int8
    assert tv.scales.dtype == torch.bfloat16 and (tv.mins is not None) == with_mins
    got = tqt.dequant(tv).numpy()
    for i in range(layers or 1):
        want = np.asarray(dequant_qtensor(_jax_layer(jv, i) if layers else jv, jnp.float32))
        assert np.array_equal((got[i] if layers else got).T, want), i
    # the nibble planes hold the codes: v = 16 (hi - 8) + lo
    lo, hi = tqt.q8v3_nibbles(tv.qs)
    assert torch.equal((16 * (hi.to(torch.int16) - 8) + lo.to(torch.int16)).to(torch.int8), tq.qs)
    # u0 = v / 8 exactly, through the bf16 bit decode
    assert torch.equal(tqt.q8v3_u0(tv.qs).float(), tq.qs.float() / 8)
    # a layer of the stack is a view of it, and decodes as the 2-D container
    if layers:
        layer = tv.layer(1)
        assert layer.qs.data_ptr() == tv.qs.data_ptr() + tv.qs[0].numel()
        assert torch.equal(tqt.dequant(layer), tqt.dequant(tv)[1])


@pytest.mark.parametrize("group,with_mins", [(32, False), (16, True)])
def test_from_jax_q8v3_keeps_the_bits(group, with_mins):
    rng = np.random.default_rng(20 + group)
    jq, tq = _q8(rng, 2048, 384, group, with_mins, layers=2)
    jv = jto_q8v3(jq)
    conv = tqt.from_jax_qtensor("q8v3", np.asarray(jv.qs), np.asarray(jv.scales),
                                None if jv.mins is None else np.asarray(jv.mins), jv.k, jv.n,
                                group=group)
    own = tqt.to_q8v3_stacked(tq)
    assert isinstance(conv, tqt.Q8V3Tensor)
    for name in ("qs", "scales", "mins"):
        a, b = getattr(conv, name), getattr(own, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    # the 2-D head, N-padded in the JAX container (384 → 512): padding dropped
    jh, th = _q8(rng, 2048, 384, group, with_mins)
    jp = jto_q8v3(pad_qtensor_n(jh, 512))
    assert jp.qs.shape[-1] == 512 and jp.n == 384
    conv = tqt.from_jax_qtensor("q8v3", np.asarray(jp.qs), np.asarray(jp.scales),
                                None if jp.mins is None else np.asarray(jp.mins), jp.k, jp.n,
                                group=group)
    assert conv.qs.shape == (384, 2048)
    assert np.array_equal(tqt.dequant(conv).numpy().T, np.asarray(dequant_qtensor(jto_q8v3(jh),
                                                                                  jnp.float32)))


@pytest.mark.parametrize("k,group,ok", [(2048, 32, True), (4096, 16, True), (1024, 32, False),
                                        (3072, 32, False), (2048, 8, False)])
def test_eligibility_matches_jax(k, group, ok):
    rng = np.random.default_rng(k + group)
    jq, tq = _q8(rng, k, 64, group, False)
    assert jq8v3_eligible(jq) == tqt.q8v3_eligible(tq) == ok
    assert isinstance(tqt.to_q8v3_stacked(tq), tqt.Q8V3Tensor) == ok
    # a 4-bit weight stays where it is, in both packages
    q4 = tqt.pack_q_values(np.zeros((64, k), np.uint8), np.ones((64, k // 32), np.float32),
                           np.zeros((64, k // 32), np.float32))
    assert not tqt.q8v3_eligible(q4) and not jq8v3_eligible(jq.replace(kind="q4"))
    assert tqt.to_q8v3_stacked(q4) is q4


def _bf16_bits(bits):
    """uint32 bf16 bit patterns (low 16 bits) → f64."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32).astype(np.float64)


def _round_bf16(x):
    """f64 → the nearest bf16 (ties to even), as f64: one rounding."""
    mant, exp = np.frexp(x)
    return np.ldexp(np.rint(mant * 256.0), exp - 8)


def _tile_a_operand(w: "tqt.Q8V3Tensor") -> tuple[np.ndarray, np.ndarray]:
    """K12's wgmma tiles' A operand, in numpy bit operations on the packed
    planes of a 16-row weight, gathered as csrc/q8v3_matmul.cu's consumer
    lane (g, t) gathers it: for each 16-code step s of a 128-code chunk,
    rows g and g + 8, the lane reads chunks t>>1 and 2 + (t>>1) of the lo
    plane (bytes 0..63) and the same of the hi plane (64..127), takes word
    b = s // 2 of each, joins a lo word and a hi word into the sign-flipped
    bytes u = lo | hi << 4 after shifting by 4 (t & 1), shifts by 8 for the
    odd steps, decodes bytes 0 and 2 to bf16 v / 16 (0x4100 | (u & 0x7F)
    minus 0x4100 | (~u & 0x80)) and folds the group's scale and min:
    A = bf16(v / 16 * s8 - m / 2), the group being block b (g32) or step s
    (g16) of the chunk. Returns (v / 16, A), f64 [16, K], each placed at the
    natural k of its wgmma slot: 2t, 2t + 1 (word t>>1) and 2t + 8, 2t + 9
    (word 2 + (t>>1)) of the step."""
    qs = w.qs.numpy()
    n, k = qs.shape
    words = qs.reshape(n, k // 128, 128).view("<u4")  # [row, chunk, 16-byte chunk * 4 + word]
    s8 = w.scales.float().numpy().astype(np.float64)
    m = np.zeros_like(s8) if w.mins is None else w.mins.float().numpy().astype(np.float64)
    spg = 128 // w.group
    v16 = np.full((n, k), np.nan)
    a = np.full((n, k), np.nan)
    rows = np.arange(n)[:, None]
    for t in range(4):
        sl, sh = 4 * (t & 1), 4 - 4 * (t & 1)
        for s in range(8):
            b, i = s // 2, s % 2
            si = b if w.group == 32 else s
            for word, slot in ((t >> 1, 2 * t), (2 + (t >> 1), 2 * t + 8)):
                lo, hi = words[:, :, 4 * word + b], words[:, :, 4 * (4 + word) + b]
                u = ((lo >> sl) & 0x0F0F0F0F) | ((hi << sh) & 0xF0F0F0F0)
                u >>= 8 * i
                for half, byte in ((0, u & 0xFF), (1, (u >> 16) & 0xFF)):
                    dec = _bf16_bits(0x4100 | (byte & 0x7F)) - _bf16_bits(0x4100 | (~byte & 0x80))
                    col = np.arange(k // 128)[None, :] * 128 + 16 * s + slot + half
                    grp = np.arange(k // 128)[None, :] * spg + si
                    v16[rows, col] = dec
                    a[rows, col] = _round_bf16(dec * s8[rows, grp] - m[rows, grp] / 2)
    return v16, a


@pytest.mark.parametrize("group,with_mins", [(32, False), (32, True), (16, False), (16, True)])
def test_tile_fragment_mapping(group, with_mins):
    """The bit operations K12's tiles decode with, on the packed bytes of
    `q8v3_from_codes`: every lane (g, t) of every 16-code step gets u0 of
    the codes at natural k = 2t, 2t+1, 2t+8, 2t+9 of its rows g and g + 8,
    exactly (as v / 16 = u0 / 2), and its A value is the plain version's
    weight halved, rounded once to bf16 (the tiles double their f32 sums)."""
    rng = np.random.default_rng(40 + group + with_mins)
    n, k = 16, 256
    v = torch.from_numpy(rng.integers(-128, 128, (n, k), dtype=np.int8))
    v[0, :256] = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)  # every code once
    s8 = torch.from_numpy((rng.random((n, k // group)) * 0.08 + 1e-4).astype(np.float32))
    mn = torch.from_numpy((rng.random((n, k // group)) * 0.05).astype(np.float32)) if with_mins else None
    w = tqt.q8v3_from_codes(v, s8, mn, group)
    v16, a = _tile_a_operand(w)
    assert np.array_equal(2 * v16, tqt.q8v3_u0(w.qs).numpy().astype(np.float64))
    assert np.array_equal(16 * v16, v.numpy().astype(np.float64))
    # the group each weight's scale and min come from, by natural k
    per_k = lambda t: np.repeat(t.float().numpy().astype(np.float64), group, -1)  # noqa: E731
    s8k, mk = per_k(w.scales), 0.0 if mn is None else per_k(w.mins)
    assert np.array_equal(2 * a, _round_bf16(2 * v16 * s8k - mk))
    # the plain version's weight (u0 * s8 - m in f32) within half a bf16 ulp
    want = tqt.dequant(w).numpy().astype(np.float64)
    assert np.all(np.abs(2 * a - want) <= np.abs(want) * 2.0**-8 + 2.0**-20 * (np.abs(2 * v16 * s8k) + mk))


def _q8v3_check_case(case):
    """(x, w) for a q8v3_check case: a 16-byte aligned bf16 x [40, 256] and a
    [100, 256] g16 Q8V3Tensor with mins (N a multiple of neither 64 nor 128),
    then one thing K12 does or does not take."""
    n, k = 100, 256
    w = tqt.Q8V3Tensor(torch.zeros(n, k, dtype=torch.uint8), torch.zeros(n, k // 16, dtype=torch.bfloat16),
                       torch.zeros(n, k // 16, dtype=torch.bfloat16), k, n, 16)
    x = torch.zeros(40, k, dtype=torch.bfloat16)
    stack = lambda w, layers: tqt.stack([w] * layers)  # noqa: E731
    if case == "misaligned x":
        x = torch.zeros(40 * k + 1, dtype=torch.bfloat16)[1:].view(40, k)
    elif case == "misaligned planes":
        w = dataclasses.replace(w, qs=torch.zeros(n * k + 1, dtype=torch.uint8)[1:].view(n, k))
    elif case == "misaligned mins":
        w = dataclasses.replace(w, mins=torch.zeros(n * k // 16 + 1, dtype=torch.bfloat16)[1:]
                                .view(n, k // 16))
    elif case == "f32 x":
        x = x.float()
    elif case == "K % 128":
        w = tqt.Q8V3Tensor(torch.zeros(n, 192, dtype=torch.uint8), torch.zeros(n, 12, dtype=torch.bfloat16),
                           None, 192, n, 16)
        x = torch.zeros(40, 192, dtype=torch.bfloat16)
    elif case == "group 64":
        w = dataclasses.replace(w, scales=w.scales[:, :4].contiguous(), mins=None, group=64)
    elif case == "f32 scales":
        w = dataclasses.replace(w, scales=w.scales.float())
    elif case == "int8 planes":
        w = dataclasses.replace(w, qs=w.qs.to(torch.int8))
    elif case == "a layer stack":
        w = stack(w, 2)
    elif case == "a layer of a stack":  # an offset of 100 * 16 * 2 bytes: aligned
        w = stack(w, 3).layer(2)
    elif case == "a g32 layer, odd N":  # 99 rows of 8 scales: 1584 bytes a layer, aligned
        w = stack(tqt.Q8V3Tensor(torch.zeros(99, k, dtype=torch.uint8),
                                 torch.zeros(99, k // 32, dtype=torch.bfloat16), None, k, 99, 32), 2).layer(1)
    elif case == "a g32 layer, misaligned":  # 99 rows of 4 scales: 792 bytes a layer
        w = stack(tqt.Q8V3Tensor(torch.zeros(99, 128, dtype=torch.uint8),
                                 torch.zeros(99, 4, dtype=torch.bfloat16), None, 128, 99, 32), 2).layer(1)
        x = torch.zeros(40, 128, dtype=torch.bfloat16)
    return x, w


@pytest.mark.parametrize("case,error", [
    ("ok", None), ("misaligned x", ValueError), ("misaligned planes", ValueError),
    ("misaligned mins", ValueError), ("f32 x", TypeError), ("K % 128", ValueError),
    ("group 64", ValueError), ("f32 scales", TypeError), ("int8 planes", ValueError),
    ("a layer stack", ValueError), ("a layer of a stack", None), ("a g32 layer, odd N", None),
    ("a g32 layer, misaligned", ValueError),
])
def test_q8v3_check_takes_what_k12_takes(case, error):
    """The rules K12's wrapper holds a CUDA launch to, checked on CPU
    tensors: any M and N, K % 128 == 0, groups of 16 or 32, bf16 x, uint8
    planes, bf16 scales and mins, 2-D, contiguous, every tensor 16-byte
    aligned (a layer of a stack where its bytes keep the alignment);
    everything else raises."""
    x, w = _q8v3_check_case(case)
    if error is None:
        assert tqm.q8v3_check(x, w) == (40, w.k)
    else:
        with pytest.raises(error):
            tqm.q8v3_check(x, w)


@pytest.mark.parametrize("group", [32, 16])
def test_plain_matches_the_jax_layered_kernel(group):
    rng = np.random.default_rng(30 + group)
    jq, tq = _q8(rng, 2048, 512, group, True, layers=2)
    jv, tv = jto_q8v3(jq), tqt.to_q8v3_stacked(tq)
    x = (rng.standard_normal((8, 2048)) * 0.1).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for li in range(2):
        want = np.asarray(jqmatmul_layered(xj, jv, jnp.int32(li)), np.float32)
        got = tqm.linear_layered(xt, tv, li)
        assert got.dtype == torch.bfloat16 and got.shape == (8, 512)
        assert rel_rows(got.float().numpy(), want) < TOL_KERNEL, li


@pytest.mark.parametrize("group,with_mins", [(32, False), (16, True)])
def test_plain_matches_the_jax_2d_matmul(group, with_mins):
    """The 2-D head, which the JAX package runs as a one-layer stack."""
    rng = np.random.default_rng(40 + group)
    jq, tq = _q8(rng, 2048, 384, group, with_mins)
    x = (rng.standard_normal((3, 5, 2048)) * 0.1).astype(np.float32)
    want = np.asarray(jqmatmul(jnp.asarray(x, jnp.bfloat16).reshape(15, 2048), jto_q8v3(jq)),
                      np.float32)
    before = tqm.K12.launches
    got = tqm.linear(torch.from_numpy(x).to(torch.bfloat16), tqt.to_q8v3_stacked(tq))
    assert got.shape == (3, 5, 384) and tqm.K12.launches == before  # the CPU launches nothing
    assert rel_rows(got.reshape(15, 384).float().numpy(), want) < TOL_KERNEL


# -- load_params under NFAI_Q8V3 ---------------------------------------------------------


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("q8v3")
    return {name: make_tiny_llama_gguf(d / f"{name}.gguf", **kw) for name, kw in FIXTURES.items()}


def _jax_params(path):
    with JGGUFFile.open(path) as jg:
        return jllama.load_params(jg, jllama.LlamaConfig.from_gguf(jg), dtype=jnp.bfloat16,
                                  device_put=False, quantized="auto")


def _port_kinds(w) -> list:
    """The port container's kind per layer ("q8v3", "q8", "q4", "dense")."""
    names = {tqt.Q8V3Tensor: "q8v3", tqt.Q8Tensor: "q8", tqt.Q4Tensor: "q4"}
    if isinstance(w, tqt.LayerList):
        return [names[type(it)] for it in w.items]
    return [names.get(type(w), "dense")] * (tqt.n_layers(w) if hasattr(w, "qs") else 1)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_load_params_makes_the_jax_q8v3_choices(paths, name, monkeypatch):
    monkeypatch.setenv("NFAI_Q8V3", "1")
    want = _jax_params(paths[name])
    with GGUFFile.open(paths[name]) as g:
        cfg = LlamaConfig.from_gguf(g)
        got = load_params(g, cfg, dtype=torch.bfloat16)
    jl, tl = want["layers"], got["layers"]
    assert set(tl) == set(jl)
    seen = set()
    for key, leaf in jl.items():
        if not isinstance(leaf, QTensor):
            continue
        kinds = _port_kinds(tl[key])
        seen.add(leaf.kind)
        if leaf.kind == "q8v3":
            # the 8-bit layers repacked; a 4-bit layer of a mixed stack stays
            # 4-bit (the JAX package widened it to 8 bits first)
            assert "q8v3" in kinds and set(kinds) <= {"q8v3", "q4"}, key
            for i, kind in enumerate(kinds):
                if kind == "q8v3":
                    w = tl[key].layer(i)
                    jv = _jax_layer(leaf, i)
                    assert np.array_equal(tqt.dequant(w).numpy().T[:, : leaf.n],
                                          np.asarray(dequant_qtensor(jv, jnp.float32))[:, : leaf.n])
        else:
            assert "q8v3" not in kinds, key
    head, jhead = got["lm_head"], want["lm_head"]
    assert isinstance(head, tqt.Q8V3Tensor) == (jhead.kind == "q8v3")
    if name == "q8_0":  # every stack and the untied head repacked
        assert seen == {"q8v3"} and isinstance(head, tqt.Q8V3Tensor)
        assert np.array_equal(tqt.dequant(head).numpy().T,
                              np.asarray(dequant_qtensor(jhead, jnp.float32))[:, : jhead.n])
    if name == "mix":  # the tied Q6_K table stays 8-bit (K6): the embedding rows gather from it
        assert isinstance(head, tqt.Q8Tensor) and got["embed"] is None and jhead.kind == "q8"
        assert isinstance(tl["wv"], tqt.LayerList) and _port_kinds(tl["wv"]) == [
            "q8v3" if use_more_bits(i, 4) else "q4" for i in range(4)]
    if name == "narrow":  # K = 256: nothing is eligible
        assert "q8v3" not in seen and isinstance(head, tqt.Q8Tensor)
    if name == "moe":  # expert stacks stay 8-bit in both; the attention stacks are repacked
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            assert jl[key].kind == "q8" and _port_kinds(tl[key])[0] == "q8", key
        assert isinstance(tl["wo"], tqt.Q8V3Tensor) and jl["wo"].kind == "q8v3"


def test_without_the_switch_nothing_is_repacked(paths, monkeypatch):
    monkeypatch.setenv("NFAI_Q8V3", "0")
    with GGUFFile.open(paths["q8_0"]) as g:
        got = load_params(g, LlamaConfig.from_gguf(g), dtype=torch.bfloat16)
    assert all(not isinstance(w, tqt.Q8V3Tensor) for w in got["layers"].values())
    assert isinstance(got["lm_head"], tqt.Q8Tensor)


# -- the whole model against the JAX engine -------------------------------------------------


@pytest.fixture(scope="module")
def q8v3_engines(paths):
    mp = pytest.MonkeyPatch()
    mp.setenv("NFAI_Q8V3", "1")
    try:
        je = JInferenceEngine(str(paths["q8_0"]), JEngineConfig(dtype="float32", max_seq_len=64))
        te = InferenceEngine(paths["q8_0"], EngineConfig(dtype="float32", max_seq_len=64),
                             device="cpu")
    finally:
        mp.undo()
    assert je.params["layers"]["wqkv"].kind == "q8v3" and je.params["lm_head"].kind == "q8v3"
    assert isinstance(te.params["layers"]["wqkv"], tqt.Q8V3Tensor)
    assert isinstance(te.params["lm_head"], tqt.Q8V3Tensor)
    return je, te


def test_model_under_q8v3_vs_jax(q8v3_engines):
    je, te = q8v3_engines
    ids = [2, 4, 6, 8, 10, 12, 14]
    jl, _ = je.prefill(je.new_cache(1), ids)
    tl, _ = te.prefill(te.new_cache(1), ids)
    jl = np.asarray(jl, np.float32)
    assert rel_rows(tl.numpy(), jl) < TOL
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=4)))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=4)))
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:  # only a near-tie of the JAX logits may flip a greedy token
            logits = np.asarray(je.prefill(je.new_cache(1), ids + want[:i])[0])[0]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TOL * np.abs(logits).max(), (i, a, b)
            return
    assert got == want


def test_params_from_jax_carries_q8v3(q8v3_engines):
    je, te = q8v3_engines
    cfg = te.model_cfg
    conv = params_from_jax(jax.tree.map(np.asarray, je.params), cfg)
    for key, w in te.params["layers"].items():
        if isinstance(w, tqt.Q8V3Tensor):
            c = conv["layers"][key]
            assert isinstance(c, tqt.Q8V3Tensor), key
            assert torch.equal(c.qs, w.qs) and torch.equal(c.scales, w.scales), key
    assert torch.equal(conv["lm_head"].qs, te.params["lm_head"].qs)
    tokens = torch.tensor([[2, 4, 6, 8, 10, 12, 14, 16]])
    out = [prefill_step(p, cfg, tokens, torch.arange(8)[None], torch.tensor([7]),
                        KVCache.zeros(cfg, 1, 16, torch.float32))[0] for p in (conv, te.params)]
    assert torch.equal(out[0], out[1])
