"""The port's qwen3moe path against the JAX package's (port on the CPU, its
plain versions; JAX on its CPU backend with the grouped Pallas kernels in
interpret mode, as its own tests run them):

- `qmatmul_grouped_plain` (the plain version of K8 / K9) against the JAX
  `qmatmul_grouped` for a 4-bit stack (Q4_K) and 8-bit ones of group 32
  (Q8_0) and 16 (Q6_K), with mins (Q5_K, Q2_K) and without, E = 4,
  K = N = 256 (K = 512 for the 4-bit stack: the JAX kernel's split-half
  tiles need it, below it JAX takes its dense fallback), tm = 8, 32 and
  128, on a routing with an empty expert and one expert over two blocks;
  compared on the routed rows;
- `moe_route` / `moe_group_layout` against `_moe_route` /
  `_moe_group_layout`: order, dst, block_group and m_pad exactly, and the
  port's block_rows (each block's real rows, 0 on the empty tail blocks);
- `moe_ffn` of one layer against `_moe_ffn_grouped_q` on the same input;
- a tiny qwen3moe model (hidden 512, 4 heads / 2 kv: head_dim 128, E = 4,
  top-2, expert ffn 256, Q4_K with a Q6_K ffn_down_exps on layer 1)
  carried across by `params_from_jax`: prefill logits and 4 teacher-forced
  decode steps, dense and through the page pool, against the JAX engine;
- one ring stage of K8's and K9's decode GEMV modelled in numpy (the
  swizzled copies, ldmatrix, the nibble and int8 decodes into the permuted
  K order, scale and min folds) against (s q - m) @ x^T.

Tolerances: max|got - want| / max|want| < 2e-2 (per routed row for the
grouped matmul) for the kernels' plain versions and the FFN: the JAX
kernels round each dequantized weight (scale * q) to bf16 and the port
keeps it in f32; the routing weights within 1e-5 (f32 softmax of the same
logits); the layout exactly. Whole-model logits within 3e-2: at hidden 512
and head_dim 128 the two packages' bf16 roundings (both round every matmul
output to bf16, at different points) put even a dense model 1.4e-2 to
2.5e-2 apart (a dense llama of these widths 1.4-1.8e-2, a dense qwen3 with
q/k norms up to 2.5e-2; at hidden 256 and head_dim 64 0.5-0.8e-2), while
one wrongly chosen expert moves the logits by ~0.1. The weights have std
0.02 (router logits of std ≈ 0.45).

Near-ties: the two packages may pick different experts for a token whose
k-th and (k+1)-th router logits lie within their rounding of each other.
A compared row whose own token has such a margin (below NEAR_TIE = 0.02)
at any layer is left out and counted; the rows left must be most of them,
and their greedy tokens must agree.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.gguf.quants import quantize as jax_quantize
from nfai_tpu.models import llama as jllama
from nfai_tpu.ops import qtensor as jqt
from nfai_tpu.ops.qmatmul import grouped_supported, qmatmul_grouped as jax_qmatmul_grouped
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.models import KVCache, decode_step, params_from_jax, prefill_step
from nfai_tpu_torch.models import llama as tllama
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.ops.qmatmul import qmatmul_grouped, qmatmul_grouped_plain
from nfai_tpu_torch.ops.qtensor import dequant
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 2e-2
MOE = dict(arch="qwen3moe", n_experts=4, n_experts_used=2, qk_norm=True, hidden=512, n_heads=4,
           n_kv_heads=2, ffn_dim=256, vocab_size=512, tied=False, seed=65, scale=0.02,
           quant=GGMLType.Q4_K, quant_overrides={"blk.1.ffn_down_exps.weight": GGMLType.Q6_K})
# (kind, scale group, mins) of the expert stacks
KINDS = [(GGMLType.Q4_K, 32, True), (GGMLType.Q8_0, 32, False), (GGMLType.Q6_K, 16, False),
         (GGMLType.Q5_K, 32, True), (GGMLType.Q2_K, 16, True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops gain nothing from intra-op threads beside the suite's other
    workers; restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def rel_rows(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def _stacks(kind, e, n, k, seed):
    """E experts of one GGUF kind (quantized by the JAX package from one
    seeded draw) as the JAX stacked QTensor (what `mat3` builds) and the
    port's [E, N, ...] container."""
    rng = np.random.default_rng(seed)
    raws = [jax_quantize((rng.standard_normal((n, k)) * 0.05).astype(np.float32),
                         JGGMLType[kind.name]) for _ in range(e)]
    parts = [jqt.pack_gguf_tensor(r, JGGMLType[kind.name], (n, k), device_put=False) for r in raws]
    f = parts[0]
    jw = jqt.QTensor(np.stack([p.qs for p in parts]), np.stack([p.scales for p in parts]),
                     None if f.mins is None else np.stack([p.mins for p in parts]),
                     f.kind, k, n, f.group)
    tw = tqt.pack_gguf_tensor(np.concatenate(raws), kind, (e * n, k))
    return jw, tw._map(lambda t: t.reshape(e, n, *t.shape[1:]), n=n)


# experts of 0, 3, tm + 2 (over two blocks) and 1 rows
def _routing(tm):
    sizes = [0, 3, tm + 2, 1]
    flat = np.repeat(np.arange(4), sizes)
    return np.random.default_rng(tm).permutation(flat)


@pytest.mark.parametrize("tm", [8, 32, 128])
@pytest.mark.parametrize("kind,group,mins", KINDS, ids=lambda v: getattr(v, "name", str(v)))
def test_qmatmul_grouped_plain_vs_jax(kind, group, mins, tm):
    e, n, k = 4, 256, 512 if kind == GGMLType.Q4_K else 256
    jw, tw = _stacks(kind, e, n, k, seed=group + tm)
    assert (tw.group, tw.mins is not None) == (group, mins)
    assert grouped_supported(jw.replace(qs=None, scales=None, mins=None), tm)  # the Pallas kernel
    flat = _routing(tm)
    rows = flat.size
    jorder, jdst, jbg, m_pad = jllama._moe_group_layout(jnp.asarray(flat, jnp.int32), rows, e, tm)
    order, dst, bg, br, tm_pad = tllama.moe_group_layout(torch.from_numpy(flat), rows, e, tm)
    assert tm_pad == m_pad
    x = np.zeros((m_pad, k), np.float32)
    x[np.asarray(jdst)] = np.random.default_rng(1).standard_normal((rows, k))
    x = x.astype(jnp.bfloat16).astype(np.float32)  # both sides take bf16 rows
    want = np.asarray(jax_qmatmul_grouped(jnp.asarray(x, jnp.bfloat16), jw, jbg, tm), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = qmatmul_grouped_plain(xt, tw, bg, tm, br).float().numpy()
    d = dst.numpy()
    assert rel_rows(got[d], want[d]) < TOL
    pad = np.setdiff1d(np.arange(m_pad), d)
    assert not got[pad].any()  # padding rows and unused blocks are zero
    np.testing.assert_array_equal(qmatmul_grouped(xt, tw, bg, tm, br).float().numpy(), got)


@pytest.mark.parametrize("n,e,used", [(1, 8, 2), (8, 16, 4), (300, 4, 2), (2100, 8, 2)])
def test_route_and_layout_vs_jax(n, e, used):
    """Decode (tm 8), prefill (tm 32) and long prefill (tm 128) row counts."""
    rng = np.random.default_rng(n)
    h = 64
    x = rng.standard_normal((n, h)).astype(np.float32)
    router = (rng.standard_normal((h, e)) * 0.2).astype(np.float32)
    cfg = jllama.LlamaConfig(vocab_size=8, hidden_size=h, n_layers=1, n_heads=1, n_kv_heads=1,
                             head_dim=h, ffn_dim=h, n_experts=e, n_experts_used=used)
    jv, ji = jllama._moe_route(jnp.asarray(x), {"router": jnp.asarray(router)}, cfg)
    tv, ti = tllama.moe_route(torch.from_numpy(x), torch.from_numpy(router), used, True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    rows = n * used
    tm = tllama.group_tm(rows)
    assert tm == (8 if rows <= 512 else 32 if rows <= 4096 else 128)
    jorder, jdst, jbg, jm = jllama._moe_group_layout(jnp.asarray(ji).reshape(-1), rows, e, tm)
    order, dst, bg, br, m_pad = tllama.moe_group_layout(ti.reshape(-1), rows, e, tm)
    assert m_pad == jm
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    bg, br = bg.numpy(), br.numpy()
    np.testing.assert_array_equal(bg, np.asarray(jbg))
    # block_rows: each block's rows of its expert, together every routed row once
    assert br.sum() == rows and br.max() <= tm
    blocks = dst.numpy() // tm
    np.testing.assert_array_equal(np.bincount(blocks, minlength=bg.size), br)


@pytest.fixture(scope="module")
def moe_engines(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("moe") / "qwen3moe.gguf", **MOE)
    je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    conv = params_from_jax(jax.tree.map(np.asarray, je.params), te.model_cfg)
    return je, te, conv


def test_load_params_keeps_expert_stacks_quantized(moe_engines):
    """load_params: [L, E, N, K/2] 4-bit gate/up stacks, down per layer in
    its own kind (4-bit on layer 0, Q6_K's 8-bit on layer 1), f32 routers
    [L, H, E] and q/k norms [L, D]; params_from_jax carries the JAX stacks
    (v2 4-bit, 8-bit promoted and unified) across to the same weights."""
    je, te, conv = moe_engines
    lp, cl = te.params["layers"], conv["layers"]
    assert tuple(lp["w_gate_exps"].qs.shape) == (2, 4, 256, 256)
    assert [type(lp["w_down_exps"].layer(i)).__name__ for i in range(2)] == ["Q4Tensor", "Q8Tensor"]
    assert lp["w_down_exps"].layer(1).group == 16
    assert tuple(lp["router"].shape) == (2, 512, 4) and lp["router"].dtype == torch.float32
    assert tuple(lp["q_norm"].shape) == (2, 128) and te.params["fused_mlp"] is False
    for key in ("w_gate_exps", "w_up_exps", "w_down_exps", "wo"):
        for i in range(2):
            a, b = dequant(cl[key].layer(i)).numpy(), dequant(lp[key].layer(i)).numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-20 * np.abs(b).max())
    for key in ("router", "q_norm", "k_norm", "attn_norm"):
        np.testing.assert_array_equal(cl[key].numpy(), lp[key].numpy())


@pytest.mark.parametrize("layer", [0, 1])
def test_moe_ffn_vs_jax(moe_engines, layer):
    """One layer's MoE FFN on the same [2, 5, H] input: 4-bit down on layer
    0 (the JAX package's 8-bit promotion of it), Q6_K down on layer 1."""
    je, te, conv = moe_engines
    x = np.random.default_rng(layer).standard_normal((2, 5, 512)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[layer], je.params["layers"])
    want = np.asarray(jllama._moe_ffn_grouped_q(jnp.asarray(x), lp, je.model_cfg, jax.nn.silu))
    got = tllama.moe_ffn(conv, te.model_cfg, torch.from_numpy(x), layer)
    assert got.shape == (2, 5, 512)
    assert rel(got.numpy(), want) < TOL


PROMPT = np.random.default_rng(0).integers(5, 250, 21)
PS, TABLE, T = 16, [[5, 2, 7, 3]], 32
TOL_MODEL, NEAR_TIE = 3e-2, 0.02


@pytest.fixture
def router_margins(monkeypatch):
    """Records, per call of the port's `moe_route` (one per layer and
    forward), each token's gap between its k-th and (k+1)-th router logit."""
    calls = []
    route = tllama.moe_route

    def recording(x, router, n_used, norm_topk):
        top = torch.topk(x.float() @ router.float(), n_used + 1, dim=-1).values
        calls.append((top[:, n_used - 1] - top[:, n_used]).numpy())
        return route(x, router, n_used, norm_topk)

    monkeypatch.setattr(tllama, "moe_route", recording)
    return calls


def _chunk():
    tokens = np.zeros((1, T), np.int64)
    tokens[0, : PROMPT.size] = PROMPT
    return tokens, np.arange(T)[None], np.array([PROMPT.size - 1])


def _teacher_forced(je, te, params, paged):
    """Prefill logits and 4 teacher-forced decode steps of JAX and the port
    (with `params`), dense or through a shuffled 4-page table; returns the
    list of (port, JAX) logits."""
    jcfg, cfg = je.model_cfg, te.model_cfg
    tokens, positions, last = _chunk()
    out = []
    if paged:
        jc = JPagedKVCache.zeros(jcfg, n_pages=9, page_size=PS, dtype=jnp.float32)
        tc = PagedKVCache.zeros(cfg, 9, PS, torch.float32)
        jt, tt = jnp.asarray(TABLE, jnp.int32), torch.tensor(TABLE, dtype=torch.int32)
        jl, jc = jllama.paged_prefill_step(je.params, jcfg, jnp.asarray(tokens, jnp.int32),
                                           jnp.asarray(positions, jnp.int32),
                                           jnp.asarray(last, jnp.int32), jc, jt)
        tl, tc = tllama.paged_prefill_step(params, cfg, *(torch.from_numpy(a) for a in (
            tokens, positions, last)), tc, tt)
    else:
        jc, tc = je.new_cache(1), KVCache.zeros(cfg, 1, 64, torch.float32)
        jl, jc = jllama.prefill_step(je.params, jcfg, jnp.asarray(tokens, jnp.int32),
                                     jnp.asarray(positions, jnp.int32),
                                     jnp.asarray(last, jnp.int32), jc)
        tl, tc = prefill_step(params, cfg, *(torch.from_numpy(a) for a in (tokens, positions, last)),
                              tc)
    out.append((tl.numpy(), np.asarray(jl)))
    pos = PROMPT.size
    for tok in (17, 99, 200, 42):
        if paged:
            h, jc = jllama.forward(je.params, jcfg, jnp.asarray([[tok]], jnp.int32),
                                   jnp.asarray([[pos]], jnp.int32), jc, page_tables=jt)
            jl = jllama.logits_for(je.params, h, jcfg)[:, 0]
            tl, tc = decode_step(params, cfg, torch.tensor([tok]), torch.tensor([pos]), tc,
                                 page_tables=tt)
        else:
            jl, jc = jllama.decode_step(je.params, jcfg, jnp.asarray([tok], jnp.int32),
                                        jnp.asarray([pos], jnp.int32), jc)
            tl, tc = decode_step(params, cfg, torch.tensor([tok]), torch.tensor([pos]), tc)
        out.append((tl.numpy(), np.asarray(jl)))
        pos += 1
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_qwen3moe_model_vs_jax(moe_engines, router_margins, paged):
    je, te, conv = moe_engines
    rows = _teacher_forced(je, te, conv, paged)
    n_layers = te.model_cfg.n_layers
    assert len(router_margins) == n_layers * len(rows)
    # each compared row's own token: the prompt's last, then the decode tokens
    own = [router_margins[i][PROMPT.size - 1 if i < n_layers else 0]
           for i in range(len(router_margins))]
    margin = np.asarray(own).reshape(len(rows), n_layers).min(1)
    near = margin < NEAR_TIE
    print(f"{'paged' if paged else 'dense'}: {int(near.sum())} of {len(rows)} rows left out "
          f"(router margins {np.round(margin, 3).tolist()})")
    assert near.sum() <= 1
    for step, (got, want) in enumerate(rows):
        if not near[step]:
            assert rel(got, want) < TOL_MODEL, step
            assert int(got.argmax()) == int(want.argmax()), step


def test_qwen3moe_engine_greedy_vs_jax(moe_engines):
    """The port's own load_params, through InferenceEngine.generate."""
    je, te, _ = moe_engines
    ids = [int(t) for t in PROMPT]
    from nfai_tpu.config import SamplingParams as JSamplingParams
    from nfai_tpu_torch.config import SamplingParams

    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=8)))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=8)))
    assert got == want


@pytest.mark.parametrize("kind", ["q4", "q8_g16", "q8_g32_mins"])
def test_grouped_gemv_stage_fragment_mapping(kind):
    """One ring stage of K8 / K9's decode GEMV (csrc/grouped_matmul.cu,
    `grouped_gemv_kernel`), modelled in numpy: the lanes' 16-byte copies of
    16 code rows x 128 bytes into the stage with chunk c of row r at
    c ^ (r & 7), the ldmatrix lanes' addresses and the words they hand to
    lane (g, t), the nibble decode (A = 128 + q, one lop3) or K6's int8 one
    (A = q) of those words into the A slots' permuted K order, x's B
    fragment in the same order, the m16n8k16 products, each scale group's
    f32 scale and its min (K8: min + 128 scale) times the group's x sum
    staged beside the fragments: the C fragments equal (s q - m) @ x^T for
    the stage's 16 rows and 8 x rows (two of them live, the rest zero)."""
    q4, g32, mins = kind == "q4", "g32" in kind, kind == "q4" or kind.endswith("mins")
    cpb, bps = (32, 1) if q4 else (16, 2 if g32 else 1)
    ncodes, rows = 8 * cpb, 2
    rng = np.random.default_rng(len(kind))
    raw = rng.integers(0, 256, (16, 128), dtype=np.uint8)  # the stage's code bytes, 8 blocks a row
    groups = 8 // bps
    sc = rng.random((16, groups), dtype=np.float32) * 1e-2
    mn = rng.random((16, groups), dtype=np.float32) * 5e-2 if mins else np.zeros((16, groups), np.float32)
    x = np.zeros((8, ncodes), np.float32)
    x[:rows] = rng.standard_normal((rows, ncodes)).astype(np.float32)
    if q4:  # natural order: byte j of 32-block b holds code 32b+j low, 32b+16+j high
        q = np.empty((16, ncodes), np.float32)
        for b in range(8):
            blk = raw[:, 16 * b:16 * b + 16]
            q[:, 32 * b:32 * b + 16], q[:, 32 * b + 16:32 * b + 32] = blk & 0xF, blk >> 4
    else:
        q = raw.view(np.int8).astype(np.float32)
    w = np.repeat(sc, cpb * bps, 1) * q - np.repeat(mn, cpb * bps, 1)
    want = w @ x.T  # [16 weight rows, 8 x rows]

    stage = np.zeros(16 * 128, np.uint8)  # the copies: lane (rq, cq), rows rq + 4k
    written = np.zeros((16, 8), int)
    for lane in range(32):
        rq, cq = lane >> 3, lane & 7
        for k in range(4):
            r = rq + 4 * k
            dst = r * 128 + 16 * (cq ^ (r & 7))
            stage[dst:dst + 16] = raw[r, 16 * cq:16 * cq + 16]
            written[r, cq] += 1
    assert (written == 1).all()
    words = stage.view("<u4")  # 4-byte words of the stage

    def ldmatrix(ch0):
        """register j of lane (g, t): word t of the 16-byte row that lane 8j + g addresses"""
        addr = []
        for lane in range(32):
            lr, ch = (lane & 7) + 8 * ((lane >> 3) & 1), ch0 + (lane >> 4)
            addr.append(lr * 128 + 16 * (ch ^ (lr & 7)))
        return [[int(words[(addr[8 * j + (lane >> 2)] >> 2) + (lane & 3)]) for j in range(4)]
                for lane in range(32)]

    def nib2(v):  # the kernel's nib2 (GV_Q128): 128 + the codes at bits 0-3 and 16-19 of v
        return [128.0 + (v & 0xF), 128.0 + ((v >> 16) & 0xF)]

    def i8x2(v):  # K6's i8x2: the int8 codes at bits 0-7 and 16-23 of v
        return [float(((v & 0xFF) ^ 0x80) - 0x80), float((((v >> 16) & 0xFF) ^ 0x80) - 0x80)]

    xsum = x.reshape(8, groups, cpb * bps).sum(-1)  # [x rows, scale groups], staged beside the fragments
    acc = np.zeros((32, 4))
    p = None
    for pr in range(4):
        reg = ldmatrix(2 * pr)
        for h in range(2):
            b = 2 * pr + h
            if b % bps == 0:
                p = np.zeros((16, 8))
            halves = 2 if q4 else 1
            for half in range(halves):
                A, B = np.zeros((16, 16)), np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    w0, w1 = reg[lane][2 * h], reg[lane][2 * h + 1]
                    sh = 4 * half
                    dec = (lambda v: nib2(v >> sh)) if q4 else i8x2
                    A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = dec(w0), dec(w1)
                    A[g, 2 * t + 8:2 * t + 10], A[g + 8, 2 * t + 8:2 * t + 10] = dec(w0 >> 8), dec(w1 >> 8)
                    seg = x[g, b * cpb + 16 * half:b * cpb + 16 * half + 16]  # B: lane (g, t) holds column g
                    B[2 * t:2 * t + 2, g] = seg[[4 * t, 4 * t + 2]]
                    B[2 * t + 8:2 * t + 10, g] = seg[[4 * t + 1, 4 * t + 3]]
                p += A @ B
            if b % bps == bps - 1:
                gi = b // bps
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for e in range(4):
                        r, m = g + 8 * (e >> 1), 2 * t + (e & 1)
                        min_r = mn[r, gi] + (128.0 * sc[r, gi] if q4 else 0.0)
                        acc[lane, e] += sc[r, gi] * p[r, m] - min_r * xsum[m, gi]
    got = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        got[g, 2 * t:2 * t + 2], got[g + 8, 2 * t:2 * t + 2] = acc[lane, :2], acc[lane, 2:]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert not got[:, rows:].any()
