"""The dense-weight route against the JAX package (port on the CPU):

- K11's plain version (`dense_matmul_plain`) against the JAX
  `_dense_matmul_layered` Pallas kernel in interpret mode, at shapes its
  tiles divide (K = 1152 among them), and against the JAX `linear_layered`
  where they do not (its XLA fallback, the same function); per output row,
  max|Δ| / max|ref| ≤ 1e-2 in bf16 (both round the f32 sum once), ≤ 1e-5
  in f32 (only the summation order differs);
- `load_params` against the JAX `load_params` on the same file, decision by
  decision: the same keys, the same dense-or-quantized choice per key, and
  bit-equal dense arrays in bf16 (after the [K, N] / [N, K] transpose), on
  tiny F16 (tied), BF16 (untied), Gemma-3-1B-mix (Q5_0 where K % 256 != 0,
  Q8_0 attn_v and Q6_K ffn_down on llama.cpp's `use_more_bits` layers,
  Q4_K, a tied Q8_0 table), IQ4_NL-mixed and `param_dtype` fixtures;
- whole models against the JAX engine (both in float32): prefill logits
  within 2e-2 (5e-2 on an int8 cache, each package quantizing its own K/V)
  and 8 greedy tokens equal unless the JAX logits hold a near-tie there, on
  the F16 llama, the Gemma-3-1B mix, qwen3moe with
  `param_dtype="float32"` (dense experts) and the F16 llama on int8 caches;
- the port with itself: the paged forwards against the dense ones (1e-4,
  the same greedy tokens), `params_from_jax` on the JAX engine's dense
  leaves against `load_params` (1e-4), the dense and paged BatchEngine
  against `InferenceEngine.generate`, and `param_dtype` checking.
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
from nfai_tpu.ops import qmatmul as jqm
from nfai_tpu.ops.qtensor import QTensor
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from nfai_tpu_torch.gguf.quants import IQ4_NL_VALUES, dequantize
from nfai_tpu_torch.models import (
    KVCache, LlamaConfig, decode_loop, load_params, paged_decode_loop, paged_prefill_step,
    params_from_jax, prefill_step,
)
from nfai_tpu_torch.ops import qmatmul as tqm
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf, random_float_bytes, use_more_bits

TOL = 2e-2
TOL_INT8 = 5e-2
N_NEW = 8
PROMPT = "The quick brown fox jumps over the lazy dog. " * 2
NARROW = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512, vocab_size=512)


def _gemma3_mix(n_layers: int) -> dict:
    """llama.cpp's Q4_K_M choices for Gemma-3-1B where hidden % 256 != 0
    (quant Q5_0 for q/k/gate/up): attn_v Q5_0, or Q8_0 on the
    `use_more_bits` layers; attn_output Q4_K; ffn_down Q4_K or Q6_K; a Q8_0
    token table."""
    out = {"token_embd.weight": GGMLType.Q8_0}
    for i in range(n_layers):
        more = use_more_bits(i, n_layers)
        out[f"blk.{i}.attn_v.weight"] = GGMLType.Q8_0 if more else GGMLType.Q5_0
        out[f"blk.{i}.attn_output.weight"] = GGMLType.Q4_K
        out[f"blk.{i}.ffn_down.weight"] = GGMLType.Q6_K if more else GGMLType.Q4_K
    return out


# hidden 384: K = 384 rows take no k-quant (Q5_0 there), N = 384 stays
# quantizable, so wo and ffn_down keep their containers (ffn_down a LayerList)
GEMMA3_MIX = dict(arch="gemma3", hidden=384, n_layers=6, n_heads=4, n_kv_heads=1, key_length=128,
                  ffn_dim=512, vocab_size=512, post_norms=True, qk_norm=True, sliding_window=8,
                  rope_base=1e6, seed=73, scale=0.02, quant=GGMLType.Q5_0,
                  quant_overrides=_gemma3_mix(6))
# IQ4_NL (written over these tensors after the fact: no package encodes it)
# and Q5_1 beside Q4_K; wk/wv at N = 64 and an F16 ffn_up: dense by shape and kind
IQ4_NL_TENSORS = ("blk.0.attn_q.weight", "blk.1.ffn_gate.weight", "output.weight")
IQ4_MIX = dict(NARROW, n_kv_heads=1, quant=GGMLType.Q4_K, tied=False, seed=5, quant_overrides={
    "blk.0.ffn_down.weight": GGMLType.Q5_1, "blk.1.ffn_up.weight": GGMLType.F16,
    **{name: GGMLType.F32 for name in IQ4_NL_TENSORS}})
MOE = dict(arch="qwen3moe", n_experts=4, n_experts_used=2, qk_norm=True, hidden=512, n_heads=4,
           n_kv_heads=2, ffn_dim=256, vocab_size=512, tied=False, seed=65, scale=0.02,
           quant=GGMLType.Q4_K, quant_overrides={"blk.1.ffn_down_exps.weight": GGMLType.Q6_K})
FIXTURES = {
    "f16": (dict(NARROW, quant=GGMLType.F16, tied=True, seed=3, scale=0.08), {}),
    "bf16": (dict(NARROW, quant=GGMLType.BF16, tied=False, seed=4), {}),
    "gemma3_mix": (GEMMA3_MIX, {}),
    "iq4_mix": (IQ4_MIX, {}),
    "q4_k_param_dtype": (dict(NARROW, quant=GGMLType.Q4_K, tied=True, seed=6),
                         {"param_dtype": "float32"}),
    "moe_param_dtype": (MOE, {"param_dtype": "float32"}),
}


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
    """The worst over rows of max|got - want| / max|want| within a row."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def _iq4_nl_bytes(x: np.ndarray) -> np.ndarray:
    """IQ4_NL blocks of x: f16 d = max|x| / 127 and, per weight, the index of
    the nearest value of the 16-entry table (low nibbles weights 0-15)."""
    x = x.reshape(-1, 32)
    d = (np.abs(x).max(1) / 127).astype(np.float16)
    scaled = x / np.maximum(d.astype(np.float32), 1e-8)[:, None]
    idx = np.abs(scaled[:, :, None] - IQ4_NL_VALUES).argmin(-1).astype(np.uint8)
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, :2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = idx[:, :16] | (idx[:, 16:] << 4)
    return out.reshape(-1)


def _with_iq4_nl(src, dst, names):
    """A copy of the GGUF at `src` with the tensors `names` re-encoded as IQ4_NL."""
    with GGUFFile.open(src) as g:
        w = GGUFWriter()
        for k, v in g.metadata.items():
            if k != "general.alignment":
                w.add(k, v)
        for name, desc in g.tensors.items():
            if name in names:
                kind, raw = GGMLType.IQ4_NL, _iq4_nl_bytes(g.tensor_f32(name))
            else:
                kind, raw = desc.ggml_type, np.array(g.tensor_bytes(name)).view(np.uint8).reshape(-1)
            w.add_tensor(name, np.broadcast_to(np.zeros((), np.float32), desc.shape), kind,
                         raw_bytes=raw)
        return w.write(dst)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    out = {name: make_tiny_llama_gguf(d / f"{name}.gguf", **kw)
           for name, (kw, _) in FIXTURES.items()}
    out["iq4_mix"] = _with_iq4_nl(out["iq4_mix"], d / "iq4_nl.gguf", IQ4_NL_TENSORS)
    return out


def _engines(path, name, **extra):
    cfg = dict(FIXTURES[name][1], **extra)
    je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256, **cfg))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256, **cfg), device="cpu")
    if te.model_cfg.embed_scale != 1.0:  # gemma: llama.cpp's attention scale (ROADMAP §3)
        je.model_cfg = dataclasses.replace(je.model_cfg, attn_scale=te.model_cfg.query_scale)
    return je, te


# -- K11's plain version --------------------------------------------------------


def _stack(rng, l, n, k, dtype):
    return rng.standard_normal((l, k, n)).astype(np.float32) * 0.05  # the JAX [L, K, N]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 2048, 384), (3, 1152, 256),
                                   (64, 256, 1024), (130, 384, 128),
                                   # edges of the card's wgmma tiles: a full 16-row
                                   # tile, one row past the 16-, 64- and 256-row ones
                                   (16, 512, 256), (17, 256, 512), (65, 1024, 384),
                                   (257, 384, 256)])
def test_plain_matches_the_jax_kernel(m, k, n, dtype):
    """Shapes the JAX tiles divide: the Pallas kernel itself (interpret).
    The plain version is what the card's K11 is held to."""
    rng = np.random.default_rng(m * 7 + k)
    w = _stack(rng, 3, n, k, dtype)
    x = rng.standard_normal((m, k)).astype(np.float32)
    tk, tn = jqm._pick_tiles(m, k, n)
    assert k % tk == 0 and n % tn == 0 and tk % 128 == 0  # the kernel's own route
    jd = getattr(jnp, dtype)
    want = jqm._dense_matmul_layered(jnp.asarray(x, jd), 1, jnp.asarray(w, jd), out_dtype=jd)
    td = getattr(torch, dtype)
    wt = torch.from_numpy(w).transpose(1, 2).contiguous().to(td)  # the port's [L, N, K]
    got = tqm.dense_matmul_plain(torch.from_numpy(x).to(td), wt, 1)
    assert got.dtype == td and got.shape == (m, n)
    assert rel_rows(got.float().numpy(), np.asarray(want, np.float32)) <= (
        1e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", [(5, 200, 96), (3, 1000, 130), (17, 72, 40)])
def test_plain_matches_the_jax_fallback(m, k, n, dtype):
    """Shapes the JAX tiles do not divide: its `linear_layered` falls back to
    XLA's x @ w[layer]; K11 takes them with masked tails."""
    rng = np.random.default_rng(m + k + n)
    w = _stack(rng, 2, n, k, dtype)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jqm.linear_layered(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.int32(1))
    wt = torch.from_numpy(w).transpose(1, 2).contiguous().to(td)
    got = tqm.linear_layered(torch.from_numpy(x).to(td), wt, 1)
    assert got.shape == (2, m, n)
    assert rel_rows(got.float().numpy(), np.asarray(want, np.float32)) <= (
        1e-2 if dtype == "bfloat16" else 1e-5)


def test_dense_wrapper_counts_no_launch_on_the_cpu():
    before = tqm.K11.launches
    w = torch.randn(2, 16, 32)
    out = tqm.dense_matmul_layered(torch.randn(3, 32), w, 1)
    assert out.shape == (3, 16) and tqm.K11.launches == before


# -- load_params, decision by decision ---------------------------------------------


def _jax_params(path, quantized):
    with JGGUFFile.open(path) as jg:
        jcfg = jllama.LlamaConfig.from_gguf(jg)
        return jllama.load_params(jg, jcfg, dtype=jnp.bfloat16, device_put=False,
                                  quantized=quantized)


def _bits(a) -> np.ndarray:
    """bf16 bits of a JAX (ml_dtypes) or torch bf16 array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_load_params_makes_the_jax_decisions(paths, name):
    quantized = "param_dtype" not in FIXTURES[name][1]
    want = _jax_params(paths[name], "auto" if quantized else False)
    with GGUFFile.open(paths[name]) as g:
        got = load_params(g, LlamaConfig.from_gguf(g), dtype=torch.bfloat16, quantized=quantized)
    jl, tl = want["layers"], got["layers"]
    # the key set first: the fusion and stacking decisions show there
    assert set(tl) == set(jl)
    for key, leaf in jl.items():
        assert isinstance(tl[key], torch.Tensor) == (not isinstance(leaf, QTensor)), key
        if key.endswith("norm") or key == "router":
            continue
        if isinstance(leaf, QTensor):
            continue
        assert tl[key].dtype == torch.bfloat16
        assert np.array_equal(_bits(tl[key]), _bits(np.swapaxes(np.asarray(leaf), -1, -2))), key
    head = got["lm_head"]
    assert isinstance(head, torch.Tensor) == (not isinstance(want["lm_head"], QTensor))
    assert (got["embed"] is None) == (want["embed"] is None)
    if isinstance(head, torch.Tensor):
        assert np.array_equal(_bits(head), _bits(np.asarray(want["lm_head"]).T))
        if got["embed"] is not None:
            assert np.array_equal(_bits(got["embed"]), _bits(want["embed"]))
    if LlamaConfig.from_gguf(GGUFFile.open(paths[name])).tied_embeddings and isinstance(
            head, torch.Tensor):
        assert got["embed"] is head  # one copy of a dense tied table
    if name == "gemma3_mix":  # split q/k/v; wv dense from Q5_0 and dequantized Q8_0 layers
        assert {"wq", "wk", "wv", "w_gate_up"} <= set(tl) and "wqkv" not in tl
        assert isinstance(tl["wo"], tqt.Q4Tensor) and isinstance(tl["w_down"], tqt.LayerList)
        assert isinstance(head, tqt.Q8Tensor) and got["embed"] is None
    if name == "iq4_mix":
        # q/k/v: dense wk/wv (N = 64) beside layer 1's Q4_K wq stay split;
        # gate/up fuse on each layer (Q4_K pairs, then IQ4_NL with F16), and
        # the fused stack, quantized on layer 0, is dequantized whole
        assert {"wq", "wk", "wv", "w_gate_up"} <= set(tl) and "w_gate" not in tl
        assert all(isinstance(tl[k], torch.Tensor) for k in ("wq", "wk", "wv", "w_gate_up"))
        assert isinstance(tl["wo"], tqt.Q4Tensor) and isinstance(head, torch.Tensor)


# -- whole models against the JAX engine ------------------------------------------


@pytest.fixture(scope="module", params=["f16", "gemma3_mix", "moe_param_dtype", "f16 int8"])
def model(request, paths):
    name = request.param.split()[0]
    extra = {"kv_dtype": "int8"} if request.param.endswith("int8") else {}
    je, te = _engines(paths[name], name, **extra)
    return request.param, je, te


def test_prefill_logits_vs_jax(model):
    name, je, te = model
    ids = te.tokenizer.encode(PROMPT)
    jl, _ = je.prefill(je.new_cache(1), ids)
    tl, _ = te.prefill(te.new_cache(1), ids)
    assert tl.shape == (1, te.model_cfg.vocab_size)
    assert rel(tl.numpy(), np.asarray(jl)) < (TOL_INT8 if name.endswith("int8") else TOL)


def test_greedy_generate_vs_jax(model):
    name, je, te = model
    ids = te.tokenizer.encode(PROMPT)
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=N_NEW)))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=N_NEW)))
    assert len(want) == len(got) == N_NEW
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:  # only a near-tie of the JAX logits may flip a greedy token
            logits = np.asarray(je.prefill(je.new_cache(1), ids + want[:i])[0])[0]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TOL * np.abs(logits).max(), (i, a, b)
            return
    assert got == want


def test_params_from_jax_with_dense_leaves(model):
    """The JAX engine's params (dense stacks, the dense tied head and its
    embed copy, dense experts, mixed dense and quantized keys) carried
    across give the logits of the port's own load_params: within 1e-4 where
    every weight is dense; within 2e-2 beside quantized ones (the JAX v3
    4-bit containers keep their scales in bf16, and a quantized head
    rounds the logits to bf16)."""
    name, je, te = model
    cfg = te.model_cfg
    conv = params_from_jax(jax.tree.map(np.asarray, je.params), cfg)
    for key, w in te.params["layers"].items():  # (the JAX package unifies a LayerList's kinds)
        assert isinstance(conv["layers"][key], torch.Tensor) == isinstance(w, torch.Tensor), key
    if cfg.tied_embeddings and isinstance(conv["lm_head"], torch.Tensor):
        assert conv["embed"] is conv["lm_head"]
    tokens = torch.tensor([te.tokenizer.encode(PROMPT)[:24]])
    out = [prefill_step(p, cfg, tokens, torch.arange(24)[None], torch.tensor([23]),
                        KVCache.zeros(cfg, 1, 64, torch.float32))[0]
           for p in (conv, te.params)]
    weights = list(te.params["layers"].values()) + [te.params["lm_head"]]
    all_dense = all(isinstance(w, torch.Tensor) for w in weights)
    assert rel(out[0].numpy(), out[1].numpy()) < (1e-4 if all_dense else TOL)


# -- the port with itself -----------------------------------------------------------


PS, TABLE, T = 16, [[5, 2, 7, 3]], 32


@pytest.mark.parametrize("name", ["f16", "gemma3_mix"])
def test_paged_forward_matches_dense(paths, name):
    """A prompt and 8 greedy tokens through the dense cache and through the
    page pool: the same arithmetic, different plumbing."""
    te = InferenceEngine(paths[name], EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    cfg, params = te.model_cfg, te.params
    prompt = np.random.default_rng(0).integers(5, 250, 21)
    tokens = torch.zeros(1, T, dtype=torch.long)
    tokens[0, :prompt.size] = torch.from_numpy(prompt)
    positions, last = torch.arange(T)[None], torch.tensor([prompt.size - 1])
    dlogits, dcache = prefill_step(params, cfg, tokens, positions, last,
                                   KVCache.zeros(cfg, 1, 64, torch.float32))
    tables = torch.tensor(TABLE, dtype=torch.int32)
    plogits, pool = paged_prefill_step(params, cfg, tokens, positions, last,
                                       PagedKVCache.zeros(cfg, 9, PS, torch.float32), tables)
    assert rel(plogits.numpy(), dlogits.numpy()) < 1e-4
    first, start = dlogits.argmax(-1), torch.tensor([prompt.size])
    dtoks, dnext, _, _ = decode_loop(params, cfg, first, start, dcache, None, 8, temperature=0.0)
    ptoks, pnext, _, _ = paged_decode_loop(params, cfg, first, start, pool, tables, None, 8,
                                           temperature=0.0)
    assert dtoks.tolist() == ptoks.tolist() and dnext.tolist() == pnext.tolist()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batch_engine_serves_a_dense_model(paths, paged):
    engine = InferenceEngine(paths["bf16"], EngineConfig(dtype="float32", max_seq_len=128,
                                                         page_size=16, prefill_chunk=32),
                             device="cpu")
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(5, 250, n)] for n in (7, 19, 40)]
    s = SamplingParams(temperature=0.0, max_new_tokens=6)
    want = [list(engine.generate(p, s)) for p in prompts]
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=paged)
    reqs = [be.submit(p, s) for p in prompts]
    for _ in range(400):
        if all(r.state == RequestState.FINISHED for r in reqs):
            break
        be.step()
    assert [r.output_ids for r in reqs] == want


def test_param_dtype_is_checked(paths):
    path = paths["q4_k_param_dtype"]
    for bad in ("bf16", "float16", "int8"):
        with pytest.raises(ValueError, match="param_dtype"):
            InferenceEngine(path, EngineConfig(dtype="float32", param_dtype=bad), device="cpu")
    dense = InferenceEngine(path, EngineConfig(dtype="float32", param_dtype="float32"), device="cpu")
    quant = InferenceEngine(path, EngineConfig(dtype="float32"), device="cpu")
    assert all(isinstance(w, torch.Tensor) for w in dense.params["layers"].values())
    assert isinstance(dense.params["lm_head"], torch.Tensor) and dense.params["embed"] is dense.params["lm_head"]
    assert isinstance(quant.params["layers"]["wqkv"], tqt.Q4Tensor) and quant.params["embed"] is None
    # the dense copy holds the quantized weights' values, rounded once to the dtype
    w = quant.params["layers"]["wqkv"]
    assert torch.equal(dense.params["layers"]["wqkv"], tqt.to_dense(w, torch.float32))


def test_to_dense_rounds_once_from_f32():
    rng = np.random.default_rng(9)
    w = tqt.pack_q_values(rng.integers(0, 16, (128, 64)),
                          rng.uniform(1e-3, 1e-2, (128, 2)).astype(np.float32),
                          rng.uniform(0, 1e-2, (128, 2)).astype(np.float32))
    assert torch.equal(tqt.to_dense(w, torch.bfloat16), tqt.dequant(w).to(torch.bfloat16))
    stacked = tqt.stack([tqt.to_dense(w, torch.bfloat16), w])  # a mixed stack goes dense
    assert isinstance(stacked, torch.Tensor) and stacked.shape == (2, 128, 64)
    assert torch.equal(stacked[0], stacked[1])


@pytest.mark.parametrize("kind", [GGMLType.F16, GGMLType.BF16], ids=lambda k: k.name)
def test_random_float_fixture_bytes(kind):
    raw = random_float_bytes(np.random.default_rng(0), 64, 256, kind)
    w = dequantize(raw, 64 * 256, kind)
    assert raw.size == 2 * 64 * 256 and np.isfinite(w).all()
    assert 2**-8 <= np.abs(w).min() and np.abs(w).max() < 2**-4
    assert 0.015 < w.std() < 0.04 and abs(w.mean()) < 2e-3
