"""qwen2, mistral and phi3 beside the JAX package (port on the CPU, JAX on
its CPU backend, Pallas kernels in interpret mode), and the kernel instances
their published widths need:

- the fixture writes the JAX fixture's bytes with `attn_bias` (qwen2) and
  `fused_tensors` (phi3), and `LlamaConfig.from_gguf` reads the JAX
  config's fields (attn_bias, NEOX for qwen2 and phi3, NORM for mistral);
- `load_params` makes the JAX loader's decisions on quantized fixtures:
  which groups fuse (q/k/v stays split on every layer where one layer's
  attn_v is Q6_K, and the biases with it), phi3's pre-fused attn_qkv and
  [gate; up] ffn_up, the fused-MLP container (K5) where the JAX package
  builds one, the kernel family of every weight, and the weights themselves
  (mistral's NORM → NEOX rows) against `params_from_jax` of the JAX
  params, which carries the biases and pre-fused tensors across;
- tiny models (2 layers, f32 weights, f32 activations) through the port's
  own loader against the JAX engine, per logits row within 2e-2 (the slice
  rule; both sides compute in f32, so the gap is far smaller): prefill
  logits, 4 teacher-forced decode steps on the dense cache and through a
  shuffled page table, the verify forward (T = 5 at a row's offset), 16
  greedy tokens from each engine's `generate`, the paged path against the
  dense one; qwen2 also on int8 caches (5e-2: each package quantizes its
  own K/V, the JAX int8 rule);
- the plain versions of K2 and K7 at GQA ratios 5, 6, 7 and 16 (head_dim
  128) and at head_dim 96 (r = 1, Phi-3-mini's 32 / 32), bf16 and int8,
  and K4's at head_dim 96 (r = 1 and 6), against the JAX kernels in
  interpret mode (f32, 1e-4: only the summation order differs); the K/V
  store's plain version at head_dim 96 against the JAX writes exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_kv_store as kv_store_tests
from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models import llama as jllama
from nfai_tpu.models.testing import make_tiny_llama_gguf as jax_make_tiny
from nfai_tpu.ops.fused_decode import layered_decode_attention_slab as jax_decode_attention
from nfai_tpu.ops.paged_attention import paged_flash_decode_attention
from nfai_tpu.ops.prefill_attention import flash_prefill_attention as jax_prefill_attention
from nfai_tpu.ops.qtensor import QTensor
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import (
    KVCache, LlamaConfig, decode_step, load_params, paged_prefill_step, params_from_jax,
    prefill_step, resolve,
)
from nfai_tpu_torch.models.llama import verify_step
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.ops.fused_decode import layered_decode_attention
from nfai_tpu_torch.ops.paged_attention import paged_decode_attention
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 1e-4  # f32 attention, port plain vs JAX interpret kernel
TOL_MODEL = 2e-2  # whole models against the JAX engine, per logits row
TOL_INT8 = 5e-2  # whole models on int8 caches (tests/test_kv_int8.py's rule)
# tiny models of each family: qwen2 at r = 6 (Qwen2.5-1.5B's ratio) with
# biases, mistral (NORM rope, SPM vocabulary) at r = 4, phi3 at head_dim 96
# (Phi-3-mini's) with its pre-fused tensors
FAMILIES = {
    "qwen2": dict(arch="qwen2", attn_bias=True, hidden=384, n_heads=6, n_kv_heads=1, ffn_dim=256,
                  seed=81, scale=0.05),
    "mistral": dict(arch="mistral", spm_tokenizer=True, hidden=256, n_heads=4, n_kv_heads=1,
                    ffn_dim=256, seed=83, scale=0.05),
    "phi3": dict(arch="phi3", fused_tensors=True, hidden=384, n_heads=4, n_kv_heads=4, ffn_dim=256,
                 tied=False, seed=85, scale=0.05),
}
# quantized fixtures for the load decisions: K % 1024 == 0 and F % 256 == 0
# where the fused MLP is in reach; qwen2's layer-0 attn_v in Q6_K keeps
# q/k/v (and the biases) split on every layer, as a Q4_K_M file's does
LOADS = {
    "qwen2_q4k": dict(FAMILIES["qwen2"], hidden=256, n_heads=4, n_kv_heads=2, quant=GGMLType.Q4_K),
    "qwen2_mix": dict(FAMILIES["qwen2"], hidden=256, n_heads=4, n_kv_heads=2, quant=GGMLType.Q4_K,
                      quant_overrides={"blk.0.attn_v.weight": GGMLType.Q6_K}),
    "mistral_q4k": dict(FAMILIES["mistral"], hidden=1024, n_heads=8, n_kv_heads=2, quant=GGMLType.Q4_K),
    "phi3_q4k": dict(FAMILIES["phi3"], hidden=1024, n_heads=8, n_kv_heads=8, quant=GGMLType.Q4_K),
    "phi3_mix": dict(FAMILIES["phi3"], hidden=1024, n_heads=8, n_kv_heads=8, quant=GGMLType.Q4_K,
                     quant_overrides={"blk.1.ffn_down.weight": GGMLType.Q6_K,
                                      "blk.0.attn_qkv.weight": GGMLType.Q6_K}),
    "phi3_f32": dict(FAMILIES["phi3"]),
}
PROMPT = np.random.default_rng(1).integers(5, 250, 21)
PS, TABLE, T = 16, [[5, 2, 7, 3]], 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def rel_rows(got, want):
    """The largest per-row error over the rows of the last axis."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jkw(kw):
    """The fixture's arguments in the JAX package's GGMLType."""
    out = dict(kw)
    if "quant" in kw:
        out["quant"] = JGGMLType[kw["quant"].name]
    if "quant_overrides" in kw:
        out["quant_overrides"] = {k: JGGMLType[v.name] for k, v in kw["quant_overrides"].items()}
    return out


# -- fixtures and config ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2", "mistral", "phi3", "qwen2_mix", "phi3_mix"])
def test_fixture_bytes_and_config_match_jax(tmp_path, name):
    kw = FAMILIES.get(name) or LOADS[name]
    a = make_tiny_llama_gguf(tmp_path / "port.gguf", **kw)
    b = jax_make_tiny(tmp_path / "jax.gguf", **_jkw(kw))
    assert a.read_bytes() == b.read_bytes()
    with GGUFFile.open(a) as g, JGGUFFile.open(b) as jg:
        cfg, jcfg = resolve(g).config_from_gguf(g), jllama.LlamaConfig.from_gguf(jg)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.attn_bias == (kw["arch"] == "qwen2")
    assert cfg.rope_neox == (kw["arch"] != "mistral")
    assert cfg.sliding_window == 0 and cfg.swa_pattern == 0  # no window read for these three


# -- load decisions ----------------------------------------------------------------------


def _family(w) -> str:
    """The kernel family a port weight lands in."""
    if isinstance(w, torch.Tensor):
        return "dense"
    if isinstance(w, tqt.LayerList):
        return "mixed"
    return "4-bit" if isinstance(w, tqt.Q4Tensor) else "8-bit"


def _jfamily(leaf) -> str:
    if not isinstance(leaf, QTensor):
        return "dense"
    return "4-bit" if leaf.kind.startswith("q4") else "8-bit"


@pytest.fixture(scope="module")
def loads(tmp_path_factory):
    """name -> (config, port load_params, JAX load_params as numpy,
    params_from_jax of it, the GGUF's path)."""
    out = {}
    for name, kw in LOADS.items():
        path = make_tiny_llama_gguf(tmp_path_factory.mktemp(name) / "m.gguf", **kw)
        with JGGUFFile.open(path) as jg:
            jp = jllama.load_params(jg, jllama.LlamaConfig.from_gguf(jg), dtype=jnp.float32,
                                    device_put=False, quantized="auto")
        jp = jax.tree.map(np.asarray, jp)
        with GGUFFile.open(path) as g:
            cfg = LlamaConfig.from_gguf(g)
            mine = load_params(g, cfg, dtype=torch.float32)
        out[name] = (cfg, mine, jp, params_from_jax(jp, cfg), path)
    return out


@pytest.mark.parametrize("name", list(LOADS))
def test_load_params_makes_the_jax_decisions(loads, name):
    cfg, mine, jp, _, _ = loads[name]
    tl, jl = mine["layers"], jp["layers"]
    assert set(tl) == set(jl)  # which groups fuse, biases with them
    for key, leaf in jl.items():
        if key.endswith(("norm", "bias")):
            continue
        want = _jfamily(leaf)
        got = _family(tl[key])
        # a stack mixing kinds: the JAX package promotes it to 8 bits, the
        # port keeps it per layer (K1 and K6 both run: the same function)
        assert got == want or (got == "mixed" and want == "8-bit"), key
    # the fused-MLP container (K5) exactly where the JAX package builds it
    gu = jl.get("w_gate_up")
    assert mine["fused_mlp"] == (isinstance(gu, QTensor) and gu.kind == "q4mlpg")
    assert _family(mine["lm_head"]) == _jfamily(jp["lm_head"])
    fused_qkv = "wqkv" in tl
    if name == "qwen2_mix":
        assert not fused_qkv and {"wq_bias", "wk_bias", "wv_bias"} <= set(tl) and "wqkv_bias" not in tl
        assert isinstance(tl["wv"], tqt.LayerList)
    if name == "qwen2_q4k":
        assert fused_qkv and "wqkv_bias" in tl and "wq_bias" not in tl
    if name.startswith("phi3"):
        assert fused_qkv and "w_gate_up" in tl and "w_gate" not in tl
    assert mine["fused_mlp"] == (name in ("mistral_q4k", "phi3_q4k"))


@pytest.mark.parametrize("name", list(LOADS))
def test_params_from_jax_equals_load_params(loads, name):
    """The JAX params carried across (biases and pre-fused tensors included)
    hold the port loader's weights: the matmul weights within f32 rounding
    of the JAX containers' folds (the fused-MLP containers within 2e-2: the
    JAX package stores their scales in bf16, tests/test_torch_fused_mlp.py),
    the biases and norms exactly, mistral's wq/wk rows in the same NORM →
    NEOX order."""
    cfg, mine, jp, conv, path = loads[name]
    tl, cl = mine["layers"], conv["layers"]
    assert set(tl) == set(cl)
    for key in tl:
        if key.endswith(("norm", "bias")):
            torch.testing.assert_close(tl[key], cl[key], rtol=0, atol=0)
            continue
        bf16_scales = getattr(jp["layers"][key], "kind", "") in ("q4mlpg", "q4mlpd")
        for i in range(cfg.n_layers):
            a = tl[key][i] if isinstance(tl[key], torch.Tensor) else tqt.dequant(tl[key].layer(i))
            b = cl[key][i] if isinstance(cl[key], torch.Tensor) else tqt.dequant(cl[key].layer(i))
            if bf16_scales:
                assert rel(a.numpy(), b.numpy()) < TOL_MODEL, (key, i)
                continue
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2.0**-20 * float(b.abs().max()),
                                       err_msg=f"{key} layer {i}")
    if cfg.attn_bias:  # the GGUF's f32 bias, exactly (k: the middle of a fused bias)
        with GGUFFile.open(path) as g:
            want = torch.from_numpy(np.array(g.tensor_f32("blk.1.attn_k.bias")))
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        got = tl["wk_bias"][1] if "wk_bias" in tl else tl["wqkv_bias"][1][qd:qd + kvd]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- whole models against the JAX engine ------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """name -> (JAX engine, port engine) on the tiny f32 model of a family,
    built at first use."""
    built = {}

    def get(name):
        if name not in built:
            path = make_tiny_llama_gguf(tmp_path_factory.mktemp(name) / "m.gguf", **FAMILIES[name])
            je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256))
            te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
            built[name] = je, te
        return built[name]

    return get


def _chunk():
    tokens = np.zeros((1, T), np.int64)
    tokens[0, : PROMPT.size] = PROMPT
    return tokens, np.arange(T)[None], np.array([PROMPT.size - 1])


def _port_run(te, paged, quant):
    cfg, params = te.model_cfg, te.params
    tokens, positions, last = (torch.from_numpy(a) for a in _chunk())
    if paged:
        cache = PagedKVCache.zeros(cfg, 9, PS, torch.float32, quantized=quant)
        tables = torch.tensor(TABLE, dtype=torch.int32)
        logits, cache = paged_prefill_step(params, cfg, tokens, positions, last, cache, tables)
    else:
        cache, tables = KVCache.zeros(cfg, 1, 64, torch.float32, quantized=quant), None
        logits, cache = prefill_step(params, cfg, tokens, positions, last, cache)
    out, pos = [logits.numpy()], PROMPT.size
    for tok in (17, 99, 200, 42):
        logits, cache = decode_step(params, cfg, torch.tensor([tok]), torch.tensor([pos]), cache,
                                    page_tables=tables)
        out.append(logits.numpy())
        pos += 1
    return out


def _jax_run(je, paged, quant):
    jcfg = je.model_cfg
    tokens, positions, last = (jnp.asarray(a, jnp.int32) for a in _chunk())
    if paged:
        cache = JPagedKVCache.zeros(jcfg, n_pages=9, page_size=PS, dtype=jnp.float32, quantized=quant)
        tables = jnp.asarray(TABLE, jnp.int32)
        logits, cache = jllama.paged_prefill_step(je.params, jcfg, tokens, positions, last, cache, tables)
    else:
        cache = jllama.KVCache.zeros(jcfg, 1, 64, jnp.float32, quantized=quant)
        logits, cache = jllama.prefill_step(je.params, jcfg, tokens, positions, last, cache)
    out, pos = [np.asarray(logits)], PROMPT.size
    for tok in (17, 99, 200, 42):
        if paged:
            h, cache = jllama.forward(je.params, jcfg, jnp.asarray([[tok]], jnp.int32),
                                      jnp.asarray([[pos]], jnp.int32), cache, page_tables=tables)
            logits = jllama.logits_for(je.params, h, jcfg)[:, 0]
        else:
            logits, cache = jllama.decode_step(je.params, jcfg, jnp.asarray([tok], jnp.int32),
                                               jnp.asarray([pos], jnp.int32), cache)
        out.append(np.asarray(logits))
        pos += 1
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_model_vs_jax(engines, name, paged):
    """Prefill logits and 4 teacher-forced decode steps (dense decode: K2's
    plain version, the store; paged: K7's, the paged store) per row within
    2e-2 of the JAX engine, with the same greedy tokens."""
    je, te = engines(name)
    got, want = _port_run(te, paged, False), _jax_run(je, paged, False)
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel_rows(g, w) < TOL_MODEL, (name, step)
        assert int(g.argmax()) == int(w.argmax()), (name, step)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_qwen2_int8_cache_vs_jax(engines, paged):
    je, te = engines("qwen2")
    got, want = _port_run(te, paged, True), _jax_run(je, paged, True)
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel_rows(g, w) < TOL_INT8, step


@pytest.mark.parametrize("name", list(FAMILIES))
def test_paged_equals_dense(engines, name):
    _, te = engines(name)
    dense, paged = _port_run(te, False, False), _port_run(te, True, False)
    for step, (d, p) in enumerate(zip(dense, paged)):
        assert rel_rows(p, d) < 1e-5, (name, step)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_verify_forward_vs_jax(engines, name):
    """The verify forward (the speculative path's T = gamma + 1 tokens at
    a row's offset, through `_qkv` and K4's plain version) after the
    prompt's prefill, against the JAX `verify_step`."""
    je, te = engines(name)
    tokens, positions, last = _chunk()
    cand = np.array([[17, 99, 200, 42, 7]])
    cpos = PROMPT.size + np.arange(cand.shape[1])[None]
    cache = KVCache.zeros(te.model_cfg, 1, 64, torch.float32)
    _, cache = prefill_step(te.params, te.model_cfg, *(torch.from_numpy(a) for a in (tokens, positions, last)),
                            cache)
    got, _ = verify_step(te.params, te.model_cfg, torch.from_numpy(cand), torch.from_numpy(cpos), cache)
    jcache = jllama.KVCache.zeros(je.model_cfg, 1, 64, jnp.float32)
    _, jcache = jllama.prefill_step(je.params, je.model_cfg, *(jnp.asarray(a, jnp.int32)
                                                               for a in (tokens, positions, last)), jcache)
    want, _ = jllama.verify_step(je.params, je.model_cfg, jnp.asarray(cand, jnp.int32),
                                 jnp.asarray(cpos, jnp.int32), jcache)
    assert got.shape == (1, cand.shape[1], te.model_cfg.vocab_size)
    assert rel_rows(got.numpy(), np.asarray(want)) < TOL_MODEL


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sixteen_greedy_tokens_equal_jax(engines, name):
    je, te = engines(name)
    ids = [int(i) for i in PROMPT]
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=16, seed=0)))
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=16, seed=0)))
    assert len(got) == 16 and got == want, name


# -- the kernels' plain versions at the new ratios and head width ------------------------

# (r, head_dim): Qwen2.5-1.5B's 12 / 2, Qwen2.5-7B's 28 / 4, Qwen3-14B's 40 /
# 8, Qwen3-235B-A22B's 64 / 4, and Phi-3-mini's 32 / 32 at head_dim 96
SHAPES = [(6, 128), (7, 128), (5, 128), (16, 128), (1, 96)]


def _codes(rng, lead, hkv, d):
    """Random K or V rows [*lead, Hkv*D] quantized by the JAX package."""
    q, s = jllama.quantize_kv(jnp.asarray(_f32(rng, *lead, hkv * d)), hkv)
    return np.array(q), np.array(s)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r,d", SHAPES)
def test_decode_attention_plain_vs_jax(r, d, quant):
    rng = np.random.default_rng(7 * r + d + quant)
    l, b, s, hkv = 2, 3, 256, 2
    q, kn, vn = _f32(rng, b, hkv * r, d), _f32(rng, b, hkv * d), _f32(rng, b, hkv * d)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = _codes(rng, (l, b, s), hkv, d), _codes(rng, (l, b, s), hkv, d)
        sc = dict(k_scales=np.swapaxes(ks, 2, 3).copy(), v_scales=np.swapaxes(vs, 2, 3).copy())
    else:
        kc, vc = _f32(rng, l, b, s, hkv * d), _f32(rng, l, b, s, hkv * d)
    starts = np.array([0, 130, s - 1], np.int32)
    args = (q, kn, vn, kc, vc)
    want = np.asarray(jax_decode_attention(*map(jnp.asarray, args), jnp.int32(1), jnp.asarray(starts),
                                           s_block=128, interpret=True,
                                           **{k: jnp.asarray(v) for k, v in sc.items()}))
    got = layered_decode_attention(*map(torch.from_numpy, args), 1, torch.from_numpy(starts),
                                   **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert got.shape == (b, hkv * r, d)
    assert rel_rows(got.numpy(), want) < TOL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r,d", SHAPES)
def test_paged_attention_plain_vs_jax(r, d, quant):
    rng = np.random.default_rng(11 * r + d + quant)
    b, hkv, ps, n_p = 4, 2, 16, 4
    n_pages = b * n_p + 3
    q = _f32(rng, b, hkv * r, d)
    sc = {}
    if quant:
        (kq, ks), (vq, vs) = _codes(rng, (n_pages, ps), hkv, d), _codes(rng, (n_pages, ps), hkv, d)
        kp, vp = (c.reshape(n_pages, ps, hkv, d).transpose(2, 0, 1, 3).copy() for c in (kq, vq))
        sc = dict(k_scales=ks.transpose(2, 0, 1).copy(), v_scales=vs.transpose(2, 0, 1).copy())
    else:
        kp, vp = _f32(rng, hkv, n_pages, ps, d), _f32(rng, hkv, n_pages, ps, d)
    tables = (rng.permutation(n_pages - 1)[: b * n_p] + 1).reshape(b, n_p).astype(np.int32)
    lengths = np.array([1, ps + 1, 50, n_p * ps], np.int32)
    args = (q, kp, vp, tables, lengths)
    want = np.asarray(paged_flash_decode_attention(*map(jnp.asarray, args), interpret=True,
                                                   **{k: jnp.asarray(v) for k, v in sc.items()}))
    got = paged_decode_attention(*map(torch.from_numpy, args),
                                 **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert rel_rows(got.numpy(), want) < TOL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 6])
def test_prefill_attention_d96_plain_vs_jax(r, quant):
    rng = np.random.default_rng(13 * r + quant)
    b, t, s, hkv, d = 2, 64, 256, 2, 96
    q = _f32(rng, b, t, hkv * r, d)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = _codes(rng, (b, s), hkv, d), _codes(rng, (b, s), hkv, d)
        sc = dict(k_scales=np.swapaxes(ks, 1, 2).copy(), v_scales=np.swapaxes(vs, 1, 2).copy())
    else:
        kc, vc = _f32(rng, b, s, hkv * d), _f32(rng, b, s, hkv * d)
    offsets = np.array([100, 0], np.int32)
    want = np.asarray(jax_prefill_attention(*map(jnp.asarray, (q, kc, vc, offsets)), t_block=64, s_block=128,
                                            interpret=True, kv_layout="full",
                                            **{k: jnp.asarray(v) for k, v in sc.items()}))
    got = flash_prefill_attention(*map(torch.from_numpy, (q, kc, vc, offsets)),
                                  **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert got.shape == (b, t, hkv * r, d)
    assert rel_rows(got.numpy(), want) < TOL


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_kv_store_d96_equals_jax(mode):
    """The dense decode store, a dense prefill chunk and the paged store at
    head_dim 96, exactly as the JAX writes (tests/test_torch_kv_store.py's
    cases at the new width)."""
    kv_store_tests.test_dense_decode_store_equals_jax(96, mode)
    kv_store_tests.test_dense_prefill_store_equals_jax(96, mode, 7)
    kv_store_tests.test_paged_store_equals_jax(96, mode, 5, 16)
