"""The int8 KV cache (`EngineConfig(kv_dtype="int8")`) of the port against
the JAX package's, on the CPU (port: plain versions; JAX: its CPU backend,
Pallas kernels in interpret mode), from numpy inputs made from a seed:

- `quantize_kv` gives JAX's int8 codes and f32 scales exactly (round half
  to even, true division) and `dequant_kv` JAX's values exactly;
- the scale writes: `write_all_layers_t` (K10's plain version) and
  `write_paged_scales` equal the JAX functions exactly, a start >= S
  dropped;
- the plain versions of K2 (decode, new token folded in at full precision),
  K4 (prefill, "full" layout) and K7 (paged decode) with scales match the
  JAX kernels at head_dim 64 and 128, r = 1, 2 and 8, ragged starts
  including 0, in f32: tolerance 1e-4 of max|JAX| (only the summation
  order differs);
- a tiny Llama (Q4_K) and a tiny qwen3 (head_dim 128) with an int8 cache,
  dense and paged, against the JAX engine: prefill logits and 4
  teacher-forced decode steps within the whole-model tolerances of
  test_torch_engine.py (2e-2) and test_torch_qwen.py (3e-2), with equal
  greedy tokens; and the port's int8 cache within 5e-2 of its bf16 cache
  relative to the logit scale (the JAX package's int8 rule,
  tests/test_kv_int8.py);
- serving: `prefill_slot_step` on an int8 lane equals `prefill_step` on a
  batch-1 int8 cache; the dense and paged BatchEngines give the JAX
  BatchEngine's greedy output_ids; a prefix hit and a preemption on the
  int8 pool return every page; an HTTP request on an int8 engine is
  answered.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.models import llama as jllama
from nfai_tpu.ops.fused_decode import (
    layered_decode_attention as jax_layered_decode_attention,
    layered_decode_attention_slab as jax_layered_decode_attention_slab,
    write_all_layers_t as jax_write_all_layers_t,
)
from nfai_tpu.ops.paged_attention import paged_flash_decode_attention
from nfai_tpu.ops.prefill_attention import flash_prefill_attention as jax_flash_prefill_attention
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu.runtime.paged_cache import write_paged_scales as jax_write_paged_scales
from nfai_tpu.runtime.scheduler import BatchEngine as JBatchEngine
from nfai_tpu_torch import server as srv
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.models import (
    KVCache, decode_step, paged_prefill_step, params_from_jax, prefill_slot_step, prefill_step,
)
from nfai_tpu_torch.models.llama import dequant_kv, quantize_kv
from nfai_tpu_torch.ops.fused_decode import (
    layered_decode_attention, write_all_layers_t, write_all_layers_t_plain,
)
from nfai_tpu_torch.ops.paged_attention import paged_decode_attention
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache, write_paged_scales
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 1e-4  # f32 attention, port plain vs JAX interpret kernel
TOL_LLAMA, TOL_QWEN = 2e-2, 3e-2  # whole models (test_torch_engine.py, test_torch_qwen.py)
INT8_VS_BF16 = 5e-2  # of the logit scale, the JAX package's int8 rule
LLAMA = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512, vocab_size=512,
             quant=GGMLType.Q4_K, tied=False, context_length=256)
QWEN3 = dict(arch="qwen3", qk_norm=True, hidden=512, n_heads=4, n_kv_heads=2, ffn_dim=256,
             vocab_size=512, tied=False, seed=65, scale=0.02, quant=GGMLType.Q4_K)
PS, TABLE = 16, [[5, 2, 7, 3]]  # 4 shuffled pages of 16: positions 0..63
PROMPT = np.random.default_rng(0).integers(5, 200, 21)
T = 32  # the padded prefill chunk


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads beside the suite's
    other workers; restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _codes(rng, lead, hkv, d):
    """Random K or V rows [*lead, Hkv*D] quantized by the JAX package:
    (int8 codes, f32 scales [*lead, Hkv]) as numpy."""
    q, s = jllama.quantize_kv(jnp.asarray(_f32(rng, *lead, hkv * d)), hkv)
    return np.array(q), np.array(s)


# -- quantization and the scale writes ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequant_equal_jax(dtype):
    rng = np.random.default_rng(1)
    x = _f32(rng, 3, 7, 4 * 64) * rng.uniform(0.01, 30.0, (3, 7, 1)).astype(np.float32)
    x[0, 0, :64] = 0.0  # an all-zero head: the 1e-20 floor
    x[1, 2, 64:128] = 127.0 * np.round(x[1, 2, 64:128])  # values on the half-way points
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jllama.quantize_kv(jx, 4)
    tq, ts = quantize_kv(tx, 4)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (3, 7, 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    st = np.swapaxes(np.asarray(js), 1, 2)  # time-minor [B, H, S]
    want = jllama.dequant_kv(jq, jnp.asarray(st), jnp.dtype(dtype))
    got = dequant_kv(tq, torch.from_numpy(st), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_write_all_layers_t_plain_vs_jax():
    rng = np.random.default_rng(2)
    l, b, h, s = 3, 4, 2, 256
    arr = _f32(rng, l, b, h, s)
    rows = _f32(rng, l, b, h)
    starts = np.array([0, 17, s - 1, s], np.int32)  # the last one is dropped
    want = np.asarray(jax_write_all_layers_t(jnp.asarray(arr), jnp.asarray(rows), jnp.asarray(starts),
                                             interpret=True))
    got = torch.from_numpy(arr.copy())
    assert write_all_layers_t(got, torch.from_numpy(rows), torch.from_numpy(starts)) is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 3], arr[:, 3])
    neg = torch.from_numpy(arr.copy())  # a negative start is dropped too (as K3 drops it)
    write_all_layers_t_plain(neg, torch.from_numpy(rows), torch.tensor([-1, 0, 1, 2]))
    np.testing.assert_array_equal(neg.numpy()[:, 0], arr[:, 0])


@pytest.mark.parametrize("ps", [4, 16])
def test_write_paged_scales_equals_jax(ps):
    rng = np.random.default_rng(ps)
    hkv, n_pages, b, t = 2, 12, 3, 5
    spool = _f32(rng, hkv, n_pages, ps)
    new = _f32(rng, b, t, hkv)
    tables = (rng.permutation(n_pages - 1)[: b * 3] + 1).reshape(b, 3).astype(np.int32)
    positions = (ps - 2 + np.arange(t))[None].repeat(b, 0).astype(np.int32)  # across a page boundary
    want = np.asarray(jax_write_paged_scales(*map(jnp.asarray, (spool, new, tables, positions))))
    got = torch.from_numpy(spool.copy())
    assert write_paged_scales(got, *map(torch.from_numpy, (new, tables, positions))) is got
    np.testing.assert_array_equal(got.numpy(), want)


# -- the attention kernels' plain versions with scales ---------------------------


@pytest.mark.parametrize("impl", ["slab", "grid"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("r", [1, 2, 8])
def test_decode_attention_int8_plain_vs_jax(impl, d, r):
    rng = np.random.default_rng(10 * d + r)
    l, b, s, hkv = 2, 3, 256, 2
    q, kn, vn = _f32(rng, b, hkv * r, d), _f32(rng, b, hkv * d), _f32(rng, b, hkv * d)
    (kc, ks), (vc, vs) = _codes(rng, (l, b, s), hkv, d), _codes(rng, (l, b, s), hkv, d)
    ks, vs = np.swapaxes(ks, 2, 3).copy(), np.swapaxes(vs, 2, 3).copy()  # [L, B, Hkv, S]
    starts = np.array([0, 130, s - 1], np.int32)
    jfn = jax_layered_decode_attention_slab if impl == "slab" else jax_layered_decode_attention
    args = (q, kn, vn, kc, vc)
    want = np.asarray(jfn(*map(jnp.asarray, args), jnp.int32(1), jnp.asarray(starts), s_block=128,
                          interpret=True, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    got = layered_decode_attention(*map(torch.from_numpy, args), 1, torch.from_numpy(starts),
                                   k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    assert got.shape == (b, hkv * r, d)
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("r", [1, 2, 8])
@pytest.mark.parametrize("t,offset", [(64, 0), (64, 100)])
def test_prefill_attention_int8_plain_vs_jax(d, r, t, offset):
    rng = np.random.default_rng(d + r + t + offset)
    b, s, hkv = 2, 256, 2
    q = _f32(rng, b, t, hkv * r, d)
    (kc, ks), (vc, vs) = _codes(rng, (b, s), hkv, d), _codes(rng, (b, s), hkv, d)
    ks, vs = np.swapaxes(ks, 1, 2).copy(), np.swapaxes(vs, 1, 2).copy()  # [B, Hkv, S]
    offsets = np.array([offset, max(0, offset - 7)], np.int32)
    want = np.asarray(jax_flash_prefill_attention(
        *map(jnp.asarray, (q, kc, vc, offsets)), t_block=64, s_block=128, interpret=True,
        kv_layout="full", k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    got = flash_prefill_attention(*map(torch.from_numpy, (q, kc, vc, offsets)),
                                  k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    assert got.shape == (b, t, hkv * r, d)
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("r", [1, 2, 8])
def test_paged_attention_int8_plain_vs_jax(d, r):
    """Shuffled tables; lengths 1, ps - 1, ps + 1 and the full table."""
    rng = np.random.default_rng(3 * d + r)
    b, hkv, ps, n_p = 4, 2, 16, 4
    n_pages = b * n_p + 3
    q = _f32(rng, b, hkv * r, d)
    (kq, ks), (vq, vs) = _codes(rng, (n_pages, ps), hkv, d), _codes(rng, (n_pages, ps), hkv, d)
    pages = lambda c: c.reshape(n_pages, ps, hkv, d).transpose(2, 0, 1, 3).copy()  # noqa: E731
    spages = lambda sc: sc.transpose(2, 0, 1).copy()  # [Hkv, P, ps]  # noqa: E731
    kp, vp, ksp, vsp = pages(kq), pages(vq), spages(ks), spages(vs)
    tables = (rng.permutation(n_pages - 1)[: b * n_p] + 1).reshape(b, n_p).astype(np.int32)
    lengths = np.array([1, ps - 1, ps + 1, n_p * ps], np.int32)
    args = (q, kp, vp, tables, lengths)
    want = np.asarray(paged_flash_decode_attention(*map(jnp.asarray, args), interpret=True,
                                                   k_scales=jnp.asarray(ksp), v_scales=jnp.asarray(vsp)))
    got = paged_decode_attention(*map(torch.from_numpy, args), k_scales=torch.from_numpy(ksp),
                                 v_scales=torch.from_numpy(vsp))
    assert rel(got.numpy(), want) < TOL


# -- whole models ------------------------------------------------------------------


def _engines(path, **jkw):
    je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256, kv_dtype="int8"))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256, kv_dtype="int8"),
                         device="cpu")
    return je, te


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("kv8") / "tiny_q4k.gguf", **LLAMA)
    je, te = _engines(path)
    return je, te, te.params


@pytest.fixture(scope="module")
def qwen3(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("kv8q") / "qwen3.gguf", **QWEN3)
    je, te = _engines(path)
    return je, te, params_from_jax(jax.tree.map(np.asarray, je.params), te.model_cfg)


def _chunk():
    tokens = np.zeros((1, T), np.int64)
    tokens[0, : PROMPT.size] = PROMPT
    return tokens, np.arange(T)[None], np.array([PROMPT.size - 1])


def _port_run(te, params, paged, quantized=True):
    """The port's prefill logits and 4 teacher-forced decode steps (a dense
    cache, or a 4-page shuffled table of a 9-page pool)."""
    cfg = te.model_cfg
    tokens, positions, last = (torch.from_numpy(a) for a in _chunk())
    if paged:
        cache, tables = PagedKVCache.zeros(cfg, 9, PS, torch.float32, quantized=quantized), \
            torch.tensor(TABLE, dtype=torch.int32)
        logits, cache = paged_prefill_step(params, cfg, tokens, positions, last, cache, tables)
    else:
        cache, tables = KVCache.zeros(cfg, 1, 64, torch.float32, quantized=quantized), None
        logits, cache = prefill_step(params, cfg, tokens, positions, last, cache)
    out, pos = [logits.numpy()], PROMPT.size
    for tok in (17, 99, 200, 42):
        logits, cache = decode_step(params, cfg, torch.tensor([tok]), torch.tensor([pos]), cache,
                                    page_tables=tables)
        out.append(logits.numpy())
        pos += 1
    return out, cache


def _jax_run(je, paged):
    jcfg = je.model_cfg
    tokens, positions, last = (jnp.asarray(a, jnp.int32) for a in _chunk())
    if paged:
        cache = JPagedKVCache.zeros(jcfg, n_pages=9, page_size=PS, dtype=jnp.float32, quantized=True)
        tables = jnp.asarray(TABLE, jnp.int32)
        logits, cache = jllama.paged_prefill_step(je.params, jcfg, tokens, positions, last, cache, tables)
    else:
        cache = jllama.KVCache.zeros(jcfg, 1, 64, jnp.float32, quantized=True)
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
    return out, cache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("model,tol", [("llama", TOL_LLAMA), ("qwen3", TOL_QWEN)])
def test_int8_model_vs_jax(request, model, tol, paged):
    je, te, params = request.getfixturevalue(model)
    got, cache = _port_run(te, params, paged)
    want, jcache = _jax_run(je, paged)
    assert cache.quantized and cache.k.dtype == torch.int8 and cache.ks.dtype == torch.float32
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) < tol, step
        # greedy tokens equal, except at a near-tie: where JAX's top two
        # logits lie within the tolerance (qwen3's step 2: 0.0078, one bf16
        # step, against 3e-2 x 1.56), the port's pick must be one of JAX's
        # tied tokens
        top2 = np.sort(w.ravel())[-2:]
        if top2[1] - top2[0] > tol * np.abs(w).max():
            assert int(g.argmax()) == int(w.argmax()), step
        else:
            assert w.ravel()[g.argmax()] >= top2[1] - tol * np.abs(w).max(), step
    # the stored scales hold what JAX stores (codes may differ by one step
    # where the two K values straddle a rounding point)
    n = PROMPT.size + 4
    if paged:
        ks = cache.ks[:, :, torch.tensor(TABLE[0])].reshape(*cache.ks.shape[:2], -1)[..., :n]
        jks = np.asarray(jcache.ks)[:, :, TABLE[0]].reshape(ks.shape[:2] + (-1,))[..., :n]
    else:
        ks, jks = cache.ks[..., :n], np.asarray(jcache.ks)[..., :n]
    assert rel(ks.numpy(), jks) < tol


def test_int8_cache_close_to_bf16_cache(llama):
    _, te, params = llama
    for paged in (False, True):
        quant, _ = _port_run(te, params, paged)
        full, _ = _port_run(te, params, paged, quantized=False)
        for a, b in zip(full, quant):
            assert np.abs(a - b).max() / np.abs(a).max() < INT8_VS_BF16


# -- serving -------------------------------------------------------------------------


def test_prefill_slot_step_int8_equals_prefill_step(llama):
    _, te, params = llama
    cfg = te.model_cfg
    tokens, positions, last = (torch.from_numpy(a) for a in _chunk())
    one, one_cache = prefill_step(params, cfg, tokens, positions, last,
                                  KVCache.zeros(cfg, 1, 64, torch.float32, quantized=True))
    batched = KVCache.zeros(cfg, 3, 64, torch.float32, quantized=True)
    got, out = prefill_slot_step(params, cfg, tokens, positions, last, batched, 1)
    assert out is batched
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=0, atol=1e-5 * one.abs().max().item())
    for a, b in ((out.k, one_cache.k), (out.v, one_cache.v), (out.ks, one_cache.ks), (out.vs, one_cache.vs)):
        torch.testing.assert_close(a[:, 1:2], b, rtol=0, atol=0)
        assert not a[:, [0, 2]].any()  # the other lanes are untouched


SCHED = dict(max_seq_len=96, dtype="float32", prefill_chunk=32, page_size=16, kv_dtype="int8")
SCHED_PROMPTS = [[int(x) for x in np.random.default_rng(1).integers(5, 200, n)] for n in (6, 11, 17, 9, 25)]


@pytest.fixture(scope="module")
def sched_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("kv8s") / "tiny_q4k.gguf",
                                **dict(LLAMA, context_length=128))


def _drive(be, reqs, max_steps=400):
    for _ in range(max_steps):
        if be.step() == 0 and be.queue.empty() and all(r.state != RequestState.QUEUED for r in reqs):
            break
    return [r.output_ids for r in reqs]


def _tied_at_divergence(je, prompt, got, want, tol=TOL_LLAMA):
    """Where two greedy streams first differ: whether JAX's own logits there
    (the prompt and the common prefix prefilled on a fresh int8 cache) have
    a top-2 gap within `tol` of the logit scale, with the port's token among
    the tied ones. True when the streams do not differ."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if i is None:
        return True
    logits, _ = je.prefill(je.new_cache(1), list(prompt) + list(want[:i]))
    w = np.asarray(logits, np.float32).ravel()
    top, band = np.sort(w)[-2:], tol * np.abs(w).max()
    return bool(top[1] - top[0] < band and w[got[i]] >= top[1] - band)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batch_engine_int8_greedy_equals_jax(sched_path, paged):
    """5 single-chunk prompts on 4 slots (the fifth waits), 10 greedy tokens
    each: the same output_ids as the JAX BatchEngine with kv_dtype="int8"
    (the counterpart of tests/test_kv_int8.py::test_batch_engine_int8_paged),
    up to a near-tie. On this fixture the f32 caches agree on every token;
    int8 codes flip by one step where the two packages' K/V (2e-2 apart,
    test_torch_engine.py) straddle a rounding point, and then a greedy
    stream may part at a step whose top-2 logits JAX itself holds within
    2e-2 of the logit scale: there the port's token must be one of the
    tied pair, and nothing after it is compared."""
    je = JInferenceEngine(str(sched_path), JEngineConfig(**SCHED))
    jbe = JBatchEngine(je, max_batch=4, decode_chunk=4, paged=paged)
    jreqs = [jbe.submit(p, JSamplingParams(temperature=0.0, max_new_tokens=10)) for p in SCHED_PROMPTS]
    want = _drive(jbe, jreqs)
    te = InferenceEngine(sched_path, EngineConfig(**SCHED), device="cpu")
    be = BatchEngine(te, max_batch=4, decode_chunk=4, paged=paged)
    assert be.cache.quantized and be.cache.k.dtype == torch.int8
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=10)) for p in SCHED_PROMPTS]
    got = _drive(be, reqs)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert all(len(o) == 10 for o in got)
    assert sum(g == w for g, w in zip(got, want)) >= 3  # most streams agree in full
    for p, g, w in zip(SCHED_PROMPTS, got, want):
        assert _tied_at_divergence(je, p, g, w), (p, g, w)


def test_int8_pool_prefix_hit_and_preemption_return_every_page(sched_path):
    te = InferenceEngine(sched_path, EngineConfig(**SCHED), device="cpu")
    s = SamplingParams(temperature=0.0, max_new_tokens=24)
    p1, p2 = [[int(x) for x in np.random.default_rng(10).integers(5, 200, 20)] for _ in range(2)]
    p2 = p2[::-1]
    roomy = BatchEngine(te, max_batch=2, decode_chunk=4, paged=True)
    expected = _drive(roomy, [roomy.submit(p1, s), roomy.submit(p2, s)])
    # a starved pool (4 pages of 16 beside the sink): one request is preempted
    be = BatchEngine(te, max_batch=2, decode_chunk=4, paged=True, pool_tokens=4 * 16)
    assert be.cache.quantized and be.cache.nbytes == sum(
        t.numel() * t.element_size() for t in (be.cache.k, be.cache.v, be.cache.ks, be.cache.vs))
    r1, r2 = be.submit(p1, s), be.submit(p2, s)
    assert _drive(be, [r1, r2]) == expected
    assert be.preemptions >= 1
    assert (be.alloc.refs[1:] == 0).all()  # every page came back
    # the same 40-token prompt twice: the second adopts the first's pages
    p = [int(x) for x in np.random.default_rng(7).integers(5, 200, 40)]
    share = BatchEngine(te, max_batch=2, decode_chunk=4, paged=True, pool_tokens=12 * 16)
    a = share.submit(p, SamplingParams(temperature=0.0, max_new_tokens=6))
    _drive(share, [a])
    b = share.submit(p, SamplingParams(temperature=0.0, max_new_tokens=6))
    _drive(share, [b])
    assert share.alloc.hits == 1 and a.output_ids == b.output_ids
    assert (share.alloc.refs[1:] == 0).all()


def test_http_request_on_an_int8_engine(sched_path):
    httpd = srv.serve(str(sched_path), host="127.0.0.1", port=0,
                      engine_config=EngineConfig(**dict(SCHED, prefill_chunk=64)), max_batch=2,
                      device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert httpd.state.batch.cache.quantized
        body = {"messages": [{"role": "user", "content": "hi"}], "temperature": 0, "max_tokens": 8}
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            out = json.loads(r.read())
        assert isinstance(out["choices"][0]["message"]["content"], str)
        assert 0 < out["usage"]["completion_tokens"] <= 8
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.state.batch.close()
        thread.join(timeout=10)
