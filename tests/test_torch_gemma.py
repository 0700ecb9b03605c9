"""Gemma 1/2/3 in the port beside the JAX package (port on the CPU, JAX on
its CPU backend, Pallas kernels in interpret mode), from numpy inputs made
from a seed:

- the fixtures write the JAX fixture's bytes for the gemma options, and
  `LlamaConfig.from_gguf` reads the JAX config's fields for gemma, gemma2
  and gemma3, except `attn_scale`: the port follows llama.cpp (head_dim^-0.5,
  and (hidden // n_heads)^-0.5 only for the 27B depths, gemma2 46 blocks and
  gemma3 62), where the JAX package takes (hidden / n_heads)^-0.5 for every
  gemma2 — the two differ where head_dim * n_heads != hidden (Gemma-2-2B:
  288^-0.5 against 256^-0.5);
- the plain versions of K2 (decode), K4 (prefill) and K7 (paged decode) with
  softcap, a sliding window and head_dim 256, at r = 1, 2, 4 and 8, on bf16
  and int8 caches, against the JAX kernels in f32 (tolerance 1e-4 of
  max|JAX|: only the summation order differs);
- tiny gemma2 and gemma3 models (Q4_K, a window of 8 under a 21-token
  prompt, head_dim * n_heads != hidden) through `params_from_jax`: prefill
  logits and 4 teacher-forced decode steps, dense and paged, on f32 and int8
  caches, within the qwen tests' 3e-2 (int8: the JAX int8 rule, 5e-2) of the
  JAX engine (run with the port's attention scale) and with the same greedy
  tokens up to a stated near-tie;
  the port's own `load_params` gives the same params;
- serving a tiny gemma2 with Gemma's SPM vocabulary and chat template:
  <end_of_turn> stops generation as in the JAX tokenizer, a ChatSession and
  the CLI answer, a paged and a dense BatchEngine give the engine's greedy
  tokens, and the HTTP server answers a request.
"""
import dataclasses
import io
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models import llama as jllama
from nfai_tpu.models.testing import make_tiny_llama_gguf as jax_make_tiny
from nfai_tpu.ops.fused_decode import (
    layered_decode_attention as jax_decode_grid,
    layered_decode_attention_slab as jax_decode_slab,
)
from nfai_tpu.ops.paged_attention import paged_flash_decode_attention
from nfai_tpu.ops.prefill_attention import flash_prefill_attention as jax_prefill
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu.tokenizer import tokenizer_from_gguf as jax_tokenizer
from nfai_tpu_torch import cli
from nfai_tpu_torch import server as srv
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from nfai_tpu_torch.models import (
    KVCache, LlamaConfig, decode_step, paged_prefill_step, params_from_jax, prefill_step,
)
from nfai_tpu_torch.ops.fused_decode import layered_decode_attention
from nfai_tpu_torch.ops.paged_attention import paged_decode_attention
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention
from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import (
    GEMMA_TEMPLATE, _header, gemma_spm_tokenizer_metadata, make_tiny_llama_gguf,
)

TOL = 1e-4  # f32 attention, port plain vs JAX interpret kernel
TOL_MODEL = 3e-2  # whole models, as tests/test_torch_qwen.py
# whole models on int8 caches: each package quantizes its own K/V, and a code
# flips where the two K/V straddle a rounding point: the JAX package's int8
# rule (tests/test_kv_int8.py), as chip_smoke.py's INT8_TOL
TOL_INT8 = 5e-2
SOFTCAP, WINDOW = 2.0, 100  # a cap that bites on unit-scale scores; a window inside S = 256
# tiny models: head_dim 128 with 4 heads at hidden 256 (q width 512 != hidden)
GEMMA2 = dict(arch="gemma2", hidden=256, n_heads=4, n_kv_heads=2, key_length=128, ffn_dim=512,
              vocab_size=512, post_norms=True, sliding_window=8, attn_softcap=50.0,
              final_softcap=30.0, seed=71, scale=0.02, quant=GGMLType.Q4_K)
GEMMA3 = dict(arch="gemma3", hidden=256, n_layers=6, n_heads=4, n_kv_heads=1, key_length=128,
              ffn_dim=512, vocab_size=512, post_norms=True, qk_norm=True, sliding_window=8,
              rope_base=1e6, seed=73, scale=0.02, quant=GGMLType.Q4_K)
PROMPT = np.random.default_rng(0).integers(5, 250, 21)
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


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _codes(rng, lead, hkv, d):
    """Random K or V rows [*lead, Hkv*D] quantized by the JAX package."""
    q, s = jllama.quantize_kv(jnp.asarray(_f32(rng, *lead, hkv * d)), hkv)
    return np.array(q), np.array(s)


# -- config ------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(arch="gemma"),
    dict(arch="gemma2", post_norms=True, sliding_window=8, attn_softcap=50.0, final_softcap=30.0),
    dict(arch="gemma3", post_norms=True, sliding_window=8, qk_norm=True, n_layers=6,
         spm_tokenizer=True),
], ids=["gemma", "gemma2", "gemma3"])
def test_fixture_bytes_and_config_match_jax(tmp_path, kw):
    a = make_tiny_llama_gguf(tmp_path / "port.gguf", **kw)
    b = jax_make_tiny(tmp_path / "jax.gguf", **kw)
    assert a.read_bytes() == b.read_bytes()
    with GGUFFile.open(a) as g, JGGUFFile.open(b) as jg:
        cfg, jcfg = LlamaConfig.from_gguf(g), jllama.LlamaConfig.from_gguf(jg)
    for f in dataclasses.fields(cfg):
        if f.name != "attn_scale":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.layer_windows() == jcfg.layer_windows()
    # hidden = n_heads * head_dim here, so both scales are head_dim^-0.5
    assert cfg.query_scale == pytest.approx(jcfg.query_scale)
    assert cfg.rope_neox and cfg.activation == "gelu" and cfg.embed_scale == 64**0.5


def test_attention_scale_follows_llama_cpp(tmp_path):
    """At head_dim * n_heads != hidden the JAX package's gemma2 scale is
    (hidden / n_heads)^-0.5 and the port's head_dim^-0.5 (llama.cpp, HF's
    query_pre_attn_scalar); at the 27B depths both packages' rule is
    (hidden // n_heads)^-0.5 for gemma2, and the port's for gemma3 too."""
    path = make_tiny_llama_gguf(tmp_path / "g2.gguf", arch="gemma2", hidden=64, n_heads=4,
                                key_length=32, post_norms=True, sliding_window=8)
    with GGUFFile.open(path) as g, JGGUFFile.open(path) as jg:
        cfg, jcfg = LlamaConfig.from_gguf(g), jllama.LlamaConfig.from_gguf(jg)
    assert cfg.head_dim == jcfg.head_dim == 32
    assert cfg.query_scale == pytest.approx(32**-0.5)
    assert jcfg.query_scale == pytest.approx(16**-0.5)  # the reference's (hidden / n_heads)^-0.5
    for arch, depth, hidden, heads in (("gemma2", 46, 4608, 32), ("gemma3", 62, 5376, 32),
                                       ("gemma2", 26, 2304, 8)):
        w = GGUFWriter()
        _header(w, arch, "hdr", context_length=64, hidden=hidden, n_layers=depth, ffn_dim=64,
                n_heads=heads, n_kv_heads=heads // 2, rope_base=1e4, vocab_size=300,
                tok_md=gemma_spm_tokenizer_metadata(300),
                extra={"attention.key_length": 128 if depth > 26 else 256})
        w.add_tensor("output_norm.weight", np.ones(hidden, np.float32))
        with GGUFFile.open(w.write(tmp_path / f"{arch}{depth}.gguf")) as g:
            got = LlamaConfig.from_gguf(g).query_scale
        want = (hidden // heads) ** -0.5 if depth > 26 else 256**-0.5  # 144, 168; 256 at 2B
        assert got == pytest.approx(want), (arch, depth)


# -- the attention kernels' plain versions -------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("impl", ["slab", "grid"])
def test_decode_attention_gemma_plain_vs_jax(impl, r, quant):
    rng = np.random.default_rng(20 * r + quant)
    l, b, s, hkv, d = 2, 3, 256, 2 if r < 8 else 1, 256
    q, kn, vn = _f32(rng, b, hkv * r, d), _f32(rng, b, hkv * d), _f32(rng, b, hkv * d)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = _codes(rng, (l, b, s), hkv, d), _codes(rng, (l, b, s), hkv, d)
        sc = dict(k_scales=np.swapaxes(ks, 2, 3).copy(), v_scales=np.swapaxes(vs, 2, 3).copy())
    else:
        kc, vc = _f32(rng, l, b, s, hkv * d), _f32(rng, l, b, s, hkv * d)
    starts = np.array([0, 130, s - 1], np.int32)  # 0, inside and past the window of 100
    jfn = jax_decode_slab if impl == "slab" else jax_decode_grid
    args = (q, kn, vn, kc, vc)
    want = np.asarray(jfn(*map(jnp.asarray, args), jnp.int32(1), jnp.asarray(starts), s_block=128,
                          interpret=True, softcap=SOFTCAP, window=WINDOW,
                          **{k: jnp.asarray(v) for k, v in sc.items()}))
    got = layered_decode_attention(*map(torch.from_numpy, args), 1, torch.from_numpy(starts),
                                   softcap=SOFTCAP, window=WINDOW,
                                   **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert got.shape == (b, hkv * r, d)
    assert rel(got.numpy(), want) < TOL
    # the window and the cap change the answer (they are applied, not ignored)
    plain = layered_decode_attention(*map(torch.from_numpy, args), 1, torch.from_numpy(starts),
                                     **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert rel(plain.numpy(), want) > 1e-2


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("softcap,window", [(SOFTCAP, 40), (0.0, 40), (SOFTCAP, 0)],
                         ids=["softcap+window", "window", "softcap"])
def test_prefill_attention_gemma_plain_vs_jax(softcap, window, r, quant):
    rng = np.random.default_rng(r + 10 * quant + window)
    b, t, s, hkv, d = 2, 64, 256, 2 if r < 8 else 1, 256
    q = _f32(rng, b, t, hkv * r, d)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = _codes(rng, (b, s), hkv, d), _codes(rng, (b, s), hkv, d)
        sc = dict(k_scales=np.swapaxes(ks, 1, 2).copy(), v_scales=np.swapaxes(vs, 1, 2).copy())
    else:
        kc, vc = _f32(rng, b, s, hkv * d), _f32(rng, b, s, hkv * d)
    offsets = np.array([100, 0], np.int32)
    want = np.asarray(jax_prefill(*map(jnp.asarray, (q, kc, vc, offsets)), t_block=64, s_block=128,
                                  interpret=True, kv_layout="full", softcap=softcap, window=window,
                                  **{k: jnp.asarray(v) for k, v in sc.items()}))
    got = flash_prefill_attention(*map(torch.from_numpy, (q, kc, vc, offsets)), softcap=softcap,
                                  window=window, **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert got.shape == (b, t, hkv * r, d)
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_paged_attention_gemma_plain_vs_jax(r, quant):
    """Shuffled tables; lengths 1, ps + 1, 50 and the full table, window 20
    (a page and a bit) and softcap together."""
    rng = np.random.default_rng(30 + r + quant)
    b, hkv, d, ps, n_p = 4, 2 if r < 8 else 1, 256, 16, 4
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
                                                   softcap=SOFTCAP, window=20,
                                                   **{k: jnp.asarray(v) for k, v in sc.items()}))
    got = paged_decode_attention(*map(torch.from_numpy, args), softcap=SOFTCAP, window=20,
                                 **{k: torch.from_numpy(v) for k, v in sc.items()})
    assert rel(got.numpy(), want) < TOL


# -- whole models ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=["gemma2", "gemma3"])
def model(request, tmp_path_factory):
    """(JAX engine, JAX config with the port's attention scale, port engine,
    port params from the JAX params)."""
    kw = {"gemma2": GEMMA2, "gemma3": GEMMA3}[request.param]
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp(request.param) / "g.gguf", **kw)
    je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    jcfg = dataclasses.replace(je.model_cfg, attn_scale=te.model_cfg.query_scale)
    return je, jcfg, te, params_from_jax(jax.tree.map(np.asarray, je.params), te.model_cfg)


def _chunk():
    tokens = np.zeros((1, T), np.int64)
    tokens[0, : PROMPT.size] = PROMPT
    return tokens, np.arange(T)[None], np.array([PROMPT.size - 1])


def _port_run(cfg, params, paged, quant):
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


def _jax_run(je, jcfg, paged, quant):
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


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gemma_model_vs_jax(model, paged, quant):
    je, jcfg, te, params = model
    cfg = te.model_cfg
    assert cfg.layer_windows()[0] == 8 < PROMPT.size and 0 in cfg.layer_windows()
    assert cfg.head_dim * cfg.n_heads != cfg.hidden_size
    got, want = _port_run(cfg, params, paged, quant), _jax_run(je, jcfg, paged, quant)
    tol = TOL_INT8 if quant else TOL_MODEL
    for step, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) < tol, step
        # greedy tokens equal, except where JAX's top two logits lie within
        # the tolerance: there the port's pick must be one of the tied pair
        top2, band = np.sort(w.ravel())[-2:], tol * np.abs(w).max()
        if top2[1] - top2[0] > band:
            assert int(g.argmax()) == int(w.argmax()), step
        else:
            assert w.ravel()[g.argmax()] >= top2[1] - band, step
    if cfg.final_softcap:
        assert max(np.abs(g).max() for g in got) < cfg.final_softcap


def test_load_params_equals_params_from_jax(model):
    """The port's own loader gives what params_from_jax carries: post norms
    and norms exactly, gemma3's local rope frequencies exactly."""
    _, _, te, conv = model
    for key in ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffw_norm"):
        torch.testing.assert_close(te.params["layers"][key], conv["layers"][key], rtol=0, atol=0)
    assert ("inv_freq_local" in te.params) == (te.model_cfg.rope_base_local > 0)
    if "inv_freq_local" in te.params:
        torch.testing.assert_close(te.params["inv_freq_local"], conv["inv_freq_local"], rtol=0, atol=0)
        assert not torch.equal(te.params["inv_freq_local"], te.params["inv_freq"])


# -- serving ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gemma_chat_path(tmp_path_factory):
    """The tiny gemma2 weights under Gemma's SPM vocabulary and template."""
    tmp = tmp_path_factory.mktemp("gchat")
    g = GGUFFile.open(make_tiny_llama_gguf(tmp / "g.gguf", **GEMMA2))
    w = GGUFWriter()
    for k, v in g.metadata.items():
        if not k.startswith("tokenizer.") and k != "general.alignment":
            w.add(k, v)
    for k, v in gemma_spm_tokenizer_metadata(g.metadata["gemma2.vocab_size"]).items():
        w.add(k, v)
    for name, desc in g.tensors.items():
        w.add_tensor(name, np.broadcast_to(np.zeros((), np.float32), desc.shape), desc.ggml_type,
                     raw_bytes=np.array(g.tensor_bytes(name)).view(np.uint8).reshape(-1))
    path = w.write(tmp / "gemma_chat.gguf")
    g.close()
    return path


SERVE = dict(dtype="float32", max_seq_len=160, page_size=16, prefill_chunk=32)


def test_gemma_tokenizer_stops_and_chat(gemma_chat_path):
    te = InferenceEngine(gemma_chat_path, EngineConfig(**SERVE), device="cpu")
    tok = te.tokenizer
    with JGGUFFile.open(gemma_chat_path) as jg:
        jtok = jax_tokenizer(jg.metadata)
    assert tok.eos_ids == jtok.eos_ids == {tok.vocab["<eos>"], tok.vocab["<end_of_turn>"]}
    assert te.chat_template.source == GEMMA_TEMPLATE
    prompt = te.chat_template.render([{"role": "user", "content": "hi"}])
    assert prompt == "<bos><start_of_turn>user\nhi<end_of_turn>\n<start_of_turn>model\n"
    ids = tok.encode(prompt, add_bos=False)
    assert ids == jtok.encode(prompt, add_bos=False) and ids[:2] == [2, 4]
    session = ChatSession(te, SamplingParams(temperature=0.0, max_new_tokens=6))
    session.send("hello there")
    assert session.last_metrics.new_tokens > 0


def test_gemma_cli_answers_piped_prompt(gemma_chat_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello there\nquit\n"))
    rc = cli.main(["--gguf", str(gemma_chat_path), "--device", "cpu", "--dtype", "float32",
                   "--temp", "0", "--max-new-tokens", "8", "--max-seq", "160", "--metrics"])
    assert rc == 0
    out, err = capsys.readouterr()
    assert out.strip() != "" and "tok/s" in err


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_gemma_batch_engine_greedy_equals_engine(gemma_chat_path, paged):
    te = InferenceEngine(gemma_chat_path, EngineConfig(**SERVE), device="cpu")
    prompts = [te.tokenizer.encode(p) for p in ("a short one", "x" * 40, "the third one")]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    want = [list(te.generate(p, sp)) for p in prompts]
    be = BatchEngine(te, max_batch=2, decode_chunk=4, paged=paged)
    reqs = [be.submit(p, sp) for p in prompts]
    for _ in range(300):
        if be.step() == 0 and be.queue.empty() and all(r.state != RequestState.QUEUED for r in reqs):
            break
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert [r.output_ids for r in reqs] == want


def test_gemma_http_request(gemma_chat_path):
    httpd = srv.serve(str(gemma_chat_path), host="127.0.0.1", port=0,
                      engine_config=EngineConfig(**SERVE), max_batch=2, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
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
