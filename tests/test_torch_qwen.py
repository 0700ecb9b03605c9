"""qwen3 / qwen3moe beside the JAX package (port on the CPU, JAX on its CPU
backend, Pallas kernels in interpret mode):

- the fixtures write the JAX fixture's bytes for the qwen options, and
  `LlamaConfig.from_gguf` reads the same fields as the JAX config;
- head_dim 128 (what qwen3 and Llama-3.2-3B use) in the plain versions of
  K2 (decode), K4 (prefill) and K7 (paged decode) against the JAX kernels,
  with r = 8 query heads per kv head as at Qwen3-30B-A3B and r = 3 as at
  Llama-3.2-3B (f32, tolerance 1e-4: only the summation order differs);
- a tiny dense qwen3 (hidden 512, 4 heads / 2 kv: head_dim 128, q/k norms,
  NEOX rope with no q/k permutation, Q4_K) through `params_from_jax`:
  prefill logits and 4 teacher-forced decode steps, dense and paged,
  within 3e-2 of the JAX engine (the bf16 gap of these widths; see
  test_torch_moe.py) with the same greedy tokens;
- the ChatML template renders, <|im_end|> ends generation, and a paged
  BatchEngine serves a tiny qwen3moe with the engine's greedy tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models.llama import LlamaConfig as JLlamaConfig
from nfai_tpu.models.testing import make_tiny_llama_gguf as jax_make_tiny
from nfai_tpu.ops.fused_decode import layered_decode_attention_slab as jax_decode_attention
from nfai_tpu.ops.paged_attention import paged_flash_decode_attention
from nfai_tpu.ops.prefill_attention import flash_prefill_attention as jax_prefill_attention
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from nfai_tpu_torch.models import LlamaConfig, params_from_jax, resolve
from nfai_tpu_torch.ops.fused_decode import layered_decode_attention
from nfai_tpu_torch.ops.paged_attention import paged_decode_attention
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention
from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import (
    CHATML_TEMPLATE, _header, make_tiny_llama_gguf, tiny_tokenizer_metadata,
)
from test_torch_moe import MOE, TOL_MODEL, _teacher_forced, rel

TOL = 1e-4
QWEN3 = dict(arch="qwen3", qk_norm=True, hidden=512, n_heads=4, n_kv_heads=2, ffn_dim=256,
             vocab_size=512, tied=False, seed=65, scale=0.02, quant=GGMLType.Q4_K)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [QWEN3, MOE], ids=["qwen3", "qwen3moe"])
def test_fixture_bytes_and_config_match_jax(tmp_path, kw):
    jkw = dict(kw, quant=JGGMLType[kw["quant"].name], quant_overrides={
        k: JGGMLType[v.name] for k, v in kw.get("quant_overrides", {}).items()})
    a = make_tiny_llama_gguf(tmp_path / "port.gguf", **kw)
    b = jax_make_tiny(tmp_path / "jax.gguf", **jkw)
    assert a.read_bytes() == b.read_bytes()
    with GGUFFile.open(a) as g, JGGUFFile.open(b) as jg:
        cfg, jcfg = LlamaConfig.from_gguf(g), JLlamaConfig.from_gguf(jg)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.head_dim == 128 and cfg.qk_norm and cfg.rope_neox
    assert cfg.n_experts == (4 if kw["arch"] == "qwen3moe" else 0)


def test_head_dim_comes_from_key_length_and_other_archs_raise(tmp_path):
    """A qwen3moe header with key_length 128 at hidden 512 / 8 heads (as
    Qwen3-30B-A3B: hidden / heads = 64); an architecture neither package
    serves (falcon), and llama with q/k norms, are not ported."""
    w = GGUFWriter()
    _header(w, "qwen3moe", "hdr", context_length=64, hidden=512, n_layers=1, ffn_dim=64,
            n_heads=8, n_kv_heads=2, rope_base=1e6, vocab_size=300, rms_eps=1e-6,
            tok_md=tiny_tokenizer_metadata(chatml=True),
            extra={"attention.key_length": 128, "expert_count": 16, "expert_used_count": 4,
                   "expert_feed_forward_length": 96})
    w.add_tensor("output_norm.weight", np.ones(512, np.float32))
    with GGUFFile.open(w.write(tmp_path / "hdr.gguf")) as g:
        cfg = LlamaConfig.from_gguf(g)
    assert (cfg.head_dim, cfg.rms_eps, cfg.n_experts, cfg.n_experts_used, cfg.moe_ffn_dim) == (
        128, np.float32(1e-6), 16, 4, 96)
    falcon = make_tiny_llama_gguf(tmp_path / "falcon.gguf", arch="falcon")
    llama_qk = make_tiny_llama_gguf(tmp_path / "lq.gguf", qk_norm=True)
    for path in (falcon, llama_qk):
        with GGUFFile.open(path) as g, pytest.raises(NotImplementedError):
            resolve(g).config_from_gguf(g)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("r", [3, 8])
def test_decode_attention_d128_plain_vs_jax(r):
    rng = np.random.default_rng(7 + r)
    l, b, s, hkv, d = 2, 3, 256, 2, 128
    q, kn, vn = _f32(rng, b, hkv * r, d), _f32(rng, b, hkv * d), _f32(rng, b, hkv * d)
    kc, vc = _f32(rng, l, b, s, hkv * d), _f32(rng, l, b, s, hkv * d)
    starts = np.array([0, 130, s - 1], np.int32)
    want = np.asarray(jax_decode_attention(*map(jnp.asarray, (q, kn, vn, kc, vc)), jnp.int32(1),
                                           jnp.asarray(starts), s_block=128, interpret=True))
    got = layered_decode_attention(*map(torch.from_numpy, (q, kn, vn, kc, vc)), 1,
                                   torch.from_numpy(starts))
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("r,t,offset", [(8, 64, 0), (8, 64, 100), (3, 64, 100)])
def test_prefill_attention_d128_plain_vs_jax(r, t, offset):
    rng = np.random.default_rng(t + offset + r)
    b, s, hkv, d = 2, 256, 2, 128
    q, kc, vc = _f32(rng, b, t, hkv * r, d), _f32(rng, b, s, hkv * d), _f32(rng, b, s, hkv * d)
    offsets = np.array([offset, max(0, offset - 7)], np.int32)
    want = np.asarray(jax_prefill_attention(*map(jnp.asarray, (q, kc, vc, offsets)), t_block=64,
                                            s_block=128, interpret=True, kv_layout="full"))
    got = flash_prefill_attention(*map(torch.from_numpy, (q, kc, vc, offsets)))
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("r", [3, 8])
def test_paged_attention_d128_plain_vs_jax(r):
    rng = np.random.default_rng(11 + r)
    b, hkv, d, ps, n_p = 4, 2, 128, 16, 4
    n_pages = b * n_p + 3
    q, kp, vp = _f32(rng, b, hkv * r, d), _f32(rng, hkv, n_pages, ps, d), _f32(rng, hkv, n_pages, ps, d)
    tables = (rng.permutation(n_pages - 1)[: b * n_p] + 1).reshape(b, n_p).astype(np.int32)
    lengths = np.array([1, ps + 1, 50, n_p * ps], np.int32)
    want = np.asarray(paged_flash_decode_attention(*map(jnp.asarray, (q, kp, vp, tables, lengths)),
                                                   interpret=True))
    got = paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, tables, lengths)))
    assert rel(got.numpy(), want) < TOL


@pytest.fixture(scope="module")
def qwen3_engines(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("qwen3") / "qwen3.gguf", **QWEN3)
    je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    return je, te, params_from_jax(jax.tree.map(np.asarray, je.params), te.model_cfg)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_qwen3_model_vs_jax(qwen3_engines, paged):
    je, te, conv = qwen3_engines
    assert "q_norm" in conv["layers"] and "wqkv" in conv["layers"]
    for step, (got, want) in enumerate(_teacher_forced(je, te, conv, paged)):
        assert rel(got, want) < TOL_MODEL, step
        assert int(got.argmax()) == int(want.argmax()), step


def _chatml_moe(tmp_path):
    """The tiny qwen3moe weights under a ChatML tokenizer (Qwen's specials,
    EOS <|im_end|>, the ChatML template)."""
    g = GGUFFile.open(make_tiny_llama_gguf(tmp_path / "moe.gguf", **MOE))
    w = GGUFWriter()
    for k, v in g.metadata.items():
        if not k.startswith("tokenizer.") and k != "general.alignment":
            w.add(k, v)
    for k, v in tiny_tokenizer_metadata(chatml=True).items():
        w.add(k, v)
    for name, desc in g.tensors.items():
        w.add_tensor(name, np.broadcast_to(np.zeros((), np.float32), desc.shape), desc.ggml_type,
                     raw_bytes=np.array(g.tensor_bytes(name)).view(np.uint8).reshape(-1))
    path = w.write(tmp_path / "moe_chatml.gguf")
    g.close()
    return path


def test_chatml_session_and_paged_batch_engine(tmp_path):
    te = InferenceEngine(_chatml_moe(tmp_path), EngineConfig(dtype="float32", max_seq_len=256,
                                                              page_size=16, prefill_chunk=32),
                         device="cpu")
    tok = te.tokenizer
    assert te.chat_template.source == CHATML_TEMPLATE
    assert tok.is_eos(tok.vocab["<|im_end|>"]) and not tok.add_bos
    prompt = te.chat_template.render([{"role": "user", "content": "hi"}])
    assert prompt == "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n"
    ids = tok.encode(prompt, add_bos=False)
    assert ids[0] == tok.vocab["<|im_start|>"] and tok.vocab["<|im_end|>"] in ids
    session = ChatSession(te, SamplingParams(temperature=0.0, max_new_tokens=6))
    session.send("hello there")
    assert session.last_metrics.new_tokens > 0
    prompts = [tok.encode(p, add_bos=False) for p in ("a short one", "x" * 70, "the third")]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    want = [list(te.generate(p, sp)) for p in prompts]
    be = BatchEngine(te, max_batch=2, decode_chunk=4, paged=True)
    reqs = [be.submit(p, sp) for p in prompts]
    for _ in range(200):
        if be.step() == 0 and be.queue.empty():
            break
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert [r.output_ids for r in reqs] == want
