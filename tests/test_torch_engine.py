"""The slice as a whole: one tiny Q4_K llama GGUF loaded by the JAX package's
InferenceEngine and by the port's (dtype float32, port on the CPU).

Tolerance for logits: max|got - want| / max|want| < 2e-2 (the JAX side
rounds dequantized weights and matmul outputs to bf16). Greedy tokens must
be equal. Also: the GGUF fixture and writer copies produce the JAX
package's bytes, params_from_jax reproduces load_params, the CLI answers a
piped prompt, and without CUDA the engine refuses to start unless the
caller asks for the CPU.
"""
import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models.llama import decode_step as jax_decode_step
from nfai_tpu.models.llama import load_params as jax_load_params
from nfai_tpu.models.testing import make_tiny_llama_gguf as jax_make_tiny
from nfai_tpu.runtime.engine import GenerationMetrics as JGenerationMetrics
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch import cli
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import (
    KVCache, LlamaConfig, decode_step, load_params, params_from_jax, prefill_step,
)
from nfai_tpu_torch.ops.qtensor import dequant
from nfai_tpu_torch.runtime.engine import ChatSession, GenerationMetrics, InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 2e-2
TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            vocab_size=512, quant=GGMLType.Q4_K, tied=False)
PROMPT = "The quick brown fox jumps over the lazy dog. " * 2


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("tiny") / "tiny_q4k.gguf", **TINY)


@pytest.fixture(scope="module")
def engines(gguf_path):
    je = JInferenceEngine(str(gguf_path), JEngineConfig(dtype="float32", max_seq_len=256))
    te = InferenceEngine(gguf_path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    return je, te


def test_fixture_and_writer_bytes_match_jax(tmp_path, gguf_path):
    jp = jax_make_tiny(tmp_path / "jax.gguf", **{**TINY, "quant": JGGMLType.Q4_K})
    assert jp.read_bytes() == gguf_path.read_bytes()
    freqs = np.linspace(1, 4, 32).astype(np.float32)
    a = make_tiny_llama_gguf(tmp_path / "a.gguf", rope_freqs=freqs)
    b = jax_make_tiny(tmp_path / "b.gguf", rope_freqs=freqs)
    assert a.read_bytes() == b.read_bytes()


def test_load_params_layout(gguf_path):
    g = GGUFFile.open(gguf_path)
    cfg = LlamaConfig.from_gguf(g)
    p = load_params(g, cfg, dtype=torch.float32)
    assert p["layers"]["wqkv"].qs.shape == (2, 256 + 2 * 128, 128)
    assert p["layers"]["w_gate_up"].n == 1024 and p["layers"]["w_down"].k == 512
    assert p["lm_head"].n == 512 and p["embed"].shape == (512, 256)
    g.close()


def test_params_from_jax_matches_load_params(gguf_path):
    jg = JGGUFFile.open(gguf_path)
    from nfai_tpu.models.llama import LlamaConfig as JLlamaConfig

    jcfg = JLlamaConfig.from_gguf(jg)
    jp = jax_load_params(jg, jcfg, dtype=jnp.float32, device_put=False, quantized="auto")
    np_params = jax.tree.map(np.asarray, jp)
    g = GGUFFile.open(gguf_path)
    cfg = LlamaConfig.from_gguf(g)
    mine = load_params(g, cfg, dtype=torch.float32)
    conv = params_from_jax(np_params, cfg)
    for key in ("wqkv", "wo", "w_gate_up", "w_down"):
        a = dequant(conv["layers"][key]).numpy()
        b = dequant(mine["layers"][key]).numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-20 * np.abs(b).max())
    np.testing.assert_allclose(dequant(conv["lm_head"]).numpy(), dequant(mine["lm_head"]).numpy(),
                               rtol=0, atol=2.0**-20)
    np.testing.assert_array_equal(conv["embed"].numpy(), mine["embed"].numpy())
    np.testing.assert_array_equal(conv["inv_freq"].numpy(), mine["inv_freq"].numpy())
    jg.close()
    g.close()


def test_prefill_and_teacher_forced_decode_vs_jax(engines):
    je, te = engines
    ids = te.tokenizer.encode(PROMPT)
    assert ids == je.tokenizer.encode(PROMPT)
    jl, jc = je.prefill(je.new_cache(1), ids)
    tl, tc = te.prefill(te.new_cache(1), ids)
    assert tl.shape == (1, 512)
    assert rel(tl.numpy(), np.asarray(jl)) < TOL
    rng = np.random.default_rng(0)
    pos = len(ids)
    for _ in range(8):
        tok = int(rng.integers(0, 261))
        jl, jc = jax_decode_step(je.params, je.model_cfg, jnp.asarray([tok], jnp.int32),
                                 jnp.asarray([pos], jnp.int32), jc)
        tl, tc = decode_step(te.params, te.model_cfg, torch.tensor([tok]), torch.tensor([pos]), tc)
        assert rel(tl.numpy(), np.asarray(jl)) < TOL
        assert int(tl.argmax()) == int(np.argmax(np.asarray(jl)))
        pos += 1
    # the port's cache holds what the JAX cache holds
    kv = np.asarray(jc.k)[:, :, :pos]
    assert rel(tc.k[:, :, :pos].numpy(), kv) < TOL


def test_greedy_generate_equals_jax(engines):
    je, te = engines
    ids = te.tokenizer.encode(PROMPT)
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=16)))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=16)))
    assert len(got) == 16
    assert got == want
    text = te.generate_text(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=6))
    assert text == je.generate_text(PROMPT, JSamplingParams(temperature=0.0, max_new_tokens=6))


def test_batched_prefill_step_matches_single_rows(engines):
    _, te = engines
    cfg = te.model_cfg
    rows = [list(range(10, 26)), list(range(100, 116))]
    tokens = torch.tensor(rows)
    positions = torch.arange(16)[None].expand(2, 16)
    logits, _ = prefill_step(te.params, cfg, tokens, positions, torch.tensor([15, 15]),
                             KVCache.zeros(cfg, 2, 64, torch.float32))
    for i, r in enumerate(rows):
        one, _ = prefill_step(te.params, cfg, torch.tensor([r]), positions[:1], torch.tensor([15]),
                              KVCache.zeros(cfg, 1, 64, torch.float32))
        np.testing.assert_allclose(logits[i].numpy(), one[0].numpy(), rtol=1e-4, atol=1e-4)


def test_chat_session_reuses_cache(engines):
    _, te = engines
    s = ChatSession(te, SamplingParams(temperature=0.7, max_new_tokens=8, seed=3))
    a = s.send("hi")
    cached = len(s._cached_ids)
    assert cached > 0 and isinstance(a, str)
    s.send("and again")
    assert len(s._cached_ids) > cached
    assert s.last_metrics.prompt_tokens < len(s._cached_ids)  # only the suffix prefilled


def test_cli_answers_piped_prompt(gguf_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello there\nquit\n"))
    rc = cli.main(["--gguf", str(gguf_path), "--device", "cpu", "--temp", "0",
                   "--max-new-tokens", "8", "--max-seq", "256", "--metrics"])
    assert rc == 0
    out, err = capsys.readouterr()
    assert out.strip() != ""
    assert "tok/s" in err


def test_no_cuda_fallback(gguf_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(gguf_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--gguf", str(gguf_path)])


def test_cache_rounds_up_to_the_key_tile(gguf_path):
    te = InferenceEngine(gguf_path, EngineConfig(dtype="float32", max_seq_len=100), device="cpu")
    assert te.new_cache(1).max_seq == 128
    ids = te.tokenizer.encode("x" * 90)
    out = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=32)))
    assert 0 < len(out) <= 100 - len(ids) + 1  # stops at max_seq_len, not at 128


def test_unported_options_raise(gguf_path, engines, tmp_path):
    """fp8 caches are still refused by name. Logprobs and session
    save/load run: greedy tokens and logprobs as the JAX engine's (logprobs
    within 0.12: twice 2e-2 of this fixture's logit scale of 3;
    test_torch_sampling_ext.py holds every option), and a saved session
    loads (test_torch_session.py). Speculative and constrained decoding run
    (test_speculative_and_constrained_requests_run below)."""
    with pytest.raises(NotImplementedError):  # int8 runs (test_torch_kv_int8.py); other kinds do not
        InferenceEngine(gguf_path, EngineConfig(kv_dtype="fp8"), device="cpu")
    je, te = engines
    ids = te.tokenizer.encode(PROMPT)
    jm, tm = JGenerationMetrics(), GenerationMetrics()
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=16, logprobs=2), metrics=jm))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=16, logprobs=2), metrics=tm))
    assert got == want
    assert [e["id"] for e in tm.logprobs] == got
    np.testing.assert_allclose([e["logprob"] for e in tm.logprobs], [e["logprob"] for e in jm.logprobs],
                               rtol=0, atol=0.12)
    session = ChatSession(te, SamplingParams(temperature=0.0, max_new_tokens=4))
    session.send("hi")
    session.save(tmp_path / "s.npz")
    assert ChatSession.load(te, tmp_path / "s.npz")._cached_ids == session._cached_ids


def test_speculative_and_constrained_requests_run(gguf_path, engines):
    """Speculative decoding ("ngram", and "draft" with the target's own
    GGUF as the draft) gives the plain greedy tokens; JSON mode, a regex
    and a GBNF grammar give text that satisfies them (test_torch_spec.py
    and test_torch_constrained.py hold both to the JAX package)."""
    import json
    import re

    _, te = engines
    ids = te.tokenizer.encode(PROMPT)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=12)
    want = list(te.generate(ids, greedy))
    for spec in ("ngram", "draft"):
        e = InferenceEngine(gguf_path, EngineConfig(dtype="float32", max_seq_len=256, speculative=spec,
                                                    draft_gguf=str(gguf_path) if spec == "draft" else ""),
                            device="cpu")
        m = GenerationMetrics()
        assert list(e.generate(ids, greedy, metrics=m)) == want and m.spec_drafted > 0
    checks = [(dict(response_format="json"), lambda t: isinstance(json.loads(t), dict)),
              (dict(regex="a+"), lambda t: re.fullmatch("a+", t)),
              (dict(grammar='root ::= "a"'), lambda t: t == "a")]
    for fields, ok in checks:
        text = te.generate_text(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=24, **fields))
        assert ok(text), (fields, text)
