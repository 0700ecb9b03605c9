"""The port's perplexity tool (nfai_tpu_torch.eval) against the JAX
package's (nfai_tpu.eval) on tiny Q8_0 and Q4_K llamas (the JAX eval
test's fixture at hidden 256, where Q4_K's 256-wide blocks fit, and the
fixture tokenizer's whole vocabulary; 2 layers; f32 on both sides, the
port on the CPU).

Tolerance: the mean NLL (log perplexity) within NLL_TOL = 5e-3 relative of
the JAX value. The JAX side rounds dequantized weights and matmul outputs
to bf16 (its logits agree with the port's within 2e-2 of their largest,
test_torch_engine.py); averaged over every target the NLLs agree far more
closely. `main` prints the JAX tool's JSON keys, each value within the same
tolerance in log space (deltas: within NLL_TOL x the perplexity).
"""
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu import eval as jeval
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models import LlamaConfig as JLlamaConfig
from nfai_tpu.models import load_params as jax_load_params
from nfai_tpu_torch import eval as teval
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import LlamaConfig, load_params
from nfai_tpu_torch.testing import make_tiny_llama_gguf

NLL_TOL = 5e-3
TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=512, seed=9)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores; restored
    for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[GGMLType.Q8_0, GGMLType.Q4_K], ids=lambda q: q.name)
def gguf_path(request, tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("ev") / f"{request.param.name}.gguf",
                                quant=request.param, **TINY)


def close_ppl(got, want):
    assert abs(math.log(got) - math.log(want)) <= NLL_TOL * math.log(want), (got, want)


@pytest.mark.parametrize("mode,kv_quant", [("quantized", False), ("dense", False), ("quantized", True)])
def test_perplexity_equals_jax(gguf_path, mode, kv_quant):
    ids = np.random.default_rng(4).integers(0, 250, size=96).astype(np.int32)
    jg = JGGUFFile.open(gguf_path)  # left open: the JAX dense params may view its map
    jcfg = JLlamaConfig.from_gguf(jg)
    jp = jax_load_params(jg, jcfg, dtype=jnp.float32, quantized="auto" if mode == "quantized" else False)
    want = jeval.perplexity(jp, jcfg, ids, window=32, kv_quant=kv_quant)
    with GGUFFile.open(gguf_path) as g:
        cfg = LlamaConfig.from_gguf(g)
        params = load_params(g, cfg, dtype=torch.float32, quantized=mode == "quantized")
    got = teval.perplexity(params, cfg, ids, window=32, dtype=torch.float32, kv_quant=kv_quant)
    assert np.isfinite(got) and got > 1
    close_ppl(got, want)


def test_window_nll_blocks_the_log_softmax(gguf_path, monkeypatch):
    """The row-blocked log-sum-exp gives the full log_softmax's NLL (blocks
    of 5 rows over a 32-token window: a ragged last block)."""
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 250, size=(1, 32)))
    with GGUFFile.open(gguf_path) as g:
        cfg = LlamaConfig.from_gguf(g)
        params = load_params(g, cfg, dtype=torch.float32)
    from nfai_tpu_torch.models import KVCache
    from nfai_tpu_torch.models.llama import forward, logits_for

    with torch.inference_mode():
        h, _ = forward(params, cfg, ids, torch.arange(32)[None], KVCache.zeros(cfg, 1, 64, torch.float32))
        ref = -torch.log_softmax(logits_for(params, h[0], cfg)[:-1], -1).gather(1, ids[0, 1:, None]).sum()
    monkeypatch.setattr(teval, "LSE_ROWS", 5)
    nll, count = teval.window_nll(params, cfg, ids, KVCache.zeros(cfg, 1, 64, torch.float32))
    assert count == 31
    assert abs(nll - float(ref)) <= 1e-4 * abs(float(ref))


def test_perplexity_requires_enough_tokens(gguf_path):
    with GGUFFile.open(gguf_path) as g:
        cfg = LlamaConfig.from_gguf(g)
        params = load_params(g, cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="need at least 32 tokens"):
        teval.perplexity(params, cfg, np.arange(10), window=32, dtype=torch.float32)


@pytest.mark.parametrize("flags", [[], ["--dense"], ["--compare", "--kv", "int8"]],
                         ids=["quantized", "dense", "compare-kv-int8"])
def test_main_prints_the_jax_json(gguf_path, tmp_path, flags, capsys, monkeypatch):
    monkeypatch.setenv("NFAI_JAX_CACHE", str(tmp_path / "jax_cache"))
    text = tmp_path / "corpus.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 6)
    common = ["--gguf", str(gguf_path), "--text", str(text), "--window", "32", "--max-tokens", "128",
              "--dtype", "float32", *flags]
    assert jeval.main(common) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert teval.main(common + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    for key, w in want.items():
        if "delta" in key:
            assert abs(got[key] - w) <= 2 * NLL_TOL * max(want.get("ppl_quantized", 0), want.get("ppl_dense", 0))
        else:
            close_ppl(got[key], w)


def test_main_refuses_to_run_without_a_card(gguf_path, tmp_path, monkeypatch):
    text = tmp_path / "t.txt"
    text.write_text("abc " * 20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.main(["--gguf", str(gguf_path), "--text", str(text)])
