"""The pipeline stage split (parallel/pipeline_parallel.py) against the JAX
package on the CPU, in this process (one device: the JAX `pp_forward` runs
without `devices`, so no multi-device program is compiled here).

- `split_stages` and `split_cache` against the JAX ones on a tiny llama
  (dense and Q4_K weights, 2 and 4 stages): the same layer keys, every
  stage leaf the L-slice of its stack (the JAX stage's leaves converted to
  the port's containers dequantize to the port stage's), the caches'
  slices;
- `pp_forward` logits (a 24-token prefill, then one decode token) against
  the port's one-stage forward (2e-4) and the JAX `pp_forward` (2e-4 on
  dense weights, 2e-2 on Q4_K, relative to the largest logit), and the
  stage caches against the one-stage cache's slices;
- the JAX fault (ROADMAP §3): the JAX `split_stages` gives the final norm
  and the LM head to every stage, the port to the last only;
- a stage boundary inside gemma2's sliding-window period raises in both
  packages; a boundary on the period runs the windows as one stage does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models import KVCache as JKVCache
from nfai_tpu.models import llama as JL
from nfai_tpu.parallel.pipeline_parallel import pp_forward as jax_pp_forward
from nfai_tpu.parallel.pipeline_parallel import split_cache as jax_split_cache
from nfai_tpu.parallel.pipeline_parallel import split_stages as jax_split_stages
from nfai_tpu.parallel.pipeline_parallel import stage_config as jax_stage_config
from nfai_tpu_torch.gguf import GGUFFile
from nfai_tpu_torch.models import KVCache, LlamaConfig, load_params
from nfai_tpu_torch.models.llama import forward, logits_for, params_from_jax
from nfai_tpu_torch.ops.qtensor import LayerList, Q4Tensor, Q8Tensor, dequant
from nfai_tpu_torch.parallel import pp_forward, split_cache, split_stages, stage_config
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TINY = dict(hidden=256, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=512, context_length=512)
T = 24
# the port against the JAX package: f32 on dense weights; on Q4_K the JAX
# kernels' bf16 rounding (tests/test_torch_engine.py's rule, relative to the
# largest logit)
JAX_TOL = {None: 2e-4, JGGMLType.Q4_K: 2e-2}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _load(tmp_path, quant=None, **kw):
    args = {**TINY, **kw, **({"quant": quant} if quant is not None else {})}
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", **args)
    with JGGUFFile.open(path) as jg:
        jcfg = JL.LlamaConfig.from_gguf(jg)
        jp = JL.load_params(jg, jcfg, dtype=jnp.float32, quantized="auto" if quant is not None else False)
    with GGUFFile.open(path) as g:
        cfg = LlamaConfig.from_gguf(g)
        params = load_params(g, cfg, dtype=torch.float32, quantized=quant is not None)
    return cfg, params, jcfg, jp


def _dense(w) -> np.ndarray:
    if isinstance(w, LayerList):
        return np.stack([_dense(it) for it in w.items])
    return (dequant(w) if isinstance(w, (Q4Tensor, Q8Tensor)) else w).float().numpy()


def _jax_layers_as_port(jstage: dict, jp: dict, cfg) -> dict:
    """A JAX stage's layer leaves converted to the port's containers (the
    embedding, head and norms taken from the whole JAX params)."""
    src = {"layers": jax_to_numpy(jstage["layers"]), **{k: jax_to_numpy(jp[k]) for k in
                                                        ("embed", "final_norm", "lm_head", "inv_freq")}}
    return params_from_jax(src, cfg)["layers"]


def jax_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("quant", [None, JGGMLType.Q4_K], ids=["dense", "q4_k"])
def test_split_stages_and_cache_match_jax(tmp_path, n_stages, quant):
    cfg, params, jcfg, jp = _load(tmp_path, quant)
    stages, jstages = split_stages(params, n_stages, cfg), jax_split_stages(jp, n_stages, jcfg)
    per = cfg.n_layers // n_stages
    for i, ((st, scfg), (jst, jscfg)) in enumerate(zip(stages, jstages)):
        assert scfg.n_layers == jscfg.n_layers == per
        assert set(st["layers"]) == set(jst["layers"])
        from_jax = _jax_layers_as_port(jst, jp, cfg)
        for key, w in st["layers"].items():
            whole = _dense(params["layers"][key])[i * per:(i + 1) * per]
            assert np.array_equal(_dense(w), whole)  # the port stage: the stack's L-slice
            np.testing.assert_allclose(_dense(from_jax[key]), whole, rtol=0, atol=1e-6)
        assert (st["embed"] is not None) == (jst["embed"] is not None)
        assert i == 0 or st["embed"] is None
    cache = KVCache.zeros(cfg, 1, 128, torch.float32)
    jcache = JKVCache.zeros(jcfg, 1, 128, jnp.float32)
    for c, jc in zip(split_cache(cache, n_stages), jax_split_cache(jcache, n_stages)):
        assert tuple(c.k.shape) == tuple(jc.k.shape) == (per, 1, 128, cfg.n_kv_heads * cfg.head_dim)
        assert c.k.data_ptr() >= cache.k.data_ptr()  # views of the whole cache


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("quant", [None, JGGMLType.Q4_K], ids=["dense", "q4_k"])
def test_pp_forward_matches_jax_and_one_stage(tmp_path, n_stages, quant):
    cfg, params, jcfg, jp = _load(tmp_path, quant)
    rng = np.random.default_rng(0)
    toks = rng.integers(5, 200, (1, T))
    tokens, positions = torch.from_numpy(toks), torch.arange(T)[None]
    with torch.inference_mode():
        want_h, want_cache = forward(params, cfg, tokens, positions, KVCache.zeros(cfg, 1, 128, torch.float32))
    want = logits_for(params, want_h[:, -1:], cfg)
    stages = split_stages(params, n_stages, cfg)
    got_h, caches = pp_forward(stages, tokens, positions, split_cache(KVCache.zeros(cfg, 1, 128, torch.float32),
                                                                      n_stages))
    got = logits_for(stages[-1][0], got_h[:, -1:], cfg)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    per = cfg.n_layers // n_stages
    for i, c in enumerate(caches):
        torch.testing.assert_close(c.k, want_cache.k[i * per:(i + 1) * per], rtol=1e-5, atol=1e-5)
    jstages = jax_split_stages(jp, n_stages, jcfg)
    jh, jcaches = jax_pp_forward(jstages, jnp.asarray(toks, jnp.int32), jnp.asarray(positions.numpy(), jnp.int32),
                                 jax_split_cache(JKVCache.zeros(jcfg, 1, 128, jnp.float32), n_stages))
    assert _rel(got, JL.logits_for(jstages[-1][0], jh[:, -1:])) < JAX_TOL[quant]
    # one decode token through the pipeline
    tok = torch.argmax(want, dim=-1)
    pos1 = torch.full((1, 1), T)
    with torch.inference_mode():
        want1 = logits_for(params, forward(params, cfg, tok, pos1, want_cache)[0], cfg)
    got_h1, _ = pp_forward(stages, tok, pos1, caches)
    torch.testing.assert_close(logits_for(stages[-1][0], got_h1, cfg), want1, rtol=2e-4, atol=2e-4)
    jh1, _ = jax_pp_forward(jstages, jnp.asarray(tok.numpy(), jnp.int32), jnp.asarray(pos1.numpy(), jnp.int32),
                            jcaches)
    assert _rel(logits_for(stages[-1][0], got_h1, cfg), JL.logits_for(jstages[-1][0], jh1)) < JAX_TOL[quant]


def test_jax_fault_every_stage_holds_the_final_norm_and_head(tmp_path):
    """ROADMAP §3: the JAX `split_stages` gives `final_norm` and `lm_head` to
    every stage (nfai_tpu/parallel/pipeline_parallel.py:84-85), though only
    the last stage reads them: n_stages copies of the head where a real
    pipeline places one. The port gives them to the last stage only (and
    the embedding to the first), with the same logits."""
    cfg, params, jcfg, jp = _load(tmp_path, JGGMLType.Q4_K, tied=False)
    jstages = jax_split_stages(jp, 4, jcfg)
    assert all(st["lm_head"] is not None and st["final_norm"] is not None for st, _ in jstages)
    stages = split_stages(params, 4, cfg)
    assert [st["lm_head"] is not None for st, _ in stages] == [False, False, False, True]
    assert [st["final_norm"] is not None for st, _ in stages] == [False, False, False, True]
    assert [st["embed"] is not None for st, _ in stages] == [True, False, False, False]


def test_swa_boundary_refused_in_both_packages(tmp_path):
    """gemma2's local/global period is 2 layers: a boundary after layer 1
    raises in both packages; after layer 2 the stages run the windows as
    one stage does."""
    kw = dict(arch="gemma2", post_norms=True, sliding_window=4, attn_softcap=50.0, final_softcap=30.0,
              spm_tokenizer=True)
    cfg, params, jcfg, jp = _load(tmp_path, **kw)
    for fn in (lambda: stage_config(cfg, 1, first_layer=1), lambda: jax_stage_config(jcfg, 1, first_layer=1),
               lambda: split_stages(params, 4, cfg), lambda: jax_split_stages(jp, 4, jcfg)):
        with pytest.raises(NotImplementedError, match="SWA pattern period"):
            fn()
    tokens, positions = torch.arange(5, 5 + T)[None], torch.arange(T)[None]
    with torch.inference_mode():
        want = logits_for(params, forward(params, cfg, tokens, positions, KVCache.zeros(cfg, 1, 64, torch.float32))[0],
                          cfg)
    stages = split_stages(params, 2, cfg)
    h, _ = pp_forward(stages, tokens, positions, split_cache(KVCache.zeros(cfg, 1, 64, torch.float32), 2))
    torch.testing.assert_close(logits_for(stages[-1][0], h, cfg), want, rtol=2e-4, atol=2e-4)
