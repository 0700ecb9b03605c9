"""The OpenAI sampling options in the port against the JAX package: logit
bias, presence/frequency penalties and logprobs, from the three plain
functions through decode_loop / paged_decode_loop, the engine's generate
and the BatchEngine (dense and paged), on seeded inputs.

Tolerances:
- the plain functions on the same f32 inputs: exact for the bias and the
  penalties (one add per element); logprobs within 1e-5 absolute (the
  log-sum-exp's summation order), equal top ids (numpy normals: no ties);
- the tiny Q4_K llama (hidden 256, 2 layers, vocab 512, f32 on both
  sides), whose logits reach |3| and agree across the packages within 2e-2
  of that (the JAX side rounds dequantized weights and matmul outputs to
  bf16; test_torch_engine.py): greedy tokens equal, up to a near-tie: where
  two greedy streams part, the port's token must be tied with JAX's by
  JAX's own logprobs (within TIE = 2e-2 x 3 = 0.06 of its top one), and
  nothing after that step is compared (on this fixture the logprobs are
  flat, top-2 gaps of 0.016 occur); every logprob (the chosen token's and
  the top list's) within LP_TOL = 0.12 absolute (a logprob moves by at
  most twice the largest logit error); the top ids equal where the next
  candidate is further than LP_TOL; the penalties' counts are exactly the
  sampled tokens' and equal JAX's where the streams agree in full.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.models.llama import KVCache as JKVCache
from nfai_tpu.models.llama import decode_loop as jax_decode_loop
from nfai_tpu.models.llama import paged_decode_loop as jax_paged_decode_loop
from nfai_tpu.models.llama import paged_prefill_step as jax_paged_prefill_step
from nfai_tpu.models.llama import prefill_step as jax_prefill_step
from nfai_tpu.ops import sampling as jsampling
from nfai_tpu.runtime.engine import GenerationMetrics as JGenerationMetrics
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu.runtime.scheduler import BatchEngine as JBatchEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.models import (
    KVCache, decode_loop, paged_decode_loop, paged_prefill_step, prefill_step,
)
from nfai_tpu_torch.ops import sampling
from nfai_tpu_torch.runtime.engine import GenerationMetrics, InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf

LP_TOL = 0.12
TIE = 0.06
TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            vocab_size=512, quant=GGMLType.Q4_K, tied=False, context_length=256)
CONFIG = dict(max_seq_len=96, dtype="float32", prefill_chunk=32, page_size=16, decode_chunk=8)
PS = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores; restored
    for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the three plain functions -------------------------------------------------


def test_apply_logit_bias_equals_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 64)).astype(np.float32)
    ids = np.array([[3, 9, 0, 0], [5, 5, 7, 0], [63, 0, 0, 0]], np.int32)  # padding, a repeated id
    vals = np.array([[100.0, -2.5, 0, 0], [1.5, 2.0, -100.0, 0], [0.25, 0, 0, 0]], np.float32)
    want = np.asarray(jsampling.apply_logit_bias(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(vals)))
    got = sampling.apply_logit_bias(torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == logits[0, 0]  # padding adds 0.0 to token 0


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_penalties_equals_jax(per_row):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 64)).astype(np.float32)
    counts = rng.integers(0, 3, (3, 64)).astype(np.int32) * (rng.random((3, 64)) < 0.2)
    pres, freq = (np.array([0.5, 0.0, 1.25], np.float32), np.array([0.25, 2.0, 0.0], np.float32)) \
        if per_row else (0.5, 0.25)
    want = np.asarray(jsampling.apply_penalties(jnp.asarray(logits), jnp.asarray(counts.astype(np.int32)),
                                                jnp.asarray(pres), jnp.asarray(freq)))
    got = sampling.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts.astype(np.int32)),
                                   torch.as_tensor(pres), torch.as_tensor(freq))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_top", [0, 1, 5, 20])
def test_token_logprobs_equals_jax(n_top):
    rng = np.random.default_rng(2 + n_top)
    logits = (rng.standard_normal((4, 512)) * 3).astype(np.float32)
    chosen = np.array([3, 10, 511, 0], np.int32)
    jlp, jid, jtlp = jsampling.token_logprobs(jnp.asarray(logits), jnp.asarray(chosen), n_top)
    lp, tid, tlp = sampling.token_logprobs(torch.from_numpy(logits), torch.from_numpy(chosen), n_top)
    assert tid.shape == tlp.shape == (4, max(n_top, 1))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jtlp), rtol=0, atol=1e-5)
    assert (tlp.numpy() <= 0).all() and (np.diff(tlp.numpy(), axis=1) <= 0).all()


def test_logprob_entries_order_ties_by_id():
    """Equal logprobs come out of torch.topk in its own order; the host
    record puts them in ascending id (the JAX order: a stable argsort of
    lax.top_k's lowest-index-first ties) before cutting to the request's k."""
    logits = torch.full((1, 32), -5.0)
    logits[0, [20, 4, 11]] = 2.0  # three equal maxima
    logits[0, 7] = 1.0
    lp, tid, tlp = sampling.token_logprobs(logits, torch.tensor([7]), 4)
    assert sorted(tid[0, :3].tolist()) == [4, 11, 20] and tid[0, 3] == 7
    e = sampling.logprob_entry(lp.tolist(), tid.tolist(), tlp.tolist(), 0, 4, 7)
    assert [i for i, _ in e["top"]] == [4, 11, 20, 7] and e["id"] == 7
    assert e["top"][0][1] == e["top"][1][1] == e["top"][2][1] > e["top"][3][1] == e["logprob"]
    assert [i for i, _ in sampling.logprob_entry(lp.tolist(), tid.tolist(), tlp.tolist(), 0, 2, 7)["top"]] == [4, 11]
    assert sampling.logprob_entry(lp.tolist(), tid.tolist(), tlp.tolist(), 0, 0, 7)["top"] == []


# -- the tiny model ------------------------------------------------------------


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("sx") / "tiny_q4k.gguf", **TINY)


@pytest.fixture(scope="module")
def engines(gguf_path):
    """{kv_dtype: (JAX engine, port engine)}, both in float32."""
    return {kv: (JInferenceEngine(str(gguf_path), JEngineConfig(kv_dtype=kv, **CONFIG)),
                 InferenceEngine(gguf_path, EngineConfig(kv_dtype=kv, **CONFIG), device="cpu"))
            for kv in ("auto", "int8")}


PROMPTS = np.random.default_rng(3).integers(5, 250, (2, 12))
TABLES = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
FORCED = 300


def _options(vocab):
    """Per-row options at batch 2: row 0 forces FORCED (+100) with a heavy
    frequency penalty, so it must leave FORCED after a few repeats; row 1
    bans two ids and has a presence penalty."""
    bias_ids = np.array([[FORCED, 0, 0], [17, 42, 0]], np.int32)
    bias_vals = np.array([[100.0, 0, 0], [-100.0, -100.0, 0]], np.float32)
    return dict(bias_ids=bias_ids, bias_vals=bias_vals,
                presence=np.array([0.0, 0.75], np.float32), frequency=np.array([30.0, 0.5], np.float32),
                counts=np.zeros((2, vocab), np.int32))


def _assert_logprobs_close(got, want):
    """(chosen_lp, top_ids, top_lps) against the JAX arrays: the values,
    rank by rank, within LP_TOL; an id in both top lists has logprobs
    within LP_TOL on both sides, and an id in the port's list only must
    lie within LP_TOL of JAX's last entry (the two lists may cut a run of
    near-equal candidates at different places)."""
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), rtol=0, atol=LP_TOL)
    tid, tlp = np.asarray(got[1]).reshape(-1, np.shape(got[1])[-1]), np.asarray(got[2]).reshape(tid_shape := (-1, np.shape(got[1])[-1]))
    jid, jtlp = np.asarray(want[1]).reshape(tid_shape), np.asarray(want[2]).reshape(tid_shape)
    for ids, lps, jids, jlps in zip(tid, tlp, jid, jtlp):
        jof = dict(zip(jids.tolist(), jlps.tolist()))
        for i, v in zip(ids.tolist(), lps.tolist()):
            assert abs(v - jof[i]) <= LP_TOL if i in jof else v <= jlps[-1] + LP_TOL, (i, v, jof)


def _agreed(got, want, top):
    """The length of the common prefix of two greedy streams; where they
    part, the port's token must be in JAX's top list `top[d]` ((ids, lps)
    at that step) within TIE of its first entry."""
    for d, (g, w) in enumerate(zip(got, want)):
        if g != w:
            ids, lps = (list(x) for x in top[d])
            assert g in ids and lps[ids.index(g)] >= lps[0] - TIE, (d, g, w, ids, lps)
            return d
    assert len(got) == len(want)
    return len(got)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_decode_loops_with_options_equal_jax(engines, kv, paged):
    je, te = engines[kv]
    quant = kv == "int8"
    cfg, jcfg = te.model_cfg, je.model_cfg
    t = PROMPTS.shape[1]
    positions = np.arange(t)[None].repeat(2, 0)
    if paged:
        jcache = JPagedKVCache.zeros(jcfg, n_pages=9, page_size=PS, dtype=jnp.float32, quantized=quant)
        cache = PagedKVCache.zeros(cfg, 9, PS, torch.float32, quantized=quant)
        jl, tl = [], []
        for r in range(2):
            args = (PROMPTS[r:r + 1], positions[:1], np.array([t - 1]))
            jlog, jcache = jax_paged_prefill_step(je.params, jcfg, *(jnp.asarray(a, jnp.int32) for a in args),
                                                  jcache, jnp.asarray(TABLES[r:r + 1]))
            tlog, cache = paged_prefill_step(te.params, cfg, *(torch.from_numpy(a).long() for a in args),
                                             cache, torch.from_numpy(TABLES[r:r + 1]))
            jl.append(np.asarray(jlog))
            tl.append(tlog.numpy())
        jlog, tlog = np.concatenate(jl), np.concatenate(tl)
    else:
        jcache = JKVCache.zeros(jcfg, 2, 96, jnp.float32, quantized=quant)
        cache = KVCache.zeros(cfg, 2, 128, torch.float32, quantized=quant)
        args = (PROMPTS, positions, np.array([t - 1, t - 1]))
        jlog, jcache = jax_prefill_step(je.params, jcfg, *(jnp.asarray(a, jnp.int32) for a in args), jcache)
        tlog, cache = prefill_step(te.params, cfg, *(torch.from_numpy(a).long() for a in args), cache)
        jlog, tlog = np.asarray(jlog), tlog.numpy()
    first = np.argmax(jlog, -1)
    assert (np.argmax(tlog, -1) == first).all()
    opts = _options(cfg.vocab_size)
    n = 8
    common = dict(temperature=0.0, n_logprobs=3)
    jout = (jax_paged_decode_loop(je.params, jcfg, jnp.asarray(first, jnp.int32), jnp.asarray([t, t], jnp.int32),
                                  jcache, jnp.asarray(TABLES), jax.random.PRNGKey(0), n,
                                  **{k: jnp.asarray(v) for k, v in opts.items()}, **common)
            if paged else
            jax_decode_loop(je.params, jcfg, jnp.asarray(first, jnp.int32), jnp.asarray([t, t], jnp.int32),
                            jcache, jax.random.PRNGKey(0), n, **{k: jnp.asarray(v) for k, v in opts.items()},
                            **common))
    topts = {k: torch.from_numpy(v) for k, v in opts.items()}
    tout = (paged_decode_loop(te.params, cfg, torch.from_numpy(first), torch.tensor([t, t]), cache,
                              torch.from_numpy(TABLES), None, n, **topts, **common)
            if paged else
            decode_loop(te.params, cfg, torch.from_numpy(first), torch.tensor([t, t]), cache, None, n,
                        **topts, **common))
    assert len(tout) == len(jout) == 8
    assert tout[5].shape == (2, n) and tout[6].shape == tout[7].shape == (2, n, 3)
    # the tokens each step sampled (the step's logprobs describe them)
    seq = torch.cat([tout[0][:, 1:], tout[1][:, None]], 1).tolist()
    jseq = np.concatenate([np.asarray(jout[0])[:, 1:], np.asarray(jout[1])[:, None]], 1).tolist()
    jtid, jtlp = np.asarray(jout[6]), np.asarray(jout[7])
    for r in range(2):
        d = _agreed(seq[r], jseq[r], list(zip(jtid[r], jtlp[r])))
        # steps up to the parting one saw the same history
        _assert_logprobs_close([a[r, :d + 1].numpy() for a in tout[5:]],
                               [np.asarray(a)[r, :d + 1] for a in jout[5:]])
        assert tout[4][r].tolist() == np.bincount(seq[r], minlength=cfg.vocab_size).tolist()
        if d == n:
            np.testing.assert_array_equal(tout[4][r].numpy(), np.asarray(jout[4])[r])
    assert seq[0][0] == FORCED and any(x != FORCED for x in seq[0][1:])  # forced, then penalised off it
    assert not {17, 42} & set(seq[1])
    assert torch.equal(topts["counts"], torch.zeros_like(topts["counts"]))  # the argument is left as it was


def test_decode_loop_frozen_rows_do_not_count(engines):
    """A row whose `active` entry is False neither advances nor adds to its
    counts; its logprobs describe the token it keeps."""
    _, te = engines["auto"]
    cfg = te.model_cfg
    cache = KVCache.zeros(cfg, 2, 128, torch.float32)
    t = PROMPTS.shape[1]
    logits, cache = prefill_step(te.params, cfg, torch.from_numpy(PROMPTS).long(),
                                 torch.arange(t)[None].repeat(2, 1), torch.tensor([t - 1, t - 1]), cache)
    first = logits.argmax(-1)
    counts = torch.zeros((2, cfg.vocab_size), dtype=torch.int32)
    out = decode_loop(te.params, cfg, first, torch.tensor([t, t]), cache, None, 4, temperature=0.0,
                      active=torch.tensor([True, False]), presence=0.5, frequency=0.5, counts=counts,
                      n_logprobs=0)
    assert out[4][0].sum() == 4 and out[4][1].sum() == 0
    assert out[0][1].tolist() == [int(first[1])] * 4 and int(out[1][1]) == int(first[1])
    assert out[6].shape == (2, 4, 1)


CASES = {
    "forcing bias": dict(logit_bias=((FORCED, 100.0), (5, -100.0)), logprobs=5),
    "frequency penalty": dict(frequency_penalty=1.5, logprobs=2),
    "presence penalty and bias": dict(presence_penalty=2.0, logit_bias=((60, 3.0),), logprobs=3),
}


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_with_options_equals_jax(engines, case, kv):
    """Greedy generate: tokens equal, GenerationMetrics.logprobs aligned
    with them (one entry per token, across the chunk boundaries: decode
    chunk 8 over 40 tokens) and within LP_TOL of the JAX engine's."""
    je, te = engines[kv]
    ids = [int(x) for x in PROMPTS[0]]
    opts = dict(temperature=0.0, max_new_tokens=40, **CASES[case])
    jm, tm = JGenerationMetrics(), GenerationMetrics()
    want = list(je.generate(ids, JSamplingParams(**opts), metrics=jm))
    got = list(te.generate(ids, SamplingParams(**opts), metrics=tm))
    assert len(got) == 40 and [e["id"] for e in tm.logprobs] == got
    k = opts["logprobs"]
    jtop = [([i for i, _ in e["top"]], [v for _, v in e["top"]]) if k else ([e["id"]], [e["logprob"]])
            for e in jm.logprobs]
    d = _agreed(got, want, jtop)
    for g, w in zip(tm.logprobs[:d + 1], jm.logprobs[:d + 1]):
        assert len(g["top"]) == len(w["top"]) == k
        _assert_logprobs_close(
            (np.array([g["logprob"]]), np.array([[i for i, _ in g["top"]]], np.int64).reshape(1, k),
             np.array([[v for _, v in g["top"]]], np.float32).reshape(1, k)),
            (np.array([w["logprob"]]), np.array([[i for i, _ in w["top"]]], np.int64).reshape(1, k),
             np.array([[v for _, v in w["top"]]], np.float32).reshape(1, k)))
        assert g["logprob"] <= 1e-6
    if case == "forcing bias":
        assert got[0] == FORCED and 5 not in got
    if case == "frequency penalty":
        plain = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=40)))
        assert got != plain and len(set(got)) > len(set(plain))


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_generate_logprobs_describe_each_token(engines, kv):
    """The logprob carry across chunks (decode chunk 8, 20 tokens, one
    budget-cut tail): entry i is what a fresh prefill of the prompt and the
    first i tokens gives for token i, after the bias and the penalties of
    those i tokens: its top ids equal (where the neighbours lie more than
    twice the tolerance apart) and every logprob within 2e-2 (a prefill
    and a decode step sum in different orders, and the plain matmul rounds
    to bf16, whose step at a logit near 3 is 2^-6; int8: the prefill
    attends its own tokens quantized where a decode step folds the newest
    in at full precision, which stays within the same 2e-2 here)."""
    _, te = engines[kv]
    tol = 2e-2
    ids = [int(x) for x in PROMPTS[1]]
    s = SamplingParams(temperature=0.0, max_new_tokens=20, logprobs=3, logit_bias=((FORCED, 4.0),),
                       frequency_penalty=0.7, presence_penalty=0.3)
    m = GenerationMetrics()
    got = list(te.generate(ids, s, metrics=m))
    assert len(got) == len(m.logprobs) == 20 and FORCED in got
    vocab = te.model_cfg.vocab_size
    for i, e in enumerate(m.logprobs):
        logits, _ = te.prefill(te.new_cache(1), ids + got[:i])
        logits = sampling.apply_logit_bias(logits, torch.tensor([[FORCED]]), torch.tensor([[4.0]]))
        counts = torch.bincount(torch.tensor(got[:i], dtype=torch.int64), minlength=vocab)[None]
        logits = sampling.apply_penalties(logits, counts.int(), 0.3, 0.7)
        lp, tid, tlp = sampling.token_logprobs(logits, torch.tensor([got[i]]), 3)
        assert e["id"] == got[i]
        assert abs(e["logprob"] - float(lp[0])) <= tol, i
        vals = tlp[0].tolist()
        np.testing.assert_allclose([v for _, v in e["top"]], vals, rtol=0, atol=tol)
        gaps = np.abs(np.diff(vals))
        for r, t in enumerate(tid[0].tolist()):
            if (r == 0 or gaps[r - 1] > 2 * tol) and (r == len(vals) - 1 or gaps[r] > 2 * tol):
                assert e["top"][r][0] == t, (i, r)


def test_generate_refuses_bias_ids_outside_the_vocabulary(engines):
    _, te = engines["auto"]
    with pytest.raises(ValueError, match="outside the vocabulary"):
        list(te.generate([1, 2, 3], SamplingParams(logit_bias=((512, 1.0),))))


# -- the BatchEngine -----------------------------------------------------------


def _mixed():
    """Six greedy requests on 4 slots, every option mixed with plain ones."""
    prompts = [[int(x) for x in np.random.default_rng(10 + i).integers(5, 250, n)]
               for i, n in enumerate((6, 11, 17, 9, 14, 20))]
    opts = [dict(logprobs=2), dict(logit_bias=((FORCED, 100.0),), frequency_penalty=40.0, logprobs=0),
            dict(), dict(presence_penalty=1.0, frequency_penalty=0.5),
            dict(logit_bias=tuple((i, -100.0) for i in range(20, 36)), logprobs=5),
            dict(frequency_penalty=2.0, logprobs=3)]
    return prompts, [dict(temperature=0.0, max_new_tokens=12, **o) for o in opts]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batch_engine_with_mixed_options_equals_jax(engines, paged):
    """The JAX BatchEngine runs the same requests with logprobs of at least
    2 on every one (the tokens do not depend on them), so that each stream
    can be held to the near-tie rule."""
    je, te = engines["auto"]
    prompts, opts = _mixed()
    jbe = JBatchEngine(je, max_batch=4, decode_chunk=4, paged=paged)
    be = BatchEngine(te, max_batch=4, decode_chunk=4, paged=paged)
    jreqs = [jbe.submit(p, JSamplingParams(**{**o, "logprobs": max(2, o.get("logprobs") or 0)}))
             for p, o in zip(prompts, opts)]
    reqs = [be.submit(p, SamplingParams(**o)) for p, o in zip(prompts, opts)]
    for b in (jbe, be):
        for _ in range(300):
            if b.step() == 0 and b.queue.empty():
                break
    assert all(r.state == RequestState.FINISHED for r in reqs)
    for r, jr, o in zip(reqs, jreqs, opts):
        assert len(r.output_ids) == 12
        d = _agreed(r.output_ids, jr.output_ids,
                    [([i for i, _ in e["top"]], [v for _, v in e["top"]]) for e in jr.logprob_data])
        if o.get("logprobs") is None:
            assert r.logprob_data == []
            continue
        assert [e["id"] for e in r.logprob_data] == r.output_ids
        for g, w in zip(r.logprob_data[:d + 1], jr.logprob_data[:d + 1]):
            assert len(g["top"]) == o["logprobs"]
            assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
            jof = dict(w["top"])
            assert all(abs(v - jof[i]) <= LP_TOL if i in jof else v <= w["top"][-1][1] + LP_TOL
                       for i, v in g["top"])
    assert reqs[1].output_ids[0] == FORCED and any(t != FORCED for t in reqs[1].output_ids)
    assert not set(range(20, 36)) & set(reqs[4].output_ids)
    # every slot's stream is its single-request run, up to a near-tie
    # (batched and single-row matmuls round differently)
    for p, o, r in zip(prompts, opts, reqs):
        m = GenerationMetrics()
        single = list(te.generate(p, SamplingParams(**{**o, "logprobs": 3}), metrics=m))
        _agreed(r.output_ids, single, [([i for i, _ in e["top"]], [v for _, v in e["top"]]) for e in m.logprobs])


def test_batch_engine_keeps_the_largest_bias_entries(engines, caplog):
    _, te = engines["auto"]
    be = BatchEngine(te, max_batch=2)
    s = SamplingParams(logit_bias=tuple((i, float(i)) for i in range(40)))
    ids, vals = be._bias_row(s)
    assert ids.tolist() == list(range(39, 23, -1)) and vals.tolist() == [float(i) for i in range(39, 23, -1)]
    be._bias_row(s)
    assert sum("keeping the 16 largest" in r.message for r in caplog.records) == 1
