"""Speculative decoding in the port against the JAX package on the CPU:
`_ngram_propose`, `_ngram_draft_device`, `spec_decode_rounds`,
`draft_spec_rounds`, `spec_verify_sample`, the engine's ngram and draft
paths and the BatchEngine's batched speculative step (dense and paged).

Greedy speculation must give plain greedy decoding's tokens. The tiny
fixture's logits are flat (top-two logprob gaps of 0.006 occur), so streams
are held equal up to a near-tie: where two streams part, the token taken
must lie within TIE = 0.06 of the top of the reference run's logprobs there
(test_torch_sampling_ext.py's rule). The port's rounds and engines are held
to the port's plain greedy stream this way (a verify forward runs its
matmuls over B(gamma + 1) rows, a decode step over B, and the two may round
a near-tie apart), the port's plain stream to the JAX engine's, and the JAX
functions on the same weights (carried across with `params_from_jax`, f32)
to the JAX engine's.

`spec_verify_sample`'s law is checked within the port (in-process XLA:CPU
compiles of the JAX function are unreliable, tests/test_spec_sampling.py):
Monte Carlo over 40000 rows of one call against the exact law of plain
sampling from `filtered_for_sampling`, by a chi-square test at p > 1e-3
over the tokens of nonzero probability (and no draw elsewhere); greedy rows
are exact.

Also one test per reference fault: the JAX BatchEngine's frozen lanes write
K/V rows (a mid-prefill dense lane's row 0, a shared prefix page) where the
port's write none (fault 1), and an unknown `speculative` value runs plain
decoding in the JAX engine where the port raises (fault 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import nfai_tpu.models.llama as jllama
from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.runtime.engine import GenerationMetrics as JGenerationMetrics
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.engine import _ngram_propose as jax_ngram_propose
from nfai_tpu.runtime.scheduler import BatchEngine as JBatchEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.models import params_from_jax, prefill_step
from nfai_tpu_torch.models.llama import _ngram_draft_device, draft_spec_rounds, spec_decode_rounds
from nfai_tpu_torch.ops.sampling import filtered_for_sampling, spec_verify_sample
from nfai_tpu_torch.runtime import scheduler
from nfai_tpu_torch.runtime.engine import ChatSession, GenerationMetrics, InferenceEngine, _ngram_propose
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            quant=GGMLType.Q4_K, tied=False, context_length=128)
DRAFT = dict(hidden=256, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=256,  # a smaller model, the same vocab
             quant=GGMLType.Q4_K, tied=False, context_length=128, seed=99)
CONFIG = dict(max_seq_len=96, dtype="float32", prefill_chunk=32, page_size=16)
SPEC = dict(spec_tokens=4, spec_rounds=2)
PROMPT = [3, 4, 5, 3, 4, 5, 3, 4]  # repetitive: the n-gram drafts hit
TIE = 0.06


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores; restored
    for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    return make_tiny_llama_gguf(d / "target.gguf", **TINY), make_tiny_llama_gguf(d / "draft.gguf", **DRAFT)


@pytest.fixture(scope="module")
def engines(paths):
    je = JInferenceEngine(str(paths[0]), JEngineConfig(**CONFIG))
    te = InferenceEngine(paths[0], EngineConfig(**CONFIG), device="cpu")
    te.params = params_from_jax(jax.tree.map(np.asarray, je.params), te.model_cfg)  # the JAX weights
    return je, te


@pytest.fixture(scope="module")
def plain(engines):
    """Greedy streams of PROMPT (48 tokens): the port's, and the JAX
    engine's with its logprobs (top 5) for the near-tie rule."""
    je, te = engines
    jm = JGenerationMetrics()
    want = list(je.generate(PROMPT, JSamplingParams(temperature=0.0, max_new_tokens=48, logprobs=5), metrics=jm))
    got = list(te.generate(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=48)))
    return got, want, jm.logprobs


def agreed(got, want, entries) -> int:
    """The common prefix of two greedy streams; where they part, `got`'s
    token must be in the JAX run's top list there within TIE of its first."""
    for d, (g, w) in enumerate(zip(got, want)):
        if g != w:
            top = dict(entries[d]["top"])
            assert g in top and top[g] >= entries[d]["top"][0][1] - TIE, (d, g, w, entries[d])
            return d
    assert len(got) == len(want)
    return len(got)


# -- the drafters ------------------------------------------------------------


def test_ngram_propose_matches_jax():
    """The JAX unit test's cases, then seeded histories, in both packages."""
    hist = [1, 2, 3, 9, 8, 1, 2, 3]
    assert _ngram_propose(hist, 3, 4) == [9, 8, 1, 2]
    assert _ngram_propose(hist, 3, 1) == [9]
    assert _ngram_propose([1, 2], 3, 4) is None
    assert _ngram_propose([5, 6, 7, 8], 2, 4) is None  # no earlier match
    rng = np.random.default_rng(0)
    for _ in range(200):
        h = [int(x) for x in rng.integers(0, 4, int(rng.integers(1, 30)))]
        n, g = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        assert _ngram_propose(h, n, g) == jax_ngram_propose(h, n, g)


def test_ngram_draft_device_matches_jax():
    """The JAX test's three cases (a match, a miss, a continuation running
    past the history), then a seeded batch, against the JAX function."""
    cases = [([5, 6, 7, 8, 9, 5, 6, 7, 0, 0, 0, 0], 8, 3, [8, 9, 5], True),
             ([1, 2, 3, 4, 5, 0, 0, 0, 0, 0, 0, 0], 5, 3, [5, 5, 5], False),
             ([5, 6, 7, 5, 6, 7, 0, 0, 0, 0, 0, 0], 6, 4, [5, 6, 7, 7], True)]
    for hist, hlen, gamma, draft, found in cases:
        d, f = _ngram_draft_device(torch.tensor([hist]), torch.tensor([hlen]), 3, gamma)
        assert d[0].tolist() == draft and bool(f[0]) == found
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 5, (16, 40))
    hlen = rng.integers(1, 41, 16)
    for n, gamma in ((1, 3), (2, 4), (3, 8)):
        d, f = _ngram_draft_device(torch.from_numpy(hist), torch.from_numpy(hlen), n, gamma)
        jd, jf = jllama._ngram_draft_device(jnp.asarray(hist, jnp.int32), jnp.asarray(hlen, jnp.int32), n, gamma)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


# -- the rounds ----------------------------------------------------------------


def _prefilled(te, je, prompt):
    """Both packages' caches after the prompt, and the greedy pending token."""
    n = len(prompt)
    logits, cache = prefill_step(te.params, te.model_cfg, torch.tensor([prompt]), torch.arange(n)[None],
                                 torch.tensor([n - 1]), te.new_cache(1))
    jlogits, jcache = jllama.prefill_step(je.params, je.model_cfg, jnp.asarray([prompt], jnp.int32),
                                          jnp.arange(n, dtype=jnp.int32)[None],
                                          jnp.asarray([n - 1], jnp.int32), je.new_cache(1))
    return cache, jcache, int(logits.argmax(-1)[0]), int(jnp.argmax(jlogits, -1)[0])


def _run_rounds(te, je, prompt, eos, jeos, draft_engines=None, calls=12):
    """Drive the port's and the JAX rounds function (EOS ids `eos` and
    `jeos`) from a fresh prefill until a lane stops or 24 tokens are out;
    returns both emitted streams, their last active flags and the port's
    drafted/accepted counts."""
    cache, jcache, tok, jtok = _prefilled(te, je, prompt)
    s = te.max_seq_len
    n = len(prompt)
    hist = torch.zeros(1, s, dtype=torch.int64)
    hist[0, :n + 1] = torch.tensor(prompt + [tok])
    jhist = jnp.zeros((1, s), jnp.int32).at[0, :n + 1].set(jnp.asarray(prompt + [jtok], jnp.int32))
    state = (torch.tensor([tok]), torch.tensor([n]), cache, hist, torch.tensor([n + 1]), torch.tensor([True]))
    jstate = (jnp.asarray([jtok], jnp.int32), jnp.asarray([n], jnp.int32), jcache, jhist,
              jnp.asarray([n + 1], jnp.int32), jnp.asarray([True]))
    if draft_engines is not None:
        dt, dj = draft_engines
        _, dcache = dt.prefill(dt.new_cache(1), prompt)
        _, djcache = dj.prefill(dj.new_cache(1), prompt)
    out, jout, drafted, accepted = [], [], 0, 0
    for _ in range(calls):
        pend, pos, cache, hist, hlen, act = state
        jpend, jpos, jcache, jhist, jhlen, jact = jstate
        if draft_engines is None:
            o, c, pend, pos, cache, hist, hlen, act, dr, ac = spec_decode_rounds(
                te.params, te.model_cfg, pend, pos, cache, hist, hlen, torch.tensor(eos), act, 2, 4, 3)
            jo, jc, jpend, jpos, jcache, jhist, jhlen, jact, _, _ = jllama.spec_decode_rounds(
                je.params, je.model_cfg, jpend, jpos, jcache, jhist, jhlen, jnp.asarray(jeos, jnp.int32),
                jact, n_rounds=2, gamma=4, ngram=3)
        else:
            o, c, pend, pos, cache, dcache, act, dr, ac = draft_spec_rounds(
                te.params, te.model_cfg, dt.params, dt.model_cfg, pend, pos, cache, dcache, torch.tensor(eos),
                act, 2, 4, max_seq=s)
            jo, jc, jpend, jpos, jcache, djcache, jact, _, _ = jllama.draft_spec_rounds(
                je.params, je.model_cfg, dj.params, dj.model_cfg, jpend, jpos, jcache, djcache,
                jnp.asarray(jeos, jnp.int32), jact, n_rounds=2, gamma=4)
        out += o[0, :int(c[0])].tolist()
        jout += [int(x) for x in np.asarray(jo[0, :int(jc[0])])]
        drafted, accepted = drafted + int(dr[0]), accepted + int(ac[0])
        state = (pend, pos, cache, hist, hlen, act)
        jstate = (jpend, jpos, jcache, jhist, jhlen, jact)
        if (not bool(act[0]) and not bool(jact[0])) or min(len(out), len(jout)) >= 24:
            break
    return out, jout, bool(act[0]), bool(jact[0]), drafted, accepted


@pytest.fixture(scope="module")
def draft_engines(paths, engines):
    je, te = engines
    return (InferenceEngine(paths[1], EngineConfig(**CONFIG), device="cpu"),
            JInferenceEngine(str(paths[1]), JEngineConfig(**CONFIG)))


@pytest.mark.parametrize("drafter", ["ngram", "draft"])
def test_rounds_greedy_equal_plain_and_jax(engines, plain, draft_engines, drafter):
    """24 tokens of the rounds (2 rounds of 4 drafts a call) are plain
    greedy's, in both packages; the port's drafts are accepted."""
    je, te = engines
    got, want, entries = plain
    out, jout, _, _, drafted, accepted = _run_rounds(
        te, je, PROMPT, [-2], [-2], draft_engines if drafter == "draft" else None)
    assert out[:24] == got[:24]
    assert jout[:24] == want[:24]
    agreed(out[:24], jout[:24], entries)
    assert drafted > 0 and (accepted > 0 or drafter == "draft")


@pytest.mark.parametrize("drafter", ["ngram", "draft"])
def test_rounds_stop_before_an_eos_mid_round(engines, plain, draft_engines, drafter):
    """Declaring each package's 7th plain greedy token an EOS: its rounds
    function emits the tokens before that token's first occurrence, never
    the EOS, and deactivates the lane."""
    je, te = engines
    got, want, _ = plain
    out, jout, act, jact, _, _ = _run_rounds(te, je, PROMPT, [got[6], -2], [want[6], -2],
                                             draft_engines if drafter == "draft" else None)
    assert out == got[:got.index(got[6])] and jout == want[:want.index(want[6])]
    assert not act and not jact


# -- the engine ----------------------------------------------------------------


def _spec_engine(paths, te, speculative, **cfg):
    e = InferenceEngine(paths[0], EngineConfig(**dict(CONFIG, **cfg), speculative=speculative,
                                               draft_gguf=str(paths[1]) if speculative == "draft" else "",
                                               **SPEC), device="cpu")
    e.params = te.params
    return e


@pytest.mark.parametrize("drafter", ["ngram", "draft", "self"])
def test_engine_greedy_speculation_equals_plain_to_the_cache_end(paths, engines, drafter):
    """A 40-slot cache and a budget past it: the rounds, then the cache
    tail's plain chunks; the tokens are plain greedy's, and JAX's engine's
    (speculating the same way) up to a near-tie. "self" drafts with the
    target's own GGUF: almost every draft is accepted."""
    je, te = engines
    speculative = "ngram" if drafter == "ngram" else "draft"
    draft_gguf = {"ngram": "", "draft": str(paths[1]), "self": str(paths[0])}[drafter]
    short = dict(CONFIG, max_seq_len=40)
    e = InferenceEngine(paths[0], EngineConfig(**short, speculative=speculative, draft_gguf=draft_gguf, **SPEC),
                        device="cpu")
    e.params = te.params
    sp = SamplingParams(temperature=0.0, max_new_tokens=64)
    m = GenerationMetrics()
    got = list(e.generate(PROMPT, sp, metrics=m))
    base = InferenceEngine(paths[0], EngineConfig(**short), device="cpu")
    base.params = te.params
    pm = GenerationMetrics()
    mine = list(base.generate(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=64, logprobs=5), metrics=pm))
    agreed(got, mine, pm.logprobs)  # the verify's and the decode step's matmuls may part at a near-tie
    assert len(got) == len(mine) == 40 - len(PROMPT) + 1  # to the cache's end: the last token needs no slot
    assert m.spec_drafted > 0
    if drafter == "self":
        assert m.spec_accepted / m.spec_drafted > 0.8
    jcfg = JEngineConfig(**short, speculative=speculative, draft_gguf=draft_gguf, **SPEC)
    jm = JGenerationMetrics()
    ref = list(JInferenceEngine(str(paths[0]), JEngineConfig(**short)).generate(
        PROMPT, JSamplingParams(temperature=0.0, max_new_tokens=64, logprobs=5), metrics=jm))
    jgot = list(JInferenceEngine(str(paths[0]), jcfg).generate(PROMPT, JSamplingParams(temperature=0.0,
                                                                                        max_new_tokens=64)))
    agreed(jgot, ref, jm.logprobs)  # the JAX verify and decode step part at near-ties too
    agreed(got, ref, jm.logprobs)


@pytest.mark.parametrize("speculative", ["ngram", "draft"])
def test_engine_sampled_speculation_runs_and_reproduces(paths, engines, speculative):
    _, te = engines
    e = _spec_engine(paths, te, speculative)
    sp = SamplingParams(temperature=0.7, top_k=20, top_p=0.95, seed=11, max_new_tokens=24)
    m = GenerationMetrics()
    out = list(e.generate(PROMPT + PROMPT, sp, metrics=m))
    assert len(out) == 24 and m.spec_drafted > 0
    assert list(e.generate(PROMPT + PROMPT, sp)) == out  # the seed fixes the stream


def test_speculation_is_off_with_options_and_chat_turns_stay_in_step(paths, engines):
    """A request with logprobs decodes plainly (no drafts); two greedy
    ChatSession turns under speculation answer as a plain session does,
    whose cached ids are the tokens the cache holds."""
    _, te = engines
    e = _spec_engine(paths, te, "ngram", max_seq_len=128)
    m = GenerationMetrics()
    list(e.generate(PROMPT, SamplingParams(temperature=0.0, max_new_tokens=8, logprobs=0), metrics=m))
    assert m.spec_drafted == 0 and len(m.logprobs) == 8
    base = InferenceEngine(paths[0], EngineConfig(**dict(CONFIG, max_seq_len=128)), device="cpu")
    base.params = te.params
    sp = SamplingParams(temperature=0.0, max_new_tokens=10)
    a, b = ChatSession(e, sp), ChatSession(base, sp)
    for text in ("ab ab ab ab", "cd cd"):
        assert a.send(text) == b.send(text)
        assert a._cached_ids == b._cached_ids and len(a._cached_ids) == e._last_pos


def test_draft_vocabulary_must_match(paths, tmp_path):
    other = make_tiny_llama_gguf(tmp_path / "v256.gguf", **dict(DRAFT, vocab_size=320))
    e = InferenceEngine(paths[0], EngineConfig(**CONFIG, speculative="draft", draft_gguf=str(other)),
                        device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        list(e.generate([1, 2], SamplingParams(temperature=0.0, max_new_tokens=4)))


def test_fault_3_unknown_speculative_value(paths):
    """The JAX engine takes a misspelt value and decodes plainly; the port
    refuses it."""
    jplain = JInferenceEngine(str(paths[0]), JEngineConfig(**CONFIG))
    jtypo = JInferenceEngine(str(paths[0]), JEngineConfig(**CONFIG, speculative="ngarm"))
    jm = JGenerationMetrics()
    sp = JSamplingParams(temperature=0.0, max_new_tokens=8)
    assert list(jtypo.generate(PROMPT, sp, metrics=jm)) == list(jplain.generate(PROMPT, sp))
    assert jm.spec_drafted == 0
    with pytest.raises(ValueError, match="speculative"):
        InferenceEngine(paths[0], EngineConfig(**CONFIG, speculative="ngarm"), device="cpu")


# -- spec_verify_sample's law ------------------------------------------------------


def _plain_law(row, temp, top_k, top_p):
    """The exact distribution plain sampling draws one token from."""
    filtered, idx, _ = filtered_for_sampling(row[None].float(), temp, top_k, top_p)
    p = np.zeros(row.shape[-1])
    np.add.at(p, idx[0].numpy(), torch.softmax(filtered, -1)[0].double().numpy())
    return p


def _chi2(draws, want):
    """Chi-square goodness of fit over the tokens of nonzero probability;
    no draw may fall elsewhere. Returns the p-value."""
    got = np.bincount(draws, minlength=want.size)
    support = want > 1e-12
    assert got[~support].sum() == 0
    return scipy.stats.chisquare(got[support], want[support] / want[support].sum() * got.sum()).pvalue


N_ROWS = 40000


def test_first_token_law_equals_plain_sampling():
    """The first emitted token (the draft if accepted, else the residual
    draw) follows plain sampling's law at column 0 (temperature 0.8, top-k
    8, top-p 0.9)."""
    rng = np.random.default_rng(0)
    v, gamma = 16, 3
    logits = torch.from_numpy(rng.standard_normal((1, gamma + 1, v)) * 2.0).float()
    draft = torch.tensor([[3, 7, 1]])
    gen = torch.Generator().manual_seed(1)
    n_acc, new = spec_verify_sample(logits.expand(N_ROWS, -1, -1), draft.expand(N_ROWS, -1), gen,
                                    torch.full((N_ROWS,), 0.8), 8, torch.full((N_ROWS,), 0.9))
    first = torch.where(n_acc >= 1, draft[0, 0], new).numpy()
    assert _chi2(first, _plain_law(logits[0, 0], 0.8, 8, 0.9)) > 1e-3


def test_second_token_law_given_the_first_accepted():
    rng = np.random.default_rng(2)
    v, gamma = 12, 2
    logits = torch.from_numpy(rng.standard_normal((1, gamma + 1, v)) * 1.5).float()
    draft = torch.tensor([[5, 9]])
    gen = torch.Generator().manual_seed(3)
    n_acc, new = spec_verify_sample(logits.expand(N_ROWS, -1, -1), draft.expand(N_ROWS, -1), gen,
                                    1.0, 0, 1.0)
    second = torch.where(n_acc >= 2, draft[0, 1], new)[n_acc >= 1].numpy()
    assert second.size > 1000
    assert _chi2(second, _plain_law(logits[0, 1], 1.0, 0, 1.0)) > 1e-3


def test_full_acceptance_continues_with_a_plain_draw():
    rng = np.random.default_rng(5)
    v = 8
    logits = torch.zeros(1, 2, v)
    logits[0, 0, 2] = 50.0  # the draft has p ~ 1: always accepted
    logits[0, 1] = torch.from_numpy(rng.standard_normal(v)).float()
    gen = torch.Generator().manual_seed(6)
    n_acc, new = spec_verify_sample(logits.expand(N_ROWS, -1, -1), torch.tensor([[2]]).expand(N_ROWS, -1),
                                    gen, torch.ones(N_ROWS), 0, torch.ones(N_ROWS))
    assert bool((n_acc == 1).all())
    assert _chi2(new.numpy(), _plain_law(logits[0, 1], 1.0, 0, 1.0)) > 1e-3


def test_greedy_rows_take_the_argmax_prefix_exactly():
    """Greedy rows beside sampled ones: the argmax-prefix rule and the
    argmax continuation, whatever the draws."""
    rng = np.random.default_rng(4)
    v, gamma = 10, 3
    logits = torch.from_numpy(rng.standard_normal((5, gamma + 1, v))).float()
    am = logits.argmax(-1)
    draft = torch.stack([am[0, :gamma], (am[1, :gamma] + 1) % v,
                         torch.stack([am[2, 0], (am[2, 1] + 1) % v, am[2, 2]]),
                         torch.stack([(am[3, 0] + 1) % v, am[3, 1], am[3, 2]]), am[4, :gamma]])
    temps = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.9])  # one sampled row in the batch
    for seed in range(5):
        n_acc, new = spec_verify_sample(logits, draft, torch.Generator().manual_seed(seed), temps, 8,
                                        torch.ones(5))
        assert n_acc[:4].tolist() == [gamma, 0, 1, 0]
        assert new[:4].tolist() == [int(am[0, gamma]), int(am[1, 0]), int(am[2, 1]), int(am[3, 0])]


# -- the BatchEngine ---------------------------------------------------------------


def drive(be, reqs, max_steps=400):
    for _ in range(max_steps):
        if be.step() == 0 and be.queue.empty() and all(r.state != RequestState.QUEUED for r in reqs):
            break
    return [r.output_ids for r in reqs]


BATCH_PROMPTS = [PROMPT, [9, 9, 2, 9, 9, 2, 9, 9], [7, 1, 7, 1, 7, 1, 7]]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batch_engine_speculates_mixed_greedy_and_sampled_slots(paths, engines, paged):
    """Two greedy slots and a sampled one speculate together: the greedy
    slots' tokens are the plain BatchEngine's exactly and the JAX
    speculative BatchEngine's up to a near-tie (by the JAX plain run's
    logprobs); the sampled slot fills its budget; the counters move."""
    je, te = engines
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=16), SamplingParams(temperature=0.0, max_new_tokens=16),
                SamplingParams(temperature=0.8, top_k=20, max_new_tokens=16)]
    outs = {}
    for spec in ("off", "ngram"):
        e = _spec_engine(paths, te, spec, paged_kv=paged)
        be = BatchEngine(e, max_batch=4)
        reqs = [be.submit(p, s) for p, s in zip(BATCH_PROMPTS, sampling)]
        outs[spec] = drive(be, reqs)
        assert all(r.state == RequestState.FINISHED for r in reqs)
        assert (be.spec_drafted > 0 and be.spec_accepted > 0) == (spec == "ngram")
    assert outs["ngram"][:2] == outs["off"][:2] and len(outs["ngram"][2]) == 16
    jouts = {}
    for spec in ("off", "ngram"):
        jbe = JBatchEngine(JInferenceEngine(str(paths[0]), JEngineConfig(**CONFIG, speculative=spec,
                                                                          paged_kv=paged, **SPEC)), max_batch=4)
        jreqs = [jbe.submit(p, JSamplingParams(temperature=0.0, max_new_tokens=16,
                                               logprobs=5 if spec == "off" else None))
                 for p in BATCH_PROMPTS[:2]]
        jouts[spec] = (drive(jbe, jreqs), [r.logprob_data for r in jreqs])
    assert jouts["ngram"][0] == jouts["off"][0]
    for got, want, entries in zip(outs["ngram"][:2], jouts["ngram"][0], jouts["off"][1]):
        agreed(got, want, entries)


# -- reference fault 1 ------------------------------------------------------------------


def _watch(module, name, monkeypatch, read):
    """Wrap module.name (a rounds function, called with the cache as its
    fifth argument and returning it fifth) so that `read(cache)` sees the
    cache before and after each call: returns the list of (before, after)."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        before = read(args[4])
        out = real(*args, **kw)
        seen.append((before, read(out[4])))
        return out

    monkeypatch.setattr(module, name, spy)
    return seen


LONG = [int(x) for x in np.random.default_rng(7).integers(10, 200, 72)]  # 3 prefill chunks of 32


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fault_1_frozen_lanes_write_no_kv(paths, engines, monkeypatch, paged):
    """A decoding request speculates while a second one is mid-prefill.
    Dense: the JAX BatchEngine's spec step rewrites row 0 of the prefilling
    lane (its frozen position); the port's leaves the lane's prompt rows as
    they were. Paged: the prefilling request shares the first request's
    prompt pages (prefix sharing); the JAX step's frozen lane writes row 0
    of that shared page through the prefilling slot's table, the port's
    writes no page but the pages its rows own. The port's second request
    then answers as it does alone."""
    je, te = engines
    first = LONG[:32]  # one chunk, two pages: published as a prefix when its prefill ends
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)

    def run(jax_side):
        if jax_side:
            eng = JInferenceEngine(str(paths[0]), JEngineConfig(**CONFIG, speculative="ngram", paged_kv=paged, **SPEC))
            be = JBatchEngine(eng, max_batch=2)
            params, module = JSamplingParams(temperature=0.0, max_new_tokens=16), jllama
        else:
            be = BatchEngine(_spec_engine(paths, te, "ngram", paged_kv=paged), max_batch=2)
            params, module = sp, scheduler

        def rows(cache):
            lane = next((i for i, s in enumerate(be.slots) if s.prefilling), None)
            if lane is None:
                return None
            if paged:  # the prefilling slot's first page: shared with the decoding request
                return np.array(cache.k[:, :, be.slots[lane].pages[0]], np.float32)
            return np.array(cache.k[:, lane, :be.slots[lane].prefill_next], np.float32)

        seen = _watch(module, "spec_decode_rounds", monkeypatch, rows)
        r1 = be.submit(first, params)
        be.step()  # r1 prefilled: its prompt pages are published
        r2 = be.submit(LONG, params)
        drive(be, [r1, r2])
        monkeypatch.undo()
        pairs = [(b, a) for b, a in seen if b is not None]
        assert pairs, "no speculative step ran while a request was mid-prefill"
        return pairs, r2.output_ids

    jpairs, _ = run(True)
    assert any(not np.array_equal(b, a) for b, a in jpairs)  # the JAX frozen lane wrote rows
    pairs, out = run(False)
    for b, a in pairs:
        np.testing.assert_array_equal(a, b)
    solo = BatchEngine(_spec_engine(paths, te, "ngram", paged_kv=paged), max_batch=2)
    assert drive(solo, [solo.submit(LONG, sp)])[0] == out
