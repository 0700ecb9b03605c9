"""Constrained decoding in the port (grammar.py and constrained.py copies,
the engine's constrained path, the BatchEngine's per-slot masks) against the
JAX package on the CPU.

- The copies: along seeded token walks over one vocabulary, the port's
  `TokenConstraint.allowed` / `closing_allowed` masks, `closing_string` and
  `complete` equal the JAX modules' exactly, for JSON mode, a JSON Schema, a
  GBNF grammar and a regex; `constraint_for` reads the same token bytes and
  EOS ids from the two packages' tokenizers of the tiny GGUF.
- The engine: greedy constrained tokens equal the JAX engine's (budgets
  short enough that the closing masks run), and the text satisfies the
  constraint.
- The BatchEngine: greedy tokens of a batch mixing constrained and plain
  requests equal the JAX BatchEngine's, dense and paged; a constrained
  request preempted on a starved pool resumes with the same tokens.
- Reference fault 2: the JAX engine's constrained path drops the logit bias
  and the penalties (its output does not move); the port applies them, and
  its engine and BatchEngine agree.

The fixture is the scheduler tests' tiny Q4_K llama (f32 activations),
whose logits are flat (top-two logprob gaps of 0.004 occur in these
streams) and agree with JAX's within 2e-2 of their scale of 3: greedy
streams of the two packages are held equal up to a near-tie, where they
part, the port's token must lie within TIE = 0.06 of the top of JAX's own
logprobs at that step (test_torch_sampling_ext.py's rule). Streams of the
port alone (engine, BatchEngine, preempted or not) are held equal.
"""
import json
import re

import numpy as np
import pytest
import torch

from nfai_tpu import constrained as jcons
from nfai_tpu import grammar as jgram
from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.runtime.engine import GenerationMetrics as JGenerationMetrics
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.scheduler import BatchEngine as JBatchEngine
from nfai_tpu_torch import constrained as cons
from nfai_tpu_torch import grammar as gram
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            quant=GGMLType.Q4_K, tied=False, context_length=128)
CONFIG = dict(max_seq_len=96, dtype="float32", prefill_chunk=32, page_size=16)
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"},
                                           "tag": {"enum": ["a", "bc"]}},
          "required": ["ok", "n"]}
GBNF = 'root ::= "val=" [0-9]{1,3} ("," [a-z]+)* ";"'
REGEX = r"(ab|cd)+-[0-9]{2}x?"
TIE = 0.06
# each constraint as SamplingParams fields, and the check its text must pass
MODES = {
    "json": (dict(response_format="json"), lambda t: isinstance(json.loads(t), dict)),
    "schema": (dict(response_format="json_schema", json_schema=SCHEMA),
               lambda t: {"ok", "n"} <= set(json.loads(t))),
    "gbnf": (dict(grammar=GBNF), lambda t: re.fullmatch(r"val=[0-9]{1,3}(,[a-z]+)*;", t)),
    "regex": (dict(regex=REGEX), lambda t: re.fullmatch(REGEX, t)),
}


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
def gguf_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("cons") / "tiny_q4k.gguf", **TINY)


@pytest.fixture(scope="module")
def engines(gguf_path):
    je = JInferenceEngine(str(gguf_path), JEngineConfig(**CONFIG))
    te = InferenceEngine(gguf_path, EngineConfig(**CONFIG), device="cpu")
    return je, te


def _walk_vocab():
    """A vocabulary of single bytes, seeded multi-byte pieces over a JSON /
    grammar alphabet, two UTF-8 pieces, an empty (special) entry and EOS."""
    rng = np.random.default_rng(0)
    pieces = [bytes([b]) for b in range(32, 127)] + [b"\n", b"\t"]
    alphabet = np.frombuffer(b'{}[]":, 0123456789abcdexyz-.=;truefalsn', np.uint8)
    pieces += [bytes(rng.choice(alphabet, int(rng.integers(2, 6)))) for _ in range(300)]
    pieces += ["é".encode(), "日本".encode(), b"", b"<eos>"]
    return pieces, {len(pieces) - 1}


def _machines(mode):
    fields = MODES[mode][0]
    if mode == "json":
        return cons.JsonMachine(require_object=True), jcons.JsonMachine(require_object=True)
    return gram.machine_for(SamplingParams(**fields)), jgram.machine_for(JSamplingParams(**fields))


@pytest.mark.parametrize("mode", list(MODES))
def test_copies_give_the_jax_masks_along_token_walks(mode):
    """Masks, closing masks, closing strings and completion equal the JAX
    modules' at every step of a seeded walk (random allowed tokens, then
    closing tokens from step 24 on, until the structure is complete)."""
    pieces, eos = _walk_vocab()
    pc, jc = cons.TokenConstraint(pieces, eos), jcons.TokenConstraint(pieces, eos)
    pm, jm = _machines(mode)
    rng = np.random.default_rng(1)
    text = b""
    for step in range(60):
        assert pm.closing_string() == jm.closing_string() and pm.complete == jm.complete
        if pm.complete:  # the engines stop here: no mask is asked of a finished machine
            break
        allowed, closing = pc.allowed(pm), pc.closing_allowed(pm)
        np.testing.assert_array_equal(allowed, jc.allowed(jm))
        np.testing.assert_array_equal(closing, jc.closing_allowed(jm))
        mask = closing if step >= 24 else allowed
        tok = int(rng.choice(np.flatnonzero(mask)))
        assert pm.advance_bytes(pieces[tok]) and jm.advance_bytes(pieces[tok])
        text += pieces[tok]
    assert pm.complete, (mode, text)
    assert MODES[mode][1](text.decode()), (mode, text)


def test_grammar_matching_the_empty_string_masks_where_the_jax_copy_raises(engines):
    """A regex that matches "" leaves the machine finished before its first
    token: the JAX copy raises IndexError at the first UTF-8 lead byte of
    the vocabulary (the tiny byte-level vocab has 128 of them); the port's
    masks, and a request through its engine, run."""
    je, te = engines
    fields = dict(regex="[a-z]*")
    jm, pm = jgram.machine_for(JSamplingParams(**fields)), gram.machine_for(SamplingParams(**fields))
    assert jm.complete and pm.complete
    with pytest.raises(IndexError):
        jcons.constraint_for(je.tokenizer).allowed(jm)
    allowed = te.json_constraint.allowed(pm)
    assert allowed[ord("a")] and not allowed[ord("A")] and not allowed[0xC3]
    text = te.generate_text("x", SamplingParams(temperature=0.0, max_new_tokens=8, **fields))
    assert re.fullmatch("[a-z]*", text), text


def test_constraint_for_reads_the_same_vocabulary(engines):
    je, te = engines
    pc, jc = cons.constraint_for(te.tokenizer), jcons.constraint_for(je.tokenizer)
    assert pc.token_bytes == jc.token_bytes and pc.eos_ids == jc.eos_ids
    assert te.json_constraint is te.json_constraint  # built once per engine


def agreed(got, want, entries) -> int:
    """The common prefix of two greedy streams; where they part, `got`'s
    token must be in the JAX run's top list there (logprob `entries`,
    which describe the masked distribution) within TIE of its first."""
    for d, (g, w) in enumerate(zip(got, want)):
        if g != w:
            top = dict(entries[d]["top"])
            assert g in top and top[g] >= entries[d]["top"][0][1] - TIE, (d, g, w, entries[d])
            return d
    assert len(got) == len(want)
    return len(got)


@pytest.mark.parametrize("mode,budget", [("json", 14), ("schema", 40), ("gbnf", 12), ("regex", 10)])
def test_engine_greedy_constrained_tokens_equal_jax(engines, mode, budget):
    """The budgets are short: the closing masks decide the last tokens."""
    je, te = engines
    fields = MODES[mode][0]
    ids = te.tokenizer.encode("Answer in the format asked for.")
    jm = JGenerationMetrics()
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=budget, logprobs=5, **fields),
                            metrics=jm))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=budget, **fields)))
    agreed(got, want, jm.logprobs)
    assert MODES[mode][1](te.tokenizer.decode(got)), te.tokenizer.decode(got)


def test_sampled_constrained_outputs_satisfy_their_constraints(engines):
    _, te = engines
    for seed, (mode, (fields, ok)) in enumerate(MODES.items()):
        text = te.generate_text("x", SamplingParams(temperature=0.9, seed=seed, max_new_tokens=40, **fields))
        assert ok(text), (mode, text)


def drive(be, reqs, max_steps=400):
    for _ in range(max_steps):
        if be.step() == 0 and be.queue.empty() and all(r.state != RequestState.QUEUED for r in reqs):
            break
    return [r.output_ids for r in reqs]


MIXED = [("json", 24), (None, 12), ("regex", 10), ("gbnf", 12)]


def _mixed(params_cls, **extra):
    return [params_cls(temperature=0.0, max_new_tokens=n, **extra, **(MODES[m][0] if m else {}))
            for m, n in MIXED]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batch_engine_mixed_constrained_and_plain_equal_jax(engines, paged):
    """Four slots, three constrained: one-step chunks with per-row masks.
    Each slot's tokens equal the JAX BatchEngine's up to a near-tie, and
    the port's engine's for the same request exactly."""
    je, te = engines
    prompts = [[int(x) for x in np.random.default_rng(s).integers(5, 200, n)]
               for s, n in zip(range(4), (9, 13, 20, 6))]
    jbe = JBatchEngine(je, max_batch=4, decode_chunk=4, paged=paged)
    jreqs = [jbe.submit(p, s) for p, s in zip(prompts, _mixed(JSamplingParams, logprobs=5))]
    drive(jbe, jreqs)
    be = BatchEngine(te, max_batch=4, decode_chunk=4, paged=paged)
    reqs = [be.submit(p, s) for p, s in zip(prompts, _mixed(SamplingParams))]
    drive(be, reqs)
    for p, s, r, jr in zip(prompts, _mixed(SamplingParams), reqs, jreqs):
        agreed(r.output_ids, jr.output_ids, jr.logprob_data)
        assert r.output_ids == list(te.generate(p, s))
    for (m, _), r in zip(MIXED, reqs):
        assert r.state == RequestState.FINISHED
        if m:
            assert MODES[m][1](te.tokenizer.decode(r.output_ids)), (m, r.output_ids)


def test_preempted_constrained_request_resumes_unchanged(engines):
    """A starved pool preempts a constrained request; its automaton is
    rebuilt from the tokens it emitted, so the tokens are the roomy run's,
    and the JAX BatchEngine's up to a near-tie."""
    je, te = engines
    rng = np.random.default_rng(10)
    p1, p2 = ([int(x) for x in rng.integers(5, 200, 30)] for _ in range(2))
    fields = MODES["schema"][0]  # both outputs outgrow their 2 pages
    jbe = JBatchEngine(je, max_batch=2, decode_chunk=4, paged=True)
    jreqs = [jbe.submit(p, JSamplingParams(temperature=0.0, max_new_tokens=40, logprobs=5, **fields))
             for p in (p1, p2)]
    drive(jbe, jreqs)
    s = SamplingParams(temperature=0.0, max_new_tokens=40, **fields)
    roomy = BatchEngine(te, max_batch=2, decode_chunk=4, paged=True)
    want = drive(roomy, [roomy.submit(p, s) for p in (p1, p2)])
    be = BatchEngine(te, max_batch=2, decode_chunk=4, paged=True, pool_tokens=6 * 16)  # 5 pages a request
    reqs = [be.submit(p, s) for p in (p1, p2)]
    got = drive(be, reqs)
    assert be.preemptions >= 1
    assert got == want and all(r.state == RequestState.FINISHED for r in reqs)
    for g, jr in zip(got, jreqs):
        agreed(g, jr.output_ids, jr.logprob_data)
        assert MODES["schema"][1](te.tokenizer.decode(g))


@pytest.mark.parametrize("option", [dict(logit_bias=((32, 100.0),)), dict(frequency_penalty=3.0)],
                         ids=["logit_bias", "frequency_penalty"])
def test_fault_2_jax_engine_drops_bias_and_penalties_port_applies_them(engines, option):
    """JSON mode with a +100 bias on the space byte (id 32), or a frequency
    penalty of 3: the JAX engine's constrained tokens are those without the
    option (reference fault 2); the port's engine changes them (the bias:
    a space wherever one is legal) and equals the port's BatchEngine, which
    applies the option as the JAX BatchEngine does."""
    je, te = engines
    ids = te.tokenizer.encode("Write JSON.")
    base = dict(temperature=0.0, max_new_tokens=16, response_format="json")
    j_plain = list(je.generate(ids, JSamplingParams(**base)))
    j_opt = list(je.generate(ids, JSamplingParams(**base, **option)))
    assert j_opt == j_plain  # the JAX engine ignores the option
    t_plain = list(te.generate(ids, SamplingParams(**base)))
    t_opt = list(te.generate(ids, SamplingParams(**base, **option)))
    assert t_plain == j_plain and t_opt != t_plain
    if "logit_bias" in option:
        assert t_opt[1] == 32
    for paged in (False, True):
        be = BatchEngine(te, max_batch=2, decode_chunk=4, paged=paged)
        req = be.submit(ids, SamplingParams(**base, **option))
        assert drive(be, [req])[0] == t_opt
    assert isinstance(json.loads(te.tokenizer.decode(t_opt)), dict)


def test_constrained_chat_turns_keep_the_cache_in_step(gguf_path):
    """A ChatSession turn in JSON mode, then a plain one: the session's
    cached ids are the tokens whose K/V the cache holds, so the second turn
    prefills only the new suffix and answers as a fresh session does (the
    byte-level chat needs a longer cache than the other cases)."""
    from nfai_tpu_torch.runtime.engine import ChatSession

    te = InferenceEngine(gguf_path, EngineConfig(**dict(CONFIG, max_seq_len=128)), device="cpu")
    json_s = SamplingParams(temperature=0.0, max_new_tokens=12, response_format="json")
    plain = SamplingParams(temperature=0.0, max_new_tokens=6)
    s = ChatSession(te, json_s)
    first = s.send("Give me JSON.")
    assert isinstance(json.loads(first), dict)
    n_cached = len(s._cached_ids)
    assert n_cached == te._last_pos
    s.sampling = plain
    second = s.send("Thanks.")
    fresh = ChatSession(te, plain, messages=list(s.messages[:-1]))
    fresh.messages.pop()  # ask the same question from scratch
    assert fresh.send("Thanks.") == second
