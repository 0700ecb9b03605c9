"""The port's continuous-batching scheduler (BatchEngine), dense and paged,
on the CPU: the cases of the JAX package's scheduler tests (admission,
isolation, lockstep decode with mixed sampling, EOS/budget/cache-room ends,
stream order, prefix sharing, small pools, preemption, cancellation,
prefill overlapping decode), and equal greedy output_ids per request to the
JAX package's BatchEngine on the same GGUF and settings.

The fixture is a tiny Q4_K llama (hidden 256, 2 layers, 4/2 heads, ffn
512) in float32; both packages use 16-token pages. Greedy outputs are
compared for equality (the two packages' logits agree within 2e-2, see
test_torch_engine.py, and these prompts have no near-tie).
"""
import numpy as np
import pytest
import torch

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.scheduler import BatchEngine as JBatchEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.runtime import scheduler
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.scheduler import BatchEngine, QueueFull, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            quant=GGMLType.Q4_K, tied=False, context_length=128)
CONFIG = dict(max_seq_len=96, dtype="float32", prefill_chunk=32, page_size=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores (the module
    ran 20x slower under 6 workers); restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("sched") / "tiny_q4k.gguf", **TINY)


@pytest.fixture(scope="module")
def engine(gguf_path):
    return InferenceEngine(gguf_path, EngineConfig(**CONFIG), device="cpu")


@pytest.fixture(params=[False, True], ids=["dense", "paged"])
def paged(request):
    return request.param


def drive(be, reqs, max_steps=300):
    for _ in range(max_steps):
        if be.step() == 0 and all(r.state != RequestState.QUEUED for r in reqs):
            if be.queue.empty():
                break
    return [r.output_ids for r in reqs]


def prompts_of(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(5, 200, n)] for n in lengths]


def small_pool(engine, n_pages, **kw):
    """A paged BatchEngine whose pool holds n_pages 16-token pages (the sink
    page included)."""
    return BatchEngine(engine, paged=True, pool_tokens=(n_pages - 1) * 16, **kw)


# -- against the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_outputs(gguf_path):
    """The JAX BatchEngine's greedy output_ids, dense and paged, for 5
    prompts (one of three prefill chunks) on 4 slots."""
    je = JInferenceEngine(str(gguf_path), JEngineConfig(**CONFIG))
    out = {}
    for paged_ in (False, True):
        be = JBatchEngine(je, max_batch=4, decode_chunk=4, paged=paged_)
        reqs = [be.submit(p, JSamplingParams(temperature=0.0, max_new_tokens=10))
                for p in prompts_of(1, (6, 11, 17, 9, 70))]
        out[paged_] = drive(be, reqs)
    return out


def test_greedy_outputs_equal_the_jax_batch_engine(engine, paged, jax_outputs):
    """Every request's greedy output equals the JAX BatchEngine's, except in
    dense mode the 70-token prompt: the JAX dense scheduler decodes its
    half-prefilled lane as an inactive row at position 0 and so overwrites
    the prompt's first K/V row (a reference fault, ROADMAP §3); the port
    freezes that lane at the next position its prefill writes, and its
    output equals the single-request run, as the JAX paged mode's does."""
    prompts = prompts_of(1, (6, 11, 17, 9, 70))
    s = SamplingParams(temperature=0.0, max_new_tokens=10)
    be = BatchEngine(engine, max_batch=4, decode_chunk=4, paged=paged)
    reqs = [be.submit(p, s) for p in prompts]
    got = drive(be, reqs)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert all(len(o) == 10 for o in got)
    want = jax_outputs[paged]
    if paged:
        assert got == want
    else:
        assert got[:4] == want[:4]
        assert got[4] == list(engine.generate(prompts[4], s)) == jax_outputs[True][4]


# -- the JAX package's scheduler cases ----------------------------------------


def test_single_request_matches_engine_generate(engine, paged):
    ids = prompts_of(0, (9,))[0]
    s = SamplingParams(temperature=0.0, max_new_tokens=10)
    expected = list(engine.generate(ids, s))
    be = BatchEngine(engine, max_batch=4, decode_chunk=4, paged=paged)
    req = be.submit(ids, s)
    drive(be, [req])
    assert req.state == RequestState.FINISHED
    assert req.output_ids == expected


def test_concurrent_requests_isolated(engine, paged):
    prompts = prompts_of(1, (6, 11, 17, 9))
    s = SamplingParams(temperature=0.0, max_new_tokens=8)
    expected = [list(engine.generate(p, s)) for p in prompts]
    be = BatchEngine(engine, max_batch=4, decode_chunk=4, paged=paged)
    reqs = [be.submit(p, s) for p in prompts]
    drive(be, reqs)
    for r, exp in zip(reqs, expected):
        assert r.state == RequestState.FINISHED
        assert r.output_ids == exp, f"request {r.id} diverged under batching"


def test_more_requests_than_slots(engine, paged):
    prompts = prompts_of(2, (7,) * 6)
    s = SamplingParams(temperature=0.0, max_new_tokens=5)
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=paged)
    reqs = [be.submit(p, s) for p in prompts]
    drive(be, reqs)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert all(0 < len(r.output_ids) <= 5 for r in reqs)


def test_mixed_sampling_params(engine, paged):
    """A greedy and a hot request with different top_k in one batch: the
    greedy one is unchanged by its neighbour's sampling."""
    p = prompts_of(3, (8,))[0]
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=paged)
    r_greedy = be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=6))
    r_hot = be.submit(p, SamplingParams(temperature=1.5, top_k=3, max_new_tokens=6, seed=1))
    drive(be, [r_greedy, r_hot])
    assert r_greedy.output_ids == list(
        engine.generate(p, SamplingParams(temperature=0.0, max_new_tokens=6)))
    assert r_hot.state == RequestState.FINISHED and len(r_hot.output_ids) == 6


def test_cache_room_termination(engine, paged):
    # prompt 80 in a 96-slot cache: at most ~16 tokens before the room ends
    p = prompts_of(4, (80,))[0]
    be = BatchEngine(engine, max_batch=2, decode_chunk=8, paged=paged)
    r = be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=500))
    drive(be, [r])
    assert r.state == RequestState.FINISHED
    assert len(r.output_ids) <= 17


def test_prompt_too_long_rejected(engine, paged):
    be = BatchEngine(engine, max_batch=2, paged=paged)
    with pytest.raises(ValueError, match="exceeds"):
        be.submit(list(range(200)))


def test_stream_iterator(engine, paged):
    p = prompts_of(5, (6,))[0]
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=paged)
    be.start()
    try:
        r = be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=6))
        streamed = list(r.stream(timeout=120))
    finally:
        be.close()
    assert streamed == r.output_ids
    assert r.ttft_s is not None and r.ttft_s > 0


def test_cancellation_frees_slot_and_pages(engine, paged):
    p = prompts_of(10, (8,))[0]
    be = BatchEngine(engine, max_batch=2, decode_chunk=2, paged=paged)
    r = be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=500))
    be.step()
    assert r.state == RequestState.RUNNING
    n_before = len(r.output_ids)
    r.cancel()
    be.step()
    assert r.state == RequestState.CANCELLED
    assert list(r.stream(timeout=5))[:n_before] == r.output_ids[:n_before]
    assert all(s.request is None for s in be.slots)
    if paged:  # every page but the sink is unreferenced (published ones stay cached)
        assert (be.alloc.refs[1:] == 0).all() and be.alloc.refs[0] == 1


def test_cancelled_in_queue_never_runs(engine, paged):
    p = prompts_of(11, (8,))[0]
    be = BatchEngine(engine, max_batch=1, decode_chunk=2, paged=paged)
    r1 = be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=4))
    r2 = be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=4))
    r2.cancel()
    drive(be, [r1, r2])
    assert r1.state == RequestState.FINISHED
    assert r2.state == RequestState.CANCELLED and r2.output_ids == []


def test_prefill_overlaps_decode(engine, paged):
    """A long-prompt arrival must not stall a running slot, and the running
    slot's lockstep decode must not touch the arrival's half-prefilled
    cache: both outputs equal their single-request runs."""
    short, long_p = prompts_of(12, (4, 90))  # the long prompt is 3 chunks of 32
    s1 = SamplingParams(temperature=0.0, max_new_tokens=40)
    s2 = SamplingParams(temperature=0.0, max_new_tokens=4)
    be = BatchEngine(engine, max_batch=2, decode_chunk=2, paged=paged)
    r1 = be.submit(short, s1)
    be.step()  # admits r1, its prefill, its first chunk
    be.step()
    assert r1.state == RequestState.RUNNING and len(r1.output_ids) >= 1
    produced = len(r1.output_ids)
    r2 = be.submit(long_p, s2)
    be.step()  # r2 prefills ONE chunk, r1 still decodes
    assert be.slots[1].prefilling or be.slots[0].prefilling
    assert len(r1.output_ids) > produced, "running slot stalled during prefill"
    drive(be, [r1, r2])
    assert r1.state == RequestState.FINISHED and r2.state == RequestState.FINISHED
    assert r2.output_ids == list(engine.generate(long_p, s2))
    if paged:  # dense lanes run at M = 2, where the CPU's matmul sums in another
        # order than generate's M = 1 and flips a near-tie 38 tokens in
        assert r1.output_ids == list(engine.generate(short, s1))


def test_unported_sampling_options_raise_at_submit(engine, paged):
    """A bias id outside the vocabulary, or a grammar, regex or schema that
    does not compile, is a ValueError at submit naming the field (nothing
    is queued; the server answers it with a 400); what now runs is held to the JAX BatchEngine in the parity cases below and in
    test_torch_constrained.py / test_torch_spec.py."""
    be = BatchEngine(engine, max_batch=2, paged=paged)
    with pytest.raises(ValueError, match="outside the vocabulary"):
        be.submit([1, 2, 3], SamplingParams(logit_bias=((engine.model_cfg.vocab_size, 1.0),)))
    for bad in (dict(grammar='root ::= "unterminated'), dict(regex="(a"), dict(json_schema={"type": "nope"})):
        with pytest.raises(ValueError, match=f"^{next(iter(bad))}: "):
            be.submit([1, 2, 3], SamplingParams(**bad))
    assert be.queue.empty()


def test_constrained_requests_run_through_submit(engine, paged):
    """JSON mode, a regex and a GBNF grammar beside a plain request: every
    constrained output satisfies its constraint."""
    import json
    import re

    be = BatchEngine(engine, max_batch=4, paged=paged)
    checks = [(dict(response_format="json"), lambda t: isinstance(json.loads(t), dict)),
              (dict(regex="a+"), lambda t: re.fullmatch("a+", t)),
              (dict(grammar='root ::= "a"'), lambda t: t == "a"), ({}, lambda t: True)]
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=20, **fields))
            for p, (fields, _) in zip(prompts_of(3, (5, 9, 12, 7)), checks)]
    drive(be, reqs)
    for r, (fields, ok) in zip(reqs, checks):
        assert r.state == RequestState.FINISHED and ok(engine.tokenizer.decode(r.output_ids)), (fields, r.output_ids)


@pytest.fixture(scope="module")
def jax_engine(gguf_path):
    return JInferenceEngine(str(gguf_path), JEngineConfig(**CONFIG))


@pytest.mark.parametrize("opt", [dict(logprobs=2), dict(presence_penalty=0.5), dict(frequency_penalty=0.5),
                                 dict(logit_bias=((3, 1.0),))],
                         ids=["logprobs", "presence_penalty", "frequency_penalty", "logit_bias"])
def test_sampling_options_run_as_in_the_jax_batch_engine(engine, jax_engine, paged, opt):
    """The options the port now runs, one request beside a plain one on 2
    slots: greedy output_ids equal the JAX BatchEngine's up to a near-tie
    (where they part, the port's token lies within 0.06, 2e-2 of the
    fixture's logit scale of 3, of JAX's top logprob, which the JAX run
    reports for every request), logprobs within 0.12 (twice that)."""
    p, q = prompts_of(2, (9, 13))
    s = dict(temperature=0.0, max_new_tokens=10)
    jbe = JBatchEngine(jax_engine, max_batch=2, decode_chunk=4, paged=paged)
    jr = [jbe.submit(x, JSamplingParams(**s, **{**opt, "logprobs": max(2, opt.get("logprobs", 0))}))
          for x in (p, q)]
    drive(jbe, jr)
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=paged)
    r = [be.submit(p, SamplingParams(**s, **opt)), be.submit(q, SamplingParams(**s))]
    drive(be, r)
    for got, want in zip(r, jr):
        assert got.state == RequestState.FINISHED and len(got.output_ids) == 10
        for d, (g, w) in enumerate(zip(got.output_ids, want.output_ids)):
            if g != w:
                top = dict(want.logprob_data[d]["top"])
                assert g in top and top[g] >= want.logprob_data[d]["top"][0][1] - 0.06
                break
    if "logprobs" in opt:
        assert [e["id"] for e in r[0].logprob_data] == r[0].output_ids and r[1].logprob_data == []
        for g, w in zip(r[0].logprob_data, jr[0].logprob_data):
            if g["id"] != w["id"]:
                break
            assert abs(g["logprob"] - w["logprob"]) <= 0.12


def test_counts_follow_the_slots(engine, paged):
    """The penalties' counts hold each slot's output tokens, including the
    first (sampled at the end of the prefill), and a slot's row starts
    from zero for its next request."""
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=paged)
    s = SamplingParams(temperature=0.0, max_new_tokens=30, frequency_penalty=0.5)
    reqs = [be.submit(p, s) for p in prompts_of(3, (7, 12))]
    for _ in range(2):
        be.step()
    assert all(slot.request is not None for slot in be.slots)
    for i, slot in enumerate(be.slots):
        req = slot.request
        want = np.bincount(req.output_ids, minlength=engine.model_cfg.vocab_size)
        assert be._counts[i].tolist() == want.tolist()
    drive(be, reqs)
    r3 = be.submit(prompts_of(4, (5,))[0], s)
    be.step()
    slot = next(i for i, sl in enumerate(be.slots) if sl.request is r3)
    assert be._counts[slot].tolist() == np.bincount(r3.output_ids,
                                                    minlength=engine.model_cfg.vocab_size).tolist()


def test_queue_full_is_refused(engine, paged):
    be = BatchEngine(engine, max_batch=1, paged=paged, queue_cap=1)
    be.submit([1, 2, 3])
    with pytest.raises(QueueFull):
        be.submit([1, 2, 3])


# -- paged-only behaviour -------------------------------------------------------


def test_prefix_sharing_skips_prefill(engine):
    """Two requests with the same long prompt: the second adopts the first's
    KV pages (an allocator hit) and generates the same output."""
    p = prompts_of(7, (40,))[0]  # more than 2 pages of 16
    s = SamplingParams(temperature=0.0, max_new_tokens=6)
    be = small_pool(engine, 2 * 6 + 1, max_batch=2, decode_chunk=4)
    r1 = be.submit(p, s)
    drive(be, [r1])
    assert be.alloc.hits == 0
    r2 = be.submit(p, s)
    drive(be, [r2])
    assert be.alloc.hits == 1, "the second identical prompt must hit the prefix cache"
    assert r1.output_ids == r2.output_ids


def test_small_pool_serves_more_than_dense_capacity(engine):
    """A pool holding fewer tokens than max_batch x max_seq still serves
    concurrent short requests: paging allocates what is used."""
    prompts = prompts_of(8, (7,) * 4)
    s = SamplingParams(temperature=0.0, max_new_tokens=5)
    be = small_pool(engine, 9, max_batch=4, decode_chunk=4)  # 8 x 16 tokens, dense 4 x 96
    assert be.cache.k.numel() < engine.new_cache(4).k.numel()
    expected = [list(engine.generate(p, s)) for p in prompts]
    reqs = [be.submit(p, s) for p in prompts]
    drive(be, reqs)
    for r, exp in zip(reqs, expected):
        assert r.state == RequestState.FINISHED and r.output_ids == exp


def test_preemption_recovers_and_output_is_unchanged(engine):
    """A starved pool: a request is preempted for capacity, re-prefilled,
    and its streamed output still equals the unconstrained greedy run."""
    p1, p2 = prompts_of(10, (20, 20))  # neither ends at EOS before 24 tokens
    s = SamplingParams(temperature=0.0, max_new_tokens=24)
    expected = [list(engine.generate(p, s)) for p in (p1, p2)]
    be = small_pool(engine, 5, max_batch=2, decode_chunk=4)
    r1, r2 = be.submit(p1, s), be.submit(p2, s)
    drive(be, [r1, r2], max_steps=400)
    assert be.preemptions >= 1
    assert [r1.state, r2.state] == [RequestState.FINISHED] * 2
    assert [r1.output_ids, r2.output_ids] == expected
    assert (be.alloc.refs[1:] == 0).all()  # every page came back


def test_preempted_penalties_and_logprobs_resume_unchanged(engine):
    """A starved pool preempts a request with penalties and logprobs: on
    re-admission its counts are rebuilt from the tokens it already emitted
    (the JAX scheduler restarts them from zero), so its output and
    logprobs equal the unconstrained run's."""
    p1, p2 = prompts_of(10, (20, 20))
    s = SamplingParams(temperature=0.0, max_new_tokens=24, frequency_penalty=0.8,
                       presence_penalty=0.4, logprobs=2)
    roomy = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=True)
    want = [roomy.submit(p1, s), roomy.submit(p2, s)]
    drive(roomy, want)
    be = small_pool(engine, 5, max_batch=2, decode_chunk=4)
    got = [be.submit(p1, s), be.submit(p2, s)]
    drive(be, got, max_steps=400)
    assert be.preemptions >= 1
    for g, w in zip(got, want):
        assert g.state == RequestState.FINISHED and g.output_ids == w.output_ids
        assert [e["id"] for e in g.logprob_data] == g.output_ids
        np.testing.assert_allclose([e["logprob"] for e in g.logprob_data],
                                   [e["logprob"] for e in w.logprob_data], rtol=0, atol=2e-2)


def test_lane_compaction_runs_the_smallest_power_of_two(engine, monkeypatch):
    widths = []
    real = scheduler.paged_decode_loop

    def spy(params, cfg, tokens, *args, **kw):
        widths.append(tokens.shape[0])
        return real(params, cfg, tokens, *args, **kw)

    monkeypatch.setattr(scheduler, "paged_decode_loop", spy)
    be = BatchEngine(engine, max_batch=8, decode_chunk=2, paged=True)
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=16))
            for p in prompts_of(13, (5, 6, 7))]
    drive(be, reqs)
    assert set(widths) == {1, 2, 4}  # 1, 2, then 3 active slots: never the 8 physical lanes


def test_pad_lanes_write_only_the_sink_page(engine):
    """With 3 active slots the 4th compacted lane carries an all-zero table:
    its K/V go to page 0, and no page of the pool beyond those the slots
    own is ever written."""
    be = BatchEngine(engine, max_batch=8, decode_chunk=2, paged=True)
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=16))
            for p in prompts_of(13, (5, 6, 7))]
    owned = set()
    for _ in range(50):
        owned |= {p for s in be.slots for p in s.pages}
        if be.step() == 0 and be.queue.empty():
            break
    assert all(r.state == RequestState.FINISHED for r in reqs)
    untouched = sorted(set(range(1, be.alloc.n_pages)) - owned)
    assert untouched and not be.cache.k[:, :, untouched].any()
    assert be.cache.k[:, :, 0].any()  # the pad lane wrote the sink page


def test_a_failing_step_fails_the_running_requests(engine, monkeypatch):
    """The background worker survives an exception in a step: it fails the
    running requests (their streams end) and keeps serving."""
    be = BatchEngine(engine, max_batch=2, decode_chunk=4, paged=True)
    r = be.submit(prompts_of(15, (6,))[0], SamplingParams(temperature=0.0, max_new_tokens=20))
    be.step()  # admitted, prefilled, first chunk decoded
    real = scheduler.paged_decode_loop

    def boom(*args, **kw):
        raise RuntimeError("injected decode failure")

    monkeypatch.setattr(scheduler, "paged_decode_loop", boom)
    be.start()
    try:
        list(r.stream(timeout=60))
        assert r.state == RequestState.FAILED
        monkeypatch.setattr(scheduler, "paged_decode_loop", real)
        r2 = be.submit(prompts_of(16, (6,))[0], SamplingParams(temperature=0.0, max_new_tokens=4))
        assert len(list(r2.stream(timeout=60))) > 0 and r2.state == RequestState.FINISHED
    finally:
        be.close()
