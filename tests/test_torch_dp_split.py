"""The dp split of the dense BatchEngine's lanes on the CPU.

A gloo world of two ranks (tests/torch_tp_worker.py "dp2": mesh {"dp": 2,
"tp": 1}, f32, the tiny llama of tests/test_torch_tp_engine.py) against
the port's single-device engine in each rank's process, and the JAX dense
BatchEngine on a 2-device CPU mesh {"dp": 2, "tp": 1} in a subprocess
(tests/torch_parallel_jax_refs.py "mesh"), as tests/test_sharding.py holds
the JAX dp BatchEngine to its unsplit one. Held:

- a rank's dense cache holds B/dp lanes of a batch that dp divides (its dp
  group's, from dp_rank * B/dp on), all lanes of one it does not (1, 3);
- a decode step on a rank's lanes gives the single-device engine's rows
  within 1e-5 (relative to the largest logit);
- the dense BatchEngine's greedy tokens (six requests through four slots,
  prompts of 9 to 29 tokens in prefill chunks of 16) equal the
  single-device port's and JAX's dp BatchEngine's, which prefills each
  prompt in one chunk: a JAX lane that is mid-prefill decodes at position 0
  and overwrites its prompt's first K/V row (ROADMAP §3, the JAX
  scheduler's faults), so JAX's own chunked batch differs from its
  `generate` from the third prompt on; sampled
  requests (with logprobs, penalties and a logit bias) and speculative
  "ngram" requests (greedy and sampled) give the single-device port's
  tokens and logprob entries: every rank draws the whole batch's numbers;
- every prefill ends in one broadcast over dp and every decode chunk in
  one gather; rank 1's BatchEngine decodes lanes 2 and 3 only.
"""
import pytest

from torch_worlds import jax_ok, ranks_ok, run_worlds, tiny_llama

LOGIT_TOL = 1e-5
WORLDS = {"dp2": ({"dp": 2, "tp": 1}, 2)}
# tests/torch_tp_worker.py's DP_CASES["greedy"]: the JAX BatchEngine runs the same requests
GREEDY = dict(prompts=[list(range(10 + 7 * i, 19 + 11 * i)) for i in range(6)], n_new=10, max_batch=4,
              prefill_chunk=64)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    return run_worlds(d, WORLDS, {"llama": tiny_llama(d)}, {"dp": GREEDY})


def test_cache_lanes_per_rank(run):
    for res in ranks_ok(run, "dp2"):
        r = res["rank"]
        assert res["dp"]["cache_batch"] == {"1": 1, "3": 3, "4": 2, "8": 4}
        assert res["dp"]["lanes"] == [2 * r, 2]
        for case in ("greedy", "sampled", "spec"):
            assert res["dp"][case]["lanes"] == [2 * r, 2] and res["dp"][case]["cache_lanes"] == 2
    assert jax_ok(run)["dp_cache_lanes"] == 2


def test_decode_logits_on_a_ranks_lanes(run):
    for res in ranks_ok(run, "dp2"):
        assert res["dp"]["logit_err"] < LOGIT_TOL, res["dp"]["logit_err"]


def test_greedy_tokens_equal_jax_and_single_device(run):
    root = ranks_ok(run, "dp2")[0]["dp"]["greedy"]
    assert root["tokens"] == root["want"]["tokens"] == jax_ok(run)["dp_tokens"]
    assert all(len(t) == GREEDY["n_new"] for t in root["tokens"])


@pytest.mark.parametrize("case", ["sampled", "spec"])
def test_seeded_tokens_equal_single_device(run, case):
    """The sampled rows (and their logprob entries), and the speculative
    rows, are the single-device BatchEngine's, whose generator has the
    same seed."""
    root = ranks_ok(run, "dp2")[0]["dp"][case]
    assert root["tokens"] == root["want"]["tokens"]
    assert root["logprobs"] == root["want"]["logprobs"]
    assert root["spec"] == root["want"]["spec"]
    if case == "sampled":
        assert any(root["logprobs"]) and len(set(map(tuple, root["tokens"]))) == len(root["tokens"])
    else:
        assert root["spec"][0] > 0 and root["spec"][1] > 0  # drafts proposed and some accepted


def test_one_broadcast_a_prefill_and_one_gather_a_chunk(run):
    """The same dp collectives on both ranks: a broadcast for each request's
    first token, a gather for each decode chunk."""
    a, b = ranks_ok(run, "dp2")
    for case in ("greedy", "sampled"):
        assert a["dp"][case]["dp"] == b["dp"][case]["dp"]
        assert a["dp"][case]["dp"]["gather_lanes"] > 0
    # the Comm's counts run on across the BatchEngines of one engine
    assert a["dp"]["greedy"]["dp"]["broadcast_first"] == 6
    assert a["dp"]["sampled"]["dp"]["broadcast_first"] == 11
