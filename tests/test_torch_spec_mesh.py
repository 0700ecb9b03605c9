"""The draft model, NFAI_Q8V3 and dense weights under tp = 2 on the CPU.

A gloo world of two ranks (tests/torch_tp_worker.py "spec", mesh {"tp":
2}, f32) against the port's single-device engines in each rank's process
and, in a subprocess on a 2-device CPU mesh (tests/torch_parallel_jax_refs.py
"mesh"), the JAX engine under {"tp": 2}, its single-device draft engine and
its {"tp": 2} engine under NFAI_Q8V3=1. Held:

- speculative="draft" under the mesh (target: the tiny llama of
  tests/test_torch_tp_engine.py, F32; draft: a one-layer llama of the same
  vocabulary): greedy output equals the tp target's plain greedy, the
  single-device draft engine's, and the JAX single-device draft engine's;
  the draft engine takes the target's Mesh, holds its own shard (4 / 2
  heads a rank) and has its own Comm, which makes the draft's collectives;
  seeded sampled output agrees across the ranks; acceptance is counted;
- dense (F32) weights at tp = 2: the greedy tokens equal the JAX mesh
  engine's (tests/test_torch_tp_engine.py holds their logits to one device);
- NFAI_Q8V3=1 at tp = 2 on a hidden-2048 Q8_0 model whose wk/wv shards are
  64 rows (N/tp % 128 != 0: the JAX loader leaves them unmarked): a rank's
  containers are the kinds the JAX mesh engine holds (wk, wv q8v3 and
  split from wq; wq, wo, gate_up, down and the head q8), its greedy tokens
  equal the JAX mesh engine's and the single-device port's under the same
  switch, and its prefill logits are within 2e-2 of both per row;
- the rule behind those kinds: the port's reading of the JAX kernel's tile
  fit (`_jax_q8_tiles_fit`) is the JAX `kernel_supported` of a q8 view at
  every shape tried, and at Llama-3.1-8B's widths in Q8_0 (the card's
  model E) the JAX loader marks every split weight at tp = 2, so no rank
  weight takes K12 there (at tp = 4 the head's 32064-row shard is left
  unmarked and takes it).
"""
import numpy as np
import pytest

from nfai_tpu.ops.qmatmul import kernel_supported as jax_kernel_supported
from nfai_tpu.ops.qtensor import QTensor
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.models.llama import _jax_marks_tp, _jax_q8_tiles_fit
from nfai_tpu_torch.testing import make_tiny_llama_gguf
from torch_worlds import TINY, jax_ok, ranks_ok, run_worlds, tiny_llama

TOL = 2e-2
Q8_MODEL = dict(hidden=2048, n_layers=2, n_heads=32, n_kv_heads=2, ffn_dim=2048, vocab_size=4096,
                quant=GGMLType.Q8_0, tied=False, seed=7)
Q_IDS = [2, 4, 6, 8, 10, 12, 14]  # tests/torch_tp_worker.py's spec_checks
PROMPT = "The quick brown fox jumps over the lazy dog, and then it runs far away."  # the worker's
# the JAX kinds of the rank's containers (the port's class for each)
KINDS = {"q8": "Q8Tensor", "q8v3": "Q8V3Tensor"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from nfai_tpu_torch.gguf import GGUFFile
    from nfai_tpu_torch.tokenizer import tokenizer_from_gguf

    d = tmp_path_factory.mktemp("spec")
    paths = {"llama": tiny_llama(d),
             "draft": str(make_tiny_llama_gguf(d / "draft.gguf", vocab_size=512, tied=False, seed=3,
                                               **{**TINY, "n_layers": 1})),
             "q8": str(make_tiny_llama_gguf(d / "q8.gguf", **Q8_MODEL))}
    ids = tokenizer_from_gguf(GGUFFile.open(paths["llama"]).metadata).encode(PROMPT)
    return run_worlds(d, {"spec": ({"tp": 2}, 2)}, paths, {"spec": {"ids": ids, "n_new": 24, "q_ids": Q_IDS}})


def test_draft_under_tp2_equals_plain_greedy_and_jax(run):
    jax_tokens = jax_ok(run)["draft_tokens"]
    for res in ranks_ok(run, "spec"):
        s = res["spec"]
        assert s["draft_tokens"] == s["plain_tokens"] == s["one_draft_tokens"] == jax_tokens
        assert len(s["draft_tokens"]) == 24
        drafted, accepted = s["acceptance"]
        assert drafted > 0 and 0 <= accepted <= drafted


def test_draft_engine_shares_the_mesh_and_has_its_own_comm(run):
    a, b = ranks_ok(run, "spec")
    for res in (a, b):
        s = res["spec"]
        assert s["draft_mesh_shared"] and s["draft_local_heads"] == [4, 2]
        assert s["draft_collectives"]["all_reduce"] > 0 and s["draft_collectives"]["gather_vocab"] > 0
    assert a["spec"]["draft_sampled"] == b["spec"]["draft_sampled"] and len(a["spec"]["draft_sampled"]) == 16


def test_dense_weights_at_tp2_equal_the_jax_mesh_engine(run):
    want = jax_ok(run)["tp_tokens"]
    for res in ranks_ok(run, "spec"):
        assert res["spec"]["plain_tokens"] == want


def test_q8v3_containers_are_the_jax_kinds(run):
    want = {k: KINDS[v] for k, v in jax_ok(run)["q8v3_kinds"].items()}
    assert want["wk"] == want["wv"] == "Q8V3Tensor" and want["wq"] == "Q8Tensor"
    for res in ranks_ok(run, "spec"):
        q = res["spec"]["q8v3"]
        assert q["kinds"] == want
        assert set(q["one_kinds"].values()) == {"Q8V3Tensor"}  # one device: every eligible stack


def test_q8v3_at_tp2_tokens_and_logits(run):
    ref = jax_ok(run)
    jl = np.asarray(ref["q8v3_logits"], np.float32)
    for res in ranks_ok(run, "spec"):
        q = res["spec"]["q8v3"]
        assert q["tokens"] == ref["q8v3_tokens"] == q["one_tokens"] and len(q["tokens"]) == 4
        got = np.asarray(q["logits"], np.float32)
        assert float(np.abs(got - jl).max() / np.abs(jl).max()) < TOL
        assert q["logit_err"] < TOL


@pytest.mark.parametrize("group", [16, 32])
@pytest.mark.parametrize("k,n", [(4096, 2048), (4096, 512), (2048, 4096), (7168, 4096), (4096, 64128),
                                 (4096, 7168), (2048, 64), (1024, 128), (384, 256), (640, 96), (128, 4096),
                                 (3072, 1536), (1536, 4480), (4480, 1536), (96, 100), (2304, 128000)], ids=str)
def test_tile_fit_is_the_jax_kernel_supported(k, n, group):
    view = QTensor(None, None, None, "q8", k, n, group=group)
    assert _jax_q8_tiles_fit(k, n, group) == jax_kernel_supported(view)


@pytest.mark.parametrize("tp,unmarked", [(2, set()), (4, {"lm_head"})])
def test_llama_8b_q8_0_takes_no_k12_under_tp(tp, unmarked):
    """Every split 8-bit weight of Llama-3.1-8B (Q8_0, groups of 32) is
    marked at tp = 2, so the JAX `q8v3_eligible` refuses them all; at tp = 4
    the head's vocabulary shard (32064 rows, N/tp % 128 != 0) is not, and
    takes K12 on each rank."""
    whole = {"wq": ("col", 4096, 4096), "wk": ("col", 1024, 4096), "wv": ("col", 1024, 4096),
             "wo": ("row", 4096, 4096), "w_gate": ("col", 14336, 4096), "w_up": ("col", 14336, 4096),
             "w_down": ("row", 4096, 14336), "lm_head": ("col", 128256, 4096)}
    assert {key for key, (how, n, k) in whole.items() if not _jax_marks_tp(how, n, k, 32, tp)} == unmarked
