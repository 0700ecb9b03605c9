"""Tensor parallelism end to end on the CPU: gloo worlds of spawned ranks
(tests/torch_tp_worker.py, one process a rank, the port's plain kernel
versions, f32 activations and F32 weights) against the port's
single-device engine in each rank's process and the JAX single-device
engine in this one.

Three worlds, started once for the module and run side by side: tp = 2
(every check), tp = 4 and dp = 2 x tp = 2 (tokens and logits). The tiny
llama is hidden 256, 2 layers, 8 / 4 heads, ffn 1024. Held:

- greedy tokens equal the JAX single-device engine's and the port's;
- logits of a prefill and 4 teacher-forced decode steps within 1e-5 of
  the port's single-device engine, relative to the largest logit (the
  f32 sums of the row-parallel partials are added in another order);
- the int8 cache, a tiny qwen2 (biases, tied table: the vocab-parallel
  embedding), phi3 (pre-fused qkv and gate_up) and gemma2 (post norms,
  softcaps, a window of 8) at tp = 2: the same;
- a decode step makes 2L all-reduces and one gather; the ranks' sampled
  tokens agree; a tp engine's tokens do not change when a plain engine is
  built in its process;
- the BatchEngine (prefix sharing, a starved pool that preempts), one
  HTTP completion and one SSE chat equal the single-device ones; a session
  file saved under the mesh resumes on one device; perplexity;
- the options a mesh once refused run and agree with one device (an "sp"
  axis, seq_parallel's check, a MoE model under tp with and without
  expert_parallel, the draft model, NFAI_Q8V3, an axis no split names);
  `cli --mesh tp=2 --device cpu` answers piped input as the single-device
  CLI does.

Each world has a file:// rendezvous under tmp_path and a 120 s group
timeout; every process is killed past 240 s, so a hung rank fails the
tests instead of stalling the suite.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_tp_worker.py"
TINY = dict(hidden=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=1024, context_length=256)
WORLDS = {"tp2": ({"tp": 2}, 2), "tp4": ({"tp": 4}, 4), "dp2tp2": ({"dp": 2, "tp": 2}, 4)}
LOGIT_TOL = 1e-5
DEADLINE_S = 240


def _fixtures(d: Path) -> dict:
    return {
        "llama": make_tiny_llama_gguf(d / "llama.gguf", vocab_size=512, tied=False, **TINY),
        "qwen2": make_tiny_llama_gguf(d / "qwen2.gguf", arch="qwen2", attn_bias=True, tied=True, **TINY),
        "phi3": make_tiny_llama_gguf(d / "phi3.gguf", arch="phi3", fused_tensors=True, tied=False, **TINY),
        "gemma2": make_tiny_llama_gguf(d / "gemma2.gguf", arch="gemma2", post_norms=True, sliding_window=8,
                                       attn_softcap=50.0, final_softcap=30.0, spm_tokenizer=True, **TINY),
        "moe": make_tiny_llama_gguf(d / "moe.gguf", arch="qwen3moe", qk_norm=True, n_experts=4,
                                    n_experts_used=2, **{**TINY, "ffn_dim": 256}),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every world's ranks, started together; {world: [rank results]}."""
    d = tmp_path_factory.mktemp("tp")
    paths = {k: str(v) for k, v in _fixtures(d).items()}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for world, (mesh, size) in WORLDS.items():
        conf = d / f"{world}.json"
        conf.write_text(json.dumps({"paths": paths, "mesh": mesh, "timeout_s": 120}))
        coord = f"file://{d / f'rdv_{world}'}"
        procs[world] = [subprocess.Popen(
            [sys.executable, str(WORKER), world, str(r), str(size), coord, str(conf), str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(size)]
    deadline = time.monotonic() + DEADLINE_S
    logs = {}
    for world, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                logs[world, r] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                logs[world, r] = p.communicate()[0] + "\n(killed at the deadline)"
    results = {}
    for world, (_, size) in WORLDS.items():
        results[world] = []
        for r in range(size):
            f = d / f"{world}_{r}.json"
            res = json.loads(f.read_text()) if f.exists() else {"ok": False}
            res["log"] = logs[world, r][-4000:]
            results[world].append(res)
    results["paths"] = paths
    return results


def _ok(results, world):
    for res in results[world]:
        assert res["ok"], res.get("error") or res["log"]
    return results[world]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_greedy_tokens_equal_jax_and_single_device(run, world):
    ranks = _ok(run, world)
    llama = ranks[0]["llama"]
    je = JInferenceEngine(run["paths"]["llama"], JEngineConfig(dtype="float32", max_seq_len=128))
    want = list(je.generate(llama["ids"], JSamplingParams(temperature=0.0, max_new_tokens=12)))
    assert llama["one_tokens"] == want
    for res in ranks:
        assert res["llama"]["tp_tokens"] == want


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_logits_within_tolerance_of_single_device(run, world):
    for res in _ok(run, world):
        assert max(res["llama"]["logit_errs"]) < LOGIT_TOL, res["llama"]["logit_errs"]


@pytest.mark.parametrize("world,local", [("tp2", [4, 2, 512]), ("tp4", [2, 1, 256]),
                                         ("dp2tp2", [4, 2, 512])])
def test_each_rank_holds_its_heads(run, world, local):
    """The local config and the cache: n_heads, n_kv_heads, ffn_dim over tp,
    the cache's lanes the rank's kv-heads (x head_dim 32)."""
    for res in _ok(run, world):
        assert res["llama"]["local_heads"] == local
        assert res["llama"]["cache_kvd"] == local[1] * 32


@pytest.mark.parametrize("model", ["int8", "qwen2", "phi3", "gemma2"])
def test_families_and_int8_cache_at_tp2(run, model):
    for res in _ok(run, "tp2"):
        m = res[model]
        assert m["tp_tokens"] == m["one_tokens"]
        assert max(m["logit_errs"]) < LOGIT_TOL, m["logit_errs"]


def test_decode_step_collectives(run):
    """2L all-reduces and one gather a decode step; one more reduce where a
    tied table is split under the head (qwen2's vocab-parallel embedding)."""
    for res in _ok(run, "tp2") + _ok(run, "tp4") + _ok(run, "dp2tp2"):
        n = res["llama"]["n_layers"]
        assert res["llama"]["step_collectives"] == {"all_reduce": 2 * n, "gather_vocab": 1}
    for res in _ok(run, "tp2"):
        assert res["qwen2"]["step_collectives"] == {"all_reduce": 4, "gather_vocab": 1, "embed_reduce": 1}
        assert res["phi3"]["step_collectives"] == {"all_reduce": 4, "gather_vocab": 1}


def test_sampled_tokens_agree_across_ranks(run):
    for world in WORLDS:
        ranks = _ok(run, world)
        assert len({json.dumps(r["llama"]["sampled"]) for r in ranks}) == 1
        for r in ranks:
            assert r["llama"]["sampled_seeded"] == r["llama"]["sampled_seeded_one"]


def test_two_engines_in_one_process(run):
    """A plain engine built after a tp engine leaves the tp engine's group
    and tokens alone (the JAX TP_MESH global is reset by every engine)."""
    for res in _ok(run, "tp2"):
        first, plain, again = res["llama"]["two_engines"]
        assert first == again == plain


def test_session_file_and_perplexity_at_tp2(run):
    """A session saved under the mesh (the ranks' kv-heads gathered, one
    file from rank 0) resumes on the tp engine and on a single-device one
    as the live session goes on; perplexity equals the single device's."""
    for res in _ok(run, "tp2"):
        s = res["session"]
        assert s["live"] == s["tp_loaded"] == s["one_loaded"] and s["live"]
        tp_ppl, one_ppl = s["ppl"]
        assert abs(tp_ppl - one_ppl) <= LOGIT_TOL * one_ppl


@pytest.mark.parametrize("case", ["shared", "starved"])
def test_batch_engine_at_tp2(run, case):
    """The tp BatchEngine's tokens equal the single-device BatchEngine's and
    generate's; the follower preempted exactly where rank 0 did."""
    root, follower = _ok(run, "tp2")
    got = root["batch"][case]
    assert got["got"] == got["want"]["batch"] == got["want"]["generate"]
    assert all(len(t) == got["n_new"] for t in got["got"])
    assert follower["batch"][case]["preemptions"] == got["preemptions"]
    assert (got["preemptions"] > 0) == (case == "starved")


def test_server_at_tp2(run):
    root, follower = _ok(run, "tp2")
    s = root["server"]
    assert s["tp"] == s["one"] and s["tp"]["done"] == "[DONE]"
    assert s["tp"]["completion"] and s["tp"]["chat"]
    assert follower["server"]["followed"]


PORTED_OPTIONS = {  # ROADMAP 2(b), 2(c): what each case does now in the tp = 2 world
    "sp_axis": "ok: dp=1 tp=1 sp=2 sp_rank={rank}",
    "seq_parallel": "ValueError: seq_parallel needs mesh_shape={{'sp': n>1}}",
    "expert_parallel": "ok: greedy equal True",
    "moe": "ok: greedy equal True",
    "draft": "ok: greedy equal True",
    "q8v3": "ok: greedy equal True",
    "x_axis": "ok: greedy equal True",
}


@pytest.mark.parametrize("name", ["sp_axis", "seq_parallel", "expert_parallel", "moe", "draft", "q8v3", "x_axis"])
def test_unported_parallel_options_raise(run, name):
    """Every option a mesh once refused now runs (ROADMAP 2(b), 2(c)): an
    "sp" axis makes a mesh, seq_parallel on a mesh without an sp axis gives
    the JAX check's ValueError, and a MoE model under tp (with or without
    expert_parallel), speculative="draft" (the model as its own draft),
    NFAI_Q8V3=1 and a mesh {"tp": 1, "x": 2} decode the single-device
    engine's greedy tokens (tests/test_torch_expert_parallel.py,
    test_torch_spec_mesh.py and test_torch_mesh_axes.py hold them to the
    JAX package). No case raises NotImplementedError any more."""
    for res in _ok(run, "tp2"):
        msg = res["refusals"][name]
        assert not msg.startswith("NotImplementedError"), msg
        assert msg == PORTED_OPTIONS[name].format(rank=res["rank"]), msg


def test_cli_mesh_piped(run, capsys, monkeypatch):
    """`python -m nfai_tpu_torch.cli --mesh tp=2 --device cpu` (rank 0 spawns
    rank 1) answers piped input as the single-device CLI does."""
    import io

    from nfai_tpu_torch import cli

    args = ["--gguf", run["paths"]["llama"], "--device", "cpu", "--dtype", "float32", "--temp", "0",
            "--max-new-tokens", "8", "--max-seq", "128"]
    text = "hello there\nwhat next\n"
    env = dict(os.environ, OMP_NUM_THREADS="1", NFAI_DIST_TIMEOUT="120")
    env.pop("NFAI_COORD", None)
    out = subprocess.run([sys.executable, "-m", "nfai_tpu_torch.cli", *args, "--mesh", "tp=2"],
                         input=text, capture_output=True, text=True, cwd=ROOT, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert out.stdout == want and len(want.splitlines()) == 2
