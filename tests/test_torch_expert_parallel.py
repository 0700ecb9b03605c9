"""MoE models under tensor parallelism: expert parallelism
(parallel/expert_parallel.py, `EngineConfig(expert_parallel=True)`) and
the ffn split of the expert stacks, against the JAX package on the CPU.

In this process:
- the expert stacks' split against the JAX `llama_param_shardings`
  (router replicated, gate/up by columns, down by rows) and, under expert
  parallelism, the JAX `expert_shardings` (the expert axis);
- rank shards of `load_params(tp=, tp_rank=[, expert_parallel=True])` for
  Q4_K, Q6_K, Q8_0 and F16 experts at tp 2 and 4, dequantized and joined,
  bit-equal to the single-device params; a split that breaks the grouped
  kernels' N rule or the experts' divisibility is a ValueError naming it;
  `expert_split` of loaded stacks equals the loader's shards;
- `moe_ffn_ep` (the ranks' partials summed) against the JAX `moe_ffn_ep`
  on dense and 8-bit stacks, over 2 and 4 ranks (the JAX function in a
  subprocess on the 8-virtual-device mesh: tests/torch_parallel_jax_refs.py);
- `cli --mesh tp=2 --expert-parallel --device cpu` answers piped input as
  the single-device CLI does.

In gloo worlds of spawned ranks (tests/torch_ep_worker.py, started once for
the module, side by side, with a deadline): {"tp": 2} (every check) and
{"dp": 2, "tp": 2}, each with expert parallelism and with the ffn split,
on a tiny qwen3moe with F32 experts (the dense route) and with Q8_0
experts (the grouped route, K9's plain version): greedy tokens equal to
both single-device engines' (the JAX engine's on the F32 model), prefill
logits within 1e-5 of both (relative to the largest logit) and 4
teacher-forced decode steps within 1e-5 of the port's (on the Q8_0 model
within 2e-2: its quantized matmuls' bf16 outputs round the row-parallel
partials before the f32 sum); a decode step's collectives 2L all-reduces
and one gather; each rank's expert bytes a tp-th; the paged BatchEngine
(Q8_0) and one HTTP completion (F32) under expert parallelism equal the
single-device ones.
"""
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models.llama import LlamaConfig as JLlamaConfig
from nfai_tpu.models.llama import load_params as jax_load_params
from nfai_tpu.parallel import llama_param_shardings as jax_shardings
from nfai_tpu.parallel import make_mesh as jax_make_mesh
from nfai_tpu.parallel.expert_parallel import expert_shardings as jax_expert_shardings
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import LlamaConfig, load_params
from nfai_tpu_torch.ops.qtensor import LayerList, Q4Tensor, Q8Tensor, dequant, from_jax_qtensor
from nfai_tpu_torch.parallel import expert_split, moe_ffn_ep, param_splits
from nfai_tpu_torch.testing import make_tiny_llama_gguf

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_ep_worker.py"
JAX_REFS = ROOT / "tests" / "torch_parallel_jax_refs.py"
MOE = dict(arch="qwen3moe", qk_norm=True, n_experts=4, n_experts_used=2, hidden=256, n_layers=2, n_heads=8,
           n_kv_heads=4, ffn_dim=256, context_length=256, vocab_size=512, tied=False)
WORLDS = {"tp2": ({"tp": 2}, 2), "dp2tp2": ({"dp": 2, "tp": 2}, 4)}
EXPERTS = ("w_gate_exps", "w_up_exps", "w_down_exps")
LOGIT_TOL = 1e-5
# on Q8_0 weights the quantized matmuls give bf16 outputs, so the
# row-parallel partials (wo's, and the ffn split's down) are rounded to bf16
# before their f32 sum: the kernel-parity rule
Q8_TOL = 2e-2
DEADLINE_S = 300
IDS = list(range(9, 49))  # the workers' prompt


def _ep_inputs() -> dict:
    rng = np.random.default_rng(0)
    e, h, f = 8, 32, 64
    out = {"x": rng.standard_normal((12, h), np.float32), "router": rng.standard_normal((h, e), np.float32),
           "used": np.int64(2)}
    for name, (k, n) in {"gate": (h, f), "up": (h, f), "down": (f, h)}.items():
        out[f"dense_{name}"] = rng.standard_normal((e, k, n), np.float32) * 0.1
        out[f"q8_{name}_qs"] = rng.integers(-127, 128, (e, k, n), dtype=np.int8)
        out[f"q8_{name}_scales"] = rng.random((e, k // 32, n), dtype=np.float32) * 0.01
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references' subprocess and every world's ranks, started
    together; {world: [rank results]}, the rank-0 arrays and the paths."""
    d = tmp_path_factory.mktemp("ep")
    paths = {"moe": str(make_tiny_llama_gguf(d / "moe.gguf", **MOE)),
             "moe_q8": str(make_tiny_llama_gguf(d / "moe_q8.gguf", quant=GGMLType.Q8_0, **MOE))}
    inp = d / "ep.npz"
    np.savez(inp, **_ep_inputs())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # JAX_PLATFORMS off for the script's own setup; OMP_NUM_THREADS=1 stalls its 8-device collectives
    jax_env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "OMP_NUM_THREADS")}
    jax_proc = subprocess.Popen([sys.executable, str(JAX_REFS), "ep", str(inp), str(d / "jax_ep.npz")],
                                cwd=ROOT, env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = {}
    for world, (mesh, size) in WORLDS.items():
        conf = d / f"{world}.json"
        conf.write_text(json.dumps({"paths": paths, "mesh": mesh, "timeout_s": 120, "full": world == "tp2"}))
        coord = f"file://{d / f'rdv_{world}'}"
        procs[world] = [subprocess.Popen(
            [sys.executable, str(WORKER), world, str(r), str(size), coord, str(conf), str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(size)]
    deadline = time.monotonic() + DEADLINE_S
    logs = {}
    for key, p in [(("jax", 0), jax_proc)] + [((w, r), p) for w, ps in procs.items() for r, p in enumerate(ps)]:
        try:
            logs[key] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            logs[key] = p.communicate()[0] + "\n(killed at the deadline)"
    assert jax_proc.returncode == 0, logs["jax", 0][-3000:]
    results = {"paths": paths, "jax": dict(np.load(d / "jax_ep.npz"))}
    for world, (_, size) in WORLDS.items():
        results[world] = []
        for r in range(size):
            f = d / f"{world}_{r}.json"
            res = json.loads(f.read_text()) if f.exists() else {"ok": False}
            res["log"] = logs[world, r][-4000:]
            results[world].append(res)
        arrays = d / f"{world}_arrays.npz"
        results[f"{world}_arrays"] = dict(np.load(arrays)) if arrays.exists() else {}
    return results


def _ok(results, world):
    for res in results[world]:
        assert res["ok"], res.get("error") or res["log"]
    return results[world]


# ---------------------------------------------------------------------------
# in process


def _jax_axis(spec) -> str | None:
    """The split a JAX PartitionSpec of an [L, E, K, N] expert stack gives."""
    spec = tuple(spec) + (None,) * (4 - len(tuple(spec)))
    return {1: "expert", 2: "row", 3: "col"}.get(next((i for i, a in enumerate(spec) if a == "tp"), -1))


@pytest.mark.parametrize("ep", [False, True], ids=["ffn_split", "expert_parallel"])
def test_split_table_matches_jax_shardings(tmp_path, ep):
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", quant=GGMLType.Q4_K, **MOE)
    jg = JGGUFFile.open(path)
    jcfg = JLlamaConfig.from_gguf(jg)
    jp = jax_load_params(jg, jcfg, dtype=jnp.float32, device_put=False, fuse=True, quantized="auto", tp=2)
    mesh = jax_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    tree = jax_shardings(mesh, jp)["layers"]
    if ep:  # the JAX engine's replacement of the expert stacks' specs (engine.py:160-170)
        tree = {**tree, **{k: jax_expert_shardings(mesh, stacked_layers=True) for k in EXPERTS}}
    want = {k: _jax_axis((tree[k].qs if hasattr(tree[k], "qs") else tree[k]).spec) for k in EXPERTS}
    assert want == ({k: "expert" for k in EXPERTS} if ep else
                    {"w_gate_exps": "col", "w_up_exps": "col", "w_down_exps": "row"})
    assert tuple(tree["router"].spec) in ((), (None, None, None))  # replicated
    with GGUFFile.open(path) as g:
        mine = param_splits(load_params(g, LlamaConfig.from_gguf(g), dtype=torch.float32, tp=2, tp_rank=0,
                                        expert_parallel=ep))["layers"]
    assert {k: mine[k] for k in EXPERTS} == want and mine["router"] is None
    jg.close()


def _dense(w) -> np.ndarray:
    return (dequant(w) if isinstance(w, (Q4Tensor, Q8Tensor)) else w).float().numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K", "Q8_0", "F16"])
def test_rank_shards_join_to_the_single_device_params(tmp_path, kind, tp):
    """Each expert stack's rank shards, dequantized and joined along their
    split axis (E under expert parallelism; N for gate/up and K for down
    under the ffn split), equal the single-device stacks bit for bit; the
    router is whole on every rank; `expert_split` of the loaded stacks
    gives the loader's expert shards."""
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", quant=GGMLType[kind], **MOE)
    with GGUFFile.open(path) as g:
        cfg = LlamaConfig.from_gguf(g)
        full = load_params(g, cfg, dtype=torch.float32)
        ep = [load_params(g, cfg, dtype=torch.float32, tp=tp, tp_rank=r, expert_parallel=True) for r in range(tp)]
        ffn = [load_params(g, cfg, dtype=torch.float32, tp=tp, tp_rank=r) for r in range(tp)]
    for key in EXPERTS:
        whole = _dense(full["layers"][key])
        assert np.array_equal(np.concatenate([_dense(s["layers"][key]) for s in ep], axis=1), whole)
        axis = -1 if key == "w_down_exps" else -2
        assert np.array_equal(np.concatenate([_dense(s["layers"][key]) for s in ffn], axis=axis), whole)
        for r, s in enumerate(ep):
            cut = expert_split(full["layers"][key], tp, r)
            assert type(cut) is type(s["layers"][key]) and np.array_equal(_dense(cut), _dense(s["layers"][key]))
    for s in ep + ffn:
        assert torch.equal(s["layers"]["router"], full["layers"]["router"])


def test_splits_that_break_the_kernel_rules_raise(tmp_path):
    """Q8_0 experts of 128 ffn columns at tp = 4 keep 32 a rank: K8/K9's N
    rule refuses them (the ffn split); 4 experts at tp = 8 do not divide."""
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", quant=GGMLType.Q8_0, **{**MOE, "ffn_dim": 128})
    with GGUFFile.open(path) as g:
        cfg = LlamaConfig.from_gguf(g)
        with pytest.raises(ValueError, match=r"N/tp % 64 == 0 .*N=128, tp=4 gives 32"):
            load_params(g, cfg, dtype=torch.float32, tp=4, tp_rank=0)
        load_params(g, cfg, dtype=torch.float32, tp=4, tp_rank=0, expert_parallel=True)  # experts stay whole
    path = make_tiny_llama_gguf(tmp_path / "f.gguf", **{**MOE, "hidden": 512})
    with GGUFFile.open(path) as g:
        with pytest.raises(ValueError, match="n_experts=4 must be divisible by tp=8 for expert_parallel"):
            load_params(g, LlamaConfig.from_gguf(g), dtype=torch.float32, tp=8, tp_rank=0, expert_parallel=True)


@pytest.fixture(scope="module")
def ep_inputs():
    return _ep_inputs()


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("stacks", ["dense", "q8"])
def test_moe_ffn_ep_matches_jax(run, ep_inputs, size, stacks):
    """The ranks' f32 partials of `moe_ffn_ep`, summed, against the JAX
    `moe_ffn_ep`: dense stacks within the JAX test's 2e-5; 8-bit stacks,
    whose gate / up / down rows are rounded to bf16 (a bf16 step of one
    gate value moves its token's sums by a few tenths here), within 2e-2 of
    the largest output, the kernel-parity rule."""
    inp = ep_inputs
    e, h = inp["router"].shape[1], inp["x"].shape[1]
    cfg = LlamaConfig(vocab_size=128, hidden_size=h, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=16,
                      ffn_dim=64, n_experts=e, n_experts_used=int(inp["used"]), moe_ffn_dim=64)
    if stacks == "dense":  # JAX [E, K, N] -> the port's [E, N, K]
        ws = [torch.from_numpy(inp[f"dense_{n}"]).transpose(1, 2).contiguous() for n in ("gate", "up", "down")]
    else:
        ws = [from_jax_qtensor("q8", inp[f"q8_{n}_qs"], inp[f"q8_{n}_scales"], None, *inp[f"q8_{n}_qs"].shape[1:])
              for n in ("gate", "up", "down")]
    x, router = torch.from_numpy(inp["x"]), torch.from_numpy(inp["router"])
    got = sum(moe_ffn_ep(x, router, *(expert_split(LayerList([w]), size, r).items[0] for w in ws), cfg, r, size)
              for r in range(size))
    want = run["jax"][f"{stacks}_{size}"]
    if stacks == "dense":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < Q8_TOL


def test_cli_expert_parallel_piped(run, capsys, monkeypatch):
    """`python -m nfai_tpu_torch.cli --mesh tp=2 --expert-parallel --device
    cpu` (rank 0 spawns rank 1) answers piped input as the single-device
    CLI does."""
    from nfai_tpu_torch import cli

    args = ["--gguf", run["paths"]["moe_q8"], "--device", "cpu", "--dtype", "float32", "--temp", "0",
            "--max-new-tokens", "8", "--max-seq", "128"]
    text = "hello there\nwhat next\n"
    env = dict(os.environ, OMP_NUM_THREADS="1", NFAI_DIST_TIMEOUT="120")
    env.pop("NFAI_COORD", None)
    out = subprocess.run([sys.executable, "-m", "nfai_tpu_torch.cli", *args, "--mesh", "tp=2", "--expert-parallel"],
                         input=text, capture_output=True, text=True, cwd=ROOT, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert out.stdout == want and len(want.splitlines()) == 2


# ---------------------------------------------------------------------------
# the worlds


@pytest.fixture(scope="module")
def jax_moe(run):
    je = JInferenceEngine(run["paths"]["moe"], JEngineConfig(dtype="float32", max_seq_len=128))
    logits, _ = je.prefill(je.new_cache(1), IDS)
    return np.asarray(logits, np.float32), list(je.generate(IDS, JSamplingParams(temperature=0.0, max_new_tokens=8)))


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case", ["moe_ep", "moe_ffn", "moe_q8_ep", "moe_q8_ffn"])
def test_engine_matches_both_single_device_engines(run, jax_moe, world, case):
    tol = Q8_TOL if case.startswith("moe_q8") else LOGIT_TOL
    for res in _ok(run, world):
        m = res[case]
        assert m["tp_tokens"] == m["one_tokens"]
        assert max(m["logit_errs"]) < tol, m["logit_errs"]
    if case.startswith("moe_q8"):
        return
    want_logits, want_tokens = jax_moe
    got = run[f"{world}_arrays"][f"{case}_prefill"]
    assert np.abs(got - want_logits).max() / np.abs(want_logits).max() < LOGIT_TOL
    assert run[world][0][case]["tp_tokens"] == want_tokens


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case", ["moe_ep", "moe_ffn", "moe_q8_ep", "moe_q8_ffn"])
def test_each_rank_holds_its_experts_and_collectives(run, world, case):
    """A rank's expert stacks: E/tp whole experts, or every expert's F/tp
    columns (and down's F/tp K range); a tp-th of the bytes; a decode step
    makes 2L all-reduces (wo and the MoE FFN) and one gather."""
    for res in _ok(run, world):
        m = res[case]
        tp = 2
        assert m["expert_bytes"] * tp == m["one_expert_bytes"]
        lead = m["shapes"]["w_gate_exps"][:3]
        if case.endswith("_ep"):
            assert m["expert_parallel"] and lead == [2, 4 // tp, 256] and m["moe_ffn_dim"] == 256
        else:
            assert not m["expert_parallel"] and lead == [2, 4, 256 // tp] and m["moe_ffn_dim"] == 256 // tp
        n = m["n_layers"]
        assert m["step_collectives"] == {"all_reduce": 2 * n, "gather_vocab": 1}


def test_batch_engine_and_http_under_expert_parallelism(run):
    root, follower = _ok(run, "tp2")
    assert root["batch"]["got"] == root["batch"]["want"] and all(len(t) == 8 for t in root["batch"]["got"])
    h = root["http"]
    assert h["ep"] == h["one"] and h["ep"]
    assert follower["http"]["followed"]
