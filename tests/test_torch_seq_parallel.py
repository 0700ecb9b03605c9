"""Sequence parallelism (parallel/seq_parallel.py, the "sp" mesh axis,
`EngineConfig(seq_parallel=True)`) against the JAX package on the CPU.

In this process:
- `local_flash` against the JAX `_local_flash` (GQA r in {1, 2, 4}, ragged
  lengths, slices that hold no valid key), and its T > 1, softcap, window
  and int8 forms against plain attention (the port's K4 plain version) over
  the whole cache; two slices merged by the log-sum-exp rule give the same;
- `mesh_dims` with an "sp" axis against the JAX `make_mesh` (sizes and
  errors), and the rank layout (coordinates, each axis's group) against
  the JAX device array;
- the engine's checks that need no world.

In gloo worlds of spawned ranks (tests/torch_sp_worker.py, started once for
the module, side by side, with a deadline): {"sp": 2} (every check),
{"sp": 4} and {"tp": 2, "sp": 2}:
- the stats merge, the ring and the merged-lane adapter on each rank's
  slice against the JAX `sp_decode_attention`, `_ring` and `_merged` (run
  in a subprocess on the 8-virtual-device mesh: tests/torch_parallel_jax_refs.py)
  and against dense attention in numpy;
- the tiny llama (f32 and int8) and gemma2 (softcaps, a window of 8):
  prefill logits (a 100-token prompt in chunks of 32, across two 64-slot
  slices) within 1e-5 of both single-device engines (relative to the
  largest logit; 5e-2 on the int8 cache, whose new token is read back
  quantized, as the JAX SP engine does), 4 teacher-forced decode steps
  within the same of the port's, greedy tokens equal to both; a decode
  step's collectives (one max and two sums a layer over sp, and under tp
  2L all-reduces and one gather); each rank's cache its S slice;
- the BatchEngine, dense (the split cache) and paged (the pool whole on
  every sp rank), and a session saved under sp resumed on one device.
"""
import dataclasses
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
from nfai_tpu.parallel import make_mesh as jax_make_mesh
from nfai_tpu.parallel.seq_parallel import _local_flash as jax_local_flash
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention_plain
from nfai_tpu_torch.parallel import local_flash, mesh_dims
from nfai_tpu_torch.parallel.mesh import axis_ranks, rank_coords
from nfai_tpu_torch.parallel.seq_parallel import NEG_INF
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_sp_worker.py"
JAX_REFS = ROOT / "tests" / "torch_parallel_jax_refs.py"
TINY = dict(hidden=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=1024, context_length=256)
WORLDS = {"sp2": ({"sp": 2}, 2), "sp4": ({"sp": 4}, 4), "tp2sp2": ({"tp": 2, "sp": 2}, 4)}
LOGIT_TOL = 1e-5
INT8_TOL = 5e-2
DEADLINE_S = 300
IDS = list(range(10, 110))  # the workers' prompt


def _attention_inputs() -> dict:
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 3, 64, 8, 2, 16
    return dict(q=rng.standard_normal((b, hq, d), np.float32), k=rng.standard_normal((b, s, hkv, d), np.float32),
                v=rng.standard_normal((b, s, hkv, d), np.float32), lengths=np.array([64, 5, 37], np.int32))


def _dense_attention(q, k, v, lengths, scale):
    """Softmax attention of one query token over k/v [B, S, Hkv, D] in f64."""
    b, hq, d = q.shape
    r = hq // k.shape[2]
    out = np.zeros((b, hq, d))
    for bi in range(b):
        for h in range(hq):
            sc = (k[bi, :lengths[bi], h // r].astype(np.float64) @ q[bi, h]) * scale
            p = np.exp(sc - sc.max())
            out[bi, h] = (p / p.sum()) @ v[bi, :lengths[bi], h // r]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references' subprocess and every world's ranks, started
    together; {world: [rank results]}, the rank-0 arrays and the paths."""
    d = tmp_path_factory.mktemp("sp")
    paths = {"llama": str(make_tiny_llama_gguf(d / "llama.gguf", vocab_size=512, tied=False, **TINY)),
             "gemma2": str(make_tiny_llama_gguf(d / "gemma2.gguf", arch="gemma2", post_norms=True,
                                                sliding_window=8, attn_softcap=50.0, final_softcap=30.0,
                                                spm_tokenizer=True, **TINY))}
    inp = d / "attention.npz"
    np.savez(inp, **_attention_inputs())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # JAX_PLATFORMS off for the script's own setup; OMP_NUM_THREADS=1 stalls its 8-device collectives
    jax_env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "OMP_NUM_THREADS")}
    jax_proc = subprocess.Popen([sys.executable, str(JAX_REFS), "sp", str(inp), str(d / "jax_sp.npz")],
                                cwd=ROOT, env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = {}
    for world, (mesh, size) in WORLDS.items():
        conf = d / f"{world}.json"
        conf.write_text(json.dumps({"paths": paths, "mesh": mesh, "attention": str(inp), "timeout_s": 120,
                                    "full": world == "sp2"}))
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
    results = {"paths": paths, "inputs": _attention_inputs(), "jax": dict(np.load(d / "jax_sp.npz"))}
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


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("offset", [0, 16, 48])
def test_local_flash_matches_jax(r, offset):
    """The decode form: partials of one 32-slot slice at `offset`, ragged
    lengths (row 1 has no valid key past offset 0: the identity)."""
    rng = np.random.default_rng(r)
    b, sl, hkv, d = 3, 32, 2, 16
    q = rng.standard_normal((b, hkv * r, d), np.float32)
    k, v = (rng.standard_normal((b, sl, hkv, d), np.float32) for _ in range(2))
    lengths = np.array([64, 5, 37], np.int32)
    want = jax_local_flash(*map(jnp.asarray, (q, k, v, lengths)), offset, d ** -0.5)
    got = local_flash(*map(torch.from_numpy, (q, k, v, lengths)), offset, d ** -0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if offset >= 5:
        acc, m, l = (t[1] for t in got)
        assert (acc == 0).all() and (m == NEG_INF).all() and (l == 0).all()


def _normalised(acc, m, l):
    return acc / l.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("case", [dict(), dict(softcap=20.0), dict(window=8), dict(int8=True),
                                  dict(softcap=20.0, window=8, int8=True)], ids=str)
def test_local_flash_chunk_forms_match_plain_attention(case):
    """T = 8 queries at absolute positions over the whole cache (offset 0),
    and the same cache cut into two slices merged by the log-sum-exp rule,
    against the port's plain prefill attention (causal, softcap, window,
    int8 scales)."""
    from nfai_tpu_torch.ops.kv_store import quantize_kv

    rng = np.random.default_rng(3)
    b, t, s, hq, hkv, d = 2, 8, 64, 8, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, t, hq, d), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv * d), np.float32)) for _ in range(2))
    offsets = torch.tensor([20, 50], dtype=torch.int32)
    positions = offsets[:, None].long() + torch.arange(t)[None]
    scales = {}
    if case.get("int8"):
        k, ks = quantize_kv(k, hkv)
        v, vs = quantize_kv(v, hkv)
        scales = dict(k_scales=ks.transpose(1, 2).contiguous(), v_scales=vs.transpose(1, 2).contiguous())
    kw = dict(softcap=case.get("softcap", 0.0), window=case.get("window", 0))
    want = flash_prefill_attention_plain(q, k, v, offsets, d ** -0.5, **scales, **kw)
    k4, v4 = k.view(b, s, hkv, d), v.view(b, s, hkv, d)
    got = _normalised(*local_flash(q, k4, v4, None, 0, d ** -0.5, positions=positions, **kw, **scales))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    halves = []
    for lo in (0, s // 2):
        sl = {n: t_[..., lo:lo + s // 2] for n, t_ in scales.items()}
        halves.append(local_flash(q, k4[:, lo:lo + s // 2], v4[:, lo:lo + s // 2], None, lo, d ** -0.5,
                                  positions=positions, **kw, **sl))
    m = torch.maximum(halves[0][1], halves[1][1])
    corr = [torch.where(h[1] <= NEG_INF / 2, 0.0, torch.exp(h[1] - m)) for h in halves]
    acc = sum(h[0] * c[..., None] for h, c in zip(halves, corr))
    l = sum(h[2] * c for h, c in zip(halves, corr))
    torch.testing.assert_close(acc / l[..., None], want, rtol=1e-5, atol=1e-5)


SP_SHAPES = [{"sp": 2}, {"sp": -1}, {"tp": 2, "sp": 2}, {"dp": 2, "sp": 2}, {"dp": 2, "tp": 2, "sp": 2},
             {"sp": 3}, {"tp": -1, "sp": 2}, {"dp": -1, "tp": 2, "sp": 2}, {"sp": 8}, {"sp": 1}]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared between the packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SP_SHAPES, ids=str)
def test_mesh_dims_with_sp_match_jax(shape, n):
    def jax_dims():
        return dict(jax_make_mesh(dict(shape), devices=jax.devices()[:n]).shape)

    assert _outcome(lambda: mesh_dims(shape, n)) == _outcome(jax_dims)


@pytest.mark.parametrize("shape", [{"sp": 8}, {"tp": 2, "sp": 4}, {"dp": 2, "tp": 2, "sp": 2},
                                   {"dp": 4, "sp": 2}, {"dp": 2, "tp": 4}], ids=str)
def test_rank_layout_matches_the_jax_device_array(shape):
    """Rank r sits where the JAX mesh puts device r: coordinates (dp, tp,
    sp), and each axis's group the devices along that axis."""
    mesh = jax_make_mesh(dict(shape), devices=jax.devices())
    dims = mesh_dims(shape, 8)
    grid = mesh.devices.reshape(mesh.devices.shape + (1,) * (3 - mesh.devices.ndim))
    for idx in np.ndindex(grid.shape):
        rank = grid[idx].id
        assert rank_coords(dims, rank) == idx
        for a, axis in enumerate(("dp", "tp", "sp")):
            line = [grid[idx[:a] + (i,) + idx[a + 1:]].id for i in range(grid.shape[a])]
            assert axis_ranks(dims, axis, rank) == line


def test_engine_checks_without_a_world(tmp_path):
    """In a world of one: seq_parallel on an sp axis of 1 and
    expert_parallel on a dense model raise the JAX checks' ValueErrors."""
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", vocab_size=512, **TINY)
    cfg = dict(dtype="float32", max_seq_len=128)
    with pytest.raises(ValueError, match=r"seq_parallel needs mesh_shape=\{'sp': n>1\}"):
        InferenceEngine(path, EngineConfig(mesh_shape={"sp": 1}, seq_parallel=True, **cfg), device="cpu")
    with pytest.raises(ValueError, match="expert_parallel needs an MoE model"):
        InferenceEngine(path, EngineConfig(mesh_shape={"tp": 1}, expert_parallel=True, **cfg), device="cpu")
    e = InferenceEngine(path, EngineConfig(mesh_shape={"sp": 1}, **cfg), device="cpu")
    assert e.mesh.sp == 1 and e.sp_comm is None and e.new_cache(1).offset == 0


# ---------------------------------------------------------------------------
# the worlds


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_merge_ring_and_merged_adapter_match_jax(run, world):
    ranks = _ok(run, world)
    n = ranks[0]["mesh"]["sp"]
    inp = run["inputs"]
    dense = _dense_attention(inp["q"], inp["k"], inp["v"], inp["lengths"], 16 ** -0.5)
    got = run[f"{world}_arrays"]
    for name in ("stats", "ring", "merged_stats", "merged_ring"):
        np.testing.assert_allclose(got[f"{name}_{n}"], run["jax"][f"{name}_{n}"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[f"{name}_{n}"], dense, rtol=2e-5, atol=2e-5)
    for res in ranks:
        assert res["attention"]["stats_counts"] == {"all_max": 1, "all_reduce": 2}
        assert res["attention"]["ring_counts"] == {"ring": n - 1}


def _jax_prefill_and_tokens(path, arch=None):
    je = JInferenceEngine(path, JEngineConfig(dtype="float32", max_seq_len=128, prefill_chunk=32))
    if arch == "gemma2":  # the port's attention scale (llama.cpp's rule; equal at these widths)
        port = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=128), device="cpu")
        je.model_cfg = dataclasses.replace(je.model_cfg, attn_scale=port.model_cfg.query_scale)
    logits, _ = je.prefill(je.new_cache(1), IDS)
    toks = list(je.generate(IDS, JSamplingParams(temperature=0.0, max_new_tokens=12)))
    return np.asarray(logits, np.float32), toks


@pytest.fixture(scope="module")
def jax_refs(run):
    return {"llama": _jax_prefill_and_tokens(run["paths"]["llama"]),
            "gemma2": _jax_prefill_and_tokens(run["paths"]["gemma2"], "gemma2")}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("model", ["llama", "int8", "gemma2"])
def test_engine_matches_both_single_device_engines(run, jax_refs, world, model):
    tol = INT8_TOL if model == "int8" else LOGIT_TOL
    want_logits, want_tokens = jax_refs["gemma2" if model == "gemma2" else "llama"]
    got = run[f"{world}_arrays"][f"{model}_prefill"]
    assert np.abs(got - want_logits).max() / np.abs(want_logits).max() < tol
    for res in _ok(run, world):
        m = res[model]
        assert max(m["logit_errs"]) < tol, m["logit_errs"]
        assert m["sp_tokens"] == m["one_tokens"]
        if model != "int8":
            assert m["sp_tokens"] == want_tokens


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_each_rank_holds_its_slice_and_collectives(run, world):
    """Each rank's cache is [L, 1, S/sp, KVD/tp] from slot sp_rank * S/sp;
    a decode step makes one max and two sums a layer over sp (and under tp
    its 2L all-reduces and one gather)."""
    for res in _ok(run, world):
        mesh, m = res["mesh"], res["llama"]
        sp, tp = mesh["sp"], mesh["tp"]
        span = -(-128 // (64 * sp)) * 64 * sp
        shape, offset, max_seq, nbytes = m["cache"]
        assert shape == [2, 1, span // sp, 128 // tp] and offset == mesh["sp_rank"] * span // sp
        assert max_seq == span and nbytes * sp * tp == m["one_cache_bytes"] * span // 128
        n = m["n_layers"]
        assert m["step_collectives"]["sp"] == {"all_max": n, "all_reduce": 2 * n}
        assert m["step_collectives"]["tp"] == ({"all_reduce": 2 * n, "gather_vocab": 1} if tp > 1 else {})


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_batch_engine_under_sp(run, cache):
    root = _ok(run, "sp2")[0]
    b = root["batch"][cache]
    assert b["got"] == b["want"] and all(len(t) == 8 for t in b["got"])


def test_session_saved_under_sp_resumes_on_one_device(run):
    for res in _ok(run, "sp2"):
        s = res["session"]
        assert s["cached"] > 128  # the first turn reached the second slice (256 slots)
        assert s["live"] == s["sp_loaded"] == s["one_loaded"] and s["live"]
        assert s["gathered"].get("gather_slots") == 2  # k and v


def test_max_seq_len_must_divide_by_sp(run):
    for res in _ok(run, "sp2"):
        assert res["errors"]["max_seq_len"] == "max_seq_len=127 must be divisible by the sp axis (2)"
