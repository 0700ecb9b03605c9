"""Gloo worlds of tests/torch_tp_worker.py ranks, and the JAX package's mesh
references beside them, for the port's mesh tests
(tests/test_torch_dp_split.py, test_torch_mesh_axes.py,
test_torch_spec_mesh.py).

`run_worlds` starts every world's ranks (one process a rank, a file://
rendezvous under the test's directory, a 120 s group timeout) and, given a
config, the JAX references of tests/torch_parallel_jax_refs.py "mesh" on a
2-device CPU mesh, all together; it waits for them (each process is killed
past DEADLINE_S, so a hung rank fails the tests instead of stalling the
suite) and returns every rank's result.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from nfai_tpu_torch.testing import make_tiny_llama_gguf

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_tp_worker.py"
JAX_REFS = ROOT / "tests" / "torch_parallel_jax_refs.py"
# the tiny llama of tests/test_torch_tp_engine.py (F32 weights)
TINY = dict(hidden=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=1024, context_length=256)
DEADLINE_S = 240


def tiny_llama(d: Path) -> str:
    return str(make_tiny_llama_gguf(d / "llama.gguf", vocab_size=512, tied=False, **TINY))


def run_worlds(d: Path, worlds: dict, paths: dict, jax_conf: dict | None = None) -> dict:
    """{world: [rank results]} of `worlds` ({name: (mesh, size)}), and
    under "jax" the references' output for `jax_conf` (None: none run)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    if jax_conf is not None:
        conf = d / "jax_refs.json"
        conf.write_text(json.dumps({"paths": paths, **jax_conf}))
        # 2 devices for the JAX make_mesh, which takes them all; OMP_NUM_THREADS=1 stalls its collectives
        jax_env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "OMP_NUM_THREADS")}
        jax_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        procs["jax"] = [subprocess.Popen([sys.executable, str(JAX_REFS), "mesh", str(conf), str(d / "jax.json")],
                                         cwd=ROOT, env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)]
    for world, (mesh, size) in worlds.items():
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
    results = {"paths": paths}
    if jax_conf is not None:
        f = d / "jax.json"
        results["jax"] = json.loads(f.read_text()) if procs["jax"][0].returncode == 0 and f.exists() else None
        results["jax_log"] = logs["jax", 0][-4000:]
    for world, (_, size) in worlds.items():
        results[world] = []
        for r in range(size):
            f = d / f"{world}_{r}.json"
            res = json.loads(f.read_text()) if f.exists() else {"ok": False}
            res["log"] = logs[world, r][-4000:]
            results[world].append(res)
    return results


def ranks_ok(results: dict, world: str) -> list[dict]:
    for res in results[world]:
        assert res["ok"], res.get("error") or res["log"]
    return results[world]


def jax_ok(results: dict) -> dict:
    assert results["jax"] is not None, results["jax_log"]
    return results["jax"]
