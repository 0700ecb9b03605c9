"""Mesh axes beyond dp, tp and sp on the CPU.

- The layout: `mesh_dims`, `coords`, `rank_coords` and `axis_ranks` against
  the JAX `make_mesh(...).devices` on the suite's 8 virtual CPU devices:
  rank r sits where the JAX mesh puts device r, and each axis's group is
  the devices along that axis, for extra axes in both orders, "sp" before
  and after another axis, several extra axes and an extra axis of -1; the
  sizes and errors of `mesh_dims` are the JAX function's.
- A gloo world of two ranks (tests/torch_tp_worker.py "x2", mesh {"tp": 1,
  "x": 2}, f32, the tiny llama of tests/test_torch_tp_engine.py): every
  axis has its group (x the two ranks, dp and tp each rank alone), the
  axis replicates (no collective in the params), and each rank's prefill
  logits and greedy tokens are bit for bit the single-device engine's, as
  are a paged BatchEngine's (rank 0 steps, rank 1 follows).
- `cli --mesh tp=1,x=2 --device cpu` answers piped input as the
  single-device CLI does.
"""
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from nfai_tpu.parallel import make_mesh as jax_make_mesh
from nfai_tpu_torch.parallel import mesh_dims
from nfai_tpu_torch.parallel.mesh import axis_ranks, coords, rank_coords
from torch_worlds import ROOT, ranks_ok, run_worlds, tiny_llama

SHAPES = [{"tp": 2, "x": 4}, {"x": 4, "tp": 2}, {"dp": 2, "x": 2, "tp": 2}, {"x": 2, "dp": 2, "tp": 2},
          {"x": 2, "sp": 4}, {"sp": 4, "x": 2}, {"dp": 2, "sp": 2, "x": 2}, {"dp": 2, "x": 2, "sp": 2},
          {"tp": 2, "sp": 2, "x": 2}, {"x": 2, "y": 2, "tp": 2}, {"ep": 8}, {"tp": -1, "x": 2},
          {"x": -1, "tp": 2}, {"pp": 2, "sp": 2, "dp": 2}]
ERROR_SHAPES = [{"x": 3}, {"x": -1, "y": -1}, {"x": 2, "tp": 3}, {"x": 16}, {"x": -1, "tp": 3}]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared between the packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_layout_matches_the_jax_device_array(shape):
    mesh = jax_make_mesh(dict(shape), devices=jax.devices())
    dims = mesh_dims(shape, 8)
    assert list(dims.items()) == list(dict(mesh.shape).items())
    grid = mesh.devices
    for idx in np.ndindex(grid.shape):
        rank = grid[idx].id
        assert tuple(coords(dims, rank).values()) == idx
        at = dict(zip(dims, idx))
        assert rank_coords(dims, rank) == (at["dp"], at["tp"], at.get("sp", 0))
        for a, axis in enumerate(dims):
            line = [grid[idx[:a] + (i,) + idx[a + 1:]].id for i in range(grid.shape[a])]
            assert axis_ranks(dims, axis, rank) == line
        assert axis_ranks(dims, "absent", rank) == [rank]


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("shape", ERROR_SHAPES + SHAPES[:4], ids=str)
def test_mesh_dims_sizes_and_errors_match_jax(shape, n):
    def jax_dims():
        return list(dict(jax_make_mesh(dict(shape), devices=jax.devices()[:n]).shape).items())

    assert _outcome(lambda: list(mesh_dims(shape, n).items())) == _outcome(jax_dims)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("x")
    return run_worlds(d, {"x2": ({"tp": 1, "x": 2}, 2)}, {"llama": tiny_llama(d)})


def test_every_axis_has_its_group(run):
    for res in ranks_ok(run, "x2"):
        r, x = res["rank"], res["x"]
        assert x["dims"] == {"dp": 1, "tp": 1, "x": 2}
        assert x["groups"] == {"dp": [r], "tp": [r], "x": [0, 1]}
        assert x["coords"] == [0, 0, r]
        assert not x["params_comm"]  # nothing is split over x


def test_extra_axis_replicates_bit_for_bit(run):
    for res in ranks_ok(run, "x2"):
        x = res["x"]
        assert x["prefill_equal"]
        assert x["tokens"] == x["one_tokens"] and len(x["tokens"]) == 12
    root = run["x2"][0]["x"]
    assert root["batch"] == root["batch_one"] and all(len(t) == 8 for t in root["batch"])


def test_cli_extra_axis_piped(run, capsys, monkeypatch):
    """`--mesh tp=1,x=2` spawns rank 1 and answers as one device does."""
    from nfai_tpu_torch import cli

    args = ["--gguf", run["paths"]["llama"], "--device", "cpu", "--dtype", "float32", "--temp", "0",
            "--max-new-tokens", "8", "--max-seq", "128"]
    text = "hello there\nwhat next\n"
    env = dict(os.environ, OMP_NUM_THREADS="1", NFAI_DIST_TIMEOUT="120")
    env.pop("NFAI_COORD", None)
    out = subprocess.run([sys.executable, "-m", "nfai_tpu_torch.cli", *args, "--mesh", "tp=1,x=2"],
                         input=text, capture_output=True, text=True, cwd=ROOT, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main(args) == 0
    want = capsys.readouterr().out
    assert out.stdout == want and len(want.splitlines()) == 2
