"""The port's mesh, split table and sharded loader against the JAX package,
in this process (the spawned worlds run in tests/test_torch_tp_engine.py).

- `mesh_dims` gives the JAX `make_mesh` shapes and errors for the same
  dicts and device counts; `validate_tp` and `parse_mesh` the JAX
  messages and results;
- the port's split table equals the axis of each PartitionSpec of the JAX
  `llama_param_shardings` (on the 8-virtual-device CPU mesh of conftest: a
  spec comparison, nothing is compiled) on a tiny llama, a pre-fused phi3
  and a qwen2 with biases and a tied table, fused and split keys compared
  part by part;
- for every weight, GGUF kind (Q4_K, Q6_K, Q8_0, Q5_K, F16) and tp in {2,
  4}, the rank shards of `load_params(tp=, tp_rank=)`, dequantized and
  joined, are bit-equal to `load_params()`'s;
- the refusals that need no world: sequence and expert parallelism without
  a mesh, axes other than dp, tp and sp, a mesh without CUDA unless the CPU
  is asked for,
  NCCL with two ranks on one device (the device count mocked to 1), a
  row split whose K/tp is not a multiple of 64; importing the package makes
  no process group;
- the JAX fault of the TP_MESH global (ROADMAP §3), in a subprocess.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.cli import parse_mesh as jax_parse_mesh
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models.llama import LlamaConfig as JLlamaConfig
from nfai_tpu.models.llama import load_params as jax_load_params
from nfai_tpu.parallel import llama_param_shardings as jax_shardings
from nfai_tpu.parallel import make_mesh as jax_make_mesh
from nfai_tpu.parallel import validate_tp as jax_validate_tp
from nfai_tpu_torch.cli import parse_mesh
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import LlamaConfig, load_params
from nfai_tpu_torch.ops.qtensor import Q4Tensor, Q8Tensor, dequant
from nfai_tpu_torch.parallel import distributed, make_mesh, mesh_dims, param_splits, validate_tp
from nfai_tpu_torch.parallel.sharding import col_rows, slice_k
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(hidden=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=1024, vocab_size=512)
SHAPES = [{}, {"tp": 2}, {"dp": 2}, {"dp": 2, "tp": -1}, {"dp": -1, "tp": 2}, {"dp": -1, "tp": -1},
          {"tp": 3}, {"dp": 3, "tp": -1}, {"dp": 2, "tp": 4}, {"tp": 1}, {"dp": 4, "tp": 2}]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared between the packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_dims_match_jax(shape, n):
    def jax_dims():
        m = jax_make_mesh(dict(shape), devices=jax.devices()[:n])
        return {"dp": m.shape["dp"], "tp": m.shape["tp"]}

    assert _outcome(lambda: mesh_dims(shape, n)) == _outcome(jax_dims)


def test_other_mesh_axes_raise():
    """Axes other than dp, tp and sp, once refused, now make the JAX
    `make_mesh`'s mesh: dp and tp first, the others in the caller's order
    (tests/test_torch_mesh_axes.py holds the layouts to the JAX device
    arrays)."""
    for shape, n in (({"ep": 2}, 2), ({"pp": 1}, 1), ({"dp": 1, "tp": 1, "sp": 1, "ep": 1}, 1)):
        want = list(dict(jax_make_mesh(dict(shape), devices=jax.devices()[:n]).shape).items())
        assert list(mesh_dims(shape, n).items()) == want
        if n == 1:  # a world of one
            assert list(make_mesh(shape).dims.items()) == want


def test_make_mesh_without_a_world_is_one_rank():
    m = make_mesh({"tp": 1})
    assert (m.dp, m.tp, m.rank, m.tp_group, m.dp_group) == (1, 1, 0, None, None)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"tp": 2})


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dims", [(8, 4, 1024, 0, 512), (12, 2, 8960, 0, 151936),
                                  (32, 8, 768, 768, 151936), (6, 3, 100, 0, 30)], ids=str)
def test_validate_tp_matches_jax(dims, tp):
    cfg = SimpleNamespace(**dict(zip(("n_heads", "n_kv_heads", "ffn_dim", "moe_ffn_dim", "vocab_size"),
                                     dims)))
    assert _outcome(lambda: validate_tp(cfg, tp)) == _outcome(lambda: jax_validate_tp(cfg, tp))


@pytest.mark.parametrize("spec", ["", "tp=2", "dp=2,tp=4", "tp=-1", "dp=2, tp=2", "sp=8"])
def test_parse_mesh_matches_jax(spec):
    assert parse_mesh(spec) == jax_parse_mesh(spec)


FUSED = {"wqkv": ("wq", "wk", "wv"), "w_gate_up": ("w_gate", "w_up"),
         "wqkv_bias": ("wq_bias", "wk_bias", "wv_bias")}


def _by_part(splits: dict) -> dict:
    out = {}
    for k, v in splits.items():
        for part in FUSED.get(k, (k,)):
            out[part] = v
    return out


def _jax_axis(spec, n_dims) -> str | None:
    """"col" where the last axis is split, "row" where the one before it
    is (the JAX layout is [..., K, N]), None where nothing is."""
    spec = tuple(spec) + (None,) * (n_dims - len(spec))
    if spec[-1] == "tp":
        return "col"
    if n_dims >= 2 and spec[-2] == "tp":
        return "row"
    return None


def _jax_splits(tree, params) -> dict:
    def axis(sh, leaf):
        s = sh.qs if hasattr(sh, "qs") else sh
        n = np.ndim(leaf.qs if hasattr(leaf, "qs") else leaf)
        return _jax_axis(s.spec, n)

    return {k: axis(v, params["layers"][k]) for k, v in tree["layers"].items()}


@pytest.mark.parametrize("case", [
    dict(quant=GGMLType.Q4_K, tied=False),
    dict(arch="phi3", fused_tensors=True, quant=GGMLType.Q4_K, tied=False),
    dict(arch="qwen2", attn_bias=True, quant=GGMLType.Q8_0, tied=True),
], ids=["llama", "phi3", "qwen2_tied"])
def test_split_table_matches_jax_shardings(tmp_path, case):
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", **{**TINY, **case})
    jg = JGGUFFile.open(path)
    jcfg = JLlamaConfig.from_gguf(jg)
    jp = jax_load_params(jg, jcfg, dtype=jnp.float32, device_put=False, fuse=True, quantized="auto", tp=2)
    tree = jax_shardings(jax_make_mesh({"tp": 2}, devices=jax.devices()[:2]), jp)
    with GGUFFile.open(path) as g:
        mine = param_splits(load_params(g, LlamaConfig.from_gguf(g), dtype=torch.float32, tp=2, tp_rank=0))
    assert _by_part(mine["layers"]) == _by_part(_jax_splits(tree, jp))
    assert mine["lm_head"] == _jax_axis(tree["lm_head"].qs.spec if hasattr(tree["lm_head"], "qs")
                                        else tree["lm_head"].spec, 2) == "col"
    # a tied quantized table: JAX keeps no embed (it lives under the head), nor does the port
    assert mine["tied"] == (jp["embed"] is None) == case["tied"]
    if not case["tied"]:
        assert tree["embed"].spec == jax.sharding.PartitionSpec(None, None)  # replicated, as the port's
    jg.close()


def _dense(w, layer=None) -> np.ndarray:
    if isinstance(w, (Q4Tensor, Q8Tensor)):
        w = dequant(w if layer is None else w.layer(layer))
    elif layer is not None:
        w = w[layer]
    return w.float().numpy()


def _sections(key, cfg):
    hd = cfg.head_dim
    return {"wqkv": (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd),
            "w_gate_up": (cfg.ffn_dim, cfg.ffn_dim)}.get(key)


def _join_cols(parts, sections, tp):
    """Rank shards [.., N/tp, K] (each [s0/tp | s1/tp | ..] for a fused
    weight) → [.., N, K]."""
    if sections is None:
        return np.concatenate(parts, axis=-2)
    out, off = [], 0
    for s in sections:
        w = s // tp
        out.append(np.concatenate([p[..., off:off + w, :] for p in parts], axis=-2))
        off += w
    return np.concatenate(out, axis=-2)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K", "Q8_0", "Q5_K", "F16"])
def test_rank_shards_join_to_the_single_device_params(tmp_path, kind, tp):
    """Every weight: the ranks' shards, dequantized and joined along their
    split axis, equal the single-device params bit for bit; the replicated
    entries are equal on every rank. The head is untied here; the tied
    table (vocab-split) is the Q6_K case's second half."""
    for tied in (False, True) if kind == "Q6_K" else (False,):
        path = make_tiny_llama_gguf(tmp_path / f"m{tied}.gguf", quant=GGMLType[kind], tied=tied, **TINY)
        with GGUFFile.open(path) as g:
            cfg = LlamaConfig.from_gguf(g)
            full = load_params(g, cfg, dtype=torch.float32)
            shards = [load_params(g, cfg, dtype=torch.float32, tp=tp, tp_rank=r) for r in range(tp)]
        splits = param_splits(full)["layers"]
        for key, w in full["layers"].items():
            for layer in range(cfg.n_layers):
                want = _dense(w, layer)
                parts = [_dense(s["layers"][key], layer) for s in shards]
                if splits[key] == "col":
                    got = (np.concatenate(parts, axis=-1) if key.endswith("_bias")
                           else _join_cols(parts, _sections(key, cfg), tp))
                elif splits[key] == "row":
                    got = np.concatenate(parts, axis=-1)
                else:
                    assert all(np.array_equal(p, want) for p in parts), key
                    continue
                assert np.array_equal(got, want), (key, layer)
        head = np.concatenate([_dense(s["lm_head"]) for s in shards], axis=0)
        assert np.array_equal(head, _dense(full["lm_head"]))
        for s in shards:
            assert type(s["lm_head"]) is type(full["lm_head"])  # quantized stays quantized per shard
            if tied:
                assert s["embed"] is None or s["embed"] is s["lm_head"]
            else:
                assert torch.equal(s["embed"], full["embed"])
            for name in ("final_norm", "inv_freq"):
                assert torch.equal(s[name], full[name])


def test_row_split_needs_k_per_rank_multiple_of_64(tmp_path):
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", quant=GGMLType.Q8_0,
                                **{**TINY, "n_kv_heads": 8})  # wo: K = 256, 32 a rank at tp = 8
    with GGUFFile.open(path) as g, pytest.raises(ValueError, match="K/tp % 64 == 0"):
        load_params(g, LlamaConfig.from_gguf(g), dtype=torch.float32, tp=8, tp_rank=0)


def test_slice_k_and_col_rows():
    q = Q4Tensor(torch.arange(4 * 64, dtype=torch.uint8).reshape(4, 64), torch.rand(4, 4),
                 torch.rand(4, 4), 128, 4)
    part = slice_k(q, 64, 128)
    assert part.k == 64 and part.qs.is_contiguous() and torch.equal(dequant(part), dequant(q)[:, 64:])
    with pytest.raises(ValueError, match="scale group"):
        slice_k(q, 16, 80)
    assert col_rows(8, 2, 1).tolist() == [4, 5, 6, 7]
    assert col_rows(12, 2, 1, (8, 2, 2)).tolist() == [4, 5, 6, 7, 9, 11]


@pytest.mark.parametrize("flag", ["seq_parallel", "expert_parallel"])
def test_parallel_flags_without_a_mesh_raise(tmp_path, flag):
    """The JAX engine ignores them without a mesh; the port refuses them."""
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", **TINY)
    with pytest.raises(ValueError, match=rf"{flag}.*needs a mesh \(no mesh_shape is set\)"):
        InferenceEngine(path, EngineConfig(dtype="float32", **{flag: True}), device="cpu")


def test_mesh_without_cuda_raises_unless_the_cpu_is_asked_for(tmp_path):
    path = make_tiny_llama_gguf(tmp_path / "m.gguf", **TINY)
    cfg = EngineConfig(dtype="float32", max_seq_len=64, mesh_shape={"tp": 1})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(path, cfg)
    e = InferenceEngine(path, cfg, device="cpu")  # a world of one: the single-device engine
    assert e.comm is None and e.mesh.tp == 1


def test_nccl_refuses_two_ranks_on_one_device(tmp_path, monkeypatch):
    """Two ranks of one host on a (mocked) single card under NCCL: both
    raise before any group is made, naming gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    errors = {}

    def rank(r):
        try:
            distributed.init_distributed(f"file://{tmp_path / 'rdv'}", 2, r, backend="nccl", timeout_s=30)
        except Exception as e:  # noqa: BLE001 - checked below
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    [t.start() for t in threads]
    [t.join(60) for t in threads]
    assert sorted(errors) == [0, 1]
    assert all(isinstance(e, RuntimeError) and "gloo" in str(e) for e in errors.values()), errors
    assert not torch.distributed.is_initialized()


def test_init_distributed_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("NFAI_COORD", raising=False)
    assert distributed.init_distributed() is False


def _world_of_one(argv) -> int:
    distributed.init_distributed(f"file://{argv[0]}", 1, 0, backend="gloo", timeout_s=30)
    return 0


def test_ranks_leave_the_world_before_they_exit(tmp_path):
    """A spawned rank's main (`_rank_main`) and rank 0's `join_local`
    destroy their process groups: a rank that exits with its gloo groups
    alive may abort in their threads' teardown ("terminate called without
    an active exception", seen under load in the CLI's tp = 2 world)."""
    with pytest.raises(SystemExit) as stop:
        distributed._rank_main(f"{__name__}:_world_of_one", [str(tmp_path / "a")], {})
    assert stop.value.code == 0 and not torch.distributed.is_initialized()
    _world_of_one([str(tmp_path / "b")])
    try:
        assert torch.distributed.is_initialized()
        assert distributed.join_local([]) == [] and not torch.distributed.is_initialized()
    finally:
        distributed.leave_world()


def test_importing_the_package_makes_no_group():
    code = ("import torch.distributed as d, nfai_tpu_torch.parallel, nfai_tpu_torch.cli, "
            "nfai_tpu_torch.server; print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "False"


JAX_TP_MESH_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
from nfai_tpu.config import EngineConfig, SamplingParams
from nfai_tpu.gguf import GGMLType
from nfai_tpu.models.testing import make_tiny_llama_gguf
from nfai_tpu.ops import qmatmul as qm
from nfai_tpu.runtime.engine import InferenceEngine
calls = []
inner = qm._qmatmul_tp
qm._qmatmul_tp = lambda *a, **k: calls.append(1) or inner(*a, **k)
p = make_tiny_llama_gguf(sys.argv[2], hidden=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=1024,
                         vocab_size=512, quant=GGMLType.Q4_K, tied=False)
cfg = dict(dtype="float32", max_seq_len=128)
s = SamplingParams(temperature=0.0, max_new_tokens=2)
tp = InferenceEngine(str(p), EngineConfig(mesh_shape={"dp": 4, "tp": 2}, **cfg))
list(tp.generate(list(range(5, 25)), s))
before = len(calls)
InferenceEngine(str(p), EngineConfig(**cfg))  # a later single-device engine in the same process
list(tp.generate(list(range(5, 45)), s))  # a new prefill bucket: the tp engine traces again
print(before, len(calls) - before, qm.TP_MESH is None)
'''


def test_jax_fault_a_later_engine_resets_the_tp_mesh(tmp_path):
    """The JAX engine keeps the mesh in a module global (`ops.qmatmul.TP_MESH`,
    set by every engine: nfai_tpu/runtime/engine.py:179, :193). A plain
    engine built after a tp engine clears it, and what the tp engine traces
    afterwards runs its tp-marked weights outside shard_map (no per-shard
    kernel: GSPMD gathers each weight whole; the tokens stay right). Run in
    a subprocess (tests/test_engine_parallel.py: shard_map compiles trip an
    XLA:CPU bug in-process). The port keeps the group on the engine
    (tests/test_torch_tp_engine.py::test_two_engines_in_one_process)."""
    out = subprocess.run([sys.executable, "-c", JAX_TP_MESH_SCRIPT, str(ROOT), str(tmp_path / "m.gguf")],
                         capture_output=True, text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    before, after, cleared = out.stdout.split()[-3:]
    assert int(before) > 0 and int(after) == 0 and cleared == "True"
