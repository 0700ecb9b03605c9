"""One rank of a gloo world for tests/test_torch_seq_parallel.py: the port's
sequence-parallel attention functions and engine on the CPU against the
port's single-device engine in the same process.

    python tests/torch_sp_worker.py WORLD RANK SIZE COORD CONFIG.json OUT_DIR

CONFIG.json holds the GGUF paths, the mesh, the attention inputs (an npz of
q, k, v, lengths) and whether to run the BatchEngine, session and error
checks. The rank writes OUT_DIR/WORLD_RANK.json (tokens, relative logit
errors, collective counts, cache shapes) and rank 0 OUT_DIR/WORLD_arrays.npz
(the attention outputs, the prefill logits) for the test to compare, and
exits non-zero on any failure. Imports torch and the port only.
"""
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from nfai_tpu_torch.config import EngineConfig, SamplingParams  # noqa: E402
from nfai_tpu_torch.models.llama import decode_step  # noqa: E402
from nfai_tpu_torch.parallel import (  # noqa: E402
    init_distributed, sp_decode_attention, sp_decode_attention_merged, sp_decode_attention_ring,
)
from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine  # noqa: E402
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState  # noqa: E402

IDS = list(range(10, 110))  # 100 tokens: the prefill spans two 64-slot slices
CFG = dict(dtype="float32", max_seq_len=128, prefill_chunk=32)
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=12)


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def attention_checks(inp, sp_comm, arrays) -> dict:
    """This rank's S slice of k and v through the stats merge, the ring and
    the merged-lane adapter (both); the outputs go to `arrays`."""
    q, k, v, lengths = (torch.from_numpy(inp[n]) for n in ("q", "k", "v", "lengths"))
    b, s, hkv, d = k.shape
    sl = s // sp_comm.size
    lo = sp_comm.rank * sl
    ks, vs = k[:, lo:lo + sl].contiguous(), v[:, lo:lo + sl].contiguous()
    sp_comm.reset()
    n = sp_comm.size
    arrays[f"stats_{n}"] = sp_decode_attention(q, ks, vs, lengths, sp_comm)
    stats_counts = dict(sp_comm.counts)
    sp_comm.reset()
    arrays[f"ring_{n}"] = sp_decode_attention_ring(q, ks, vs, lengths, sp_comm)
    ring_counts = dict(sp_comm.counts)
    merged = (ks.reshape(b, sl, hkv * d), vs.reshape(b, sl, hkv * d))
    for ring in (False, True):
        arrays[f"merged_{'ring' if ring else 'stats'}_{n}"] = sp_decode_attention_merged(
            q, merged, lengths, hkv, sp_comm, ring=ring)
    return {"stats_counts": stats_counts, "ring_counts": ring_counts}


def model_checks(path, mesh, arrays, name, **kw) -> dict:
    """Greedy tokens of the sp engine and of the single-device one, the
    relative logit error of the prefill and of 4 teacher-forced decode
    steps, a decode step's collectives and the rank's cache."""
    cfg = dict(CFG, **kw)
    sp = InferenceEngine(path, EngineConfig(mesh_shape=mesh, seq_parallel=True, **cfg), device="cpu")
    one = InferenceEngine(path, EngineConfig(**cfg), device="cpu")
    cache = sp.new_cache(1)
    lt, ct = sp.prefill(cache, IDS)
    lo, co = one.prefill(one.new_cache(1), IDS)
    arrays[f"{name}_prefill"] = lt
    errs = [rel(lt, lo)]
    pos = len(IDS)
    for tok in (5, 77, 3, 41):
        sp.sp_comm.reset()
        if sp.comm is not None:
            sp.comm.reset()
        lt, ct = decode_step(sp.params, sp.model_cfg, torch.tensor([tok]), torch.tensor([pos]), ct)
        lo, co = decode_step(one.params, one.model_cfg, torch.tensor([tok]), torch.tensor([pos]), co)
        errs.append(rel(lt, lo))
        pos += 1
    steps = {"sp": dict(sp.sp_comm.counts), "tp": dict(sp.comm.counts) if "comm" in sp.params else {}}
    return {"sp_tokens": list(sp.generate(IDS, GREEDY)), "one_tokens": list(one.generate(IDS, GREEDY)),
            "logit_errs": errs, "step_collectives": steps, "n_layers": sp.model_cfg.n_layers,
            "cache": [list(cache.k.shape), cache.offset, cache.max_seq, cache.nbytes],
            "one_cache_bytes": one.new_cache(1).nbytes}


def _drain(be, reqs, root):
    if not root:
        be.follow()
        return None
    for _ in range(2000):
        if be.step() == 0 and all(r.state in (RequestState.FINISHED, RequestState.FAILED) for r in reqs):
            break
    be.close()
    return [list(r.output_ids) for r in reqs]


def batch_checks(path, mesh, root) -> dict:
    """The BatchEngine under sp, dense (the split cache) and paged (the pool
    whole on every sp rank), against the single-device BatchEngine."""
    s = SamplingParams(temperature=0.0, max_new_tokens=8)
    prompts = [IDS[:60 + 9 * i] for i in range(3)] + [list(range(200, 230))]
    out = {}
    for paged in (False, True):
        kw = dict(max_batch=4, paged=paged)
        cfg = dict(CFG, page_size=16)
        eng = InferenceEngine(path, EngineConfig(mesh_shape=mesh, seq_parallel=True, **cfg), device="cpu")
        want = None
        if root:
            one = InferenceEngine(path, EngineConfig(**cfg), device="cpu")
            be0 = BatchEngine(one, **kw)
            want = _drain(be0, [be0.submit(p, s) for p in prompts], True)
        be = BatchEngine(eng, **kw)
        got = _drain(be, [be.submit(p, s) for p in prompts] if root else [], root)
        out["paged" if paged else "dense"] = {"want": want, "got": got}
    return out


def session_checks(path, mesh, out_dir) -> dict:
    """A ChatSession saved under sp (the S slices gathered, one file from
    rank 0) resumes on the sp engine and on a single-device one as the live
    session goes on."""
    cfg = dict(CFG, max_seq_len=256)  # two slices of 128: the first turn fills more than one
    sp = InferenceEngine(path, EngineConfig(mesh_shape=mesh, seq_parallel=True, **cfg), device="cpu")
    one = InferenceEngine(path, EngineConfig(**cfg), device="cpu")
    s = SamplingParams(temperature=0.0, max_new_tokens=6)
    live = ChatSession(sp, s)
    live.send("hello there, this first turn is long enough to reach the second slice of the cache.")
    file = os.path.join(out_dir, "sp_session.npz")
    live.save(file)
    sp.comm.broadcast_object()  # the file is written before any rank reads it
    return {"cached": len(live._cached_ids), "live": live.send("and then?"),
            "sp_loaded": ChatSession.load(sp, file, s).send("and then?"),
            "one_loaded": ChatSession.load(one, file, s).send("and then?"),
            "gathered": dict(sp.sp_comm.counts)}


def error_checks(path, mesh) -> dict:
    try:
        InferenceEngine(path, EngineConfig(mesh_shape=mesh, seq_parallel=True, **{**CFG, "max_seq_len": 127}),
                        device="cpu")
        return {"max_seq_len": "no error"}
    except ValueError as e:
        return {"max_seq_len": str(e)}


def main(argv) -> int:
    world, rank, size, coord, config, out_dir = argv
    rank, size = int(rank), int(size)
    with open(config) as f:
        conf = json.load(f)
    paths, mesh = conf["paths"], conf["mesh"]
    init_distributed(coord, size, rank, backend="gloo", timeout_s=conf.get("timeout_s", 120))
    root = rank == 0
    result, arrays = {"rank": rank}, {}
    t0 = time.perf_counter()
    try:
        probe = InferenceEngine(paths["llama"], EngineConfig(mesh_shape=mesh, seq_parallel=True, **CFG),
                                device="cpu")
        result["mesh"] = {**probe.mesh.dims, "rank": probe.mesh.rank, "sp_rank": probe.mesh.sp_rank,
                          "tp_rank": probe.mesh.tp_rank}
        with np.load(conf["attention"]) as z:
            result["attention"] = attention_checks({k: z[k] for k in z.files}, probe.sp_comm, arrays)
        del probe
        result["llama"] = model_checks(paths["llama"], mesh, arrays, "llama")
        result["int8"] = model_checks(paths["llama"], mesh, arrays, "int8", kv_dtype="int8")
        result["gemma2"] = model_checks(paths["gemma2"], mesh, arrays, "gemma2")
        if conf.get("full"):
            result["batch"] = batch_checks(paths["llama"], mesh, root)
            result["session"] = session_checks(paths["llama"], mesh, out_dir)
            result["errors"] = error_checks(paths["llama"], mesh)
        result["ok"] = True
    except Exception:  # noqa: BLE001 - the test reads the traceback
        result["ok"] = False
        result["error"] = traceback.format_exc()
    result["seconds"] = time.perf_counter() - t0
    if root:
        np.savez(os.path.join(out_dir, f"{world}_arrays.npz"),
                 **{k: v.detach().float().numpy() for k, v in arrays.items()})
    with open(os.path.join(out_dir, f"{world}_{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
