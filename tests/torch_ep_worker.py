"""One rank of a gloo world for tests/test_torch_expert_parallel.py: a MoE
model under tp on the CPU, its experts split over the expert axis
(`expert_parallel`) or over their ffn columns (the default), against the
port's single-device engine in the same process.

    python tests/torch_ep_worker.py WORLD RANK SIZE COORD CONFIG.json OUT_DIR

CONFIG.json holds the GGUF paths ("moe": F32 experts, the dense route;
"moe_q8": Q8_0 experts, the grouped route), the mesh and whether to run the
BatchEngine and HTTP checks. The rank writes OUT_DIR/WORLD_RANK.json
(tokens, relative logit errors, collective counts, expert bytes) and rank 0
OUT_DIR/WORLD_arrays.npz (prefill logits) for the test to compare, and exits
non-zero on any failure. Imports torch and the port only.
"""
import dataclasses
import json
import os
import sys
import threading
import time
import traceback
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from nfai_tpu_torch.config import EngineConfig, SamplingParams  # noqa: E402
from nfai_tpu_torch.models.llama import decode_step  # noqa: E402
from nfai_tpu_torch.parallel import init_distributed  # noqa: E402
from nfai_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState  # noqa: E402

IDS = list(range(9, 49))
CFG = dict(dtype="float32", max_seq_len=128)
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
EXPERTS = ("w_gate_exps", "w_up_exps", "w_down_exps")


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def expert_bytes(params) -> int:
    total = 0
    for k in EXPERTS:
        w = params["layers"][k]
        leaves = [w] if isinstance(w, torch.Tensor) else [getattr(w, f.name) for f in dataclasses.fields(w)]
        total += sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))
    return total


def model_checks(path, mesh, arrays, name, ep) -> dict:
    tp = InferenceEngine(path, EngineConfig(mesh_shape=mesh, expert_parallel=ep, **CFG), device="cpu")
    one = InferenceEngine(path, EngineConfig(**CFG), device="cpu")
    lt, ct = tp.prefill(tp.new_cache(1), IDS)
    lo, co = one.prefill(one.new_cache(1), IDS)
    arrays[f"{name}_prefill"] = lt
    errs = [rel(lt, lo)]
    pos = len(IDS)
    for tok in (5, 77, 3, 41):
        tp.comm.reset()
        lt, ct = decode_step(tp.params, tp.model_cfg, torch.tensor([tok]), torch.tensor([pos]), ct)
        lo, co = decode_step(one.params, one.model_cfg, torch.tensor([tok]), torch.tensor([pos]), co)
        errs.append(rel(lt, lo))
        pos += 1
    step = dict(tp.comm.counts)
    shapes = {k: list((w if isinstance(w, torch.Tensor) else w.qs).shape)
              for k, w in ((k, tp.params["layers"][k]) for k in EXPERTS)}
    return {"tp_tokens": list(tp.generate(IDS, GREEDY)), "one_tokens": list(one.generate(IDS, GREEDY)),
            "logit_errs": errs, "step_collectives": step, "n_layers": tp.model_cfg.n_layers,
            "expert_bytes": expert_bytes(tp.params), "one_expert_bytes": expert_bytes(one.params),
            "shapes": shapes, "moe_ffn_dim": tp.model_cfg.moe_ffn_dim,
            "expert_parallel": bool(tp.params.get("expert_parallel"))}


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
    """The paged BatchEngine under expert parallelism against the
    single-device one."""
    s = SamplingParams(temperature=0.0, max_new_tokens=8)
    prompts = [IDS + [60 + i] for i in range(3)] + [list(range(100, 130))]
    cfg = dict(CFG, page_size=16)
    want = None
    if root:
        be0 = BatchEngine(InferenceEngine(path, EngineConfig(**cfg), device="cpu"), max_batch=4)
        want = _drain(be0, [be0.submit(p, s) for p in prompts], True)
    be = BatchEngine(InferenceEngine(path, EngineConfig(mesh_shape=mesh, expert_parallel=True, **cfg),
                                     device="cpu"), max_batch=4)
    got = _drain(be, [be.submit(p, s) for p in prompts] if root else [], root)
    return {"want": want, "got": got}


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def http_checks(path, mesh, root) -> dict:
    """One completion through the server on rank 0 (rank 1 follows), under
    expert parallelism, and the same on a single-device server."""
    from nfai_tpu_torch import server as srv

    out = {}

    def complete(httpd):
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            body = {"prompt": "The quick brown fox", "max_tokens": 8, "temperature": 0}
            return json.loads(_post(base, "/v1/completions", body).read())["choices"][0]["text"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            httpd.state.batch.close()
            thread.join(timeout=30)

    if root:
        out["one"] = complete(srv.serve(path, port=0, engine_config=EngineConfig(**CFG), max_batch=2,
                                        device="cpu"))
    httpd = srv.serve(path, port=0, engine_config=EngineConfig(mesh_shape=mesh, expert_parallel=True, **CFG),
                      max_batch=2, device="cpu")
    if root:
        out["ep"] = complete(httpd)
    else:
        out["followed"] = httpd is None
    return out


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
        for model in ("moe", "moe_q8"):
            for mode in ("ep", "ffn"):
                result[f"{model}_{mode}"] = model_checks(paths[model], mesh, arrays, f"{model}_{mode}", mode == "ep")
        if conf.get("full"):
            result["batch"] = batch_checks(paths["moe_q8"], mesh, root)
            result["http"] = http_checks(paths["moe"], mesh, root)
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
