"""One rank of a gloo world for tests/test_torch_tp_engine.py: the port's
tensor-parallel engine, BatchEngine and server on the CPU against the
port's single-device engine in the same process.

    python tests/torch_tp_worker.py WORLD RANK SIZE COORD CONFIG.json OUT_DIR

WORLD names the checks ("tp2": every check below; "tp4" and
"dp2tp2": the tiny llama's tokens and logits). CONFIG.json holds the GGUF
paths and the mesh; the rank writes OUT_DIR/WORLD_RANK.json with what it
measured (tokens, prompt ids, relative logit errors, collective counts)
for the test to compare, and exits non-zero on any failure. Imports torch
and the port only.
"""
import json
import os
import sys
import threading
import time
import traceback
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from nfai_tpu_torch.config import EngineConfig, SamplingParams  # noqa: E402
from nfai_tpu_torch.models.llama import decode_step  # noqa: E402
from nfai_tpu_torch.parallel import init_distributed, make_mesh  # noqa: E402
from nfai_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState  # noqa: E402

PROMPT = "The quick brown fox jumps over the lazy dog, and then it runs far away."
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=12)


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def engines(path, mesh, **kw):
    cfg = dict(dtype="float32", max_seq_len=128, **kw)
    tp = InferenceEngine(path, EngineConfig(mesh_shape=mesh, **cfg), device="cpu")
    one = InferenceEngine(path, EngineConfig(**cfg), device="cpu")
    return tp, one


def model_checks(path, mesh, **kw) -> dict:
    """Greedy tokens of both engines, and the relative logit error of the
    prefill and of 4 teacher-forced decode steps."""
    tp, one = engines(path, mesh, **kw)
    ids = one.tokenizer.encode(PROMPT)
    lt, ct = tp.prefill(tp.new_cache(1), ids)
    lo, co = one.prefill(one.new_cache(1), ids)
    errs = [rel(lt, lo)]
    pos = len(ids)
    for tok in (5, 77, 3, 41):
        tp.comm.reset()
        lt, ct = decode_step(tp.params, tp.model_cfg, torch.tensor([tok]), torch.tensor([pos]), ct)
        lo, co = decode_step(one.params, one.model_cfg, torch.tensor([tok]), torch.tensor([pos]), co)
        errs.append(rel(lt, lo))
        pos += 1
    return {"ids": ids, "step_collectives": dict(tp.comm.counts), "tp_tokens": list(tp.generate(ids, GREEDY)),
            "one_tokens": list(one.generate(ids, GREEDY)), "logit_errs": errs,
            "local_heads": [tp.model_cfg.n_heads, tp.model_cfg.n_kv_heads, tp.model_cfg.ffn_dim],
            "cache_kvd": tp.new_cache(1).k.shape[-1]}


def llama_checks(path, mesh) -> dict:
    out = model_checks(path, mesh)
    tp, one = engines(path, mesh)
    ids = out["ids"]
    out["n_layers"] = tp.model_cfg.n_layers
    # sampled: one seed (rank 0's, broadcast) on every rank
    sampled = SamplingParams(temperature=0.9, top_k=40, max_new_tokens=12)
    out["sampled"] = list(tp.generate(ids, sampled))
    out["sampled_seeded"] = list(tp.generate(ids, SamplingParams(temperature=0.9, seed=3, max_new_tokens=12)))
    out["sampled_seeded_one"] = list(one.generate(ids, SamplingParams(temperature=0.9, seed=3,
                                                                     max_new_tokens=12)))
    # two engines in one process: a tp engine, a plain one built after it, the tp engine again
    first = list(tp.generate(ids, GREEDY))
    later = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=128), device="cpu")
    out["two_engines"] = [first, list(later.generate(ids, GREEDY)), list(tp.generate(ids, GREEDY))]
    return out


def session_and_eval_checks(path, mesh, out_dir, root) -> dict:
    """A ChatSession saved under the mesh (rank 0 writes the gathered cache)
    and loaded by a single-device engine and by the tp engine continues as
    the uninterrupted session; perplexity on the tp engine."""
    from nfai_tpu_torch.eval import perplexity
    from nfai_tpu_torch.runtime.engine import ChatSession

    tp, one = engines(path, mesh)
    s = SamplingParams(temperature=0.0, max_new_tokens=6)
    live = ChatSession(tp, s)
    live.send("hello there")
    file = os.path.join(out_dir, "tp_session.npz")
    live.save(file)
    tp.comm.broadcast_object()  # the file is written before any rank reads it
    out = {"live": live.send("and then?"), "tp_loaded": ChatSession.load(tp, file, s).send("and then?"),
           "one_loaded": ChatSession.load(one, file, s).send("and then?")}
    ids = one.tokenizer.encode(PROMPT * 4)
    out["ppl"] = [perplexity(e.params, e.model_cfg, ids, window=64, dtype=torch.float32) for e in (tp, one)]
    return out


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
    """The BatchEngine at tp: prefix sharing, then a starved pool that
    preempts, against the single-device BatchEngine's tokens."""
    tp, one = engines(path, mesh, page_size=16, prefill_chunk=32)
    base = list(range(10, 50))
    shared = [base + [60 + i] for i in range(4)] + [list(range(100 + 9 * i, 120 + 9 * i)) for i in range(4)]
    # two 20-token prompts of 24 new tokens each in a pool of 4 pages of 16: one is preempted
    starved = [list(range(300, 320)), list(range(330, 350))]
    cases = {"shared": (shared, 8, dict(max_batch=4)),
             "starved": (starved, 24, dict(max_batch=2, pool_tokens=64, decode_chunk=4))}
    out = {}
    for name, (prompts, n_new, kw) in cases.items():
        s = SamplingParams(temperature=0.0, max_new_tokens=n_new)
        want = None
        if root:
            be0 = BatchEngine(one, **kw)
            want = _drain(be0, [be0.submit(p, s) for p in prompts], True)
            want = {"batch": want, "generate": [list(one.generate(p, s)) for p in prompts]}
        be = BatchEngine(tp, **kw)
        got = _drain(be, [be.submit(p, s) for p in prompts] if root else [], root)
        out[name] = {"want": want, "got": got, "preemptions": be.preemptions, "n_new": n_new}
    return out


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _http(httpd) -> dict:
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        done = json.loads(_post(base, "/v1/completions", {"prompt": PROMPT, "max_tokens": 10,
                                                           "temperature": 0}).read())
        events = [line.decode().strip()[6:] for line in _post(base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi there"}], "max_tokens": 10,
            "temperature": 0, "stream": True}) if line.decode().startswith("data: ")]
        pieces = [json.loads(e)["choices"][0]["delta"].get("content", "") for e in events[:-1]]
        return {"completion": done["choices"][0]["text"], "chat": "".join(pieces), "done": events[-1]}
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.state.batch.close()
        thread.join(timeout=30)


def server_checks(path, mesh, root) -> dict:
    from nfai_tpu_torch import server as srv

    cfg = dict(max_seq_len=128, dtype="float32")
    out = {}
    if root:
        out["one"] = _http(srv.serve(path, port=0, engine_config=EngineConfig(**cfg), max_batch=2,
                                     device="cpu"))
    httpd = srv.serve(path, port=0, engine_config=EngineConfig(mesh_shape=mesh, **cfg), max_batch=2,
                      device="cpu")
    if root:
        out["tp"] = _http(httpd)
    else:
        out["followed"] = httpd is None
    return out


def _same_greedy(path, mesh, **kw) -> str:
    tp = InferenceEngine(path, EngineConfig(mesh_shape=mesh, dtype="float32", max_seq_len=128, **kw),
                         device="cpu")
    one = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=128), device="cpu")
    ids = one.tokenizer.encode(PROMPT)
    return f"greedy equal {list(tp.generate(ids, GREEDY)) == list(one.generate(ids, GREEDY))}"


def refusals(paths, mesh) -> dict:
    """What a mesh does not run yet raises NotImplementedError (ROADMAP
    2(c)); the options ported since (an "sp" axis, seq_parallel's checks,
    expert_parallel, a MoE model under tp) record what they did."""
    out = {}

    def expect(name, fn):
        try:
            out[name] = f"ok: {fn()}"
        except NotImplementedError as e:
            out[name] = "NotImplementedError: " + str(e)
        except Exception as e:  # noqa: BLE001 - recorded for the test
            out[name] = f"{type(e).__name__}: {e}"

    llama = paths["llama"]
    cfg = dict(dtype="float32", max_seq_len=128)
    expect("sp_axis", lambda: (lambda m: f"dp={m.dp} tp={m.tp} sp={m.sp} sp_rank={m.sp_rank}")(make_mesh({"sp": 2})))
    expect("seq_parallel", lambda: InferenceEngine(
        llama, EngineConfig(mesh_shape=mesh, seq_parallel=True, **cfg), device="cpu"))
    expect("expert_parallel", lambda: _same_greedy(paths["moe"], mesh, expert_parallel=True))
    expect("moe", lambda: _same_greedy(paths["moe"], mesh))
    expect("draft", lambda: InferenceEngine(
        llama, EngineConfig(mesh_shape=mesh, speculative="draft", draft_gguf=llama, **cfg), device="cpu"))
    os.environ["NFAI_Q8V3"] = "1"
    try:
        expect("q8v3", lambda: InferenceEngine(llama, EngineConfig(mesh_shape=mesh, **cfg), device="cpu"))
    finally:
        del os.environ["NFAI_Q8V3"]
    return out


def main(argv) -> int:
    world, rank, size, coord, config, out_dir = argv
    rank, size = int(rank), int(size)
    with open(config) as f:
        conf = json.load(f)
    paths, mesh = conf["paths"], conf["mesh"]
    init_distributed(coord, size, rank, backend="gloo", timeout_s=conf.get("timeout_s", 120))
    root = rank == 0
    result = {"rank": rank}
    t0 = time.perf_counter()
    try:
        result["llama"] = llama_checks(paths["llama"], mesh)
        if world == "tp2":
            result["int8"] = model_checks(paths["llama"], mesh, kv_dtype="int8")
            for name in ("qwen2", "phi3", "gemma2"):
                result[name] = model_checks(paths[name], mesh)
            result["session"] = session_and_eval_checks(paths["llama"], mesh, out_dir, root)
            result["batch"] = batch_checks(paths["llama"], mesh, root)
            result["server"] = server_checks(paths["llama"], mesh, root)
            result["refusals"] = refusals(paths, mesh)
        result["ok"] = True
    except Exception:  # noqa: BLE001 - the test reads the traceback
        result["ok"] = False
        result["error"] = traceback.format_exc()
    result["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{world}_{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
