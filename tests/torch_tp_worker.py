"""One rank of a gloo world for tests/test_torch_tp_engine.py: the port's
tensor-parallel engine, BatchEngine and server on the CPU against the
port's single-device engine in the same process.

    python tests/torch_tp_worker.py WORLD RANK SIZE COORD CONFIG.json OUT_DIR

WORLD names the checks ("tp2": every check below; "tp4" and
"dp2tp2": the tiny llama's tokens and logits; "dp2": the dense
BatchEngine's lanes split over dp, tests/test_torch_dp_split.py; "x2": an
axis no split names, tests/test_torch_mesh_axes.py; "spec": the draft
model and NFAI_Q8V3 under tp = 2, tests/test_torch_spec_mesh.py).
CONFIG.json holds the GGUF paths and the mesh; the rank writes
OUT_DIR/WORLD_RANK.json with what it measured (tokens, prompt ids,
relative logit errors, collective counts) for the test to compare, and
exits non-zero on any failure. Imports torch and the port only.
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
from nfai_tpu_torch.models.llama import decode_step, prefill_slot_step  # noqa: E402
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
    """The options a mesh once refused record what they do now: an "sp"
    axis, seq_parallel's checks, expert_parallel, a MoE model under tp, the
    draft model, NFAI_Q8V3 and an axis no split names (greedy tokens
    against the single-device engine's); anything else raising
    NotImplementedError is recorded as such."""
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
    expect("draft", lambda: _same_greedy(llama, mesh, speculative="draft", draft_gguf=llama))
    os.environ["NFAI_Q8V3"] = "1"
    try:
        expect("q8v3", lambda: _same_greedy(llama, mesh))
    finally:
        del os.environ["NFAI_Q8V3"]
    expect("x_axis", lambda: _same_greedy(llama, {"tp": 1, "x": 2}))
    return out


# ---------------------------------------------------------------------------
# dp = 2: the dense BatchEngine's lanes split over dp

DP_BATCH = 4
DP_CASES = {
    # six greedy prompts through four slots (two admission waves)
    "greedy": dict(prompts=[list(range(10 + 7 * i, 19 + 11 * i)) for i in range(6)], n_new=10,
                   sampling=[dict(temperature=0.0)] * 6),
    # sampled rows beside greedy ones, with logprobs, penalties and a logit bias on some
    "sampled": dict(prompts=[list(range(40 + 5 * i, 52 + 9 * i)) for i in range(5)], n_new=10,
                    sampling=[dict(temperature=0.8, top_k=20), dict(temperature=0.0, logprobs=2),
                              dict(temperature=1.0, presence_penalty=0.5, frequency_penalty=0.3),
                              dict(temperature=0.7, logit_bias=((17, 2.0), (33, -1.0)), logprobs=0),
                              dict(temperature=0.9, top_p=0.8, min_p=0.05)]),
}
DP_SPEC = dict(prompts=[[5, 6, 7, 8, 9] * 4 + [5, 6], [11, 12, 13] * 6, [20, 21, 22, 23] * 4, [30, 31] * 8],
               n_new=16, sampling=[dict(temperature=0.0), dict(temperature=0.8), dict(temperature=0.0),
                                   dict(temperature=0.6)])


def _batch_run(engine, root, case, **kw) -> dict:
    """A dense BatchEngine of DP_BATCH slots on `engine` driven through
    `case` (rank 0 submits and steps, the others follow): the tokens and
    logprob entries of each request (rank 0), and every rank's dp
    collectives."""
    be = BatchEngine(engine, max_batch=DP_BATCH, decode_chunk=4, paged=False, **kw)
    reqs = [be.submit(p, SamplingParams(max_new_tokens=case["n_new"], **s))
            for p, s in zip(case["prompts"], case["sampling"])] if root else []
    got = _drain(be, reqs, root)
    out = {"lanes": [be.lanes.start, len(be.lanes)], "cache_lanes": be.cache.k.shape[1],
           "dp": dict(be.dp_comm.counts) if be.dp_comm is not None else None}
    if root:
        out.update(tokens=got, logprobs=[r.logprob_data for r in reqs], spec=[be.spec_drafted, be.spec_accepted])
    return out


def dp_checks(path, mesh, root) -> dict:
    """The dense cache's lanes a rank holds (B/dp of a batch that dp
    divides, all of a batch it does not), one decode step's logits on the
    rank's lanes against the single-device engine's rows, and the dense
    BatchEngine's tokens (greedy, sampled with the options, speculative
    "ngram") against the single-device BatchEngine's."""
    dp, one = engines(path, mesh, prefill_chunk=16)
    out = {"cache_batch": {b: dp.new_cache(b).k.shape[1] for b in (1, 3, 4, 8)}, "lanes": dp.lanes(DP_BATCH)}
    lo, n = dp.lanes(DP_BATCH)
    prompts = DP_CASES["greedy"]["prompts"][:DP_BATCH]
    caches = {"dp": dp.new_cache(DP_BATCH), "one": one.new_cache(DP_BATCH)}
    last = {}
    for name, e in (("dp", dp), ("one", one)):
        rows = range(lo, lo + n) if name == "dp" else range(DP_BATCH)
        for slot in rows:
            ids = prompts[slot]
            logits, caches[name] = prefill_slot_step(
                e.params, e.model_cfg, torch.tensor([ids]), torch.arange(len(ids))[None],
                torch.tensor([len(ids) - 1]), caches[name], slot - rows.start)
        toks = torch.tensor([prompts[i][-1] for i in rows])
        pos = torch.tensor([len(prompts[i]) for i in rows])
        last[name], _ = decode_step(e.params, e.model_cfg, toks, pos, caches[name])
    out["logit_err"] = rel(last["dp"], last["one"][lo:lo + n])
    for name, case in DP_CASES.items():
        got = _batch_run(dp, root, case)
        if root:
            got["want"] = _batch_run(one, True, case)
        out[name] = got
    sdp, sone = engines(path, mesh, prefill_chunk=16, speculative="ngram", spec_tokens=3, spec_rounds=2)
    out["spec"] = _batch_run(sdp, root, DP_SPEC)
    if root:
        out["spec"]["want"] = _batch_run(sone, True, DP_SPEC)
    return out


# ---------------------------------------------------------------------------
# an axis no split names: {"tp": 1, "x": 2} replicates

def x_axis_checks(path, mesh, root) -> dict:
    """Each axis's group, then the model on every rank bit for bit the
    single-device engine's: prefill logits, greedy tokens, a paged
    BatchEngine (rank 0 steps, rank 1 follows)."""
    x, one = engines(path, mesh)
    m = x.mesh
    out = {"dims": m.dims, "groups": {a: m.ranks(a) for a in m.dims}, "coords": [m.axis_rank(a) for a in m.dims]}
    ids = one.tokenizer.encode(PROMPT)
    out["prefill_equal"] = bool(torch.equal(x.prefill(x.new_cache(1), ids)[0], one.prefill(one.new_cache(1), ids)[0]))
    out["tokens"], out["one_tokens"] = list(x.generate(ids, GREEDY)), list(one.generate(ids, GREEDY))
    out["params_comm"] = "comm" in x.params
    be = BatchEngine(x, max_batch=4, decode_chunk=4)
    prompts = DP_CASES["greedy"]["prompts"]
    s = SamplingParams(temperature=0.0, max_new_tokens=8)
    out["batch"] = _drain(be, [be.submit(p, s) for p in prompts] if root else [], root)
    if root:
        be0 = BatchEngine(one, max_batch=4, decode_chunk=4)
        out["batch_one"] = _drain(be0, [be0.submit(p, s) for p in prompts], True)
    return out


# ---------------------------------------------------------------------------
# the draft model and NFAI_Q8V3 under tp = 2

def spec_checks(paths, mesh, root) -> dict:
    """The draft model under the mesh (greedy and seeded sampled, against
    the tp target's plain decoding; its engine takes the target's Mesh and
    has its own Comm), then the hidden-2048 Q8_0 model under NFAI_Q8V3=1 at
    tp = 2 (the containers a rank holds, greedy tokens, the prefill's
    logits against the single-device engine under the same switch)."""
    llama, draft = paths["llama"], paths["draft"]
    tp, one = engines(llama, mesh, speculative="draft", draft_gguf=draft, spec_tokens=3, spec_rounds=2)
    plain = InferenceEngine(llama, EngineConfig(mesh_shape=mesh, dtype="float32", max_seq_len=128),
                            device="cpu", mesh=tp.mesh)
    ids = one.tokenizer.encode(PROMPT)
    out = {}
    from nfai_tpu_torch.runtime.engine import GenerationMetrics

    s = SamplingParams(temperature=0.0, max_new_tokens=24)
    m = GenerationMetrics()
    out["draft_tokens"] = list(tp.generate(ids, s, metrics=m))
    out["plain_tokens"] = list(plain.generate(ids, s))
    out["one_draft_tokens"] = list(one.generate(ids, s))
    out["acceptance"] = [m.spec_drafted, m.spec_accepted]
    de = tp.draft_engine
    out["draft_mesh_shared"] = de.mesh is tp.mesh and de.comm is not tp.comm and de.params["comm"] is de.comm
    out["draft_local_heads"] = [de.model_cfg.n_heads, de.model_cfg.n_kv_heads]
    out["draft_collectives"] = dict(de.comm.counts)
    sampled = SamplingParams(temperature=0.8, seed=5, max_new_tokens=16)
    out["draft_sampled"] = list(tp.generate(ids, sampled))
    os.environ["NFAI_Q8V3"] = "1"
    try:
        q = InferenceEngine(paths["q8"], EngineConfig(mesh_shape=mesh, dtype="float32", max_seq_len=64),
                            device="cpu")
        qone = InferenceEngine(paths["q8"], EngineConfig(dtype="float32", max_seq_len=64), device="cpu")
    finally:
        del os.environ["NFAI_Q8V3"]
    kinds = {k: type(w).__name__ for k, w in q.params["layers"].items() if not k.endswith("norm")}
    kinds["lm_head"] = type(q.params["lm_head"]).__name__
    q_ids = [2, 4, 6, 8, 10, 12, 14]
    lt, lo = q.prefill(q.new_cache(1), q_ids)[0], qone.prefill(qone.new_cache(1), q_ids)[0]
    qs = SamplingParams(temperature=0.0, max_new_tokens=4)
    out["q8v3"] = {"kinds": kinds, "one_kinds": {k: type(w).__name__ for k, w in qone.params["layers"].items()
                                                 if not k.endswith("norm")},
                   "tokens": list(q.generate(q_ids, qs)), "one_tokens": list(qone.generate(q_ids, qs)),
                   "logit_err": rel(lt, lo), "logits": lt[0].tolist()}
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
        if world == "dp2":
            result["dp"] = dp_checks(paths["llama"], mesh, root)
        elif world == "x2":
            result["x"] = x_axis_checks(paths["llama"], mesh, root)
        elif world == "spec":
            result["spec"] = spec_checks(paths, mesh, root)
        else:
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
