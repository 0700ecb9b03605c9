"""The JAX package's sequence- and expert-parallel functions on the
8-virtual-device CPU mesh, for tests/test_torch_seq_parallel.py and
tests/test_torch_expert_parallel.py. Run in a subprocess, as
tests/sp_worker.py and tests/ep_worker.py run them (shard_map programs
compiled in the test process break later XLA:CPU compiles).

    python tests/torch_parallel_jax_refs.py sp|ep INPUTS.npz OUT.npz
    XLA_FLAGS=--xla_force_host_platform_device_count=2 \
        python tests/torch_parallel_jax_refs.py mesh CONFIG.json OUT.json

sp: `sp_decode_attention`, `sp_decode_attention_ring` and
`sp_decode_attention_merged` (stats merge and ring) of the inputs' q, k, v,
lengths over an sp axis of 2 and of 4. ep: `moe_ffn_ep` over a tp axis of
2 and of 4, on dense stacks and on 8-bit (q8) stacks, for the inputs' x and
router. Each call is jitted: run eagerly, a shard_map program compiles op
by op (about a minute for these calls, against a few seconds jitted).

mesh (on 2 devices: the JAX `make_mesh` takes every device), the JAX
engines of tests/test_torch_dp_split.py and tests/test_torch_spec_mesh.py,
f32, on CONFIG.json's GGUFs and prompts: the dense BatchEngine under
{"dp": 2, "tp": 1}; the engine under {"tp": 2} (dense weights); the
single-device engine with speculative="draft"; and under {"tp": 2} with
NFAI_Q8V3=1 the 8-bit model's container kinds, prefill logits and greedy
tokens. Writes their tokens and kinds as JSON.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nfai_tpu.parallel.mesh import make_mesh  # noqa: E402

SIZES = (2, 4)


def sp(inp) -> dict:
    from nfai_tpu.parallel.seq_parallel import (
        sp_decode_attention, sp_decode_attention_merged, sp_decode_attention_ring,
    )

    q, k, v, lengths = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "lengths"))
    b, s, hkv, d = k.shape
    out = {}
    for n in SIZES:
        mesh = make_mesh({"dp": 8 // n, "tp": 1, "sp": n})
        out[f"stats_{n}"] = jax.jit(lambda *a: sp_decode_attention(*a, mesh, axis="sp"))(q, k, v, lengths)
        out[f"ring_{n}"] = jax.jit(lambda *a: sp_decode_attention_ring(*a, mesh, axis="sp"))(q, k, v, lengths)
        merged = (k.reshape(b, s, hkv * d), v.reshape(b, s, hkv * d))
        for ring in (False, True):
            out[f"merged_{'ring' if ring else 'stats'}_{n}"] = jax.jit(
                lambda q, kv, ln: sp_decode_attention_merged(q, kv, ln, hkv, mesh, axis="sp", ring=ring))(
                q, merged, lengths)
    return out


def ep(inp) -> dict:
    from nfai_tpu.models.llama import LlamaConfig
    from nfai_tpu.ops.qtensor import QTensor
    from nfai_tpu.parallel.expert_parallel import moe_ffn_ep

    e, h = inp["router"].shape[1], inp["x"].shape[1]
    f = inp["dense_gate"].shape[2]
    cfg = LlamaConfig(vocab_size=128, hidden_size=h, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=16,
                      ffn_dim=f, rope_base=10000.0, context_length=64, n_experts=e,
                      n_experts_used=int(inp["used"]), moe_ffn_dim=f, norm_topk_prob=True)
    x, router = jnp.asarray(inp["x"]), jnp.asarray(inp["router"])
    dense = {"router": router, **{f"w_{n}_exps": jnp.asarray(inp[f"dense_{n}"]) for n in ("gate", "up", "down")}}

    def q8(n):
        qs, sc = inp[f"q8_{n}_qs"], inp[f"q8_{n}_scales"]
        return QTensor(jnp.asarray(qs), jnp.asarray(sc), None, "q8", qs.shape[1], qs.shape[2])

    quant = {"router": router, **{f"w_{n}_exps": q8(n) for n in ("gate", "up", "down")}}
    out = {}
    for n in SIZES:
        mesh = make_mesh({"dp": 8 // n, "tp": n})
        run = jax.jit(lambda x, lp: moe_ffn_ep(x, lp, cfg, jax.nn.silu, mesh))
        out[f"dense_{n}"] = run(x, dense)
        out[f"q8_{n}"] = run(x, quant)
    return out


def mesh(conf) -> dict:
    from nfai_tpu.config import EngineConfig, SamplingParams
    from nfai_tpu.runtime.engine import InferenceEngine
    from nfai_tpu.runtime.scheduler import BatchEngine

    paths, out = conf["paths"], {}
    base = dict(dtype="float32", max_seq_len=128)
    if "dp" in conf:  # the dense BatchEngine, its lanes over dp
        dp = conf["dp"]
        eng = InferenceEngine(paths["llama"], EngineConfig(mesh_shape={"dp": 2, "tp": 1},
                                                           prefill_chunk=dp["prefill_chunk"], **base))
        with jax.sharding.set_mesh(eng.mesh):
            be = BatchEngine(eng, max_batch=dp["max_batch"], decode_chunk=4, paged=False)
            reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=dp["n_new"])) for p in dp["prompts"]]
            for _ in range(500):
                if be.step() == 0:
                    break
        out["dp_tokens"] = [list(map(int, r.output_ids)) for r in reqs]
        out["dp_cache_lanes"] = int(be.cache.k.addressable_shards[0].data.shape[1])
    if "spec" in conf:
        sp = conf["spec"]
        greedy = SamplingParams(temperature=0.0, max_new_tokens=sp["n_new"])
        eng = InferenceEngine(paths["llama"], EngineConfig(mesh_shape={"tp": 2}, **base))
        with jax.sharding.set_mesh(eng.mesh):
            out["tp_tokens"] = list(map(int, eng.generate(sp["ids"], greedy)))
        draft = InferenceEngine(paths["llama"], EngineConfig(speculative="draft", draft_gguf=paths["draft"],
                                                             spec_tokens=3, **base))
        out["draft_tokens"] = list(map(int, draft.generate(sp["ids"], greedy)))
        os.environ["NFAI_Q8V3"] = "1"
        try:
            q = InferenceEngine(paths["q8"], EngineConfig(mesh_shape={"tp": 2}, dtype="float32", max_seq_len=64))
        finally:
            del os.environ["NFAI_Q8V3"]
        kind = lambda w: getattr(w, "kind", "dense")  # noqa: E731
        out["q8v3_kinds"] = {k: kind(w) for k, w in q.params["layers"].items() if not k.endswith("norm")}
        out["q8v3_kinds"]["lm_head"] = kind(q.params["lm_head"])
        with jax.sharding.set_mesh(q.mesh):
            logits, _ = q.prefill(q.new_cache(1), sp["q_ids"])
            out["q8v3_logits"] = np.asarray(logits, np.float32)[0].tolist()
            out["q8v3_tokens"] = list(map(int, q.generate(sp["q_ids"], SamplingParams(temperature=0.0,
                                                                                      max_new_tokens=4))))
    return out


def main(argv) -> int:
    mode, src, dst = argv
    if mode == "mesh":
        import json

        with open(src) as f:
            out = mesh(json.load(f))
        with open(dst, "w") as f:
            json.dump(out, f)
        print("ALL OK")
        return 0
    with np.load(src) as z:
        inp = {k: z[k] for k in z.files}
    out = {"sp": sp, "ep": ep}[mode](inp)
    np.savez(dst, **{k: np.asarray(v, np.float32) for k, v in out.items()})
    print("ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
