"""The JAX package's sequence- and expert-parallel functions on the
8-virtual-device CPU mesh, for tests/test_torch_seq_parallel.py and
tests/test_torch_expert_parallel.py. Run in a subprocess, as
tests/sp_worker.py and tests/ep_worker.py run them (shard_map programs
compiled in the test process break later XLA:CPU compiles).

    python tests/torch_parallel_jax_refs.py sp|ep INPUTS.npz OUT.npz

sp: `sp_decode_attention`, `sp_decode_attention_ring` and
`sp_decode_attention_merged` (stats merge and ring) of the inputs' q, k, v,
lengths over an sp axis of 2 and of 4. ep: `moe_ffn_ep` over a tp axis of
2 and of 4, on dense stacks and on 8-bit (q8) stacks, for the inputs' x and
router. Each call is jitted: run eagerly, a shard_map program compiles op
by op (about a minute for these calls, against a few seconds jitted).
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


def main(argv) -> int:
    mode, src, dst = argv
    with np.load(src) as z:
        inp = {k: z[k] for k in z.files}
    out = {"sp": sp, "ep": ep}[mode](inp)
    np.savez(dst, **{k: np.asarray(v, np.float32) for k, v in out.items()})
    print("ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
