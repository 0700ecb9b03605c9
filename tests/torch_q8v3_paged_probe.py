"""Where the tiny q8v3 model's paged decode on the card parts from the CPU.

    python tests/torch_q8v3_paged_probe.py [headmajor|merged ...]

Needs an NVIDIA GPU. The fixture of tests/test_torch_cuda.py::
test_tiny_q8v3_model_cuda_matches_cpu (hidden 2048, 16/4 heads of 128, two
Q8_0 layers under NFAI_Q8V3=1, page size 16, table [3, 1, 4, 5]) runs on
the card (bf16), on the CPU (bf16) and on the CPU in float32, and each step
is split into its parts. One JSON line per part, max|a - b| / max|b|:

(a) the logits of a dense decode step after the dense prefill;
(b) the pool's pages after the paged prefill, per layer (written slots only);
(c) K7 alone on the card's pages (the fixture's D = 128, r = 4, ps = 16)
    against `paged_decode_attention_plain`, per query head;
(d) K12 at M = 1 on each of the fixture's weights against its plain version;
(e) the paged decode's logits: card and CPU each against the f32 run, and
    the card's decode on the CPU's pool (is it the pool or the step);
(f) (a) again with the prompt prefilled in chunks of 8 tokens, so that
    every matmul of the prefill is K12's GEMV (f32 products of the exact
    weight) instead of its wgmma tiles (the weight rounded once to bf16).
"""
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nfai_tpu_torch.config import EngineConfig  # noqa: E402
from nfai_tpu_torch.gguf import GGMLType  # noqa: E402
from nfai_tpu_torch.models import decode_step, paged_prefill_step  # noqa: E402
from nfai_tpu_torch.models import llama as tllama  # noqa: E402
from nfai_tpu_torch.ops import paged_attention as pga  # noqa: E402
from nfai_tpu_torch.ops import qmatmul as qm  # noqa: E402
from nfai_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache  # noqa: E402
from nfai_tpu_torch.testing import make_tiny_llama_gguf  # noqa: E402

TABLE = [[3, 1, 4, 5]]


def rel(got, want, row_dims=0):
    got, want = got.float().cpu().flatten(row_dims), want.float().cpu().flatten(row_dims)
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def show(part, **kv):
    print(json.dumps({"part": part, **kv}), flush=True)


def paged(e, ids, dev):
    table = torch.tensor(TABLE, dtype=torch.int32, device=dev)
    pool = PagedKVCache.zeros(e.model_cfg, 6, 16, e.cache_dtype, dev)
    pre, pool = paged_prefill_step(
        e.params, e.model_cfg, torch.tensor([ids], device=dev),
        torch.arange(len(ids), device=dev)[None], torch.tensor([len(ids) - 1], device=dev),
        pool, table)
    return pre, pool, table


def decode(e, ids, dev, cache, table=None):
    return decode_step(e.params, e.model_cfg, torch.tensor([7], device=dev),
                       torch.tensor([len(ids)], device=dev), cache, page_tables=table)[0]


def written(pool_k, n):
    """[L, Hkv, P, ps, D] → [L, Hkv, n, D]: the slots the prefill wrote, in table order."""
    pages = pool_k[:, :, TABLE[0]]
    lyr, hkv, n_p, ps, d = pages.shape
    return pages.reshape(lyr, hkv, n_p * ps, d)[:, :, :n]


def main(layouts):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    os.environ["NFAI_Q8V3"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        path = make_tiny_llama_gguf(os.path.join(tmp, "q8v3.gguf"), hidden=2048, n_layers=2,
                                    n_heads=16, n_kv_heads=4, ffn_dim=2048, vocab_size=512,
                                    quant=GGMLType.Q8_0, tied=False, seed=7)
        cfg = EngineConfig(max_seq_len=256, page_size=16)
        gpu, cpu = InferenceEngine(path, cfg, device="cuda"), InferenceEngine(path, cfg, device="cpu")
        f32 = InferenceEngine(path, EngineConfig(max_seq_len=256, page_size=16, dtype="float32"),
                              device="cpu")
        ids = cpu.tokenizer.encode("a short prompt for both devices")
        show("fixture", tokens=len(ids), device=torch.cuda.get_device_name(0))

        # (d) K12 at M = 1 on every weight of the fixture
        lp = gpu.params["layers"]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name in ("wqkv", "wo", "w_gate_up", "w_down"):
            for layer in range(gpu.model_cfg.n_layers):
                w = lp[name].layer(layer)
                x = torch.randn(1, w.k, device="cuda", dtype=torch.bfloat16, generator=gen)
                show("d", weight=f"{name}[{layer}]", n=w.n, k=w.k,
                     rel=rel(qm.q8v3_matmul(x, w), qm.q8v3_matmul_plain(x, w), 1))
        w = gpu.params["lm_head"]
        x = torch.randn(1, w.k, device="cuda", dtype=torch.bfloat16, generator=gen)
        show("d", weight="lm_head", n=w.n, k=w.k,
             rel=rel(qm.q8v3_matmul(x, w), qm.q8v3_matmul_plain(x, w), 1))

        # (a) dense prefill, then a dense decode step
        dense = {}
        for dev, e in (("cuda", gpu), ("cpu", cpu), ("f32", f32)):
            d = "cpu" if dev == "f32" else dev
            pre, cache = e.prefill(e.new_cache(1), ids)
            dense[dev] = (pre, decode(e, ids, d, cache))
        show("a", prefill_card_vs_cpu=rel(dense["cuda"][0], dense["cpu"][0]),
             decode_card_vs_cpu=rel(dense["cuda"][1], dense["cpu"][1]),
             decode_card_vs_f32=rel(dense["cuda"][1], dense["f32"][1]),
             decode_cpu_vs_f32=rel(dense["cpu"][1], dense["f32"][1]))

        # (f) the dense steps with every prefill matmul on K12's GEMV (M <= 8)
        chunked = {}
        for dev in ("cuda", "cpu"):
            e = InferenceEngine(path, EngineConfig(max_seq_len=256, page_size=16, prefill_chunk=8),
                                device=dev)
            pre, cache = e.prefill(e.new_cache(1), ids)
            chunked[dev] = (pre, decode(e, ids, dev, cache))
        show("f", prefill_card_vs_cpu=rel(chunked["cuda"][0], chunked["cpu"][0]),
             decode_card_vs_cpu=rel(chunked["cuda"][1], chunked["cpu"][1]),
             decode_card_vs_f32=rel(chunked["cuda"][1], dense["f32"][1]),
             decode_cpu_vs_f32=rel(chunked["cpu"][1], dense["f32"][1]))

        for layout in layouts:
            tllama._PREFILL_KV_LAYOUT = layout
            runs = {}
            for dev, e in (("cuda", gpu), ("cpu", cpu), ("f32", f32)):
                d = "cpu" if dev == "f32" else dev
                pre, pool, table = paged(e, ids, d)
                runs[dev] = (pre, pool, table, decode(e, ids, d, pool, table))
            (gpre, gpool, gtab, gdec), (cpre, cpool, ctab, cdec), (fpre, fpool, _, fdec) = (
                runs["cuda"], runs["cpu"], runs["f32"])
            # (b) the pages after the paged prefill
            for name in ("k", "v"):
                g, c, f = (written(getattr(p, name), len(ids)) for p in (gpool, cpool, fpool))
                show("b", layout=layout, pool=name,
                     card_vs_cpu=[rel(g[i], c[i], 2) for i in range(g.shape[0])],
                     card_vs_f32=[rel(g[i], f[i], 2) for i in range(g.shape[0])],
                     cpu_vs_f32=[rel(c[i], f[i], 2) for i in range(g.shape[0])])
            show("b", layout=layout, prefill_logits_card_vs_cpu=rel(gpre, cpre),
                 card_vs_f32=rel(gpre, fpre), cpu_vs_f32=rel(cpre, fpre))
            # (c) K7 alone on the card's pages, at the fixture's shapes
            lengths = torch.tensor([len(ids) + 1], dtype=torch.int32, device="cuda")
            q = torch.randn(1, 16, 128, device="cuda", dtype=torch.bfloat16, generator=gen)
            for layer in range(gpu.model_cfg.n_layers):
                kp, vp = gpool.k[layer], gpool.v[layer]
                show("c", layout=layout, layer=layer,
                     rel=rel(pga.paged_decode_attention(q, kp, vp, gtab, lengths),
                             pga.paged_decode_attention_plain(q, kp, vp, gtab, lengths, 128**-0.5), 2))
            # (e) the paged decode: each against f32, and the card on the CPU's pool
            moved = PagedKVCache(cpool.k.cuda(), cpool.v.cuda())
            show("e", layout=layout, card_vs_cpu=rel(gdec, cdec), card_vs_f32=rel(gdec, fdec),
                 cpu_vs_f32=rel(cdec, fdec),
                 card_on_cpu_pool_vs_cpu=rel(decode(gpu, ids, "cuda", moved, gtab), cdec))


if __name__ == "__main__":
    main(sys.argv[1:] or ["headmajor", "merged"])
