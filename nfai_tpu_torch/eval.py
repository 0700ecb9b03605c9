"""Perplexity evaluation (teacher-forced) over non-overlapping windows, as
llama.cpp's `perplexity` scores a text.

Counterpart of nfai_tpu/eval.py. Each window is one prefill forward of T =
window tokens on a fresh cache (the prefill path's kernels: the matmuls,
K4, K5, the K/V store), then the LM head at every position (K1's or K6's
tiles at M = window) and the log-softmax in f32, taken in row blocks so
that no second [T, V] copy of the logits is made.

Usage:
    python -m nfai_tpu_torch.eval --gguf model.gguf --text corpus.txt [--dense | --compare] [--kv int8]
    python -m nfai_tpu_torch.eval ... --device cpu --dtype float32   # the plain versions

Runs on the GPU by default and raises if none is visible. Prints one JSON
line with the JAX tool's keys: ppl_quantized / ppl_dense, ppl_delta (with
--compare), ppl_<mode>-kv-int8 and ppl_kv_delta_<mode> (with --kv int8).
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

LSE_ROWS = 64  # logit rows per log-sum-exp block: 64 x V f32 of scratch


@torch.inference_mode()
def window_nll(params: dict, cfg, tokens: torch.Tensor, cache) -> tuple[float, int]:
    """Sum of -log p(tokens[t + 1] | tokens[..t]) over one window [1, T],
    and the number of terms (T - 1)."""
    from .models.llama import forward, logits_for

    t = tokens.shape[1]
    positions = torch.arange(t, device=tokens.device)[None]
    h, _ = forward(params, cfg, tokens, positions, cache)
    logits = logits_for(params, h[0], cfg)  # [T, V] f32, the head at M = T
    targets = tokens[0, 1:]
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for r0 in range(0, t - 1, LSE_ROWS):
        block = logits[r0:min(r0 + LSE_ROWS, t - 1)]
        picked = block.gather(1, targets[r0:r0 + block.shape[0], None])[:, 0]
        total += (torch.logsumexp(block, dim=-1) - picked).sum(dtype=torch.float64)
    return float(total), t - 1


def perplexity(params: dict, cfg, token_ids, window: int = 512, dtype=torch.bfloat16,
               kv_quant: bool = False) -> float:
    """Perplexity over non-overlapping windows of `token_ids`, on the
    device that holds `params`. `kv_quant` scores with the int8 KV cache
    (EngineConfig.kv_dtype="int8") so its accuracy cost is measurable
    against the full-precision cache."""
    from .models.llama import KVCache

    token_ids = np.asarray(token_ids, np.int64)
    n_windows = len(token_ids) // window
    if n_windows == 0:
        raise ValueError(f"need at least {window} tokens, got {len(token_ids)}")
    device = params["final_norm"].device
    slots = -(-window // 64) * 64  # K4's key tile
    total_nll, total_count = 0.0, 0
    for w in range(n_windows):
        chunk = torch.from_numpy(token_ids[w * window:(w + 1) * window][None]).to(device)
        cache = KVCache.zeros(cfg, 1, slots, dtype, device, quantized=kv_quant)
        nll, count = window_nll(params, cfg, chunk, cache)
        total_nll += nll
        total_count += count
    return math.exp(total_nll / total_count)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nfai_tpu_torch.eval")
    p.add_argument("--gguf", required=True)
    p.add_argument("--text", required=True, help="UTF-8 text file to score")
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=0, help="0 = whole file")
    p.add_argument("--dense", action="store_true",
                   help="dequantize every matmul weight into --dtype at load (the K11 route)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="activation dtype (the CUDA kernels take bfloat16)")
    p.add_argument("--compare", action="store_true",
                   help="evaluate both quantized and dense, report the delta")
    p.add_argument("--kv", default="auto", choices=["auto", "int8"],
                   help="KV cache storage during scoring (int8 adds a 'kv-int8' result "
                        "row for the accuracy delta)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from .device import resolve_device
    from .gguf import GGUFFile
    from .models import resolve
    from .tokenizer import tokenizer_from_gguf

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels take bfloat16 activations; use --dtype bfloat16")
    with open(args.text, encoding="utf-8") as f:
        text = f.read()
    with GGUFFile.open(args.gguf) as g:
        family = resolve(g)
        cfg = family.config_from_gguf(g)
        ids = np.asarray(tokenizer_from_gguf(g.metadata).encode(text), np.int64)
        if args.max_tokens:
            ids = ids[: args.max_tokens]
        print(f"{len(ids)} tokens, window {args.window}", file=sys.stderr)
        results = {}
        modes = ["quantized", "dense"] if args.compare else (["dense"] if args.dense else ["quantized"])
        for mode in modes:
            params = family.load_params(g, cfg, dtype=dtype, device=device,
                                        quantized=mode == "quantized")
            results[mode] = perplexity(params, cfg, ids, args.window, dtype)
            print(f"ppl[{mode}] = {results[mode]:.4f}", file=sys.stderr)
            if args.kv == "int8":
                results[f"{mode}-kv-int8"] = perplexity(params, cfg, ids, args.window, dtype,
                                                        kv_quant=True)
                print(f"ppl[{mode}-kv-int8] = {results[mode + '-kv-int8']:.4f}", file=sys.stderr)
            del params

    out = {f"ppl_{k}": round(v, 4) for k, v in results.items()}
    if "quantized" in results and "dense" in results:
        out["ppl_delta"] = round(results["quantized"] - results["dense"], 4)
    for mode in ("quantized", "dense"):
        if f"{mode}-kv-int8" in results:
            out[f"ppl_kv_delta_{mode}"] = round(results[f"{mode}-kv-int8"] - results[mode], 4)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
