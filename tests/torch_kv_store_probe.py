"""Batch-8 steps of models A (bf16 and int8 caches), C and E8, dense and
paged, for comparing two trees of the port in one call (a change and its
parent): kernels and device ms a decode step (torch.profiler over 8 steps),
each profile's kernels by name (ms and launches a step: which kernels a
change removed), the decode wall, one 8x128 prefill chunk's wall and, for
A and A8, the paged BatchEngine's aggregate tok/s and TTFT (16 requests);
with --k3 also K3's and K10's own rows. Every phase is chip_smoke.py's own, imported from the
tree under test, so both trees run the same measurement.

    python tests/torch_kv_store_probe.py [--root DIR] [--models A,C,E8] [--k3] [--out FILE]

--root is the checkout whose nfai_tpu_torch and chip_smoke.py are used
(default: this one; a parent from `git archive` into a git-ignored _parent/,
say); with --out each run appends its JSON line to that file. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

# model -> (GGUF kind, kv_dtype, NFAI_Q8V3, K4 layout) as chip_smoke.py runs it
PROBED = {"A": ("q4_k", "auto", False, None), "A8": ("q4_k", "int8", False, None),
          "C": ("qwen3moe", "auto", False, None), "E8": ("llama_8b_q8_0", "int8", True, "headmajor")}
SERVED = ("A", "A8")  # the 16-request paged BatchEngine runs on these


def _gguf(cs, tmp, kind):
    from nfai_tpu_torch.testing import make_llama_1b_gguf, make_qwen3moe_gguf

    if kind == "qwen3moe":
        return make_qwen3moe_gguf(os.path.join(tmp, "c.gguf"), n_layers=cs.C_LAYERS)
    n_layers = cs.E_LAYERS if kind == "llama_8b_q8_0" else None
    return make_llama_1b_gguf(os.path.join(tmp, f"{kind}.gguf"), kind=kind, n_layers=n_layers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--models", default="A,A8", help=f"comma-separated, of {sorted(PROBED)}")
    ap.add_argument("--k3", action="store_true", help="also time K3's and K10's own rows")
    ap.add_argument("--out", default=None, help="append each run's JSON line to this file")
    args = ap.parse_args(argv)
    models = [m for m in args.models.split(",") if m]
    if bad := set(models) - set(PROBED):
        ap.error(f"unknown models {sorted(bad)}")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kv_store_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nfai_tpu_torch import kernels as kernels_mod
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    assert Path(cs.__file__).resolve().parent == Path(root), "chip_smoke.py from another tree"
    tables = []  # every profile's kernel table, as phase_profile reads it
    kernel_table = cs._kernel_table

    def keep_table(prof):
        tables.append(kernel_table(prof))
        return tables[-1]

    def per_step(table, n):  # kernel name (cut to 120 characters; names that then meet are summed)
        out = {}                # -> [device ms, launches] a step
        for k, (ms, c) in table.items():
            row = out.setdefault(k[:120], [0.0, 0.0])
            row[0] += ms / n
            row[1] += c / n
        return out

    cs._kernel_table = keep_table
    smi = cs.phase_build(torch, kernels_mod)["smi"]
    out = {"root": root, "smi": smi}
    if args.k3:
        rows = cs._kernels_kv_write(torch, cs.Timer(torch), torch.Generator(device="cuda").manual_seed(0))
        out["k3"] = {name: [(c["shape"], c["ms"]) for c in r["cases"]] for name, r in rows.items()}
    paths = {}
    with tempfile.TemporaryDirectory(prefix="kv_store_probe_") as tmp:
        for label in models:
            kind, kv, q8v3, layout = PROBED[label]
            if kind not in paths:
                paths[kind] = _gguf(cs, tmp, kind)
            t0 = time.perf_counter()
            with cs._Switches(q8v3=q8v3, layout=layout):
                engine = InferenceEngine(paths[kind], EngineConfig(max_seq_len=1024, kv_dtype=kv), device="cuda")
                cs.log(f"{label} ({root}): loaded in {time.perf_counter() - t0:.1f} s")
                batch = cs.phase_batch(torch, engine, kernels_mod)
                state = batch.pop("state")
                dense = cs.phase_profile(torch, engine, state)
                dense["by_kernel"] = per_step(tables[-1], dense["steps"])
                del state
                paged = cs._paged_decode_timing(torch, engine, kernels_mod)
                paged["profile"]["by_kernel"] = per_step(tables[-1], paged["profile"]["steps"])
                server = cs._batch_engine_run(torch, engine) if label in SERVED else None
            out[label] = dict(prefill_ms=batch["prefill_ms"], decode_ms_per_step=batch["decode_ms_per_step"],
                              profile=dense, paged_decode_ms_per_step=paged["decode_ms_per_step"],
                              paged_profile=paged["profile"],
                              server_tok_s=server and server["tok_s"], server_ttft_ms=server and server["ttft_ms"])
            del engine
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    for label in models:
        r = out[label]
        served = "" if r["server_tok_s"] is None else (
            f"; server {r['server_tok_s']:.1f} tok/s, TTFT p50 {r['server_ttft_ms']['p50']:.1f} ms")
        print(f"{root} {label}: dense {r['profile']['kernels_per_step']:.0f} kernels, "
              f"{r['profile']['device_ms_per_step']:.3f} device ms, wall {r['decode_ms_per_step']:.2f} ms a step; "
              f"paged {r['paged_profile']['kernels_per_step']:.0f}, {r['paged_profile']['device_ms_per_step']:.3f}, "
              f"wall {r['paged_decode_ms_per_step']:.2f}; prefill 8x128 {r['prefill_ms']:.1f} ms{served}", flush=True)
    if args.k3:
        print(f"{root} K3 / K10 ms: {out['k3']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
