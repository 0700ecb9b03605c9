"""Chip smoke for the PyTorch/CUDA port (nfai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only build,kernels   # a quick kernel check

Phases (each failure propagates, the exit code is then non-zero):
  build    print the card, its power limit and the versions; build every
           kernel from csrc/ (one nvcc per source, in parallel)
  kernels  hold K1-K9 against their plain PyTorch versions on the card at
           the slice's shapes (K2/K3/K4/K7 at head_dim 64 and 128; K8/K9 at
           the decode layouts of a batch-1 and a batch-8 routing and a
           256-token prefill chunk); time kernel, plain version and the
           library yardstick with CUDA events (L2 flushed before each launch)
  serve    per model, write a GGUF of published widths (random raw blocks),
           load it with InferenceEngine(device="cuda") and answer three
           ChatSession requests through its chat template (one prompt > 256
           tokens: a second prefill chunk runs at an offset); TTFT and
           decode tok/s per request
  batch    prefill_step on an 8x128 prompt, then decode_loop for 64 tokens
           at batch 8, S = 1024 (the bench.py shape); decode tok/s, the
           kernel launches and host syncs per decode step, the byte bound
  profile  torch.profiler over 8 more decode steps of that batch: device
           busy share of the wall time and device time by kernel
  server   continuous batching on model A's engine: paged vs dense
           forwards on the card (a 300-token prefill, 8 teacher-forced
           decode steps at batch 4), a timed and profiled batch-8 paged
           decode, then the main path with the counts zeroed: a paged
           BatchEngine serving 16 requests (prefix sharing, a 3-chunk
           prompt, mixed sampling), a starved pool that must preempt, and
           8 concurrent HTTP requests (SSE and blocking) through the server;
           on model C's engine a paged BatchEngine serving 8 requests
  parity   2-layer full-width copies on cuda and on cpu (plain versions):
           four Llama-3.2-1B kinds and the Llama-3.2-3B widths (K1 at K =
           3072, K5 at H = 3072, K2/K4 at head_dim 128): prefill logits and
           4 teacher-forced decode steps within tolerance; the Q4_K copy
           also prefills one chunk of more than 1024 rows (the mlp_prefill
           route) and runs the same steps through the paged pool; model C:
           each layer's MoE FFN on one routing fed to both sides, then every
           prompt row and 4 decode steps, router near-ties left out and
           counted
The main path is three models, each driven by serve, batch and profile;
model A's engine then serves continuously batched traffic, and so does C's:
  A  the untied Q4_K Llama-3.2-1B in the JAX package's default
     configuration: every layer's MLP is one K5 launch (16 per decode
     step), no K6;
  B  the Q4_K_M mix llama.cpp writes: tied Q6_K table (K6 head, embedding
     rows gathered from it), Q6_K attn_v/ffn_down on 8 of 16 layers (K6),
     Q4_K elsewhere (K1); no K5, as the JAX route;
  C  qwen3moe at Qwen3-30B-A3B's widths, 8 of its 48 layers (C_LAYERS),
     in the Q4_K_M mix: q/k norms, NEOX rope, head_dim 128 (K2/K4 at
     D = 128, r = 8), per layer K8 for the gate and up experts and for a
     4-bit down, K9 for a Q6_K down, K6 for the Q6_K head and attn_v; no K5;
  server  model A through the paged pool: K7 for every decode layer, K4 on
     the gathered pages for prefill, no K2/K3; C server the same for C.
The kernels' launch counts are zeroed just before each path and read just
after; every kernel of that path must have launched, the kernels off its
route must not, and the per-step counts must match the route. The line
before the last is {"kernels": [...]} (launches summed over the paths),
the last {"ok": true, "device": {...}}; a run of a subset of the phases
ends with "ok": false, since the main paths' launch checks did not run in
full. Kernel errors are taken per output row (per batch row for decode
attention, per query token for prefill attention, per input row for the
matmuls and the MLP, per routed row for the grouped matmuls), so a row
whose output is small is held to the same tolerance as the largest one.
Needs the repo checkout (nfai_tpu_torch) and a CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_S = 989e12  # H100 SXM dense bf16 tensor-core rate
GGUF_Q4K_BYTES_PER_WEIGHT = 144 / 256  # Q4_K's own encoding (the port's container holds 0.75)
TOL = 2e-2  # max|got - want| / max|want|, the JAX package's kernel-parity rule

PHASES = ("build", "kernels", "serve", "batch", "profile", "server", "parity")
# main-path model -> make_llama_1b_gguf kind ("qwen3moe": make_qwen3moe_gguf)
MODELS = {"A": "q4_k", "B": "q4_k_m", "C": "qwen3moe"}
C_LAYERS = 8  # model C's depth: 8 of Qwen3-30B-A3B's 48 layers, every width kept
PARITY_KINDS = ("q4_k", "q4_k_m", "q8_0", "q4_0_tied", "llama_3b")
NEAR_TIE = 0.01  # router-logit gap below which card and CPU may pick different experts


def log(msg: str) -> None:
    print(msg, flush=True)


def errors(got, want, row_dims: int = 0) -> tuple[float, float]:
    """(max|got - want|, the worst over rows of max|got - want| / max|want|
    within a row). The leading `row_dims` axes index the rows; 0 takes the
    whole tensor as one row."""
    got, want = got.float().cpu().flatten(row_dims), want.float().cpu().flatten(row_dims)
    diff = (got - want).abs().amax(-1)
    rel = diff / want.abs().amax(-1).clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def check(name: str, got, want, tol: float = TOL, row_dims: int = 0) -> float:
    """Assert errors(...)[1] < tol; returns max|got - want|."""
    abs_err, rel = errors(got, want, row_dims)
    log(f"  {name}: max abs err {abs_err:.3e}, rel {rel:.3e} "
        f"({'worst of per-row' if row_dims else 'whole tensor'}, tol {tol:g})")
    if not rel < tol:
        raise AssertionError(f"{name}: rel err {rel:.3e} exceeds {tol:g}")
    return abs_err


class Timer:
    """Median CUDA-event time of one fn() launch over `iters` launches.

    Before each launch a 128 MB read evicts the 50 MB L2 (the decode path
    reads each weight once per step, so it meets a cold cache), then a GPU
    spin of ~0.5 ms keeps the device busy while the host enqueues the two
    events and fn(): the events bracket the kernels alone, not the host's
    Python and launch overhead."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush_buf.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase: build


def phase_build(torch, kernels_mod) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = kernels_mod.build_all(verbose=True)
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"  built {sorted(kernels_mod.KERNELS)} in {time.perf_counter() - t0:.1f}s")
    return {"smi": smi}


# ---------------------------------------------------------------------------
# phase: kernels


def _q4_weight(torch, n, k, gen):
    from nfai_tpu_torch.ops.qtensor import Q4Tensor

    qs = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device="cuda", generator=gen)
    sc = torch.rand(n, k // 32, device="cuda", generator=gen) * 2e-3 + 1e-4
    mn = torch.rand(n, k // 32, device="cuda", generator=gen) * 1.5e-2
    return Q4Tensor(qs, sc, mn, k, n)


def _q8_weight(torch, n, k, group, qmax, gen, with_mins=False):
    from nfai_tpu_torch.ops.qtensor import Q8Tensor

    qs = torch.randint(-qmax, qmax, (n, k), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(n, k // group, device="cuda", generator=gen) * 2e-3 / qmax * 16 + 1e-5
    mn = torch.rand(n, k // group, device="cuda", generator=gen) * 1e-2 if with_mins else None
    return Q8Tensor(qs, sc, mn, k, n, group)


def phase_kernels(torch, timer) -> dict:
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_decode as fd
    from nfai_tpu_torch.ops import prefill_attention as pa
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import dequant

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    results = {}

    # K1 at every (K, N) of the path (wk/wv: model B's split Q4_K layers),
    # decode rows 1 and 8, prefill rows 256 and 1024 (the batch prefill's
    # 8x128 chunk; the head sees one row per sequence)
    shapes = {"wqkv": (2048, 3072), "wo": (2048, 2048), "wk/wv": (2048, 512),
              "gate_up": (2048, 16384), "down": (8192, 2048), "lm_head": (2048, 128256),
              "C wq": (2048, 4096), "C wo": (4096, 2048),  # model C's head_dim-128 q and o
              "3B wqkv": (3072, 5120), "3B wo": (3072, 3072)}  # the 3B's K = 3072 (K % 2048 != 0)
    cases = []
    for label, (k, n) in shapes.items():
        w = _q4_weight(torch, n, k, gen)
        wd = dequant(w).to(bf)
        for m in (1, 8, 256) if label == "lm_head" else (1, 8, 256, 1024):
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = qm.q4_matmul(x, w)
            torch.cuda.synchronize()
            err = check(f"K1 {label} M={m} K={k} N={n}", got, qm.matmul_plain(x, w), row_dims=1)
            ms = timer(lambda: qm.q4_matmul(x, w))
            plain_ms = timer(lambda: qm.matmul_plain(x, w), iters=3)
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            nbytes = m * k * 2 + n * k // 2 + n * k // 32 * 8 + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * n * k)
            # the same work with the weight at GGUF Q4_K's own 0.5625 B/weight
            b_gguf, _ = bound_ms(m * k * 2 + n * k * GGUF_Q4K_BYTES_PER_WEIGHT + m * n * 2, 2.0 * m * n * k)
            cases.append(dict(shape=f"{label} M={m}", max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=b, bound_by=by,
                              bound_gguf_ms=b_gguf, library_ms=lib_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by} with the 0.75 B/weight container, "
                f"{b_gguf:.4f} at Q4_K's 0.5625 B/weight; plain {plain_ms:.3f}, "
                f"cuBLAS on dequantized bf16 {lib_ms:.4f})")
        del w, wd
    results["q4_matmul"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/q4_matmul.cu",
        replaces="nfai_tpu/ops/qmatmul.py:415",
        also_replaces=["nfai_tpu/ops/qmatmul.py:735", "nfai_tpu/ops/qmatmul.py:282"],
        headline=next(c for c in cases if c["shape"] == "lm_head M=8"), cases=cases,
    )

    # K2 / K3 at the decode shapes: the 1B's L=16, Hq=32, Hkv=8, D=64,
    # model C's L=8, Hq=32, Hkv=4, D=128 (r = 8; K3's row is 512 wide in
    # both) and the 3B's Hq=24, Hkv=8, D=128 (r = 3; 2 layers of cache)
    cases2, cases3 = [], []
    for L, hq, hkv, d, b, s in ((16, 32, 8, 64, 1, 512), (16, 32, 8, 64, 8, 1024),
                                (8, 32, 4, 128, 1, 512), (8, 32, 4, 128, 8, 1024),
                                (2, 24, 8, 128, 8, 1024)):
        kvd = hkv * d
        kc = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen)
        kn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        vn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        start = s - 1
        # rows hold s-1 old tokens, except at B > 1 an empty row and one at s/3
        starts = torch.full((b,), start, dtype=torch.int32, device="cuda")
        if b > 1:
            starts[0] = 0
            starts[1] = s // 3
        layer = L // 3
        scale = d**-0.5
        got = fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts, scale)
        want = fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts, scale)
        torch.cuda.synchronize()
        err = check(f"K2 D={d} Hq={hq} Hkv={hkv} B={b} S={s} starts={starts.tolist()[:3]}...", got,
                    want, row_dims=1)
        # timing: every row holds start old tokens
        starts_t = torch.full((b,), start, dtype=torch.int32, device="cuda")
        ms = timer(lambda: fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts_t, scale))
        plain_ms = timer(lambda: fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts_t, scale))
        kd = torch.cat([kc[layer, :, :start], kn[:, None]], 1).view(b, start + 1, hkv, d).transpose(1, 2).contiguous()
        vd = torch.cat([vc[layer, :, :start], vn[:, None]], 1).view(b, start + 1, hkv, d).transpose(1, 2).contiguous()
        q4 = q[:, :, None]
        lib_ms = timer(lambda: nnf.scaled_dot_product_attention(q4, kd, vd, scale=scale, enable_gqa=True))
        nbytes = 2 * (2 * b * hq * d + 2 * b * kvd + 2 * b * start * kvd)
        bb, by = bound_ms(nbytes, 4.0 * b * hq * (start + 1) * d)
        cases2.append(dict(shape=f"D={d} Hkv={hkv} B={b} S={s} start={start}", max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, SDPA {lib_ms:.4f})")

        rows = torch.randn(L, b, kvd, device="cuda", dtype=bf, generator=gen)
        starts_w = starts.clone()
        starts_w[-1] = s  # dropped
        ref = kc.clone()
        fd.write_all_layers_plain(ref, rows, starts_w)
        got = fd.write_all_layers(kc.clone(), rows, starts_w)
        torch.cuda.synchronize()
        err3 = check(f"K3 L={L} B={b} S={s} KVD={kvd}", got, ref, tol=1e-30)  # exact copy
        cache_t = kc.clone()
        ms = timer(lambda: fd.write_all_layers(cache_t, rows, starts_t))
        plain_ms = timer(lambda: fd.write_all_layers_plain(cache_t, rows, starts_t))
        bidx = torch.arange(b, device="cuda")
        sidx = starts_t.long()

        def index_put():  # one advanced-index assignment = index_put_
            cache_t[:, bidx, sidx] = rows

        lib_ms = timer(index_put)
        bb, by = bound_ms(2 * rows.numel() * 2, 0)
        cases3.append(dict(shape=f"L={L} B={b} S={s} KVD={kvd}", max_abs_err=err3, ms=ms,
                           plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}, plain {plain_ms:.4f}, index_put_ {lib_ms:.4f})")
        del kc, vc, kd, vd, cache_t, ref
    results["decode_attention"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/decode_attention.cu",
        replaces="nfai_tpu/ops/fused_decode.py:465", also_replaces=["nfai_tpu/ops/fused_decode.py:200"],
        headline=cases2[1], cases=cases2,
    )
    results["kv_write"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/kv_write.cu",
        replaces="nfai_tpu/ops/fused_decode.py:601", also_replaces=[],
        headline=cases3[1], cases=cases3,
    )

    # K4: prefill chunks against a layer of the [B, S, KVD] cache, at the
    # 1B's heads (D=64), model C's (Hkv=4, D=128) and the 3B's (r = 3)
    cases4 = []
    for hq, hkv, d, b, t, s, off in ((32, 8, 64, 1, 256, 1024, 0), (32, 8, 64, 1, 256, 1024, 256),
                                     (32, 8, 64, 8, 128, 1024, 0), (32, 8, 64, 2, 16, 512, 100),
                                     (32, 4, 128, 1, 256, 1024, 0), (32, 4, 128, 1, 256, 1024, 256),
                                     (32, 4, 128, 8, 128, 1024, 0), (24, 8, 128, 1, 256, 1024, 256)):
        kvd = hkv * d
        q = torch.randn(b, t, hq, d, device="cuda", dtype=bf, generator=gen)
        kc = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        offs = torch.full((b,), off, dtype=torch.int32, device="cuda")
        scale = d**-0.5
        got = pa.flash_prefill_attention(q, kc, vc, offs, scale)
        torch.cuda.synchronize()
        err = check(f"K4 D={d} Hkv={hkv} B={b} T={t} S={s} offset={off}", got,
                    pa.flash_prefill_attention_plain(q, kc, vc, offs, scale), row_dims=2)
        ms = timer(lambda: pa.flash_prefill_attention(q, kc, vc, offs, scale))
        plain_ms = timer(lambda: pa.flash_prefill_attention_plain(q, kc, vc, offs, scale), iters=3)
        span = off + t
        qt = q.transpose(1, 2)
        kd = kc[:, :span].view(b, span, hkv, d).transpose(1, 2).contiguous()
        vd = vc[:, :span].view(b, span, hkv, d).transpose(1, 2).contiguous()
        mask = (torch.arange(span, device="cuda")[None, :]
                <= (off + torch.arange(t, device="cuda"))[:, None])
        lib_ms = timer(lambda: nnf.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True))
        visible = t * off + t * (t + 1) // 2
        nbytes = 2 * (2 * b * t * hq * d + 2 * b * span * kvd)
        bb, by = bound_ms(nbytes, 4.0 * b * hq * d * visible)
        cases4.append(dict(shape=f"D={d} Hkv={hkv} B={b} T={t} S={s} offset={off}", max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, SDPA {lib_ms:.4f})")
    results["prefill_attention"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/prefill_attention.cu",
        replaces="nfai_tpu/ops/prefill_attention.py:267", also_replaces=[],
        headline=cases4[2], cases=cases4,
    )
    results.update(_kernels_k5_k6(torch, timer, gen))
    results.update(_kernels_k7(torch, timer, gen))
    results.update(_kernels_k8_k9(torch, timer, gen))
    return results


def _kernels_k5_k6(torch, timer, gen) -> dict:
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_mlp as fm
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import dequant

    bf = torch.bfloat16
    results = {}
    # K5 at the 1B MLP (K = H = 2048, F = 8192; decode rows 1 and 8, prefill
    # 256 and 1024) and at the 3B's (K = H = 3072, rows 1, 8 and 256)
    cases = []
    for k, f, h, rows in ((2048, 8192, 2048, (1, 8, 256, 1024)), (3072, 8192, 3072, (1, 8, 256))):
        gu, dn = _q4_weight(torch, 2 * f, k, gen), _q4_weight(torch, h, f, gen)

        def replaced_route(x):  # what K5 replaces: K1 gate_up, silu * up, K1 down
            g_u = qm.q4_matmul(x, gu)
            return qm.q4_matmul((nnf.silu(g_u[:, :f].float()) * g_u[:, f:].float()).to(bf), dn)

        for m in rows:
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = fm.fused_mlp(x, gu, dn)
            torch.cuda.synchronize()
            err = check(f"K5 M={m} K={k} F={f} H={h}", got, fm.fused_mlp_plain(x, gu, dn), row_dims=1)
            ms = timer(lambda: fm.fused_mlp(x, gu, dn))
            plain_ms = timer(lambda: fm.fused_mlp_plain(x, gu, dn), iters=3)
            route_ms = timer(lambda: replaced_route(x))
            nbytes = m * k * 2 + (2 * f * k + h * f) * 3 // 4 + m * h * 2
            b, by = bound_ms(nbytes, 2.0 * m * k * 2 * f + 2.0 * m * f * h)
            cases.append(dict(shape=f"M={m}" + ("" if k == 2048 else f" H={h}"), max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                              replaced_route_ms=route_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
                f"replaced route K1 + silu*mul + K1 {route_ms:.4f}; no single library call)")
        del gu, dn
    results["fused_mlp"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/fused_mlp.cu",
        replaces="nfai_tpu/ops/fused_mlp.py:201", also_replaces=[],
        headline=cases[1], cases=cases,
    )

    # K6: the tied Q6_K head, Q8_0 wqkv and down, model B's Q6_K wv and
    # w_down; rows 1, 8, 256 and, below the head, 1024 (B's batch prefill)
    shapes = {"Q6_K head": (2048, 128256, 16, 32), "Q8_0 wqkv": (2048, 3072, 32, 127),
              "Q8_0 down": (8192, 2048, 32, 127), "Q6_K wv": (2048, 512, 16, 32),
              "Q6_K w_down": (8192, 2048, 16, 32), "C Q6_K head": (2048, 151936, 16, 32)}
    cases = []
    for label, (k, n, group, qmax) in shapes.items():
        w = _q8_weight(torch, n, k, group, qmax, gen)
        wd = dequant(w).to(bf)
        for m in (1, 8, 256) if label.endswith("head") else (1, 8, 256, 1024):
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = qm.q8_matmul(x, w)
            torch.cuda.synchronize()
            err = check(f"K6 {label} M={m} K={k} N={n} g{group}", got, qm.matmul_plain(x, w),
                        row_dims=1)
            ms = timer(lambda: qm.q8_matmul(x, w))
            plain_ms = timer(lambda: qm.matmul_plain(x, w), iters=3)
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            nbytes = m * k * 2 + n * k + n * (k // group) * 4 + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * n * k)
            cases.append(dict(shape=f"{label} M={m}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b, bound_by=by, library_ms=lib_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
                f"cuBLAS on dequantized bf16 {lib_ms:.4f})")
        # with mins (Q5_K / Q2_K kinds): checked, not timed
        if label == "Q8_0 wqkv":
            wm = _q8_weight(torch, n, k, group, qmax, gen, with_mins=True)
            xm = torch.randn(8, k, device="cuda", dtype=bf, generator=gen)
            check(f"K6 {label} with mins M=8", qm.q8_matmul(xm, wm), qm.matmul_plain(xm, wm),
                  row_dims=1)
        del w, wd
    results["q8_matmul"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/q8_matmul.cu",
        replaces="nfai_tpu/ops/qmatmul.py:190", also_replaces=["nfai_tpu/ops/qmatmul.py:541"],
        headline=next(c for c in cases if c["shape"] == "Q6_K head M=8"), cases=cases,
    )
    return results


def _shuffled_tables(torch, b, n_p, n_pages, seed, device="cuda"):
    """[b, n_p] int32 block tables: distinct page ids drawn without order
    from 1 .. n_pages - 1 (page 0 is the sink), never contiguous runs."""
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))[: b * n_p] + 1
    return perm.view(b, n_p).to(torch.int32).to(device)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _kernels_k7(torch, timer, gen) -> dict:
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_decode as fd
    from nfai_tpu_torch.ops import paged_attention as pa

    bf = torch.bfloat16
    ragged = [1, 127, 128, 129, 500, 777, 1000, 1024]
    # (label, Hq, Hkv, D, B, page size, lengths); every case is checked per
    # batch row; the 1B's heads (Hkv=8, D=64), model C's (Hkv=4, D=128), the
    # 3B's (Hq=24, r = 3)
    cases_in = (("B=8 ps=128 S=1024", 32, 8, 64, 8, 128, [1024] * 8),
                ("B=8 ps=128 ragged", 32, 8, 64, 8, 128, ragged),
                ("B=1 ps=128 len=512", 32, 8, 64, 1, 128, [512]),
                ("B=8 ps=16 S=1024", 32, 8, 64, 8, 16, [1024] * 8),
                ("B=8 ps=16 ragged", 32, 8, 64, 8, 16, [1, 15, 16, 17, 500, 777, 1000, 1024]),
                ("D=128 Hkv=4 B=8 ps=128 S=1024", 32, 4, 128, 8, 128, [1024] * 8),
                ("D=128 Hkv=4 B=8 ps=128 ragged", 32, 4, 128, 8, 128, ragged),
                ("D=128 Hkv=4 B=1 ps=128 len=512", 32, 4, 128, 1, 128, [512]),
                ("D=128 Hq=24 Hkv=8 B=8 ps=128 ragged", 24, 8, 128, 8, 128, ragged))
    cases = []
    for label, hq, hkv, d, b, ps, lens in cases_in:
        scale = d**-0.5
        n_p = -(-max(lens) // ps)
        n_pages = b * n_p + 16  # >= 80 pages at ps = 128
        kp = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        vp = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        tables = _shuffled_tables(torch, b, n_p, n_pages, seed=len(cases))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen)
        got = pa.paged_decode_attention(q, kp, vp, tables, lengths, scale)
        torch.cuda.synchronize()
        err = check(f"K7 {label} lengths={lens}", got,
                    pa.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale), row_dims=1)
        ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, tables, lengths, scale))
        plain_ms = timer(lambda: pa.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale), iters=3)
        s = n_p * ps
        tl = tables.long()
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]

        def gather_sdpa():  # the yardstick: one page gather, then SDPA over the dense view
            kg = kp[:, tl].view(hkv, b, s, d).transpose(0, 1)
            vg = vp[:, tl].view(hkv, b, s, d).transpose(0, 1)
            return nnf.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask,
                                                    scale=scale, enable_gqa=True)

        lib_ms = timer(gather_sdpa)
        keys = sum(lens)
        nbytes = 2 * (2 * b * hq * d) + 4 * (tables.numel() + b) + 2 * (2 * keys * hkv * d)
        bb, by = bound_ms(nbytes, 4.0 * hq * d * keys)
        # K2 at the same dense shape: lengths[b] - 1 cached tokens plus the folded-in new one
        kc = torch.randn(b, max(lens), hkv * d, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(b, max(lens), hkv * d, device="cuda", dtype=bf, generator=gen)
        kn = torch.randn(b, hkv * d, device="cuda", dtype=bf, generator=gen)
        starts = (lengths - 1).contiguous()
        k2_ms = timer(lambda: fd.decode_attention(q, kn, kn, kc, vc, starts, scale))
        cases.append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb,
                          bound_by=by, library_ms=lib_ms, library="page gather + SDPA",
                          k2_same_shape_ms=k2_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, "
            f"page gather + SDPA {lib_ms:.4f}, K2 at the same dense shape {k2_ms:.4f})")
        del kp, vp, kc, vc
    return {"paged_attention": dict(
        route="cuda", source="nfai_tpu_torch/csrc/paged_attention.cu",
        replaces="nfai_tpu/ops/paged_attention.py:113", also_replaces=[],
        headline=cases[0], cases=cases,
    )}


def _routing_layout(torch, n_tokens, e, used, gen):
    """A batch of n_tokens each routed to `used` distinct experts drawn at
    random (a random-weight router's routing), laid out group-aligned as
    moe_ffn lays it out: (x_pad rows, dst, block_group, block_rows, tm,
    distinct experts hit)."""
    from nfai_tpu_torch.models.llama import group_tm, moe_group_layout

    idx = torch.rand(n_tokens, e, device="cuda", generator=gen).argsort(-1)[:, :used]
    rows = n_tokens * used
    tm = group_tm(rows)
    _, dst, bg, br, m_pad = moe_group_layout(idx.reshape(-1), rows, e, tm)
    return m_pad, dst, bg, br, tm, int(torch.unique(idx).numel())


def _kernels_k8_k9(torch, timer, gen) -> dict:
    """K8 (4-bit) and K9 (8-bit) at model C's expert shapes: gate/up
    [128, 768, 2048] and down [128, 2048, 768], at the decode layouts of a
    batch-1 and a batch-8 routing (8 and 64 rows, tm 8), a 256-token
    prefill chunk (2048 rows, tm 32) and the batch phase's 8 x 128-token
    prefill (8192 rows, tm 128); per routed row against the plain version.
    Yardstick: the hit experts of every block dequantized to bf16, then one
    torch.bmm over the blocks."""
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import Q4Tensor, Q8Tensor, dequant

    bf = torch.bfloat16
    e, used, h, f = 128, 8, 2048, 768

    def stack(kind, n, k, group=32, with_mins=False):
        if kind == "q4":
            return Q4Tensor(
                torch.randint(0, 256, (e, n, k // 2), dtype=torch.uint8, device="cuda", generator=gen),
                torch.rand(e, n, k // 32, device="cuda", generator=gen) * 2e-3 + 1e-4,
                torch.rand(e, n, k // 32, device="cuda", generator=gen) * 1.5e-2, k, n)
        return Q8Tensor(
            torch.randint(-32, 32, (e, n, k), dtype=torch.int8, device="cuda", generator=gen),
            torch.rand(e, n, k // group, device="cuda", generator=gen) * 1e-3 + 1e-5,
            torch.rand(e, n, k // group, device="cuda", generator=gen) * 1e-2 if with_mins else None,
            k, n, group)

    weights = {"grouped_q4": {"gate/up": stack("q4", f, h), "down": stack("q4", h, f)},
               "grouped_q8": {"Q6_K down": stack("q8", h, f, group=16)}}
    layouts = {"batch 1": _routing_layout(torch, 1, e, used, gen),
               "batch 8": _routing_layout(torch, 8, e, used, gen),
               "prefill 256": _routing_layout(torch, 256, e, used, gen),
               "batch prefill 8x128": _routing_layout(torch, 8 * 128, e, used, gen)}
    results = {}
    for name, ws in weights.items():
        cases = []
        for label, w in ws.items():
            per_expert = sum(t[0].numel() * t.element_size()
                             for t in (w.qs, w.scales) + (() if w.mins is None else (w.mins,)))
            for lname, (m_pad, dst, bg, br, tm, hit) in layouts.items():
                rows = dst.numel()
                x = torch.zeros(m_pad, w.k, device="cuda", dtype=bf)
                x[dst] = torch.randn(rows, w.k, device="cuda", dtype=bf, generator=gen)
                got = qm.qmatmul_grouped(x, w, bg, tm, br)
                torch.cuda.synchronize()
                want = qm.qmatmul_grouped_plain(x, w, bg, tm, br)
                err = check(f"{'K8' if name == 'grouped_q4' else 'K9'} {label} {lname}: {rows} rows, "
                            f"m_pad {m_pad}, tm {tm}, {hit} experts hit", got[dst], want[dst],
                            row_dims=1)
                if bool((got.float().abs().sum(-1) == 0).sum() != m_pad - rows):
                    raise AssertionError("padding rows must be zero and routed rows not")
                ms = timer(lambda: qm.qmatmul_grouped(x, w, bg, tm, br))
                plain_ms = timer(lambda: qm.qmatmul_grouped_plain(x, w, bg, tm, br), iters=3)
                g = bg.long()
                xb = x.view(m_pad // tm, tm, w.k)
                lib_ms = timer(lambda: torch.bmm(xb, dequant(w._map(lambda t: t[g])).to(bf).transpose(1, 2)),
                               iters=3)
                nbytes = hit * per_expert + rows * (w.k + w.n) * 2 + bg.numel() * 8
                b, by = bound_ms(nbytes, 2.0 * rows * w.k * w.n)
                cases.append(dict(shape=f"{label} K={w.k} N={w.n} {lname} ({rows} rows, tm {tm})",
                                  max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                                  bound_by=by, library_ms=lib_ms,
                                  library="dequantized hit experts + torch.bmm"))
                log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
                    f"dequantize hit experts + bmm {lib_ms:.4f})")
                del x, want, got
        if name == "grouped_q8":  # with mins (Q5_K / Q2_K kinds), g32: checked, not timed
            wm = stack("q8", h, f, group=32, with_mins=True)
            m_pad, dst, bg, br, tm, _ = layouts["batch 8"]
            x = torch.zeros(m_pad, f, device="cuda", dtype=bf)
            x[dst] = torch.randn(dst.numel(), f, device="cuda", dtype=bf, generator=gen)
            check("K9 g32 with mins batch 8", qm.qmatmul_grouped(x, wm, bg, tm, br)[dst],
                  qm.qmatmul_grouped_plain(x, wm, bg, tm, br)[dst], row_dims=1)
        results[name] = dict(
            route="cuda", source="nfai_tpu_torch/csrc/grouped_matmul.cu",
            replaces="nfai_tpu/ops/qmatmul.py:1098" if name == "grouped_q4" else "nfai_tpu/ops/qmatmul.py:1144",
            also_replaces=["nfai_tpu/ops/qmatmul.py:1014"],
            headline=cases[1], cases=cases,
        )
    return results


# ---------------------------------------------------------------------------
# phases: serve, batch, parity


def phase_serve(torch, path) -> dict:
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine

    t0 = time.perf_counter()
    engine = InferenceEngine(path, EngineConfig(max_seq_len=1024), device="cuda")
    torch.cuda.synchronize()
    log(f"  loaded {engine.model_name}: {engine.model_cfg.n_layers} layers, "
        f"hidden {engine.model_cfg.hidden_size}, vocab {engine.model_cfg.vocab_size} "
        f"in {time.perf_counter() - t0:.1f}s; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    session = ChatSession(engine, SamplingParams(temperature=0.0, max_new_tokens=64))
    prompts = [
        "Hello! Who are you?",
        "Summarise this: " + " ".join(f"item{i}" for i in range(45)),  # > 256 tokens
        "Thanks. One more line, please.",
    ]
    reqs = []
    for p in prompts:
        text = session.send(p)
        m = session.last_metrics
        reqs.append(dict(prompt_tokens=m.prompt_tokens, new_tokens=m.new_tokens,
                         ttft_ms=m.ttft_s * 1e3, decode_tok_s=m.decode_tokens_per_s))
        log(f"  request: {m.prompt_tokens} prompt tok, {m.new_tokens} new, "
            f"TTFT {m.ttft_s * 1e3:.1f} ms, decode {m.decode_tokens_per_s:.1f} tok/s, "
            f"{len(text)} chars")
        if m.new_tokens <= 0:
            raise AssertionError("a request produced no tokens")
    if max(r["prompt_tokens"] for r in reqs) <= 256:
        raise AssertionError("no prompt exceeded one 256-token prefill chunk")
    return {"engine": engine, "requests": reqs}


def phase_batch(torch, engine, kernels_mod) -> dict:
    from nfai_tpu_torch.models import decode_loop, prefill_step

    b, t, n = 8, 128, 64
    cfg = engine.model_cfg
    cache = engine.new_cache(b)
    if cache.max_seq != 1024:
        raise AssertionError("batch phase expects S = 1024")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (b, t), device="cuda", generator=gen)
    positions = torch.arange(t, device="cuda")[None].expand(b, t).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(engine.params, cfg, tokens, positions,
                                 torch.full((b,), t - 1, device="cuda"), cache)
    first = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pos = torch.full((b,), t, device="cuda")
    decode_loop(engine.params, cfg, first, pos, cache, gen, 2)  # warm-up steps
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    t0 = time.perf_counter()
    toks, _, cache, _ = decode_loop(engine.params, cfg, first, pos, cache, gen, n)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    per_step = {k.name: (k.launches - before[k.name]) / n for k in kernels_mod.KERNELS.values()}
    if not bool((toks >= 0).all() & (toks < cfg.vocab_size).all()):
        raise AssertionError("decode produced out-of-range token ids")
    syncs, where = _syncs_per_step(torch, engine, (first, pos + n, cache, gen))
    out = dict(prefill_ms=prefill_s * 1e3, prefill_tok_s=b * t / prefill_s,
               decode_ms_per_step=dec_s / n * 1e3, decode_tok_s=b * n / dec_s,
               launches_per_step=per_step, host_syncs_per_step=syncs,
               decode_bound_ms={f"batch {bb}": _decode_bound_ms(engine, bb) for bb in (1, b)},
               state=(first, pos + n + 2, cache, gen))
    log(f"  batch {b}, prompt {t}, S 1024: prefill {prefill_s * 1e3:.1f} ms "
        f"({b * t / prefill_s:.0f} tok/s); decode {n} steps {dec_s * 1e3:.1f} ms "
        f"= {dec_s / n * 1e3:.2f} ms/step, {b * n / dec_s:.1f} tok/s; "
        f"kernel launches per step {per_step}; host syncs per step {syncs} {where}; "
        f"byte bound of a step {out['decode_bound_ms']} ms")
    return out


def _syncs_per_step(torch, engine, state, n=2):
    """Host syncs per decode step, counted with torch.cuda.set_sync_debug_mode
    ("warn") over n steps; returns (syncs per step, the distinct warnings)."""
    import warnings

    from nfai_tpu_torch.models import decode_loop

    tok, pos, cache, gen = state
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode_loop(engine.params, engine.model_cfg, tok, pos, cache, gen, n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0][:120] for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(syncs) / n, sorted(set(syncs))


def _decode_bound_ms(engine, batch: int) -> float:
    """The least time of one decode step at `batch` rows: every weight the
    step reads, once, over the HBM rate, from the containers loaded (a MoE
    layer reads the experts a random routing is expected to hit:
    E (1 - (1 - k/E)^batch) of each stack). Caches and activations are
    left out."""
    from nfai_tpu_torch.ops.qtensor import LayerList

    cfg = engine.model_cfg

    def nbytes(w):
        if isinstance(w, LayerList):
            return sum(nbytes(it) for it in w.items)
        if hasattr(w, "qs"):
            return sum(t.numel() * t.element_size()
                       for t in (w.qs, w.scales) + (() if w.mins is None else (w.mins,)))
        return w.numel() * w.element_size()

    total = nbytes(engine.params["lm_head"])
    for key, w in engine.params["layers"].items():
        part = nbytes(w)
        if key.endswith("_exps"):
            e, k = cfg.n_experts, cfg.n_experts_used
            part *= (1 - (1 - k / e) ** batch)
        total += part
    return total / PEAK_BYTES_S * 1e3


def phase_profile(torch, engine, state, tables=None) -> dict:
    """Device busy share and per-kernel device time of 8 decode steps at
    batch 8 (the wall clock includes the host's launch work); through the
    page pool when `tables` are given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nfai_tpu_torch.models import decode_loop, paged_decode_loop

    tok, pos, cache, gen = state
    n = 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if tables is None:
            decode_loop(engine.params, engine.model_cfg, tok, pos, cache, gen, n)
        else:
            paged_decode_loop(engine.params, engine.model_cfg, tok, pos, cache, tables, gen, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    n_kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # kernels only: ops would double count
            continue
        n_kernels += ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + dev_us / 1e3
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    out = dict(steps=n, kernels_per_step=n_kernels / n,
               wall_ms_per_step=wall_ms / n, device_ms_per_step=busy_ms / n,
               device_idle_share=1.0 - busy_ms / wall_ms,
               top_kernels_ms_per_step={k[:60]: v / n for k, v in top})
    log(f"  profiled {n} steps: {n_kernels / n:.0f} kernels/step, wall {wall_ms / n:.2f} ms/step, device busy "
        f"{busy_ms / n:.2f} ms/step, idle share {out['device_idle_share']:.3f}")
    for k, v in top:
        log(f"    {v / n:8.4f} ms/step  {k[:90]}")
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def phase_parity(torch, path2, kind) -> dict:
    """A 2-layer full-width copy on cuda and on cpu: prefill logits and 4
    teacher-forced decode steps; for the Q4_K kind also one prefill chunk
    of 1100 rows (above MLP_FUSED_MAX_ROWS: the mlp_prefill route)."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import KVCache, decode_step, prefill_step
    from nfai_tpu_torch.ops.fused_mlp import MLP_FUSED_MAX_ROWS
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    from nfai_tpu_torch.kernels import KERNELS

    torch.set_num_threads(os.cpu_count() or 8)
    ecfg = EngineConfig(max_seq_len=256)
    engines = {dev: InferenceEngine(path2, ecfg, device=dev) for dev in ("cuda", "cpu")}
    before = {k.name: k.launches for k in KERNELS.values()}
    rels = []

    def compare(name, logits):
        check(f"{kind} {name}", logits["cuda"], logits["cpu"])
        rels.append(errors(logits["cuda"], logits["cpu"])[1])

    ids = engines["cpu"].tokenizer.encode("Parity between the card and the plain versions.")
    logits, caches = {}, {}
    for dev, e in engines.items():
        logits[dev], caches[dev] = e.prefill(e.new_cache(1), ids)
    compare(f"prefill logits ({len(ids)} tokens)", logits)
    pos = len(ids)
    for step, tok in enumerate((17, 99, 200, 42)):
        for dev, e in engines.items():
            logits[dev], caches[dev] = decode_step(
                e.params, e.model_cfg, torch.tensor([tok], device=dev),
                torch.tensor([pos], device=dev), caches[dev])
        compare(f"decode step {step} logits", logits)
        pos += 1
    if kind == "q4_k":
        t = 1100
        if not (t > MLP_FUSED_MAX_ROWS and engines["cuda"].params["fused_mlp"]):
            raise AssertionError("the Q4_K copy should take the fused-MLP route")
        tokens = torch.randint(0, 256, (1, t), generator=torch.Generator().manual_seed(1))
        for dev, e in engines.items():
            logits[dev], _ = prefill_step(
                e.params, e.model_cfg, tokens.to(dev), torch.arange(t, device=dev)[None],
                torch.tensor([t - 1], device=dev),
                KVCache.zeros(e.model_cfg, 1, 1152, e.cache_dtype, e.device))
        compare(f"prefill logits ({t} rows in one chunk: mlp_prefill)", logits)
        _paged_parity(torch, engines, ids, compare)
    launches = {k.name: k.launches - before[k.name] for k in KERNELS.values()}
    if kind == "llama_3b":  # K = 3072, head_dim 128; K5 where mlp_eligible takes H = 3072
        cfg = engines["cuda"].model_cfg
        log(f"  llama_3b copy (hidden {cfg.hidden_size}, head_dim {cfg.head_dim}, fused MLP "
            f"{engines['cuda'].params['fused_mlp']}) launches: {launches}")
        if cfg.head_dim != 128 or not engines["cuda"].params["fused_mlp"] or any(
                launches[n] <= 0 for n in ("q4_matmul", "fused_mlp", "decode_attention",
                                           "prefill_attention")):
            raise AssertionError(f"the 3B-width copy did not take its route: {launches}")
    return {"max_rel_err": max(rels), "launches": launches}


def phase_parity_moe(torch, path2) -> dict:
    """A 2-layer model C copy on cuda and on cpu. First each layer's MoE FFN
    with one routing fed to both sides (the CPU's), per row within TOL; then
    the whole model on a ChatML prompt: the logits of every prompt row and of
    4 teacher-forced decode steps, per row, leaving out the rows whose own
    token has a near-tie in the router (k-th and (k+1)-th router logits
    within NEAR_TIE on the CPU, at any layer), where the card may rightly
    pick another expert; their count is printed."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import KVCache, decode_step, forward, logits_for
    from nfai_tpu_torch.models import llama as tllama
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(os.cpu_count() or 8)
    engines = {dev: InferenceEngine(path2, EngineConfig(max_seq_len=256), device=dev)
               for dev in ("cuda", "cpu")}
    cfg = engines["cpu"].model_cfg
    route = tllama.moe_route
    try:
        x = torch.randn(24, cfg.hidden_size, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
        for layer in range(cfg.n_layers):
            vals, idx = route(x, engines["cpu"].params["layers"]["router"][layer],
                              cfg.n_experts_used, cfg.norm_topk_prob)
            tllama.moe_route = lambda xx, *_: (vals.to(xx.device), idx.to(xx.device))
            ffn = {dev: tllama.moe_ffn(e.params, cfg, x.to(e.device), layer)
                   for dev, e in engines.items()}
            kind = type(engines["cpu"].params["layers"]["w_down_exps"].layer(layer)).__name__
            check(f"qwen3moe layer {layer} MoE FFN (down {kind}), one routing fed to both", ffn["cuda"],
                  ffn["cpu"], row_dims=1)
        margins = []

        def recording(xx, router, n_used, norm_topk):
            if xx.device.type == "cpu":
                top = torch.topk(xx.float() @ router.float(), n_used + 1, dim=-1).values
                margins.append(top[:, n_used - 1] - top[:, n_used])
            return route(xx, router, n_used, norm_topk)

        tllama.moe_route = recording
        tok = engines["cpu"].tokenizer
        ids = tok.encode(engines["cpu"].chat_template.render(
            [{"role": "user", "content": "Parity between the card and the plain versions."}]),
            add_bos=False)
        n = len(ids)
        logits, caches = {}, {}
        for dev, e in engines.items():
            cache = KVCache.zeros(cfg, 1, 256, e.cache_dtype, e.device)
            h, caches[dev] = forward(e.params, cfg, torch.tensor([ids], device=e.device),
                                     torch.arange(n, device=e.device)[None], cache)
            logits[dev] = logits_for(e.params, h[0])
        rows = [(f"prompt row {i}", logits["cuda"][i], logits["cpu"][i]) for i in range(n)]
        near = [float(torch.stack([m[i] for m in margins]).min()) < NEAR_TIE for i in range(n)]
        pos = n
        for step, t in enumerate((17, 99, 200, 42)):
            margins.clear()
            for dev, e in engines.items():
                logits[dev], caches[dev] = decode_step(
                    e.params, cfg, torch.tensor([t], device=e.device),
                    torch.tensor([pos], device=e.device), caches[dev])
            rows.append((f"decode step {step}", logits["cuda"][0], logits["cpu"][0]))
            near.append(float(torch.stack([m[0] for m in margins]).min()) < NEAR_TIE)
            pos += 1
    finally:
        tllama.moe_route = route
    kept = [(name, a, b) for (name, a, b), nt in zip(rows, near) if not nt]
    log(f"  qwen3moe: {sum(near)} of {len(rows)} rows left out as router near-ties "
        f"(gap < {NEAR_TIE}); {len(kept)} compared")
    if len(kept) < len(rows) // 2:
        raise AssertionError("too many near-ties for the parity to mean anything")
    got = torch.stack([a.float().cpu() for _, a, _ in kept])
    want = torch.stack([b.float().cpu() for _, _, b in kept])
    check(f"qwen3moe logits of {len(kept)} rows (prompt {n} tokens, 4 decode steps)", got, want,
          row_dims=1)
    return dict(rows=len(rows), near_ties=sum(near), max_rel_err=errors(got, want, 1)[1])


def _paged_parity(torch, engines, ids, compare) -> None:
    """The same prompt and 4 teacher-forced steps through the page pool
    (a shuffled 2-page table of a 12-page pool): K7 and K4 on the gathered
    pages on the card against their plain versions on the CPU."""
    from nfai_tpu_torch.models import decode_step, paged_prefill_step
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    perm = torch.randperm(11, generator=torch.Generator().manual_seed(2))[:2] + 1
    logits, pools, tables = {}, {}, {}
    n = len(ids)
    for dev, e in engines.items():
        tables[dev] = perm.view(1, 2).to(torch.int32).to(dev)
        pools[dev] = PagedKVCache.zeros(e.model_cfg, 12, 128, e.cache_dtype, dev)
        logits[dev], pools[dev] = paged_prefill_step(
            e.params, e.model_cfg, torch.tensor([ids], device=dev), torch.arange(n, device=dev)[None],
            torch.tensor([n - 1], device=dev), pools[dev], tables[dev])
    compare(f"paged prefill logits ({n} tokens, table {perm.tolist()})", logits)
    pos = n
    for step, tok in enumerate((17, 99, 200, 42)):
        for dev, e in engines.items():
            logits[dev], pools[dev] = decode_step(
                e.params, e.model_cfg, torch.tensor([tok], device=dev),
                torch.tensor([pos], device=dev), pools[dev], page_tables=tables[dev])
        compare(f"paged decode step {step} logits", logits)
        pos += 1


def _pcts(xs) -> dict:
    xs = sorted(xs)
    at = lambda f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
    return dict(p50=at(0.5), p90=at(0.9), max=xs[-1])


def _server_parity(torch, engine, kernels_mod) -> dict:
    """Paged vs dense forwards on the card, outside the main-path window:
    a 300-token prefill through a shuffled table (paged_prefill_step)
    against prefill_step, then 4 rows of ragged length (prefilled with
    paged_prefill_step / prefill_slot_step) decode 8 teacher-forced steps at
    batch 4 through one-step paged decodes and dense decode_step; every
    paged step must launch K7 exactly once per layer.

    Model A's MLP is K5, whose f32 atomics sum in another order on every
    run, so two identical dense runs of the 16 layers differ by about as
    much as the tolerance (measured here: `k5_dense_noise`). The check is
    therefore made with A's weights on the two-K1 MLP route, which is
    deterministic: K4 sees the same bytes on both sides, and K7 walks keys
    in K2's order, so paged and dense must agree well inside 2e-2 (exactly,
    by design). The K5 route's paged-vs-dense error is reported beside its
    noise floor."""
    from nfai_tpu_torch.models import (
        KVCache, decode_step, paged_prefill_step, prefill_slot_step, prefill_step,
    )
    from nfai_tpu_torch.ops.paged_attention import K7
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    cfg, dev = engine.model_cfg, engine.device
    params = dict(engine.params, fused_mlp=False)  # the deterministic route (see above)
    ps, n_p, lens = 128, 8, [300, 137, 77, 255]
    pool = PagedKVCache.zeros(cfg, len(lens) * n_p + 9, ps, engine.cache_dtype, dev)
    tables = _shuffled_tables(torch, len(lens), n_p, pool.n_pages, seed=7, device=dev)
    dense = KVCache.zeros(cfg, len(lens), n_p * ps, engine.cache_dtype, dev)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 1000, (1, n), generator=gen).to(dev) for n in lens]
    rels = []

    def prefill_args(i):
        n = lens[i]
        return (prompts[i], torch.arange(n, device=dev)[None], torch.tensor([n - 1], device=dev))

    for i in range(len(lens)):
        lp, pool = paged_prefill_step(params, cfg, *prefill_args(i), pool, tables[i:i + 1])
        ld, dense = prefill_slot_step(params, cfg, *prefill_args(i), dense, i)
        if i == 0:
            ref, _ = prefill_step(params, cfg, *prefill_args(0),
                                  KVCache.zeros(cfg, 1, n_p * ps, engine.cache_dtype, dev))
            check("paged vs dense prefill logits (300 tokens, shuffled table)", lp, ref)
            check("prefill_slot_step vs prefill_step logits (300 tokens)", ld, ref)
            rels += [errors(lp, ref)[1], errors(ld, ref)[1]]
    positions = torch.tensor(lens, device=dev)
    for step in range(8):
        toks = torch.randint(0, 1000, (len(lens),), generator=gen).to(dev)
        before = K7.launches
        lp, pool = decode_step(params, cfg, toks, positions, pool, page_tables=tables)
        if K7.launches - before != cfg.n_layers:
            raise AssertionError(f"a paged decode step launched K7 {K7.launches - before} times, "
                                 f"not once per layer ({cfg.n_layers})")
        ld, dense = decode_step(params, cfg, toks, positions, dense)
        check(f"paged vs dense decode step {step} logits (batch 4, positions "
              f"{positions.tolist()})", lp, ld, row_dims=1)
        rels.append(errors(lp, ld, row_dims=1)[1])
        positions = positions + 1
    # the K5 route: paged vs dense, and the same dense prefill twice
    k5 = engine.params
    fresh = lambda: KVCache.zeros(cfg, 1, n_p * ps, engine.cache_dtype, dev)  # noqa: E731
    d1, _ = prefill_step(k5, cfg, *prefill_args(0), fresh())
    d2, _ = prefill_step(k5, cfg, *prefill_args(0), fresh())
    pool.k.zero_()
    pool.v.zero_()
    p1, _ = paged_prefill_step(k5, cfg, *prefill_args(0), pool, tables[:1])
    out = {"max_rel_err": max(rels), "k5_paged_vs_dense": errors(p1, d1)[1],
           "k5_dense_noise": errors(d2, d1)[1]}
    log(f"  K5 route, 300-token prefill: paged vs dense rel {out['k5_paged_vs_dense']:.3e}, two "
        f"dense runs rel {out['k5_dense_noise']:.3e} (K5's atomics); not checked")
    return out


def _paged_decode_timing(torch, engine, kernels_mod) -> dict:
    """Batch-8 paged decode as the batch phase runs dense decode (positions
    from 128, 64 steps, pool pages filled at random), then 8 steps under
    the profiler; outside the main-path window."""
    from nfai_tpu_torch.models import paged_decode_loop
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    cfg, b, n, ps, dev = engine.model_cfg, 8, 64, 128, engine.device
    pool = PagedKVCache.zeros(cfg, b * 8 + 9, ps, engine.cache_dtype, dev)
    pool.k.normal_(0, 0.5)
    pool.v.normal_(0, 0.5)
    tables = _shuffled_tables(torch, b, 8, pool.n_pages, seed=11, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, 1000, (b,), device=dev, generator=gen)
    pos = torch.full((b,), 128, device=dev)
    paged_decode_loop(engine.params, cfg, tok, pos, pool, tables, gen, 2)  # warm-up
    _sync(torch)
    before = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    t0 = time.perf_counter()
    paged_decode_loop(engine.params, cfg, tok, pos, pool, tables, gen, n)
    _sync(torch)
    dec_s = time.perf_counter() - t0
    per_step = {k.name: (k.launches - before[k.name]) / n for k in kernels_mod.KERNELS.values()}
    if per_step["paged_attention"] != cfg.n_layers:
        raise AssertionError(f"paged decode chunk: {per_step['paged_attention']} K7 launches per "
                             f"step, not one per layer ({cfg.n_layers})")
    log(f"  paged batch {b}, positions 128..{128 + n}: {dec_s / n * 1e3:.2f} ms/step, "
        f"{b * n / dec_s:.1f} tok/s; launches per step {per_step}")
    prof = phase_profile(torch, engine, (tok, pos, pool, gen), tables=tables)
    del pool
    return dict(decode_ms_per_step=dec_s / n * 1e3, decode_tok_s=b * n / dec_s,
                launches_per_step=per_step, profile=prof)


def _drive(be, reqs, max_steps=5000):
    from nfai_tpu_torch.runtime.scheduler import RequestState

    for _ in range(max_steps):
        if be.step() == 0 and be.queue.empty() and not be._parked:
            break
    bad = [r.id for r in reqs if r.state != RequestState.FINISHED]
    if bad:
        raise AssertionError(f"requests {bad} did not finish")


def _batch_engine_run(torch, engine) -> dict:
    """16 requests at once on a paged BatchEngine (max_batch 8, chunk 8):
    8 share a 300-token prefix (2 full pages) with tails of 20-200 tokens,
    8 are distinct (30-700 tokens, one of them 3 prefill chunks); half
    greedy, half temperature 0.8 with top_k 20 or 40 and top_p 0.95."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(5)
    ids = lambda n: torch.randint(0, 1000, (n,), generator=rng).tolist()  # noqa: E731
    prefix = ids(300)
    shared = [prefix + ids(t) for t in (20, 45, 70, 95, 120, 150, 175, 200)]
    distinct = [ids(n) for n in (30, 90, 150, 230, 310, 420, 512, 700)]
    prompts = [shared[0]] + distinct + shared[1:]  # the prefix is published before its sharers arrive
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=64) if i % 2 == 0 else
                SamplingParams(temperature=0.8, top_k=(20, 40)[i // 2 % 2], top_p=0.95,
                               max_new_tokens=64) for i in range(len(prompts))]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    _sync(torch)
    t0 = time.perf_counter()
    reqs = [be.submit(p, s) for p, s in zip(prompts, sampling)]
    _drive(be, reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    n_out = sum(len(r.output_ids) for r in reqs)
    ttft = _pcts([r.ttft_s * 1e3 for r in reqs])
    out = dict(requests=len(reqs), prompt_tokens=sum(map(len, prompts)), new_tokens=n_out,
               wall_s=wall, tok_s=n_out / wall, ttft_ms=ttft, prefix_hits=be.alloc.hits,
               prefix_misses=be.alloc.misses, pool_mb=be.cache.nbytes / 1e6,
               preemptions=be.preemptions)
    log(f"  BatchEngine: {len(reqs)} requests, {out['prompt_tokens']} prompt tokens, {n_out} new "
        f"in {wall:.2f} s = {n_out / wall:.1f} tok/s aggregate; TTFT p50 {ttft['p50']:.1f} / "
        f"p90 {ttft['p90']:.1f} / max {ttft['max']:.1f} ms; prefix hits {be.alloc.hits}, misses "
        f"{be.alloc.misses}; pool {out['pool_mb']:.1f} MB; preemptions {be.preemptions}")
    if be.alloc.hits <= 0:
        raise AssertionError("no prefix-cache hit")
    if any(not 0 < len(r.output_ids) <= 64 for r in reqs):
        raise AssertionError(f"output lengths {[len(r.output_ids) for r in reqs]}")
    del be
    return out


def _preemption_run(torch, engine) -> dict:
    """A pool that admits 8 prompts of 240-250 tokens (2 pages each, 16
    pages) but cannot grow them all to 314 tokens (24 pages): the youngest
    are preempted and recomputed; every request must still finish."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, 1000, (240 + i,), generator=rng).tolist() for i in range(8)]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True, pool_tokens=2048)
    t0 = time.perf_counter()
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=64)) for p in prompts]
    _drive(be, reqs)
    wall = time.perf_counter() - t0
    lens = [len(r.output_ids) for r in reqs]
    log(f"  preemption: pool {be.alloc.n_pages} pages, {be.preemptions} preemptions, outputs {lens}, "
        f"{wall:.2f} s")
    if be.preemptions < 1:
        raise AssertionError("the starved pool preempted nothing")
    if any(not 0 < n <= 64 for n in lens):
        raise AssertionError(f"output lengths {lens}")
    return dict(preemptions=be.preemptions, output_lengths=lens, wall_s=wall,
                full_length=sum(n == 64 for n in lens))


def _http_run(torch, engine) -> dict:
    """ServerState + make_handler on the same engine (127.0.0.1, port 0): 8
    concurrent requests from threads, 4 SSE chat, 3 blocking chat, 1
    /v1/completions; TTFT is the time to the first SSE chunk."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nfai_tpu_torch.runtime.scheduler import BatchEngine
    from nfai_tpu_torch.server import ServerState, make_handler

    batch = BatchEngine(engine, max_batch=8, decode_chunk=8)
    batch.start()
    state = ServerState(engine, batch)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, errs = {}, []

    def hit(i):
        stream = i < 4
        path, body = ("/v1/completions", {"prompt": f"Request {i}: count to ten."}) if i == 7 else (
            "/v1/chat/completions", {"messages": [{"role": "user", "content": f"Request {i}: hello"}]})
        body.update(temperature=0, max_tokens=32, stream=stream)
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                if not stream:
                    obj = json.loads(r.read())
                    c = obj["choices"][0]
                    results[i] = dict(code=r.status, text=c.get("text", c.get("message", {}).get("content")))
                    return
                events, first = [], None
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        if first is None:
                            first = time.perf_counter() - t0
                        events.append(line[6:])
                text = "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                               for e in events[:-1])
                results[i] = dict(code=r.status, text=text, done=events[-1] == "[DONE]",
                                  ttft_ms=first * 1e3)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(f"request {i}: {e!r}")

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batch.close()
    if errs or len(results) != 8:
        raise AssertionError(f"HTTP requests failed: {errs or sorted(results)}")
    if any(r["code"] != 200 or not r["text"] for r in results.values()):
        raise AssertionError(f"HTTP results: {results}")
    if not all(results[i]["done"] for i in range(4)):
        raise AssertionError("an SSE stream did not end in [DONE]")
    if health["requests_served"] != 8:
        raise AssertionError(f"/healthz reports {health['requests_served']} requests served")
    ttft = _pcts([results[i]["ttft_ms"] for i in range(4)])
    log(f"  HTTP: 8 concurrent requests (4 SSE, 3 blocking chat, 1 completion) all 200 in "
        f"{wall:.2f} s; SSE TTFT p50 {ttft['p50']:.1f} / max {ttft['max']:.1f} ms; /healthz "
        f"{health['requests_served']} served")
    return dict(wall_s=wall, sse_ttft_ms=ttft, chars=[len(results[i]["text"]) for i in range(8)])


def phase_server(torch, engine, kernels_mod) -> tuple[dict, dict]:
    """The continuous-batching path on model A's engine. Returns (results,
    the launch counts of its main-path window)."""
    out = dict(paged_vs_dense=_server_parity(torch, engine, kernels_mod),
               paged_decode=_paged_decode_timing(torch, engine, kernels_mod))
    kernels_mod.reset_launches()
    out["batch_engine"] = _batch_engine_run(torch, engine)
    out["preemption"] = _preemption_run(torch, engine)
    out["http"] = _http_run(torch, engine)
    launches = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    log(f"  server main-path launches: {launches}")
    must, must_not = ROUTES["server"]
    if any(launches[name] <= 0 for name in must) or any(launches[n] != 0 for n in must_not):
        raise AssertionError(f"the server path did not take its route: {launches}")
    return out, launches


# ---------------------------------------------------------------------------


# kernels each main path must launch, and those its route must not
ROUTES = {
    "A": ({"q4_matmul", "decode_attention", "kv_write", "prefill_attention", "fused_mlp"},
          {"q8_matmul", "paged_attention", "grouped_q4", "grouped_q8"}),
    "B": ({"q4_matmul", "decode_attention", "kv_write", "prefill_attention", "q8_matmul"},
          {"fused_mlp", "paged_attention", "grouped_q4", "grouped_q8"}),
    "server": ({"q4_matmul", "paged_attention", "prefill_attention", "fused_mlp"},
               {"decode_attention", "kv_write", "q8_matmul", "grouped_q4", "grouped_q8"}),
    "C": ({"q4_matmul", "q8_matmul", "decode_attention", "kv_write", "prefill_attention",
           "grouped_q4", "grouped_q8"}, {"fused_mlp", "paged_attention"}),
    "C server": ({"q4_matmul", "q8_matmul", "paged_attention", "prefill_attention",
                  "grouped_q4", "grouped_q8"}, {"decode_attention", "kv_write", "fused_mlp"}),
}


def _check_moe_step(engine, per_step) -> None:
    """Model C's decode step launches what its route implies: per layer K8
    for gate and up and for a 4-bit down, K9 for a Q6_K down."""
    from nfai_tpu_torch.ops.qtensor import Q4Tensor

    cfg, down = engine.model_cfg, engine.params["layers"]["w_down_exps"]
    q4_down = sum(isinstance(down.layer(i), Q4Tensor) for i in range(cfg.n_layers))
    want = {"grouped_q4": 2 * cfg.n_layers + q4_down, "grouped_q8": cfg.n_layers - q4_down,
            "fused_mlp": 0}
    got = {k: per_step[k] for k in want}
    log(f"  model C per-step grouped launches {got}, route implies {want}")
    if got != want or not 0 < q4_down < cfg.n_layers:
        raise AssertionError(f"model C: grouped launches per step {got}, route implies {want}")


def _moe_server_run(torch, engine) -> dict:
    """A paged BatchEngine on model C: 8 requests of 30-600 tokens, 32 new
    tokens each, half greedy and half at temperature 0.8 with top_k 20 or
    40."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(8)
    lens = (30, 95, 160, 240, 330, 420, 510, 600)
    vocab = engine.model_cfg.vocab_size
    prompts = [torch.randint(300, vocab, (n,), generator=rng).tolist() for n in lens]
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=32) if i % 2 == 0 else
                SamplingParams(temperature=0.8, top_k=(20, 40)[i // 2 % 2], top_p=0.95,
                               max_new_tokens=32) for i in range(len(prompts))]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    _sync(torch)
    t0 = time.perf_counter()
    reqs = [be.submit(p, sp) for p, sp in zip(prompts, sampling)]
    _drive(be, reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    n_out = sum(len(r.output_ids) for r in reqs)
    ttft = _pcts([r.ttft_s * 1e3 for r in reqs])
    out = dict(requests=len(reqs), prompt_tokens=sum(lens), new_tokens=n_out, wall_s=wall,
               tok_s=n_out / wall, ttft_ms=ttft, pool_mb=be.cache.nbytes / 1e6,
               output_lengths=[len(r.output_ids) for r in reqs])
    log(f"  model C BatchEngine: {len(reqs)} requests, {sum(lens)} prompt tokens, {n_out} new in "
        f"{wall:.2f} s = {n_out / wall:.1f} tok/s aggregate; TTFT p50 {ttft['p50']:.1f} / max "
        f"{ttft['max']:.1f} ms; pool {out['pool_mb']:.1f} MB; outputs {out['output_lengths']}")
    if any(not 0 < n <= 32 for n in out["output_lengths"]):
        raise AssertionError(f"output lengths {out['output_lengths']}")
    del be
    return out


def main_path(torch, kernels_mod, label, kind, tmp, only, summary, phase_s) -> dict:
    """Serve (and batch, profile) one model with the launch counts zeroed
    just before; returns the counts read just after, checked against the
    model's route."""
    from nfai_tpu_torch.testing import make_llama_1b_gguf, make_qwen3moe_gguf

    t0 = time.perf_counter()
    if kind == "qwen3moe":
        path = make_qwen3moe_gguf(os.path.join(tmp, "qwen3moe.gguf"), n_layers=C_LAYERS)
    else:
        path = make_llama_1b_gguf(os.path.join(tmp, f"llama1b_{kind}.gguf"), kind=kind)
    log(f"model {label} ({kind}): wrote {path.stat().st_size / 2**30:.2f} GiB GGUF "
        f"in {time.perf_counter() - t0:.1f}s")
    out = {}
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    served = phase_serve(torch, path)
    engine = served["engine"]
    out["requests"] = served["requests"]
    phase_s[f"serve {label}"] = time.perf_counter() - t0
    if "batch" in only:
        t0 = time.perf_counter()
        batch = phase_batch(torch, engine, kernels_mod)
        state = batch.pop("state")
        out["batch"] = batch
        phase_s[f"batch {label}"] = time.perf_counter() - t0
        if "profile" in only:
            t0 = time.perf_counter()
            out["profile"] = phase_profile(torch, engine, state)
            phase_s[f"profile {label}"] = time.perf_counter() - t0
        del state
    launches = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    log(f"  model {label} main-path launches: {launches}")
    must, must_not = ROUTES[label]
    if any(launches[name] <= 0 for name in must) or any(launches[n] != 0 for n in must_not):
        raise AssertionError(f"model {label} did not take its route: {launches}")
    if "batch" in out:
        per_step = out["batch"]["launches_per_step"]
        n_layers = engine.model_cfg.n_layers
        if label == "A" and per_step["fused_mlp"] != n_layers:
            raise AssertionError(f"model A: {per_step['fused_mlp']} K5 launches per step, "
                                 f"not one per layer ({n_layers})")
        if label == "B" and not per_step["q8_matmul"] > 0:
            raise AssertionError("model B: no K6 launch in a decode step")
        if label == "C":
            _check_moe_step(engine, per_step)
    summary[f"model {label}"] = out
    by_path = {label: launches}
    if label == "A" and "server" in only:  # on the engine already loaded
        t0 = time.perf_counter()
        summary["server"], by_path["server"] = phase_server(torch, engine, kernels_mod)
        phase_s["server"] = time.perf_counter() - t0
    if label == "C" and "server" in only:
        t0 = time.perf_counter()
        kernels_mod.reset_launches()
        summary["server C"] = _moe_server_run(torch, engine)
        by_path["C server"] = launches = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
        log(f"  model C server main-path launches: {launches}")
        must, must_not = ROUTES["C server"]
        if any(launches[n] <= 0 for n in must) or any(launches[n] != 0 for n in must_not):
            raise AssertionError(f"model C's server path did not take its route: {launches}")
        phase_s["server C"] = time.perf_counter() - t0
    del served, engine
    os.remove(path)
    torch.cuda.empty_cache()
    return by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    if bad := set(only) - set(PHASES):
        ap.error(f"unknown phases {sorted(bad)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nfai_tpu_torch import kernels as kernels_mod
    from nfai_tpu_torch.testing import make_llama_1b_gguf, make_qwen3moe_gguf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    phase_s = {}
    summary: dict = {}
    tmp = tempfile.mkdtemp(prefix="nfai_smoke_")
    try:
        t0 = time.perf_counter()
        summary.update(phase_build(torch, kernels_mod))
        phase_s["build"] = time.perf_counter() - t0
        timer = Timer(torch)
        kern = {}
        if "kernels" in only:
            t0 = time.perf_counter()
            kern = phase_kernels(torch, timer)
            phase_s["kernels"] = time.perf_counter() - t0
        launches = None
        if "serve" in only or "batch" in only:
            by_path = {}
            for label, kind in MODELS.items():
                by_path.update(main_path(torch, kernels_mod, label, kind, tmp, only, summary, phase_s))
            launches = {name: sum(m[name] for m in by_path.values()) for name in kernels_mod.KERNELS}
            summary["launches_by_path"] = by_path
        if "parity" in only:
            t0 = time.perf_counter()
            summary["parity"] = {}
            for kind in PARITY_KINDS:
                path2 = make_llama_1b_gguf(os.path.join(tmp, f"llama1b_2l_{kind}.gguf"),
                                           kind=kind, n_layers=2)
                summary["parity"][kind] = phase_parity(torch, path2, kind)
                os.remove(path2)
            path2 = make_qwen3moe_gguf(os.path.join(tmp, "qwen3moe_2l.gguf"), n_layers=2)
            summary["parity"]["qwen3moe"] = phase_parity_moe(torch, path2)
            os.remove(path2)
            phase_s["parity"] = time.perf_counter() - t0
        log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}, "
            f"total {time.perf_counter() - t_all:.1f}")
        if len(summary) > 1:
            log("summary: " + json.dumps({k: v for k, v in summary.items() if k != "smi"}))
        if kern:
            rows = []
            for name, r in kern.items():
                h = r["headline"]
                rows.append(dict(
                    name=name, route=r["route"], source=r["source"], replaces=r["replaces"],
                    also_replaces=r["also_replaces"],
                    launches=None if launches is None else launches[name],
                    max_abs_err=h["max_abs_err"], ms=h["ms"], plain_ms=h["plain_ms"],
                    bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                    library_ms=h["library_ms"], shape=h["shape"],
                    **{key: h[key] for key in ("bound_gguf_ms", "replaced_route_ms", "library",
                                               "k2_same_shape_ms") if key in h},
                ))
            log(json.dumps({"kernels": rows}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": set(only) == set(PHASES), "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
