"""Chip smoke for the PyTorch/CUDA port (nfai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only build,kernels   # a quick kernel check

Phases (each failure propagates, the exit code is then non-zero):
  build    print the card, its power limit and the versions; build every
           kernel from csrc/ (one nvcc per source, in parallel)
  kernels  hold K1-K6 against their plain PyTorch versions on the card at
           the slice's shapes; time kernel, plain version and the library
           yardstick with CUDA events (L2 flushed before each launch)
  serve    per model, write a Llama-3.2-1B-width GGUF (random raw blocks),
           load it with InferenceEngine(device="cuda") and answer three
           ChatSession requests (one prompt > 256 tokens: a second prefill
           chunk runs at an offset); TTFT and decode tok/s per request
  batch    prefill_step on an 8x128 prompt, then decode_loop for 64 tokens
           at batch 8, S = 1024 (the bench.py shape); decode tok/s and the
           kernel launches per decode step
  profile  torch.profiler over 8 more decode steps of that batch: device
           busy share of the wall time and device time by kernel
  parity   2-layer full-width copies of four kinds on cuda and on cpu
           (plain versions): prefill logits and 4 teacher-forced decode
           steps within tolerance; the Q4_K copy also prefills one chunk of
           more than 1024 rows (the mlp_prefill route)
The main path is two models, each driven by serve, batch and profile:
  A  the untied Q4_K model in the JAX package's default configuration:
     every layer's MLP is one K5 launch (16 per decode step), no K6;
  B  the Q4_K_M mix llama.cpp writes: tied Q6_K table (K6 head, embedding
     rows gathered from it), Q6_K attn_v/ffn_down on 8 of 16 layers (K6),
     Q4_K elsewhere (K1); no K5, as the JAX route.
The kernels' launch counts are zeroed just before each model's path and
read just after; every kernel of that path must have launched, and the
per-step counts must match the route. The line before the last is
{"kernels": [...]} (launches summed over both paths), the last
{"ok": true, "device": {...}}; a run of a subset of the phases ends with
"ok": false, since the main paths' launch checks did not run in full.
Kernel errors are taken per output row (per batch row for decode
attention, per query token for prefill attention, per input row for the
matmuls and the MLP), so a row whose output is small is held to the same
tolerance as the largest one. Needs the repo checkout (nfai_tpu_torch) and
a CUDA device; imports nothing of JAX.
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

PHASES = ("build", "kernels", "serve", "batch", "profile", "parity")
MODELS = {"A": "q4_k", "B": "q4_k_m"}  # main-path model -> make_llama_1b_gguf kind
PARITY_KINDS = ("q4_k", "q4_k_m", "q8_0", "q4_0_tied")


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
              "gate_up": (2048, 16384), "down": (8192, 2048), "lm_head": (2048, 128256)}
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

    # K2 / K3 at the decode shapes: L=16, Hq=32, Hkv=8, D=64
    L, hq, hkv, d = 16, 32, 8, 64
    kvd = hkv * d
    cases2, cases3 = [], []
    for b, s in ((1, 512), (8, 1024)):
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
        layer = 5
        scale = d**-0.5
        got = fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts, scale)
        want = fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts, scale)
        torch.cuda.synchronize()
        err = check(f"K2 B={b} S={s} starts={starts.tolist()[:3]}...", got, want, row_dims=1)
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
        cases2.append(dict(shape=f"B={b} S={s} start={start}", max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, SDPA {lib_ms:.4f})")

        rows = torch.randn(L, b, kvd, device="cuda", dtype=bf, generator=gen)
        starts_w = starts.clone()
        starts_w[-1] = s  # dropped
        ref = kc.clone()
        fd.write_all_layers_plain(ref, rows, starts_w)
        got = fd.write_all_layers(kc.clone(), rows, starts_w)
        torch.cuda.synchronize()
        err3 = check(f"K3 L={L} B={b} S={s}", got, ref, tol=1e-30)  # exact copy
        cache_t = kc.clone()
        ms = timer(lambda: fd.write_all_layers(cache_t, rows, starts_t))
        plain_ms = timer(lambda: fd.write_all_layers_plain(cache_t, rows, starts_t))
        bidx = torch.arange(b, device="cuda")
        sidx = starts_t.long()

        def index_put():  # one advanced-index assignment = index_put_
            cache_t[:, bidx, sidx] = rows

        lib_ms = timer(index_put)
        bb, by = bound_ms(2 * rows.numel() * 2, 0)
        cases3.append(dict(shape=f"L={L} B={b} S={s}", max_abs_err=err3, ms=ms,
                           plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}, plain {plain_ms:.4f}, index_put_ {lib_ms:.4f})")
        del kc, vc, kd, vd, cache_t, ref
    results["decode_attention"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/decode_attention.cu",
        replaces="nfai_tpu/ops/fused_decode.py:465", also_replaces=["nfai_tpu/ops/fused_decode.py:200"],
        headline=cases2[-1], cases=cases2,
    )
    results["kv_write"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/kv_write.cu",
        replaces="nfai_tpu/ops/fused_decode.py:601", also_replaces=[],
        headline=cases3[-1], cases=cases3,
    )

    # K4: prefill chunks against a layer of the [B, S, KVD] cache
    cases4 = []
    for b, t, s, off in ((1, 256, 1024, 0), (1, 256, 1024, 256), (8, 128, 1024, 0), (2, 16, 512, 100)):
        q = torch.randn(b, t, hq, d, device="cuda", dtype=bf, generator=gen)
        kc = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        offs = torch.full((b,), off, dtype=torch.int32, device="cuda")
        scale = d**-0.5
        got = pa.flash_prefill_attention(q, kc, vc, offs, scale)
        torch.cuda.synchronize()
        err = check(f"K4 B={b} T={t} S={s} offset={off}", got,
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
        cases4.append(dict(shape=f"B={b} T={t} S={s} offset={off}", max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, SDPA {lib_ms:.4f})")
    results["prefill_attention"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/prefill_attention.cu",
        replaces="nfai_tpu/ops/prefill_attention.py:267", also_replaces=[],
        headline=cases4[2], cases=cases4,
    )
    results.update(_kernels_k5_k6(torch, timer, gen))
    return results


def _kernels_k5_k6(torch, timer, gen) -> dict:
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_mlp as fm
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import dequant

    bf = torch.bfloat16
    results = {}
    # K5 at the 1B MLP: K = H = 2048, F = 8192; decode rows 1 and 8, prefill 256 and 1024
    k, f, h = 2048, 8192, 2048
    gu, dn = _q4_weight(torch, 2 * f, k, gen), _q4_weight(torch, h, f, gen)

    def replaced_route(x):  # what K5 replaces: K1 gate_up, silu * up, K1 down
        g_u = qm.q4_matmul(x, gu)
        return qm.q4_matmul((nnf.silu(g_u[:, :f].float()) * g_u[:, f:].float()).to(bf), dn)

    cases = []
    for m in (1, 8, 256, 1024):
        x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
        got = fm.fused_mlp(x, gu, dn)
        torch.cuda.synchronize()
        err = check(f"K5 M={m} K={k} F={f} H={h}", got, fm.fused_mlp_plain(x, gu, dn), row_dims=1)
        ms = timer(lambda: fm.fused_mlp(x, gu, dn))
        plain_ms = timer(lambda: fm.fused_mlp_plain(x, gu, dn), iters=3)
        route_ms = timer(lambda: replaced_route(x))
        nbytes = m * k * 2 + (2 * f * k + h * f) * 3 // 4 + m * h * 2
        b, by = bound_ms(nbytes, 2.0 * m * k * 2 * f + 2.0 * m * f * h)
        cases.append(dict(shape=f"M={m}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b, bound_by=by, library_ms=None, replaced_route_ms=route_ms))
        log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
            f"replaced route K1 + silu*mul + K1 {route_ms:.4f}; no single library call)")
    results["fused_mlp"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/fused_mlp.cu",
        replaces="nfai_tpu/ops/fused_mlp.py:201", also_replaces=[],
        headline=cases[1], cases=cases,
    )
    del gu, dn

    # K6: the tied Q6_K head, Q8_0 wqkv and down, model B's Q6_K wv and
    # w_down; rows 1, 8, 256 and, below the head, 1024 (B's batch prefill)
    shapes = {"Q6_K head": (2048, 128256, 16, 32), "Q8_0 wqkv": (2048, 3072, 32, 127),
              "Q8_0 down": (8192, 2048, 32, 127), "Q6_K wv": (2048, 512, 16, 32),
              "Q6_K w_down": (8192, 2048, 16, 32)}
    cases = []
    for label, (k, n, group, qmax) in shapes.items():
        w = _q8_weight(torch, n, k, group, qmax, gen)
        wd = dequant(w).to(bf)
        for m in (1, 8, 256) if label == "Q6_K head" else (1, 8, 256, 1024):
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
    out = dict(prefill_ms=prefill_s * 1e3, prefill_tok_s=b * t / prefill_s,
               decode_ms_per_step=dec_s / n * 1e3, decode_tok_s=b * n / dec_s,
               launches_per_step=per_step, state=(first, pos + n, cache, gen))
    log(f"  batch {b}, prompt {t}, S 1024: prefill {prefill_s * 1e3:.1f} ms "
        f"({b * t / prefill_s:.0f} tok/s); decode {n} steps {dec_s * 1e3:.1f} ms "
        f"= {dec_s / n * 1e3:.2f} ms/step, {b * n / dec_s:.1f} tok/s; "
        f"kernel launches per step {per_step}")
    return out


def phase_profile(torch, engine, state) -> dict:
    """Device busy share and per-kernel device time of 8 decode steps at
    batch 8 (the wall clock includes the host's launch work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nfai_tpu_torch.models import decode_loop

    tok, pos, cache, gen = state
    n = 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_loop(engine.params, engine.model_cfg, tok, pos, cache, gen, n)
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

    torch.set_num_threads(os.cpu_count() or 8)
    ecfg = EngineConfig(max_seq_len=256)
    engines = {dev: InferenceEngine(path2, ecfg, device=dev) for dev in ("cuda", "cpu")}
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
    return {"max_rel_err": max(rels)}


# ---------------------------------------------------------------------------


# kernels each main-path model must launch, and the one its route must not
ROUTES = {
    "A": ({"q4_matmul", "decode_attention", "kv_write", "prefill_attention", "fused_mlp"},
          "q8_matmul"),
    "B": ({"q4_matmul", "decode_attention", "kv_write", "prefill_attention", "q8_matmul"},
          "fused_mlp"),
}


def main_path(torch, kernels_mod, label, kind, tmp, only, summary, phase_s) -> dict:
    """Serve (and batch, profile) one model with the launch counts zeroed
    just before; returns the counts read just after, checked against the
    model's route."""
    from nfai_tpu_torch.testing import make_llama_1b_gguf

    t0 = time.perf_counter()
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
    if any(launches[name] <= 0 for name in must) or launches[must_not] != 0:
        raise AssertionError(f"model {label} did not take its route: {launches}")
    if "batch" in out:
        per_step = out["batch"]["launches_per_step"]
        n_layers = engine.model_cfg.n_layers
        if label == "A" and per_step["fused_mlp"] != n_layers:
            raise AssertionError(f"model A: {per_step['fused_mlp']} K5 launches per step, "
                                 f"not one per layer ({n_layers})")
        if label == "B" and not per_step["q8_matmul"] > 0:
            raise AssertionError("model B: no K6 launch in a decode step")
    summary[f"model {label}"] = out
    del served, engine
    os.remove(path)
    torch.cuda.empty_cache()
    return launches


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
    from nfai_tpu_torch.testing import make_llama_1b_gguf

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
            by_model = {label: main_path(torch, kernels_mod, label, kind, tmp, only, summary, phase_s)
                        for label, kind in MODELS.items()}
            launches = {name: sum(m[name] for m in by_model.values()) for name in kernels_mod.KERNELS}
            summary["launches_by_model"] = by_model
        if "parity" in only:
            t0 = time.perf_counter()
            summary["parity"] = {}
            for kind in PARITY_KINDS:
                path2 = make_llama_1b_gguf(os.path.join(tmp, f"llama1b_2l_{kind}.gguf"),
                                           kind=kind, n_layers=2)
                summary["parity"][kind] = phase_parity(torch, path2, kind)
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
                    **{key: h[key] for key in ("bound_gguf_ms", "replaced_route_ms") if key in h},
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
