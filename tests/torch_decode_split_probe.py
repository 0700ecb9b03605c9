"""K2's and K7's time at each cluster size c, to choose `decode_split`.

    python tests/torch_decode_split_probe.py

Needs an NVIDIA GPU. Calls the C entry points of csrc/decode_attention.cu
and csrc/paged_attention.cu with c = 1, 2, 4, 8 and 16 (the wrappers take
c from `decode_split`) at the decode shapes the rule has to get right: batch
1 at 512 slots (the launch-bound rows), batch 8 at 4000 of 4096 keys on
narrow grids (Gemma-3-1B's and Gemma 2B's single kv head, model C's and
G's four) and on model A's wide one (8 kv heads), and A's long context (3500
of 4096); three of them also through the int8 entry points (quantize_kv
codes). Prints the card, then one JSON line per shape: the median CUDA-event
ms of a launch at each c (L2 evicted before each launch, as chip_smoke.py's
Timer does), the c `decode_split` picks and the checked max|kernel - plain|
/ max|plain| of each c.
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nfai_tpu_torch.kernels import ptr, stream_ptr  # noqa: E402
from nfai_tpu_torch.models.llama import quantize_kv  # noqa: E402
from nfai_tpu_torch.ops import fused_decode as fd  # noqa: E402
from nfai_tpu_torch.ops import paged_attention as pga  # noqa: E402

SPLITS = (1, 2, 4, 8, 16)
# (label, kernel, B, Hq, Hkv, D, slots, keys a row); "-i8": the int8 entry point
SHAPES = (("K2 A heads B=1 S=512", "K2", 1, 32, 8, 64, 512, 511),
          ("K7 A heads B=1 len=512", "K7", 1, 32, 8, 64, 512, 512),
          ("K2 C heads B=1 S=512", "K2", 1, 32, 4, 128, 512, 511),
          ("K2 Gemma-3-1B heads B=8 4000 keys", "K2", 8, 4, 1, 256, 4096, 4000),
          ("K7 Gemma-3-1B heads B=8 4000 keys", "K7", 8, 4, 1, 256, 4096, 4000),
          ("K2 Gemma 2B heads B=8 S=1024", "K2", 8, 8, 1, 256, 1024, 1023),
          ("K2 C heads B=8 S=1024", "K2", 8, 32, 4, 128, 1024, 1023),
          ("K2 A heads B=8 S=1024", "K2", 8, 32, 8, 64, 1024, 1023),
          ("K2 A long context B=8 3500 keys", "K2", 8, 32, 8, 64, 4096, 3500),
          ("K2 G heads B=8 4000 keys", "K2", 8, 8, 4, 256, 4096, 4000),
          ("K7 G heads B=8 4000 keys", "K7", 8, 8, 4, 256, 4096, 4000),
          ("K7 A heads B=8 4000 keys", "K7", 8, 32, 8, 64, 4096, 4000),
          ("K2-i8 G heads B=8 4000 keys", "K2-i8", 8, 8, 4, 256, 4096, 4000),
          ("K7-i8 Gemma-3-1B heads B=8 4000 keys", "K7-i8", 8, 4, 1, 256, 4096, 4000),
          ("K2-i8 A long context B=8 3500 keys", "K2-i8", 8, 32, 8, 64, 4096, 3500),
          ("K2-i8 A heads B=8 S=1024", "K2-i8", 8, 32, 8, 64, 1024, 1023),
          ("K2-i8 C heads B=8 S=1024", "K2-i8", 8, 32, 4, 128, 1024, 1023),
          ("K7-i8 A heads B=8 4000 keys", "K7-i8", 8, 32, 8, 64, 4096, 4000),
          ("K7-i8 C heads B=8 len=1024", "K7-i8", 8, 32, 4, 128, 1024, 1024))


def timed(fn, flush, iters=20):
    times = []
    fn()
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[iters // 2]


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.ones(32 << 20, device="cuda")
    bf = dict(device="cuda", dtype=torch.bfloat16, generator=gen)
    sms = fd.sm_count(torch.cuda.current_device())
    for label, kind, b, hq, hkv, d, slots, keys in SHAPES:
        r, scale = hq // hkv, d**-0.5
        q = torch.randn(b, hq, d, **bf)
        out = torch.empty_like(q)
        quant = kind.endswith("-i8")
        if kind.startswith("K2"):
            kc, vc = torch.randn(b, slots, hkv * d, **bf), torch.randn(b, slots, hkv * d, **bf)
            kn, vn = torch.randn(b, hkv * d, **bf), torch.randn(b, hkv * d, **bf)
            starts = torch.full((b,), keys, dtype=torch.int32, device="cuda")
            sc = ()
            if quant:
                (kc, ks), (vc, vs) = quantize_kv(kc, hkv), quantize_kv(vc, hkv)
                sc = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
            want = fd.decode_attention_plain(q, kn, vn, kc, vc, starts, scale, *sc)

            def run(c):
                if quant:
                    fd.K2_I8.call("nfai_decode_attention_i8", ptr(q), ptr(kn), ptr(vn), ptr(kc), ptr(vc),
                                  ptr(sc[0]), ptr(sc[1]), ptr(starts), ptr(out), b, slots, hkv, r, d, scale, 0.0,
                                  0, c, stream_ptr(q))
                else:
                    fd.K2.call("nfai_decode_attention", ptr(q), ptr(kn), ptr(vn), ptr(kc), ptr(vc), ptr(starts),
                               ptr(out), b, slots, hkv, r, d, scale, 0.0, 0, c, stream_ptr(q))
        else:
            ps = 128
            n_p = slots // ps
            n_pages = b * n_p + 1
            kp, vp = torch.randn(hkv, n_pages, ps, d, **bf), torch.randn(hkv, n_pages, ps, d, **bf)
            sc = ()
            if quant:
                (kp, ks), (vp, vs) = quantize_kv(kp, 1), quantize_kv(vp, 1)
                sc = ks[..., 0].contiguous(), vs[..., 0].contiguous()
            tables = (torch.randperm(n_pages - 1)[: b * n_p] + 1).view(b, n_p).to(torch.int32).cuda()
            lengths = torch.full((b,), keys, dtype=torch.int32, device="cuda")
            want = pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale, *sc)

            def run(c):
                if quant:
                    pga.K7_I8.call("nfai_paged_attention_i8", ptr(q), ptr(kp), ptr(vp), ptr(sc[0]), ptr(sc[1]),
                                   ptr(tables), ptr(lengths), ptr(out), b, hkv, r, n_pages, ps, n_p, d, scale,
                                   0.0, 0, c, stream_ptr(q))
                else:
                    pga.K7.call("nfai_paged_attention", ptr(q), ptr(kp), ptr(vp), ptr(tables), ptr(lengths),
                                ptr(out), b, hkv, r, n_pages, ps, n_p, d, scale, 0.0, 0, c, stream_ptr(q))
        row = {"shape": label, "picked": fd.decode_split(b, hkv, slots, sms, d), "ms": {}, "rel_err": {}}
        # the same tensors read once by two torch reductions: the card's streaming rate here
        kt, vt = (kc, vc) if kind.startswith("K2") else (kp, vp)
        row["read_kv_ms"] = timed(lambda: (kt.sum(), vt.sum()), flush)
        row["kv_mb"] = 2 * kt.numel() * kt.element_size() / 1e6
        for c in SPLITS:
            if c * b * hkv > 4 * sms:
                continue
            run(c)
            torch.cuda.synchronize()
            row["rel_err"][c] = float((out.float() - want.float()).abs().max() / want.float().abs().max())
            row["ms"][c] = timed(lambda: run(c), flush)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
