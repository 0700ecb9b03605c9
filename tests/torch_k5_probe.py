"""K5's decode kernel, variant by variant, to choose its design.

    python tests/torch_k5_probe.py [--variants a,b,...]

Needs an NVIDIA GPU and nvcc. Builds copies of csrc/fused_mlp.cu, each
with a few constants or lines replaced (`VARIANTS`; "as is" is the source
unchanged, the timing-only variants drop work and give wrong sums), calls
each copy's `nfai_fused_mlp_decode` at model A's and the 3B's MLP widths
and M = 1, 8 and 16, and prints the card, then one JSON line per variant:
the median CUDA-event ms of a launch (L2 evicted before each launch, as
chip_smoke.py's Timer does), the max|kernel - plain| / max|plain| per row
where the variant keeps the sums.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import Timer, _q4_weight, errors  # noqa: E402
from nfai_tpu_torch import kernels  # noqa: E402
from nfai_tpu_torch.kernels import ptr, stream_ptr  # noqa: E402
from nfai_tpu_torch.ops import fused_mlp as fm  # noqa: E402

SOURCE = kernels.CSRC / "fused_mlp.cu"
# name -> (replacements (old, new) in the source, whether the sums stay right)
VARIANTS = {
    "as is": ((), True),
    # the weight stream alone: every stage's product skipped
    "no products": ((("  for (int bb = 0; bb < 8; bb += 2) {", "  for (int bb = 0; bb < 0; bb += 2) {"),), False),
    # phase 1 and the hand-over of a alone
    "no phase 2": ((("  for (int q = 0; q < mine * n2; ++q) {", "  for (int q = 0; q < 0; ++q) {"),), False),
    # the weight copies with an L2 prefetch hint of 128 or 256 bytes
    **{f"L2 prefetch {n}": ((("constexpr uint32_t NIB_MASK",
                              "__device__ __forceinline__ void cp_async16_pf(void* dst, const void* src) {\n"
                              f"  asm volatile(\"cp.async.cg.shared.global.L2::{n}B [%0], [%1], 16;\\n\" "
                              "::\"r\"(smem_u32(dst)), \"l\"(src));\n}\nconstexpr uint32_t NIB_MASK"),
                             ("cp_async16(st", "cp_async16_pf(st")), True) for n in (128, 256)},
    # deeper and shallower rings, where they fit (else the source's rule)
    "stages 6": ((("  if (d_smem(NF, 4, K, F) <= D_SMEM_MAX)\n    return launch_decode<NF, 4>",
                   "  if (d_smem(NF, 6, K, F) <= D_SMEM_MAX)\n    return launch_decode<NF, 6>"),), True),
    "stages 3": ((("  if (d_smem(NF, 4, K, F) <= D_SMEM_MAX)\n    return launch_decode<NF, 4>",
                   "  if (d_smem(NF, 3, K, F) <= D_SMEM_MAX)\n    return launch_decode<NF, 3>"),), True),
}
SHAPES = ((2048, 8192, 2048, (1, 8, 16)), (3072, 8192, 3072, (8,)))


def build(variants: dict, tmp: Path) -> dict:
    src = SOURCE.read_text()
    procs = {}
    for name, (subs, _) in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name!r}: {old!r} is not in {SOURCE.name}")
            text = text.replace(old, new)
        cu = tmp / f"v{len(procs)}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.nfai_fused_mlp_decode.argtypes = fm.K5.functions["nfai_fused_mlp_decode"]
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    chosen = {n: VARIANTS[n] for n in args.variants.split(",")}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        libs = build(chosen, Path(d))
        timer = Timer(torch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = {name: {} for name in chosen}
        for k, f, h, ms in SHAPES:
            gu, dn = _q4_weight(torch, 2 * f, k, gen), _q4_weight(torch, h, f, gen)
            for m in ms:
                x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=gen)
                want = fm.fused_mlp_plain(x, gu, dn)
                plan = fm.decode_plan(m, k, f, h)
                work = torch.empty(plan["work"], dtype=torch.uint8, device="cuda")
                for name, lib in libs.items():
                    counters = torch.zeros(plan["counters"], dtype=torch.int32, device="cuda")
                    y = torch.zeros(m, h, dtype=torch.bfloat16, device="cuda")

                    def run():
                        rc = lib.nfai_fused_mlp_decode(
                            ptr(x), ptr(gu.qs), ptr(gu.scales), ptr(gu.mins), ptr(dn.qs), ptr(dn.scales),
                            ptr(dn.mins), ptr(work), ptr(counters), ptr(y), m, k, f, h, 0, stream_ptr(x))
                        if rc:
                            raise RuntimeError(f"{name}: cudaError_t {rc}")

                    run()
                    torch.cuda.synchronize()
                    label = f"{'A' if k == 2048 else '3B'} M={m}"
                    rows[name][label] = {"ms": timer(run, iters=20)}
                    if chosen[name][1]:
                        rows[name][label]["rel"] = errors(y, want, 1)[1]
                        if not rows[name][label]["rel"] < 2e-2:
                            raise AssertionError(f"{name} {label}: {rows[name][label]}")
            del gu, dn
        for name in libs:
            print(json.dumps({"variant": name, "rows": rows[name]}), flush=True)


if __name__ == "__main__":
    main()
