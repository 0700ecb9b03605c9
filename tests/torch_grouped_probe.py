"""K8 / K9's decode GEMV (tm = 8), variant by variant, to choose its design.

    python tests/torch_grouped_probe.py [--variants a,b,...]

Needs an NVIDIA GPU and nvcc. Builds copies of csrc/grouped_matmul.cu, each
with a few constants or lines replaced (`VARIANTS`; "as is" is the source
unchanged, the timing-only variants drop work and give wrong sums), calls
each copy's `nfai_grouped_q4` / `nfai_grouped_q8` at model C's expert
shapes (gate/up K = 2048, N = 768 and the 4-bit down K = 768, N = 2048 on
K8; the Q6_K down on K9) on the layouts of a batch-1 and a batch-8 decode
step (128 experts, 8 a token, random routing from a seed), and prints the
card, then one JSON line per variant: the median CUDA-event ms of a launch
(L2 evicted before each launch, as chip_smoke.py's Timer does) and the
max|kernel - plain| / max|plain| per routed row where the variant keeps
the sums.
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

from chip_smoke import Timer, _routing_layout, errors  # noqa: E402
from nfai_tpu_torch import kernels  # noqa: E402
from nfai_tpu_torch.kernels import ptr, stream_ptr  # noqa: E402
from nfai_tpu_torch.ops import qmatmul as qm  # noqa: E402
from nfai_tpu_torch.ops.qtensor import Q4Tensor, Q8Tensor  # noqa: E402

SOURCE = kernels.CSRC / "grouped_matmul.cu"
# name -> (replacements (old, new) in the source, whether the sums stay right)
VARIANTS = {
    "as is": ((), True),
    # the weight stream and x's staging alone: every stage's products skipped
    "no products": ((("        for (int pp = 0; pp < 2; ++pp) {", "        for (int pp = 0; pp < 0; ++pp) {"),), False),
    # the products on whatever the ring holds: no weight copied (compute alone)
    "no stream": ((("    if (i >= mine) return;", "    if (true) return;"),), False),
    # the K split by the SM count alone, or to six waves
    **{f"ks {n} wave{'s' if n > 1 else ''}": ((("constexpr int GV_WAVES = 3;", f"constexpr int GV_WAVES = {n};"),), True)
       for n in (1, 6)},
    # three blocks an SM where shared memory lets them (K = 768): 85 registers
    "bound 3": ((("__global__ void __launch_bounds__(GV_THREADS, 2)", "__global__ void __launch_bounds__(GV_THREADS, 3)"),), True),
    # ring depths: K8 3 stages, K9 2
    "K8 stages 3": ((("static constexpr int S = Q4 ? 2 : 3,", "static constexpr int S = 3,"),), True),
    "K9 stages 2": ((("static constexpr int S = Q4 ? 2 : 3,", "static constexpr int S = 2,"),), True),
}


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
        lib.nfai_grouped_q4.argtypes = qm.K8.functions["nfai_grouped_q4"]
        lib.nfai_grouped_q8.argtypes = qm.K9.functions["nfai_grouped_q8"]
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = [v for v in ap.parse_args().variants.split(",") if v]
    if not torch.cuda.is_available():
        sys.exit("torch_grouped_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    e, used, h, f = 128, 8, 2048, 768

    def q4(n, k):
        return Q4Tensor(torch.randint(0, 256, (e, n, k // 2), dtype=torch.uint8, device="cuda", generator=gen),
                        torch.rand(e, n, k // 32, device="cuda", generator=gen) * 2e-3 + 1e-4,
                        torch.rand(e, n, k // 32, device="cuda", generator=gen) * 1.5e-2, k, n)

    weights = {"K8 gate/up": q4(f, h), "K8 down": q4(h, f),
               "K9 Q6_K down": Q8Tensor(torch.randint(-32, 32, (e, h, f), dtype=torch.int8, device="cuda",
                                                      generator=gen),
                                        torch.rand(e, h, f // 16, device="cuda", generator=gen) * 1e-3 + 1e-5,
                                        None, f, h, 16)}
    layouts = {"batch 1": _routing_layout(torch, 1, e, used, gen), "batch 8": _routing_layout(torch, 8, e, used, gen)}
    timer = Timer(torch)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build({n: VARIANTS[n] for n in names}, Path(tmp))
        for name in names:
            row = {"variant": name}
            for wname, w in weights.items():
                for lname, (m_pad, dst, bg, br, tm, _) in layouts.items():
                    x = torch.randn(m_pad, w.k, device="cuda", dtype=torch.bfloat16, generator=gen)
                    y = torch.empty(m_pad, w.n, device="cuda", dtype=torch.bfloat16)
                    args = (ptr(x), ptr(w.qs), ptr(w.scales), ptr(w.mins) if w.mins is not None else None,
                            ptr(bg), ptr(br), ptr(y), m_pad, w.k, w.n, tm)

                    def launch():
                        if isinstance(w, Q4Tensor):
                            rc = libs[name].nfai_grouped_q4(*args, stream_ptr(x))
                        else:
                            rc = libs[name].nfai_grouped_q8(*args, w.group, stream_ptr(x))
                        if rc:
                            raise RuntimeError(f"{name}: cudaError_t {rc}")

                    launch()
                    torch.cuda.synchronize()
                    key = f"{wname} {lname}"
                    row[f"{key} ms"] = round(timer(launch), 5)
                    if VARIANTS[name][1]:
                        want = qm.qmatmul_grouped_plain(x, w, bg, tm, br)
                        row[f"{key} rel"] = errors(y[dst], want[dst], 1)[1]
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
