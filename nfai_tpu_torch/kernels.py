"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ctypes — seconds per
file, where a PyTorch C++ extension takes minutes. A library is built at first
use into ``_build/`` (listed in .gitignore), named by a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused.
`build_all` starts one nvcc per source at once.

Every C entry point takes pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; `Kernel.call` raises if that is not 0. Each
`Kernel` carries a plain integer `launches`, which its wrapper increments
where it launches the kernel and nowhere else.

Nothing here runs at import: the CPU tests import every module of the port,
and nvcc is first called when a kernel is first launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


class Kernel:
    """One ``csrc`` source: its C entry points, its build, its launch count."""

    def __init__(self, name: str, source: str, functions: dict[str, list]):
        self.name = name
        self.source = source
        self.functions = functions  # C symbol -> ctypes argtypes
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def _target(self) -> Path:
        h = hashlib.sha256(self.path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.path.stem}-{h.hexdigest()[:16]}.so"

    def compile_cmd(self) -> tuple[list[str], Path, Path]:
        """(nvcc command writing a temporary file, temporary file, target)."""
        target = self._target()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.path)]
        return cmd, Path(tmp), target

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                target = self._target()
                if not target.exists():
                    build([self])
                lib = ctypes.CDLL(str(target))
                for sym, argtypes in self.functions.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def call(self, symbol: str, *args) -> None:
        rc = getattr(self.lib(), symbol)(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: {symbol} returned cudaError_t {rc}"
            )


def build(kernels: list[Kernel], verbose: bool = False) -> dict[str, str]:
    """Compile the given kernels' sources in parallel (one nvcc each) unless
    their library is already built. Returns nvcc's output per kernel; raises
    if any compile fails."""
    procs = []
    for k in kernels:
        if k._target().exists():
            continue
        cmd, tmp, target = k.compile_cmd()
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((k, tmp, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = {}, []
    for k, tmp, target, proc in procs:
        out, _ = proc.communicate()
        logs[k.name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{k.source}:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    return logs


KERNELS: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all(verbose: bool = False) -> dict[str, str]:
    """Build every registered kernel (the ops modules register theirs when
    imported)."""
    from .ops import fused_decode, fused_mlp, prefill_attention, qmatmul  # noqa: F401

    return build(list(KERNELS.values()), verbose=verbose)


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of `t`'s device, as a pointer for the C side."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
