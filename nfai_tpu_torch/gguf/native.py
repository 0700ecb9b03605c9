"""ctypes binding to the port's native (C++/OpenMP) dequantization library.

Counterpart of the JAX package's gguf/native.py. The source is the port's
own copy, ``nfai_tpu_torch/csrc/nfai_native.cpp``: 13 decoders
(`_NATIVE_TYPES`) and a fused dequantize-and-transpose. It is built with
``g++`` at first use into ``nfai_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source, the flags and the compiler's
version line, so an edited source, other flags or another toolchain build
anew and an unchanged one is reused. A build writes a temporary file and
renames it into place, so a process never loads a half-written library
while another builds it.

There is no fallback that hides it: when the build or the load fails, the
call raises with the compiler's output; the reader never decodes such a
kind with numpy instead. The numpy codecs (`quants.py`) stay the plain
version: the tests hold this library against them bit for bit, and the
reader uses them for the kinds the library does not take (F32, F64, the
integer kinds, Q8_1, IQ4_NL, IQ4_XS).

The flags: ``-ffp-contract=off`` keeps GCC from fusing ``a*b - c`` into an
FMA (its default in GNU mode where the target has one), which would round
a K-quant value differently from numpy; ``-march=native`` (the JAX
Makefile's) is left out, so a library built on one host runs on another
that shares the toolchain. Importing this module builds and loads nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .constants import GGML_BLOCK_LAYOUT, GGMLType, tensor_nbytes

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "nfai_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-ffp-contract=off", "-shared",
             "-Wall", "-Wextra")

_FN_NAMES = {
    GGMLType.F16: "nfai_dequant_f16",
    GGMLType.BF16: "nfai_dequant_bf16",
    GGMLType.Q4_0: "nfai_dequant_q4_0",
    GGMLType.Q4_1: "nfai_dequant_q4_1",
    GGMLType.Q5_0: "nfai_dequant_q5_0",
    GGMLType.Q5_1: "nfai_dequant_q5_1",
    GGMLType.Q8_0: "nfai_dequant_q8_0",
    GGMLType.Q2_K: "nfai_dequant_q2_k",
    GGMLType.Q3_K: "nfai_dequant_q3_k",
    GGMLType.Q4_K: "nfai_dequant_q4_k",
    GGMLType.Q5_K: "nfai_dequant_q5_k",
    GGMLType.Q6_K: "nfai_dequant_q6_k",
    GGMLType.Q8_K: "nfai_dequant_q8_k",
}
_NATIVE_TYPES = frozenset(_FN_NAMES)

_lib = None
_lock = threading.Lock()


def _compiler() -> tuple[str, str]:
    """(path of g++, its version line)."""
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(
            f"{CXX} not found: the native dequant library ({SOURCE.name}) is built with it at "
            "first use, and the reader does not decode its kinds without it"
        )
    version = subprocess.run([found, "--version"], capture_output=True, text=True).stdout
    return found, (version.splitlines() or [""])[0]


def _target(version: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(f"{version} {platform.machine()}".encode())
    return BUILD_DIR / f"nfai_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    cxx, version = _compiler()
    target = _target(version)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native dequant library failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the library; cached once loaded.
    Raises RuntimeError if either fails, on every call until one succeeds."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the native dequant library {path} failed: {e}") from e
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            for name in _FN_NAMES.values():
                fn = getattr(lib, name)
                fn.argtypes = [u8p, f32p, ctypes.c_int64]
                fn.restype = None
            lib.nfai_dequant_transpose.argtypes = [
                ctypes.c_int32, u8p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64
            ]
            lib.nfai_dequant_transpose.restype = None
            lib.nfai_num_threads.restype = ctypes.c_int32
            _lib = lib
        return _lib


def available(ggml_type: GGMLType | None = None) -> bool:
    """Whether the library decodes `ggml_type` (with None: whether it
    loads). A kind it takes builds and loads it here, and a failure raises:
    False means only that the kind is not one of `_NATIVE_TYPES`."""
    if ggml_type is not None and ggml_type not in _NATIVE_TYPES:
        return False
    load_library()
    return True


def num_threads() -> int:
    """The OpenMP team size a decode runs with (`omp_get_max_threads`)."""
    return int(load_library().nfai_num_threads())


def _source(data: np.ndarray, need: int, ggml_type: GGMLType) -> np.ndarray:
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if data.size < need:  # the C side reads without bounds
        raise ValueError(f"{ggml_type.name}: need {need} bytes, got {data.size}")
    return data


def _check_type(ggml_type: GGMLType) -> None:
    if ggml_type not in _NATIVE_TYPES:  # the C dispatch would leave the output unwritten
        raise ValueError(f"the native library does not decode {ggml_type.name}")


def dequantize_native(data: np.ndarray, n: int, ggml_type: GGMLType) -> np.ndarray:
    """Decode `n` values of `ggml_type` from raw bytes → float32, in one
    parallel pass."""
    _check_type(ggml_type)
    if n % GGML_BLOCK_LAYOUT[ggml_type].block_size:
        raise ValueError(f"{ggml_type.name}: {n} elements is not a whole number of blocks")
    data = _source(data, tensor_nbytes(n, ggml_type), ggml_type)
    fn = getattr(load_library(), _FN_NAMES[ggml_type])
    out = np.empty(n, np.float32)
    fn(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    return out


def dequant_transpose_native(
    data: np.ndarray, ggml_type: GGMLType, n_out: int, k_in: int
) -> np.ndarray:
    """Fused dequantize + transpose of a row-major [n_out, k_in] tensor to
    [k_in, n_out] float32 (one parallel pass over the rows)."""
    _check_type(ggml_type)
    layout = GGML_BLOCK_LAYOUT[ggml_type]
    if k_in % layout.block_size:
        raise ValueError(f"{ggml_type.name}: a row of {k_in} is not a whole number of blocks")
    row_bytes = (k_in // layout.block_size) * layout.type_size
    data = _source(data, n_out * row_bytes, ggml_type)
    lib = load_library()
    out = np.empty((k_in, n_out), np.float32)
    lib.nfai_dequant_transpose(
        int(ggml_type),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_out,
        k_in,
        row_bytes,
    )
    return out
