"""GGUF binary reader: mmap-backed, zero-copy tensor views.

Parity target: ``NFAI.GGUF/Parser.cs`` — header (:130-143), typed metadata KV
store incl. nested arrays (:145-236), tensor-info records (:244-307), alignment
handling (:125-128). Unlike the reference (which streams tensor bytes through
managed 10 MB batches, ``NFAI.Core/AbstractComputeCollection.cs:36-79``), this
reader mmaps the file once and exposes each tensor as a zero-copy numpy view of
the quantized payload, decoded on demand: the 13 kinds of the native library
(`native.py`, built with g++ at first use; a failed build raises) in one
parallel pass, the rest by the numpy codecs. `metadata_types` keeps each
key's value type (and an array's element type), so a tool that rewrites a
file can write every value back as it was typed.
"""
from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    Keys,
    tensor_nbytes,
)
from . import native
from .quants import dequantize

_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclass
class TensorDesc:
    """One tensor-info record (reference: Parser.cs:244-307).

    `dims_ggml` is the on-disk ggml order (dims[0] fastest-varying / contiguous);
    `shape` is the numpy/row-major order, i.e. ``dims_ggml[::-1]``.
    """

    name: str
    dims_ggml: tuple[int, ...]
    ggml_type: GGMLType
    offset: int  # relative to data-section start, already aligned

    @property
    def shape(self) -> tuple[int, ...]:
        return self.dims_ggml[::-1]

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.dims_ggml:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.n_elements, self.ggml_type)


class _Cursor:
    """Sequential little-endian reader over a buffer."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError(f"GGUF truncated: wanted {n} bytes at {self.pos}")
        self.pos += n
        return bytes(out)

    def scalar(self, fmt: str):
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return val

    def u32(self) -> int:
        return self.scalar("<I")

    def u64(self) -> int:
        return self.scalar("<Q")

    def string(self) -> str:
        n = self.u64()
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.u32())
            count = self.u64()
            if elem_type in (GGUFValueType.STRING, GGUFValueType.ARRAY):
                return [self.value(elem_type) for _ in range(count)]
            # bulk-decode scalar arrays (vocab/merges metadata can be huge)
            fmt = _SCALAR_FMT[elem_type]
            size = struct.calcsize(fmt)
            raw = self.read(count * size)
            arr = np.frombuffer(raw, dtype=np.dtype(fmt[1]).newbyteorder("<"))
            if elem_type == GGUFValueType.BOOL:
                return arr.astype(bool).tolist()
            return arr.tolist()
        return self.scalar(_SCALAR_FMT[vtype])


@dataclass
class GGUFFile:
    """A parsed GGUF file: metadata dict + tensor descriptors + mmap'd payload."""

    path: Path
    version: int
    metadata: dict[str, Any]
    tensors: dict[str, TensorDesc]
    alignment: int
    data_offset: int
    _buf: Any = field(default=None, repr=False)  # mmap or bytes
    _file: BinaryIO | None = field(default=None, repr=False)
    # key -> (value type, element type of an ARRAY value, else None)
    metadata_types: dict[str, tuple[GGUFValueType, GGUFValueType | None]] = field(
        default_factory=dict, repr=False)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def open(cls, path: str | Path) -> "GGUFFile":
        path = Path(path)
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            return cls._parse(path, mm, f)
        except Exception:
            mm.close()
            f.close()
            raise

    @classmethod
    def _parse(cls, path: Path, buf, f) -> "GGUFFile":
        cur = _Cursor(buf)
        magic = cur.u32()
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file (magic {magic:#x})")
        version = cur.u32()
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = cur.u64()
        n_kv = cur.u64()

        metadata: dict[str, Any] = {}
        metadata_types: dict[str, tuple[GGUFValueType, GGUFValueType | None]] = {}
        for _ in range(n_kv):
            key = cur.string()
            vtype = GGUFValueType(cur.u32())
            elem = GGUFValueType(struct.unpack_from("<I", buf, cur.pos)[0]) \
                if vtype == GGUFValueType.ARRAY else None
            metadata[key] = cur.value(vtype)
            metadata_types[key] = (vtype, elem)

        tensors: dict[str, TensorDesc] = {}
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.u32()
            dims = tuple(cur.u64() for _ in range(n_dims))
            type_id = cur.u32()
            offset = cur.u64()
            tensors[name] = TensorDesc(name, dims, GGMLType(type_id), offset)

        alignment = int(metadata.get(Keys.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        data_offset = (cur.pos + alignment - 1) // alignment * alignment
        return cls(path, version, metadata, tensors, alignment, data_offset, buf, f,
                   metadata_types=metadata_types)

    def close(self) -> None:
        if isinstance(self._buf, mmap.mmap):
            self._buf.close()
        self._buf = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- tensor access -----------------------------------------------------
    def tensor_bytes(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of the quantized payload for `name`."""
        if self._buf is None:
            raise ValueError("GGUFFile is closed")
        desc = self.tensors[name]
        start = self.data_offset + desc.offset
        return np.frombuffer(self._buf, dtype=np.uint8, count=desc.nbytes, offset=start)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in numpy (row-major) shape: the native
        library's kinds through it, the others through the numpy codecs."""
        desc = self.tensors[name]
        if native.available(desc.ggml_type):
            flat = native.dequantize_native(self.tensor_bytes(name), desc.n_elements, desc.ggml_type)
        else:
            flat = dequantize(self.tensor_bytes(name), desc.n_elements, desc.ggml_type)
        return flat.reshape(desc.shape)

    def tensor_f32_transposed(self, name: str) -> np.ndarray:
        """Dequantized 2-D tensor transposed to (in, out), contiguous: one
        fused native pass for the library's kinds."""
        desc = self.tensors[name]
        if len(desc.shape) != 2:
            raise ValueError(f"{name} is not 2-D")
        n_out, k_in = desc.shape
        if native.available(desc.ggml_type):
            return native.dequant_transpose_native(self.tensor_bytes(name), desc.ggml_type, n_out, k_in)
        return np.ascontiguousarray(self.tensor_f32(name).T)

    # -- metadata access ---------------------------------------------------
    @property
    def architecture(self) -> str:
        return str(self.metadata.get(Keys.ARCHITECTURE, ""))
