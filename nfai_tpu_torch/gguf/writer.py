"""GGUF binary writer.

Exists so tests and the chip smoke can fabricate valid GGUF fixtures
(synthetic Llama checkpoints, up to full model width with raw block payloads).
Produces spec-conformant v3 files readable by `reader.GGUFFile` and by
llama.cpp. `write` streams the tensor payloads to the file one by one, so a
GB-sized checkpoint is never assembled in memory twice.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)
from .quants import quantize


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        return GGUFValueType.INT64 if (value < 0 or value >= 2**32) else GGUFValueType.UINT32
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


class GGUFWriter:
    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any, GGUFValueType | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    # -- metadata ----------------------------------------------------------
    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None,
            elem_type: GGUFValueType | None = None) -> None:
        """One metadata value; its type is inferred unless given. An ARRAY's
        element type is inferred from its first item unless `elem_type`
        names it (`GGUFFile.metadata_types` gives a read file's)."""
        self._kv.append((key, vtype or _infer_vtype(value), value, elem_type))

    # -- tensors -----------------------------------------------------------
    def add_tensor(
        self,
        name: str,
        array: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw_bytes: bytes | None = None,
    ) -> None:
        """Add a tensor. `array.shape` is numpy (row-major) order; stored dims are
        reversed into ggml order. If `raw_bytes` is given it is used verbatim
        (array supplies only the shape); otherwise `array` is quantized."""
        if ggml_type is None:
            ggml_type = {
                np.dtype(np.float32): GGMLType.F32,
                np.dtype(np.float16): GGMLType.F16,
                np.dtype(np.int32): GGMLType.I32,
            }.get(array.dtype)
            if ggml_type is None:
                raise TypeError(f"cannot infer ggml type for dtype {array.dtype}")
        if raw_bytes is None:
            if ggml_type in (GGMLType.I8, GGMLType.I16, GGMLType.I32, GGMLType.I64):
                np_dtype = {GGMLType.I8: np.int8, GGMLType.I16: np.int16,
                            GGMLType.I32: np.int32, GGMLType.I64: np.int64}[ggml_type]
                raw_bytes = np.ascontiguousarray(array, dtype=np_dtype).tobytes()
            else:
                raw_bytes = quantize(np.asarray(array, dtype=np.float32), ggml_type).tobytes()
        expected = tensor_nbytes(int(np.prod(array.shape)), ggml_type)
        if len(raw_bytes) != expected:
            raise ValueError(
                f"{name}: payload is {len(raw_bytes)} bytes, expected {expected}"
            )
        dims_ggml = tuple(reversed(array.shape))
        self._tensors.append((name, dims_ggml, ggml_type, raw_bytes))

    # -- serialization -----------------------------------------------------
    @staticmethod
    def _pack_string(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    @classmethod
    def _pack_value(cls, vtype: GGUFValueType, value: Any,
                    elem_type: GGUFValueType | None = None) -> bytes:
        fmt = {
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
        if vtype == GGUFValueType.STRING:
            return cls._pack_string(str(value))
        if vtype == GGUFValueType.ARRAY:
            items = list(value)
            if elem_type is None:
                elem_type = _infer_vtype(items[0]) if items else GGUFValueType.UINT32
            out = struct.pack("<IQ", int(elem_type), len(items))
            return out + b"".join(cls._pack_value(elem_type, v) for v in items)
        return struct.pack(fmt[vtype], value)

    def _head(self) -> tuple[bytes, list[tuple[int, bytes]]]:
        """Header + metadata + tensor infos, and each payload's data offset."""
        header = struct.pack(
            "<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv)
        )
        kv_blob = b"".join(
            self._pack_string(k) + struct.pack("<I", int(t)) + self._pack_value(t, v, e)
            for k, t, v, e in self._kv
        )
        # tensor infos with aligned offsets
        infos = b""
        payloads: list[tuple[int, bytes]] = []
        offset = 0
        for name, dims_ggml, ggml_type, raw in self._tensors:
            offset = (offset + self.alignment - 1) // self.alignment * self.alignment
            infos += self._pack_string(name)
            infos += struct.pack("<I", len(dims_ggml))
            infos += b"".join(struct.pack("<Q", d) for d in dims_ggml)
            infos += struct.pack("<IQ", int(ggml_type), offset)
            payloads.append((offset, raw))
            offset += len(raw)
        return header + kv_blob + infos, payloads

    def _chunks(self):
        head, payloads = self._head()
        data_start = (len(head) + self.alignment - 1) // self.alignment * self.alignment
        yield head + b"\x00" * (data_start - len(head))
        pos = data_start
        for off, raw in payloads:
            pad = data_start + off - pos
            if pad:
                yield b"\x00" * pad
            yield raw
            pos = data_start + off + len(raw)

    def to_bytes(self) -> bytes:
        return b"".join(self._chunks())

    def write(self, path: str | Path) -> Path:
        path = Path(path)
        with open(path, "wb") as f:
            for chunk in self._chunks():
                f.write(chunk)
        return path
