"""GGUF file format: reader, writer, and the block-quant codecs the port reads."""
from .constants import (  # noqa: F401
    GGML_BLOCK_LAYOUT,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    Keys,
    tensor_nbytes,
)
from .quants import DEQUANTIZERS, QUANTIZERS, dequantize, quantize  # noqa: F401
from .reader import GGUFFile, TensorDesc  # noqa: F401
from .writer import GGUFWriter  # noqa: F401
