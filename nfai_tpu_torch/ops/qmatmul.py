"""Kernels K1 (4-bit) and K6 (8-bit) dequant-matmul, and the `linear` entry
points over them.

`q4_matmul(x, w)` computes y[M, N] = x[M, K] @ W^T for a 2-D `Q4Tensor`,
`q8_matmul(x, w)` the same for a 2-D `Q8Tensor` (bf16 out). On a CUDA
tensor each launches its hand-written kernel — ``csrc/q4_matmul.cu``, the
port of the JAX package's `_q4v3_matmul`, `_q4v3_matmul_layered` and
`_q4_matmul` Pallas kernels; ``csrc/q8_matmul.cu``, the port of
`_q8_matmul` and `_q8_matmul_layered` — or raises; on a CPU tensor it runs
`matmul_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import torch

from ..kernels import I, Kernel, P, ptr, register, stream_ptr
from .qtensor import Q4Tensor, Q8Tensor, dequant

K1 = register(Kernel(
    "q4_matmul", "q4_matmul.cu",
    {"nfai_q4_matmul": [P, P, P, P, P, I, I, I, P]},
))
K6 = register(Kernel(
    "q8_matmul", "q8_matmul.cu",
    {"nfai_q8_matmul": [P, P, P, P, P, I, I, I, I, P]},
))


def _check(x: torch.Tensor, w, name: str, qs_shape: tuple) -> tuple[int, int]:
    m, k = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes bf16 activations, got {x.dtype}")
    if w.k != k or tuple(w.qs.shape) != qs_shape:
        raise ValueError(f"weight {tuple(w.qs.shape)} does not match x {tuple(x.shape)}")
    if k % 32:
        raise ValueError(f"K={k} must be a multiple of 32")
    if m > 8 and w.n % 64:
        raise ValueError(f"N={w.n} must be a multiple of 64 for M={m} > 8")
    for t in (x, w.qs, w.scales) + (() if w.mins is None else (w.mins,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")
    if w.scales.dtype != torch.float32 or (w.mins is not None and w.mins.dtype != torch.float32):
        raise TypeError(f"{name} needs f32 scales and mins")
    return m, k


def matmul_plain(x: torch.Tensor, w: Q4Tensor | Q8Tensor) -> torch.Tensor:
    """x [M, K] (any float dtype) @ dequant(w)^T in f32 → bf16 [M, N]: the
    plain version of K1 and of K6."""
    return (x.float() @ dequant(w).T).to(torch.bfloat16)


def q4_matmul(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] bf16 for a 2-D Q4Tensor on x's device."""
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    m, k = _check(x, w, "q4_matmul", (w.n, x.shape[1] // 2))
    y = torch.empty(m, w.n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    K1.call(
        "nfai_q4_matmul", ptr(x), ptr(w.qs), ptr(w.scales), ptr(w.mins),
        ptr(y), m, k, w.n, stream_ptr(x),
    )
    K1.launches += 1
    return y


def q8_matmul(x: torch.Tensor, w: Q8Tensor) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] bf16 for a 2-D Q8Tensor on x's device (mins,
    where the kind has them, folded in: the JAX 2-D path subtracts them
    outside its kernel and the layered one inside, the same function)."""
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    m, k = _check(x, w, "q8_matmul", (w.n, x.shape[1]))
    if w.group not in (16, 32):
        raise ValueError(f"q8_matmul takes scale groups of 16 or 32, got {w.group}")
    y = torch.empty(m, w.n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    K6.call(
        "nfai_q8_matmul", ptr(x), ptr(w.qs), ptr(w.scales),
        ptr(w.mins) if w.mins is not None else None,
        ptr(y), m, k, w.n, w.group, stream_ptr(x),
    )
    K6.launches += 1
    return y


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ quantized W → [..., N] bf16 (the JAX `linear`): K1 for
    a Q4Tensor, K6 for a Q8Tensor."""
    if isinstance(w, Q4Tensor):
        matmul = q4_matmul
    elif isinstance(w, Q8Tensor):
        matmul = q8_matmul
    else:
        raise NotImplementedError(
            "dense (unquantized) matmul weights are not ported yet; the port "
            "carries 4-bit and 8-bit weights"
        )
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, w.k).contiguous(), w)
    return y.reshape(*lead, w.n)


def linear_layered(x: torch.Tensor, w, layer: int) -> torch.Tensor:
    """x @ W[layer] for a layer-stacked container or a LayerList — the
    layer's view, no copy (the JAX `linear_layered`)."""
    return linear(x, w.layer(layer))
