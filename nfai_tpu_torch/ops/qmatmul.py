"""Kernels K1 (4-bit) and K6 (8-bit) dequant-matmul, the `linear` entry
points over them, and the grouped (MoE expert) kernels K8 (4-bit) and K9
(8-bit) behind `qmatmul_grouped`.

`q4_matmul(x, w)` computes y[M, N] = x[M, K] @ W^T for a 2-D `Q4Tensor`,
`q8_matmul(x, w)` the same for a 2-D `Q8Tensor` (bf16 out). On a CUDA
tensor each launches its hand-written kernel — ``csrc/q4_matmul.cu``, the
port of the JAX package's `_q4v3_matmul`, `_q4v3_matmul_layered` and
`_q4_matmul` Pallas kernels; ``csrc/q8_matmul.cu``, the port of
`_q8_matmul` and `_q8_matmul_layered` — or raises; on a CPU tensor it runs
`matmul_plain`, the same function in plain PyTorch.

`qmatmul_grouped(x, w, block_group, tm)` multiplies row block i of x
(tm rows) by expert block_group[i] of a stacked [E, ...] container:
``csrc/grouped_matmul.cu``, the port of `_grouped_call` through
`_qmatmul_grouped_q4` (K8) and `_qmatmul_grouped_q8` (K9), or on a CPU
tensor `qmatmul_grouped_plain`.

`q8v3_matmul(x, w)` computes y[M, N] = x[M, K] @ W^T for a 2-D
`Q8V3Tensor` (a layer of a stack is a view: its pointer is an offset into
the stacked buffer, nothing is copied): on a CUDA tensor
``csrc/q8v3_matmul.cu`` (K12), the port of `_q8v3_matmul_layered` (the
JAX 2-D q8v3 head runs it as a one-layer stack), which decodes the nibble
planes with bit operations only (a GEMV at M <= 8, TMA-fed wgmma tiles
above); on a CPU tensor `q8v3_matmul_plain`, the same decode written out in
PyTorch.

`dense_matmul_layered(x, w, layer)` computes x @ w[layer]^T for a dense
(unquantized) weight stack w [L, N, K] in the activation dtype: on a CUDA
tensor ``csrc/dense_matmul.cu`` (K11), the port of `_dense_matmul_layered`,
which reads the layer in place from the stack; on a CPU tensor
`dense_matmul_plain`. A dense 2-D weight (the LM head) is multiplied with
`torch.matmul`, as the JAX package leaves `x @ w` to XLA.
"""
from __future__ import annotations

import torch

from ..kernels import I, Kernel, P, ptr, register, stream_ptr
from .qtensor import Q4Tensor, Q8Tensor, Q8V3Tensor, dequant, q8v3_order, q8v3_planar

K1 = register(Kernel(
    "q4_matmul", "q4_matmul.cu",
    {"nfai_q4_matmul": [P, P, P, P, P, I, I, I, P]},
))
K6 = register(Kernel(
    "q8_matmul", "q8_matmul.cu",
    {"nfai_q8_matmul": [P, P, P, P, P, I, I, I, I, P]},
))
K8 = register(Kernel(
    "grouped_q4", "grouped_matmul.cu",
    {"nfai_grouped_q4": [P, P, P, P, P, P, P, I, I, I, I, P]},
))
K9 = register(Kernel(
    "grouped_q8", "grouped_matmul.cu",
    {"nfai_grouped_q8": [P, P, P, P, P, P, P, I, I, I, I, I, P]},
))
K11 = register(Kernel(
    "dense_matmul", "dense_matmul.cu",
    {"nfai_dense_matmul": [P, P, P, I, I, I, I, I, P]},
))
K12 = register(Kernel(
    "q8v3_matmul", "q8v3_matmul.cu",
    {"nfai_q8v3_matmul": [P, P, P, P, P, I, I, I, I, P]},
))


def _check(x: torch.Tensor, w, name: str, qs_shape: tuple) -> tuple[int, int]:
    m, k = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes bf16 activations, got {x.dtype}")
    if w.k != k or tuple(w.qs.shape) != qs_shape:
        raise ValueError(f"weight {tuple(w.qs.shape)} does not match x {tuple(x.shape)}")
    if k % 32:
        raise ValueError(f"K={k} must be a multiple of 32")
    for t in (x, w.qs, w.scales) + (() if w.mins is None else (w.mins,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")
    if w.scales.dtype != torch.float32 or (w.mins is not None and w.mins.dtype != torch.float32):
        raise TypeError(f"{name} needs f32 scales and mins")
    return m, k


def q4_check(x: torch.Tensor, w: Q4Tensor) -> tuple[int, int]:
    """What K1 takes, or a ValueError/TypeError: bf16 x [M, K] and a 2-D
    Q4Tensor [N, K] (f32 scales and mins), K % 32 == 0, every tensor
    contiguous, on x's device and 16-byte aligned (the GEMV's 16-byte and
    float4 loads, the tiles' TMA map of x and their 16-byte copies). Any M
    and N: the kernel masks the ragged edges. Returns (M, K)."""
    m, k = _check(x, w, "q4_matmul", (w.n, x.shape[1] // 2))
    if any(t.data_ptr() % 16 for t in (x, w.qs, w.scales, w.mins)):
        raise ValueError("q4_matmul needs 16-byte aligned tensors")
    return m, k


def q8_check(x: torch.Tensor, w: Q8Tensor) -> tuple[int, int]:
    """What K6 takes, or a ValueError/TypeError: bf16 x [M, K] and a 2-D
    Q8Tensor [N, K] (f32 scales, and mins where the kind has them), K % 32
    == 0, scale groups of 16 or 32, every tensor contiguous and on x's
    device, x and the codes 16-byte aligned (the GEMVs' 16-byte loads, the
    tiles' TMA maps; unaligned scale rows are read one by one). Any M and N:
    the kernel masks the ragged edges. Returns (M, K)."""
    m, k = _check(x, w, "q8_matmul", (w.n, x.shape[1]))
    if w.group not in (16, 32):
        raise ValueError(f"q8_matmul takes scale groups of 16 or 32, got {w.group}")
    if x.data_ptr() % 16 or w.qs.data_ptr() % 16:
        raise ValueError("q8_matmul needs 16-byte aligned activations and codes")
    return m, k


def matmul_plain(x: torch.Tensor, w: Q4Tensor | Q8Tensor) -> torch.Tensor:
    """x [M, K] (any float dtype) @ dequant(w)^T in f32 → bf16 [M, N]: the
    plain version of K1 and of K6."""
    return (x.float() @ dequant(w).T).to(torch.bfloat16)


def q4_matmul(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] bf16 for a 2-D Q4Tensor on x's device."""
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    m, k = q4_check(x, w)
    y = torch.empty(m, w.n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    K1.call(
        "nfai_q4_matmul", ptr(x), ptr(w.qs), ptr(w.scales), ptr(w.mins),
        ptr(y), m, k, w.n, stream_ptr(x),
    )
    K1.count()
    return y


def q8_matmul(x: torch.Tensor, w: Q8Tensor) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] bf16 for a 2-D Q8Tensor on x's device (mins,
    where the kind has them, folded in: the JAX 2-D path subtracts them
    outside its kernel and the layered one inside, the same function)."""
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    m, k = q8_check(x, w)
    y = torch.empty(m, w.n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    K6.call(
        "nfai_q8_matmul", ptr(x), ptr(w.qs), ptr(w.scales),
        ptr(w.mins) if w.mins is not None else None,
        ptr(y), m, k, w.n, w.group, stream_ptr(x),
    )
    K6.count()
    return y


def q8v3_matmul_plain(x: torch.Tensor, w: Q8V3Tensor) -> torch.Tensor:
    """x [M, K] (any float dtype) @ W^T → bf16 [M, N] with W the decode
    written out (u0 = (hi - 50) + lo in bf16, times 8s, minus the mins, in
    f32) and rounded once to bf16, as K12's wgmma tiles round it
    (A = bf16(v/16 · 8s − m/2), the sums doubled) and as the JAX kernel
    feeds its bf16 dot; products and sums in f32: the plain version of K12.
    W stays in the planes' K order and x is permuted to it (the same sum,
    without reordering the big operand), and W is decoded 1024 rows at a
    time, so a block stays in the CPU's caches between its decode and its
    product."""
    xp = x.float().index_select(-1, q8v3_order(w.k).to(x.device))
    rows = 1024

    def weight(r):  # rows r .. r + 1023 of W, rounded once to bf16
        return q8v3_planar(w._map(lambda t: t[r:r + rows])).to(torch.bfloat16).float()

    parts = [xp @ weight(r).T for r in range(0, w.n, rows)]
    return torch.cat(parts, dim=-1).to(torch.bfloat16)


def q8v3_check(x: torch.Tensor, w: Q8V3Tensor) -> tuple[int, int]:
    """What K12 takes, or a ValueError/TypeError: bf16 x [M, K] and a 2-D
    Q8V3Tensor [N, K] (uint8 planes, bf16 scales and mins), K % 128 == 0
    (the planes' chunks, the tiles' stages), scale groups of 16 or 32, every
    tensor contiguous, on x's device and 16-byte aligned (the GEMV's 16-byte
    loads, the tiles' TMA maps of x and the planes, their 16- and 8-byte
    copies of a stage's scales and mins; a layer of a stack is an offset
    into it, so it keeps the stack's alignment only where a layer's bytes
    are a multiple of 16). Any M and N: the kernel masks the ragged edges.
    Returns (M, K)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"q8v3_matmul on CUDA takes bf16 activations, got {x.dtype}")
    m, k = x.shape
    if w.k != k or tuple(w.qs.shape) != (w.n, k) or w.qs.dtype != torch.uint8:
        raise ValueError(f"q8v3 weight {tuple(w.qs.shape)} does not match x {tuple(x.shape)}")
    if k % 128 or w.group not in (16, 32):
        raise ValueError(f"q8v3_matmul takes K % 128 == 0 and groups of 16 or 32; got K={k}, "
                         f"group {w.group}")
    leaves = (x, w.qs, w.scales) + (() if w.mins is None else (w.mins,))
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16 for t in leaves):
        raise ValueError("q8v3_matmul needs contiguous, 16-byte aligned tensors on one device")
    if w.scales.dtype != torch.bfloat16 or (w.mins is not None and w.mins.dtype != torch.bfloat16):
        raise TypeError("q8v3_matmul needs bf16 scales and mins")
    return m, k


def q8v3_matmul(x: torch.Tensor, w: Q8V3Tensor) -> torch.Tensor:
    """x [M, K] bf16 @ W^T → [M, N] bf16 for a 2-D Q8V3Tensor on x's device
    (what it takes: `q8v3_check`)."""
    if x.device.type == "cpu":
        return q8v3_matmul_plain(x, w)
    m, k = q8v3_check(x, w)
    y = torch.empty(m, w.n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    K12.call(
        "nfai_q8v3_matmul", ptr(x), ptr(w.qs), ptr(w.scales),
        ptr(w.mins) if w.mins is not None else None,
        ptr(y), m, k, w.n, w.group, stream_ptr(x),
    )
    K12.count()
    return y


def dense_matmul_plain(x: torch.Tensor, w: torch.Tensor, layer: int) -> torch.Tensor:
    """x [M, K] @ w[layer]^T for a dense stack w [L, N, K]: x rounded to
    w's dtype, products and sums in f32, the result in x's dtype (the JAX
    wrapper casts x to the weight's dtype and returns x's; f32 operands stay
    f32). The plain version of K11."""
    return (x.to(w.dtype).float() @ w[layer].float().T).to(x.dtype)


def dense_matmul_layered(x: torch.Tensor, w: torch.Tensor, layer: int) -> torch.Tensor:
    """x [M, K] bf16 @ w[layer]^T → [M, N] bf16 for a dense bf16 stack w
    [L, N, K] on x's device; any M, K and N. The layer is an offset into the
    stack: nothing is sliced or copied."""
    if x.device.type == "cpu":
        return dense_matmul_plain(x, w, layer)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"dense_matmul_layered on CUDA takes bf16 x and w, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[2] != x.shape[1]:
        raise ValueError(f"weight stack {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if not 0 <= layer < w.shape[0]:
        raise IndexError(f"layer {layer} of a {w.shape[0]}-layer stack")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_matmul_layered needs contiguous tensors on one device")
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    vec = k % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    K11.call("nfai_dense_matmul", ptr(x), ptr(w), ptr(y), m, k, n, layer, int(vec), stream_ptr(x))
    K11.count()
    return y


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ W → [..., N] (the JAX `linear`): K1 for a Q4Tensor,
    K6 for a Q8Tensor, K12 for a Q8V3Tensor (bf16 out); `torch.matmul` for a
    dense [N, K] tensor in the activation dtype (the LM head, which JAX
    leaves to XLA)."""
    if isinstance(w, torch.Tensor):
        return torch.matmul(x.to(w.dtype), w.T)
    if isinstance(w, Q4Tensor):
        matmul = q4_matmul
    elif isinstance(w, Q8Tensor):
        matmul = q8_matmul
    elif isinstance(w, Q8V3Tensor):
        matmul = q8v3_matmul
    else:
        raise TypeError(f"no matmul for a weight of type {type(w).__name__}")
    lead = x.shape[:-1]
    y = matmul(x.reshape(-1, w.k).contiguous(), w)
    return y.reshape(*lead, w.n)


def linear_layered(x: torch.Tensor, w, layer: int) -> torch.Tensor:
    """x @ W[layer] for a layer stack (the JAX `linear_layered`): K11 on a
    dense [L, N, K] stack; for a quantized stacked container or a LayerList,
    the layer's view (no copy) through `linear`."""
    if isinstance(w, torch.Tensor):
        lead = x.shape[:-1]
        y = dense_matmul_layered(x.reshape(-1, w.shape[2]).contiguous(), w, layer)
        return y.reshape(*lead, w.shape[1])
    return linear(x, w.layer(layer))


def qmatmul_grouped_plain(x: torch.Tensor, w: Q4Tensor | Q8Tensor, block_group: torch.Tensor,
                          tm: int, block_rows: torch.Tensor) -> torch.Tensor:
    """x [M, K] (M % tm == 0) → bf16 [M, N]: row block i times expert
    block_group[i] of the stacked [E, ...] container in f32; zero on the
    rows of block i past block_rows[i]. The plain version of K8 and K9."""
    m, k = x.shape
    wsel = dequant(w._map(lambda t: t[block_group.to(x.device).long()]))  # [M/tm, N, K]
    y = torch.einsum("btk,bnk->btn", x.float().reshape(m // tm, tm, k), wsel)
    rows = block_rows.to(x.device).long()[:, None]
    keep = torch.arange(tm, device=x.device)[None] < rows
    return torch.where(keep[..., None], y, 0.0).reshape(m, w.n).to(torch.bfloat16)


def qmatmul_grouped(x: torch.Tensor, w: Q4Tensor | Q8Tensor, block_group: torch.Tensor,
                    tm: int, block_rows: torch.Tensor) -> torch.Tensor:
    """Group-aligned grouped matmul (the JAX `qmatmul_grouped`, with the
    real rows of each block given, as `models.llama.moe_group_layout`
    returns them; see `qmatmul_grouped_plain`): x [M, K] bf16, w a stacked
    [E, ...] Q4Tensor (K8) or Q8Tensor (K9), block_group / block_rows
    [M/tm] int32. tm = 8 or a multiple of 32 (then N % 64 == 0)."""
    if x.device.type == "cpu":
        return qmatmul_grouped_plain(x, w, block_group, tm, block_rows)
    m, k = x.shape
    if isinstance(w, Q4Tensor):
        kernel, qs_shape = K8, (w.n, k // 2)
    elif isinstance(w, Q8Tensor):
        kernel, qs_shape = K9, (w.n, k)
        if w.group not in (16, 32):
            raise ValueError(f"grouped_q8 takes scale groups of 16 or 32, got {w.group}")
    else:
        raise NotImplementedError("grouped matmul takes 4-bit and 8-bit expert stacks")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"qmatmul_grouped on CUDA takes bf16 activations, got {x.dtype}")
    if w.qs.dim() != 3 or w.k != k or tuple(w.qs.shape[1:]) != qs_shape:
        raise ValueError(f"expert stack {tuple(w.qs.shape)} does not match x {tuple(x.shape)}")
    if k % 32 or m % tm or not (tm == 8 or (tm % 32 == 0 and w.n % 64 == 0)):
        raise ValueError(f"grouped matmul needs K % 32 == 0, M % tm == 0 and tm = 8 or a "
                         f"multiple of 32 with N % 64 == 0; got K={k}, M={m}, tm={tm}, N={w.n}")
    index = (block_group, block_rows)
    for t in index:
        if t.dtype != torch.int32 or t.shape != (m // tm,):
            raise ValueError(f"block_group / block_rows must be int32 [{m // tm}]; got "
                             f"{t.dtype} {tuple(t.shape)}")
    leaves = (x, w.qs, w.scales) + (() if w.mins is None else (w.mins,)) + index
    if any(t.device != x.device or not t.is_contiguous() for t in leaves):
        raise ValueError("qmatmul_grouped needs contiguous tensors on one device")
    if w.scales.dtype != torch.float32 or (w.mins is not None and w.mins.dtype != torch.float32):
        raise TypeError("qmatmul_grouped needs f32 scales and mins")
    y = torch.empty(m, w.n, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    args = (ptr(x), ptr(w.qs), ptr(w.scales), ptr(w.mins) if w.mins is not None else None,
            ptr(block_group), ptr(block_rows), ptr(y),
            m, k, w.n, tm)
    if kernel is K8:
        K8.call("nfai_grouped_q4", *args, stream_ptr(x))
    else:
        K9.call("nfai_grouped_q8", *args, w.group, stream_ptr(x))
    kernel.count()
    return y
