"""Kernel K5: the one-kernel quantized MLP, y = (act(x @ Wg) * (x @ Wu)) @ Wd.

Counterpart of nfai_tpu/ops/fused_mlp.py. `fused_mlp(x, gu, dn)` runs one
layer's MLP for up to `MLP_FUSED_MAX_ROWS` rows: gate_up is the fused
4-bit [gate|up] weight (N = 2F, K = H in), dn the 4-bit down weight
(N = H, K = F), both the port's plain `Q4Tensor` in natural order (the JAX
package's permuted q4mlpg/q4mlpd containers exist for Mosaic's DMA
blocks). On a CUDA tensor it launches ``csrc/fused_mlp.cu`` — the port of
the `_fused_mlp` Pallas kernel (`_mlp_kernel_v2` and `_mlp_kernel`, one
function) — or raises; on a CPU tensor it runs `fused_mlp_plain`.

`mlp_prefill` serves larger row counts as the JAX function does: gate_up
through K1, the down weight dequantized once and multiplied with
`torch.matmul` (JAX leaves that product to XLA, outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

from ..kernels import I, Kernel, P, ptr, register, stream_ptr
from .qmatmul import matmul_plain, q4_matmul
from .qtensor import Q4Tensor, dequant

K5 = register(Kernel(
    "fused_mlp", "fused_mlp.cu",
    {"nfai_fused_mlp": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]},
))

# Rows above which the JAX package dequantizes once (mlp_prefill) instead of
# re-streaming the MLP weights per batch tile; the port keeps its routing.
MLP_FUSED_MAX_ROWS = 1024
ACTIVATIONS = ("silu", "gelu")  # gelu is the tanh approximation, as in JAX


def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    """silu, or the tanh form of gelu (gemma), by name."""
    if act == "silu":
        return nnf.silu(g)
    if act == "gelu":
        return nnf.gelu(g, approximate="tanh")
    raise ValueError(f"activation must be one of {ACTIVATIONS}, got {act!r}")


def mlp_eligible(gu, dn) -> bool:
    """Whether a (w_gate_up, w_down) pair of layer stacks takes the fused
    route: both 4-bit in every layer (a LayerList or an 8-bit stack does
    not), and the JAX package's own layout rule (`mlp_tfb_for`, less its
    VMEM arithmetic, which is the TPU's): K % 1024 == 0 and F % 256 == 0."""
    if not (isinstance(gu, Q4Tensor) and isinstance(dn, Q4Tensor)):
        return False
    f = gu.n // 2
    return gu.n == 2 * f and dn.k == f and gu.k % 1024 == 0 and f % 256 == 0


def fused_mlp_plain(x: torch.Tensor, gu: Q4Tensor, dn: Q4Tensor,
                    act: str = "silu") -> torch.Tensor:
    """x [M, K] → bf16 [M, H] in f32, the activation rounded to bf16 before
    the down product (as both Pallas bodies do)."""
    f = gu.n // 2
    g_u = x.float() @ dequant(gu).T
    return matmul_plain((activation(g_u[:, :f], act) * g_u[:, f:]).to(torch.bfloat16), dn)


def _f_tile(m: int, f: int, row_tile: int) -> int:
    """FFN columns per block: 64 while the grid fills the card; wider at
    prefill row counts, where every extra F tile adds M*H partial sums to
    write and read back."""
    row_tiles = -(-m // row_tile)
    tf = 64
    while tf < 512 and f % (2 * tf) == 0 and row_tiles * (f // tf) > 264:
        tf *= 2
    return tf


def fused_mlp(x: torch.Tensor, gu: Q4Tensor, dn: Q4Tensor,
              act: str = "silu") -> torch.Tensor:
    """One layer's MLP for x [M, K] (M ≤ MLP_FUSED_MAX_ROWS) → [M, H] bf16."""
    if act not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {act!r}")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, gu, dn, act)
    m, k = x.shape
    f, h = gu.n // 2, dn.n
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_mlp on CUDA takes bf16 activations, got {x.dtype}")
    if gu.k != k or dn.k != f or gu.qs.shape != (2 * f, k // 2) or dn.qs.shape != (h, f // 2):
        raise ValueError(f"weights {tuple(gu.qs.shape)}, {tuple(dn.qs.shape)} do not "
                         f"form an MLP for x {tuple(x.shape)}")
    if k % 128 or f % 64 or h % 256:
        raise ValueError(f"fused_mlp needs K % 128, F % 64, H % 256 == 0; got {k}, {f}, {h}")
    if m > MLP_FUSED_MAX_ROWS:
        raise ValueError(f"fused_mlp takes at most {MLP_FUSED_MAX_ROWS} rows, got {m}")
    leaves = (x, gu.qs, gu.scales, gu.mins, dn.qs, dn.scales, dn.mins)
    if any(t.device != x.device or not t.is_contiguous() for t in leaves):
        raise ValueError("fused_mlp needs contiguous tensors on one device")
    if any(t.dtype != torch.float32 for t in leaves[2:4] + leaves[5:]):
        raise TypeError("fused_mlp needs f32 scales and mins")
    y = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    row_tile = 16 if m <= 16 else 64
    tf = _f_tile(m, f, row_tile)
    # per-F-tile f32 partials [F / TF, M, H] (every one written before it is
    # read), then one zeroed arrival counter per (row tile, 256-column
    # chunk): the last block at a chunk sums its partials in F-tile order,
    # so equal inputs give equal bits
    n_part = f // tf * m * h
    work = torch.empty(n_part + math.ceil(m / row_tile) * (h // 256), dtype=torch.float32,
                       device=x.device)
    work[n_part:].zero_()
    K5.call(
        "nfai_fused_mlp", ptr(x), ptr(gu.qs), ptr(gu.scales), ptr(gu.mins),
        ptr(dn.qs), ptr(dn.scales), ptr(dn.mins), ptr(work), ptr(y),
        m, k, f, h, tf, int(act == "gelu"), stream_ptr(x),
    )
    K5.count()
    return y


def fused_mlp_layered(x: torch.Tensor, gu: Q4Tensor, dn: Q4Tensor, layer: int,
                      act: str = "silu") -> torch.Tensor:
    """Layer-indexed fused MLP over stacked containers, x [..., K] → [..., H]
    in x's dtype (the JAX `fused_mlp_layered`; its `fused_mlp` is this on a
    one-layer slice)."""
    lead = x.shape[:-1]
    y = fused_mlp(x.reshape(-1, gu.k).contiguous(), gu.layer(layer), dn.layer(layer), act)
    return y.reshape(*lead, dn.n).to(x.dtype)


def mlp_prefill(x: torch.Tensor, gu: Q4Tensor, dn: Q4Tensor,
                act: str = "silu") -> torch.Tensor:
    """The MLP for large row counts (the JAX `mlp_prefill`): gate_up through
    K1, the activation rounded to bf16, the down weight dequantized once per
    call and multiplied in bf16 with f32 accumulation. x [..., K] → [..., H]
    in x's dtype."""
    lead = x.shape[:-1]
    f = gu.n // 2
    g_u = q4_matmul(x.reshape(-1, gu.k).to(torch.bfloat16).contiguous(), gu)
    a = (activation(g_u[:, :f].float(), act) * g_u[:, f:].float()).to(torch.bfloat16)
    y = torch.matmul(a, dequant(dn).to(torch.bfloat16).T)
    return y.reshape(*lead, dn.n).to(x.dtype)
