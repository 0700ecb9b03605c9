"""Kernel K5: the one-kernel quantized MLP, y = (act(x @ Wg) * (x @ Wu)) @ Wd.

Counterpart of nfai_tpu/ops/fused_mlp.py. `fused_mlp(x, gu, dn)` runs one
layer's MLP for up to `MLP_FUSED_MAX_ROWS` rows: gate_up is the fused
4-bit [gate|up] weight (N = 2F, K = H in), dn the 4-bit down weight
(N = H, K = F), both the port's plain `Q4Tensor` in natural order (the JAX
package's permuted q4mlpg/q4mlpd containers exist for Mosaic's DMA
blocks). On a CUDA tensor it launches ``csrc/fused_mlp.cu`` — the port of
the `_fused_mlp` Pallas kernel (`_mlp_kernel_v2` and `_mlp_kernel`, one
function) — or raises; on a CPU tensor it runs `fused_mlp_plain`. Up to
`DECODE_MAX_ROWS` rows it launches the decode kernel (`decode_plan`:
tensor-core GEMVs, the activation handed between the two products through
L2, a few F slices' partials summed in a fixed order); above them, and for
the shapes the decode kernel does not take, the tiles (`tiles_plan`: K1's
wgmma tiles twice in one launch, the activation through L2).

`mlp_prefill` serves larger row counts as the JAX function does: gate_up
through K1, the down weight dequantized once and multiplied with
`torch.matmul` (JAX leaves that product to XLA, outside any Pallas kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf

from ..kernels import I, Kernel, P, ptr, register, stream_ptr
from .fused_decode import sm_count
from .qmatmul import matmul_plain, q4_matmul
from .qtensor import Q4Tensor, dequant

K5 = register(Kernel(
    "fused_mlp", "fused_mlp.cu",
    {"nfai_fused_mlp_decode": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
     "nfai_fused_mlp_tiles": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]},
))

# Rows above which the JAX package dequantizes once (mlp_prefill) instead of
# re-streaming the MLP weights per batch tile; the port keeps its routing.
MLP_FUSED_MAX_ROWS = 1024
ACTIVATIONS = ("silu", "gelu")  # gelu is the tanh approximation, as in JAX

# The decode kernel (csrc/fused_mlp.cu, fused_mlp_decode_kernel): rows it
# takes, ffn columns a block, output rows of a phase-2 item, codes a ring
# stage, bytes of a warp's ring stage, warps a block, an H100 block's shared
# memory
DECODE_MAX_ROWS = 16
DECODE_FB = 64
DECODE_RB = 128
DECODE_STAGE_CODES = 256
DECODE_STAGE_BYTES = 3328
DECODE_WARPS = 8
SMEM_MAX = 232448


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


def decode_slice(f: int) -> int:
    """The F slice of the decode kernel's phase-2 items: 1024 codes, or 256
    where F % 1024 != 0."""
    return 256 if f % 1024 else 1024


def decode_plan(m: int, k: int, f: int, h: int, sms: int = 132) -> dict | None:
    """The decode kernel's launch for x [m, k] through gate_up [2f, k] and
    down [h, f] on a card of `sms` SMs, or None where it does not take the
    shape (more than 16 rows, K % 256, F % 256 or H % 128 not 0, more than
    `sms` blocks, or no ring that fits in shared memory), and the tiles run
    instead. Mirrors the .cu: F / 64 blocks, all resident at once, each
    64 ffn columns in phase 1 (8 a warp); phase 2's items, (128 output rows,
    an F slice of `decode_slice(f)` codes), dealt to the blocks in turn;
    `work` bytes (a's fragments and sums, the f32 partials [F / slice, m,
    H]) and the counters (H / 16 row groups, then F / slice twice)."""
    if not 1 <= m <= DECODE_MAX_ROWS or k % DECODE_STAGE_CODES or f % DECODE_STAGE_CODES or \
            h % DECODE_RB or f // DECODE_FB > sms:
        return None
    nf = 1 if m <= 8 else 2  # n8 fragments of x rows
    fs = decode_slice(f)
    fixed = (nf * k * 16 + (k // 32) * 8 * nf * 4 + nf * fs * 16 + (fs // 32) * 8 * nf * 4
             + 8 * nf * DECODE_FB * 2)
    stages = next((s for s in (4, 3) if fixed + DECODE_WARPS * s * DECODE_STAGE_BYTES <= SMEM_MAX),
                  None)
    if stages is None:
        return None
    n_fs = f // fs
    return dict(blocks=f // DECODE_FB, slice=fs, slices=n_fs, items=(h // DECODE_RB) * n_fs,
                stages=stages, smem=fixed + DECODE_WARPS * stages * DECODE_STAGE_BYTES,
                part=n_fs * m * h,
                work=nf * f * 16 + (f // 32) * 8 * nf * 4 + n_fs * m * h * 4,
                counters=h // 16 + 2 * n_fs)


def tiles_plan(m: int, k: int, f: int, h: int, sms: int = 132) -> dict:
    """The tiles' launch for x [m, k] through gate_up [2f, k] and down
    [h, f] (K, F and H multiples of 128). Mirrors the .cu: the row tile
    `bm` is the least of 16, 32, 64, 128 that holds m; phase 1 is F / 64 x
    row tiles, phase 2 H / 128 x row tiles x `ks` F slices, ks doubled (to
    8, dividing F / 128) while phase 2 stays within `sms` blocks; `work`
    bytes (a, then the slices' f32 sums) and the counters."""
    bm = next(w for w in (16, 32, 64, 128) if m <= w or w == 128)
    n_m, n_h = -(-m // bm), h // 128
    ks = 1
    while ks < 8 and (f // 128) % (2 * ks) == 0 and n_h * n_m * 2 * ks <= sms:
        ks *= 2
    part = ks * n_m * n_h * (bm // 2) * 256 if ks > 1 else 0
    return dict(bm=bm, row_tiles=n_m, ks=ks, blocks=(f // DECODE_FB + ks * n_h) * n_m,
                work=m * f * 2 + part * 4, counters=n_m * (2 + n_h))


# per (device, stream): K5's counters (the decode kernel's and the tiles'),
# zero between launches (each counter's last user resets it)
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 counters for K5 on `stream`."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


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
    if k % 128 or f % 128 or h % 128:
        raise ValueError(f"fused_mlp needs K, F and H multiples of 128; got {k}, {f}, {h}")
    if m > MLP_FUSED_MAX_ROWS:
        raise ValueError(f"fused_mlp takes at most {MLP_FUSED_MAX_ROWS} rows, got {m}")
    leaves = (x, gu.qs, gu.scales, gu.mins, dn.qs, dn.scales, dn.mins)
    if any(t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16 for t in leaves):
        raise ValueError("fused_mlp needs contiguous, 16-byte aligned tensors on one device")
    if any(t.dtype != torch.float32 for t in leaves[2:4] + leaves[5:]):
        raise TypeError("fused_mlp needs f32 scales and mins")
    y = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y
    sms = sm_count(x.device.index)
    plan = decode_plan(m, k, f, h, sms)
    if plan is not None:
        entry, ks = "nfai_fused_mlp_decode", ()
    else:
        plan = tiles_plan(m, k, f, h, sms)
        entry, ks = "nfai_fused_mlp_tiles", (plan["ks"],)
    # the hand-over of a and the f32 partials, each written before it is
    # read; the counters, zero between launches
    work = torch.empty(plan["work"], dtype=torch.uint8, device=x.device)
    stream = stream_ptr(x)
    counters = _counters(x.device, stream.value, plan["counters"])
    K5.call(
        entry, ptr(x), ptr(gu.qs), ptr(gu.scales), ptr(gu.mins), ptr(dn.qs), ptr(dn.scales),
        ptr(dn.mins), ptr(work), ptr(counters), ptr(y), m, k, f, h, *ks, int(act == "gelu"), stream,
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
