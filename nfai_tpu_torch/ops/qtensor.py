"""The port's quantized weight containers and their packers.

Both containers keep a GGUF matmul weight quantized in device memory, in a
layout chosen for a GPU kernel rather than for Mosaic: N-major like GGUF
itself (each output row's K values contiguous), with f32 scales (and mins):

- `Q4Tensor` (Q4_0, Q4_1, Q4_K), one 16-byte block of nibbles and one f32
  scale and min per 32 weights:

      w[n, k] = scales[n, k // 32] * q[n, k] - mins[n, k // 32]

  ``qs`` uint8 [..., N, K/2]: 32-block b of row n is bytes [16b, 16b+16);
  byte j holds element 32b+j in its low nibble and 32b+16+j in its high
  nibble — the Q4_0/Q4_1 block order, so those payloads copy verbatim and
  Q4_K's 64-element chunks are re-threaded once at load. 0.75 bytes per
  weight, against 0.5625 for GGUF's own Q4_K;
- `Q8Tensor` (Q8_0, Q5_K, Q6_K, Q2_K, Q3_K), one int8 per weight and one
  f32 scale (and min, for Q5_K/Q2_K) per `group` = 32 or 16 weights:

      w[n, k] = scales[n, k // g] * q[n, k] (- mins[n, k // g])

  ``qs`` int8 [..., N, K]. Q6_K takes 1.25 bytes per weight here against
  0.82 in GGUF, Q8_0 1.125 against 1.0625;
- `Q8V3Tensor` ("q8v3", the opt-in ``NFAI_Q8V3`` container of the JAX
  package's `to_q8v3_stacked`): the int8 codes of a `Q8Tensor` split into
  two nibble planes, lo = v & 0xF and hi = (v >> 4) + 8, which decode to
  bf16 with bit operations only: lo under the header 0x4000 is 2 + lo/8,
  hi under 0x4200 is 32 + 2 hi, and the fold u0 = (hi - 50) + lo is exact
  in bf16 and equals v/8. With the effective scales 8s and the mins stored
  in bf16, as the JAX container stores them:

      w[n, k] = u0[n, k] * scales[n, k // g] (- mins[n, k // g])

  ``qs`` uint8 [..., N, K], K*N bytes like int8, N-major, in chunks of 128
  codes laid out for the mma.sync fragments of K12 (`_Q8V3_NIBBLE`).

f32 makes the dequantized weight equal `gguf.quants.dequantize` bit for
bit (Q4_K's d*sc needs 17 mantissa bits, more than f16 has).

A leading layer axis ([L, ...] on every leaf) makes a layer-stacked weight;
`layer(i)` is a view, which is all the kernels need to serve both the 2-D
and the layered entry points of the JAX package. A stack whose layers mix
kinds (a Q4_K_M file keeps attn_v and ffn_down in Q6_K on some layers) is a
`LayerList`: each layer stays in its own container behind the same
`layer(i)`, where the JAX package promotes the whole stack to its 8-bit
container (`unify_qtensors`). The function computed is the same.

A weight the JAX package keeps dense (a kind without a container, a shape
outside the kernel layout, or every weight under a `param_dtype` other
than "auto") is a plain tensor [..., N, K] in the activation dtype. The
helpers below (`same_layout`, `concat`, `permute_rows`, `stack`,
`n_layers`) take such tensors beside the containers; a stack whose layers
mix quantized and dense weights is dequantized whole (`to_dense`: f32,
then one rounding to the dtype), as the JAX `stack` does.

`from_jax_qtensor` undoes the JAX package's TPU packings (v2 split-half
nibbles with the /16 and -8 folds, v3 word planes, merged q4v3m scales, the
fused-MLP permutations of q4mlpg/q4mlpd, N padding) into these containers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.quants import _unpack_kquant_scales, _unpack_q3k_scales

QBLOCK = 32


class _Container:
    """What the containers share: leaves qs/scales/mins (mins may be None)
    with an optional leading layer axis."""

    def _map(self, fn, **changes):
        return dataclasses.replace(
            self, qs=fn(self.qs), scales=fn(self.scales),
            mins=None if self.mins is None else fn(self.mins), **changes,
        )

    def layer(self, i: int):
        return self._map(lambda t: t[i])

    def to(self, device):
        return self._map(lambda t: t.to(device))


@dataclasses.dataclass
class Q4Tensor(_Container):
    """A 4-bit weight of logical shape (N out, K in); see module doc."""

    qs: torch.Tensor  # uint8 [..., N, K/2]
    scales: torch.Tensor  # f32 [..., N, K/32]
    mins: torch.Tensor  # f32 [..., N, K/32]
    k: int
    n: int

    @property
    def group(self) -> int:
        return QBLOCK


@dataclasses.dataclass
class Q8Tensor(_Container):
    """An 8-bit weight of logical shape (N out, K in); see module doc."""

    qs: torch.Tensor  # int8 [..., N, K]
    scales: torch.Tensor  # f32 [..., N, K/group]
    mins: torch.Tensor | None  # f32 [..., N, K/group] or None (symmetric kinds)
    k: int
    n: int
    group: int = QBLOCK


@dataclasses.dataclass
class Q8V3Tensor(_Container):
    """An 8-bit weight of logical shape (N out, K in) in nibble planes; see
    module doc."""

    qs: torch.Tensor  # uint8 [..., N, K] (two nibble planes per 128-code chunk)
    scales: torch.Tensor  # bf16 [..., N, K/group], the effective 8s
    mins: torch.Tensor | None  # bf16 [..., N, K/group] or None (symmetric kinds)
    k: int
    n: int
    group: int = QBLOCK


@dataclasses.dataclass
class LayerList:
    """Per-layer weights of mixed kinds behind the stacked containers'
    `layer(i)`."""

    items: list

    def layer(self, i: int):
        return self.items[i]

    def to(self, device) -> "LayerList":
        return LayerList([it.to(device) for it in self.items])

    @property
    def k(self) -> int:
        return self.items[0].k

    @property
    def n(self) -> int:
        return self.items[0].n


def n_layers(w) -> int:
    """Layer count of a stacked container, a LayerList or a dense stack."""
    if isinstance(w, LayerList):
        return len(w.items)
    return w.shape[0] if isinstance(w, torch.Tensor) else w.qs.shape[0]


def same_layout(items: list) -> bool:
    """Whether the weights share container, group, K and the presence of
    mins (or are all dense tensors of one K and dtype) — the condition to
    fuse them along N or stack them."""
    a = items[0]
    if isinstance(a, torch.Tensor):
        return all(isinstance(it, torch.Tensor) and it.shape[-1] == a.shape[-1]
                   and it.dtype == a.dtype for it in items)
    return all(
        type(it) is type(a) and it.group == a.group and it.k == a.k
        and (it.mins is None) == (a.mins is None)
        for it in items
    )


# ---------------------------------------------------------------------------
# packing GGUF blocks


def _from_numpy(q_bytes: np.ndarray, scales: np.ndarray, mins: np.ndarray,
                k: int, n: int) -> Q4Tensor:
    return Q4Tensor(
        torch.from_numpy(np.ascontiguousarray(q_bytes, dtype=np.uint8)),
        torch.from_numpy(np.ascontiguousarray(scales, dtype=np.float32)),
        torch.from_numpy(np.ascontiguousarray(mins, dtype=np.float32)),
        k, n,
    )


def _q8_from_numpy(q: np.ndarray, scales: np.ndarray, mins: np.ndarray | None,
                   group: int) -> Q8Tensor:
    *_, n, k = q.shape
    as_f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return Q8Tensor(
        torch.from_numpy(np.ascontiguousarray(q, dtype=np.int8)), as_f32(scales),
        None if mins is None else as_f32(mins), k, n, group,
    )


# integer-level decoders of the 8-bit kinds (q values [N, K] + effective
# scales/mins [N, K/g]), the JAX package's _q8_0_int .. _q3_k_int


def _q8_0_int(raw: np.ndarray, n_out: int, k_in: int):
    blocks = raw.reshape(n_out * k_in // 32, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32).reshape(n_out, k_in // 32)
    q = blocks[:, 2:].view(np.int8).reshape(n_out, k_in)
    return q, d, None


def _q5_k_int(raw: np.ndarray, n_out: int, k_in: int):
    """Q5_K → values 0..31 + effective scales/mins per 32."""
    nb = n_out * k_in // 256
    blocks = raw.reshape(nb, 176)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mi = _unpack_kquant_scales(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:176].reshape(nb, 4, 32)
    j = np.arange(4)
    hb1 = ((qh[:, None, :] >> (2 * j)[None, :, None]) & 1).astype(np.uint8)
    hb2 = ((qh[:, None, :] >> (2 * j + 1)[None, :, None]) & 1).astype(np.uint8)
    lo = (qs & 0x0F) | (hb1 << 4)
    hi = (qs >> 4) | (hb2 << 4)
    q = np.stack([lo, hi], axis=2).reshape(nb, 256)
    scales = (d * sc.astype(np.float32)).reshape(n_out, k_in // 32)
    mins = (dmin * mi.astype(np.float32)).reshape(n_out, k_in // 32)
    return q.reshape(n_out, k_in), scales, mins


def _q6_k_int(raw: np.ndarray, n_out: int, k_in: int):
    """Q6_K → q-32 (symmetric) + effective scales per 16."""
    nb = n_out * k_in // 256
    blocks = raw.reshape(nb, 210)
    ql = blocks[:, 0:128].reshape(nb, 2, 64)
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)  # (nb,16)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)
    q1 = (ql[:, :, :32] & 0x0F) | (((qh >> 0) & 3) << 4)
    q2 = (ql[:, :, 32:] & 0x0F) | (((qh >> 2) & 3) << 4)
    q3 = (ql[:, :, :32] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[:, :, 32:] >> 4) | (((qh >> 6) & 3) << 4)
    q = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, 256).astype(np.int16) - 32
    scales = (d * sc).reshape(n_out, k_in // 16)
    return q.astype(np.int8).reshape(n_out, k_in), scales, None


def _q2_k_int(raw: np.ndarray, n_out: int, k_in: int):
    """Q2_K → values 0..3 + effective scales/mins per 16."""
    nb = n_out * k_in // 256
    blocks = raw.reshape(nb, 84)
    scales8 = blocks[:, 0:16]
    qs = blocks[:, 16:80].reshape(nb, 2, 32)
    d = blocks[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = blocks[:, 82:84].copy().view(np.float16).astype(np.float32)
    shifts = np.arange(4)
    q = ((qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3).reshape(nb, 256)
    scales = (d * (scales8 & 0x0F).astype(np.float32)).reshape(n_out, k_in // 16)
    mins = (dmin * (scales8 >> 4).astype(np.float32)).reshape(n_out, k_in // 16)
    return q.astype(np.int8).reshape(n_out, k_in), scales, mins


def _q3_k_int(raw: np.ndarray, n_out: int, k_in: int):
    """Q3_K → signed values (hmask applied) + effective scales per 16."""
    nb = n_out * k_in // 256
    blocks = raw.reshape(nb, 110)
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96].reshape(nb, 2, 32)
    sc = _unpack_q3k_scales(blocks[:, 96:108]).astype(np.float32)  # (nb,16)
    d = blocks[:, 108:110].copy().view(np.float16).astype(np.float32)
    shifts = np.arange(4)
    q = ((qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3).astype(np.int16)
    m = (4 * np.arange(2)[:, None] + shifts[None, :]).reshape(1, 2, 4, 1)
    hb = ((hmask[:, None, None, :] >> m) & 1).astype(np.int16)
    q = q - (1 - hb) * 4
    scales = (d * sc).reshape(n_out, k_in // 16)
    return q.astype(np.int8).reshape(n_out, k_in), scales, None


# kind -> (scale group, decoder, K multiple the block format needs)
_Q8_DECODERS = {
    GGMLType.Q8_0: (32, _q8_0_int, 32),
    GGMLType.Q5_K: (32, _q5_k_int, 256),
    GGMLType.Q6_K: (16, _q6_k_int, 256),
    GGMLType.Q2_K: (16, _q2_k_int, 256),
    GGMLType.Q3_K: (16, _q3_k_int, 256),
}
SUPPORTED_QUANT_TYPES = frozenset(
    {GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K} | set(_Q8_DECODERS)
)


def pack_gguf_tensor(raw: np.ndarray, ggml_type: GGMLType,
                     shape_out_in: tuple[int, int]) -> Q4Tensor | Q8Tensor:
    """Repack a GGUF matmul weight (numpy shape (N_out, K_in)) into a CPU
    `Q4Tensor` (4-bit kinds) or `Q8Tensor` (8-bit kinds and the k-quants
    the JAX package also widens to 8 bits). Raises NotImplementedError for
    other kinds."""
    n, k = shape_out_in
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    if ggml_type in _Q8_DECODERS:
        group, decode, k_multiple = _Q8_DECODERS[ggml_type]
        if k % k_multiple:
            raise ValueError(f"{ggml_type.name} needs K % {k_multiple} == 0, got K={k}")
        q, scales, mins = decode(raw, n, k)
        return _q8_from_numpy(q, scales, mins, group)
    if k % QBLOCK:
        raise ValueError(f"4-bit packing needs K % 32 == 0, got K={k}")
    if ggml_type == GGMLType.Q4_0:
        blocks = raw.reshape(n * k // 32, 18)
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)[:, 0]
        qs, scales, mins = blocks[:, 2:18], d, 8.0 * d  # d*q - 8d
    elif ggml_type == GGMLType.Q4_1:
        blocks = raw.reshape(n * k // 32, 20)
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)[:, 0]
        m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
        qs, scales, mins = blocks[:, 4:20], d, -m  # d*q + m
    elif ggml_type == GGMLType.Q4_K:
        if k % 256:
            raise ValueError(f"Q4_K needs K % 256 == 0, got K={k}")
        nb = n * k // 256
        blocks = raw.reshape(nb, 144)
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
        dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
        sc, mi = _unpack_kquant_scales(blocks[:, 4:16])  # (nb, 8)
        # chunk c (32 bytes) carries sub-block 2c in its low nibbles and
        # 2c+1 in its high nibbles, element j in byte j: re-thread each
        # sub-block into the 16-byte [j | j+16] block order
        chunk = blocks[:, 16:144].reshape(nb, 4, 2, 16)
        c0, c1 = chunk[:, :, 0], chunk[:, :, 1]
        sub_a = (c0 & 0x0F) | ((c1 & 0x0F) << 4)
        sub_b = (c0 >> 4) | (c1 & 0xF0)
        qs = np.stack([sub_a, sub_b], axis=2)  # (nb, 4, 2, 16)
        scales = d * sc.astype(np.float32)
        mins = dmin * mi.astype(np.float32)
    else:
        raise NotImplementedError(
            f"{ggml_type.name} weights are not ported yet (the port keeps "
            "Q4_0/Q4_1/Q4_K, Q8_0 and Q2_K/Q3_K/Q5_K/Q6_K quantized)"
        )
    return _from_numpy(
        qs.reshape(n, k // 2), scales.reshape(n, k // 32),
        mins.reshape(n, k // 32), k, n,
    )


def pack_q_values(q: np.ndarray, scales: np.ndarray, mins: np.ndarray) -> Q4Tensor:
    """Natural nibble values q [..., N, K] (0..15) and per-32 scales/mins
    [..., N, K/32] → Q4Tensor."""
    *lead, n, k = q.shape
    qb = q.astype(np.uint8).reshape(*lead, n, k // 32, 2, 16)
    packed = qb[..., 0, :] | (qb[..., 1, :] << 4)
    return _from_numpy(packed.reshape(*lead, n, k // 2), scales, mins, k, n)


def unpack_q_values(qt: Q4Tensor) -> torch.Tensor:
    """uint8 nibble values [..., N, K] in natural k order."""
    *lead, n, half = qt.qs.shape
    blocks = qt.qs.reshape(*lead, n, half // 16, 16)
    q = torch.cat([blocks & 0x0F, blocks >> 4], dim=-1)
    return q.reshape(*lead, n, half * 2)


# ---------------------------------------------------------------------------
# plain functions of the containers


def dequant(qt: Q4Tensor | Q8Tensor | Q8V3Tensor) -> torch.Tensor:
    """Dense f32 [..., N, K] (the plain version of every dequant kernel)."""
    if isinstance(qt, Q8V3Tensor):
        return _q8v3_dequant(qt)
    if isinstance(qt, Q4Tensor):
        q = unpack_q_values(qt).float()
    else:
        q = qt.qs.float()
    *lead, n, k = q.shape
    g = qt.group
    w = q.reshape(*lead, n, k // g, g) * qt.scales[..., None]
    if qt.mins is not None:
        w = w - qt.mins[..., None]
    return w.reshape(*lead, n, k)


def dequant_gather(table: Q4Tensor | Q8Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows from a quantized table in head layout (tied weights):
    the rows of an N-major head are the embedding rows, so this is a row
    gather plus dequant. ids [...] → f32 [..., K] (the JAX `dequant_gather`)."""
    return dequant(table._map(lambda t: t[ids.long()]))


def to_dense(qt: Q4Tensor | Q8Tensor, dtype) -> torch.Tensor:
    """The container's weight [..., N, K] in `dtype`: f32 first, then one
    rounding to nearest even (the JAX `np.asarray(dequant_qtensor(w), dtype)`)."""
    return dequant(qt).to(dtype)


def concat(items: list):
    """Concatenate along the output (N) axis — the wqkv / gate_up fusion."""
    if not same_layout(items):
        raise ValueError("cannot fuse weights of different containers, groups or K")
    if isinstance(items[0], torch.Tensor):
        return torch.cat(items, dim=-2)
    return _join(items, lambda ts: torch.cat(ts, dim=-2), n=sum(it.n for it in items))


def permute_rows(qt, perm: np.ndarray):
    """Reorder output rows of a container or a dense [..., N, K] tensor
    (exact: rows are independent)."""
    idx = torch.as_tensor(perm, dtype=torch.long)
    if isinstance(qt, torch.Tensor):
        return qt.index_select(-2, idx)
    return qt._map(lambda t: t.index_select(-2, idx))


def stack(items: list):
    """Layer-stack per-layer weights: one stacked container when every layer
    shares its layout, a `LayerList` when quantized layers mix kinds, and a
    dense tensor when any layer is dense (the quantized ones dequantized to
    its dtype, as the JAX `stack` does)."""
    dense = [it for it in items if isinstance(it, torch.Tensor)]
    if dense:
        return torch.stack([it if isinstance(it, torch.Tensor) else to_dense(it, dense[0].dtype)
                            for it in items])
    if not same_layout(items):
        return LayerList(list(items))
    return _join(items, torch.stack)


def _join(items: list, fn, **changes):
    """Apply fn to the list of each leaf across items (same layout)."""
    leaf = lambda name: fn([getattr(it, name) for it in items])
    return dataclasses.replace(
        items[0], qs=leaf("qs"), scales=leaf("scales"),
        mins=None if items[0].mins is None else leaf("mins"), **changes,
    )


# ---------------------------------------------------------------------------
# the q8v3 container
#
# A row's K codes fall into chunks of 128: code c = 32b + 16i + 4t + j of a
# chunk (block b, half i, lane t, j < 4) sits in plane p (lo 0, hi 1) at
# bytes [64p + 16t + 4b, +4) of the chunk, a little-endian word, in nibble
# _Q8V3_NIBBLE[4i + j]. A K12 lane t thus reads its 16 bytes of each plane
# with one load, and ((w << 3) & 0x00780078) | header, (w >> 1), (w >> 5),
# (w >> 9) give the bf16x2 pairs of codes (4t, 4t+1), (4t+2, 4t+3) of half 0
# and the same of half 1: the B fragments of two m16n8k16 products, the
# 16 codes of a product within one scale group of 16.

_Q8V3_NIBBLE = (0, 4, 1, 5, 2, 6, 3, 7)
_Q8V3_CODE = tuple(int(c) for c in np.argsort(_Q8V3_NIBBLE))  # nibble → code
Q8V3_K_MULTIPLE = 2048  # the JAX q8v3_eligible's K % 2048 == 0


def q8v3_eligible(w) -> bool:
    """Whether the JAX `q8v3_eligible` takes the container the JAX package
    holds for `w`: an 8-bit kind with scale groups of 16 or 32, K % 2048 ==
    0, a 2-D weight or a layer stack (expert stacks are kept off by the
    caller: they are [L, E, N, K], or [E, N, K] items of a LayerList)."""
    return (isinstance(w, Q8Tensor) and w.group in (16, 32) and w.k % Q8V3_K_MULTIPLE == 0
            and w.qs.dim() in (2, 3))


def _q8v3_pack(v: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., N, K] → the two nibble planes, uint8 [..., N, K]."""
    *lead, n, k = v.shape
    lo = (v & 0xF).to(torch.uint8)
    hi = ((v >> 4) + 8).to(torch.uint8)  # arithmetic shift: (v >> 4) + 8 in 0..15
    planes = []
    for nib in (lo, hi):
        # chunk, b, i, t, j → chunk, t, b, (i, j)
        x = nib.reshape(-1, k // 128, 4, 2, 4, 4).permute(0, 1, 4, 2, 3, 5)
        x = x.reshape(-1, k // 128, 4, 4, 8)[..., list(_Q8V3_CODE)]
        planes.append(x[..., 0::2] | (x[..., 1::2] << 4))  # nibble 2q low, 2q + 1 high
    out = torch.stack(planes, dim=2)  # chunk, plane, t, b, byte
    return out.reshape(*lead, n, k).contiguous()


def q8v3_nibbles(qs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The planes uint8 [..., N, K] → (lo, hi) nibbles [..., N, K] in natural
    K order (the inverse of the packing)."""
    *lead, n, k = qs.shape
    by = qs.reshape(-1, k // 128, 2, 4, 4, 4)  # chunk, plane, t, b, byte
    nib = torch.stack([by & 0xF, by >> 4], dim=-1).reshape(-1, k // 128, 2, 4, 4, 8)
    codes = nib[..., list(_Q8V3_NIBBLE)].reshape(-1, k // 128, 2, 4, 4, 2, 4)
    codes = codes.permute(0, 1, 2, 4, 5, 3, 6).reshape(-1, k // 128, 2, 128)  # plane, (b, i, t, j)
    lo, hi = codes[:, :, 0], codes[:, :, 1]
    return lo.reshape(*lead, n, k), hi.reshape(*lead, n, k)


def _u0_pair_table() -> torch.Tensor:
    """f32 [65536, 2]: for a lo-plane byte L and the hi-plane byte H at the
    same place (index L | H << 8; they hold the same two codes), u0 of the
    code in the low nibbles and of the code in the high nibbles. u0 =
    (hi - 50) + lo in bf16 arithmetic, with lo = bits 0x4000 | lo << 3
    (2 + lo/8) and hi = bits 0x4200 | hi << 3 (32 + 2 hi): exact, u0 = v/8."""
    idx = torch.arange(65536, dtype=torch.int32)
    as_bf16 = lambda nib, hdr: ((nib << 3) | hdr).to(torch.int16).view(torch.bfloat16)  # noqa: E731

    def u0(lo, hi):
        return ((as_bf16(hi, 0x4200) - 50) + as_bf16(lo, 0x4000)).float()

    lo_b, hi_b = idx & 0xFF, idx >> 8
    return torch.stack([u0(lo_b & 0xF, hi_b & 0xF), u0(lo_b >> 4, hi_b >> 4)], dim=-1)


_U0_PAIRS = _u0_pair_table()


def q8v3_order(k: int) -> torch.Tensor:
    """int64 [K]: the natural K index of each position of the plane order,
    in which a chunk's byte q = 2 j0 + i of lane t's word b holds codes
    32b + 16i + 4t + j0 (low nibble) and + 2 (high nibble)."""
    t, b, j0, i, p = torch.meshgrid(*(torch.arange(n) for n in (4, 4, 2, 2, 2)), indexing="ij")
    within = (32 * b + 16 * i + 4 * t + j0 + 2 * p).reshape(-1)
    return (torch.arange(k // 128)[:, None] * 128 + within).reshape(-1)


def _q8v3_u0_planar(qs: torch.Tensor) -> torch.Tensor:
    """f32 u0 of every code, [rows, K/128, t, b, j0, i, p] in the plane
    order: each byte pair of the two planes looked up in `_U0_PAIRS`."""
    k = qs.shape[-1]
    by = qs.reshape(-1, k // 128, 2, 64)  # chunk, plane, (t, b, q)
    idx = torch.stack([by[:, :, 0], by[:, :, 1]], dim=-1).view(torch.int16).to(torch.int32) & 0xFFFF
    u0 = _U0_PAIRS.to(qs.device).index_select(0, idx.reshape(-1))
    return u0.reshape(-1, k // 128, 4, 4, 2, 2, 2)


def q8v3_planar(qt: Q8V3Tensor) -> torch.Tensor:
    """f32 [..., N, K] of u0 * 8s (- mins) in the plane order (`q8v3_order`),
    as the JAX `dequant_qtensor` of "q8v3" computes each weight."""
    *lead, n, k = qt.qs.shape
    g = (1, 4, 1, 1, 1) if qt.group == 32 else (1, 4, 1, 2, 1)  # a group is b, or (b, i)
    per_group = lambda a: a.float().reshape(-1, k // 128, *g)  # noqa: E731
    w = _q8v3_u0_planar(qt.qs) * per_group(qt.scales)
    if qt.mins is not None:
        w = w - per_group(qt.mins)
    return w.reshape(*lead, n, k)


def _natural(planar: torch.Tensor) -> torch.Tensor:
    """[..., K] in the plane order → natural K order."""
    inv = torch.argsort(q8v3_order(planar.shape[-1])).to(planar.device)
    return planar.index_select(-1, inv)


def q8v3_u0(qs: torch.Tensor) -> torch.Tensor:
    """f32 [..., N, K] of u0 = v/8 in natural K order (the decode written
    out, without the scales)."""
    return _natural(_q8v3_u0_planar(qs).reshape(qs.shape))


def _q8v3_dequant(qt: Q8V3Tensor) -> torch.Tensor:
    """f32 u0 * 8s (- mins) in natural order, bit for bit the JAX
    `dequant_qtensor` of "q8v3"."""
    return _natural(q8v3_planar(qt))


def q8v3_from_codes(v: torch.Tensor, scales8: torch.Tensor, mins: torch.Tensor | None,
                    group: int) -> Q8V3Tensor:
    """int8 codes [..., N, K] with the effective scales 8s and mins (rounded
    to bf16 here) → Q8V3Tensor on the codes' device."""
    *_, n, k = v.shape
    if k % 128:
        raise ValueError(f"the q8v3 planes need K % 128 == 0, got K={k}")
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    return Q8V3Tensor(_q8v3_pack(v), bf(scales8), None if mins is None else bf(mins), k, n, group)


def to_q8v3_stacked(w):
    """The JAX `to_q8v3_stacked`: an eligible `Q8Tensor` (2-D or a layer
    stack) → `Q8V3Tensor` with scales 8s and the mins carried over, both
    rounded once from f32 to bf16; anything else comes back unchanged. Runs
    on the weight's device."""
    if not q8v3_eligible(w):
        return w
    return q8v3_from_codes(w.qs, 8.0 * w.scales, w.mins, w.group)


# ---------------------------------------------------------------------------
# weights carried across from the JAX package

_V3_PLANES = ((0, 0), (1, 0), (0, 4), (1, 4))  # (byte pair, nibble shift)
MLP_TFB = 256  # the JAX fused-MLP containers' default grid-step width


def mlp_col_perm(f: int, tfb: int = MLP_TFB) -> np.ndarray:
    """The JAX fused-MLP ffn permutation (nfai_tpu.ops.qtensor.mlp_col_perm):
    position (j, p, t) ← column p*F/4 + j*tfb + t."""
    nj = f // (4 * tfb)
    j, p, t = np.meshgrid(np.arange(nj), np.arange(4), np.arange(tfb), indexing="ij")
    return (p * (f // 4) + j * tfb + t).reshape(-1)


def mlp_gu_col_perm(f: int, tfb: int = MLP_TFB) -> np.ndarray:
    """Column order of the JAX "q4mlpg" [gate|up] container: grid step j's
    slab holds [gate cols of step j | up cols of step j]."""
    perm = mlp_col_perm(f, tfb).reshape(-1, 4 * tfb)
    return np.concatenate([perm, f + perm], axis=1).reshape(-1)


def _v3_values(words: np.ndarray, k: int) -> np.ndarray:
    """v3 int32 words [..., K/8, N] → nibble values [..., K, N] (inverse of
    nfai_tpu.ops.qtensor._pack_v3_words: plane p is the k quarter
    [p*K/4, (p+1)*K/4), row 2s+h of a plane sits in word row s)."""
    w = words.view(np.uint32)
    *lead, nw, n = w.shape
    kq = k // 4
    q = np.empty((*lead, k, n), np.uint8)
    for p, (byte_pair, nib_shift) in enumerate(_V3_PLANES):
        plane = q[..., p * kq:(p + 1) * kq, :]
        for half in (0, 1):
            bit = (half * 2 + byte_pair) * 8 + nib_shift
            plane[..., half::2, :] = (w >> bit) & 0x0F
    return q


def from_jax_qtensor(kind: str, qs, scales, mins, k: int, n: int,
                     sections: int = 1, group: int = QBLOCK,
                     tfb: int = 0) -> Q4Tensor | Q8Tensor:
    """A JAX-package container (numpy leaves, [K-ish, N] layout, optionally
    layer-stacked) → Q4Tensor / Q8Tensor with the same dequantized values,
    in natural order and without N padding (as `dequant_qtensor` returns).

    kinds: "q8" (int8 [K, N], per-`group` scales, optional mins); "q8v3"
    (int32 [K/4, N]: the lo nibbles' v3 word rows, then the hi nibbles'
    (biased +8), bf16 scales 8s and mins, kept bit for bit); "q4" (v2
    split-half bytes, high nibble stored as (q-8)&0xF with its scale rows
    /16 and its mins -8s); "q4v3" (int32 word planes, scales 8s and mins
    m+16s); "q4v3m" (q4v3 with mins stacked under the scales); "q4mlpg"
    (q4v3m with the [gate|up] columns in per-grid-step order) and
    "q4mlpd" (q4v3 words with merged scale/min rows in per-grid-step
    order), both with grid-step width `tfb` (0 = the default 256). Anything
    else raises."""
    sc = np.asarray(scales, np.float32)
    swap = lambda a: np.swapaxes(a[..., :n], -1, -2)  # drop N padding, go N-major
    if kind == "q8":
        q = np.asarray(qs).view(np.int8)
        mn = None if mins is None else swap(np.asarray(mins, np.float32))
        return _q8_from_numpy(swap(q), swap(sc), mn, group)
    if kind == "q8v3":
        words = np.asarray(qs)
        nw = k // 8
        lo = _v3_values(words[..., :nw, :], k).astype(np.int16)
        hi = _v3_values(words[..., nw:, :], k).astype(np.int16)
        v = torch.from_numpy(np.ascontiguousarray(swap((16 * (hi - 8) + lo).astype(np.int8))))
        bf = lambda a: torch.from_numpy(np.ascontiguousarray(swap(np.asarray(a, np.float32))))  # noqa: E731
        return q8v3_from_codes(v, bf(scales), None if mins is None else bf(mins), group)
    if sections != 1:
        raise NotImplementedError("sectioned (row-parallel TP) containers are not ported")
    tfb = tfb or MLP_TFB
    col_perm = None
    if kind == "q4":
        byte = np.asarray(qs).view(np.uint8)  # [..., K/2, N]
        lo = byte & 0x0F
        hi = ((byte >> 4) + 8) & 0x0F
        q = np.concatenate([lo, hi], axis=-2)
        mn = (np.zeros_like(sc) if mins is None else np.asarray(mins, np.float32)).copy()
        sc = sc.copy()
        half = sc.shape[-2] // 2
        sc[..., half:, :] *= 16.0
        mn[..., half:, :] += 8.0 * sc[..., half:, :]
    elif kind in ("q4v3", "q4v3m", "q4mlpg", "q4mlpd"):
        if kind in ("q4v3m", "q4mlpg"):
            kb = k // QBLOCK
            sc, mn = sc[..., :kb, :], sc[..., kb:, :]
        elif kind == "q4mlpd":
            # rows grouped per grid step: [scale rows of step j | min rows
            # of step j], each in mlp_col_perm order of the ffn (K) axis
            rps = 4 * tfb // QBLOCK
            *lead, rows, h = sc.shape
            grouped = sc.reshape(*lead, rows // (2 * rps), 2 * rps, h)
            inv = np.argsort(mlp_col_perm(k, tfb)[::QBLOCK] // QBLOCK)
            sc = grouped[..., :rps, :].reshape(*lead, rows // 2, h)[..., inv, :]
            mn = grouped[..., rps:, :].reshape(*lead, rows // 2, h)[..., inv, :]
        else:
            mn = np.asarray(mins, np.float32)
        q = _v3_values(np.asarray(qs), k)
        sc, mn = sc / 8.0, mn - 2.0 * sc  # s = sc3/8, m = mn3 - 16 s
        if kind == "q4mlpg":
            col_perm = np.argsort(mlp_gu_col_perm(n // 2, tfb))
    else:
        raise NotImplementedError(
            f"JAX container kind {kind!r} has no counterpart in the port "
            "(q8 / q4 / q4v3 / q4v3m / q4mlpg / q4mlpd)"
        )
    q, sc, mn = swap(q), swap(sc), swap(mn)
    if col_perm is not None:  # natural output row c is physical row col_perm[c]
        q, sc, mn = q[..., col_perm, :], sc[..., col_perm, :], mn[..., col_perm, :]
    return pack_q_values(q, sc, mn)
