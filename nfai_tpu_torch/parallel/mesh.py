"""The (dp, tp, sp) mesh over the ranks of a `torch.distributed` world.

Counterpart of nfai_tpu/parallel/mesh.py. The axes and their rules are the
JAX `make_mesh`'s: ``dp`` (request parallelism: each dp group holds the
whole model), ``tp`` (Megatron tensor parallelism inside a dp group) and,
after them, ``sp`` (sequence parallelism: the dense KV cache split over its
S axis, `EngineConfig.seq_parallel`); a size of -1 means "whatever is left"
(at most one axis), dp defaults to 1 and tp to -1. Ranks are laid out as
the JAX device array is reshaped, dp and tp first, then the extra axis:
rank = (dp_rank * tp + tp_rank) * sp + sp_rank, so an sp group is sp
consecutive ranks. A mesh with an sp axis whose engine does not ask for
sequence parallelism replicates over it, as in JAX.

`make_mesh` returns a `Mesh`: the sizes, this rank's coordinates, and the
process groups of its tp, dp and sp groups (`dist.new_group`, every group
made on every rank in the same order, as torch requires). Nothing is
global: an engine keeps its mesh. A world that is not initialised counts as
one rank and has no groups. Other axes ("ep", "pp", ...) raise
NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"
AXES = (DP_AXIS, TP_AXIS, SP_AXIS)
UNPORTED = ("the draft model and NFAI_Q8V3 under a mesh, and mesh axes other than dp, tp and sp, "
            "are not ported yet (ROADMAP queue 1, item 2(c))")


def mesh_dims(mesh_shape: dict[str, int] | None, n: int) -> dict[str, int]:
    """{"dp": d, "tp": t[, "sp": s]} for a world of `n` ranks, by the JAX
    `make_mesh` rules and errors: dp and tp first, then "sp" where the caller
    gave it."""
    shape = dict(mesh_shape or {})
    if extra := sorted(set(shape) - set(AXES)):
        raise NotImplementedError(f"mesh axes {extra}: {UNPORTED}")
    shape.setdefault(DP_AXIS, 1)
    shape.setdefault(TP_AXIS, -1)
    negatives = [k for k, v in shape.items() if v == -1]
    if len(negatives) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if negatives:
        known = 1
        for v in shape.values():
            known *= v if v != -1 else 1
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {shape}")
        shape[negatives[0]] = n // known
    total = 1
    for v in shape.values():
        total *= v
    if total != n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {n}")
    return {k: shape[k] for k in AXES if k in shape}


def axis_ranks(dims: dict[str, int], axis: str, rank: int) -> list[int]:
    """The ranks of `rank`'s group along `axis` (its other coordinates
    fixed), in axis order: the layout rank = (dp_rank * tp + tp_rank) * sp
    + sp_rank."""
    sizes = [dims.get(a, 1) for a in AXES]
    coords = list(rank_coords(dims, rank))
    out = []
    for i in range(sizes[AXES.index(axis)]):
        coords[AXES.index(axis)] = i
        out.append((coords[0] * sizes[1] + coords[1]) * sizes[2] + coords[2])
    return out


def rank_coords(dims: dict[str, int], rank: int) -> tuple[int, int, int]:
    """(dp_rank, tp_rank, sp_rank) of `rank`."""
    tp, sp = dims.get(TP_AXIS, 1), dims.get(SP_AXIS, 1)
    return rank // (tp * sp), (rank // sp) % tp, rank % sp


@dataclass
class Mesh:
    """One rank's view of the mesh: sizes, coordinates and its groups (None
    where the world is not initialised)."""

    dp: int
    tp: int
    rank: int
    tp_group: object | None
    dp_group: object | None
    sp: int = 1
    sp_group: object | None = None

    @property
    def dims(self) -> dict[str, int]:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp, SP_AXIS: self.sp}

    @property
    def tp_rank(self) -> int:
        return rank_coords(self.dims, self.rank)[1]

    @property
    def sp_rank(self) -> int:
        return rank_coords(self.dims, self.rank)[2]

    def group(self, axis: str):
        return {TP_AXIS: self.tp_group, DP_AXIS: self.dp_group, SP_AXIS: self.sp_group}[axis]

    def size(self, axis: str) -> int:
        return self.dims[axis]

    def axis_rank(self, axis: str) -> int:
        return rank_coords(self.dims, self.rank)[AXES.index(axis)]

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along `axis`."""
        return axis_ranks(self.dims, axis, self.rank)


def make_mesh(mesh_shape: dict[str, int] | None = None) -> Mesh:
    """This rank's `Mesh` over the initialised world (or a world of one)."""
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    dims = mesh_dims(mesh_shape, n)
    dp, tp, sp = dims[DP_AXIS], dims[TP_AXIS], dims.get(SP_AXIS, 1)
    full = {DP_AXIS: dp, TP_AXIS: tp, SP_AXIS: sp}
    if not on:
        return Mesh(dp, tp, 0, None, None, sp, None)
    rank = dist.get_rank()
    groups = {}
    for axis in AXES:  # every rank makes every group, in one order
        for r in range(n):
            members = axis_ranks(full, axis, r)
            if members[0] != r:  # each group once, made from its first member
                continue
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return Mesh(dp, tp, rank, groups[TP_AXIS], groups[DP_AXIS], sp, groups[SP_AXIS])

