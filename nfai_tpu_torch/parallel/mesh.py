"""The mesh over the ranks of a `torch.distributed` world.

Counterpart of nfai_tpu/parallel/mesh.py. The axes and their rules are the
JAX `make_mesh`'s: ``dp`` (request parallelism: each dp group holds the
whole model and, in the dense BatchEngine, its share of the batch's lanes),
``tp`` (Megatron tensor parallelism inside a dp group) and, after them, any
other axis in the caller's order, among them ``sp`` (sequence parallelism:
the dense KV cache split over its S axis, `EngineConfig.seq_parallel`); a
size of -1 means "whatever is left" (at most one axis), dp defaults to 1
and tp to -1. Ranks are laid out as the JAX device array is reshaped: rank
r sits at the row-major index r of the axes in that order, so with sp the
only extra axis rank = (dp_rank * tp + tp_rank) * sp + sp_rank and an sp
group is sp consecutive ranks. An axis that no split names (sp without
`seq_parallel`, or any other name) replicates: the ranks along it compute
the same thing, as in JAX.

`make_mesh` returns a `Mesh`: the sizes by name, this rank's coordinates,
and the process groups of its group along every axis (`dist.new_group`,
every group made on every rank in the same order, as torch requires).
Nothing is global: an engine keeps its mesh. A world that is not
initialised counts as one rank and has no groups.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"


def mesh_dims(mesh_shape: dict[str, int] | None, n: int) -> dict[str, int]:
    """{"dp": d, "tp": t, <the other axes in the caller's order>} for a
    world of `n` ranks, by the JAX `make_mesh` rules and errors."""
    shape = dict(mesh_shape or {})
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
    return {DP_AXIS: shape.pop(DP_AXIS), TP_AXIS: shape.pop(TP_AXIS), **shape}


def coords(dims: dict[str, int], rank: int) -> dict[str, int]:
    """`rank`'s coordinate along every axis of `dims` (row-major in its
    order, the JAX device array's)."""
    out = {}
    for axis in reversed(dims):
        rank, out[axis] = divmod(rank, dims[axis])
    return {axis: out[axis] for axis in dims}


def rank_of(dims: dict[str, int], at: dict[str, int]) -> int:
    """The rank at coordinates `at` (`coords`' inverse)."""
    rank = 0
    for axis, size in dims.items():
        rank = rank * size + at[axis]
    return rank


def rank_coords(dims: dict[str, int], rank: int) -> tuple[int, int, int]:
    """(dp_rank, tp_rank, sp_rank) of `rank` (sp_rank 0 without an sp axis)."""
    c = coords(dims, rank)
    return c[DP_AXIS], c[TP_AXIS], c.get(SP_AXIS, 0)


def axis_ranks(dims: dict[str, int], axis: str, rank: int) -> list[int]:
    """The ranks of `rank`'s group along `axis` (its other coordinates
    fixed), in axis order; [rank] for an axis the mesh lacks."""
    if axis not in dims:
        return [rank]
    at = coords(dims, rank)
    return [rank_of(dims, {**at, axis: i}) for i in range(dims[axis])]


@dataclass
class Mesh:
    """One rank's view of the mesh: sizes by axis name, its rank, and its
    group along each axis (None where the world is not initialised)."""

    dims: dict[str, int]
    rank: int = 0
    groups: dict[str, object] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.dims.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        return coords(self.dims, self.rank).get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along `axis`."""
        return axis_ranks(self.dims, axis, self.rank)

    @property
    def dp(self) -> int:
        return self.size(DP_AXIS)

    @property
    def tp(self) -> int:
        return self.size(TP_AXIS)

    @property
    def sp(self) -> int:
        return self.size(SP_AXIS)

    @property
    def dp_rank(self) -> int:
        return self.axis_rank(DP_AXIS)

    @property
    def tp_rank(self) -> int:
        return self.axis_rank(TP_AXIS)

    @property
    def sp_rank(self) -> int:
        return self.axis_rank(SP_AXIS)

    @property
    def dp_group(self):
        return self.group(DP_AXIS)

    @property
    def tp_group(self):
        return self.group(TP_AXIS)

    @property
    def sp_group(self):
        return self.group(SP_AXIS)


def make_mesh(mesh_shape: dict[str, int] | None = None) -> Mesh:
    """This rank's `Mesh` over the initialised world (or a world of one)."""
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    dims = mesh_dims(mesh_shape, n)
    if not on:
        return Mesh(dims)
    rank = dist.get_rank()
    groups = {}
    for axis in dims:  # every rank makes every group, in one order
        for r in range(n):
            members = axis_ranks(dims, axis, r)
            if members[0] != r:  # each group once, made from its first member
                continue
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return Mesh(dims, rank, groups)
