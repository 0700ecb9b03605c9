"""The (dp, tp) mesh over the ranks of a `torch.distributed` world.

Counterpart of nfai_tpu/parallel/mesh.py. The axes and their rules are the
JAX `make_mesh`'s: ``dp`` (request parallelism: each dp group holds the
whole model) and ``tp`` (Megatron tensor parallelism inside a dp group); a
size of -1 means "whatever is left" (at most one axis), dp defaults to 1
and tp to -1. Ranks are laid out as the JAX device array is: rank =
dp_rank * tp + tp_rank, so a tp group is tp consecutive ranks.

`make_mesh` returns a `Mesh`: the sizes, this rank's coordinates, and the
process groups of its tp and dp groups (`dist.new_group`, made on every
rank in the same order, as torch requires). Nothing is global: an engine
keeps its mesh. A world that is not initialised counts as one rank and has
no groups. Other axes ("sp", ...) raise NotImplementedError: sequence and
expert parallelism are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
UNPORTED = ("sequence and expert parallelism, the pipeline split and the other mesh axes are not "
            "ported yet (ROADMAP queue 1, item 2(b))")


def mesh_dims(mesh_shape: dict[str, int] | None, n: int) -> dict[str, int]:
    """{"dp": d, "tp": t} for a world of `n` ranks, by the JAX `make_mesh`
    rules and errors."""
    shape = dict(mesh_shape or {})
    if extra := sorted(set(shape) - {DP_AXIS, TP_AXIS}):
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
    total = shape[DP_AXIS] * shape[TP_AXIS]
    if total != n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {n}")
    return {DP_AXIS: shape[DP_AXIS], TP_AXIS: shape[TP_AXIS]}


@dataclass
class Mesh:
    """One rank's view of the mesh: sizes, coordinates and its groups (None
    where the world is not initialised)."""

    dp: int
    tp: int
    rank: int
    tp_group: object | None
    dp_group: object | None

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def make_mesh(mesh_shape: dict[str, int] | None = None) -> Mesh:
    """This rank's `Mesh` over the initialised world (or a world of one)."""
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    dims = mesh_dims(mesh_shape, n)
    dp, tp = dims[DP_AXIS], dims[TP_AXIS]
    if not on:
        return Mesh(dp, tp, 0, None, None)
    rank = dist.get_rank()
    tp_group = dp_group = None
    for d in range(dp):  # every rank makes every group, in one order
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank // tp == d:
            tp_group = g
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            dp_group = g
    return Mesh(dp, tp, rank, tp_group, dp_group)
