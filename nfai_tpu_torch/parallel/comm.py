"""The collectives of tensor parallelism, counted by kind.

A `Comm` belongs to one engine (its params carry it as ``params["comm"]``):
the tp process group of its mesh and the counts of every collective it
made. Nothing here is global, so two engines in one process keep their own
groups and counts.

- `all_reduce_f32`: the row-parallel partial sums (after ``wo`` and after
  the MLP's down product), cast to f32, summed over the tp group and cast
  back to their dtype, as the JAX ``psum``s do (nfai_tpu/models/llama.py,
  the decode layer step; ops/qmatmul.py's row-parallel shard_map);
- `gather_vocab`: the vocab-split logits of the LM head joined along the
  last axis, so every rank holds the same f32 logits and samples the same
  token from one shared seed;
- `embed_reduce`: the vocab-parallel embedding of a tied table that is
  split under the head (each rank writes the rows of the ids in its range
  and zeros elsewhere; the sum is the row), as Megatron does and as GSPMD
  does for the JAX sharded table;
- `broadcast_object`: host objects from rank 0 to the whole world (the
  BatchEngine's arrivals and cancels, the CLI's input lines, a seed);
- `gather_heads`: a cache's kv-head slices joined, for a session file.

A decode step makes 2L all-reduces and one gather (and one embedding reduce
for a tied table split under the head).

gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` but, as
PyTorch documents, not in ``all_gather``. Under gloo a CUDA tensor's
gather is therefore staged through host memory: copied to the CPU,
gathered there and copied back (counted in `staged`). Under NCCL nothing
is staged. gloo's own CUDA `all_reduce` also copies through the host, so
under gloo on a card every collective waits for the device; the engine's
one host read a decode chunk holds under NCCL (and on the CPU).
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from .mesh import Mesh


class Comm:
    """One engine's tensor-parallel collectives (see module doc)."""

    def __init__(self, mesh: Mesh):
        if mesh.tp_group is None:
            raise ValueError("a Comm needs an initialised world (init_distributed)")
        self.mesh = mesh
        self.group = mesh.tp_group
        self.size = mesh.tp
        self.rank = mesh.tp_rank
        self.backend = str(dist.get_backend(self.group))
        self.counts: collections.Counter = collections.Counter()
        self.staged: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.counts.clear()
        self.staged.clear()

    def all_reduce_f32(self, partial: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's `partial` in f32, returned in its dtype."""
        acc = partial.to(torch.float32, copy=True)
        dist.all_reduce(acc, group=self.group)
        self.counts["all_reduce"] += 1
        return acc.to(partial.dtype)

    def embed_reduce(self, rows: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel embedding's sum: f32 rows, one of them nonzero
        for each id, summed over the tp group (exact)."""
        acc = rows.to(torch.float32, copy=True)
        dist.all_reduce(acc, group=self.group)
        self.counts["embed_reduce"] += 1
        return acc

    def gather_vocab(self, local: torch.Tensor) -> torch.Tensor:
        """[..., V/tp] on every rank → [..., V] in tp-rank order."""
        return self._gather(local, -1, "gather_vocab")

    def gather_heads(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """A cache tensor's kv-head slices (dim `dim`: the merged K/V lanes or
        the scales' head axis) joined in tp-rank order: the whole cache, for
        a session file."""
        return self._gather(local, dim, "gather_heads")

    def _gather(self, local: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        src = local.contiguous()
        if self.backend == "gloo" and src.is_cuda:
            parts = [torch.empty(src.shape, dtype=src.dtype) for _ in range(self.size)]
            dist.all_gather(parts, src.cpu(), group=self.group)
            self.staged[kind] += 1
            out = torch.cat(parts, dim=dim).to(src.device)
        else:
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.cat(parts, dim=dim)
        self.counts[kind] += 1
        return out

    def broadcast_object(self, obj=None):
        """Rank 0's `obj` on every rank of the world (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        self.counts["broadcast"] += 1
        return box[0]

    @property
    def is_root(self) -> bool:
        """Global rank 0: the rank that takes input from outside."""
        return self.mesh.rank == 0
