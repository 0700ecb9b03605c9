"""The collectives of tensor and sequence parallelism, counted by kind.

A `Comm` belongs to one engine and one mesh axis (the engine's params carry
its tp one as ``params["comm"]`` and, under `EngineConfig.seq_parallel`,
its sp one as ``params["sp"]``): the process group of that axis and the
counts of every collective it made. Nothing here is global, so two engines
in one process keep their own groups and counts.

- `all_reduce_f32`: the row-parallel partial sums (after ``wo`` and after
  the FFN: the MLP's down product, or the MoE FFN's f32 weighted sum, split
  over experts or over their ffn columns), cast to f32, summed over the
  group and cast back to their dtype, as the JAX ``psum``s do
  (nfai_tpu/models/llama.py, the decode layer step; ops/qmatmul.py's
  row-parallel shard_map; parallel/expert_parallel.py); over the sp group,
  the two sums of the flash partials' merge;
- `gather_vocab`: the vocab-split logits of the LM head joined along the
  last axis, so every rank holds the same f32 logits and samples the same
  token from one shared seed;
- `embed_reduce`: the vocab-parallel embedding of a tied table that is
  split under the head (each rank writes the rows of the ids in its range
  and zeros elsewhere; the sum is the row), as Megatron does and as GSPMD
  does for the JAX sharded table;
- `all_max`: the max of the sp group's merge of the flash partials
  (parallel.seq_parallel.merge: the JAX ``pmax``), in f32;
- `ring_exchange`: one hop of the ring (the JAX ``ppermute``): every rank
  sends its tensors to the next rank of the group and receives the
  previous rank's (`dist.batch_isend_irecv`);
- `broadcast_object`: host objects from rank 0 to the whole world (the
  BatchEngine's arrivals and cancels, the CLI's input lines, a seed);
- `gather`: a cache's slices joined along one axis, for a session file
  (the kv-heads over tp, the S slices over sp), and over dp the rows of
  the dense BatchEngine's lanes that each dp group sampled (one a step);
- `broadcast_from`: one rank's tensor on every rank of the group (over
  dp, a prefill's first token from the dp group that owns its lane).

A decode step under tp makes 2L all-reduces and one gather (and one
embedding reduce for a tied table split under the head); under
sequence parallelism the sp group adds one max and two sums a layer.

gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` but, as
PyTorch documents, not in ``all_gather``, ``send`` or ``recv``. Under gloo a
CUDA tensor's gather and ring hop are therefore staged through host memory:
copied to the CPU, exchanged there and copied back (counted in `staged`).
Under NCCL nothing is staged. gloo's own CUDA `all_reduce` also copies
through the host, so under gloo on a card every collective waits for the
device; the engine's one host read a decode chunk holds under NCCL (and on
the CPU).
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from .mesh import TP_AXIS, Mesh


class Comm:
    """One engine's collectives over one axis of its mesh (see module doc)."""

    def __init__(self, mesh: Mesh, axis: str = TP_AXIS):
        if mesh.group(axis) is None:
            raise ValueError("a Comm needs an initialised world (init_distributed)")
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.group(axis)
        self.size = mesh.size(axis)
        self.rank = mesh.axis_rank(axis)
        self.ranks = mesh.ranks(axis)  # the group's global ranks, in axis order
        self.backend = str(dist.get_backend(self.group))
        self.counts: collections.Counter = collections.Counter()
        self.staged: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.counts.clear()
        self.staged.clear()

    def _host(self, t: torch.Tensor) -> bool:
        """Whether gloo needs `t` staged through the host (a CUDA tensor)."""
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_f32(self, partial: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's `partial` in f32, returned in its dtype."""
        acc = partial.to(torch.float32, copy=True)
        dist.all_reduce(acc, group=self.group)
        self.counts["all_reduce"] += 1
        return acc.to(partial.dtype)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max of every rank's f32 `x` (the JAX ``pmax``)."""
        acc = x.to(torch.float32, copy=True)
        dist.all_reduce(acc, op=dist.ReduceOp.MAX, group=self.group)
        self.counts["all_max"] += 1
        return acc

    def embed_reduce(self, rows: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel embedding's sum: f32 rows, one of them nonzero
        for each id, summed over the tp group (exact)."""
        acc = rows.to(torch.float32, copy=True)
        dist.all_reduce(acc, group=self.group)
        self.counts["embed_reduce"] += 1
        return acc

    def gather_vocab(self, local: torch.Tensor) -> torch.Tensor:
        """[..., V/tp] on every rank → [..., V] in tp-rank order."""
        return self.gather(local, -1, "gather_vocab")

    def gather_heads(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """A cache tensor's kv-head slices (dim `dim`: the merged K/V lanes or
        the scales' head axis) joined in tp-rank order: the whole cache, for
        a session file."""
        return self.gather(local, dim, "gather_heads")

    def gather(self, local: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        """Every rank's `local` joined along `dim` in the group's rank order
        (counted as `kind`)."""
        src = local.contiguous()
        if self._host(src):
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

    def broadcast_from(self, t: torch.Tensor, src: int, kind: str) -> torch.Tensor:
        """The group's rank `src`'s `t` on every rank of the group, in
        place (counted as `kind`)."""
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        self.counts[kind] += 1
        return t

    def ring_exchange(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """One hop of the ring: `tensors` go to the next rank of the group
        ((rank + 1) % size) and the previous rank's come back, in one
        `batch_isend_irecv`."""
        nxt = self.ranks[(self.rank + 1) % self.size]
        prev = self.ranks[(self.rank - 1) % self.size]
        host = self._host(tensors[0])
        sends = [t.contiguous().cpu() if host else t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, prev, self.group) for t in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.counts["ring"] += 1
        if host:
            self.staged["ring"] += 1
            recvs = [t.to(src.device) for t, src in zip(recvs, tensors)]
        return recvs

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
