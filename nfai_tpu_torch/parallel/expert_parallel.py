"""Expert parallelism: a MoE model's expert stacks split over their E axis.

Counterpart of nfai_tpu/parallel/expert_parallel.py. A stacked [E, ...]
expert container cut along E gives every rank of the tp group a contiguous
[E/tp, ...] slice that is itself a standalone stacked container (a
`Q4Tensor`, `Q8Tensor` or dense stack of the same kind, k, n and group: the
JAX `expert_shardings`), so a rank runs the unchanged grouped kernels (K8 for
4-bit stacks, K9 for 8-bit ones) on its local experts, and the only
collective is one f32 all-reduce of the mixed outputs over the tp group.

The router stays replicated (it is tiny): every rank routes every token,
masks the routing weights to its own experts and remaps the expert ids to
local ids, clipped into range (the JAX lines :92-94); the (token, slot)
rows of other ranks' experts keep their places in the layout but add 0
through their masked weights. `load_params(..., expert_parallel=True)` loads
the rank's experts only (`parallel.sharding.expert_range`); `expert_split`
cuts a loaded stack the same way. The engine reaches it with
``EngineConfig(expert_parallel=True)`` and a tp mesh; attention keeps its
Megatron split.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.qtensor import LayerList, Q4Tensor, Q8Tensor
from .sharding import expert_range


def expert_split(w, tp: int, rank: int):
    """Rank `rank`'s experts of a layer-stacked expert weight: [L, E, N, ...]
    containers and dense [L, E, N, K] stacks → [L, E/tp, N, ...], a
    LayerList's [E, N, ...] items → [E/tp, N, ...]; each a standalone,
    contiguous container of the same kind."""
    if isinstance(w, LayerList):
        return LayerList([_cut(it, tp, rank, 0) for it in w.items])
    return _cut(w, tp, rank, 1)


def _cut(w, tp: int, rank: int, axis: int):
    e0, e1 = expert_range((w.shape if isinstance(w, torch.Tensor) else w.qs.shape)[axis], tp, rank)
    cut = lambda t: t.narrow(axis, e0, e1 - e0).contiguous()  # noqa: E731
    if isinstance(w, torch.Tensor):
        return cut(w)
    if not isinstance(w, (Q4Tensor, Q8Tensor)):
        raise NotImplementedError(f"no expert split for a {type(w).__name__}")
    return dataclasses.replace(w, qs=cut(w.qs), scales=cut(w.scales),
                               mins=None if w.mins is None else cut(w.mins))


def moe_ffn_ep(xf: torch.Tensor, router: torch.Tensor, wg, wu, wd, cfg, rank: int, size: int) -> torch.Tensor:
    """The MoE FFN of tokens xf [N, H] on rank `rank` of `size`, whose expert
    stacks wg / wu / wd ([E/size, N, ...] containers or dense stacks) hold
    experts rank * E/size .. (rank + 1) * E/size - 1: replicated routing
    (`models.llama.moe_route`), the weights masked to the local experts and
    the ids remapped and clipped, then the one-device routes on the local
    stacks: `moe_grouped` (the group-aligned layout over the local experts,
    gate / up / down through K8 / K9) on quantized stacks, `_moe_ffn_dense`
    on dense ones (the JAX dense oracle's function: only the hit experts
    run, which gives the same f32 sums up to their order).
    Returns the rank's f32 partial [N, H]: the JAX `moe_ffn_ep` is the sum
    of the ranks' partials in xf's dtype (the forward sums it over the tp
    group, `models.llama._finish_layer`)."""
    from ..models.llama import _moe_ffn_dense, moe_grouped, moe_route

    e, used = cfg.n_experts, cfg.n_experts_used
    el = e // size
    if el * size != e:
        raise ValueError(f"n_experts={e} must be divisible by tp={size} for expert_parallel")
    top_vals, top_idx = moe_route(xf, router, used, cfg.norm_topk_prob)
    local = (top_idx // el) == rank
    vals = torch.where(local, top_vals, 0.0)
    lid = (top_idx - rank * el).clamp(0, el - 1)
    if isinstance(wg, torch.Tensor):
        return _moe_ffn_dense(xf, vals, lid, wg, wu, wd, el, cfg.activation)
    return moe_grouped(xf, vals, lid, wg, wu, wd, el)

