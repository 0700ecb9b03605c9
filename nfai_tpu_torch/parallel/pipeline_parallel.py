"""The pipeline stage split of the layer-stacked parameters.

Counterpart of nfai_tpu/parallel/pipeline_parallel.py. A stage is an
L-slice of every stacked layer leaf (qs[L, ...] → qs[lo:hi, ...], scales
and mins alike, a LayerList's items, a dense [L, ...] stack): again a
stacked container of the same kind, with no repacking. The stage's cache is
the same L-slice of the [L, B, S, KVD] cache (and the int8 scales). Each
stage runs the unchanged `models.llama.forward` over its sub-stack, entered
through the `h0` seam (no embedding) after the first stage and left through
final_norm=False before the last; `pp_forward` chains the stages in one
process, moving the hidden state [B, T, H] between their devices: the
pipeline boundary. It is the stage function a microbatched schedule would
rotate, not a schedule; no engine option and no CLI flag reach it, as in
the JAX package.

Stage 0 holds the embedding (for a tied checkpoint the table under the
head, which is also its embedding); the final norm and the LM head go to
the last stage only. The JAX `split_stages` gives them to every stage
(:84-85), a copy of the head per stage that no stage but the last reads.
A stage boundary inside a sliding-window pattern period (gemma2, gemma3:
`layer_windows` and `layer_is_local` count from the stage's first layer)
is refused, as the JAX `stage_config` refuses it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.qtensor import LayerList

# the params entries every stage keeps (the rope tables and the route flags)
_SHARED = ("inv_freq", "inv_freq_local", "act_dtype", "fused_mlp")


def _slice_layers(w, lo: int, hi: int):
    if isinstance(w, LayerList):
        return LayerList(w.items[lo:hi])
    if isinstance(w, torch.Tensor):
        return w[lo:hi]
    return w._map(lambda t: t[lo:hi])


def split_stages(params: dict, n_stages: int, cfg) -> list[tuple[dict, object]]:
    """Layer-stacked params → `n_stages` contiguous stages [(stage_params,
    stage_cfg), ...]: every layer leaf L-sliced (views, no copy); stage 0
    keeps the embedding, the last stage the final norm and the LM head."""
    n = cfg.n_layers
    if n % n_stages:
        raise ValueError(f"n_layers={n} not divisible by {n_stages} stages")
    per = n // n_stages
    tied = params["embed"] is None or params["embed"] is params["lm_head"]
    stages = []
    for i in range(n_stages):
        lo, hi = i * per, (i + 1) * per
        first, last = i == 0, i == n_stages - 1
        st = {k: params[k] for k in _SHARED if k in params}
        st["layers"] = {k: _slice_layers(w, lo, hi) for k, w in params["layers"].items()}
        st["embed"] = params["embed"] if first else None
        # a tied table is the head and the embedding: stage 0 holds it for its rows
        st["lm_head"] = params["lm_head"] if last or (first and tied) else None
        st["final_norm"] = params["final_norm"] if last else None
        stages.append((st, stage_config(cfg, per, first_layer=lo)))
    return stages


def stage_config(cfg, n_layers: int, first_layer: int = 0):
    """A stage's config: its layer count. A boundary inside a sliding-window
    pattern period raises (the stage's `layer_windows` would count from the
    wrong phase), as the JAX function raises."""
    if getattr(cfg, "swa_pattern", 0) and first_layer % (cfg.swa_pattern or 1):
        raise NotImplementedError(
            "stage boundary inside an SWA pattern period: offset layer_windows by first_layer "
            "before splitting")
    return dataclasses.replace(cfg, n_layers=n_layers)


def split_cache(cache, n_stages: int) -> list:
    """The L-slices of a `KVCache` (and its int8 scales), one a stage
    (views: a stage's writes land in `cache`)."""
    per = cache.k.shape[0] // n_stages
    cut = lambda t, lo: None if t is None else t[lo:lo + per]  # noqa: E731
    return [dataclasses.replace(cache, k=cut(cache.k, i * per), v=cut(cache.v, i * per),
                                ks=cut(cache.ks, i * per), vs=cut(cache.vs, i * per))
            for i in range(n_stages)]


def _to(tree, device):
    """A stage's params on `device` (tensors and containers; the rest as is)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if hasattr(tree, "to") else tree


@torch.inference_mode()
def pp_forward(stages, tokens: torch.Tensor, positions: torch.Tensor, caches: list, devices=None):
    """The stages in sequence (the JAX `pp_forward`): stage i + 1 takes stage
    i's hidden state through `h0`; only the last applies the final norm.
    With `devices` (one a stage) each stage's params, cache, tokens and
    positions move to its device first, and the hidden state crosses
    between them. Returns (hidden [B, T, H] after the final norm, the
    stages' caches)."""
    from ..models.llama import forward

    h, out = None, []
    last = len(stages) - 1
    for i, (st, cfg_i) in enumerate(stages):
        cache = caches[i]
        tok, pos = tokens, positions
        if devices is not None:
            dev = torch.device(devices[i])
            st, cache = _to(st, dev), _to_cache(cache, dev)
            tok, pos = tokens.to(dev), positions.to(dev)
            h = None if h is None else h.to(dev)
        h, cache = forward(st, cfg_i, tok, pos, cache, h0=h, final_norm=i == last)
        out.append(cache)
    return h, out


def _to_cache(cache, device):
    move = lambda t: None if t is None else t.to(device)  # noqa: E731
    return dataclasses.replace(cache, k=move(cache.k), v=move(cache.v), ks=move(cache.ks), vs=move(cache.vs))
