"""Token sampling on the device: temperature → top-k → top-p → min-p →
categorical draw, or greedy argmax.

The JAX package takes an approximate top-k (TPU `approx_max_k`); here it is
the exact `torch.topk`. Per-row temperature, top-p, min-p and top-k let one
batch mix requests. The draw uses an explicit `torch.Generator` on the
logits' device, so the random bits differ from `jax.random` — compare the two
packages through greedy decoding and the filtered distribution only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _per_row(v, rows: int, device) -> torch.Tensor:
    """scalar or [B] → [B, 1] f32."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return torch.broadcast_to(v, (rows,))[:, None]


def filtered_for_sampling(logits: torch.Tensor, temperature, top_k: int, top_p,
                          min_p=0.0, top_k_rows=None):
    """The sampling pipeline up to the draw (temperature → top-k window →
    per-row top-k → top-p → min-p). `top_k_rows` [B] drops the ranks at or
    beyond each row's own k (at least 1) inside the static `top_k` window,
    so one batch can mix requests with different top_k. Returns (filtered
    [B, K] tempered logits with dropped entries at NEG_INF, top_idx [B, K]
    their vocab ids, greedy [B] bool rows)."""
    rows, vocab = logits.shape
    temperature = _per_row(temperature, rows, logits.device)
    top_p = _per_row(top_p, rows, logits.device)
    greedy = temperature[:, 0] <= 0.0
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)
    if 0 < top_k < vocab:
        top_vals, top_idx = torch.topk(scaled, top_k, dim=-1, sorted=True)
    else:
        top_vals, top_idx = torch.sort(scaled, dim=-1, descending=True)
    if top_k_rows is not None:
        ranks = torch.arange(top_vals.shape[-1], device=logits.device)[None, :]
        kk = torch.clamp(torch.as_tensor(top_k_rows, device=logits.device), min=1)[:, None]
        top_vals = torch.where(ranks < kk, top_vals, torch.full_like(top_vals, NEG_INF))
    probs = torch.softmax(top_vals, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    keep = (cumulative - probs) < top_p
    keep &= probs >= _per_row(min_p, rows, logits.device) * probs[:, :1]
    filtered = torch.where(keep, top_vals, torch.full_like(top_vals, NEG_INF))
    return filtered, top_idx, greedy


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature=0.5, top_k: int = 40, top_p=0.95,
                  min_p=0.0, top_k_rows=None) -> torch.Tensor:
    """Next token ids [B] (int64). temperature, top_p and min_p are scalars
    or per-row [B]; `top_k_rows` [B] is a per-row top-k inside the static
    `top_k` window. temperature <= 0 is greedy argmax."""
    logits = logits.float()
    static_temp = isinstance(temperature, (int, float))
    if static_temp and temperature <= 0.0:
        return greedy_sample(logits)
    filtered, top_idx, greedy = filtered_for_sampling(
        logits, temperature, top_k, top_p, min_p, top_k_rows
    )
    probs = torch.softmax(filtered, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    sampled = torch.gather(top_idx, 1, choice)[:, 0]
    if static_temp:
        return sampled
    return torch.where(greedy, greedy_sample(logits), sampled)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.float(), dim=-1)
