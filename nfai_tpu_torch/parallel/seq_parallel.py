"""Sequence parallelism: attention over a KV cache split along its S axis.

Counterpart of nfai_tpu/parallel/seq_parallel.py. Each rank of an sp group
holds the slots [offset, offset + S/sp) of every layer's cache (offset =
sp_rank * S/sp) and runs flash attention over its slice, producing the
partials (unnormalised output, running max, denominator); the partials of
the group merge with the log-sum-exp combine (one max and two sums: the
JAX ``pmax`` and ``psum``s). The traffic a decode step is B·Hq·(D + 2)
floats a rank and layer, whatever the context length. The ring variant
(`sp_decode_attention_ring`) rotates the K/V blocks around the group
instead (the JAX ``ppermute``), the online-softmax state staying on each
rank. Every function takes the sp group's `parallel.comm.Comm` where the
JAX ones take a mesh axis. The engine reaches only `sp_attention` (prefill
and decode alike); the decode forms, the ring and the merged-lane adapter
have no engine caller and are kept as the JAX functions' counterparts.

The JAX functions take one query token (decode) and compute in jnp inside
``shard_map`` (no Pallas kernel), so these are PyTorch ops, with no kernel
of their own. `local_flash` also takes T > 1 queries at their absolute
positions (causal), so that a prefill chunk runs it, and the options for
which the JAX engine drops the stats merge and lets GSPMD partition its
masked einsum over the sharded S axis (nfai_tpu/models/llama.py:776-800):
gemma2's score softcap, a sliding window, and the int8 cache's per-(token,
kv head) scales. The function is the same: dense softmax attention over
the whole context, up to the order of the f32 sums.

GQA: query head h reads kv head h // (Hq / Hkv), as ops.fused_decode.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def local_flash(q, k, v, lengths, pos_offset: int, scale: float, positions=None,
                softcap: float = 0.0, window: int = 0, k_scales=None, v_scales=None):
    """Flash partials over one rank's S slice.

    q [B, Hq, D] (the current token, the JAX form: `lengths` [B] the valid
    context, so key s is visible iff s < lengths[b]) or [B, T, Hq, D] with
    `positions` [B, T] the queries' absolute positions (key s visible iff
    s <= position, and s > position - window where `window` > 0);
    k, v [B, Sl, Hkv, D], the slice of global slots pos_offset ..
    pos_offset + Sl - 1 (int8 codes where k_scales / v_scales [B, Hkv, Sl]
    f32 are given). Scores: q·k * scale (times the key's scale), capped by
    softcap * tanh(x / softcap) where `softcap` > 0.

    Returns f32 (acc [.., Hq, D] unnormalised, m [.., Hq], l [.., Hq]) in
    q's leading shape. A query with no visible key in the slice gets (0,
    NEG_INF, 0): the identity of the merge."""
    decode = q.dim() == 3
    if decode:
        q = q[:, None]
        positions = lengths.to(torch.int64)[:, None] - 1
    b, t, hq, d = q.shape
    sl, hkv = k.shape[1], k.shape[2]
    r = hq // hkv
    qf = q.float().reshape(b, t, hkv, r, d)
    scores = torch.einsum("bthrd,bshd->bhrts", qf, k.float()) * scale
    if k_scales is not None:
        scores = scores * k_scales.float()[:, :, None, None, :]
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    pos = positions.to(device=q.device, dtype=torch.int64)[:, :, None]  # [B, T, 1]
    span = pos_offset + torch.arange(sl, device=q.device)[None, None, :]
    valid = span <= pos
    if window:
        valid &= span > pos - window
    valid = valid[:, None, None]  # [B, 1, 1, T, Sl]
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(-1)  # [B, Hkv, r, T]
    p = torch.exp(scores - m.clamp_min(NEG_INF / 2)[..., None])
    p = p.masked_fill(~valid, 0.0)
    lsum = p.sum(-1)
    if v_scales is not None:
        p = p * v_scales.float()[:, :, None, None, :]
    acc = torch.einsum("bhrts,bshd->bthrd", p, v.float())  # [B, T, Hkv, r, D]
    m = m.permute(0, 3, 1, 2).reshape(b, t, hq)
    lsum = lsum.permute(0, 3, 1, 2).reshape(b, t, hq)
    acc = acc.reshape(b, t, hq, d)
    if decode:
        return acc[:, 0], m[:, 0], lsum[:, 0]
    return acc, m, lsum


def merge(acc, m, l, comm):
    """The log-sum-exp merge of the group's partials (the JAX
    `_merge_normalize`): one max and two sums over `comm`'s group; returns
    the normalised output, f32, in acc's shape."""
    m_g = comm.all_max(m)
    corr = torch.exp(m.clamp_min(NEG_INF / 2) - m_g.clamp_min(NEG_INF / 2))
    corr = torch.where(m <= NEG_INF / 2, 0.0, corr)
    l_g = comm.all_reduce_f32(l * corr)
    acc_g = comm.all_reduce_f32(acc * corr[..., None])
    return acc_g / l_g.clamp_min(1e-30)[..., None]


def sp_decode_attention(q, k, v, lengths, comm, scale: float | None = None):
    """Stats-merge decode attention: q [B, Hq, D] post-rope queries of the
    current token (the same on every rank), k, v [B, S/sp, Hkv, D] this
    rank's slice (slots sp_rank * S/sp ..), lengths [B] the valid context.
    Returns [B, Hq, D] f32: dense softmax attention over the whole cache,
    up to the order of the f32 sums."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    positions = lengths.to(torch.int64)[:, None] - 1
    return sp_attention(q[:, None], k.flatten(2), v.flatten(2), positions, comm.rank * k.shape[1], comm,
                        scale)[:, 0]


def sp_decode_attention_ring(q, k, v, lengths, comm, scale: float | None = None):
    """Ring decode attention (the JAX `sp_decode_attention_ring`): sp steps,
    each folding the block this rank holds into its online-softmax state,
    then passing the block to the next rank (sp - 1 hops); the queries never
    move. Same arguments and result as `sp_decode_attention`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n, idx, sl = comm.size, comm.rank, k.shape[1]
    b, hq, d = q.shape
    m = torch.full((b, hq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, d), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for step in range(n):
        owner = (idx - step) % n  # whose slice this rank holds now
        a_b, m_b, l_b = local_flash(q, kb, vb, lengths, owner * sl, scale)
        m_new = torch.maximum(m, m_b)
        m_safe = m_new.clamp_min(NEG_INF / 2)
        c_old = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m.clamp_min(NEG_INF / 2) - m_safe))
        c_new = torch.where(m_b <= NEG_INF / 2, 0.0, torch.exp(m_b.clamp_min(NEG_INF / 2) - m_safe))
        l = l * c_old + l_b * c_new
        acc = acc * c_old[..., None] + a_b * c_new[..., None]
        m = m_new
        if step != n - 1:
            kb, vb = comm.ring_exchange([kb, vb])
    return acc / l.clamp_min(1e-30)[..., None]


def sp_decode_attention_merged(q, cache_kv, lengths, n_kv_heads: int, comm,
                               scale: float | None = None, ring: bool = False):
    """The merged-lane adapter (the JAX `sp_decode_attention_merged`): this
    rank's slice of one layer's cache pair [B, S/sp, Hkv*D] (the engine's
    dense layout) reshaped to [B, S/sp, Hkv, D], with no copy, for the
    stats merge or (`ring`) the ring."""
    k, v = cache_kv
    b, s, kvd = k.shape
    d = kvd // n_kv_heads
    fn = sp_decode_attention_ring if ring else sp_decode_attention
    return fn(q, k.view(b, s, n_kv_heads, d), v.view(b, s, n_kv_heads, d), lengths, comm, scale=scale)


def sp_attention(q, k_cache, v_cache, positions, offset: int, comm, scale: float,
                 softcap: float = 0.0, window: int = 0, k_scales=None, v_scales=None):
    """Attention of new tokens q [B, T, Hq, D] at positions [B, T] against
    the whole context, from this rank's slice of one layer's just-updated
    cache (k_cache / v_cache [B, S/sp, Hkv*D] at global slot `offset`; int8
    codes with scales [B, Hkv, S/sp]): `local_flash` then `merge`, the one
    entry point of the stats merge (`sp_decode_attention` is its T = 1
    case). Returns [B, T, Hq, D] f32."""
    b, sl, kvd = k_cache.shape
    d = q.shape[-1]
    hkv = kvd // d
    acc, m, l = local_flash(q, k_cache.view(b, sl, hkv, d), v_cache.view(b, sl, hkv, d), None, offset,
                            scale, positions=positions, softcap=softcap, window=window,
                            k_scales=k_scales, v_scales=v_scales)
    return merge(acc, m, l, comm)
