"""Token sampling on the device: temperature → top-k → top-p → min-p →
categorical draw, or greedy argmax; the OpenAI options applied before it
(`apply_logit_bias`, `apply_penalties`) and read after it
(`token_logprobs`); and speculative decoding's acceptance rule
(`spec_verify_sample`) — plain PyTorch, as they are plain `jnp` in the JAX
package.

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


def draw(probs: torch.Tensor, generator: torch.Generator | None, lanes=None) -> torch.Tensor:
    """One categorical draw a row of probs [B, K] ([B, 1] indices). With
    `lanes` = (lo, total) the rows are lanes lo .. lo + B - 1 of a batch of
    `total` (a dp rank's share of the dense BatchEngine's lanes): the draw
    is the whole batch's, the other lanes' rows uniform, so the rank takes
    the numbers one device drawing every lane takes for these rows
    (`torch.multinomial` of one sample divides each row by its own
    exponential draws)."""
    if lanes is None or lanes[1] == probs.shape[0]:
        return torch.multinomial(probs, 1, generator=generator)
    lo, total = lanes
    full = torch.ones((total, probs.shape[1]), dtype=probs.dtype, device=probs.device)
    full[lo:lo + probs.shape[0]] = probs
    return torch.multinomial(full, 1, generator=generator)[lo:lo + probs.shape[0]]


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  temperature=0.5, top_k: int = 40, top_p=0.95,
                  min_p=0.0, top_k_rows=None, lanes=None) -> torch.Tensor:
    """Next token ids [B] (int64). temperature, top_p and min_p are scalars
    or per-row [B]; `top_k_rows` [B] is a per-row top-k inside the static
    `top_k` window. temperature <= 0 is greedy argmax. `lanes` (lo, total):
    the rows are lanes of a larger batch whose draws they take (`draw`)."""
    logits = logits.float()
    static_temp = isinstance(temperature, (int, float))
    if static_temp and temperature <= 0.0:
        return greedy_sample(logits)
    filtered, top_idx, greedy = filtered_for_sampling(
        logits, temperature, top_k, top_p, min_p, top_k_rows
    )
    choice = draw(torch.softmax(filtered, dim=-1), generator, lanes)
    sampled = torch.gather(top_idx, 1, choice)[:, 0]
    if static_temp:
        return sampled
    return torch.where(greedy, greedy_sample(logits), sampled)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.float(), dim=-1)


def spec_verify_sample(logits3: torch.Tensor, draft: torch.Tensor, generator: torch.Generator | None,
                       temperature, top_k: int, top_p, top_k_rows=None, min_p=0.0, lanes=None):
    """Rejection-sampling acceptance for a point-mass drafter (prompt-lookup
    n-grams, greedy draft-model rollouts; the JAX `spec_verify_sample`).
    logits3 [B, T, V] are the target's logits at [tok, d_1 .. d_gamma]
    (T = gamma + 1), draft [B, gamma] the drafted ids. Draft d_j is
    accepted with probability p_j(d_j), its probability under the row's
    sampling pipeline (`filtered_for_sampling`); on rejection the
    continuation is drawn from p_j with d_j removed and renormalised, which
    for a point-mass proposal is the residual distribution. Token by token
    the output law is that of plain sampling; greedy rows (temperature <= 0)
    reduce to the argmax-prefix rule, bit for bit. temperature, top_p and
    min_p are scalars or [B]; the draws (gamma uniforms, then T categorical
    draws a row) come from `generator`; with `lanes` (lo, total) they are
    those of lanes lo .. lo + B - 1 of a batch of `total` (`draw`).

    Returns (n_acc [B] in 0..gamma, new_tok [B]): the accepted drafts and
    the continuation, a residual draw at the rejected column or a fresh
    draw after full acceptance."""
    b, t, v = logits3.shape
    gamma = t - 1
    dev = logits3.device
    lf = logits3.float().reshape(b * t, v)

    def bt(a):  # scalar or [B] -> [B*T] (one entry a verify column)
        a = torch.broadcast_to(torch.as_tensor(a, dtype=torch.float32, device=dev), (b,))
        return a[:, None].expand(b, t).reshape(-1)

    tkr = None
    if top_k_rows is not None:
        tkr = torch.as_tensor(top_k_rows, device=dev)[:, None].expand(b, t).reshape(-1)
    filtered, top_idx, _ = filtered_for_sampling(lf, bt(temperature), top_k, bt(top_p), bt(min_p), tkr)
    k = filtered.shape[-1]
    probs3 = torch.softmax(filtered, dim=-1).reshape(b, t, k)
    idx3 = top_idx.reshape(b, t, k)
    f3 = filtered.reshape(b, t, k)
    greedy = (torch.broadcast_to(torch.as_tensor(temperature, dtype=torch.float32, device=dev), (b,))
              <= 0.0)[:, None]
    argmax3 = torch.argmax(lf, dim=-1).reshape(b, t)
    draft = draft.to(device=dev, dtype=torch.int64)
    # p(d_j) under the filtered distribution (0 where it was filtered out)
    p_d = torch.where(idx3[:, :gamma] == draft[:, :, None], probs3[:, :gamma], 0.0).sum(-1)
    lo, total = lanes or (0, b)
    u = torch.rand((total, gamma), generator=generator, device=dev)[lo:lo + b]
    acc = torch.where(greedy, draft == argmax3[:, :gamma], u < p_d)
    n_acc = torch.cumprod(acc.to(torch.int64), dim=1).sum(1)
    # each column's continuation: columns < gamma leave their draft out (the
    # residual); column gamma is a plain draw from the pipeline
    excl = torch.cat([draft, torch.full((b, 1), -1, dtype=torch.int64, device=dev)], dim=1)
    f3 = torch.where(idx3 == excl[:, :, None], torch.full_like(f3, NEG_INF), f3)
    choice = draw(torch.softmax(f3, dim=-1).reshape(b * t, k), generator, (lo * t, total * t))
    cont = torch.gather(idx3.reshape(b * t, k), 1, choice).reshape(b, t)
    cont = torch.where(greedy, argmax3, cont)
    return n_acc, torch.gather(cont, 1, n_acc[:, None])[:, 0]


def apply_logit_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
                     bias_vals: torch.Tensor) -> torch.Tensor:
    """Per-request additive logit biases (OpenAI `logit_bias`): a fixed-width
    (id, bias) table per row, bias_ids [B, W] int and bias_vals [B, W];
    padding entries add 0.0 to token 0 (a no-op). A repeated id adds each
    of its biases, as the JAX scatter-add does. Returns a new tensor."""
    ids = bias_ids.to(device=logits.device, dtype=torch.int64)
    return logits.scatter_add(1, ids, bias_vals.to(device=logits.device, dtype=logits.dtype))


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, presence, frequency) -> torch.Tensor:
    """OpenAI presence/frequency penalties over the OUTPUT tokens generated
    so far (vLLM semantics: prompt tokens are not penalized): logits -
    frequency * count - presence * (count > 0), with counts [B, V] int32
    and presence/frequency scalars or [B]."""
    rows = logits.shape[0]
    pres = _per_row(presence, rows, logits.device)
    freq = _per_row(frequency, rows, logits.device)
    cf = counts.float()
    return logits - freq * cf - pres * (cf > 0).float()


def token_logprobs(logits: torch.Tensor, chosen: torch.Tensor, n_top: int = 0):
    """OpenAI `logprobs`: the log-probability of the chosen token plus the
    `n_top` most likely alternatives, from the UN-tempered distribution of
    `logits` [B, V] (after bias and penalties: logprobs describe the model,
    not the sampler).

    Returns (chosen_lp [B] f32, top_ids [B, max(n_top, 1)] int64, top_lps
    [B, max(n_top, 1)] f32); with n_top == 0 the top arrays are width-1
    placeholders, as in the JAX package. The top list is exact
    (`torch.topk` over the log-softmax; the JAX package's TPU route takes
    an approximate top-k) and sorted by logprob, descending; equal logprobs
    come in torch.topk's order, which `logprob_entry` turns into ascending
    token id (the JAX order) when the host reads them."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = lsm.gather(1, chosen.to(device=lsm.device, dtype=torch.int64)[:, None])[:, 0]
    top_lps, top_ids = torch.topk(lsm, max(n_top, 1), dim=-1)
    return chosen_lp, top_ids, top_lps


def logprob_entry(lp, tid, tlp, row: int, want_k: int, token: int) -> dict:
    """One per-token logprob record ({"id", "logprob", "top": [(id, lp),
    ...]}) from `token_logprobs`' arrays read back as host lists, at `row`
    (a batch row or a decode step): the top list ordered by logprob,
    descending, equal ones by ascending id, and cut to `want_k`."""
    top = sorted(zip(map(int, tid[row]), map(float, tlp[row])), key=lambda p: (-p[1], p[0]))
    return {"id": int(token), "logprob": float(lp[row]), "top": top[:want_k] if want_k > 0 else []}
