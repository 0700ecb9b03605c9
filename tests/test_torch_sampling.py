"""Per-row sampling settings in the port against the JAX package: the
filtered distribution of `filtered_for_sampling` (temperature → top-k
window → per-row top-k → top-p → min-p) for a batch that mixes requests,
and `sample_logits` draws that stay inside each row's own top-k.

Inputs are f32 logits from a numpy seed without ties (a permutation of
evenly spaced values), so the top-k order is the same in both packages.
The kept logits must agree within 1e-5 relative (the same division by
the temperature), the dropped set exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.ops.sampling import filtered_for_sampling as jax_filtered
from nfai_tpu_torch.ops.sampling import NEG_INF, filtered_for_sampling, sample_logits

V = 300


def _logits(seed, rows):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(np.linspace(-6.0, 6.0, V)) for _ in range(rows)]).astype(np.float32)


CASES = {
    # name: (temperature, top_k window, top_k_rows, top_p, min_p)
    "mixed rows": ([0.5, 1.0, 0.8, 1.2], 40, [1, 5, 40, 64], [0.9, 1.0, 0.95, 0.5], [0.0, 0.05, 0.0, 0.1]),
    "k below 1 keeps rank 0": ([1.0, 1.0], 16, [0, -3], [1.0, 1.0], [0.0, 0.0]),
    "no window": ([0.7, 2.0, 1.0], 0, [3, 300, 50], [1.0, 0.8, 0.99], [0.0, 0.0, 0.02]),
    "greedy rows": ([0.0, 0.9], 32, [8, 8], [0.95, 0.95], [0.0, 0.0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_filtered_for_sampling_top_k_rows_vs_jax(case):
    temp, top_k, k_rows, top_p, min_p = CASES[case]
    logits = _logits(len(case), len(temp))
    jf, jidx, jg = jax_filtered(jnp.asarray(logits), jnp.asarray(temp, jnp.float32), top_k,
                                jnp.asarray(top_p, jnp.float32), jnp.asarray(k_rows, jnp.int32),
                                jnp.asarray(min_p, jnp.float32))
    tf, tidx, tg = filtered_for_sampling(torch.from_numpy(logits), torch.tensor(temp), top_k,
                                         torch.tensor(top_p), torch.tensor(min_p),
                                         top_k_rows=torch.tensor(k_rows))
    jf, jidx, tf = np.asarray(jf), np.asarray(jidx), tf.numpy()
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    kept = jf > NEG_INF / 2
    np.testing.assert_array_equal(tf > NEG_INF / 2, kept)
    np.testing.assert_allclose(tf[kept], jf[kept], rtol=1e-5)
    for row, k in enumerate(k_rows):  # ranks at or beyond the row's own k are dropped
        assert not kept[row, max(k, 1):].any() and kept[row, 0]


def test_sample_logits_draws_inside_each_rows_top_k():
    logits = torch.from_numpy(_logits(7, 3))
    k_rows = torch.tensor([1, 3, 10])
    gen = torch.Generator().manual_seed(0)
    allowed = [set(torch.topk(logits[i], int(k)).indices.tolist()) for i, k in enumerate(k_rows)]
    seen = [set() for _ in range(3)]
    for _ in range(200):
        tok = sample_logits(logits, gen, torch.tensor([1.0, 1.0, 5.0]), 16, 1.0,
                            top_k_rows=k_rows)
        for i, t in enumerate(tok.tolist()):
            seen[i].add(t)
    assert all(s <= a for s, a in zip(seen, allowed))
    assert seen[0] == allowed[0] and len(seen[2]) > 3  # rank 0 only; a hot row spreads


def test_greedy_rows_in_a_sampled_batch_take_the_argmax():
    logits = torch.from_numpy(_logits(8, 4))
    gen = torch.Generator().manual_seed(1)
    tok = sample_logits(logits, gen, torch.tensor([0.0, 2.0, 0.0, 2.0]), 40, 0.95,
                        top_k_rows=torch.tensor([40, 40, 2, 40]))
    assert tok[0] == logits[0].argmax() and tok[2] == logits[2].argmax()
