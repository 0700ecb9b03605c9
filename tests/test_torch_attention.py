"""K2 (decode attention), K3 (K/V row write) and K4 (flash prefill
attention): the port's plain versions against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs, in f32.

Tolerance: 1e-4 relative to max|want| — both sides compute in f32 and differ
only in summation order (the 2e-2 bf16 rule is not needed here).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.ops.fused_decode import (
    layered_decode_attention as jax_layered_decode_attention,
    layered_decode_attention_slab as jax_layered_decode_attention_slab,
    write_all_layers as jax_write_all_layers,
)
from nfai_tpu.ops.prefill_attention import (
    flash_prefill_attention as jax_flash_prefill_attention,
)
from nfai_tpu_torch.ops.fused_decode import (
    decode_attention, layered_decode_attention, write_all_layers,
)
from nfai_tpu_torch.ops.prefill_attention import flash_prefill_attention

TOL = 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("impl", ["slab", "grid"])
def test_decode_attention_plain_vs_jax(impl):
    rng = np.random.default_rng(3)
    l, b, s, hkv, r, d = 2, 3, 256, 2, 4, 64
    hq, kvd = hkv * r, hkv * d
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, kvd)).astype(np.float32)
    vn = rng.standard_normal((b, kvd)).astype(np.float32)
    kc = rng.standard_normal((l, b, s, kvd)).astype(np.float32)
    vc = rng.standard_normal((l, b, s, kvd)).astype(np.float32)
    starts = np.array([0, 130, s - 1], np.int32)
    jfn = jax_layered_decode_attention_slab if impl == "slab" else jax_layered_decode_attention
    t = [torch.from_numpy(a) for a in (q, kn, vn, kc, vc)]
    for layer in range(l):
        want = np.asarray(jfn(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
            jnp.asarray(vc), jnp.int32(layer), jnp.asarray(starts),
            s_block=128, interpret=True,
        ))
        got = layered_decode_attention(*t, layer, torch.from_numpy(starts))
        assert got.shape == (b, hq, d)
        assert rel(got.numpy(), want) < TOL


def test_decode_attention_scale_and_unported_options():
    rng = np.random.default_rng(4)
    b, s, d = 2, 128, 64
    q = torch.from_numpy(rng.standard_normal((b, 4, d)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((b, 2 * d)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((b, s, 2 * d)).astype(np.float32))
    starts = torch.tensor([5, 100])
    a = decode_attention(q, kn, kn, kc, kc, starts, scale=0.5)
    want = np.asarray(jax_layered_decode_attention_slab(
        jnp.asarray(q.numpy()), jnp.asarray(kn.numpy()), jnp.asarray(kn.numpy()),
        jnp.asarray(kc.numpy())[None], jnp.asarray(kc.numpy())[None], jnp.int32(0),
        jnp.asarray(starts.numpy(), jnp.int32), s_block=128, interpret=True,
        scale=0.5,
    ))
    assert rel(a.numpy(), want) < TOL
    # softcap and window are ported (tests/test_torch_gemma.py holds them
    # against JAX at every width); values no kernel takes raise
    with pytest.raises(ValueError):
        decode_attention(q, kn, kn, kc, kc, starts, softcap=-30.0)
    with pytest.raises(ValueError):
        decode_attention(q, kn, kn, kc, kc, starts, window=-16)


def test_write_all_layers_plain_vs_jax():
    rng = np.random.default_rng(6)
    l, b, s, kvd = 3, 4, 64, 128
    cache = rng.standard_normal((l, b, s, kvd)).astype(np.float32)
    rows = rng.standard_normal((l, b, kvd)).astype(np.float32)
    starts = np.array([0, 17, s - 1, s], np.int32)  # the last one is dropped
    want = np.asarray(jax_write_all_layers(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(starts), interpret=True,
    ))
    got_t = torch.from_numpy(cache.copy())
    out = write_all_layers(got_t, torch.from_numpy(rows), torch.from_numpy(starts))
    assert out is got_t  # in place
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(got_t.numpy()[:, 3], cache[:, 3])


@pytest.mark.parametrize("t,offset", [(64, 0), (64, 100), (128, 0), (128, 64)])
def test_flash_prefill_plain_vs_jax(t, offset):
    rng = np.random.default_rng(t + offset)
    b, s, hkv, r, d = 2, 256, 2, 4, 64
    hq, kvd = hkv * r, hkv * d
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvd)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvd)).astype(np.float32)
    offsets = np.array([offset, max(0, offset - 7)], np.int32)
    want = np.asarray(jax_flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(offsets),
        t_block=64, s_block=128, interpret=True, kv_layout="full",
    ))
    got = flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(offsets),
    )
    assert got.shape == (b, t, hq, d)
    assert rel(got.numpy(), want) < TOL
