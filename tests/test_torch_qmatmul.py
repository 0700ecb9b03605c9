"""K1 (4-bit dequant-matmul) and the port's 4-bit container against the JAX
package.

The port's plain version of K1 runs here (CPU tensors); the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do. Inputs
are made with numpy from a seed and handed to both.

Tolerances: max|got - want| / max|want| < 2e-2 where the JAX kernels compute
in bf16 (the rule of benchmarks/tpu_kernel_parity.py); exact equality where
both sides decode the same GGUF bytes in f32. The matmul cases use random raw
Q4_K blocks (random 6-bit scales/mins, d/dmin as in a checkpoint): the JAX v3
container stores 8s and m+16s in bf16, and on zero-mean requantized weights
that storage alone already sits near the 2e-2 line against exact f32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.gguf.quants import dequantize as jax_dequantize
from nfai_tpu.gguf.quants import quantize as jax_quantize
from nfai_tpu.ops import qtensor as jqt
from nfai_tpu.ops.qmatmul import (
    _q4v3_matmul, _q4v3_matmul_layered, mins_correction,
)
from nfai_tpu_torch.gguf import GGMLType, dequantize
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.ops.qmatmul import linear, linear_layered, q4_check, q4_matmul
from nfai_tpu_torch.testing import random_q4k_bytes

TOL = 2e-2


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _gguf_bytes(rng, n, k, kind):
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    return jax_quantize(w, JGGMLType[kind.name])


@pytest.mark.parametrize("kind", [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K])
def test_pack_dequant_equals_gguf_decoder(kind):
    """The port's container dequantizes to exactly ggml's values (f32
    scales): held against the JAX package's numpy decoder."""
    rng = np.random.default_rng(1)
    n, k = 96, 512
    raw = _gguf_bytes(rng, n, k, kind)
    want = jax_dequantize(raw, n * k, JGGMLType[kind.name]).reshape(n, k)
    qt = tqt.pack_gguf_tensor(raw, kind, (n, k))
    np.testing.assert_array_equal(tqt.dequant(qt).numpy(), want)
    # and the port's own codec copy agrees with the JAX package's
    np.testing.assert_array_equal(dequantize(raw, n * k, kind).reshape(n, k), want)


def _jax_v2(raw, n, k):
    return jqt.pack_gguf_tensor(raw, JGGMLType.Q4_K, (n, k), device_put=False)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_q4_matmul_plain_vs_jax_q4v3(m):
    rng = np.random.default_rng(m)
    n, k = 256, 2048  # v3 needs K % 2048 == 0
    raw = random_q4k_bytes(rng, n, k)
    x = (rng.standard_normal((m, k))).astype(np.float32)
    v3 = jqt.to_v3(_jax_v2(raw, n, k))
    assert v3.kind == "q4v3"
    want = np.asarray(
        _q4v3_matmul(jnp.asarray(x, jnp.bfloat16), v3.qs, v3.scales).astype(jnp.float32)
        - mins_correction(jnp.asarray(x, jnp.bfloat16), v3.mins)
    )
    w = tqt.pack_gguf_tensor(raw, GGMLType.Q4_K, (n, k))
    got = q4_matmul(torch.from_numpy(x).to(torch.bfloat16), w)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert rel(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_linear_layered_plain_vs_jax_q4v3_layered(m, merged):
    rng = np.random.default_rng(10 + m)
    n_layers, n, k = 2, 256, 2048
    raws = [random_q4k_bytes(rng, n, k) for _ in range(n_layers)]
    parts = [_jax_v2(r, n, k) for r in raws]
    stacked = jqt.QTensor(
        np.stack([p.qs for p in parts]), np.stack([p.scales for p in parts]),
        np.stack([p.mins for p in parts]), "q4", k, n,
    )
    v3 = jqt.to_v3_stacked(stacked, merge_bytes=0 if merged else 1 << 40)
    assert v3.kind == ("q4v3m" if merged else "q4v3")
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = tqt.stack([tqt.pack_gguf_tensor(r, GGMLType.Q4_K, (n, k)) for r in raws])
    for layer in range(n_layers):
        mins = v3.scales if merged else v3.mins
        want = np.asarray(_q4v3_matmul_layered(
            jnp.asarray(x, jnp.bfloat16), jnp.int32(layer), v3.qs, v3.scales,
            mins, merged=merged,
        ).astype(jnp.float32))
        got = linear_layered(torch.from_numpy(x), w, layer)
        assert rel(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("kind", ["q4", "q4v3", "q4v3m"])
def test_from_jax_qtensor_round_trip(kind):
    """JAX dequant_qtensor of a TPU container == the port's dequant of the
    converted container (f32 rounding of the undone folds only)."""
    rng = np.random.default_rng(5)
    n, k = 128, 2048
    raw = _gguf_bytes(rng, n, k, GGMLType.Q4_K)
    v2 = _jax_v2(raw, n, k)
    if kind == "q4":
        jt = jqt.pad_qtensor_n(v2)  # N-padded, as the LM head is
    else:
        st = v2.replace(qs=v2.qs[None], scales=v2.scales[None], mins=v2.mins[None])
        jt = jqt.to_v3_stacked(st, merge_bytes=0 if kind == "q4v3m" else 1 << 40)
        assert jt.kind == kind
    leaves = dict(qs=np.asarray(jt.qs), scales=np.asarray(jt.scales),
                  mins=None if jt.mins is None else np.asarray(jt.mins))
    got = tqt.from_jax_qtensor(kind, leaves["qs"], leaves["scales"], leaves["mins"], k, n)
    if kind == "q4":
        want = np.asarray(jqt.dequant_qtensor(jt, jnp.float32))  # [K, N]
        got_w = tqt.dequant(got).numpy()
    else:
        want = np.asarray(jqt.dequant_qtensor(jt.replace(
            qs=jt.qs[0], scales=jt.scales[0],
            mins=None if jt.mins is None else jt.mins[0]), jnp.float32))
        got_w = tqt.dequant(got.layer(0)).numpy()
    np.testing.assert_allclose(got_w.T, want, rtol=0, atol=2.0**-20 * np.abs(want).max())


def test_linear_shapes_and_dense_raises():
    rng = np.random.default_rng(0)
    raw = _gguf_bytes(rng, 64, 256, GGMLType.Q4_0)
    w = tqt.pack_gguf_tensor(raw, GGMLType.Q4_0, (64, 256))
    x = torch.from_numpy(rng.standard_normal((2, 3, 256)).astype(np.float32))
    y = linear(x, w)
    assert y.shape == (2, 3, 64) and y.dtype == torch.bfloat16
    want = x.reshape(6, 256) @ tqt.dequant(w).T
    assert rel(y.reshape(6, 64).float().numpy(), want.numpy()) < 1e-2
    # a dense [N, K] weight (the LM head) multiplies with torch.matmul; one
    # whose K does not match x's raises
    dense = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    assert torch.equal(linear(x, dense), torch.matmul(x, dense.T))
    with pytest.raises(RuntimeError):
        linear(x, torch.zeros(256, 64))
    with pytest.raises(NotImplementedError):  # a kind the port does not carry quantized
        tqt.pack_gguf_tensor(raw, GGMLType.Q5_0, (64, 256))


def _q4_check_case(case):
    """(x, w) for a q4_check case: a 16-byte aligned bf16 x [40, 256] and a
    [100, 256] Q4Tensor (N a multiple of neither 64 nor 128), then one
    thing K1 does not take."""
    rng = np.random.default_rng(1)
    n, k = 100, 256
    w = tqt.pack_q_values(rng.integers(0, 16, (n, k)), rng.random((n, k // 32)).astype(np.float32),
                          rng.random((n, k // 32)).astype(np.float32))
    x = torch.zeros(40, k, dtype=torch.bfloat16)
    if case == "misaligned x":
        x = torch.zeros(40 * k + 1, dtype=torch.bfloat16)[1:].view(40, k)
    elif case == "f32 x":
        x = x.float()
    elif case == "K % 32":
        w = tqt.Q4Tensor(torch.zeros(n, 24, dtype=torch.uint8), torch.zeros(n, 1), torch.zeros(n, 1), 48, n)
        x = torch.zeros(40, 48, dtype=torch.bfloat16)
    elif case == "wrong K":
        x = torch.zeros(40, 2 * k, dtype=torch.bfloat16)
    elif case == "strided scales":
        w = dataclasses.replace(w, scales=torch.zeros(k // 32, n).T)
    elif case == "bf16 mins":
        w = dataclasses.replace(w, mins=w.mins.to(torch.bfloat16))
    elif case == "a layer stack":
        w = tqt.stack([w, w])
    return x, w


@pytest.mark.parametrize("case,error", [
    ("ok", None), ("misaligned x", ValueError), ("f32 x", TypeError), ("K % 32", ValueError),
    ("wrong K", ValueError), ("strided scales", ValueError), ("bf16 mins", TypeError),
    ("a layer stack", ValueError),
])
def test_q4_check_takes_what_k1_takes(case, error):
    """The rules K1's wrapper holds a CUDA launch to, checked on CPU
    tensors: any M and N, K % 32 == 0, bf16 x, f32 scales and mins, 2-D,
    contiguous and 16-byte aligned; everything else raises."""
    x, w = _q4_check_case(case)
    if error is None:
        assert q4_check(x, w) == (40, 256)
    else:
        with pytest.raises(error):
            q4_check(x, w)
