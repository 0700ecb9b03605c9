"""K6 (8-bit dequant-matmul), the port's 8-bit container, the GGUF kinds
it carries, tied-table gathers and mixed-kind stacks, against the JAX
package.

The port's plain version of K6 runs here (CPU tensors); the JAX side runs
its Pallas kernels `_q8_matmul` and `_q8_matmul_layered` in interpret mode,
as its own tests do. Weights are GGUF blocks quantized by the JAX package
from one seeded numpy draw; both packages decode the same bytes.

Tolerances: exact equality where both sides decode GGUF bytes in f32;
max|got - want| / max|want| < 2e-2 for the matmuls (the JAX kernels round
each scale*q product and the activations to bf16).
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
from nfai_tpu.ops.qmatmul import _q8_matmul, _q8_matmul_layered
from nfai_tpu_torch.gguf import GGMLType, dequantize, quantize
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.ops.qmatmul import linear, linear_layered, q8_check, q8_matmul

TOL = 2e-2
NEW_KINDS = [GGMLType.Q8_0, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K]
# (kind, scale group, mins): g32 and g16, with and without mins
MATMUL_KINDS = [(GGMLType.Q8_0, 32, False), (GGMLType.Q6_K, 16, False),
                (GGMLType.Q5_K, 32, True), (GGMLType.Q2_K, 16, True)]


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _raw(rng, n, k, kind):
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    return jax_quantize(w, JGGMLType[kind.name])


@pytest.mark.parametrize("kind", NEW_KINDS, ids=lambda k: k.name)
def test_pack_dequant_equals_gguf_decoder(kind):
    """The 8-bit container dequantizes to exactly ggml's values, held
    against the JAX package's numpy decoder; the port's codec copy agrees."""
    rng = np.random.default_rng(1)
    n, k = 96, 512
    raw = _raw(rng, n, k, kind)
    want = jax_dequantize(raw, n * k, JGGMLType[kind.name]).reshape(n, k)
    qt = tqt.pack_gguf_tensor(raw, kind, (n, k))
    assert isinstance(qt, tqt.Q8Tensor) and qt.qs.dtype == torch.int8
    assert qt.group == (32 if kind in (GGMLType.Q8_0, GGMLType.Q5_K) else 16)
    assert (qt.mins is not None) == (kind in (GGMLType.Q5_K, GGMLType.Q2_K))
    np.testing.assert_array_equal(tqt.dequant(qt).numpy(), want)
    np.testing.assert_array_equal(dequantize(raw, n * k, kind).reshape(n, k), want)


@pytest.mark.parametrize("kind", [GGMLType.Q8_0, GGMLType.Q6_K], ids=lambda k: k.name)
def test_quantizer_copies_write_the_jax_bytes(kind):
    x = (np.random.default_rng(2).standard_normal((64, 512)) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(quantize(x, kind), jax_quantize(x, JGGMLType[kind.name]))


@pytest.mark.parametrize("kind,group,has_mins", MATMUL_KINDS,
                         ids=lambda v: getattr(v, "name", str(v)))
@pytest.mark.parametrize("m", [1, 8])
def test_q8_matmul_plain_vs_jax_q8_matmul(kind, group, has_mins, m):
    rng = np.random.default_rng(10 + m)
    n, k = 256, 1024
    raw = _raw(rng, n, k, kind)
    jt = jqt.pack_gguf_tensor(raw, JGGMLType[kind.name], (n, k), device_put=False)
    assert (jt.kind, jt.group, jt.mins is not None) == ("q8", group, has_mins)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = _q8_matmul(jnp.asarray(x, jnp.bfloat16), jt.qs, jt.scales, jt.mins, group=group)
    w = tqt.pack_gguf_tensor(raw, kind, (n, k))
    got = q8_matmul(torch.from_numpy(x).to(torch.bfloat16), w)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert rel(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("kind,group,has_mins", MATMUL_KINDS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_linear_layered_plain_vs_jax_q8_matmul_layered(kind, group, has_mins):
    rng = np.random.default_rng(20)
    n_layers, n, k, m = 2, 256, 1024, 8
    raws = [_raw(rng, n, k, kind) for _ in range(n_layers)]
    parts = [jqt.pack_gguf_tensor(r, JGGMLType[kind.name], (n, k), device_put=False) for r in raws]
    stack = lambda a: None if a[0] is None else np.stack(a)
    qs, sc, mn = (stack([getattr(p, f) for p in parts]) for f in ("qs", "scales", "mins"))
    w = tqt.stack([tqt.pack_gguf_tensor(r, kind, (n, k)) for r in raws])
    assert isinstance(w, tqt.Q8Tensor) and w.qs.shape == (n_layers, n, k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    for layer in range(n_layers):
        want = _q8_matmul_layered(jnp.asarray(x, jnp.bfloat16), jnp.int32(layer), qs, sc, mn,
                                  group=group)
        got = linear_layered(torch.from_numpy(x), w, layer)
        assert rel(got.float().numpy(), want) < TOL


# Gemma's widths, the card's K6 rows at K % 2048 != 0, at a narrow N: hidden
# 2304 (Gemma-2-2B: the Q6_K head, attn_v; Q5_K with mins) and 1152
# (Gemma-3-1B, where the k-quants' 256-blocks do not fit: Q8_0)
GEMMA_CASES = [(2304, GGMLType.Q6_K), (2304, GGMLType.Q5_K), (1152, GGMLType.Q8_0)]


@pytest.mark.parametrize("k,kind", GEMMA_CASES, ids=lambda v: getattr(v, "name", str(v)))
@pytest.mark.parametrize("m", [1, 8, 24])
def test_q8_matmul_plain_vs_jax_at_gemma_widths(k, kind, m):
    rng = np.random.default_rng(30 + m)
    n = 128
    raw = _raw(rng, n, k, kind)
    jt = jqt.pack_gguf_tensor(raw, JGGMLType[kind.name], (n, k), device_put=False)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = _q8_matmul(jnp.asarray(x, jnp.bfloat16), jt.qs, jt.scales, jt.mins, group=jt.group)
    got = q8_matmul(torch.from_numpy(x).to(torch.bfloat16), tqt.pack_gguf_tensor(raw, kind, (n, k)))
    assert got.shape == (m, n)
    assert rel(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("k,kind", GEMMA_CASES, ids=lambda v: getattr(v, "name", str(v)))
def test_linear_layered_plain_vs_jax_at_gemma_widths(k, kind):
    rng = np.random.default_rng(40)
    n_layers, n, m = 2, 128, 8
    raws = [_raw(rng, n, k, kind) for _ in range(n_layers)]
    parts = [jqt.pack_gguf_tensor(r, JGGMLType[kind.name], (n, k), device_put=False) for r in raws]
    stack = lambda a: None if a[0] is None else np.stack(a)
    qs, sc, mn = (stack([getattr(p, f) for p in parts]) for f in ("qs", "scales", "mins"))
    w = tqt.stack([tqt.pack_gguf_tensor(r, kind, (n, k)) for r in raws])
    x = rng.standard_normal((m, k)).astype(np.float32)
    for layer in range(n_layers):
        want = _q8_matmul_layered(jnp.asarray(x, jnp.bfloat16), jnp.int32(layer), qs, sc, mn,
                                  group=parts[0].group)
        assert rel(linear_layered(torch.from_numpy(x), w, layer).float().numpy(), want) < TOL


@pytest.mark.parametrize("kind", [GGMLType.Q8_0, GGMLType.Q2_K], ids=lambda k: k.name)
def test_from_jax_q8_round_trip(kind):
    """JAX dequant_qtensor of an N-padded 8-bit container (as a head is) ==
    the port's dequant of the converted container, exactly (f32 scales)."""
    rng = np.random.default_rng(5)
    n, k = 320, 512
    jt = jqt.pad_qtensor_n(jqt.pack_gguf_tensor(_raw(rng, n, k, kind), JGGMLType[kind.name],
                                                (n, k), device_put=False))
    assert jt.qs.shape[-1] == 512  # padded
    got = tqt.from_jax_qtensor("q8", np.asarray(jt.qs), np.asarray(jt.scales),
                               None if jt.mins is None else np.asarray(jt.mins), k, n,
                               group=jt.group)
    assert isinstance(got, tqt.Q8Tensor) and got.qs.shape == (n, k)
    want = np.asarray(jqt.dequant_qtensor(jt, jnp.float32))
    np.testing.assert_array_equal(tqt.dequant(got).numpy().T, want)


@pytest.mark.parametrize("kind", [GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda k: k.name)
def test_dequant_gather_vs_jax(kind):
    """Embedding rows gathered from a tied table in head layout."""
    rng = np.random.default_rng(6)
    vocab, hidden = 384, 256
    raw = _raw(rng, vocab, hidden, kind)
    jt = jqt.pack_gguf_tensor(raw, JGGMLType[kind.name], (vocab, hidden), device_put=False)
    ids = rng.integers(0, vocab, (2, 5))
    want = np.asarray(jqt.dequant_gather(jt, jnp.asarray(ids), jnp.float32))
    table = tqt.pack_gguf_tensor(raw, kind, (vocab, hidden))
    got = tqt.dequant_gather(table, torch.from_numpy(ids))
    assert got.shape == (2, 5, hidden)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0**-20 * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy()[1, 3], tqt.dequant(table).numpy()[ids[1, 3]])


def test_mixed_stack_keeps_each_layer_in_its_kind():
    """A Q4_K_M-style stack (Q4_K and Q6_K layers) is a LayerList: each layer
    keeps its own container, and a layer of it multiplies as that container."""
    rng = np.random.default_rng(7)
    n, k = 128, 512
    q4 = tqt.pack_gguf_tensor(_raw(rng, n, k, GGMLType.Q4_K), GGMLType.Q4_K, (n, k))
    q6 = tqt.pack_gguf_tensor(_raw(rng, n, k, GGMLType.Q6_K), GGMLType.Q6_K, (n, k))
    st = tqt.stack([q4, q6, q4])
    assert isinstance(st, tqt.LayerList) and tqt.n_layers(st) == 3
    assert (st.k, st.n) == (k, n)
    x = torch.from_numpy(rng.standard_normal((3, k)).astype(np.float32))
    for i, w in enumerate((q4, q6, q4)):
        assert torch.equal(linear_layered(x, st, i), linear(x, w))
    assert not tqt.same_layout([q4, q6])
    with pytest.raises(ValueError):
        tqt.concat([q4, q6])
    fused = tqt.concat([q6, q6])  # same kind: fuses along N
    assert isinstance(fused, tqt.Q8Tensor) and fused.n == 2 * n


def _q8_check_case(case):
    """(x, w) for a q8_check case: a 16-byte aligned bf16 x [40, 256] and a
    [100, 256] g16 Q8Tensor with mins (N a multiple of neither 64 nor 128),
    then one thing K6 does or does not take."""
    n, k = 100, 256
    w = tqt.Q8Tensor(torch.zeros(n, k, dtype=torch.int8), torch.zeros(n, k // 16),
                     torch.zeros(n, k // 16), k, n, 16)
    x = torch.zeros(40, k, dtype=torch.bfloat16)
    if case == "misaligned x":
        x = torch.zeros(40 * k + 1, dtype=torch.bfloat16)[1:].view(40, k)
    elif case == "misaligned codes":
        w = dataclasses.replace(w, qs=torch.zeros(n * k + 1, dtype=torch.int8)[1:].view(n, k))
    elif case == "misaligned scales":  # read one by one: taken
        w = dataclasses.replace(w, scales=torch.zeros(n * k // 16 + 1)[1:].view(n, k // 16))
    elif case == "f32 x":
        x = x.float()
    elif case == "K % 32":
        w = tqt.Q8Tensor(torch.zeros(n, 48, dtype=torch.int8), torch.zeros(n, 3), None, 48, n, 16)
        x = torch.zeros(40, 48, dtype=torch.bfloat16)
    elif case == "group 64":
        w = dataclasses.replace(w, scales=torch.zeros(n, k // 64), mins=None, group=64)
    elif case == "bf16 scales":
        w = dataclasses.replace(w, scales=w.scales.to(torch.bfloat16))
    elif case == "a layer stack":
        w = tqt.stack([w, w])
    return x, w


@pytest.mark.parametrize("case,error", [
    ("ok", None), ("misaligned x", ValueError), ("misaligned codes", ValueError),
    ("misaligned scales", None), ("f32 x", TypeError), ("K % 32", ValueError),
    ("group 64", ValueError), ("bf16 scales", TypeError), ("a layer stack", ValueError),
])
def test_q8_check_takes_what_k6_takes(case, error):
    """The rules K6's wrapper holds a CUDA launch to, checked on CPU
    tensors: any M and N, K % 32 == 0, groups of 16 or 32, bf16 x, f32
    scales and mins, 2-D, contiguous, x and codes 16-byte aligned;
    everything else raises."""
    x, w = _q8_check_case(case)
    if error is None:
        assert q8_check(x, w) == (40, 256)
    else:
        with pytest.raises(error):
            q8_check(x, w)
