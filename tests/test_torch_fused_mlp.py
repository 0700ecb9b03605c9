"""K5 (the one-kernel quantized MLP) against the JAX package's fused MLP.

The JAX side builds its fused-MLP containers (q4mlpg/q4mlpd) from random raw
Q4_K blocks and runs `fused_mlp_layered`, `fused_mlp` (Pallas, interpret
mode on the CPU, as its own tests run it) and `mlp_prefill`; the port runs
its plain versions on the same weights, carried across by
`from_jax_qtensor`, and the same numpy inputs. Shapes as
tests/test_fused_mlp.py: L=2, K=1024, F=1024, H=256.

Tolerance: max|got - want| / max|want| < 2e-2. The JAX containers keep
their v3 scales (8s, m+16s) in bf16 and its kernels round each scale*q
product to bf16; the port's plain version is f32 throughout (measured
≈1.0-1.6% apart). The port's mlp_prefill rounds gate_up, the activation
and the dequantized down weight to bf16 as the JAX function does; it is
held to its plain f32 counterpart within 1e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.gguf import GGMLType as JGGMLType
from nfai_tpu.ops import qtensor as jqt
from nfai_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from nfai_tpu.ops.fused_mlp import fused_mlp_layered as jax_fused_mlp_layered
from nfai_tpu.ops.fused_mlp import mlp_prefill as jax_mlp_prefill
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.ops import fused_mlp as tfm
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.testing import random_q4k_bytes

TOL = 2e-2
L, K, F, H = 2, 1024, 1024, 256


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_stack(parts):
    return jqt.QTensor(np.stack([p.qs for p in parts]), np.stack([p.scales for p in parts]),
                       np.stack([p.mins for p in parts]), "q4", parts[0].k, parts[0].n)


def _to_port(qt):
    return tqt.from_jax_qtensor(qt.kind, np.asarray(qt.qs), np.asarray(qt.scales),
                                None if qt.mins is None else np.asarray(qt.mins),
                                qt.k, qt.n, tfb=qt.tfb)


def _slice(qt, i):
    return qt.replace(qs=qt.qs[i], scales=qt.scales[i],
                      mins=None if qt.mins is None else qt.mins[i])


@pytest.fixture(scope="module")
def pair():
    """(JAX q4mlpg, JAX q4mlpd, port gate_up, port down, raw blocks)."""
    rng = np.random.default_rng(0)
    raws = {name: [random_q4k_bytes(rng, n, k) for _ in range(L)]
            for name, (n, k) in (("gate", (F, K)), ("up", (F, K)), ("down", (H, F)))}
    pack = lambda raw, n, k: jqt.pack_gguf_tensor(raw, JGGMLType.Q4_K, (n, k), device_put=False)
    gu = _jax_stack([jqt.concat_qtensors([pack(raws["gate"][i], F, K), pack(raws["up"][i], F, K)])
                     for i in range(L)])
    dn = _jax_stack([pack(raws["down"][i], H, F) for i in range(L)])
    gum, dnm = jqt.to_v3_mlp_stacked(gu, dn)
    assert (gum.kind, dnm.kind) == ("q4mlpg", "q4mlpd")
    return gum, dnm, _to_port(gum), _to_port(dnm), raws


@pytest.mark.parametrize("which", ["q4mlpg", "q4mlpd"])
def test_from_jax_fused_containers_round_trip(pair, which):
    """JAX dequant_qtensor of a layer of each fused-MLP container (natural
    order) == the port's dequant of the converted container; and the port's
    converted weights are the GGUF weights up to the JAX bf16 scale storage."""
    gum, dnm, tgu, tdn, raws = pair
    jt, pt = (gum, tgu) if which == "q4mlpg" else (dnm, tdn)
    assert isinstance(pt, tqt.Q4Tensor) and (pt.k, pt.n) == (jt.k, jt.n)
    for i in range(L):
        want = np.asarray(jqt.dequant_qtensor(_slice(jt, i), jnp.float32))  # [K, N]
        got = tqt.dequant(pt.layer(i)).numpy().T
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-20 * np.abs(want).max())
    if which == "q4mlpg":
        exact = tqt.concat([tqt.pack_gguf_tensor(raws[p][0], GGMLType.Q4_K, (F, K))
                            for p in ("gate", "up")])
    else:
        exact = tqt.pack_gguf_tensor(raws["down"][0], GGMLType.Q4_K, (H, F))
    assert rel(tqt.dequant(pt.layer(0)).numpy(), tqt.dequant(exact).numpy()) < TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_vs_jax_fused_mlp_layered(pair, act):
    gum, dnm, tgu, tdn, _ = pair
    x = np.random.default_rng(1).standard_normal((4, K)).astype(np.float32)
    for layer in range(L):
        want = jax_fused_mlp_layered(jnp.asarray(x, jnp.bfloat16), gum, dnm, jnp.int32(layer), act=act)
        got = tfm.fused_mlp_layered(torch.from_numpy(x).to(torch.bfloat16), tgu, tdn, layer, act)
        assert got.dtype == torch.bfloat16 and got.shape == (4, H)
        assert rel(got.float().numpy(), want) < TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_vs_jax_fused_mlp_one_layer(pair, act):
    gum, dnm, tgu, tdn, _ = pair
    x = np.random.default_rng(2).standard_normal((2, 2, K)).astype(np.float32)
    want = jax_fused_mlp(jnp.asarray(x, jnp.bfloat16), _slice(gum, 1), _slice(dnm, 1), act=act)
    got = tfm.fused_mlp(torch.from_numpy(x.reshape(4, K)), tgu.layer(1), tdn.layer(1), act)
    assert rel(got.float().numpy(), np.asarray(want, np.float32).reshape(4, H)) < TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_vs_jax_mlp_prefill(pair, act):
    """1100 rows: above MLP_FUSED_MAX_ROWS, where both packages dequantize
    the down weight once."""
    gum, dnm, tgu, tdn, _ = pair
    rows = 1100
    assert rows > tfm.MLP_FUSED_MAX_ROWS
    x = np.random.default_rng(3).standard_normal((rows, K)).astype(np.float32)
    want = jax_mlp_prefill(jnp.asarray(x, jnp.bfloat16), _slice(gum, 0), _slice(dnm, 0), act=act)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plain = tfm.fused_mlp_plain(xt, tgu.layer(0), tdn.layer(0), act)
    assert rel(plain.float().numpy(), want) < TOL
    got = tfm.mlp_prefill(xt, tgu.layer(0), tdn.layer(0), act)
    assert got.shape == (rows, H)
    assert rel(got.float().numpy(), plain.float().numpy()) < 1e-2


def test_eligibility_follows_the_jax_rule(pair):
    _, _, tgu, tdn, _ = pair
    assert tfm.mlp_eligible(tgu, tdn)
    q8 = tqt.Q8Tensor(torch.zeros(L, H, F, dtype=torch.int8), torch.ones(L, H, F // 16),
                      None, F, H, 16)
    assert not tfm.mlp_eligible(tgu, q8)  # an 8-bit down stack keeps the two-matmul route
    assert not tfm.mlp_eligible(tgu, tqt.LayerList([tdn.layer(0), q8.layer(1)]))
    narrow = tqt.Q4Tensor(tgu.qs[..., :128], tgu.scales[..., :8], tgu.mins[..., :8], 256, 2 * F)
    assert not tfm.mlp_eligible(narrow, tdn)  # K % 1024 != 0, as jqt.mlp_eligible
    with pytest.raises(ValueError):
        tfm.fused_mlp(torch.zeros(2, K), tgu.layer(0), tdn.layer(0), act="relu")
