"""The K/V store (`nfai_tpu_torch.ops.kv_store`: K3 and K10 redesigned as one
kernel with the int8 quantization inside) on the CPU, where it runs its plain
versions, against the JAX package's writes from the same numpy inputs (made
from a seed), exactly (`np.array_equal`):

- the dense decode store (all layers' K and V rows at starts[b]) against
  JAX `quantize_kv` + `write_all_layers` + `write_all_layers_t` (Pallas in
  interpret mode), a start at S dropped;
- the dense prefill store (one layer's [B, T, Hkv*D] rows at starts[b] + t)
  against JAX `quantize_kv` + `_write_cache` + `_write_scales` on positions
  inside [0, S), and a chunk whose tail runs past S, whose rows are dropped;
- the paged store (rows [B, T, Hkv, D] through shuffled block tables at
  ragged positions) against JAX `quantize_kv` + `write_paged` +
  `write_paged_scales`, one row on a page outside the pool (dropped);

each in bf16 (no quantization; f32 and bf16 caches) and int8, head widths
64, 128 and 256, T = 1 and T > 1, page sizes 16 and 128. Then the
structure of the main path on a tiny Llama: one store call a dense decode
step, one a layer for a prefill chunk and on the paged path, bf16 and int8,
and every `quantize_kv` / `write_cache` / `flat_slots` / `scatter_rows` /
`write_all_layers*` call inside a store call (none left on the paths).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.models import llama as jllama
from nfai_tpu.ops.fused_decode import write_all_layers as jax_write_all_layers
from nfai_tpu.ops.fused_decode import write_all_layers_t as jax_write_all_layers_t
from nfai_tpu.runtime.paged_cache import write_paged as jax_write_paged
from nfai_tpu.runtime.paged_cache import write_paged_scales as jax_write_paged_scales
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.models import KVCache, decode_step, paged_prefill_step, prefill_step
from nfai_tpu_torch.models import llama
from nfai_tpu_torch.ops import kv_store as kvs
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.testing import make_tiny_llama_gguf

HEAD_DIMS = (64, 128, 256)
# (cache element, row dtype): the bf16 store on f32 and bf16 caches, and the int8 store
MODES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"), "int8": ("int8", "float32"),
         "int8 bf16 rows": ("int8", "bfloat16")}


def _rows(rng, dtype, *shape):
    """Random K/V rows (some heads far larger than others) as the dtype's
    values in a numpy f32 array, and the same values as a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 20.0, shape[:-1] + (1,))
    x = np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))
    return x, torch.from_numpy(x.copy()).to(getattr(torch, dtype))


def _cache(rng, elem, *shape):
    """A cache holding earlier rows: int8 codes or random values."""
    if elem == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32), elem).astype(jnp.float32))


def _torch(a, elem):
    return torch.from_numpy(a.copy()).to(getattr(torch, elem))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a, elem):
    return jnp.asarray(a, elem)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", list(MODES))
def test_dense_decode_store_equals_jax(d, mode):
    elem, rdt = MODES[mode]
    quant = elem == "int8"
    rng = np.random.default_rng(d + len(mode))
    l, b, s, hkv = 3, 4, 64, 2
    kvd = hkv * d
    starts = np.array([0, 17, s - 1, s], np.int32)  # the last row is dropped
    (k, tk), (v, tv) = _rows(rng, rdt, l, b, kvd), _rows(rng, rdt, l, b, kvd)
    kc, vc = _cache(rng, elem, l, b, s, kvd), _cache(rng, elem, l, b, s, kvd)
    ks, vs = (rng.random((l, b, hkv, s)).astype(np.float32) for _ in range(2))
    want = []
    for cache, sc, rows in ((kc, ks, k), (vc, vs, v)):
        rows = _jnp(rows, rdt)
        if quant:
            rows, scale = jllama.quantize_kv(rows, hkv)
            sc = jax_write_all_layers_t(jnp.asarray(sc), scale, jnp.asarray(starts), interpret=True)
        want += [jax_write_all_layers(_jnp(cache, elem), rows, jnp.asarray(starts), interpret=True), sc]
    got = [_torch(kc, elem), _torch(vc, elem), torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())]
    kvs.kv_store(got[0], got[1], tk, tv, torch.from_numpy(starts), hkv,
                 *((got[2], got[3]) if quant else ()))
    for g, w in zip(got, (want[0], want[2], want[1], want[3])):
        assert np.array_equal(_np(g), np.asarray(w).astype(_np(g).dtype))
    assert np.array_equal(_np(got[0])[:, 3], _np(_torch(kc, elem))[:, 3])  # the dropped row


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t", [1, 7, 32])
def test_dense_prefill_store_equals_jax(d, mode, t):
    elem, rdt = MODES[mode]
    quant = elem == "int8"
    rng = np.random.default_rng(3 * d + t)
    b, s, hkv = 3, 64, 2
    kvd = hkv * d
    starts = np.array([0, 9, s - t], np.int32)  # ragged, inside [0, S - T]
    (k, tk), (v, tv) = _rows(rng, rdt, b, t, kvd), _rows(rng, rdt, b, t, kvd)
    kc, vc = _cache(rng, elem, b, s, kvd), _cache(rng, elem, b, s, kvd)
    ks, vs = (rng.random((b, hkv, s)).astype(np.float32) for _ in range(2))
    want = []
    for cache, sc, rows in ((kc, ks, k), (vc, vs, v)):
        rows = _jnp(rows, rdt)
        if quant:
            rows, scale = jllama.quantize_kv(rows, hkv)
            sc = jllama._write_scales(jnp.asarray(sc), scale, jnp.asarray(starts), False)
        want += [jllama._write_cache(_jnp(cache, elem), rows.reshape(b, t, hkv, d), jnp.asarray(starts), False),
                 sc]
    got = [_torch(kc, elem), _torch(vc, elem), torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())]
    kvs.kv_store(got[0], got[1], tk, tv, torch.from_numpy(starts), hkv, *((got[2], got[3]) if quant else ()))
    for g, w in zip(got, (want[0], want[2], want[1], want[3])):
        assert np.array_equal(_np(g), np.asarray(w).astype(_np(g).dtype))


@pytest.mark.parametrize("quant", [False, True])
def test_dense_prefill_store_drops_rows_past_the_cache(quant):
    """A chunk whose tail runs past S keeps its rows inside [0, S) and drops
    the rest (the JAX `_write_cache` would clamp the start instead)."""
    rng = np.random.default_rng(5)
    b, t, s, hkv, d = 2, 8, 32, 2, 64
    _, tx = _rows(rng, "float32", b, t, hkv * d)
    starts = np.array([28, 3], np.int32)  # row 0 keeps tokens 0..3
    elem = "int8" if quant else "float32"
    kc = _torch(_cache(rng, elem, b, s, hkv * d), elem)
    vc, before = kc.clone(), kc.clone()
    ks, vs = (torch.zeros(b, hkv, s) for _ in range(2))
    kvs.kv_store(kc, vc, tx, tx, torch.from_numpy(starts), hkv, *((ks, vs) if quant else ()))
    rows, sc = kvs.quantize_kv(tx, hkv) if quant else (tx, None)
    assert torch.equal(kc[0, 28:], rows[0, :4]) and torch.equal(kc[1, 3:11], rows[1])
    assert torch.equal(kc[0, :28], before[0, :28]) and torch.equal(vc, kc)
    if quant:
        assert torch.equal(ks[0, :, 28:], sc[0, :4].T) and torch.equal(ks[1, :, 3:11], sc[1].T)
        assert not ks[0, :, :28].any() and not ks[1, :, 11:].any()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t,ps", [(1, 16), (1, 128), (5, 16), (40, 16), (40, 128)])
def test_paged_store_equals_jax(d, mode, t, ps):
    elem, rdt = MODES[mode]
    quant = elem == "int8"
    rng = np.random.default_rng(7 * d + t + ps)
    b, hkv, n_p = 3, 2, 4
    n_pages = b * n_p + 5
    tables = (rng.permutation(n_pages - 1)[: b * n_p] + 1).reshape(b, n_p).astype(np.int32)
    span = n_p * ps
    first = np.array([0, ps - 2, span - t - 3])  # ragged, across page boundaries
    positions = (first[:, None] + np.arange(t)[None]).astype(np.int32)
    tables[2, positions[2, -1] // ps] = n_pages  # a page outside the pool: that row is dropped
    (k, tk), (v, tv) = _rows(rng, rdt, b, t, hkv, d), _rows(rng, rdt, b, t, hkv, d)
    kp, vp = _cache(rng, elem, hkv, n_pages, ps, d), _cache(rng, elem, hkv, n_pages, ps, d)
    ks, vs = (rng.random((hkv, n_pages, ps)).astype(np.float32) for _ in range(2))
    jt, jpos = jnp.asarray(tables), jnp.asarray(positions)
    want = []
    for pages, sc, rows in ((kp, ks, k), (vp, vs, v)):
        rows = _jnp(rows, rdt)
        if quant:
            rows, scale = jllama.quantize_kv(rows.reshape(b, t, hkv * d), hkv)
            sc = jax_write_paged_scales(jnp.asarray(sc), scale, jt, jpos)
            rows = rows.reshape(b, t, hkv, d)
        want += [jax_write_paged(_jnp(pages, elem), rows, jt, jpos), sc]
    got = [_torch(kp, elem), _torch(vp, elem), torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())]
    kvs.kv_store_paged(got[0], got[1], tk, tv, torch.from_numpy(tables), torch.from_numpy(positions),
                       *((got[2], got[3]) if quant else ()))
    for g, w in zip(got, (want[0], want[2], want[1], want[3])):
        assert np.array_equal(_np(g), np.asarray(w).astype(_np(g).dtype))


# -- the main path's structure ---------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("store") / "tiny.gguf", hidden=256, n_heads=4,
                                n_kv_heads=2, ffn_dim=256, vocab_size=256)
    return {kv: InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=128, kv_dtype=kv),
                                device="cpu") for kv in ("auto", "int8")}


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_every_write_of_the_main_path_goes_through_one_store_call(tiny, monkeypatch, kv):
    """One store call a dense decode step, one a layer for a dense prefill
    chunk and for each paged forward; the plain pieces run only inside a
    store call, and the forwards call no other writer."""
    engine = tiny[kv]
    cfg, params, quant = engine.model_cfg, engine.params, kv == "int8"
    calls = {"kv_store": 0, "kv_store_paged": 0}
    inside = []

    def spy_store(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            inside.append(name)
            try:
                return fn(*args, **kw)
            finally:
                inside.pop()
        return run

    def only_inside(name, fn):
        def run(*args, **kw):
            assert inside, f"{name} called outside a store call"
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(llama, "kv_store", spy_store("kv_store", kvs.kv_store))
    monkeypatch.setattr(llama, "kv_store_paged", spy_store("kv_store_paged", kvs.kv_store_paged))
    for name in ("quantize_kv", "write_cache", "flat_slots", "scatter_rows", "write_all_layers_plain",
                 "write_all_layers_t_plain"):
        monkeypatch.setattr(kvs, name, only_inside(name, getattr(kvs, name)))
    monkeypatch.setattr(llama, "quantize_kv", only_inside("llama.quantize_kv", kvs.quantize_kv))
    for gone in ("_write_cache", "scatter_rows", "flat_slots", "write_all_layers", "write_all_layers_t"):
        assert not hasattr(llama, gone)

    n, t = cfg.n_layers, 12
    tokens = torch.randint(3, 200, (2, t), generator=torch.Generator().manual_seed(0))
    positions = torch.arange(t)[None].repeat(2, 1)
    cache = KVCache.zeros(cfg, 2, 64, engine.cache_dtype, "cpu", quantized=quant)
    _, cache = prefill_step(params, cfg, tokens, positions, torch.tensor([t - 1, t - 1]), cache)
    assert calls == {"kv_store": n, "kv_store_paged": 0}
    decode_step(params, cfg, tokens[:, 0], torch.tensor([t, t]), cache)
    assert calls == {"kv_store": n + 1, "kv_store_paged": 0}
    pool = PagedKVCache.zeros(cfg, 6, 16, engine.cache_dtype, "cpu", quantized=quant)
    table = torch.tensor([[3, 1, 5, 2]], dtype=torch.int32)  # 64 positions: K4's key tile
    _, pool = paged_prefill_step(params, cfg, tokens[:1], positions[:1], torch.tensor([t - 1]), pool, table)
    assert calls == {"kv_store": n + 1, "kv_store_paged": n}
    decode_step(params, cfg, tokens[:1, 0], torch.tensor([t]), pool, page_tables=table)
    assert calls == {"kv_store": n + 1, "kv_store_paged": 2 * n}
    assert not inside
