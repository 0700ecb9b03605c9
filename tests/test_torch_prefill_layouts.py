"""K4's kv layouts against the JAX package (port on the CPU):

- the plain version in "headmajor" ([B, Hkv, S, D] caches) and "merged"
  (the native [B, S, Hkv*D] rows) against the JAX `flash_prefill_attention`
  with the same `kv_layout` in interpret mode, at D = 64, 128 and 256, with
  offsets, softcap, a sliding window and int8 codes with their scales; f32
  on both sides, per query row max|Δ| / max|ref| ≤ 1e-4 (only the
  summation order differs); "merged" at D = 64 raises in both packages;
- an unknown layout raises in the port (the wrapper, and `prefill_step`
  with `_PREFILL_KV_LAYOUT` set to it), where the JAX function takes it as
  "headmajor" and the JAX `prefill_step` runs it;
- `prefill_step`, then 4 teacher-forced decode steps, dense and through the
  page pool, with `_PREFILL_KV_LAYOUT` "headmajor" and "merged" in both
  packages (the JAX one with `PREFILL_ATTN_IMPL = "flash"`), on bf16-role
  (f32 here) and int8 caches: the logits within 2e-2 (5e-2 on int8 caches,
  each package quantizing its own K/V), as the other whole-model tests;
  and the port's layouts against its own "full" within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.models import llama as jllama
from nfai_tpu.ops.prefill_attention import flash_prefill_attention as jax_flash
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.models import KVCache, decode_step, paged_prefill_step, prefill_step
from nfai_tpu_torch.models import llama as tllama
from nfai_tpu_torch.ops import prefill_attention as pa
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import PagedKVCache
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 1e-4  # f32 attention, port plain vs JAX interpret kernel
TOL_MODEL, TOL_INT8 = 2e-2, 5e-2
# head_dim 128 (hidden 256 over 2 heads): "merged" is legal, as the JAX test's fixture
MODEL = dict(hidden=256, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=512, vocab_size=512,
             context_length=512, seed=11)
T, S, PS, TABLE = 64, 128, 32, [[3, 1, 6, 4]]  # the JAX flash route needs T % 64, S % 128
PROMPT = np.random.default_rng(0).integers(5, 200, 50)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops gain nothing from intra-op threads beside the suite's other
    workers; restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_rows(got, want, row_dims=2):
    """The worst over rows (the leading `row_dims` axes) of max|Δ| / max|want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lead = got.shape[:row_dims]
    g, w = got.reshape(*lead, -1), want.reshape(*lead, -1)
    return float((np.abs(g - w).max(-1) / np.abs(w).max(-1)).max())


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _cache(rng, b, s, hkv, d, layout, int8):
    """K or V of one layer in `layout` ([B, Hkv, S, D] for "headmajor"),
    int8 codes from the JAX `quantize_kv` with [B, Hkv, S] scales if `int8`."""
    rows = _f32(rng, b, s, hkv * d)
    scales = None
    if int8:
        q, sc = jllama.quantize_kv(jnp.asarray(rows), hkv)
        rows, scales = np.array(q), np.swapaxes(np.array(sc), 1, 2).copy()
    if layout == "headmajor":
        rows = rows.reshape(b, s, hkv, d).transpose(0, 2, 1, 3).copy()
    return rows, scales


CASES = [  # (d, r, hkv, t, offsets, softcap, window)
    (64, 4, 2, 64, (0, 64), 0.0, 0),  # model A's heads
    (128, 4, 2, 64, (0, 128), 0.0, 0),  # E's GQA ratio at D = 128
    (128, 8, 1, 128, (64, 0), 0.0, 0),
    (256, 2, 2, 64, (128, 37), 50.0, 96),  # model G's: softcap and a window
]


# "merged" only where D % 128 == 0 (test_merged_needs_d_multiple_of_128)
LAYOUT_CASES = [(layout, c) for c in CASES for layout in ("headmajor", "merged")
                if layout == "headmajor" or c[0] % 128 == 0]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layout,case", LAYOUT_CASES,
                         ids=[f"{lay}-D{c[0]}-r{c[1]}-cap{c[5]:g}-win{c[6]}" for lay, c in LAYOUT_CASES])
def test_plain_layouts_match_the_jax_kernel(layout, case, int8):
    d, r, hkv, t, offsets, softcap, window = case
    rng = np.random.default_rng(d + 7 * r + t + int(softcap) + window + int8)
    b, s = len(offsets), 256
    q = _f32(rng, b, t, hkv * r, d)
    (kc, ks), (vc, vs) = (_cache(rng, b, s, hkv, d, layout, int8) for _ in range(2))
    offs = np.array(offsets, np.int32)
    jkw = {} if not int8 else dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, kc, vc, offs)), t_block=64, s_block=128,
                                interpret=True, softcap=softcap, window=window,
                                kv_layout=layout, **jkw))
    tkw = {} if not int8 else dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    got = pa.flash_prefill_attention(*map(torch.from_numpy, (q, kc, vc, offs)), softcap=softcap,
                                     window=window, kv_layout=layout, **tkw)
    assert got.shape == (b, t, hkv * r, d)
    assert rel_rows(got.numpy(), want) < TOL
    # the same values in the "full" layout give the same result
    if layout == "headmajor":
        kc, vc = (c.transpose(0, 2, 1, 3).reshape(b, s, hkv * d).copy() for c in (kc, vc))
    full = pa.flash_prefill_attention(*map(torch.from_numpy, (q, kc, vc, offs)), softcap=softcap,
                                      window=window, **tkw)
    assert torch.allclose(full, got, rtol=0, atol=1e-6)


def test_merged_needs_d_multiple_of_128():
    b, t, hq, hkv, d, s = 1, 64, 4, 2, 64, 128
    q, kc = np.zeros((b, t, hq, d), np.float32), np.zeros((b, s, hkv * d), np.float32)
    off = np.zeros((b,), np.int32)
    with pytest.raises(ValueError, match="merged"):
        jax_flash(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(off), t_block=64,
                  s_block=128, kv_layout="merged", interpret=True)
    with pytest.raises(ValueError, match="merged"):
        pa.flash_prefill_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(kc), torch.from_numpy(off), kv_layout="merged")


def test_unknown_layout_raises_in_the_port():
    rng = np.random.default_rng(5)
    q, kc = _f32(rng, 1, 64, 4, 128), _f32(rng, 1, 2, 128, 128)
    off = torch.zeros(1, dtype=torch.int32)
    for bad in ("head_major", "Full", ""):
        with pytest.raises(ValueError, match="kv_layout"):
            pa.flash_prefill_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                       torch.from_numpy(kc), off, kv_layout=bad)


def test_the_jax_function_takes_an_unknown_layout_as_headmajor():
    """The reference's silent fallback (ROADMAP §3): any layout it does not
    name runs the head-major path, bit for bit."""
    rng = np.random.default_rng(6)
    q, kc, vc = _f32(rng, 1, 64, 4, 128), _f32(rng, 1, 2, 128, 128), _f32(rng, 1, 2, 128, 128)
    off = jnp.zeros((1,), jnp.int32)
    run = lambda layout: np.asarray(jax_flash(  # noqa: E731
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), off, t_block=64, s_block=128,
        interpret=True, kv_layout=layout))
    assert np.array_equal(run("head_major"), run("headmajor"))


# -- whole models ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("layouts") / "hd128.gguf", **MODEL)
    out = {}
    for kv in ("auto", "int8"):
        je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=S, kv_dtype=kv))
        te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=S, kv_dtype=kv),
                             device="cpu")
        out[kv] = (je, te)
    assert out["auto"][1].model_cfg.head_dim == 128
    return out


def _chunk():
    tokens = np.zeros((1, T), np.int64)
    tokens[0, : PROMPT.size] = PROMPT
    return tokens, np.arange(T)[None], np.array([PROMPT.size - 1])


def _port_run(te, paged, quant):
    cfg, params = te.model_cfg, te.params
    tokens, positions, last = (torch.from_numpy(a) for a in _chunk())
    if paged:
        cache = PagedKVCache.zeros(cfg, 8, PS, torch.float32, quantized=quant)
        tables = torch.tensor(TABLE, dtype=torch.int32)
        logits, cache = paged_prefill_step(params, cfg, tokens, positions, last, cache, tables)
    else:
        cache, tables = KVCache.zeros(cfg, 1, S, torch.float32, quantized=quant), None
        logits, cache = prefill_step(params, cfg, tokens, positions, last, cache)
    out, pos = [logits.numpy()], PROMPT.size
    for tok in (17, 99, 200, 42):
        logits, cache = decode_step(params, cfg, torch.tensor([tok]), torch.tensor([pos]), cache,
                                    page_tables=tables)
        out.append(logits.numpy())
        pos += 1
    return out


def _jax_run(je, paged, quant):
    jcfg = je.model_cfg
    tokens, positions, last = (jnp.asarray(a, jnp.int32) for a in _chunk())
    if paged:
        cache = JPagedKVCache.zeros(jcfg, n_pages=8, page_size=PS, dtype=jnp.float32,
                                    quantized=quant)
        tables = jnp.asarray(TABLE, jnp.int32)
        logits, cache = jllama.paged_prefill_step(je.params, jcfg, tokens, positions, last, cache,
                                                  tables)
    else:
        cache = jllama.KVCache.zeros(jcfg, 1, S, jnp.float32, quantized=quant)
        logits, cache = jllama.prefill_step(je.params, jcfg, tokens, positions, last, cache)
    out, pos = [np.asarray(logits)], PROMPT.size
    for tok in (17, 99, 200, 42):
        if paged:
            h, cache = jllama.forward(je.params, jcfg, jnp.asarray([[tok]], jnp.int32),
                                      jnp.asarray([[pos]], jnp.int32), cache, page_tables=tables)
            logits = jllama.logits_for(je.params, h, jcfg)[:, 0]
        else:
            logits, cache = jllama.decode_step(je.params, jcfg, jnp.asarray([tok], jnp.int32),
                                               jnp.asarray([pos], jnp.int32), cache)
        out.append(np.asarray(logits))
        pos += 1
    return out


@pytest.fixture
def jax_layout(monkeypatch):
    """Set the JAX package's layout and flash route the way its own tests do
    (module attributes), restored after the test."""
    monkeypatch.setattr(jllama, "PREFILL_ATTN_IMPL", "flash")

    def set_layout(layout):
        monkeypatch.setattr(jllama, "_PREFILL_KV_LAYOUT", layout)
        monkeypatch.setattr(tllama, "_PREFILL_KV_LAYOUT", layout)

    return set_layout


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("layout", ["headmajor", "merged"])
def test_model_layouts_vs_jax(engines, jax_layout, layout, paged, quant):
    je, te = engines["int8" if quant else "auto"]
    jax_layout(layout)
    launches = pa.K4_HM.launches + pa.K4.launches + pa.K4_HM_I8.launches + pa.K4_I8.launches
    got = _port_run(te, paged, quant)
    want = _jax_run(je, paged, quant)
    tol = TOL_INT8 if quant else TOL_MODEL
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and rel_rows(g, w, 1) < tol, step
    # the CPU wrappers launch nothing
    assert pa.K4_HM.launches + pa.K4.launches + pa.K4_HM_I8.launches + pa.K4_I8.launches == launches
    jax_layout("full")
    full = _port_run(te, paged, quant)
    for step, (g, f) in enumerate(zip(got, full)):
        assert rel_rows(g, f, 1) < 1e-4, step


def test_an_unknown_layout_raises_in_the_port_and_runs_in_jax(engines, jax_layout):
    je, te = engines["auto"]
    jax_layout("head_major")
    with pytest.raises(ValueError, match="kv_layout"):
        _port_run(te, False, False)
    got = _jax_run(je, False, False)  # the reference runs it, as "headmajor"
    jax_layout("headmajor")
    want = _jax_run(je, False, False)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_the_layout_is_read_from_the_environment_at_import(tmp_path):
    """`_PREFILL_KV_LAYOUT` comes from NFAI_PREFILL_KV when the module is
    imported ("full" without it), as in the JAX module."""
    import os
    import subprocess
    import sys

    code = "import nfai_tpu_torch.models.llama as m; print(m._PREFILL_KV_LAYOUT)"
    env = {k: v for k, v in os.environ.items() if k != "NFAI_PREFILL_KV"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = lambda e: subprocess.run([sys.executable, "-c", code], env=e, cwd=root,  # noqa: E731
                                   capture_output=True, text=True, check=True).stdout.strip()
    assert run(env) == "full"
    assert run(dict(env, NFAI_PREFILL_KV="merged")) == "merged"
