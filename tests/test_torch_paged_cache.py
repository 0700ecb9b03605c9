"""The port's paged KV pool against the JAX package's: the allocator's
bookkeeping, the scatter through the block tables, K7's plain version, and
the paged forwards (port on the CPU, both packages in float32).

Tolerances: the allocator and `write_paged` must agree exactly; K7's plain
version must match the JAX Pallas kernel (interpret mode) and its jnp
reference within max|got - want| / max|want| < 1e-5 (f32 inputs from a
numpy seed: only the summation order differs); the port's paged forwards
must match its dense ones within 1e-4 with equal greedy tokens (the same
arithmetic through different plumbing); against the JAX package's paged
forwards, logits and the pool's written rows within 2e-2 (the JAX side
rounds dequantized weights and matmul outputs to bf16) and equal greedy
tokens.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.models.llama import paged_decode_loop as jax_paged_decode_loop
from nfai_tpu.models.llama import paged_prefill_step as jax_paged_prefill_step
from nfai_tpu.ops.paged_attention import paged_attention_reference, paged_flash_decode_attention
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu.runtime.paged_cache import OutOfPages as JOutOfPages
from nfai_tpu.runtime.paged_cache import PageAllocator as JPageAllocator
from nfai_tpu.runtime.paged_cache import PagedKVCache as JPagedKVCache
from nfai_tpu.runtime.paged_cache import write_paged as jax_write_paged
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.models import (
    KVCache, decode_loop, paged_decode_loop, paged_prefill_step, prefill_step,
)
from nfai_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_plain
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.runtime.paged_cache import (
    OutOfPages, PageAllocator, PagedKVCache, write_paged,
)
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 2e-2
TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            vocab_size=512, quant=GGMLType.Q4_K, tied=False, context_length=256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores (the module
    ran 20x slower under 6 workers); restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _script(alloc, oom):
    """One scripted sequence of allocator calls; returns everything each
    call returned or raised, and the counters along the way."""
    out = []

    def rec(name, fn, *args):
        try:
            r = fn(*args)
        except oom:
            r = "OutOfPages"
        out.append((name, r, alloc.refs.tolist(), alloc.hits, alloc.misses, alloc.free_pages))
        return r

    ps = alloc.page_size
    ids_a = list(range(1, 3 * ps + 3))  # 3 full pages + 2 tokens
    ids_b = ids_a[: 2 * ps] + [999] * (ps + 5)  # shares 2 pages with a
    pa = rec("alloc a", alloc.alloc, 4)
    rec("publish a", alloc.publish_prefix, ids_a, pa)
    pb_shared = rec("lookup b", alloc.lookup_prefix, ids_b)
    pb_new = rec("alloc b", alloc.alloc, 2)
    rec("lookup a again", alloc.lookup_prefix, ids_a)
    rec("lookup short", alloc.lookup_prefix, ids_a[:ps])  # the last token is never covered
    rec("lookup miss", alloc.lookup_prefix, [7] * (2 * ps + 1))
    rec("alloc too many", alloc.alloc, 99)
    rec("release a", alloc.release, pa)
    rec("release b", alloc.release, pb_shared[0] + pb_new)
    rec("retain", alloc.retain, pb_new[:1])
    rec("release retained", alloc.release, pb_new[:1])
    rec("alloc all (evicts published pages LRU)", alloc.alloc, alloc.free_pages)
    rec("lookup after eviction", alloc.lookup_prefix, ids_a)
    rec("alloc on empty pool", alloc.alloc, 1)
    return out


@pytest.mark.parametrize("n_pages,ps", [(12, 4), (16, 16)])
def test_allocator_follows_the_jax_script(n_pages, ps):
    got = _script(PageAllocator(n_pages, ps), OutOfPages)
    want = _script(JPageAllocator(n_pages, ps), JOutOfPages)
    assert got == want
    assert all(0 not in (r if isinstance(r, list) else []) for name, r, *_ in got
               if name.startswith("alloc"))  # the sink page is never handed out


def test_allocator_double_free_raises():
    a = PageAllocator(4, 16)
    p = a.alloc(1)
    a.release(p)
    with pytest.raises(RuntimeError, match="double free"):
        a.release(p)


@pytest.mark.parametrize("ps", [4, 16])
def test_write_paged_equals_jax(ps):
    rng = np.random.default_rng(ps)
    hkv, n_pages, d, b, t = 2, 12, 8, 3, 5
    pages = rng.standard_normal((hkv, n_pages, ps, d)).astype(np.float32)
    new = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    tables = (rng.permutation(n_pages - 1)[: b * 3] + 1).reshape(b, 3).astype(np.int32)
    start = ps - 2  # the rows cross a page boundary
    positions = (start + np.arange(t))[None].repeat(b, 0).astype(np.int32)
    want = np.asarray(jax_write_paged(jnp.asarray(pages), jnp.asarray(new), jnp.asarray(tables),
                                      jnp.asarray(positions)))
    pool = torch.from_numpy(pages.copy())
    got = write_paged(pool, torch.from_numpy(new), torch.from_numpy(tables), torch.from_numpy(positions))
    assert got is pool  # in place
    np.testing.assert_array_equal(pool.numpy(), want)


@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_paged_attention_plain_vs_jax(ps, r):
    """Shuffled tables; lengths 1, ps - 1, ps, ps + 1 and the full table."""
    rng = np.random.default_rng(100 * ps + r)
    hkv, d, n_p = 2, 64, 2 if ps == 128 else 4
    b, n_pages = 5, 5 * n_p + 3
    q = rng.standard_normal((b, hkv * r, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pages, ps, d)).astype(np.float32)
    tables = (rng.permutation(n_pages - 1)[: b * n_p] + 1).reshape(b, n_p).astype(np.int32)
    lengths = np.array([1, ps - 1, ps, ps + 1, n_p * ps], np.int32)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    j_kernel = np.asarray(paged_flash_decode_attention(*args, interpret=True))
    j_ref = np.asarray(paged_attention_reference(*args))
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    plain = paged_decode_attention_plain(*t, d**-0.5).numpy()
    assert rel(plain, j_kernel) < 1e-5
    assert rel(plain, j_ref) < 1e-5
    np.testing.assert_array_equal(paged_decode_attention(*t).numpy(), plain)  # CPU: the plain version


def test_paged_attention_unported_variants_raise():
    """Softcap and window are ported (tests/test_torch_gemma.py); a negative
    softcap or window, or a fractional window, raises."""
    q, kp = torch.zeros(1, 4, 64), torch.zeros(2, 3, 16, 64)
    tables, lengths = torch.ones(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="softcap"):
        paged_decode_attention(q, kp, kp, tables, lengths, softcap=-30.0)
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention(q, kp, kp, tables, lengths, window=8.5)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = make_tiny_llama_gguf(tmp_path_factory.mktemp("paged") / "tiny_q4k.gguf", **TINY)
    je = JInferenceEngine(str(path), JEngineConfig(dtype="float32", max_seq_len=256))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    return je, te


PS, TABLE = 16, [[5, 2, 7, 3]]  # 4 shuffled pages of 16: positions 0..63
PROMPT = np.random.default_rng(0).integers(5, 200, 21)
T = 32  # the padded chunk


def _chunk():
    tokens = np.zeros((1, T), np.int64)
    tokens[0, : PROMPT.size] = PROMPT
    return tokens, np.arange(T)[None], np.array([PROMPT.size - 1])


def test_paged_forward_matches_dense(engines):
    """Prefill a prompt and decode 8 greedy tokens through both cache
    layouts of the port: same arithmetic, different plumbing."""
    _, te = engines
    cfg, params = te.model_cfg, te.params
    tokens, positions, last = (torch.from_numpy(a) for a in _chunk())
    dlogits, dcache = prefill_step(params, cfg, tokens, positions, last,
                                   KVCache.zeros(cfg, 1, 64, torch.float32))
    pool = PagedKVCache.zeros(cfg, 9, PS, torch.float32)
    tables = torch.tensor(TABLE, dtype=torch.int32)
    plogits, pool = paged_prefill_step(params, cfg, tokens, positions, last, pool, tables)
    assert rel(plogits.numpy(), dlogits.numpy()) < 1e-4
    first = dlogits.argmax(-1)
    start = torch.tensor([PROMPT.size])
    dtoks, dnext, _, _ = decode_loop(params, cfg, first, start, dcache, None, 8, temperature=0.0)
    ptoks, pnext, pool, _ = paged_decode_loop(params, cfg, first, start, pool, tables, None, 8,
                                              temperature=0.0)
    assert dtoks.tolist() == ptoks.tolist() and dnext.tolist() == pnext.tolist()
    # the pool holds, page by page through the table, the dense cache's rows
    # (within 1e-2: the plain dequant-matmul rounds its input to bf16 as the
    # kernels do, so the attention's f32 summation order can flip one
    # rounding, 2^-8 of one element, in a later layer's K)
    n = PROMPT.size + 8
    rows = pool.k[:, :, tables[0].long()].reshape(cfg.n_layers, cfg.n_kv_heads, -1, cfg.head_dim)
    dense = dcache.k[:, 0, :n].reshape(cfg.n_layers, n, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    assert rel(rows[:, :, :n].numpy(), dense.numpy()) < 1e-2


def test_paged_forward_matches_jax(engines):
    je, te = engines
    tokens, positions, last = _chunk()
    jpool = JPagedKVCache.zeros(je.model_cfg, n_pages=9, page_size=PS, dtype=jnp.float32)
    jlogits, jpool = jax_paged_prefill_step(
        je.params, je.model_cfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32),
        jnp.asarray(last, jnp.int32), jpool, jnp.asarray(TABLE, jnp.int32))
    pool = PagedKVCache.zeros(te.model_cfg, 9, PS, torch.float32)
    tables = torch.tensor(TABLE, dtype=torch.int32)
    tlogits, pool = paged_prefill_step(te.params, te.model_cfg, *(torch.from_numpy(a) for a in (
        tokens, positions, last)), pool, tables)
    assert rel(tlogits.numpy(), np.asarray(jlogits)) < TOL
    first = int(np.argmax(np.asarray(jlogits)))
    assert int(tlogits.argmax()) == first
    jtoks, jnext, jpool, _ = jax_paged_decode_loop(
        je.params, je.model_cfg, jnp.asarray([first], jnp.int32), jnp.asarray([PROMPT.size], jnp.int32),
        jpool, jnp.asarray(TABLE, jnp.int32), jax.random.PRNGKey(0), 8, temperature=0.0)
    ttoks, tnext, pool, _ = paged_decode_loop(
        te.params, te.model_cfg, torch.tensor([first]), torch.tensor([PROMPT.size]), pool, tables,
        None, 8, temperature=0.0)
    assert ttoks.tolist() == np.asarray(jtoks).tolist() and int(tnext[0]) == int(jnext[0])
    n = PROMPT.size + 8
    for jp, tp in ((jpool.k, pool.k), (jpool.v, pool.v)):
        jrows = np.asarray(jp)[:, :, TABLE[0]].reshape(tp.shape[0], tp.shape[1], -1, tp.shape[-1])
        trows = tp[:, :, tables[0].long()].reshape(jrows.shape)
        assert rel(trows[:, :, :n].numpy(), jrows[:, :, :n]) < TOL
