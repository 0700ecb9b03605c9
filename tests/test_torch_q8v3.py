"""The q8v3 container and K12's plain version against the JAX package (port
on the CPU):

- the port's `to_q8v3_stacked` of the same int8 codes, scales and mins
  decodes to exactly (bit for bit, f32) the values of the JAX
  `dequant_qtensor(to_q8v3_stacked(q8))`: groups 16 and 32, with and
  without mins, 2-D and layer-stacked; the nibble planes give the codes
  back; `from_jax_qtensor("q8v3")` carries the JAX container across with
  its bf16 scales and mins bit for bit (N padding dropped);
- the eligibility gates match the JAX `q8v3_eligible` (K % 2048, the
  group, the kind); expert stacks and a tied 8-bit table stay 8-bit
  (through `load_params`);
- `q8v3_matmul_plain` against the JAX `qmatmul_layered` / `qmatmul` on
  the JAX q8v3 container, run as `tests/test_q8v3.py` runs it (bf16 x): per
  input row max|Δ| / max|ref| ≤ 1e-2 (the JAX kernel rounds u0 * 8s to
  bf16, the port multiplies in f32);
- `load_params` under `NFAI_Q8V3=1` (set with `monkeypatch.setenv` for
  both packages) makes the JAX package's container choices key by key: a
  JAX "q8v3" stack is a `Q8V3Tensor`, or a `LayerList` whose 8-bit layers
  are `Q8V3Tensor`s and whose 4-bit layers stay `Q4Tensor` (the JAX
  package promotes the whole stack first); "q8" stays `Q8Tensor`; the
  codes and scales equal the JAX container's;
- a two-layer hidden-2048 Q8_0 model, untied (the JAX test's fixture),
  under `NFAI_Q8V3=1`: prefill logits within 2e-2 of the JAX engine's and
  the same greedy tokens (unless the JAX logits hold a near-tie there);
  `params_from_jax` on the JAX engine's q8v3 leaves gives the port's own
  containers bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models import llama as jllama
from nfai_tpu.ops.qmatmul import qmatmul as jqmatmul
from nfai_tpu.ops.qmatmul import qmatmul_layered as jqmatmul_layered
from nfai_tpu.ops.qtensor import QTensor, dequant_qtensor, pad_qtensor_n
from nfai_tpu.ops.qtensor import q8v3_eligible as jq8v3_eligible
from nfai_tpu.ops.qtensor import to_q8v3_stacked as jto_q8v3
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType, GGUFFile
from nfai_tpu_torch.models import KVCache, LlamaConfig, load_params, params_from_jax, prefill_step
from nfai_tpu_torch.ops import qmatmul as tqm
from nfai_tpu_torch.ops import qtensor as tqt
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf, use_more_bits

TOL_KERNEL = 1e-2
TOL = 2e-2
# tests/test_q8v3.py's model: hidden 2048, untied Q8_0
Q8_MODEL = dict(hidden=2048, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=2048, vocab_size=4096,
                quant=GGMLType.Q8_0, tied=False, seed=7)
# a Q4_K_M-like mix at K = 2048: Q6_K attn_v / ffn_down on `use_more_bits` layers of 4, a tied
# Q6_K table (stays 8-bit), Q4_K elsewhere
MIX = dict(hidden=2048, n_layers=4, n_heads=8, n_kv_heads=4, ffn_dim=2048, vocab_size=512,
           quant=GGMLType.Q4_K, tied=True, seed=8, quant_overrides={
               "token_embd.weight": GGMLType.Q6_K,
               **{f"blk.{i}.{t}.weight": GGMLType.Q6_K for i in range(4) if use_more_bits(i, 4)
                  for t in ("attn_v", "ffn_down")}})
# K = 256: nothing eligible; MoE at K = 2048: experts stay 8-bit, attention repacked
NARROW = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512, vocab_size=512,
              quant=GGMLType.Q8_0, tied=False, seed=9)
MOE = dict(arch="qwen3moe", n_experts=4, n_experts_used=2, qk_norm=True, hidden=2048, n_heads=8,
           n_kv_heads=4, ffn_dim=256, vocab_size=512, tied=False, seed=10, n_layers=2,
           quant=GGMLType.Q8_0)
FIXTURES = {"q8_0": Q8_MODEL, "mix": MIX, "narrow": NARROW, "moe": MOE}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops gain nothing from intra-op threads beside the suite's other
    workers; restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_rows(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def _q8(rng, k, n, group, with_mins, layers=0):
    """The same int8 codes, f32 scales and mins as a JAX QTensor [.., K, N]
    and a port Q8Tensor [.., N, K]."""
    lead = (layers,) if layers else ()
    qs = rng.integers(-128, 128, (*lead, k, n), dtype=np.int8)
    sc = (rng.random((*lead, k // group, n)) * 0.01).astype(np.float32)
    mn = (rng.random((*lead, k // group, n)) * 0.05).astype(np.float32) if with_mins else None
    jq = QTensor(jnp.asarray(qs), jnp.asarray(sc), None if mn is None else jnp.asarray(mn), "q8",
                 k, n, group=group)
    nk = lambda a: torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, -1, -2)))  # noqa: E731
    tq = tqt.Q8Tensor(nk(qs), nk(sc), None if mn is None else nk(mn), k, n, group)
    return jq, tq


def _jax_layer(qt, i):
    return qt.replace(qs=qt.qs[i], scales=qt.scales[i], mins=None if qt.mins is None else qt.mins[i])


@pytest.mark.parametrize("layers", [0, 2], ids=["2d", "stacked"])
@pytest.mark.parametrize("group,with_mins", [(32, False), (32, True), (16, False), (16, True)])
def test_q8v3_decodes_to_the_jax_values(group, with_mins, layers):
    rng = np.random.default_rng(group + with_mins + layers)
    jq, tq = _q8(rng, 2048, 256, group, with_mins, layers)
    jv, tv = jto_q8v3(jq), tqt.to_q8v3_stacked(tq)
    assert jv.kind == "q8v3" and isinstance(tv, tqt.Q8V3Tensor)
    assert tv.qs.dtype == torch.uint8 and tv.qs.shape == tq.qs.shape  # K*N bytes, like int8
    assert tv.scales.dtype == torch.bfloat16 and (tv.mins is not None) == with_mins
    got = tqt.dequant(tv).numpy()
    for i in range(layers or 1):
        want = np.asarray(dequant_qtensor(_jax_layer(jv, i) if layers else jv, jnp.float32))
        assert np.array_equal((got[i] if layers else got).T, want), i
    # the nibble planes hold the codes: v = 16 (hi - 8) + lo
    lo, hi = tqt.q8v3_nibbles(tv.qs)
    assert torch.equal((16 * (hi.to(torch.int16) - 8) + lo.to(torch.int16)).to(torch.int8), tq.qs)
    # u0 = v / 8 exactly, through the bf16 bit decode
    assert torch.equal(tqt.q8v3_u0(tv.qs).float(), tq.qs.float() / 8)
    # a layer of the stack is a view of it, and decodes as the 2-D container
    if layers:
        layer = tv.layer(1)
        assert layer.qs.data_ptr() == tv.qs.data_ptr() + tv.qs[0].numel()
        assert torch.equal(tqt.dequant(layer), tqt.dequant(tv)[1])


@pytest.mark.parametrize("group,with_mins", [(32, False), (16, True)])
def test_from_jax_q8v3_keeps_the_bits(group, with_mins):
    rng = np.random.default_rng(20 + group)
    jq, tq = _q8(rng, 2048, 384, group, with_mins, layers=2)
    jv = jto_q8v3(jq)
    conv = tqt.from_jax_qtensor("q8v3", np.asarray(jv.qs), np.asarray(jv.scales),
                                None if jv.mins is None else np.asarray(jv.mins), jv.k, jv.n,
                                group=group)
    own = tqt.to_q8v3_stacked(tq)
    assert isinstance(conv, tqt.Q8V3Tensor)
    for name in ("qs", "scales", "mins"):
        a, b = getattr(conv, name), getattr(own, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    # the 2-D head, N-padded in the JAX container (384 → 512): padding dropped
    jh, th = _q8(rng, 2048, 384, group, with_mins)
    jp = jto_q8v3(pad_qtensor_n(jh, 512))
    assert jp.qs.shape[-1] == 512 and jp.n == 384
    conv = tqt.from_jax_qtensor("q8v3", np.asarray(jp.qs), np.asarray(jp.scales),
                                None if jp.mins is None else np.asarray(jp.mins), jp.k, jp.n,
                                group=group)
    assert conv.qs.shape == (384, 2048)
    assert np.array_equal(tqt.dequant(conv).numpy().T, np.asarray(dequant_qtensor(jto_q8v3(jh),
                                                                                  jnp.float32)))


@pytest.mark.parametrize("k,group,ok", [(2048, 32, True), (4096, 16, True), (1024, 32, False),
                                        (3072, 32, False), (2048, 8, False)])
def test_eligibility_matches_jax(k, group, ok):
    rng = np.random.default_rng(k + group)
    jq, tq = _q8(rng, k, 64, group, False)
    assert jq8v3_eligible(jq) == tqt.q8v3_eligible(tq) == ok
    assert isinstance(tqt.to_q8v3_stacked(tq), tqt.Q8V3Tensor) == ok
    # a 4-bit weight stays where it is, in both packages
    q4 = tqt.pack_q_values(np.zeros((64, k), np.uint8), np.ones((64, k // 32), np.float32),
                           np.zeros((64, k // 32), np.float32))
    assert not tqt.q8v3_eligible(q4) and not jq8v3_eligible(jq.replace(kind="q4"))
    assert tqt.to_q8v3_stacked(q4) is q4


@pytest.mark.parametrize("group", [32, 16])
def test_plain_matches_the_jax_layered_kernel(group):
    rng = np.random.default_rng(30 + group)
    jq, tq = _q8(rng, 2048, 512, group, True, layers=2)
    jv, tv = jto_q8v3(jq), tqt.to_q8v3_stacked(tq)
    x = (rng.standard_normal((8, 2048)) * 0.1).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for li in range(2):
        want = np.asarray(jqmatmul_layered(xj, jv, jnp.int32(li)), np.float32)
        got = tqm.linear_layered(xt, tv, li)
        assert got.dtype == torch.bfloat16 and got.shape == (8, 512)
        assert rel_rows(got.float().numpy(), want) < TOL_KERNEL, li


@pytest.mark.parametrize("group,with_mins", [(32, False), (16, True)])
def test_plain_matches_the_jax_2d_matmul(group, with_mins):
    """The 2-D head, which the JAX package runs as a one-layer stack."""
    rng = np.random.default_rng(40 + group)
    jq, tq = _q8(rng, 2048, 384, group, with_mins)
    x = (rng.standard_normal((3, 5, 2048)) * 0.1).astype(np.float32)
    want = np.asarray(jqmatmul(jnp.asarray(x, jnp.bfloat16).reshape(15, 2048), jto_q8v3(jq)),
                      np.float32)
    before = tqm.K12.launches
    got = tqm.linear(torch.from_numpy(x).to(torch.bfloat16), tqt.to_q8v3_stacked(tq))
    assert got.shape == (3, 5, 384) and tqm.K12.launches == before  # the CPU launches nothing
    assert rel_rows(got.reshape(15, 384).float().numpy(), want) < TOL_KERNEL


# -- load_params under NFAI_Q8V3 ---------------------------------------------------------


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("q8v3")
    return {name: make_tiny_llama_gguf(d / f"{name}.gguf", **kw) for name, kw in FIXTURES.items()}


def _jax_params(path):
    with JGGUFFile.open(path) as jg:
        return jllama.load_params(jg, jllama.LlamaConfig.from_gguf(jg), dtype=jnp.bfloat16,
                                  device_put=False, quantized="auto")


def _port_kinds(w) -> list:
    """The port container's kind per layer ("q8v3", "q8", "q4", "dense")."""
    names = {tqt.Q8V3Tensor: "q8v3", tqt.Q8Tensor: "q8", tqt.Q4Tensor: "q4"}
    if isinstance(w, tqt.LayerList):
        return [names[type(it)] for it in w.items]
    return [names.get(type(w), "dense")] * (tqt.n_layers(w) if hasattr(w, "qs") else 1)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_load_params_makes_the_jax_q8v3_choices(paths, name, monkeypatch):
    monkeypatch.setenv("NFAI_Q8V3", "1")
    want = _jax_params(paths[name])
    with GGUFFile.open(paths[name]) as g:
        cfg = LlamaConfig.from_gguf(g)
        got = load_params(g, cfg, dtype=torch.bfloat16)
    jl, tl = want["layers"], got["layers"]
    assert set(tl) == set(jl)
    seen = set()
    for key, leaf in jl.items():
        if not isinstance(leaf, QTensor):
            continue
        kinds = _port_kinds(tl[key])
        seen.add(leaf.kind)
        if leaf.kind == "q8v3":
            # the 8-bit layers repacked; a 4-bit layer of a mixed stack stays
            # 4-bit (the JAX package widened it to 8 bits first)
            assert "q8v3" in kinds and set(kinds) <= {"q8v3", "q4"}, key
            for i, kind in enumerate(kinds):
                if kind == "q8v3":
                    w = tl[key].layer(i)
                    jv = _jax_layer(leaf, i)
                    assert np.array_equal(tqt.dequant(w).numpy().T[:, : leaf.n],
                                          np.asarray(dequant_qtensor(jv, jnp.float32))[:, : leaf.n])
        else:
            assert "q8v3" not in kinds, key
    head, jhead = got["lm_head"], want["lm_head"]
    assert isinstance(head, tqt.Q8V3Tensor) == (jhead.kind == "q8v3")
    if name == "q8_0":  # every stack and the untied head repacked
        assert seen == {"q8v3"} and isinstance(head, tqt.Q8V3Tensor)
        assert np.array_equal(tqt.dequant(head).numpy().T,
                              np.asarray(dequant_qtensor(jhead, jnp.float32))[:, : jhead.n])
    if name == "mix":  # the tied Q6_K table stays 8-bit (K6): the embedding rows gather from it
        assert isinstance(head, tqt.Q8Tensor) and got["embed"] is None and jhead.kind == "q8"
        assert isinstance(tl["wv"], tqt.LayerList) and _port_kinds(tl["wv"]) == [
            "q8v3" if use_more_bits(i, 4) else "q4" for i in range(4)]
    if name == "narrow":  # K = 256: nothing is eligible
        assert "q8v3" not in seen and isinstance(head, tqt.Q8Tensor)
    if name == "moe":  # expert stacks stay 8-bit in both; the attention stacks are repacked
        for key in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            assert jl[key].kind == "q8" and _port_kinds(tl[key])[0] == "q8", key
        assert isinstance(tl["wo"], tqt.Q8V3Tensor) and jl["wo"].kind == "q8v3"


def test_without_the_switch_nothing_is_repacked(paths, monkeypatch):
    monkeypatch.setenv("NFAI_Q8V3", "0")
    with GGUFFile.open(paths["q8_0"]) as g:
        got = load_params(g, LlamaConfig.from_gguf(g), dtype=torch.bfloat16)
    assert all(not isinstance(w, tqt.Q8V3Tensor) for w in got["layers"].values())
    assert isinstance(got["lm_head"], tqt.Q8Tensor)


# -- the whole model against the JAX engine -------------------------------------------------


@pytest.fixture(scope="module")
def q8v3_engines(paths):
    mp = pytest.MonkeyPatch()
    mp.setenv("NFAI_Q8V3", "1")
    try:
        je = JInferenceEngine(str(paths["q8_0"]), JEngineConfig(dtype="float32", max_seq_len=64))
        te = InferenceEngine(paths["q8_0"], EngineConfig(dtype="float32", max_seq_len=64),
                             device="cpu")
    finally:
        mp.undo()
    assert je.params["layers"]["wqkv"].kind == "q8v3" and je.params["lm_head"].kind == "q8v3"
    assert isinstance(te.params["layers"]["wqkv"], tqt.Q8V3Tensor)
    assert isinstance(te.params["lm_head"], tqt.Q8V3Tensor)
    return je, te


def test_model_under_q8v3_vs_jax(q8v3_engines):
    je, te = q8v3_engines
    ids = [2, 4, 6, 8, 10, 12, 14]
    jl, _ = je.prefill(je.new_cache(1), ids)
    tl, _ = te.prefill(te.new_cache(1), ids)
    jl = np.asarray(jl, np.float32)
    assert rel_rows(tl.numpy(), jl) < TOL
    want = list(je.generate(ids, JSamplingParams(temperature=0.0, max_new_tokens=4)))
    got = list(te.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=4)))
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:  # only a near-tie of the JAX logits may flip a greedy token
            logits = np.asarray(je.prefill(je.new_cache(1), ids + want[:i])[0])[0]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TOL * np.abs(logits).max(), (i, a, b)
            return
    assert got == want


def test_params_from_jax_carries_q8v3(q8v3_engines):
    je, te = q8v3_engines
    cfg = te.model_cfg
    conv = params_from_jax(jax.tree.map(np.asarray, je.params), cfg)
    for key, w in te.params["layers"].items():
        if isinstance(w, tqt.Q8V3Tensor):
            c = conv["layers"][key]
            assert isinstance(c, tqt.Q8V3Tensor), key
            assert torch.equal(c.qs, w.qs) and torch.equal(c.scales, w.scales), key
    assert torch.equal(conv["lm_head"].qs, te.params["lm_head"].qs)
    tokens = torch.tensor([[2, 4, 6, 8, 10, 12, 14, 16]])
    out = [prefill_step(p, cfg, tokens, torch.arange(8)[None], torch.tensor([7]),
                        KVCache.zeros(cfg, 1, 16, torch.float32))[0] for p in (conv, te.params)]
    assert torch.equal(out[0], out[1])
