"""ChatSession.save / load in the port: the JAX package's session file
(np.savez_compressed: `meta` JSON, `cache_k`/`cache_v` [L, 1, max_seq_len,
KVD], `cache_ks`/`cache_vs` [L, 1, Hkv, max_seq_len] on an int8 cache).

On the chat fixture of the JAX package's session test (the tiny F32 llama,
2 layers, context 512; max_seq_len 360 here, so the port's cache of 384
slots is longer than the file's 360): a session saved, loaded and
continued gives the tokens of one never saved, at f32, bf16 and int8; the
loaded cache holds the saved bits; a session the JAX engine saved (f32 and
int8) loads into the port and continues with the JAX engine's reply, and a
port session loads into the JAX engine; the wrong model or max_seq_len is
refused. Replies are compared as text (greedy, 6 tokens a turn). The JAX
engine cannot load its own bf16 session (numpy writes ml_dtypes' bfloat16
as the raw dtype |V2, which jnp.asarray refuses: a reference fault,
ROADMAP §3); the port reads that file.
"""
import numpy as np
import pytest
import torch

from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.config import SamplingParams as JSamplingParams
from nfai_tpu.runtime.engine import ChatSession as JChatSession
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf

MAX_SEQ = 360
CONFIG = dict(max_seq_len=MAX_SEQ, prefill_chunk=128)
DTYPES = {"f32": dict(dtype="float32"), "bf16": dict(dtype="bfloat16"),
          "int8": dict(dtype="float32", kv_dtype="int8")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores; restored
    for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def greedy(n=6):
    return SamplingParams(temperature=0.0, max_new_tokens=n, seed=0)


@pytest.fixture(scope="module")
def chat_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("sess") / "chat.gguf", n_layers=2,
                                context_length=512)


@pytest.fixture(scope="module")
def engines(chat_path):
    return {k: InferenceEngine(chat_path, EngineConfig(**CONFIG, **kw), device="cpu")
            for k, kw in DTYPES.items()}


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_save_load_continue_equals_a_never_saved_session(engines, kind, tmp_path):
    engine = engines[kind]
    s = ChatSession(engine, greedy())
    r1 = s.send("hello")
    s.save(tmp_path / "session.npz")
    with np.load(tmp_path / "session.npz") as z:
        assert set(z.files) == {"meta", "cache_k", "cache_v"} | (
            {"cache_ks", "cache_vs"} if kind == "int8" else set())
        assert z["cache_k"].shape[2] == MAX_SEQ and z["cache_k"].dtype == {
            "f32": np.float32, "bf16": np.dtype("V2"), "int8": np.int8}[kind]
    s2 = ChatSession.load(engine, tmp_path / "session.npz", greedy())
    assert [m.asdict() for m in s2.messages] == [m.asdict() for m in s.messages]
    assert s2._cached_ids == s._cached_ids
    for a in ("k", "v", "ks", "vs"):
        saved, loaded = getattr(s._cache, a), getattr(s2._cache, a)
        if saved is None:
            assert loaded is None
            continue
        assert loaded.dtype == saved.dtype and loaded.shape == saved.shape and loaded.device == engine.device
        cut = (slice(None),) * (2 if a in ("k", "v") else 3) + (slice(0, MAX_SEQ),)
        assert torch.equal(loaded[cut], saved[cut])
    r2 = s2.send("again")
    s3 = ChatSession(engine, greedy())
    assert s3.send("hello") == r1
    assert s3.send("again") == r2
    assert r2 == s.send("again")  # the saved session itself goes on the same way


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_a_jax_session_continues_in_the_port(chat_path, engines, kind, tmp_path):
    """The JAX engine saves after one turn and answers a second; the port
    loads the file and gives the same second reply. Both ways: the JAX
    engine loads the port's file and gives the port's reply."""
    je = JInferenceEngine(str(chat_path), JEngineConfig(**CONFIG, **DTYPES[kind]))
    js = JChatSession(je, JSamplingParams(temperature=0.0, max_new_tokens=6, seed=0))
    jr1 = js.send("hello")
    js.save(tmp_path / "jax.npz")
    jr2 = js.send("again")
    ts = ChatSession.load(engines[kind], tmp_path / "jax.npz", greedy())
    with np.load(tmp_path / "jax.npz") as z:
        assert torch.equal(ts._cache.k[:, :, :MAX_SEQ], torch.from_numpy(z["cache_k"]))
    assert [m.content for m in ts.messages][-1] == jr1
    assert ts.send("again") == jr2
    # the port's file in the JAX engine
    ps = ChatSession(engines[kind], greedy())
    assert ps.send("hello") == jr1
    ps.save(tmp_path / "port.npz")
    js2 = JChatSession.load(je, tmp_path / "port.npz",
                            JSamplingParams(temperature=0.0, max_new_tokens=6, seed=0))
    assert np.array_equal(np.asarray(js2._cache.k), ps._cache.k[:, :, :MAX_SEQ].numpy())
    assert js2.send("again") == ps.send("again") == jr2


def test_the_jax_bf16_session_fault_and_the_ports_load(chat_path, engines, tmp_path):
    """The JAX engine's own bf16 session cannot be read back by it (|V2 in
    the file, jnp.asarray raises TypeError); the port reads it, holds its
    bits and continues as a never-saved port session does."""
    je = JInferenceEngine(str(chat_path), JEngineConfig(**CONFIG, dtype="bfloat16"))
    js = JChatSession(je, JSamplingParams(temperature=0.0, max_new_tokens=6, seed=0))
    js.send("hello")
    js.save(tmp_path / "jax_bf16.npz")
    with pytest.raises(TypeError, match="V2"):
        JChatSession.load(je, tmp_path / "jax_bf16.npz")
    ts = ChatSession.load(engines["bf16"], tmp_path / "jax_bf16.npz", greedy())
    with np.load(tmp_path / "jax_bf16.npz") as z:
        raw = z["cache_k"]
    assert raw.dtype == np.dtype("V2")
    assert ts._cache.k.dtype == torch.bfloat16
    assert np.array_equal(ts._cache.k[:, :, :MAX_SEQ].view(torch.int16).numpy(), raw.view(np.int16))
    fresh = ChatSession(engines["bf16"], greedy())
    fresh.send("hello")
    assert ts._cached_ids == fresh._cached_ids
    assert ts.send("again") == fresh.send("again")


def test_wrong_model_seq_len_or_cache_kind_is_refused(chat_path, engines, tmp_path):
    s = ChatSession(engines["f32"], greedy(2))
    s.send("hi")
    s.save(tmp_path / "x.npz")
    other = make_tiny_llama_gguf(tmp_path / "qwen.gguf", arch="qwen3", qk_norm=True, n_layers=2,
                                 context_length=512)
    with pytest.raises(ValueError, match="saved for model"):
        ChatSession.load(InferenceEngine(other, EngineConfig(**CONFIG, dtype="float32"), device="cpu"),
                         tmp_path / "x.npz")
    with pytest.raises(ValueError, match="max_seq_len"):
        ChatSession.load(InferenceEngine(chat_path, EngineConfig(max_seq_len=256, dtype="float32"),
                                         device="cpu"), tmp_path / "x.npz")
    with pytest.raises(ValueError, match="int8"):
        ChatSession.load(engines["int8"], tmp_path / "x.npz")


def test_a_session_without_a_cache_round_trips(engines, tmp_path):
    s = ChatSession(engines["f32"], greedy())
    s.save(tmp_path / "empty.npz")
    s2 = ChatSession.load(engines["f32"], tmp_path / "empty.npz")
    assert s2._cache is None and s2._cached_ids == [] and s2.messages == s.messages
