"""The port's host tools (nfai_tpu_torch.tools) against the JAX package's
(nfai_tpu.tools), both called in process: `inspect` prints the same lines,
`requantize` writes the same bytes for every JAX target and f16 (a tiny
llama at hidden 256, so the *_K targets take every weight), and its q8_0
output serves through both engines within the tiny-model tolerance (2e-2
of the logit scale, f32, the port on the CPU); `validate` keeps the JAX
fixture format and content key, so a fixture recorded by either package on
the CPU passes the other's CPU run, and its exit codes (0 / 2 / 1).

Two faults of the JAX `requantize` are shown beside the port's behaviour
(ROADMAP §3): it re-infers every metadata type (an INT32 array comes back
UINT32, a FLOAT64 value FLOAT32, a signed array that starts non-negative
cannot be written) and keeps a stale `general.file_type`.
"""
import contextlib
import io
import json
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nfai_tpu import tools as jtools
from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu.gguf import GGUFFile as JGGUFFile
from nfai_tpu.models.llama import decode_step as jax_decode_step
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine
from nfai_tpu_torch import tools
from nfai_tpu_torch.config import EngineConfig
from nfai_tpu_torch.gguf import GGMLType, GGUFFile, GGUFValueType, GGUFWriter, Keys
from nfai_tpu_torch.models import decode_step
from nfai_tpu_torch.runtime.engine import InferenceEngine
from nfai_tpu_torch.testing import make_tiny_llama_gguf

TOL = 2e-2
TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512, vocab_size=512,
            tied=False)
# every target of the JAX tool's QUANTIZERS, and f16
TARGETS = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k", "f16")
VALIDATE = ["--max-seq", "96", "--dtype", "float32"]


def _run(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("tools") / "tiny.gguf", **TINY)


@pytest.mark.parametrize("flags", [(), ("--tensors",), ("--metadata",), ("--tensors", "--metadata")],
                         ids=lambda f: "+".join(f) or "header")
def test_inspect_prints_the_jax_lines(tiny, flags):
    mine = _run(tools.main, ["inspect", str(tiny), *flags])
    theirs = _run(jtools.main, ["inspect", str(tiny), *flags])
    assert mine == theirs and mine[0] == 0
    assert "arch:      llama" in mine[1]


@pytest.mark.parametrize("target", TARGETS)
def test_requantize_writes_the_jax_bytes(tiny, tmp_path, target):
    rc, said = _run(tools.main, ["requantize", str(tiny), str(tmp_path / "mine.gguf"), "--type", target])
    jrc, jsaid = _run(jtools.main, ["requantize", str(tiny), str(tmp_path / "theirs.gguf"), "--type", target])
    assert rc == jrc == 0
    assert said.replace("mine", "theirs") == jsaid
    assert (tmp_path / "mine.gguf").read_bytes() == (tmp_path / "theirs.gguf").read_bytes()
    with GGUFFile.open(tmp_path / "mine.gguf") as g:
        kinds = {d.ggml_type for n, d in g.tensors.items() if not n.endswith("_norm.weight")}
        assert kinds == {GGMLType[target.upper()]}  # every weight took the target, the table too


def test_requantized_q8_0_serves_in_both_engines(tiny, tmp_path):
    out = tmp_path / "q8_0.gguf"
    assert _run(tools.main, ["requantize", str(tiny), str(out), "--type", "q8_0"])[0] == 0
    je = JInferenceEngine(str(out), JEngineConfig(dtype="float32", max_seq_len=128))
    te = InferenceEngine(out, EngineConfig(dtype="float32", max_seq_len=128), device="cpu")
    assert type(te.params["layers"]["wqkv"]).__name__ == "Q8Tensor"
    ids = te.tokenizer.encode("Requantized to Q8_0, served by both engines.")
    jl, jc = je.prefill(je.new_cache(1), ids)
    tl, tc = te.prefill(te.new_cache(1), ids)

    def rel(got, want):
        want = np.asarray(want, np.float32)
        return np.abs(got.numpy() - want).max() / np.abs(want).max()

    assert rel(tl, jl) < TOL
    pos = len(ids)
    for tok in (17, 99, 200, 42):
        jl, jc = jax_decode_step(je.params, je.model_cfg, jnp.asarray([tok], jnp.int32),
                                 jnp.asarray([pos], jnp.int32), jc)
        tl, tc = decode_step(te.params, te.model_cfg, torch.tensor([tok]), torch.tensor([pos]), tc)
        assert rel(tl, jl) < TOL
        pos += 1


def _typed_fixture(path, token_types, file_type=15):
    """A tiny llama whose metadata holds the types the JAX tool does not
    keep: an INT32 token_type array, a FLOAT64 value, general.file_type."""
    src = make_tiny_llama_gguf(path.with_suffix(".src.gguf"), **TINY)
    with GGUFFile.open(src) as g:
        w = GGUFWriter(alignment=g.alignment)
        for k, v in g.metadata.items():
            if k == Keys.TOKENIZER_TOKEN_TYPE:
                w.add(k, token_types(v), GGUFValueType.ARRAY, GGUFValueType.INT32)
            else:
                w.add(k, v, *g.metadata_types[k])
        w.add(Keys.FILE_TYPE, file_type, GGUFValueType.UINT32)
        w.add("general.sampling.temp", 0.1, GGUFValueType.FLOAT64)
        for name in g.tensors:
            w.add_tensor(name, np.zeros(g.tensors[name].shape, np.float32), g.tensors[name].ggml_type,
                         raw_bytes=g.tensor_bytes(name).tobytes())
    return w.write(path)


def test_requantize_keeps_the_metadata_types_where_the_jax_tool_does_not(tmp_path):
    src = _typed_fixture(tmp_path / "typed.gguf", list)
    _run(tools.main, ["requantize", str(src), str(tmp_path / "mine.gguf"), "--type", "q8_0"])
    _run(jtools.main, ["requantize", str(src), str(tmp_path / "theirs.gguf"), "--type", "q8_0"])
    with GGUFFile.open(src) as s, GGUFFile.open(tmp_path / "mine.gguf") as m, \
            GGUFFile.open(tmp_path / "theirs.gguf") as t:
        tt, temp, ft = Keys.TOKENIZER_TOKEN_TYPE, "general.sampling.temp", Keys.FILE_TYPE
        # the port: every type as read, the file type now Q8_0's (llama.cpp's MOSTLY_Q8_0 = 7)
        assert m.metadata_types == s.metadata_types
        assert m.metadata_types[tt] == (GGUFValueType.ARRAY, GGUFValueType.INT32)
        assert m.metadata[temp] == 0.1 and m.metadata[ft] == 7
        assert m.metadata[tt] == s.metadata[tt]
        # the JAX tool: UINT32 elements, a FLOAT32 value (0.1 rounded), the Q4_K_M file type kept
        assert t.metadata_types[tt] == (GGUFValueType.ARRAY, GGUFValueType.UINT32)
        assert t.metadata_types[temp] == (GGUFValueType.FLOAT32, None)
        assert t.metadata[temp] == float(np.float32(0.1)) != 0.1
        assert t.metadata[ft] == 15
        # the tensors are the same in both
        assert m.tensors.keys() == t.tensors.keys()
        for name in m.tensors:
            assert np.array_equal(m.tensor_bytes(name), t.tensor_bytes(name))
    with JGGUFFile.open(tmp_path / "mine.gguf") as jm, GGUFFile.open(src) as s:  # the JAX reader reads it
        assert jm.metadata == s.metadata | {Keys.FILE_TYPE: 7}


def test_requantize_writes_a_signed_array_the_jax_tool_cannot(tmp_path):
    src = _typed_fixture(tmp_path / "signed.gguf", lambda v: [1] + [-1] * (len(v) - 1))
    with pytest.raises(struct.error):  # a negative value packed as UINT32
        _run(jtools.main, ["requantize", str(src), str(tmp_path / "theirs.gguf"), "--type", "q8_0"])
    assert _run(tools.main, ["requantize", str(src), str(tmp_path / "mine.gguf"), "--type", "q8_0"])[0] == 0
    with GGUFFile.open(tmp_path / "mine.gguf") as m:
        assert m.metadata[Keys.TOKENIZER_TOKEN_TYPE][:2] == [1, -1]


def test_checkpoint_key_is_the_jax_key(tiny, tmp_path):
    big = tmp_path / "big.bin"  # past the 4 MB head and the 4 KB tail
    big.write_bytes(np.random.default_rng(0).bytes((5 << 20) + 123))
    for path in (str(tiny), str(big)):
        assert tools._checkpoint_key(path) == jtools._checkpoint_key(path)
    assert tools._VALIDATE_PROMPTS == jtools._VALIDATE_PROMPTS
    assert tools._VALIDATE_CORPUS == jtools._VALIDATE_CORPUS


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("validate")
    return (make_tiny_llama_gguf(d / "v1.gguf", n_layers=2, seed=70, context_length=256),
            make_tiny_llama_gguf(d / "v2.gguf", n_layers=2, seed=71, context_length=256))


@pytest.mark.parametrize("recorder", ["jax", "port"])
def test_a_fixture_of_either_package_passes_the_other(checkpoints, tmp_path, recorder):
    fx = str(tmp_path / "fixtures.json")
    port = ["--device", "cpu"]
    record, check = (jtools.main, []), (tools.main, port)
    if recorder == "port":
        record, check = check, record
    p = str(checkpoints[0])
    assert _run(record[0], ["validate", p, "--fixtures", fx, "--update", *VALIDATE, *record[1]])[0] == 0
    rc, said = _run(check[0], ["validate", p, "--fixtures", fx, *VALIDATE, *check[1]])
    assert rc == 0, said
    assert "VALIDATE OK" in said
    with open(fx) as f:
        rec = json.load(f)[tools._checkpoint_key(p)]
    assert set(rec) == {"model", "key", "greedy_tokens", "ppl", "ppl_window", "chat_smoke_chars"}


def test_validate_exit_codes(checkpoints, tmp_path):
    p1, p2 = map(str, checkpoints)
    fx = str(tmp_path / "fixtures.json")
    common = ["--fixtures", fx, *VALIDATE, "--device", "cpu"]
    assert _run(tools.main, ["validate", p1, *common])[0] == 2  # no fixture yet
    assert _run(tools.main, ["validate", p1, *common, "--update"])[0] == 0
    assert _run(tools.main, ["validate", p1, *common])[0] == 0
    assert _run(tools.main, ["validate", p2, *common])[0] == 2  # another checkpoint, its own key
    with open(fx) as f:
        data = json.load(f)
    key = tools._checkpoint_key(p1)
    good = json.loads(json.dumps(data))
    data[key]["ppl"] *= 1.01  # past the default 0.5% tolerance
    with open(fx, "w") as f:
        json.dump(data, f)
    assert _run(tools.main, ["validate", p1, *common])[0] == 1
    assert _run(tools.main, ["validate", p1, *common, "--ppl-tol", "0.02"])[0] == 0
    good[key]["greedy_tokens"][0][0] ^= 1
    with open(fx, "w") as f:
        json.dump(good, f)
    assert _run(tools.main, ["validate", p1, *common])[0] == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is visible")
def test_validate_needs_a_card_unless_asked_for_the_cpu(checkpoints, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tools.main(["validate", str(checkpoints[0]), "--fixtures", str(tmp_path / "f.json")])
