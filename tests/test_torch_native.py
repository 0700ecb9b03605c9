"""The port's native dequant library (nfai_tpu_torch/csrc/nfai_native.cpp,
bound by nfai_tpu_torch.gguf.native, built with g++ at first use) against
the port's numpy codecs, bit for bit: all 13 kinds it decodes, on random
raw blocks and on encoder output, at normal and subnormal f16 scales; the
fused transpose; the reader's routing; and the rules of the build (nothing
at import, a failed build raises and no numpy decode follows). The JAX
package's own native test covers 9 of these kinds; Q5_0, Q5_1, Q8_K and
BF16 are new here. `load_params` gives the same parameters with the
library and with the numpy path forced.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nfai_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter, native, quants, reader
from nfai_tpu_torch.gguf.constants import GGML_BLOCK_LAYOUT
from nfai_tpu_torch.models import LlamaConfig, load_params
from nfai_tpu_torch.testing import make_tiny_llama_gguf

ROOT = Path(__file__).resolve().parent.parent
KINDS = sorted(native._NATIVE_TYPES, key=int)
# kind -> byte offsets of the f16 scales inside a block (BF16/F16 are scalars)
F16_SCALES = {
    GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2),
    GGMLType.Q8_0: (0,), GGMLType.Q2_K: (80, 82), GGMLType.Q3_K: (108,),
    GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2), GGMLType.Q6_K: (208,),
}
# scale draws: "normal" f16 scales in [1e-3, 1e-2); "subnormal" ones
# log-uniform in [1e-7, 5e-5], all below f16's smallest normal (6.1e-5)
MAGNITUDES = ("normal", "subnormal")


def _scales(rng, mag, n):
    if mag == "normal":
        return rng.uniform(1e-3, 1e-2, n)
    return 10.0 ** rng.uniform(-7, np.log10(5e-5), n)


def _random_blocks(kind: GGMLType, mag: str, n_blocks: int, seed: int) -> tuple[np.ndarray, int]:
    """(raw bytes, element count): random codes, scales drawn as `mag` says."""
    rng = np.random.default_rng(seed)
    layout = GGML_BLOCK_LAYOUT[kind]
    n = n_blocks * layout.block_size
    if kind == GGMLType.F16:  # finite values (no NaN payloads), subnormal ones at "subnormal"
        x = rng.standard_normal(n) * (1.0 if mag == "normal" else 1e-6)
        return x.astype(np.float16).view(np.uint8), n
    if kind == GGMLType.BF16:
        x = (rng.standard_normal(n) * (1.0 if mag == "normal" else 1e-39)).astype(np.float32)
        return quants.quant_bf16(x), n
    raw = np.frombuffer(rng.bytes(n_blocks * layout.type_size), np.uint8).reshape(
        n_blocks, layout.type_size).copy()
    for off in F16_SCALES.get(kind, ()):
        raw[:, off:off + 2] = _scales(rng, mag, n_blocks).astype(np.float16).view(np.uint8).reshape(-1, 2)
    if kind == GGMLType.Q8_K:  # f32 d
        raw[:, :4] = _scales(rng, mag, n_blocks).astype(np.float32).view(np.uint8).reshape(-1, 4)
    return raw.reshape(-1), n


def _same_bits(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mag", MAGNITUDES)
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k.name)
def test_native_decodes_the_numpy_bits(kind, mag):
    raw, n = _random_blocks(kind, mag, 40, seed=int(kind) * 7 + len(mag))
    _same_bits(native.dequantize_native(raw, n, kind), quants.dequantize(raw, n, kind))
    if kind in quants.QUANTIZERS or kind == GGMLType.F16:  # and on the encoders' blocks of
        rng = np.random.default_rng(int(kind))  # N(0, 1) values, or of 1e-4 and 1e-6 ones
        for scale in (1.0,) if mag == "normal" else (1e-4, 1e-6):
            x = (rng.standard_normal(256 * 6) * scale).astype(np.float32)
            enc = quants.quantize(x, kind)
            _same_bits(native.dequantize_native(enc, x.size, kind), quants.dequantize(enc, x.size, kind))
    if mag == "subnormal" and kind in F16_SCALES:  # the scales really are subnormal and nonzero
        d = raw.reshape(-1, GGML_BLOCK_LAYOUT[kind].type_size)[:, F16_SCALES[kind][0]:][:, :2]
        d = np.abs(d.copy().view(np.float16).astype(np.float32))
        assert (d > 0).all() and (d < np.finfo(np.float16).tiny).all()


def _gguf(tmp_path, kinds, n_out=24, k_in=512, seed=0) -> Path:
    w = GGUFWriter()
    w.add("general.architecture", "llama")
    for kind in kinds:
        blocks = n_out * k_in // GGML_BLOCK_LAYOUT[kind].block_size
        raw, _ = _random_blocks(kind, "normal", blocks, seed + int(kind))
        w.add_tensor(f"t.{kind.name}", np.zeros((n_out, k_in), np.float32), kind,
                     raw_bytes=raw.tobytes())
    w.add_tensor("t.F32", np.random.default_rng(seed).standard_normal((n_out, k_in)).astype(np.float32),
                 GGMLType.F32)
    return w.write(tmp_path / "kinds.gguf")


@pytest.mark.parametrize("kind", KINDS + [GGMLType.F32], ids=lambda k: k.name)
def test_fused_transpose_is_the_transpose(tmp_path, kind):
    with GGUFFile.open(_gguf(tmp_path, KINDS)) as g:
        name = f"t.{kind.name}"
        t = g.tensor_f32_transposed(name)
        assert t.shape == (512, 24) and t.flags.c_contiguous
        _same_bits(t, np.ascontiguousarray(g.tensor_f32(name).T))
        want = quants.dequantize(g.tensor_bytes(name), 24 * 512, kind).reshape(24, 512).T
        _same_bits(t, np.ascontiguousarray(want))
    w = GGUFWriter()
    w.add_tensor("v", np.ones(32, np.float32), GGMLType.Q8_0)
    with GGUFFile.open(w.write(tmp_path / "one_d.gguf")) as g, pytest.raises(ValueError, match="not 2-D"):
        g.tensor_f32_transposed("v")


def test_reader_routes_each_kind(tmp_path, monkeypatch):
    """The 13 kinds through the library, every other kind through numpy."""
    calls = []
    monkeypatch.setattr(reader, "dequantize", lambda d, n, t: calls.append(t) or quants.dequantize(d, n, t))
    with GGUFFile.open(_gguf(tmp_path, KINDS)) as g:
        for name in g.tensors:
            g.tensor_f32(name)
    assert calls == [GGMLType.F32]


def test_thread_count_beside_torch():
    """torch loaded first (as the tests and the engine load them), then the
    library: neither crashes, the library's team is at most the host's
    cores, and torch's intra-op thread count is what it was. (With torch's
    wheel bundling a libgomp.so.1, the library's NEEDED entry resolves to
    it: one OpenMP runtime in the process.)"""
    code = (
        "import json, os, numpy as np, torch\n"
        "before = torch.get_num_threads()\n"
        "from nfai_tpu_torch.gguf import GGMLType, native, quants\n"
        "n = native.num_threads()\n"
        "x = np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32)\n"
        "enc = quants.quantize(x, GGMLType.Q4_K)\n"
        "same = bool(np.array_equal(native.dequantize_native(enc, x.size, GGMLType.Q4_K),\n"
        "                           quants.dequantize(enc, x.size, GGMLType.Q4_K)))\n"
        "a = torch.randn(256, 256)\n"
        "ok = bool(torch.isfinite(a @ a).all())\n"
        "gomp = sorted({l.split()[-1] for l in open('/proc/self/maps') if 'gomp' in l})\n"
        "print(json.dumps({'n': n, 'cpus': os.cpu_count(), 'before': before,\n"
        "                  'after': torch.get_num_threads(), 'same': same, 'ok': ok, 'gomp': gomp}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert 1 <= res["n"] <= res["cpus"]
    assert res["before"] == res["after"] and res["same"] and res["ok"]
    assert res["gomp"]


def test_importing_builds_and_loads_nothing():
    code = (
        "import json, subprocess\n"
        "calls = []\n"
        "real = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    calls.append(str(a[0] if a else k.get('args')))\n"
        "    return real(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import nfai_tpu_torch.gguf, nfai_tpu_torch.gguf.native as native\n"
        "import nfai_tpu_torch.tools, nfai_tpu_torch.models, nfai_tpu_torch.runtime.engine\n"
        "mapped = [l for l in open('/proc/self/maps') if 'nfai_native' in l]\n"
        "print(json.dumps({'calls': calls, 'lib': native._lib is None, 'mapped': len(mapped)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"calls": [], "lib": True, "mapped": 0}


@pytest.mark.parametrize("fault", ["syntax error", "no compiler"])
def test_a_failed_build_raises_and_no_numpy_decode_follows(tmp_path, monkeypatch, fault):
    if fault == "syntax error":
        broken = tmp_path / "nfai_native.cpp"
        broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
        monkeypatch.setattr(native, "SOURCE", broken)
        match = "building the native dequant library failed"
    else:
        monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
        match = "not found"
    monkeypatch.setattr(native, "_lib", None)
    numpy_calls = []
    monkeypatch.setattr(reader, "dequantize", lambda *a: numpy_calls.append(a[2]) or quants.dequantize(*a))
    with GGUFFile.open(_gguf(tmp_path, [GGMLType.Q4_K])) as g:
        with pytest.raises(RuntimeError, match=match) as err:
            g.tensor_f32("t.Q4_K")
        if fault == "syntax error":
            assert "error" in str(err.value)  # the compiler's output
        with pytest.raises(RuntimeError, match=match):  # every call, not only the first
            g.tensor_f32_transposed("t.Q4_K")
        assert numpy_calls == []
        g.tensor_f32("t.F32")  # a kind the library does not take still reads
    assert numpy_calls == [GGMLType.F32]
    if fault == "syntax error":  # nothing was put in the broken source's place
        assert not native._target(native._compiler()[1]).exists()


def test_bad_arguments_are_refused_before_the_call():
    for kind in (GGMLType.F32, GGMLType.Q8_1, GGMLType.IQ4_NL):
        with pytest.raises(ValueError, match="does not decode"):
            native.dequantize_native(np.zeros(64, np.uint8), 32, kind)
    with pytest.raises(ValueError, match="need 68 bytes"):  # two Q8_0 blocks, one given
        native.dequantize_native(np.zeros(34, np.uint8), 64, GGMLType.Q8_0)
    with pytest.raises(ValueError, match="whole number of blocks"):
        native.dequantize_native(np.zeros(68, np.uint8), 40, GGMLType.Q8_0)
    with pytest.raises(ValueError, match="whole number of blocks"):
        native.dequant_transpose_native(np.zeros(68, np.uint8), GGMLType.Q4_K, 1, 64)


def _assert_params_equal(a, b, where="params"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_params_equal(a[k], b[k], f"{where}.{k}")
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            _assert_params_equal(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_params_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


# a tiny untied Q8_0 llama (its table and its N = 64 projections dense:
# decoded by tensor_f32) and a tiny Q4_K_M mix (llama.cpp's kinds: Q6_K
# table, attn_v and ffn_down, Q4_K elsewhere, F32 norms), plus F16 and Q5_0
# layers that load dense
FIXTURES = {
    "tiny_q8_0": dict(quant=GGMLType.Q8_0, tied=False),
    "tiny_q4_k_m": dict(hidden=256, n_heads=4, n_kv_heads=2, ffn_dim=512, quant=GGMLType.Q4_K,
                        quant_overrides={"token_embd.weight": GGMLType.Q6_K,
                                         "blk.0.attn_v.weight": GGMLType.Q6_K,
                                         "blk.0.ffn_down.weight": GGMLType.Q6_K,
                                         "blk.1.attn_output.weight": GGMLType.F16,
                                         "blk.1.ffn_up.weight": GGMLType.Q5_0}),
}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_load_params_is_the_same_with_and_without_the_library(tmp_path, monkeypatch, fixture):
    path = make_tiny_llama_gguf(tmp_path / f"{fixture}.gguf", seed=3, **FIXTURES[fixture])
    with GGUFFile.open(path) as g:
        cfg = LlamaConfig.from_gguf(g)
        natively = load_params(g, cfg, dtype=torch.float32)
        monkeypatch.setattr(native, "_NATIVE_TYPES", frozenset())  # the numpy path, forced
        calls = []
        monkeypatch.setattr(reader, "dequantize", lambda d, n, t: calls.append(t) or quants.dequantize(d, n, t))
        by_numpy = load_params(g, cfg, dtype=torch.float32)
    assert set(calls) - {GGMLType.F32}  # the forced run decoded native kinds with numpy
    _assert_params_equal(natively, by_numpy)
