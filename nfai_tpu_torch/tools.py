"""Inspection / maintenance tools: the port's counterpart of the JAX
package's tools.py, on the port's own reader, writer, engine and eval.

    python -m nfai_tpu_torch.tools inspect model.gguf [--tensors] [--metadata]
    python -m nfai_tpu_torch.tools requantize in.gguf out.gguf --type q8_0
    python -m nfai_tpu_torch.tools validate model.gguf [--update] [--fixtures f.json]
    python -m nfai_tpu_torch.tools validate model.gguf --device cpu --dtype float32

`inspect` and `requantize` work on the file on the host (the reader decodes
through the native library). `validate` runs the model on the GPU by
default and raises if none is visible; `--device cpu` runs the plain
PyTorch versions of the kernels. Its fixtures file and content key are the
JAX tool's, so one file serves both packages. Its perplexity is scored in
float32 on the CPU, as the JAX tool scores it, and in bfloat16 on the card,
where the kernels take bfloat16: record a fixture on the device it is
checked on (a CPU fixture of either package passes the other's CPU run).

Where `requantize` differs from the JAX tool, on purpose: the JAX tool
writes every metadata float as FLOAT32 and infers every other type again,
so an INT32 array (llama.cpp's `tokenizer.ggml.token_type`) comes back
UINT32, a FLOAT64 value FLOAT32, and an array of integers that starts
non-negative and holds a negative one cannot be written; and it keeps
`general.file_type` although the tensors changed kind. The port writes
every value with the type it was read with, and sets `general.file_type`
(where the file has one) to the value llama.cpp infers for a file whose
weights are of the target kind. Where neither case arises the two tools
write the same bytes.
"""
from __future__ import annotations

import argparse
import json
import sys

# llama_ftype that llama.cpp's loader infers from a file's most common
# tensor kind (llama_model_loader: the K-quants as their "_M" mixes)
FILE_TYPE_OF = {"F32": 0, "F16": 1, "Q4_0": 2, "Q4_1": 3, "Q8_0": 7, "Q5_0": 8, "Q5_1": 9,
                "Q2_K": 10, "Q3_K": 12, "Q4_K": 15, "Q5_K": 17, "Q6_K": 18, "BF16": 32}


def cmd_inspect(args) -> int:
    from .gguf import GGUFFile

    with GGUFFile.open(args.path) as g:
        total_bytes = sum(d.nbytes for d in g.tensors.values())
        total_params = sum(d.n_elements for d in g.tensors.values())
        print(f"file:      {args.path}")
        print(f"version:   {g.version}")
        print(f"arch:      {g.architecture}")
        print(f"alignment: {g.alignment}")
        print(f"tensors:   {len(g.tensors)} ({total_params/1e9:.3f}B params, "
              f"{total_bytes/1e9:.2f} GB)")
        types = {}
        for d in g.tensors.values():
            types[d.ggml_type.name] = types.get(d.ggml_type.name, 0) + 1
        print(f"dtypes:    {types}")
        if args.metadata:
            for k, v in g.metadata.items():
                s = str(v)
                print(f"  {k} = {s[:100] + '…' if len(s) > 100 else s}")
        if args.tensors:
            for name, d in g.tensors.items():
                bpw = d.nbytes * 8 / d.n_elements
                print(
                    f"  {name:48s} {d.ggml_type.name:6s} {str(d.shape):20s}"
                    f" {d.nbytes/1e6:9.2f} MB ({bpw:.2f} bpw)"
                )
    return 0


def cmd_requantize(args) -> int:
    """Re-encode every 2-D weight tensor to the target quantization (the
    JAX tool's rule: last dim a multiple of 256 for a *_K target, else 32,
    and not a *_norm.weight); every other tensor is written as F32."""
    import numpy as np

    from .gguf import GGMLType, GGUFFile, GGUFWriter, Keys

    target = GGMLType[args.type.upper()]
    with GGUFFile.open(args.input) as g:
        w = GGUFWriter(alignment=g.alignment)
        for k, v in g.metadata.items():
            vtype, elem = g.metadata_types[k]
            if k == Keys.FILE_TYPE and target.name in FILE_TYPE_OF:
                v = FILE_TYPE_OF[target.name]
            w.add(k, v, vtype, elem)
        kept = requant = 0
        block = 256 if target.name.endswith("_K") else 32
        for name, d in g.tensors.items():
            data = g.tensor_f32(name)
            eligible = (
                len(d.shape) == 2
                and d.shape[-1] % block == 0
                and not name.endswith("_norm.weight")
            )
            if eligible:
                w.add_tensor(name, data, target)
                requant += 1
            else:
                w.add_tensor(name, data.astype(np.float32), GGMLType.F32)
                kept += 1
        w.write(args.output)
    print(f"wrote {args.output}: {requant} tensors -> {target.name}, {kept} kept dense")
    return 0


# fixed validation inputs (the JAX tool's): deterministic, model-agnostic,
# chosen so tiny synthetic checkpoints AND real instruction models both
# produce non-trivial continuations
_VALIDATE_PROMPTS = (
    "The capital of France is",
    "1 2 3 4 5 6 7 8",
    "import numpy as np\n",
)
_VALIDATE_CORPUS = (
    "The quick brown fox jumps over the lazy dog. "
    "Pack my box with five dozen liquor jugs. "
    "How vexingly quick daft zebras jump! "
    "Sphinx of black quartz, judge my vow. "
    "A shining crescent far beneath the flying vessel. "
) * 8


def _checkpoint_key(path: str) -> str:
    """Content key for a GGUF file: sha256 over (size, head 4 MB, tail 4 KB)
    — stable across renames, cheap on multi-GB files."""
    import hashlib
    import os

    h = hashlib.sha256()
    size = os.path.getsize(path)
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(4 << 20))
        f.seek(max(0, size - 4096))
        h.update(f.read(4096))
    return h.hexdigest()[:16]


def validation_record(eng, key: str, max_seq: int) -> dict:
    """The values `validate` records and checks, from a loaded engine:
    greedy first tokens of the fixed prompts, perplexity on the fixed corpus
    (float32 on the CPU, bfloat16 on the card) and a chat smoke."""
    import torch

    from .config import SamplingParams
    from .eval import perplexity
    from .runtime.engine import ChatSession

    record: dict = {"model": eng.model_name, "key": key}

    # 1) greedy first tokens (the sharpest cheap fingerprint of the whole
    # load/dequant/forward pipeline)
    firsts = []
    for prompt in _VALIDATE_PROMPTS:
        ids = eng.tokenizer.encode(prompt)[: max_seq // 2]
        toks = list(eng.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=8)))
        firsts.append(toks)
    record["greedy_tokens"] = firsts

    # 2) perplexity on the fixed corpus (teacher-forced)
    ids = eng.tokenizer.encode(_VALIDATE_CORPUS)
    window = min(128, max(16, len(ids) // 2))
    dtype = torch.float32 if eng.device.type == "cpu" else torch.bfloat16
    record["ppl"] = perplexity(eng.params, eng.model_cfg, ids, window=window, dtype=dtype)
    record["ppl_window"] = window

    # 3) chat smoke: template renders and the stream detokenizes
    sess = ChatSession(eng, SamplingParams(temperature=0.0, max_new_tokens=8))
    text = "".join(sess.stream("Hello!"))
    record["chat_smoke_chars"] = len(text)
    return record


def check_record(record: dict, fixtures_path: str, update: bool, ppl_tol: float) -> int:
    """Record (`update`) or check `record` against the fixtures file: 0 when
    recorded or matching, 2 when the checkpoint has no fixture, 1 when it
    differs."""
    import math
    import os

    key = record["key"]
    fixtures = {}
    if os.path.exists(fixtures_path):
        with open(fixtures_path, encoding="utf-8") as f:
            fixtures = json.load(f)
    print(json.dumps(record, indent=2))
    if update:
        fixtures[key] = record
        with open(fixtures_path, "w", encoding="utf-8") as f:
            json.dump(fixtures, f, indent=2, sort_keys=True)
        print(f"recorded fixtures[{key}] -> {fixtures_path}")
        return 0
    want = fixtures.get(key)
    if want is None:
        print(
            f"NO FIXTURE for checkpoint {key} in {fixtures_path}; run with "
            f"--update on a trusted setup first", file=sys.stderr,
        )
        return 2
    failures = []
    if want["greedy_tokens"] != record["greedy_tokens"]:
        failures.append("greedy first-token sequences diverge")
    rel = abs(record["ppl"] - want["ppl"]) / max(want["ppl"], 1e-9)
    if not math.isfinite(record["ppl"]) or rel > ppl_tol:
        failures.append(
            f"ppl {record['ppl']:.4f} vs expected {want['ppl']:.4f} "
            f"(rel {rel:.2%} > {ppl_tol:.2%})"
        )
    if record["chat_smoke_chars"] == 0:
        failures.append("chat smoke produced no text")
    if failures:
        for msg in failures:
            print(f"VALIDATE FAIL: {msg}", file=sys.stderr)
        return 1
    print(f"VALIDATE OK: checkpoint {key} matches recorded fixtures")
    return 0


def cmd_validate(args) -> int:
    """One-command checkpoint validation: greedy first-token goldens on
    fixed prompts, perplexity on a fixed corpus, and a chat smoke, compared
    against per-checkpoint values stored by content key in a fixtures JSON.
    Record once with --update on a trusted setup; every later environment
    or change validates with one command:

        python -m nfai_tpu_torch.tools validate model.gguf --update   # record
        python -m nfai_tpu_torch.tools validate model.gguf            # check
    """
    from .config import EngineConfig
    from .runtime.engine import InferenceEngine

    key = _checkpoint_key(args.path)
    eng = InferenceEngine(args.path, EngineConfig(max_seq_len=args.max_seq, dtype=args.dtype),
                          device=args.device)
    return check_record(validation_record(eng, key, args.max_seq), args.fixtures, args.update,
                        args.ppl_tol)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nfai_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("inspect", help="dump GGUF header/metadata/tensors")
    pi.add_argument("path")
    pi.add_argument("--tensors", action="store_true")
    pi.add_argument("--metadata", action="store_true")
    pi.set_defaults(fn=cmd_inspect)
    pr = sub.add_parser("requantize", help="re-encode weights to another type")
    pr.add_argument("input")
    pr.add_argument("output")
    pr.add_argument("--type", default="q8_0")
    pr.set_defaults(fn=cmd_requantize)
    pv = sub.add_parser(
        "validate",
        help="golden first-token + perplexity + chat smoke vs recorded fixtures "
             "(one-command checkpoint validation); perplexity in float32 on the CPU "
             "(as the JAX tool), bfloat16 on the card: check a fixture on the device "
             "it was recorded on",
    )
    pv.add_argument("path")
    pv.add_argument("--fixtures", default="validation_fixtures.json")
    pv.add_argument("--update", action="store_true",
                    help="record this checkpoint's values as the fixture")
    pv.add_argument("--max-seq", type=int, default=512)
    pv.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the GPU (default; raises without one) or the CPU's plain versions")
    pv.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="activation dtype (the CUDA kernels take bfloat16)")
    pv.add_argument("--ppl-tol", type=float, default=0.005,
                    help="relative perplexity tolerance (cross-machine "
                         "numeric drift)")
    pv.set_defaults(fn=cmd_validate)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
