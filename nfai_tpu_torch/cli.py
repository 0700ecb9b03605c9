"""Chat CLI: console REPL streaming assistant tokens.

Usage:
    python -m nfai_tpu_torch.cli --gguf model.gguf [--device cuda|cpu] ...
    echo "hello" | python -m nfai_tpu_torch.cli --gguf model.gguf   # piped mode
    python -m nfai_tpu_torch.cli --gguf model.gguf --mesh tp=2   # tensor parallel, one host
    python -m nfai_tpu_torch.cli --gguf model.gguf --mesh sp=2 --seq-parallel   # the cache split over S
    python -m nfai_tpu_torch.cli --gguf moe.gguf --mesh tp=2 --expert-parallel   # MoE experts split

Runs on the GPU by default and raises if none is visible; `--device cpu`
runs the plain PyTorch versions of the kernels.

With `--mesh` (e.g. ``tp=2`` or ``dp=2,tp=2``; an axis of any other name,
``tp=2,x=2``, replicates as in the JAX mesh, and the CLI's batch of one
replicates over dp) the engine is one rank of a mesh (parallel/). On one host this process becomes rank 0 and spawns the
other ranks itself; with NFAI_COORD / NFAI_NUM_PROCS / NFAI_PROC_ID set, it
is one rank of a launch the user started. Rank 0 reads the input and
broadcasts each line (and, while it waits, an idle beat every second, so
the other ranks' collectives never wait past their timeout); every rank runs
the same session, and rank 0 prints. `--seq-parallel` with an sp axis
(``--mesh sp=2``, or ``tp=2,sp=2``) splits the KV cache over its S axis
across the sp ranks (`EngineConfig.seq_parallel`); `--expert-parallel`
with ``--mesh tp=N`` splits a MoE model's experts over the tp ranks
(`EngineConfig.expert_parallel`); a MoE model under ``tp=N`` alone splits
its experts' ffn columns. Either flag without a mesh is refused, as the
engine refuses it.
"""
from __future__ import annotations

import argparse
import queue
import sys
import threading

from .config import EngineConfig, SamplingParams
from .parallel.distributed import join_local, start_world
from .runtime.engine import ChatSession, InferenceEngine

_IDLE, _EOF = ("idle",), ("eof",)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nfai_tpu_torch", description="GGUF chat on an NVIDIA GPU")
    p.add_argument("--gguf", required=True, help="path to the GGUF model file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--max-seq", type=int, default=512, help="KV cache length")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="activation dtype (the CUDA kernels take bfloat16)")
    p.add_argument("--temp", type=float, default=0.5)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--system", default="You are a helpful assistant.")
    p.add_argument("--metrics", action="store_true",
                   help="print TTFT / tokens-per-second after each reply")
    p.add_argument("--mesh", default="",
                   help="device mesh, e.g. 'tp=2', 'dp=2,tp=2' or 'tp=2,x=2' (an axis no split names "
                        "replicates; empty = single device)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="split the KV cache over its S axis on the mesh's sp axis (e.g. --mesh sp=2)")
    p.add_argument("--expert-parallel", action="store_true",
                   help="split a MoE model's experts over the mesh's tp axis (e.g. --mesh tp=2)")
    return p


def parse_mesh(spec: str) -> dict[str, int]:
    """'dp=2,tp=4' -> {"dp": 2, "tp": 4} (the JAX package's parse_mesh)."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    return out


def _input(interactive: bool):
    """The input lines: the prompt in a terminal, else piped stdin."""
    while True:
        if interactive:
            try:
                line = input("> ")
            except EOFError:
                return
        else:
            line = sys.stdin.readline()
            if not line:
                return
        yield line


def _lines(engine: InferenceEngine, interactive: bool):
    """The input lines, the same on every rank of a mesh: rank 0 reads them
    on a thread and broadcasts each, or an idle beat each second it waits."""
    comm = engine.comm
    if comm is None:
        yield from _input(interactive)
        return
    src: queue.Queue | None = None
    if comm.is_root:
        src = queue.Queue()

        def pump():
            for line in _input(interactive):
                src.put(line)
            src.put(_EOF)

        threading.Thread(target=pump, daemon=True).start()
    while True:
        item = None
        if src is not None:
            try:
                item = src.get(timeout=1.0)
            except queue.Empty:
                item = _IDLE
        item = comm.broadcast_object(item)
        if item == _EOF:
            return
        if item != _IDLE:
            yield item


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_arg_parser().parse_args(argv)
    mesh = parse_mesh(args.mesh)
    procs = start_world(mesh, "nfai_tpu_torch.cli:main", argv, args.device)
    try:
        engine = InferenceEngine(
            args.gguf,
            EngineConfig(
                gguf_path=args.gguf,
                max_seq_len=args.max_seq,
                dtype=args.dtype,
                system_prompt=args.system,
                mesh_shape=mesh,
                seq_parallel=args.seq_parallel,
                expert_parallel=args.expert_parallel,
            ),
            device=args.device,
        )
        root = engine.comm is None or engine.comm.is_root
        sampling = SamplingParams(
            temperature=args.temp,
            top_k=args.top_k,
            top_p=args.top_p,
            seed=args.seed,
            max_new_tokens=args.max_new_tokens,
        )
        session = ChatSession(engine, sampling)
        interactive = root and sys.stdin.isatty()
        if interactive:
            print(f"{engine.model_name} ready — type a message ('quit' to exit)")
        for line in _lines(engine, interactive):
            line = line.strip()
            if not line:
                continue
            if line.lower() in ("quit", "exit"):
                break
            for piece in session.stream(line):
                if root:
                    print(piece, end="", flush=True)
            if root:
                print()
            if args.metrics and root:
                m = session.last_metrics
                print(
                    f"[{m.prompt_tokens} prompt tok, {m.new_tokens} new | "
                    f"ttft {m.ttft_s*1000:.0f} ms | {m.decode_tokens_per_s:.1f} tok/s]",
                    file=sys.stderr,
                )
    finally:
        codes = join_local(procs) if procs else []
    if any(c != 0 for c in codes):
        print(f"ranks 1..{len(procs)} exited with {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
