"""Print two faults of the JAX package's BatchEngine that the port's avoids
(ROADMAP §3), on a tiny Q4_K llama (hidden 256, 2 layers, f32, 16-token
pages, chunks of 32):

1. dense mode: a 70-token prompt (3 prefill chunks) admitted while another
   slot decodes is decoded as an inactive lane at position 0 between its
   chunks, which overwrites its first K/V row; its greedy output then
   differs from single-request `generate`;
2. paged mode: `_grow_tables` allocates pages to a slot it has just
   preempted, and those pages are never released: refcounts stay above 0
   after every request finished.

Each line shows the JAX package's result beside the port's.

    JAX_PLATFORMS=cpu python tests/jax_scheduler_faults_probe.py
"""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nfai_tpu.config import EngineConfig as JEngineConfig  # noqa: E402
from nfai_tpu.config import SamplingParams as JSamplingParams  # noqa: E402
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from nfai_tpu.runtime.scheduler import BatchEngine as JBatchEngine  # noqa: E402
from nfai_tpu_torch.config import EngineConfig, SamplingParams  # noqa: E402
from nfai_tpu_torch.gguf import GGMLType  # noqa: E402
from nfai_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from nfai_tpu_torch.runtime.scheduler import BatchEngine  # noqa: E402
from nfai_tpu_torch.testing import make_tiny_llama_gguf  # noqa: E402

CONFIG = dict(max_seq_len=96, dtype="float32", prefill_chunk=32, page_size=16)


def prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(5, 200, n)] for n in lengths]


def drive(be):
    for _ in range(400):
        if be.step() == 0 and be.queue.empty() and not be._parked:
            return


def main():
    with tempfile.TemporaryDirectory() as d:
        path = make_tiny_llama_gguf(Path(d) / "tiny.gguf", hidden=256, n_layers=2, n_heads=4,
                                    n_kv_heads=2, ffn_dim=512, quant=GGMLType.Q4_K, tied=False,
                                    context_length=128)
        engines = {
            "jax": (JInferenceEngine(str(path), JEngineConfig(**CONFIG)), JBatchEngine, JSamplingParams),
            "port": (InferenceEngine(path, EngineConfig(**CONFIG), device="cpu"), BatchEngine,
                     SamplingParams),
        }
        for name, (eng, batch_engine, sampling) in engines.items():
            s = sampling(temperature=0.0, max_new_tokens=10)
            ps = prompts(1, (6, 11, 17, 9, 70))
            want = list(eng.generate(ps[4], s))
            be = batch_engine(eng, max_batch=4, decode_chunk=4, paged=False)
            reqs = [be.submit(p, s) for p in ps]
            drive(be)
            got = reqs[4].output_ids
            first_diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
            print(f"{name}: dense, 3-chunk prompt equals generate: {got == want} "
                  f"(first differing token: {first_diff})")

            s = sampling(temperature=0.0, max_new_tokens=24)
            be = batch_engine(eng, max_batch=2, decode_chunk=4, paged=True, pool_tokens=64)
            reqs = [be.submit(p, s) for p in prompts(10, (20, 20))]
            drive(be)
            states = [r.state.name for r in reqs]
            held = [int(p) for p in np.nonzero(be.alloc.refs[1:])[0] + 1]
            print(f"{name}: paged, starved pool: {states}; pages still referenced after all "
                  f"finished: {held}")


if __name__ == "__main__":
    main()
