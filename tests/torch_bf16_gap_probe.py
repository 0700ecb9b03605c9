"""How far the port's fused-MLP route sits from the JAX package on generic
Q4_K blocks, and how much of that the JAX kernels' bf16 weight rounding
explains, as the weights' scale grows.

    JAX_PLATFORMS=cpu python tests/torch_bf16_gap_probe.py [d_scale ...]

For each `d_scale` of `random_q4k_bytes` (weight std ≈ 200 * d_scale) it
writes the "fused_generic" checkpoint of tests/test_torch_kinds.py (hidden
1024, 2 layers, ffn 1024), prefills the same prompt through the JAX engine
and the port (CPU, f32), then through the port with the JAX kernels' bf16
weight rounding put back (the witness), and prints one JSON line per scale:
max|a - b| / max|b| for port vs JAX, witness vs JAX and witness vs port.
"""
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nfai_tpu.config import EngineConfig as JEngineConfig  # noqa: E402
from nfai_tpu.runtime.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from nfai_tpu_torch.config import EngineConfig  # noqa: E402
from nfai_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from nfai_tpu_torch.testing import random_q4k_bytes  # noqa: E402

import test_torch_kinds as kinds  # noqa: E402


def gap(d_scale: float, tmp: str) -> dict:
    path = os.path.join(tmp, f"fused_generic_{d_scale:g}.gguf")
    kinds._write_fused_fixture(
        path, blocks=lambda rng, n, k: random_q4k_bytes(rng, n, k, d_scale=d_scale))
    je = JInferenceEngine(path, JEngineConfig(dtype="float32", max_seq_len=256))
    te = InferenceEngine(path, EngineConfig(dtype="float32", max_seq_len=256), device="cpu")
    ids = te.tokenizer.encode(kinds.PROMPT)
    jax_logits = np.asarray(je.prefill(je.new_cache(1), ids)[0])
    port = te.prefill(te.new_cache(1), ids)[0].numpy()
    saved = kinds.tqm.matmul_plain, kinds.tfm.fused_mlp_plain
    kinds.tqm.matmul_plain = kinds._jax_rounded_matmul
    kinds.tfm.fused_mlp_plain = kinds._jax_rounded_fused_mlp
    try:
        witness = te.prefill(te.new_cache(1), ids)[0].numpy()
    finally:
        kinds.tqm.matmul_plain, kinds.tfm.fused_mlp_plain = saved
    return {"d_scale": d_scale,
            "port_vs_jax": float(kinds.rel(port, jax_logits)),
            "witness_vs_jax": float(kinds.rel(witness, jax_logits)),
            "witness_vs_port": float(kinds.rel(witness, port))}


def main(argv: list[str]) -> None:
    scales = [float(a) for a in argv] or [3e-5, 1e-4, 1e-3, 1e-2]
    with tempfile.TemporaryDirectory() as tmp:
        for d in scales:
            print(json.dumps(gap(d, tmp)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
