"""Model factory registry: architecture sniffing → model family dispatch
(the JAX package's registry: every architecture of its LLAMA_LIKE_ARCHS,
the llama schema's llama, mistral, qwen2, qwen3, qwen3moe, gemma/gemma2/
gemma3 and phi3)."""
from __future__ import annotations

from ..gguf import GGUFFile


class LlamaFamily:
    """Llama 3.x and Mistral dense models, Qwen2 (q/k/v biases), Qwen3 (q/k
    norms, NEOX rope), Qwen3-MoE (routed experts), Gemma 1/2/3 (gelu,
    scaled embeddings, softcaps, sliding windows, post norms) and Phi-3
    (pre-fused attn_qkv and gate/up): 4-bit, 8-bit and dense GGUF weights,
    tied or untied head."""

    def config_from_gguf(self, g: GGUFFile):
        from .llama import LlamaConfig

        return LlamaConfig.from_gguf(g)

    def load_params(self, g: GGUFFile, cfg, **kw):
        from .llama import load_params

        return load_params(g, cfg, **kw)


def resolve(g: GGUFFile) -> LlamaFamily:
    """The family for a GGUF file; architectures not ported yet raise."""
    from .llama import ARCHS

    if g.architecture in ARCHS:
        return LlamaFamily()
    raise NotImplementedError(
        f"architecture {g.architecture!r} is not ported yet (the port runs {sorted(ARCHS)})"
    )
