"""Model factory registry: architecture sniffing → model family dispatch
(the JAX package's registry, with the llama schema's llama, qwen3,
qwen3moe and gemma/gemma2/gemma3 architectures ported)."""
from __future__ import annotations

from ..gguf import GGUFFile


class LlamaFamily:
    """Llama 3.x dense models, Qwen3 (q/k norms, NEOX rope), Qwen3-MoE
    (routed experts) and Gemma 1/2/3 (gelu, scaled embeddings, softcaps,
    sliding windows, post norms): 4-bit and 8-bit GGUF weights, tied or
    untied head."""

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
