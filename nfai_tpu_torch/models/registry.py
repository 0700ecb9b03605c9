"""Model factory registry: architecture sniffing → model family dispatch
(the JAX package's registry, with only the llama family ported)."""
from __future__ import annotations

from ..gguf import GGUFFile


class LlamaFamily:
    """Llama 3.x dense models (llama arch, 4-bit and 8-bit GGUF weights, tied or
    untied head)."""

    def config_from_gguf(self, g: GGUFFile):
        from .llama import LlamaConfig

        return LlamaConfig.from_gguf(g)

    def load_params(self, g: GGUFFile, cfg, **kw):
        from .llama import load_params

        return load_params(g, cfg, **kw)


def resolve(g: GGUFFile) -> LlamaFamily:
    """The family for a GGUF file; architectures not ported yet raise."""
    if g.architecture == "llama":
        return LlamaFamily()
    raise NotImplementedError(
        f"architecture {g.architecture!r} is not ported yet (this slice runs llama)"
    )
