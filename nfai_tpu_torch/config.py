"""Configuration dataclasses.

Parity target: ``NFAI.Models/ModelOptions.cs`` (GGUFPath + KVCacheSize=512) and
the hardcoded sampling defaults in ``SamplingUtils.cs:5`` (temperature 0.5,
top-k 40, top-p 0.95) — here everything is explicit and overridable.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SamplingParams:
    """Sampling configuration (reference defaults: SamplingUtils.cs:5-33)."""

    temperature: float = 0.5
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.0  # drop tokens with prob < min_p * max_prob
    presence_penalty: float = 0.0  # OpenAI-style, over output tokens
    frequency_penalty: float = 0.0
    logit_bias: tuple[tuple[int, float], ...] = ()  # (token_id, bias) pairs
    seed: int | None = None
    max_new_tokens: int = 512
    # OpenAI logprobs: None = off, 0 = chosen token only, 1..20 = also the
    # top-N alternatives per emitted token (from the un-tempered
    # distribution). Collected in GenerationMetrics.logprobs / the batch
    # Request.logprob_data.
    logprobs: int | None = None
    stop: tuple[str, ...] = ()  # stop strings (checked on the decoded text)
    # grammar-constrained decoding: None | "json" (OpenAI json_object mode)
    # | "json_schema" (set `json_schema` too). Constrained requests run
    # token-by-token (the vocab mask depends on every accepted token),
    # bypassing the fused decode chunks.
    response_format: str | None = None
    # structured-output extensions (see nfai_tpu_torch.grammar): a GBNF grammar
    # (llama.cpp format), a full-match regex, or a JSON Schema the output
    # must conform to. At most one of grammar/regex/json_schema applies;
    # any of them puts the request on the constrained path.
    grammar: str | None = None
    regex: str | None = None
    json_schema: dict | None = None

    @property
    def constrained(self) -> bool:
        return bool(
            self.response_format or self.grammar or self.regex
            or self.json_schema is not None
        )

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def has_penalties(self) -> bool:
        return bool(self.presence_penalty or self.frequency_penalty)

    @property
    def top_logprobs(self) -> int:
        """The alternatives a token's logprob record lists: `logprobs`
        clamped to 0..20 (0 when logprobs is off)."""
        return 0 if self.logprobs is None else max(0, min(int(self.logprobs), 20))


@dataclass(frozen=True)
class EngineConfig:
    """Engine/runtime configuration.

    `max_seq_len` mirrors the reference's KVCacheSize (default 512,
    ModelOptions.cs:7) but is a real ring-free bound: generation stops at it
    instead of silently overflowing (quirk ledger, SURVEY.md §7).
    """

    gguf_path: str = ""
    max_seq_len: int = 512
    max_batch_size: int = 1
    dtype: str = "bfloat16"  # activation dtype on TPU
    param_dtype: str = "auto"  # "auto" = keep quantized / native dtype
    page_size: int = 128  # KV cache page granularity
    prefill_chunk: int = 256  # prompt chunking bucket for jit shape stability
    decode_chunk: int = 32  # tokens generated per on-device fused decode call
    # speculative decoding (greedy and sampled requests): "off" | "ngram" |
    # "draft"; any other value is a ValueError at engine start.
    # "ngram" = prompt-lookup self-drafting (no draft model, drafts come
    # from the most recent n-gram match in the prompt + generated text);
    # "draft" = a second, smaller GGUF model proposes tokens (set
    # `draft_gguf`; its tokenizer/vocab must match the target's)
    speculative: str = "off"
    draft_gguf: str = ""  # path to the draft model (speculative="draft")
    spec_tokens: int = 8  # draft length gamma (one verify forward per draft)
    spec_ngram: int = 3  # n-gram length used for the lookup
    # draft->verify->accept rounds fused into ONE device dispatch
    # (models.llama.spec_decode_rounds): amortizes the per-dispatch latency
    # across `spec_rounds` verifies
    spec_rounds: int = 4
    # KV cache storage: "auto" (= activation dtype) | "int8" (per-token
    # per-head symmetric quantization — halves decode attention HBM
    # traffic and doubles cache capacity; the dense cache and the
    # BatchEngine's paged pool both store int8 codes and f32 scales)
    kv_dtype: str = "auto"
    # continuous batching (BatchEngine): paged KV pool with block tables and
    # prompt-prefix sharing; False = dense per-slot lanes (debug/compare)
    paged_kv: bool = True
    # KV pool capacity in tokens (paged only). None = max_batch x max_seq
    # (dense-equivalent); smaller pools trade capacity for HBM, relying on
    # prefix sharing + actual-length allocation
    kv_pool_tokens: int | None = None
    # mesh: axis name -> size; empty = single device
    mesh_shape: dict[str, int] = field(default_factory=dict)
    # sequence/context parallelism: shard the KV cache over its S axis on
    # the mesh's "sp" axis (mesh_shape={"sp": n}); decode attention
    # reassembles full-context softmax from per-shard flash partials
    # (parallel.seq_parallel). For contexts that outgrow one chip's HBM.
    seq_parallel: bool = False
    # expert parallelism: shard MoE expert stacks over their E axis on the
    # tp mesh axis (requires n_experts % tp == 0); per-chip compute is the
    # unchanged local grouped kernel + one psum (parallel.expert_parallel)
    expert_parallel: bool = False
    system_prompt: str = "You are a helpful assistant."

