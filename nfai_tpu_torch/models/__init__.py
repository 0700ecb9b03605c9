"""Model families: config, weight loading, forward passes, registry."""
from .llama import (  # noqa: F401
    KVCache,
    LlamaConfig,
    decode_loop,
    decode_step,
    forward,
    load_params,
    logits_for,
    paged_decode_loop,
    paged_prefill_step,
    params_from_jax,
    prefill_slot_step,
    prefill_step,
)
from .registry import resolve  # noqa: F401
