"""Synthetic GGUF fixtures: the tiny test model, and writers for
checkpoints at published widths filled with random raw quantized blocks
(no quantizer runs over billions of floats).

`make_tiny_llama_gguf` is a copy of the JAX package's fixture (same bytes
for the same arguments: llama, mistral, qwen2 q/k/v biases, qwen3 q/k
norms, qwen3moe experts, phi3's pre-fused tensors, the gemma options: post
norms, sliding window, softcaps, the SPM vocabulary), plus `key_length`,
which the JAX fixture lacks, for a head_dim * n_heads other than hidden.
`make_llama_1b_gguf` writes the published Llama-3.2-1B shapes (hidden 2048,
32 heads / 8 kv heads, ffn 8192, vocab 128256, rope base 500000 with a
llama3 `rope_freqs` tensor) in one of these kinds: "q4_k" (untied, Q4_K
matmuls, F16 embedding), "q4_k_m" (the mix llama.cpp writes for Q4_K_M:
tied Q6_K table, Q6_K attn_v and ffn_down on the layers `use_more_bits`
picks, Q4_K elsewhere), "q8_0" (untied, Q8_0 throughout), "q4_0_tied"
(tied, Q4_0 throughout), "f16" (llama.cpp's f16 conversion: F16 matmul
weights and tied F16 token table, F32 norms) and "bf16" (the same in
BF16); or, with kind "llama_3b", the published
Llama-3.2-3B shapes (hidden 3072, 24 heads / 8 kv heads, head_dim 128, ffn
8192, 28 layers), tied Q4_K throughout; or, with kind "llama_8b_q8_0",
Llama-3.1-8B's (Meta-Llama-3.1-8B config.json: hidden 4096, 32 layers, 32
heads / 8 kv heads of head_dim 128, ffn 14336, vocab 128256, rope base
500000 with llama3 scaling of factor 8, low 1, high 4, original context
8192, untied) as llama.cpp's Q8_0 conversion writes it: every matmul
weight, the token table and an untied `output.weight` in Q8_0, F32 norms
and `rope_freqs`.
`make_qwen3moe_gguf` writes Qwen3-30B-A3B's published widths (hidden 2048,
32 / 4 heads of head_dim 128, 128 experts of which 8 are used, expert ffn
768, vocab 151936, rope base 1e6, rms eps 1e-6, untied) in the mix
llama.cpp writes for Q4_K_M, with a ChatML tokenizer. `n_layers` cuts
depth (16, 28 and 48 in the published configs).
`make_gemma2_2b_gguf` writes Gemma-2-2B's published widths (google/gemma-2-2b
config.json: hidden 2304, 26 layers, 8 / 4 heads of head_dim 256, ffn 9216,
vocab 256000, sliding window 4096, softcaps 50 / 30, rope base 1e4, tied
embeddings) in the Q4_K_M mix, with an SPM vocabulary of 256000 pieces and
Gemma's chat template; `make_gemma3_1b_gguf` Gemma-3-1B's
(google/gemma-3-1b-it config.json: hidden 1152, 4 / 1 heads of head_dim
256, ffn 6912, vocab 262144, window 512, rope 1e6 global and 1e4 local,
q/k norms), whose K = 1152 rows no k-quant can hold (K % 256 != 0): kind
"q4_0" puts Q4_0 there, kind "q4_k_m" the mix llama.cpp's Q4_K_M file of
Gemma-3-1B holds (its fallbacks: Q5_0 for Q4_K, Q8_0 for Q6_K).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .gguf import GGMLType, GGUFWriter
from .gguf.constants import Keys
from .ops.rope import compute_inv_freq
from .tokenizer.bpe import TokenType, bytes_to_unicode


LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eot_id|>")
CHATML_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
CHATML_TEMPLATE = (
    "{%- for message in messages %}"
    "{{- '<|im_start|>' + message['role'] + '\\n' + message['content'] + '<|im_end|>\\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|im_start|>assistant\\n' }}{%- endif %}"
)


def tiny_tokenizer_metadata(n_tokens: int | None = None, chatml: bool = False) -> dict:
    """A byte-level vocab (256 byte tokens + llama-3 specials), no merges:
    every string tokenizes (one token per byte). With `n_tokens` the vocab
    is padded to that size with filler tokens of three letters or digits
    (the id in base 62), which encoding never produces but which decode to
    visible text, so a model with a full-size vocab (the 1B-width fixtures)
    speaks in text, not in unknown ids. `chatml` takes Qwen's specials
    instead (<|endoftext|> as BOS, <|im_start|>, <|im_end|> as EOS, no BOS
    added), its "qwen2" pre-tokenizer and a ChatML chat template."""
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    types = [TokenType.NORMAL] * 256
    specials = CHATML_SPECIALS if chatml else LLAMA3_SPECIALS
    for s in specials:
        tokens.append(s)
        types.append(TokenType.CONTROL)
    digits = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    for i in range(len(tokens), n_tokens or 0):
        tokens.append(digits[i // 3844 % 62] + digits[i // 62 % 62] + digits[i % 62])
        types.append(TokenType.NORMAL)
    md = {
        Keys.TOKENIZER_MODEL: "gpt2",
        Keys.TOKENIZER_PRE: "qwen2" if chatml else "llama-bpe",
        Keys.TOKENIZER_TOKENS: tokens,
        Keys.TOKENIZER_TOKEN_TYPE: types,
        Keys.TOKENIZER_MERGES: [],
        Keys.TOKENIZER_BOS: tokens.index(specials[0]),
        Keys.TOKENIZER_EOS: tokens.index(specials[-1]),
    }
    if chatml:
        md[Keys.TOKENIZER_ADD_BOS] = False
        md[Keys.TOKENIZER_CHAT_TEMPLATE] = CHATML_TEMPLATE
    return md


SPM_SPECIALS = ("<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>", "<end_of_turn>")
GEMMA_TEMPLATE = (
    "{{- bos_token }}"
    "{%- for message in messages %}"
    "{%- set role = 'model' if message['role'] == 'assistant' else message['role'] %}"
    "{{- '<start_of_turn>' + role + '\n' + message['content'] | trim + '<end_of_turn>\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<start_of_turn>model\n' }}{%- endif %}"
)


def tiny_spm_tokenizer_metadata() -> dict:
    """SPM-style vocab: <unk>/<s>/</s> + 256 byte pieces (+ scores), so any
    string tokenizes via byte fallback (the JAX fixture's SPM vocabulary)."""
    pieces = ["<unk>", "<s>", "</s>"]
    types = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL]
    for b in range(256):
        pieces.append(f"<0x{b:02X}>")
        types.append(TokenType.BYTE)
    pieces.append("▁")
    types.append(TokenType.NORMAL)
    return {
        Keys.TOKENIZER_MODEL: "llama",
        Keys.TOKENIZER_TOKENS: pieces,
        "tokenizer.ggml.scores": [0.0] * len(pieces),
        Keys.TOKENIZER_TOKEN_TYPE: types,
        Keys.TOKENIZER_BOS: 1,
        Keys.TOKENIZER_EOS: 2,
        "tokenizer.ggml.unknown_token_id": 0,
    }


def spm_tokenizer_metadata(n_tokens: int, specials: tuple, *, unk: int, bos: int, eos: int,
                           template: str, pad: int | None = None, added: tuple = ()) -> dict:
    """An SPM vocabulary of `n_tokens` pieces: the `specials` (control
    pieces, the one at `unk` the unknown piece), the 256 byte pieces and
    "▁", filler pieces of four letters or digits (the id in base 62) that
    decode to visible text, then the `added` control pieces at the end;
    there are no two-character pieces, so every string falls back to byte
    pieces and encoding never merges. BOS is added; the chat template is
    `template`."""
    pieces, types = list(specials), [TokenType.CONTROL] * len(specials)
    types[unk] = TokenType.UNKNOWN
    for b in range(256):
        pieces.append(f"<0x{b:02X}>")
        types.append(TokenType.BYTE)
    pieces.append("▁")
    types.append(TokenType.NORMAL)
    digits = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    for i in range(len(pieces), n_tokens - len(added)):
        pieces.append("".join(digits[i // 62**p % 62] for p in (3, 2, 1, 0)))
        types.append(TokenType.NORMAL)
    pieces += added
    types += [TokenType.CONTROL] * len(added)
    md = {
        Keys.TOKENIZER_MODEL: "llama",
        Keys.TOKENIZER_TOKENS: pieces,
        "tokenizer.ggml.scores": [0.0] * len(pieces),
        Keys.TOKENIZER_TOKEN_TYPE: types,
        Keys.TOKENIZER_BOS: bos,
        Keys.TOKENIZER_EOS: eos,
    }
    if pad is not None:
        md[Keys.TOKENIZER_PAD] = pad
    md["tokenizer.ggml.unknown_token_id"] = unk
    md[Keys.TOKENIZER_ADD_BOS] = True
    md[Keys.TOKENIZER_CHAT_TEMPLATE] = template
    return md


def gemma_spm_tokenizer_metadata(n_tokens: int) -> dict:
    """A Gemma-style SPM vocabulary of `n_tokens` pieces: <pad> <eos> <bos>
    <unk> (ids 0-3, as in Gemma's), <start_of_turn> and <end_of_turn>
    (control pieces: <end_of_turn> ends generation), the 256 byte pieces and
    "▁", then filler pieces (`spm_tokenizer_metadata`). With Gemma's chat
    template."""
    return spm_tokenizer_metadata(n_tokens, SPM_SPECIALS, unk=3, bos=2, eos=1, pad=0,
                                  template=GEMMA_TEMPLATE)


# Mistral-7B-v0.3's control pieces (ids 0-4 of its 32768) and its [INST] template
MISTRAL_SPECIALS = ("<unk>", "<s>", "</s>", "[INST]", "[/INST]")
MISTRAL_TEMPLATE = (
    "{{- bos_token }}"
    "{%- for message in messages %}"
    "{%- if message['role'] in ('user', 'system') %}{{- '[INST] ' + message['content'] + ' [/INST]' }}"
    "{%- else %}{{- message['content'] + eos_token }}{%- endif %}"
    "{%- endfor %}"
)
# Phi-3-mini's llama-2 pieces 0-2 and its added tokens 32000-32010 (the
# vocabulary padded to 32064 with placeholders); <|end|> ends a turn
PHI3_ADDED = ("<|endoftext|>", "<|assistant|>", "<|placeholder1|>", "<|placeholder2|>",
              "<|placeholder3|>", "<|placeholder4|>", "<|system|>", "<|end|>", "<|placeholder5|>",
              "<|placeholder6|>", "<|user|>")
PHI3_TEMPLATE = (
    "{%- for message in messages %}"
    "{{- '<|' + message['role'] + '|>\n' + message['content'] + '<|end|>\n' }}"
    "{%- endfor %}"
    "{%- if add_generation_prompt %}{{- '<|assistant|>\n' }}{%- endif %}"
)


def _header(w: GGUFWriter, arch: str, name: str, *, context_length: int,
            hidden: int, n_layers: int, ffn_dim: int, n_heads: int,
            n_kv_heads: int, rope_base: float, vocab_size: int,
            tok_md: dict, rms_eps: float = 1e-5, extra: dict | None = None) -> None:
    """The JAX fixture's key order; `extra` ({key: value}, keys without the
    arch prefix) goes before the tokenizer."""
    w.add(Keys.ARCHITECTURE, arch)
    w.add(Keys.NAME, name)
    w.add(f"{arch}.context_length", context_length)
    w.add(f"{arch}.embedding_length", hidden)
    w.add(f"{arch}.block_count", n_layers)
    w.add(f"{arch}.feed_forward_length", ffn_dim)
    w.add(f"{arch}.attention.head_count", n_heads)
    w.add(f"{arch}.attention.head_count_kv", n_kv_heads)
    w.add(f"{arch}.attention.layer_norm_rms_epsilon", rms_eps)
    w.add(f"{arch}.rope.freq_base", rope_base)
    w.add(f"{arch}.vocab_size", vocab_size)
    for k, v in (extra or {}).items():
        w.add(f"{arch}.{k}", v)
    for k, v in tok_md.items():
        w.add(k, v)


def make_tiny_llama_gguf(
    path: str | Path,
    *,
    arch: str = "llama",
    vocab_size: int | None = None,
    hidden: int = 64,
    n_layers: int = 2,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    ffn_dim: int = 128,
    context_length: int = 256,
    rope_base: float = 10000.0,
    quant: GGMLType = GGMLType.F32,
    tied: bool = True,
    attn_bias: bool = False,  # qwen2-style q/k/v biases
    qk_norm: bool = False,  # qwen3-style per-head q/k norms
    fused_tensors: bool = False,  # phi3-style: attn_qkv + a [gate; up] ffn_up
    spm_tokenizer: bool = False,  # llama-2/gemma-style SPM vocab instead of BPE
    n_experts: int = 0,  # qwen3moe-style MoE FFN
    n_experts_used: int = 0,
    post_norms: bool = False,  # gemma2/3 post_attention/post_ffw norms
    sliding_window: int = 0,  # gemma2/3 {arch}.attention.sliding_window
    attn_softcap: float = 0.0,  # gemma2 softcaps
    final_softcap: float = 0.0,
    key_length: int | None = None,  # head_dim (written as attention.key_length)
    seed: int = 0,
    scale: float = 0.05,
    rope_freqs: np.ndarray | None = None,
    quant_overrides: dict | None = None,  # tensor name -> GGMLType
) -> Path:
    """Write a random-weight llama-schema GGUF (the JAX package's fixture;
    with `key_length`, head_dim = key_length instead of hidden // n_heads)."""
    rng = np.random.default_rng(seed)
    tok_md = tiny_spm_tokenizer_metadata() if spm_tokenizer else tiny_tokenizer_metadata()
    if vocab_size is None:
        n_tok = len(tok_md[Keys.TOKENIZER_TOKENS])
        vocab_size = (n_tok + 7) // 8 * 8
    head_dim = key_length or hidden // n_heads
    w = GGUFWriter()
    extra = {}  # in the JAX fixture's key order
    if sliding_window:
        extra["attention.sliding_window"] = sliding_window
    if attn_softcap:
        extra["attn_logit_softcapping"] = attn_softcap
    if final_softcap:
        extra["final_logit_softcapping"] = final_softcap
    if n_experts:
        extra.update({"expert_count": n_experts, "expert_used_count": n_experts_used or 2,
                      "expert_feed_forward_length": ffn_dim})
    if key_length:
        extra.update({"attention.key_length": key_length, "attention.value_length": key_length})
    _header(w, arch, f"tiny-{arch}-test", context_length=context_length,
            hidden=hidden, n_layers=n_layers, ffn_dim=ffn_dim, n_heads=n_heads,
            n_kv_heads=n_kv_heads, rope_base=rope_base, vocab_size=vocab_size,
            tok_md=tok_md, extra=extra)

    def rand(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def addw(name, arr, q=quant):
        if quant_overrides and name in quant_overrides:
            q = quant_overrides[name]
        w.add_tensor(name, arr, q)

    addw("token_embd.weight", rand(vocab_size, hidden))
    if rope_freqs is not None:
        addw("rope_freqs.weight", rope_freqs.astype(np.float32), GGMLType.F32)
    for i in range(n_layers):
        addw(f"blk.{i}.attn_norm.weight", np.ones(hidden, np.float32), GGMLType.F32)
        if fused_tensors:
            addw(f"blk.{i}.attn_qkv.weight", rand((n_heads + 2 * n_kv_heads) * head_dim, hidden))
        else:
            addw(f"blk.{i}.attn_q.weight", rand(n_heads * head_dim, hidden))
            addw(f"blk.{i}.attn_k.weight", rand(n_kv_heads * head_dim, hidden))
            addw(f"blk.{i}.attn_v.weight", rand(n_kv_heads * head_dim, hidden))
        addw(f"blk.{i}.attn_output.weight", rand(hidden, n_heads * head_dim))
        if attn_bias:
            addw(f"blk.{i}.attn_q.bias", rand(n_heads * head_dim), GGMLType.F32)
            addw(f"blk.{i}.attn_k.bias", rand(n_kv_heads * head_dim), GGMLType.F32)
            addw(f"blk.{i}.attn_v.bias", rand(n_kv_heads * head_dim), GGMLType.F32)
        if qk_norm:
            addw(f"blk.{i}.attn_q_norm.weight", 1.0 + rand(head_dim), GGMLType.F32)
            addw(f"blk.{i}.attn_k_norm.weight", 1.0 + rand(head_dim), GGMLType.F32)
        if post_norms:
            addw(f"blk.{i}.post_attention_norm.weight", (1.0 + rand(hidden)).astype(np.float32),
                 GGMLType.F32)
            addw(f"blk.{i}.post_ffw_norm.weight", (1.0 + rand(hidden)).astype(np.float32),
                 GGMLType.F32)
        addw(f"blk.{i}.ffn_norm.weight", np.ones(hidden, np.float32), GGMLType.F32)
        if n_experts:
            addw(f"blk.{i}.ffn_gate_inp.weight", rand(n_experts, hidden), GGMLType.F32)
            addw(f"blk.{i}.ffn_gate_exps.weight", rand(n_experts, ffn_dim, hidden))
            addw(f"blk.{i}.ffn_up_exps.weight", rand(n_experts, ffn_dim, hidden))
            addw(f"blk.{i}.ffn_down_exps.weight", rand(n_experts, hidden, ffn_dim))
        else:
            if fused_tensors:
                addw(f"blk.{i}.ffn_up.weight", rand(2 * ffn_dim, hidden))
            else:
                addw(f"blk.{i}.ffn_gate.weight", rand(ffn_dim, hidden))
                addw(f"blk.{i}.ffn_up.weight", rand(ffn_dim, hidden))
            addw(f"blk.{i}.ffn_down.weight", rand(hidden, ffn_dim))
    addw("output_norm.weight", np.ones(hidden, np.float32), GGMLType.F32)
    if not tied:
        addw("output.weight", rand(vocab_size, hidden))
    return w.write(path)


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's choice of the layers whose attn_v and ffn_down a Q4_K_M
    file keeps in Q6_K (src/llama-quant.cpp, llama_tensor_get_type):
    the first and last eighth, and every third layer between."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


# Llama-3.2-1B and -3B (published config.json): widths, heads, vocab, rope
LLAMA_1B = dict(
    hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192,
    vocab_size=128256, rope_base=500000.0, context_length=131072,
    rope_factor=32.0, rope_low=1.0, rope_high=4.0, rope_orig_ctx=8192,
)
LLAMA_3B = dict(LLAMA_1B, hidden=3072, n_layers=28, n_heads=24, n_kv_heads=8)
# Meta-Llama-3.1-8B (published config.json)
LLAMA_3_1_8B = dict(LLAMA_1B, hidden=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                    ffn_dim=14336, rope_factor=8.0)
# Qwen3-30B-A3B (published config.json; llama.cpp's qwen3moe GGUF keys)
QWEN3_30B_A3B = dict(
    hidden=2048, n_layers=48, n_heads=32, n_kv_heads=4, head_dim=128, ffn_dim=6144,
    n_experts=128, n_experts_used=8, moe_ffn_dim=768, vocab_size=151936,
    rope_base=1e6, rms_eps=1e-6, context_length=40960,
)
# Qwen/Qwen2.5-1.5B, microsoft/Phi-3-mini-4k-instruct and
# mistralai/Mistral-7B-v0.3 (published config.json)
QWEN2_5_1_5B = dict(
    hidden=1536, n_layers=28, n_heads=12, n_kv_heads=2, ffn_dim=8960, vocab_size=151936,
    rope_base=1e6, rms_eps=1e-6, context_length=32768,
)
PHI3_MINI_4K = dict(
    hidden=3072, n_layers=32, n_heads=32, n_kv_heads=32, ffn_dim=8192, vocab_size=32064,
    rope_base=1e4, rms_eps=1e-5, context_length=4096,
)
MISTRAL_7B_V0_3 = dict(
    hidden=4096, n_layers=32, n_heads=32, n_kv_heads=8, ffn_dim=14336, vocab_size=32768,
    rope_base=1e6, rms_eps=1e-5, context_length=32768,
)
# google/gemma-2-2b and google/gemma-3-1b-it (published config.json)
GEMMA2_2B = dict(
    hidden=2304, n_layers=26, n_heads=8, n_kv_heads=4, head_dim=256, ffn_dim=9216,
    vocab_size=256000, rope_base=1e4, rms_eps=1e-6, context_length=8192,
    sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
)
GEMMA3_1B = dict(
    hidden=1152, n_layers=26, n_heads=4, n_kv_heads=1, head_dim=256, ffn_dim=6912,
    vocab_size=262144, rope_base=1e6, rms_eps=1e-6, context_length=32768,
    sliding_window=512,
)


def random_q4k_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                     d_scale: float = 1e-4) -> np.ndarray:
    """Raw Q4_K payload for an (n_out, k_in) tensor: random scale and nibble
    bytes, small finite f16 d/dmin (dmin ≈ 7.5 d keeps the weights roughly
    centred, std ≈ 200 d)."""
    nb = n_out * k_in // 256
    blocks = np.frombuffer(rng.bytes(nb * 144), np.uint8).reshape(nb, 144).copy()
    d = (rng.uniform(0.5, 1.5, nb) * d_scale).astype(np.float16)
    blocks[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    blocks[:, 2:4] = (d.astype(np.float32) * 7.5).astype(np.float16).view(np.uint8).reshape(nb, 2)
    return blocks.reshape(-1)


def _f16_bytes(rng: np.random.Generator, nb: int, d_scale: float) -> np.ndarray:
    d = (rng.uniform(0.5, 1.5, nb) * d_scale).astype(np.float16)
    return d.view(np.uint8).reshape(nb, 2)


def random_q6k_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                     d_scale: float = 1e-4) -> np.ndarray:
    """Raw Q6_K payload: random 6-bit values, int8 sub-block scales in
    [-15, 15], finite f16 d (weight std ≈ 170 d)."""
    nb = n_out * k_in // 256
    blocks = np.frombuffer(rng.bytes(nb * 210), np.uint8).reshape(nb, 210).copy()
    blocks[:, 192:208] = rng.integers(-15, 16, (nb, 16)).astype(np.int8).view(np.uint8)
    blocks[:, 208:210] = _f16_bytes(rng, nb, d_scale)
    return blocks.reshape(-1)


def random_q5k_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                     d_scale: float = 7e-5) -> np.ndarray:
    """Raw Q5_K payload: random 6-bit scales and mins, 5-bit values (high
    bits in qh), small finite f16 d/dmin (dmin = 15.5 d keeps the weights
    roughly centred)."""
    nb = n_out * k_in // 256
    blocks = np.frombuffer(rng.bytes(nb * 176), np.uint8).reshape(nb, 176).copy()
    d = (rng.uniform(0.5, 1.5, nb) * d_scale).astype(np.float16)
    blocks[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    blocks[:, 2:4] = (d.astype(np.float32) * 15.5).astype(np.float16).view(np.uint8).reshape(nb, 2)
    return blocks.reshape(-1)


def random_q8_0_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                      d_scale: float = 2.7e-4) -> np.ndarray:
    """Raw Q8_0 payload: random int8 values, finite f16 d (std ≈ 74 d)."""
    nb = n_out * k_in // 32
    blocks = np.frombuffer(rng.bytes(nb * 34), np.uint8).reshape(nb, 34).copy()
    blocks[:, 0:2] = _f16_bytes(rng, nb, d_scale)
    return blocks.reshape(-1)


def random_q4_0_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                      d_scale: float = 4e-3) -> np.ndarray:
    """Raw Q4_0 payload: random nibbles, finite f16 d (std ≈ 4.6 d)."""
    nb = n_out * k_in // 32
    blocks = np.frombuffer(rng.bytes(nb * 18), np.uint8).reshape(nb, 18).copy()
    blocks[:, 0:2] = _f16_bytes(rng, nb, d_scale)
    return blocks.reshape(-1)


def random_q5_0_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                      d_scale: float = 2e-3) -> np.ndarray:
    """Raw Q5_0 payload: random 5-bit values (high bits in qh), finite f16
    d (std ≈ 9.2 d)."""
    nb = n_out * k_in // 32
    blocks = np.frombuffer(rng.bytes(nb * 22), np.uint8).reshape(nb, 22).copy()
    blocks[:, 0:2] = _f16_bytes(rng, nb, d_scale)
    return blocks.reshape(-1)


def random_float_bytes(rng: np.random.Generator, n_out: int, k_in: int,
                       kind: GGMLType = GGMLType.F16) -> np.ndarray:
    """Raw F16 or BF16 payload of random values from random bits (no float
    math over billions of weights): a random sign and mantissa, an exponent
    drawn from four values, so |w| lies in [2^-8, 2^-4) (std ≈ 0.027)."""
    n = n_out * k_in
    bits = np.frombuffer(rng.bytes(2 * n), np.uint16).copy()
    if kind == GGMLType.F16:  # 1 sign, 5 exponent (bias 15), 10 mantissa bits
        bits = (bits & 0x83FF) | ((7 + ((bits >> 10) & 3)) << 10).astype(np.uint16)
    elif kind == GGMLType.BF16:  # 1 sign, 8 exponent (bias 127), 7 mantissa bits
        bits = (bits & 0x807F) | ((119 + ((bits >> 7) & 3)) << 7).astype(np.uint16)
    else:
        raise ValueError(f"random_float_bytes writes F16 or BF16, not {kind.name}")
    return bits.view(np.uint8)


_RANDOM_BLOCKS = {
    GGMLType.Q4_K: random_q4k_bytes,
    GGMLType.Q5_K: random_q5k_bytes,
    GGMLType.Q6_K: random_q6k_bytes,
    GGMLType.Q8_0: random_q8_0_bytes,
    GGMLType.Q4_0: random_q4_0_bytes,
    GGMLType.Q5_0: random_q5_0_bytes,
    GGMLType.F16: lambda rng, n, k: random_float_bytes(rng, n, k, GGMLType.F16),
    GGMLType.BF16: lambda rng, n, k: random_float_bytes(rng, n, k, GGMLType.BF16),
}
LLAMA_1B_KINDS = ("q4_k", "q4_k_m", "q8_0", "q4_0_tied", "f16", "bf16", "llama_3b",
                  "llama_8b_q8_0")
_WIDTHS = {"llama_3b": (LLAMA_3B, "3.2-3b"), "llama_8b_q8_0": (LLAMA_3_1_8B, "3.1-8b")}


def _shape_only(*shape):  # add_tensor reads only the shape next to raw bytes
    return np.broadcast_to(np.zeros((), np.float32), shape)


def make_llama_1b_gguf(path: str | Path, *, kind: str = "q4_k",
                       n_layers: int | None = None, seed: int = 0) -> Path:
    """Write a Llama-3.2-1B-width GGUF of `kind` (see module doc; "llama_3b"
    is the 3B widths, "llama_8b_q8_0" the 3.1-8B's) with random raw blocks
    (~0.9-1.7 GB at full depth; 2.5 GB for "f16" and "bf16"; the 8B 8.5 GB,
    1.58 GB at 2 layers and 2.97 GB at 8).
    Weights are random: the model is for speed and kernel checks, not for
    text."""
    if kind not in LLAMA_1B_KINDS:
        raise ValueError(f"kind must be one of {LLAMA_1B_KINDS}, got {kind!r}")
    widths, width = _WIDTHS.get(kind, (LLAMA_1B, "3.2-1b"))
    c = dict(widths)
    if n_layers is not None:
        c["n_layers"] = n_layers
    rng = np.random.default_rng(seed)
    h, f, v, nl = c["hidden"], c["ffn_dim"], c["vocab_size"], c["n_layers"]
    hd = h // c["n_heads"]
    qd, kvd = c["n_heads"] * hd, c["n_kv_heads"] * hd
    w = GGUFWriter()
    _header(w, "llama", f"llama-{width}-width-random-{kind}",
            context_length=c["context_length"], hidden=h, n_layers=nl,
            ffn_dim=f, n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
            rope_base=c["rope_base"], vocab_size=v, tok_md=tiny_tokenizer_metadata(v))
    base = {"q4_k": GGMLType.Q4_K, "q4_k_m": GGMLType.Q4_K, "llama_3b": GGMLType.Q4_K,
            "q8_0": GGMLType.Q8_0, "q4_0_tied": GGMLType.Q4_0, "f16": GGMLType.F16,
            "bf16": GGMLType.BF16, "llama_8b_q8_0": GGMLType.Q8_0}[kind]
    tied = kind in ("q4_k_m", "q4_0_tied", "f16", "bf16", "llama_3b")

    def quant(name, n_out, k_in, q=base):
        w.add_tensor(name, _shape_only(n_out, k_in), q,
                     raw_bytes=_RANDOM_BLOCKS[q](rng, n_out, k_in))

    if kind == "q4_k":
        embed = (rng.standard_normal((v, h), dtype=np.float32) * 0.02).astype(np.float16)
        w.add_tensor("token_embd.weight", _shape_only(v, h), GGMLType.F16,
                     raw_bytes=embed.view(np.uint8).reshape(-1))
    else:
        quant("token_embd.weight", v, h, GGMLType.Q6_K if kind == "q4_k_m" else base)
    # llama.cpp stores llama3 rope scaling as per-dim frequency divisors
    base_inv = 1.0 / (c["rope_base"] ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    scaled = compute_inv_freq(hd, c["rope_base"], "llama3", c["rope_factor"],
                              c["rope_low"], c["rope_high"], c["rope_orig_ctx"])
    w.add_tensor("rope_freqs.weight", (base_inv / scaled).astype(np.float32), GGMLType.F32)
    for i in range(nl):
        more = GGMLType.Q6_K if kind == "q4_k_m" and use_more_bits(i, nl) else base
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(h, np.float32), GGMLType.F32)
        quant(f"blk.{i}.attn_q.weight", qd, h)
        quant(f"blk.{i}.attn_k.weight", kvd, h)
        quant(f"blk.{i}.attn_v.weight", kvd, h, more)
        quant(f"blk.{i}.attn_output.weight", h, qd)
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(h, np.float32), GGMLType.F32)
        quant(f"blk.{i}.ffn_gate.weight", f, h)
        quant(f"blk.{i}.ffn_up.weight", f, h)
        quant(f"blk.{i}.ffn_down.weight", h, f, more)
    w.add_tensor("output_norm.weight", np.ones(h, np.float32), GGMLType.F32)
    if not tied:
        quant("output.weight", v, h)
    return w.write(path)


def make_qwen3moe_gguf(path: str | Path, *, n_layers: int = 8, seed: int = 0) -> Path:
    """Write a Qwen3-30B-A3B-width qwen3moe GGUF (see module doc) with
    random raw blocks in the Q4_K_M mix: Q4_K base (token table, q/k/o, the
    gate and up experts), Q6_K output.weight, Q6_K attn_v and ffn_down_exps
    on the layers `use_more_bits` picks, an F32 router (std 0.02: router
    logits of std ≈ 1) and F32 q/k norms near 1. Experts are contiguous in
    each [E, N, K] tensor, K fastest. ~3.4 GB at 8 layers."""
    c = dict(QWEN3_30B_A3B, n_layers=n_layers)
    rng = np.random.default_rng(seed)
    h, v, hd, e, fe = c["hidden"], c["vocab_size"], c["head_dim"], c["n_experts"], c["moe_ffn_dim"]
    qd, kvd = c["n_heads"] * hd, c["n_kv_heads"] * hd
    w = GGUFWriter()
    _header(w, "qwen3moe", "qwen3-30b-a3b-width-random-q4_k_m",
            context_length=c["context_length"], hidden=h, n_layers=n_layers,
            ffn_dim=c["ffn_dim"], n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
            rope_base=c["rope_base"], vocab_size=v, rms_eps=c["rms_eps"],
            tok_md=tiny_tokenizer_metadata(v, chatml=True),
            extra={"attention.key_length": hd, "attention.value_length": hd,
                   "expert_count": e, "expert_used_count": c["n_experts_used"],
                   "expert_feed_forward_length": fe})

    def quant(name, q, *shape):  # shape (..., N, K); experts are E * N rows
        w.add_tensor(name, _shape_only(*shape), q,
                     raw_bytes=_RANDOM_BLOCKS[q](rng, int(np.prod(shape[:-1])), shape[-1]))

    def f32(name, arr):
        w.add_tensor(name, np.asarray(arr, np.float32), GGMLType.F32)

    quant("token_embd.weight", GGMLType.Q4_K, v, h)
    for i in range(n_layers):
        more = GGMLType.Q6_K if use_more_bits(i, n_layers) else GGMLType.Q4_K
        f32(f"blk.{i}.attn_norm.weight", np.ones(h))
        quant(f"blk.{i}.attn_q.weight", GGMLType.Q4_K, qd, h)
        quant(f"blk.{i}.attn_k.weight", GGMLType.Q4_K, kvd, h)
        quant(f"blk.{i}.attn_v.weight", more, kvd, h)
        quant(f"blk.{i}.attn_output.weight", GGMLType.Q4_K, h, qd)
        f32(f"blk.{i}.attn_q_norm.weight", rng.uniform(0.9, 1.1, hd))
        f32(f"blk.{i}.attn_k_norm.weight", rng.uniform(0.9, 1.1, hd))
        f32(f"blk.{i}.ffn_norm.weight", np.ones(h))
        f32(f"blk.{i}.ffn_gate_inp.weight", rng.standard_normal((e, h), np.float32) * 0.02)
        quant(f"blk.{i}.ffn_gate_exps.weight", GGMLType.Q4_K, e, fe, h)
        quant(f"blk.{i}.ffn_up_exps.weight", GGMLType.Q4_K, e, fe, h)
        quant(f"blk.{i}.ffn_down_exps.weight", more, e, h, fe)
    f32("output_norm.weight", np.ones(h))
    quant("output.weight", GGMLType.Q6_K, v, h)
    return w.write(path)


def _gemma_gguf(path, arch: str, c: dict, name: str, kind, seed: int) -> Path:
    """A random-block gemma2/gemma3 GGUF of the widths in `c`; `kind(name,
    layer, n_out, k_in)` picks each matmul tensor's GGMLType (the tied token
    table is asked for with layer -1)."""
    rng = np.random.default_rng(seed)
    h, v, hd, nl = c["hidden"], c["vocab_size"], c["head_dim"], c["n_layers"]
    qd, kvd, f = c["n_heads"] * hd, c["n_kv_heads"] * hd, c["ffn_dim"]
    extra = {"attention.key_length": hd, "attention.value_length": hd,
             "attention.sliding_window": c["sliding_window"]}
    if c.get("attn_softcap"):
        extra.update(attn_logit_softcapping=c["attn_softcap"],
                     final_logit_softcapping=c["final_softcap"])
    w = GGUFWriter()
    _header(w, arch, name, context_length=c["context_length"], hidden=h, n_layers=nl,
            ffn_dim=f, n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
            rope_base=c["rope_base"], vocab_size=v, rms_eps=c["rms_eps"],
            tok_md=gemma_spm_tokenizer_metadata(v), extra=extra)

    def quant(tname, layer, n_out, k_in):
        q = kind(tname, layer, n_out, k_in)
        w.add_tensor(tname, _shape_only(n_out, k_in), q, raw_bytes=_RANDOM_BLOCKS[q](rng, n_out, k_in))

    def norm(tname, n):  # GGUF gemma norms carry the +1: weights near 1
        w.add_tensor(tname, rng.uniform(0.9, 1.1, n).astype(np.float32), GGMLType.F32)

    quant("token_embd.weight", -1, v, h)
    for i in range(nl):
        norm(f"blk.{i}.attn_norm.weight", h)
        quant(f"blk.{i}.attn_q.weight", i, qd, h)
        quant(f"blk.{i}.attn_k.weight", i, kvd, h)
        quant(f"blk.{i}.attn_v.weight", i, kvd, h)
        quant(f"blk.{i}.attn_output.weight", i, h, qd)
        if arch == "gemma3":
            norm(f"blk.{i}.attn_q_norm.weight", hd)
            norm(f"blk.{i}.attn_k_norm.weight", hd)
        norm(f"blk.{i}.post_attention_norm.weight", h)
        norm(f"blk.{i}.ffn_norm.weight", h)
        quant(f"blk.{i}.ffn_gate.weight", i, f, h)
        quant(f"blk.{i}.ffn_up.weight", i, f, h)
        quant(f"blk.{i}.ffn_down.weight", i, h, f)
        norm(f"blk.{i}.post_ffw_norm.weight", h)
    norm("output_norm.weight", h)
    return w.write(path)


def make_gemma2_2b_gguf(path: str | Path, *, n_layers: int | None = None, seed: int = 0) -> Path:
    """Write a Gemma-2-2B-width gemma2 GGUF (see module doc) in the Q4_K_M
    mix llama.cpp writes: tied Q6_K token table, Q6_K attn_v and ffn_down
    on the layers `use_more_bits` picks, Q4_K elsewhere; F32 norms near 1.
    ~1.8 GB at the full 26 layers."""
    c = dict(GEMMA2_2B)
    if n_layers is not None:
        c["n_layers"] = n_layers
    nl = c["n_layers"]

    def kind(name, layer, n_out, k_in):
        if layer < 0 or (name.endswith(("attn_v.weight", "ffn_down.weight"))
                         and use_more_bits(layer, nl)):
            return GGMLType.Q6_K
        return GGMLType.Q4_K

    return _gemma_gguf(path, "gemma2", c, "gemma-2-2b-width-random-q4_k_m", kind, seed)


GEMMA3_1B_KINDS = ("q4_0", "q4_k_m")


def make_gemma3_1b_gguf(path: str | Path, *, n_layers: int = 2, seed: int = 0,
                        kind: str = "q4_0") -> Path:
    """Write a Gemma-3-1B-width gemma3 GGUF (see module doc) with a tied
    Q8_0 token table (llama.cpp's fallback for Q6_K) and F32 norms near 1,
    q/k norms included. Kind "q4_0": Q4_K where a row's K is a multiple of
    256 (attn_output, ffn_down), Q4_0 where K = 1152 is not (q, k, v, gate,
    up). Kind "q4_k_m", the mix of llama.cpp's Q4_K_M file of this model:
    Q5_0 where K = 1152 (q, k, gate, up; the fallback for Q4_K), attn_v
    Q5_0, or Q8_0 on the layers `use_more_bits` picks (the fallback for
    Q6_K), Q4_K attn_output, and ffn_down (K = 6912) Q4_K, or Q6_K on those
    layers. `n_layers` cuts depth (26 in the published config)."""
    if kind not in GEMMA3_1B_KINDS:
        raise ValueError(f"kind must be one of {GEMMA3_1B_KINDS}, got {kind!r}")
    c = dict(GEMMA3_1B, n_layers=n_layers)

    def q4_0(name, layer, n_out, k_in):
        if layer < 0:
            return GGMLType.Q8_0
        return GGMLType.Q4_K if k_in % 256 == 0 else GGMLType.Q4_0

    def q4_k_m(name, layer, n_out, k_in):
        more = layer >= 0 and use_more_bits(layer, n_layers)
        if layer < 0 or (more and name.endswith("attn_v.weight")):
            return GGMLType.Q8_0
        if more and name.endswith("ffn_down.weight"):
            return GGMLType.Q6_K
        return GGMLType.Q4_K if k_in % 256 == 0 else GGMLType.Q5_0

    name = "gemma-3-1b-width-random" + ("" if kind == "q4_0" else f"-{kind}")
    return _gemma_gguf(path, "gemma3", c, name, {"q4_0": q4_0, "q4_k_m": q4_k_m}[kind], seed)


def _family_gguf(path, arch: str, c: dict, name: str, tok_md: dict, kind, *, tied: bool,
                 bias: bool = False, fused: bool = False, seed: int = 0) -> Path:
    """A random-block llama-schema GGUF of `arch` at the widths in `c`;
    `kind(name, layer)` picks each matmul tensor's GGMLType (the token table
    asks with layer -1, an untied output.weight with layer -2). `bias`:
    qwen2's F32 q/k/v biases (std 0.5, as a trained Qwen2's are); `fused`:
    phi3's attn_qkv and [gate; up] ffn_up. Norms are ones."""
    rng = np.random.default_rng(seed)
    h, v, nl, f = c["hidden"], c["vocab_size"], c["n_layers"], c["ffn_dim"]
    hd = h // c["n_heads"]
    qd, kvd = c["n_heads"] * hd, c["n_kv_heads"] * hd
    w = GGUFWriter()
    _header(w, arch, name, context_length=c["context_length"], hidden=h, n_layers=nl,
            ffn_dim=f, n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
            rope_base=c["rope_base"], vocab_size=v, rms_eps=c["rms_eps"], tok_md=tok_md)

    def quant(tname, layer, n_out, k_in):
        q = kind(tname, layer)
        w.add_tensor(tname, _shape_only(n_out, k_in), q, raw_bytes=_RANDOM_BLOCKS[q](rng, n_out, k_in))

    def f32(tname, arr):
        w.add_tensor(tname, np.asarray(arr, np.float32), GGMLType.F32)

    quant("token_embd.weight", -1, v, h)
    for i in range(nl):
        f32(f"blk.{i}.attn_norm.weight", np.ones(h))
        if fused:
            quant(f"blk.{i}.attn_qkv.weight", i, qd + 2 * kvd, h)
        else:
            quant(f"blk.{i}.attn_q.weight", i, qd, h)
            quant(f"blk.{i}.attn_k.weight", i, kvd, h)
            quant(f"blk.{i}.attn_v.weight", i, kvd, h)
        quant(f"blk.{i}.attn_output.weight", i, h, qd)
        if bias:
            for part, n in (("q", qd), ("k", kvd), ("v", kvd)):
                f32(f"blk.{i}.attn_{part}.bias", rng.standard_normal(n, np.float32) * 0.5)
        f32(f"blk.{i}.ffn_norm.weight", np.ones(h))
        if fused:
            quant(f"blk.{i}.ffn_up.weight", i, 2 * f, h)
        else:
            quant(f"blk.{i}.ffn_gate.weight", i, f, h)
            quant(f"blk.{i}.ffn_up.weight", i, f, h)
        quant(f"blk.{i}.ffn_down.weight", i, h, f)
    f32("output_norm.weight", np.ones(h))
    if not tied:
        quant("output.weight", -2, v, h)
    return w.write(path)


def _cut(widths: dict, n_layers: int | None) -> dict:
    return dict(widths) if n_layers is None else dict(widths, n_layers=n_layers)


def make_qwen2_1_5b_gguf(path: str | Path, *, n_layers: int | None = None, seed: int = 0) -> Path:
    """Model Q: qwen2 at Qwen2.5-1.5B's widths (hidden 1536, 28 layers, 12 / 2
    heads of 128: r = 6, ffn 8960, vocab 151936, tied, q/k/v biases, rope
    base 1e6, rms eps 1e-6, a ChatML tokenizer) in llama.cpp's Q4_K_M mix:
    tied Q6_K table, Q6_K attn_v and ffn_down on the layers `use_more_bits`
    picks, Q4_K elsewhere. ~1.1 GB at full depth."""
    c = _cut(QWEN2_5_1_5B, n_layers)
    nl = c["n_layers"]

    def kind(name, layer):
        if layer < 0 or (name.endswith(("attn_v.weight", "ffn_down.weight")) and use_more_bits(layer, nl)):
            return GGMLType.Q6_K
        return GGMLType.Q4_K

    return _family_gguf(path, "qwen2", c, "qwen2.5-1.5b-width-random-q4_k_m",
                        tiny_tokenizer_metadata(c["vocab_size"], chatml=True), kind, tied=True,
                        bias=True, seed=seed)


def make_phi3_mini_gguf(path: str | Path, *, n_layers: int | None = None, seed: int = 0) -> Path:
    """Model P: phi3 at Phi-3-mini-4k's widths (hidden 3072, 32 layers, 32 /
    32 heads of 96: r = 1, ffn 8192, vocab 32064 of SPM pieces, untied,
    rope base 1e4) with its pre-fused attn_qkv [9216, 3072] and [gate; up]
    ffn_up [16384, 3072], in llama.cpp's Q4_K_M mix: Q5_K attn_qkv (its
    rule for a fused qkv), Q6_K ffn_down on the layers `use_more_bits`
    picks, Q6_K output.weight, Q4_K elsewhere (the token table too). ~2.3 GB
    at full depth."""
    c = _cut(PHI3_MINI_4K, n_layers)
    nl = c["n_layers"]

    def kind(name, layer):
        if layer == -2 or (name.endswith("ffn_down.weight") and use_more_bits(layer, nl)):
            return GGMLType.Q6_K
        return GGMLType.Q5_K if name.endswith("attn_qkv.weight") else GGMLType.Q4_K

    added = PHI3_ADDED + tuple(f"<|dummy_id_{i}|>" for i in range(64 - len(PHI3_ADDED)))
    tok = spm_tokenizer_metadata(c["vocab_size"], ("<unk>", "<s>", "</s>"), unk=0, bos=1,
                                 eos=c["vocab_size"] - len(added) + added.index("<|end|>"),
                                 template=PHI3_TEMPLATE, added=added)
    return _family_gguf(path, "phi3", c, "phi-3-mini-4k-width-random-q4_k_m", tok, kind, tied=False,
                        fused=True, seed=seed)


def make_mistral_7b_gguf(path: str | Path, *, n_layers: int | None = None, seed: int = 0) -> Path:
    """Model M: mistral at Mistral-7B-v0.3's widths (hidden 4096, 32 layers,
    32 / 8 heads of 128, ffn 14336, vocab 32768 of SPM pieces, NORM rope,
    base 1e6, untied) in plain Q4_K (the token table and output.weight
    too), so that every layer's MLP is K5's at a 7B width. ~4.0 GB at full
    depth."""
    c = _cut(MISTRAL_7B_V0_3, n_layers)
    tok = spm_tokenizer_metadata(c["vocab_size"], MISTRAL_SPECIALS, unk=0, bos=1, eos=2,
                                 template=MISTRAL_TEMPLATE)
    return _family_gguf(path, "mistral", c, "mistral-7b-v0.3-width-random-q4_k", tok,
                        lambda name, layer: GGMLType.Q4_K, tied=False, seed=seed)
