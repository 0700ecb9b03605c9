"""Synthetic Llama GGUF fixtures: the tiny test model, and a writer for
Llama-3.2-1B-width checkpoints filled with random raw quantized blocks.

`make_tiny_llama_gguf` is a copy of the JAX package's fixture (same bytes
for the same arguments) limited to the llama options the port runs.
`make_llama_1b_gguf` writes the published Llama-3.2-1B shapes (hidden 2048,
32 heads / 8 kv heads, ffn 8192, vocab 128256, rope base 500000 with a
llama3 `rope_freqs` tensor) with every quantized tensor as random raw
blocks — no quantizer runs over 1.2 B floats — in one of four kinds:
"q4_k" (untied, Q4_K matmuls, F16 embedding), "q4_k_m" (the mix llama.cpp
writes for Q4_K_M: tied Q6_K table, Q6_K attn_v and ffn_down on the layers
`use_more_bits` picks, Q4_K elsewhere), "q8_0" (untied, Q8_0 throughout)
and "q4_0_tied" (tied, Q4_0 throughout). `n_layers` cuts depth (16 in the
published config).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .gguf import GGMLType, GGUFWriter
from .gguf.constants import Keys
from .ops.rope import compute_inv_freq
from .tokenizer.bpe import TokenType, bytes_to_unicode


def tiny_tokenizer_metadata() -> dict:
    """A byte-level vocab (256 byte tokens + llama-3 specials), no merges:
    every string tokenizes (one token per byte)."""
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    types = [TokenType.NORMAL] * 256
    specials = [
        "<|begin_of_text|>",
        "<|end_of_text|>",
        "<|start_header_id|>",
        "<|end_header_id|>",
        "<|eot_id|>",
    ]
    for s in specials:
        tokens.append(s)
        types.append(TokenType.CONTROL)
    return {
        Keys.TOKENIZER_MODEL: "gpt2",
        Keys.TOKENIZER_PRE: "llama-bpe",
        Keys.TOKENIZER_TOKENS: tokens,
        Keys.TOKENIZER_TOKEN_TYPE: types,
        Keys.TOKENIZER_MERGES: [],
        Keys.TOKENIZER_BOS: tokens.index("<|begin_of_text|>"),
        Keys.TOKENIZER_EOS: tokens.index("<|eot_id|>"),
    }


def _header(w: GGUFWriter, arch: str, name: str, *, context_length: int,
            hidden: int, n_layers: int, ffn_dim: int, n_heads: int,
            n_kv_heads: int, rope_base: float, vocab_size: int,
            tok_md: dict) -> None:
    w.add(Keys.ARCHITECTURE, arch)
    w.add(Keys.NAME, name)
    w.add(f"{arch}.context_length", context_length)
    w.add(f"{arch}.embedding_length", hidden)
    w.add(f"{arch}.block_count", n_layers)
    w.add(f"{arch}.feed_forward_length", ffn_dim)
    w.add(f"{arch}.attention.head_count", n_heads)
    w.add(f"{arch}.attention.head_count_kv", n_kv_heads)
    w.add(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)
    w.add(f"{arch}.rope.freq_base", rope_base)
    w.add(f"{arch}.vocab_size", vocab_size)
    for k, v in tok_md.items():
        w.add(k, v)


def make_tiny_llama_gguf(
    path: str | Path,
    *,
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
    seed: int = 0,
    scale: float = 0.05,
    rope_freqs: np.ndarray | None = None,
    quant_overrides: dict | None = None,  # tensor name -> GGMLType
) -> Path:
    """Write a random-weight llama GGUF (the JAX package's fixture)."""
    rng = np.random.default_rng(seed)
    tok_md = tiny_tokenizer_metadata()
    if vocab_size is None:
        n_tok = len(tok_md[Keys.TOKENIZER_TOKENS])
        vocab_size = (n_tok + 7) // 8 * 8
    head_dim = hidden // n_heads
    w = GGUFWriter()
    _header(w, "llama", "tiny-llama-test", context_length=context_length,
            hidden=hidden, n_layers=n_layers, ffn_dim=ffn_dim, n_heads=n_heads,
            n_kv_heads=n_kv_heads, rope_base=rope_base, vocab_size=vocab_size,
            tok_md=tok_md)

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
        addw(f"blk.{i}.attn_q.weight", rand(n_heads * head_dim, hidden))
        addw(f"blk.{i}.attn_k.weight", rand(n_kv_heads * head_dim, hidden))
        addw(f"blk.{i}.attn_v.weight", rand(n_kv_heads * head_dim, hidden))
        addw(f"blk.{i}.attn_output.weight", rand(hidden, n_heads * head_dim))
        addw(f"blk.{i}.ffn_norm.weight", np.ones(hidden, np.float32), GGMLType.F32)
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


# Llama-3.2-1B (published config.json): widths, heads, vocab, rope
LLAMA_1B = dict(
    hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192,
    vocab_size=128256, rope_base=500000.0, context_length=131072,
    rope_factor=32.0, rope_low=1.0, rope_high=4.0, rope_orig_ctx=8192,
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


_RANDOM_BLOCKS = {
    GGMLType.Q4_K: random_q4k_bytes,
    GGMLType.Q6_K: random_q6k_bytes,
    GGMLType.Q8_0: random_q8_0_bytes,
    GGMLType.Q4_0: random_q4_0_bytes,
}
LLAMA_1B_KINDS = ("q4_k", "q4_k_m", "q8_0", "q4_0_tied")


def make_llama_1b_gguf(path: str | Path, *, kind: str = "q4_k",
                       n_layers: int | None = None, seed: int = 0) -> Path:
    """Write a Llama-3.2-1B-width GGUF of `kind` (see module doc) with random
    raw blocks (~0.9-1.7 GB at full depth). Weights are random: the model is
    for speed and kernel checks, not for text."""
    if kind not in LLAMA_1B_KINDS:
        raise ValueError(f"kind must be one of {LLAMA_1B_KINDS}, got {kind!r}")
    c = dict(LLAMA_1B)
    if n_layers is not None:
        c["n_layers"] = n_layers
    rng = np.random.default_rng(seed)
    h, f, v, nl = c["hidden"], c["ffn_dim"], c["vocab_size"], c["n_layers"]
    hd = h // c["n_heads"]
    qd, kvd = c["n_heads"] * hd, c["n_kv_heads"] * hd
    w = GGUFWriter()
    _header(w, "llama", f"llama-3.2-1b-width-random-{kind}",
            context_length=c["context_length"], hidden=h, n_layers=nl,
            ffn_dim=f, n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
            rope_base=c["rope_base"], vocab_size=v, tok_md=tiny_tokenizer_metadata())
    base = {"q4_k": GGMLType.Q4_K, "q4_k_m": GGMLType.Q4_K,
            "q8_0": GGMLType.Q8_0, "q4_0_tied": GGMLType.Q4_0}[kind]
    tied = kind in ("q4_k_m", "q4_0_tied")

    def shape_only(*shape):  # add_tensor reads only the shape next to raw bytes
        return np.broadcast_to(np.zeros((), np.float32), shape)

    def quant(name, n_out, k_in, q=base):
        w.add_tensor(name, shape_only(n_out, k_in), q,
                     raw_bytes=_RANDOM_BLOCKS[q](rng, n_out, k_in))

    if kind == "q4_k":
        embed = (rng.standard_normal((v, h), dtype=np.float32) * 0.02).astype(np.float16)
        w.add_tensor("token_embd.weight", shape_only(v, h), GGMLType.F16,
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
