"""Llama model: config from GGUF metadata, quantized weight loading, the
prefill and decode forwards, and the decode loop.

Counterpart of nfai_tpu/models/llama.py in its single-device default
configuration. Every matmul goes through a dequant-matmul kernel: K1
(ops.qmatmul) for a 4-bit weight, K6 for an 8-bit one. The MLP follows the
JAX route: where gate_up and down are 4-bit in every layer and the widths
qualify (`ops.fused_mlp.mlp_eligible`), one K5 launch per layer runs the
whole MLP at decode and for prefill chunks of up to 1024 rows, and
`mlp_prefill` serves longer chunks; otherwise gate_up (or gate and up) and
down run as separate matmuls. q/k/v and gate/up are fused along N only when
every layer's parts share a container, as the JAX package decides. A tied
checkpoint (no output.weight) keeps one quantized table: the LM head runs
on it and the embedding rows are gathered from it. A prefill chunk (T > 1)
writes its K/V into the cache and attends with K4 (ops.prefill_attention);
a decode step (T == 1) attends with K2, which folds the new token in, and
writes all layers' new K/V rows after the layer loop with one K3 launch per
cache (ops.fused_decode).

The JAX package scans over layer-stacked weights; here the loop over layers
is plain Python and each layer's weight is a view of the stacked tensor (or
its own container, where a stack mixes kinds). The cache is updated in
place. `decode_loop` is a Python loop over steps (the JAX version is one
jitted scan; capturing the step as a CUDA graph is later work).

Only llama-arch checkpoints with Q4_0/Q4_1/Q4_K, Q8_0 or Q2_K/Q3_K/Q5_K/
Q6_K matmul weights load; dense (F16/F32) matmul weights and the other
families' features (biases, q/k norms, softcaps, sliding windows, MoE,
pre-fused tensors) raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as nnf

from ..gguf import GGUFFile, Keys
from ..ops.fused_decode import layered_decode_attention, write_all_layers
from ..ops.fused_mlp import (
    MLP_FUSED_MAX_ROWS, fused_mlp_layered, mlp_eligible, mlp_prefill,
)
from ..ops.norms import rms_norm
from ..ops.prefill_attention import flash_prefill_attention
from ..ops.qmatmul import linear, linear_layered
from ..ops.qtensor import (
    SUPPORTED_QUANT_TYPES, concat, dequant_gather, from_jax_qtensor, n_layers,
    pack_gguf_tensor, permute_rows, same_layout, stack,
)
from ..ops.rope import (
    apply_rope_cs, compute_inv_freq, inv_freq_from_factors, norm_to_neox_perm,
    rope_cos_sin,
)
from ..ops.sampling import sample_logits


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    hidden_size: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int
    rms_eps: float = 1e-5
    rope_base: float = 500000.0
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_ctx: int = 8192
    context_length: int = 8192
    tied_embeddings: bool = True

    @property
    def query_scale(self) -> float:
        return 1.0 / (self.head_dim**0.5)

    @classmethod
    def from_gguf(cls, g: GGUFFile) -> "LlamaConfig":
        md = g.metadata
        arch = g.architecture
        if arch != "llama":
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (this slice runs llama)"
            )
        extras = [
            name for name in (
                "blk.0.attn_q.bias", "blk.0.attn_q_norm.weight",
                "blk.0.post_attention_norm.weight", "blk.0.ffn_gate_exps.weight",
                "blk.0.attn_qkv.weight",
            ) if name in g.tensors
        ]
        if extras:
            raise NotImplementedError(f"llama checkpoints with {extras} are not ported yet")

        def key(template, default=None):
            v = md.get(template.format(arch=arch))
            return default if v is None else v

        n_heads = int(key(Keys.HEAD_COUNT))
        hidden = int(key(Keys.EMBEDDING_LENGTH))
        vocab = key(Keys.VOCAB_SIZE)
        if vocab is None:
            vocab = len(md[Keys.TOKENIZER_TOKENS])
        return cls(
            vocab_size=int(vocab),
            hidden_size=hidden,
            n_layers=int(key(Keys.BLOCK_COUNT)),
            n_heads=n_heads,
            n_kv_heads=int(key(Keys.HEAD_COUNT_KV, n_heads)),
            head_dim=int(key(Keys.KEY_LENGTH, hidden // n_heads)),
            ffn_dim=int(key(Keys.FEED_FORWARD_LENGTH)),
            rms_eps=float(key(Keys.LAYERNORM_RMS_EPS, 1e-5)),
            rope_base=float(key(Keys.ROPE_FREQ_BASE, 10000.0)),
            rope_scaling_type=str(key(Keys.ROPE_SCALING_TYPE, "none")),
            rope_scaling_factor=float(key(Keys.ROPE_SCALING_FACTOR, 1.0)),
            rope_low_freq_factor=float(key(Keys.ROPE_SCALING_LOW_FREQ, 1.0)),
            rope_high_freq_factor=float(key(Keys.ROPE_SCALING_HIGH_FREQ, 4.0)),
            rope_original_ctx=int(key(Keys.ROPE_SCALING_ORIG_CTX, 8192)),
            context_length=int(key(Keys.CONTEXT_LENGTH, 8192)),
            tied_embeddings="output.weight" not in g.tensors,
        )


@dataclass
class KVCache:
    """Dense KV cache, k/v [L, B, S, KVD] with KVD = Hkv*D (head-major
    columns): one token of one layer is one contiguous KVD row, and
    cache.k[l] is the [B, S, KVD] view the attention kernels read."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, max_seq: int,
              dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads * cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


# ---------------------------------------------------------------------------
# weight loading

_GGUF_NAMES = {
    "attn_norm": "blk.{i}.attn_norm.weight",
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "ffn_norm": "blk.{i}.ffn_norm.weight",
    "w_gate": "blk.{i}.ffn_gate.weight",
    "w_up": "blk.{i}.ffn_up.weight",
    "w_down": "blk.{i}.ffn_down.weight",
}


_FUSIONS = ((("wq", "wk", "wv"), "wqkv"), (("w_gate", "w_up"), "w_gate_up"))


def _stack_layers(per_layer: dict[str, list]) -> dict:
    """Per-layer parameter lists → layer stacks. q/k/v and gate/up fuse
    along N only when every layer's parts share a container (the JAX
    `_fuse_projections` rule: a Q4_K_M file's Q6_K attn_v keeps q/k/v split
    on every layer); a stack whose layers mix kinds becomes a LayerList."""
    per_layer = dict(per_layer)
    for names, fused in _FUSIONS:
        if all(n in per_layer for n in names):
            groups = list(zip(*(per_layer[n] for n in names)))
            if all(same_layout(list(parts)) for parts in groups):
                per_layer[fused] = [concat(list(parts)) for parts in groups]
                for n in names:
                    del per_layer[n]
    return {
        k: torch.stack(v) if isinstance(v[0], torch.Tensor) else stack(v)
        for k, v in per_layer.items()
    }


def _params(embed, layers: dict, final_norm, lm_head, inv_freq, dtype, device) -> dict:
    return {
        "embed": None if embed is None else embed.to(dtype).to(device),
        "layers": {k: v.to(device) for k, v in layers.items()},
        "final_norm": final_norm.to(device),
        "lm_head": lm_head.to(device),
        "inv_freq": inv_freq.to(device),
        "act_dtype": dtype,
        "fused_mlp": mlp_eligible(layers.get("w_gate_up"), layers["w_down"]),
    }


def load_params(g: GGUFFile, cfg: LlamaConfig, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """GGUF → params dict on `device`:

    - ``embed`` [V, H] dense in `dtype` (dequantized from any kind the
      reader decodes), or None for a tied checkpoint;
    - ``layers``: ``attn_norm``/``ffn_norm`` f32 [L, H]; the matmul weights
      as layer stacks of `Q4Tensor`/`Q8Tensor` (or a `LayerList` where the
      layers mix kinds): ``wqkv`` or ``wq``/``wk``/``wv`` (wq/wk rows
      permuted NORM → NEOX), ``wo``, ``w_gate_up`` or ``w_gate``/``w_up``,
      ``w_down``;
    - ``final_norm`` f32 [H]; ``lm_head`` the 2-D quantized output weight,
      or for a tied checkpoint the quantized token table itself; ``inv_freq``
      f32;
    - ``act_dtype`` (`dtype`) and ``fused_mlp`` (whether the MLP takes K5).
    """

    def mat(name: str):
        desc = g.tensors[name]
        if desc.ggml_type not in SUPPORTED_QUANT_TYPES:
            raise NotImplementedError(
                f"{name} is {desc.ggml_type.name}; the port keeps only quantized "
                "matmul weights (Q4_0/Q4_1/Q4_K, Q8_0, Q2_K/Q3_K/Q5_K/Q6_K; dense "
                "kernels come later)"
            )
        return pack_gguf_tensor(g.tensor_bytes(name), desc.ggml_type, desc.shape)

    def vec(name: str) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(g.tensor_f32(name), np.float32))

    per_layer: dict[str, list] = {k: [] for k in _GGUF_NAMES}
    for i in range(cfg.n_layers):
        for key, template in _GGUF_NAMES.items():
            name = template.format(i=i)
            per_layer[key].append(vec(name) if key.endswith("norm") else mat(name))
    q_perm = norm_to_neox_perm(cfg.n_heads, cfg.head_dim)
    k_perm = norm_to_neox_perm(cfg.n_kv_heads, cfg.head_dim)
    per_layer["wq"] = [permute_rows(w, q_perm) for w in per_layer["wq"]]
    per_layer["wk"] = [permute_rows(w, k_perm) for w in per_layer["wk"]]
    if "rope_freqs.weight" in g.tensors:
        inv_freq = inv_freq_from_factors(
            g.tensor_f32("rope_freqs.weight"), cfg.head_dim, cfg.rope_base
        )
    else:
        inv_freq = compute_inv_freq(
            cfg.head_dim, cfg.rope_base, cfg.rope_scaling_type,
            cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
            cfg.rope_high_freq_factor, cfg.rope_original_ctx,
        )
    if cfg.tied_embeddings:  # one quantized table: the head, and the embedding rows
        embed, lm_head = None, mat("token_embd.weight")
    else:
        embed = torch.from_numpy(g.tensor_f32("token_embd.weight"))
        lm_head = mat("output.weight")
    return _params(embed, _stack_layers(per_layer), vec("output_norm.weight"), lm_head,
                   torch.from_numpy(inv_freq), dtype, device)


def params_from_jax(np_params: dict, cfg: LlamaConfig, dtype=torch.float32,
                    device="cpu") -> dict:
    """The JAX package's `load_params` output (leaves as numpy; quantized
    leaves as its QTensor dataclass with numpy fields) → this package's
    params.

    Undoes the TPU packings (v2 split-half nibbles with the /16 and -8
    folds, v3 word planes, merged q4v3m scales, the q4mlpg/q4mlpd fused-MLP
    permutations, 8-bit containers, N padding) through
    `ops.qtensor.from_jax_qtensor`, then fuses and routes as `load_params`
    does; a tied quantized table (``embed`` None) becomes the head and the
    embedding source. Dense matmul weights raise."""

    def conv(leaf):
        if not hasattr(leaf, "kind"):
            raise NotImplementedError("dense matmul weights are not ported yet")
        return from_jax_qtensor(
            leaf.kind, np.asarray(leaf.qs), np.asarray(leaf.scales),
            None if leaf.mins is None else np.asarray(leaf.mins),
            leaf.k, leaf.n, leaf.sections, leaf.group, leaf.tfb,
        )

    src = np_params["layers"]
    unknown = set(src) - {"attn_norm", "ffn_norm", "wqkv", "wq", "wk", "wv",
                          "wo", "w_gate_up", "w_gate", "w_up", "w_down"}
    if unknown:
        raise NotImplementedError(f"layer parameters {sorted(unknown)} are not ported yet")
    per_layer = {}
    for key, leaf in src.items():
        if key.endswith("norm"):
            per_layer[key] = list(torch.from_numpy(np.array(leaf, np.float32)))
        else:
            w = conv(leaf)
            per_layer[key] = [w.layer(i) for i in range(n_layers(w))]
    embed = np_params.get("embed")
    as_f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    return _params(
        None if embed is None else as_f32(embed), _stack_layers(per_layer),
        as_f32(np_params["final_norm"]), conv(np_params["lm_head"]),
        as_f32(np_params["inv_freq"]), dtype, device,
    )


# ---------------------------------------------------------------------------
# forward


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    if params["embed"] is None:  # tied: rows of the quantized head are the embedding
        return dequant_gather(params["lm_head"], tokens).to(params["act_dtype"])
    return params["embed"][tokens.long()]


def _qkv(lp: dict, x: torch.Tensor, layer: int, qd: int, kvd: int):
    """q, k, v projections of x [..., H]: one fused matmul where the
    checkpoint allows it, else three."""
    if "wqkv" in lp:
        qkv = linear_layered(x, lp["wqkv"], layer)
        return qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    return tuple(linear_layered(x, lp[k], layer) for k in ("wq", "wk", "wv"))


def _write_cache(cache_l: torch.Tensor, new: torch.Tensor, starts: torch.Tensor) -> None:
    """new [B, T, KVD] → cache_l [B, S, KVD] rows starts[b] .. starts[b]+T-1."""
    b, t, _ = new.shape
    rows = starts.long()[:, None] + torch.arange(t, device=new.device)[None]
    cache_l[torch.arange(b, device=new.device)[:, None], rows] = new.to(cache_l.dtype)


def _mlp(params: dict, cfg: LlamaConfig, x: torch.Tensor, layer: int) -> torch.Tensor:
    """The JAX package's MLP route: K5 (up to MLP_FUSED_MAX_ROWS rows) or
    `mlp_prefill` where the pair is fused-eligible, else two (or three)
    dequant-matmuls around the activation."""
    lp = params["layers"]
    if params["fused_mlp"]:
        if x.numel() // x.shape[-1] > MLP_FUSED_MAX_ROWS:
            return mlp_prefill(x, lp["w_gate_up"].layer(layer), lp["w_down"].layer(layer))
        return fused_mlp_layered(x, lp["w_gate_up"], lp["w_down"], layer)
    f = cfg.ffn_dim
    if "w_gate_up" in lp:
        gu = linear_layered(x, lp["w_gate_up"], layer)
        gate, up = gu[..., :f], gu[..., f:]
    else:
        gate, up = (linear_layered(x, lp[k], layer) for k in ("w_gate", "w_up"))
    inner = (nnf.silu(gate.float()) * up.float()).to(x.dtype)
    return linear_layered(inner, lp["w_down"], layer)


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache):
    """Run the stack over tokens/positions [B, T]; returns (hidden [B, T, H]
    after the final norm, cache updated in place). T == 1 takes the decode
    path (K2 + K3), T > 1 the prefill path (cache write + K4)."""
    if tokens.shape[1] == 1:
        return _decode_forward(params, cfg, tokens, positions, cache)
    b, t = tokens.shape
    lp = params["layers"]
    h = _embed(params, tokens)
    act = h.dtype
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    cos, sin = rope_cos_sin(positions, params["inv_freq"])
    starts = positions[:, 0].to(torch.int32).contiguous()  # once per chunk, for every layer's K4
    for layer in range(cfg.n_layers):
        x = rms_norm(h, lp["attn_norm"][layer], cfg.rms_eps)
        q, k, v = _qkv(lp, x, layer, qd, kvd)
        q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope_cs(q, cos, sin, neox=True).to(act)
        k = apply_rope_cs(k, cos, sin, neox=True)
        _write_cache(cache.k[layer], k.reshape(b, t, kvd), starts)
        _write_cache(cache.v[layer], v, starts)
        attn = flash_prefill_attention(
            q.contiguous(), cache.k[layer], cache.v[layer], starts,
            scale=cfg.query_scale,
        )
        h = (h + linear_layered(attn.reshape(b, t, qd), lp["wo"], layer)).to(act)
        x = rms_norm(h, lp["ffn_norm"][layer], cfg.rms_eps)
        h = (h + _mlp(params, cfg, x, layer)).to(act)
    return rms_norm(h, params["final_norm"], cfg.rms_eps), cache


def _decode_forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, cache: KVCache):
    """One token per row: K2 attends over cache[:, :starts] plus the new row;
    after the layer loop K3 writes every layer's new K/V row."""
    b = tokens.shape[0]
    lp = params["layers"]
    h = _embed(params, tokens)
    act = h.dtype
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    cos, sin = rope_cos_sin(positions, params["inv_freq"])
    starts = positions[:, 0].to(torch.int32).contiguous()  # once per step, for K2 and K3
    k_rows = torch.empty(cfg.n_layers, b, kvd, dtype=cache.k.dtype, device=h.device)
    v_rows = torch.empty_like(k_rows)
    for layer in range(cfg.n_layers):
        x = rms_norm(h, lp["attn_norm"][layer], cfg.rms_eps)
        q, k, v = _qkv(lp, x, layer, qd, kvd)
        q = q.reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope_cs(q, cos, sin, neox=True).to(act)
        k_rows[layer] = apply_rope_cs(k, cos, sin, neox=True).reshape(b, kvd)
        v_rows[layer] = v[:, 0]
        attn = layered_decode_attention(
            q.view(b, cfg.n_heads, cfg.head_dim), k_rows[layer], v_rows[layer], cache.k,
            cache.v, layer, starts, scale=cfg.query_scale,
        )
        h = (h + linear_layered(attn.reshape(b, 1, qd), lp["wo"], layer)).to(act)
        x = rms_norm(h, lp["ffn_norm"][layer], cfg.rms_eps)
        h = (h + _mlp(params, cfg, x, layer)).to(act)
    write_all_layers(cache.k, k_rows, starts)
    write_all_layers(cache.v, v_rows, starts)
    return rms_norm(h, params["final_norm"], cfg.rms_eps), cache


def logits_for(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM head (K1 or K6; the tied table for a tied checkpoint) → f32 logits."""
    return linear(hidden, params["lm_head"]).float()


@torch.inference_mode()
def prefill_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, last_index: torch.Tensor,
                 cache: KVCache):
    """Process a (padded) prompt chunk [B, T]; returns (logits [B, V] at each
    row's last real token, cache)."""
    h, cache = forward(params, cfg, tokens, positions, cache)
    rows = torch.arange(h.shape[0], device=h.device)
    h_last = h[rows, last_index.long().to(h.device)]
    return logits_for(params, h_last), cache


@torch.inference_mode()
def decode_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: KVCache):
    """One token [B] at positions [B] for every row; returns ([B, V] logits,
    cache)."""
    h, cache = forward(params, cfg, tokens[:, None], positions[:, None], cache)
    return logits_for(params, h[:, 0]), cache


@torch.inference_mode()
def decode_loop(params: dict, cfg: LlamaConfig, first_tokens: torch.Tensor,
                start_pos: torch.Tensor, cache: KVCache,
                generator: torch.Generator | None, n_steps: int,
                temperature: float = 0.0, top_k: int = 40, top_p: float = 0.95,
                min_p: float = 0.0):
    """Generate `n_steps` tokens on the device without a host sync per token.

    Returns (tokens [B, n_steps], next_tokens [B], cache, generator): every
    emitted token has its K/V written; `next_tokens` is sampled but not yet
    fed through the model (the JAX `decode_loop` contract)."""
    tok, pos = first_tokens, start_pos
    out = []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cfg, tok, pos, cache)
        nxt = sample_logits(logits, generator, temperature, top_k, top_p,
                            min_p=min_p).to(tok.dtype)
        out.append(tok)
        tok, pos = nxt, pos + 1
    return torch.stack(out, dim=1), tok, cache, generator
