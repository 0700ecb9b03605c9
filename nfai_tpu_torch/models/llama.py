"""Llama-schema models (llama, mistral, qwen2, qwen3, qwen3moe, gemma,
gemma2, gemma3, phi3):
config from GGUF metadata, quantized weight loading, the prefill and decode
forwards, and the decode loop.

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
on it and the embedding rows are gathered from it. Every new K/V row goes
through the K/V store (ops.kv_store, K3 and K10 redesigned as one kernel):
a prefill chunk (T > 1) stores each layer's K and V (one launch a layer)
and attends with K4 (ops.prefill_attention); a decode step (T == 1)
attends with K2 (ops.fused_decode), which folds the new token in, and
stores every layer's new K and V rows after the layer loop in one launch.

qwen3 and qwen3moe checkpoints are stored without llama's HF→ggml q/k
permutation (ggml's NEOX rope), so their wq/wk load as they are; their
per-head q/k RMS norms (`q_norm`/`k_norm`, f32 [D]) run before the rope.
`head_dim` comes from `attention.key_length` (128 at Qwen3-30B-A3B, where
hidden / heads is 64). A qwen3moe layer replaces the MLP with `moe_ffn`:
an f32 router (`router` [H, E]), softmax, top-k and (norm_topk_prob)
renormalisation; the (token, slot) rows are sorted by expert with a stable
argsort and scattered to a group-aligned padded layout (`moe_group_layout`)
in which every tm-row block belongs to one expert; gate, up and down then
run as grouped matmuls over the stacked [E, ...] expert containers (K8 for
4-bit, K9 for 8-bit stacks) and the weighted rows are summed back per
token. Everything there has static shapes and no host read, so the layer
loop never waits on the device. The JAX package widens a 4-bit expert
stack whose K breaks its TPU tiling (qwen3moe's down, K = 768) to its
8-bit container; the port keeps it 4-bit (K8 takes any K % 32 == 0), which
computes the same function, and keeps a stack whose layers mix kinds (Q6_K
down on the layers `use_more_bits` picks) per layer, so K8 and K9 both run.

The int8 KV cache (``EngineConfig.kv_dtype="int8"``, `KVCache.zeros(...,
quantized=True)`) follows the JAX package: the store quantizes each new
row as `quantize_kv` does into int8 codes and per-(token, kv head) f32
scales, stored time-minor ([L, B, Hkv, S]). A prefill chunk stores its
codes and scales and attends them with K4's int8 entry point, so the
chunk's own tokens are attended in their quantized form; a decode step
attends the old tokens with K2's int8 entry point and folds the new token
in at full precision, then the store quantizes the new rows for storage
only. The int8 page pool stores codes and scales through the tables: a
decode step reads the current token back quantized (K7's int8 entry
point), and a prefill chunk gathers its pages, dequantizes them into the
activation dtype (`dequant_kv`) and runs K4's bf16 route, as the JAX
package does.

Gemma (gemma, gemma2, gemma3) follows the JAX layer step: NEOX rope
without the q/k permutation, embeddings times sqrt(hidden) (in f32, then
rounded to the activation dtype), tanh-gelu in the MLP on every route;
gemma2/3 add RMS norms on the attention and FFN outputs before each
residual add (`post_attn_norm`, `post_ffw_norm`) and a sliding window on
the local layers (`LlamaConfig.layer_windows`: every second layer of
gemma2, five of six of gemma3), which K2, K4 and K7 apply themselves;
gemma2 caps the attention scores and the final logits with
softcap * tanh(x / softcap); gemma3 has q/k norms and ropes its local
layers with a second base (`inv_freq_local`). The attention scale follows
llama.cpp: head_dim^-0.5, except (hidden // n_heads)^-0.5 for the 27B
models (gemma2 with 46 blocks, gemma3 with 62), where the JAX package
scales every gemma2 by (hidden / n_heads)^-0.5.

With block tables (`page_tables`) the cache is the continuous-batching
page pool (runtime.paged_cache): every layer first stores its roped K and
V through the tables (`kv_store_paged`), then a decode step attends
with K7 (ops.paged_attention) and a prefill chunk with K4 over the dense
view of the row's pages (`_gather_pages`). `paged_prefill_step`,
`paged_decode_loop` and `prefill_slot_step` (one slot of the dense batched
cache) serve the BatchEngine.

The JAX package scans over layer-stacked weights; here the loop over layers
is plain Python and each layer's weight is a view of the stacked tensor (or
its own container, where a stack mixes kinds). The cache is updated in
place. `decode_loop` is a Python loop over steps (the JAX version is one
jitted scan; capturing the step as a CUDA graph is later work). It takes
the JAX `decode_loop`'s OpenAI options (a logit-bias table, presence and
frequency penalties over carried output counts, logprobs) and a
constrained request's vocabulary mask (`allowed_mask`) as plain PyTorch on
the step's logits, with no host read.

Speculative decoding (`verify_step`, `spec_decode_rounds` with the
on-device prompt-lookup drafter `_ngram_draft_device`, and
`draft_spec_rounds` with a draft model) verifies gamma drafts in one
forward of T = gamma + 1 tokens a row: on the dense cache the store's
chunk mode and K4 at each row's own offset, on the pool the paged store
and K4 over the gathered pages. The rounds run as a Python loop of device
work with no host read, one read-back a call. A lane that takes no part in
a round (frozen: it hit EOS, ran out of room, or holds no request) writes
no K/V row: on the dense cache it is given positions from the cache's
length on, which the store drops (the JAX functions feed it at its frozen
position, which writes that row; in the JAX BatchEngine that is row 0 of a
lane that is mid-prefill); on the pool its table is the sink page's.

Two opt-ins of the JAX package are read from the same environment
variables at the same points, with no config field, as there:

- ``NFAI_Q8V3`` (not "0"): `load_params` repacks every 8-bit layer stack
  that the JAX `q8v3_eligible` would take (groups of 16 or 32, K % 2048 ==
  0, no expert stack) and an untied 8-bit head into `Q8V3Tensor`, after the
  stacks are built (the NORM→NEOX rows and the fusions stay on `Q8Tensor`);
  they run through K12 (`ops.qmatmul.q8v3_matmul`). A tied 8-bit table stays
  a `Q8Tensor` on K6 (the embedding rows are gathered from it). In a
  `LayerList` the 8-bit layers are repacked and the 4-bit ones stay on K1,
  where the JAX package promotes the whole stack to 8 bits first: the same
  function. Under tp > 1 the JAX loader marks a split 8-bit weight's tp
  role before it repacks, and `q8v3_eligible` refuses a marked one: a
  column-split weight is marked where N/tp % 128 == 0 and the JAX kernel's
  tiles fit a shard, a row-split one where K % (tp * group) == 0 and they
  fit (`_jax_marks_tp`). So a rank's split weight stays a `Q8Tensor` on K6
  where the JAX package marks it, and only an unmarked one (the JAX
  package shards its q8v3 container) is repacked on the rank's shard.
- ``NFAI_PREFILL_KV`` → `_PREFILL_KV_LAYOUT`, read once at import ("full"
  by default): the kv_layout of K4 at both prefill call sites, the dense
  prefill and the paged prefill on gathered pages, bf16 and int8 caches.
  Under "headmajor" the caller makes the [B, Hkv, S, D] copy of each
  layer's K and V (the scales stay [B, Hkv, S]), as the JAX
  `_cached_attention` does; "merged" needs head_dim % 128 == 0. Any other
  value raises at use, where the JAX package silently runs "headmajor".

Tensor parallelism (parallel/, ``EngineConfig(mesh_shape=...)``): a rank
loads its shard (`load_params(..., tp=, tp_rank=)`, the split of
parallel.sharding) and runs this forward unchanged on the local config
(`parallel.sharding.local_config`: its heads and ffn columns), with the
engine's `parallel.comm.Comm` as ``params["comm"]``: wo's and the FFN's
partial sums are added in f32 over the tp group (`_finish_layer`), the
vocab-split logits gathered (`logits_for`), and a tied table split under
the head embeds vocab-parallel (`_embed`). A MoE model's experts split
over their ffn columns, or under ``params["expert_parallel"]`` over the
expert axis (`parallel.expert_parallel.moe_ffn_ep`); its FFN hands the f32
weighted sum to that reduce. Under sequence parallelism (``params["sp"]``,
the sp group's Comm) the dense cache is the rank's S slice and
`_sp_forward` runs instead of the prefill and decode paths. `forward`'s
`h0` / `final_norm` seams serve the pipeline stages
(parallel.pipeline_parallel).

Dense weights follow the JAX package's decisions: a matmul weight stays
quantized only where its kind has a container (Q4_0/Q4_1/Q4_K, Q8_0,
Q2_K/Q3_K/Q5_K/Q6_K), K % 64 == 0, N % 128 == 0 and the engine's
`param_dtype` is "auto" (the JAX `quantizable`); any other weight (F16,
BF16, F32, llama.cpp's fallback kinds Q5_0/Q5_1/IQ4_NL/IQ4_XS, Q8_1, Q8_K)
is decoded to f32 and rounded once to the activation dtype, [N, K] per
layer (GGUF's row order). A dense layer stack [L, N, K] runs through K11
(`ops.qmatmul.dense_matmul_layered`), which reads the layer in place; a
stack mixing quantized and dense layers is dequantized whole, and q/k/v or
gate/up whose parts mix the two stay split on every layer, as
`_fuse_projections` decides. A dense MLP is K11 on gate_up, the
activation, K11 on down (no K5). A dense tied table is one tensor serving
the embedding rows and the head; a dense head runs `torch.matmul` (JAX
leaves `x @ lm_head` to XLA). Dense expert stacks [L, E, N, K] run
`_moe_ffn_dense`, the JAX `_moe_ffn_grouped` (XLA's `ragged_dot`, no
Pallas kernel) in plain PyTorch: one product per hit expert, which reads
the expert counts back to the host once per layer.

qwen2, mistral and phi3 follow the JAX loader: mistral is NORM-roped like
llama (wq/wk rows permuted to NEOX at load); qwen2 and phi3 are NEOX.
qwen2's q/k/v biases (`attn_bias`, from `blk.0.attn_q.bias`) load as f32
[L, N] stacks, fuse into ``wqkv_bias`` exactly where q/k/v fuse, are kept
in the activation dtype and are added after the projections in `_qkv`
(every route: prefill, dense and paged decode, the verify forward, the
draft model). phi3's pre-fused ``attn_qkv`` loads as ``wqkv`` and its
[gate; up] ``ffn_up`` (2 * ffn_dim rows, no ``ffn_gate``) as
``w_gate_up`` (K5 where `mlp_eligible` holds). None of the three reads a
sliding window, as in the JAX package.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as nnf

from ..gguf import GGUFFile, Keys
from ..gguf.constants import tensor_nbytes
from ..ops.fused_decode import layered_decode_attention
from ..ops.fused_mlp import (
    MLP_FUSED_MAX_ROWS, activation, fused_mlp_layered, mlp_eligible, mlp_prefill,
)
from ..ops.kv_store import kv_store, kv_store_paged, quantize_kv  # noqa: F401 (quantize_kv: re-exported)
from ..ops.norms import rms_norm
from ..ops.paged_attention import gather_pages, paged_decode_attention
from ..ops.prefill_attention import flash_prefill_attention, head_major
from ..ops.qmatmul import linear, linear_layered, qmatmul_grouped
from ..ops.qtensor import (
    SUPPORTED_QUANT_TYPES, LayerList, concat, dequant_gather, from_jax_qtensor, n_layers,
    Q8Tensor, Q8V3Tensor, Q8V3_K_MULTIPLE, pack_gguf_tensor, permute_rows, q8v3_eligible, q8v3_from_codes,
    same_layout, stack, to_q8v3_stacked,
)
from ..ops.rope import (
    apply_rope_cs, compute_inv_freq, inv_freq_from_factors, norm_to_neox_perm,
    rope_cos_sin,
)
from ..ops.sampling import (
    apply_logit_bias, apply_penalties, sample_logits, spec_verify_sample, token_logprobs,
)
from ..parallel.sharding import (
    COL, EXPERT, ROW, col_rows, expert_cols, expert_range, row_range, slice_k, split_of,
)
from ..runtime.paged_cache import PagedKVCache


ARCHS = frozenset({"llama", "mistral", "qwen2", "qwen3", "qwen3moe", "gemma", "gemma2", "gemma3",
                   "phi3"})
# stored without the HF→ggml q/k permutation (the rest, llama and mistral, are NORM)
NEOX_ARCHS = ("qwen2", "qwen3", "qwen3moe", "phi3", "gemma", "gemma2", "gemma3")
# "full" feeds K4 the native merged-lane [B, S, KVD] cache; "headmajor" a
# per-layer [B, Hkv, S, D] copy; "merged" the native rows one head at a
# time (the JAX package's NFAI_PREFILL_KV, read at import as there)
_PREFILL_KV_LAYOUT = os.environ.get("NFAI_PREFILL_KV", "full")
GEMMA = ("gemma", "gemma2", "gemma3")
# llama.cpp's 27B detection by depth: only these scale q by (hidden // heads)^-0.5
GEMMA_27B_LAYERS = {"gemma2": 46, "gemma3": 62}


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
    attn_bias: bool = False  # qwen2: q/k/v biases after the projections
    qk_norm: bool = False  # qwen3, gemma3: per-head q/k RMS norms before the rope
    rope_neox: bool = False  # stored without the HF→ggml q/k permutation (NEOX_ARCHS)
    activation: str = "silu"  # MLP gate activation ("silu" | "gelu", tanh form)
    embed_scale: float = 1.0  # gemma multiplies embeddings by sqrt(hidden)
    # gemma2/3
    attn_softcap: float = 0.0  # gemma2: scores = cap * tanh(scores / cap)
    final_softcap: float = 0.0  # gemma2: the same cap on the f32 logits
    sliding_window: int = 0  # the local layers' attention window
    swa_pattern: int = 0  # layer i is local iff (i + 1) % pattern != 0
    post_norms: bool = False  # RMS norms on the attention and FFN outputs
    attn_scale: float = 0.0  # 0: head_dim^-0.5 (see `from_gguf`)
    rope_base_local: float = 0.0  # gemma3: the local layers' rope base
    # mixture of experts (qwen3moe); 0 experts = the dense MLP
    n_experts: int = 0
    n_experts_used: int = 0
    moe_ffn_dim: int = 0
    norm_topk_prob: bool = True

    def layer_is_local(self, i: int) -> bool:
        """Sliding-window (local) layer by llama.cpp's swa pattern: every
        `pattern`-th layer is global, the others local (gemma2: 2, gemma3:
        6)."""
        return self.swa_pattern > 0 and (i + 1) % self.swa_pattern != 0

    def layer_windows(self) -> list[int]:
        """Per-layer attention window (0 = unlimited)."""
        return [self.sliding_window if self.layer_is_local(i) else 0
                for i in range(self.n_layers)]

    @property
    def query_scale(self) -> float:
        return self.attn_scale or 1.0 / (self.head_dim**0.5)

    @classmethod
    def from_gguf(cls, g: GGUFFile) -> "LlamaConfig":
        md = g.metadata
        arch = g.architecture
        if arch not in ARCHS:
            raise NotImplementedError(
                f"architecture {arch!r} is not ported yet (the port runs {sorted(ARCHS)})"
            )
        unported = []
        if arch not in ("gemma2", "gemma3"):
            unported.append("blk.0.post_attention_norm.weight")
        if arch not in NEOX_ARCHS:
            unported.append("blk.0.attn_q_norm.weight")
        if arch != "qwen3moe":
            unported.append("blk.0.ffn_gate_exps.weight")
        extras = [name for name in unported if name in g.tensors]
        if extras:
            raise NotImplementedError(f"{arch} checkpoints with {extras} are not ported yet")

        def key(template, default=None):
            v = md.get(template.format(arch=arch))
            return default if v is None else v

        n_heads = int(key(Keys.HEAD_COUNT))
        hidden = int(key(Keys.EMBEDDING_LENGTH))
        n_layers = int(key(Keys.BLOCK_COUNT))
        vocab = key(Keys.VOCAB_SIZE)
        if vocab is None:
            vocab = len(md[Keys.TOKENIZER_TOKENS])
        gemma = arch in GEMMA
        return cls(
            vocab_size=int(vocab),
            hidden_size=hidden,
            n_layers=n_layers,
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
            attn_bias="blk.0.attn_q.bias" in g.tensors,
            qk_norm="blk.0.attn_q_norm.weight" in g.tensors,
            rope_neox=arch in NEOX_ARCHS,
            activation="gelu" if gemma else "silu",
            embed_scale=float(hidden) ** 0.5 if gemma else 1.0,
            attn_softcap=float(key("{arch}.attn_logit_softcapping", 0.0) or 0.0),
            final_softcap=float(key("{arch}.final_logit_softcapping", 0.0) or 0.0),
            sliding_window=(int(key("{arch}.attention.sliding_window", 0) or 0)
                            if arch in ("gemma2", "gemma3") else 0),
            swa_pattern={"gemma2": 2, "gemma3": 6}.get(arch, 0),
            post_norms="blk.0.post_attention_norm.weight" in g.tensors,
            # llama.cpp (llm_load_hparams): (hidden // heads)^-0.5 for the 27B
            # models only, head_dim^-0.5 otherwise; the JAX package takes
            # (hidden / heads)^-0.5 for every gemma2 (288^-0.5 at Gemma-2-2B,
            # whose query_pre_attn_scalar is 256)
            attn_scale=((hidden // n_heads) ** -0.5
                        if GEMMA_27B_LAYERS.get(arch) == n_layers else 0.0),
            rope_base_local=(float(key("{arch}.rope.freq_base_swa", 10000.0) or 10000.0)
                             if arch == "gemma3" else 0.0),
            n_experts=int(key(Keys.EXPERT_COUNT, 0) or 0),
            n_experts_used=int(key(Keys.EXPERT_USED_COUNT, 0) or 0),
            moe_ffn_dim=int(key("{arch}.expert_feed_forward_length", 0) or 0),
        )


@dataclass
class KVCache:
    """Dense KV cache, k/v [L, B, S, KVD] with KVD = Hkv*D (head-major
    columns): one token of one layer is one contiguous KVD row, and
    cache.k[l] is the [B, S, KVD] view the attention kernels read. The int8
    cache holds int8 codes in k/v and the per-(token, kv head) f32 scales in
    ks/vs [L, B, Hkv, S] (time-minor, the JAX layout); ks/vs are None for a
    bf16/f32 cache. Under sequence parallelism a rank holds the slots
    `offset` .. `offset` + S - 1 of a cache of `span` slots (`max_seq`);
    else offset is 0 and span S."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None
    offset: int = 0
    span: int = 0

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, max_seq: int,
              dtype=torch.bfloat16, device="cpu", quantized: bool = False) -> "KVCache":
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads * cfg.head_dim)
        if quantized:
            sshape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq)
            zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)  # noqa: E731
            return cls(zeros(shape, torch.int8), zeros(shape, torch.int8),
                       zeros(sshape, torch.float32), zeros(sshape, torch.float32))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_seq(self) -> int:
        """The cache's slots (all ranks' under sequence parallelism)."""
        return self.span or self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v, self.ks, self.vs)
                   if t is not None)

    def lane(self, slot: int) -> "KVCache":
        """Batch slot `slot` as a batch-1 cache of views (writes go to self)."""
        view = lambda t: None if t is None else t[:, slot:slot + 1]  # noqa: E731
        return KVCache(view(self.k), view(self.v), view(self.ks), view(self.vs), self.offset, self.span)


def dequant_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 codes q [B, S, KVD] with time-minor scales [B, H, S] → [B, S,
    KVD] in `dtype` (f32 product, then the cast)."""
    b, s, kvd = q.shape
    h = scale.shape[1]
    xh = q.reshape(b, s, h, kvd // h).float() * scale.transpose(1, 2)[..., None]
    return xh.reshape(b, s, kvd).to(dtype)


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
_QK_NORM_NAMES = {"q_norm": "blk.{i}.attn_q_norm.weight", "k_norm": "blk.{i}.attn_k_norm.weight"}
# qwen2: q/k/v biases (f32 [N] a layer), fused with the projections where they fuse
_BIAS_NAMES = {"wq_bias": "blk.{i}.attn_q.bias", "wk_bias": "blk.{i}.attn_k.bias",
               "wv_bias": "blk.{i}.attn_v.bias"}
# gemma2/3: RMS norms on the attention and FFN outputs
_POST_NORM_NAMES = {"post_attn_norm": "blk.{i}.post_attention_norm.weight",
                    "post_ffw_norm": "blk.{i}.post_ffw_norm.weight"}
# a qwen3moe layer: router + stacked expert tensors in place of the MLP
_MOE_NAMES = {
    "router": "blk.{i}.ffn_gate_inp.weight",
    "w_gate_exps": "blk.{i}.ffn_gate_exps.weight",
    "w_up_exps": "blk.{i}.ffn_up_exps.weight",
    "w_down_exps": "blk.{i}.ffn_down_exps.weight",
}


def _layer_names(cfg: LlamaConfig, tensors) -> dict[str, str]:
    """Params key → GGUF tensor template of one layer, per the config and
    the file's tensors: phi3's pre-fused ``attn_qkv`` maps onto ``wqkv``,
    and an ``ffn_up`` of 2 * ffn_dim rows with no ``ffn_gate`` ([gate; up])
    onto ``w_gate_up``, as the JAX loader maps them."""
    names = dict(_GGUF_NAMES)
    if "blk.0.attn_qkv.weight" in tensors:
        for k in ("wq", "wk", "wv"):
            del names[k]
        names["wqkv"] = "blk.{i}.attn_qkv.weight"
    up = tensors.get("blk.0.ffn_up.weight")
    if "blk.0.ffn_gate.weight" not in tensors and up is not None and up.shape[0] == 2 * cfg.ffn_dim:
        del names["w_gate"], names["w_up"]
        names["w_gate_up"] = "blk.{i}.ffn_up.weight"
    if cfg.attn_bias:
        names.update(_BIAS_NAMES)
    if cfg.qk_norm:
        names.update(_QK_NORM_NAMES)
    if cfg.post_norms:
        names.update(_POST_NORM_NAMES)
    if cfg.n_experts:
        for k in ("w_gate", "w_up", "w_down"):
            del names[k]
        names.update(_MOE_NAMES)
    return names


# (parts, fused key, their biases' keys, the fused bias key)
_FUSIONS = ((("wq", "wk", "wv"), "wqkv", tuple(_BIAS_NAMES), "wqkv_bias"),
            (("w_gate", "w_up"), "w_gate_up", (), ""))


def _stack_layers(per_layer: dict[str, list], fuse: bool = True) -> dict:
    """Per-layer parameter lists → layer stacks. q/k/v and gate/up fuse
    along N only when every layer's parts share a container or are all
    dense (the JAX `_fuse_projections` rule: a Q4_K_M file's Q6_K attn_v, or
    a dense part beside quantized ones, keeps the group split on every
    layer); q/k/v biases fuse into ``wqkv_bias`` exactly where q/k/v
    fuse, and stay split otherwise; a stack whose quantized layers mix
    kinds becomes a LayerList, one that mixes quantized and dense layers a
    dense stack (`stack`).
    Without `fuse` the parts stay as given (weights the JAX package has
    already fused or kept split)."""
    per_layer = dict(per_layer)
    for names, fused, biases, fused_bias in _FUSIONS if fuse else ():
        if all(n in per_layer for n in names):
            groups = list(zip(*(per_layer[n] for n in names)))
            # a part repacked on a tp shard stays split (`_q8v3_shard`)
            if all(same_layout(list(parts)) and not isinstance(parts[0], Q8V3Tensor) for parts in groups):
                per_layer[fused] = [concat(list(parts)) for parts in groups]
                for n in names:
                    del per_layer[n]
                if biases and all(n in per_layer for n in biases):
                    bias_groups = zip(*(per_layer[n] for n in biases))
                    per_layer[fused_bias] = [torch.cat(parts) for parts in bias_groups]
                    for n in biases:
                        del per_layer[n]
    return {k: stack(v) for k, v in per_layer.items()}


def _params(embed, layers: dict, final_norm, lm_head, inv_freq, inv_freq_local, dtype,
            device) -> dict:
    head = lm_head.to(device)
    if embed is lm_head:  # a dense tied table: one copy for the head and the rows
        embed = head
    elif embed is not None:
        embed = embed.to(dtype).to(device)
    out = {
        "embed": embed,
        # the q/k/v biases in the activation dtype: the forward adds them as
        # the JAX package does (bias.astype(projection dtype)), one add a part
        "layers": {k: (v.to(dtype) if k.endswith("_bias") else v).to(device) for k, v in layers.items()},
        "final_norm": final_norm.to(device),
        "lm_head": head,
        "inv_freq": inv_freq.to(device),
        "act_dtype": dtype,
        "fused_mlp": mlp_eligible(layers.get("w_gate_up"), layers.get("w_down")),
    }
    if inv_freq_local is not None:  # gemma3's local layers
        out["inv_freq_local"] = inv_freq_local.to(device)
    return out


def _q8v3_on() -> bool:
    return os.environ.get("NFAI_Q8V3", "0") != "0"


def _jax_q8_tiles_fit(k: int, n: int, group: int) -> bool:
    """The JAX `kernel_supported` of an 8-bit container [K, N]: the K tile
    of its decode tile picker (`_pick_tiles(0, k, n)`) holds a multiple of
    8 scale rows, or all of them."""
    n_tiles = (1024, 512, 256, 128) if n < 65536 else (512, 256, 128)
    tk = None
    if any(n % t == 0 for t in n_tiles):
        tk = next((t for t in (1024, 512, 256) if k % t == 0), None)
    if tk is None:
        tk = next((t for t in (512, 256, 128) if k % t == 0), k)
    rows = tk // group
    return rows % 8 == 0 or rows == k // group


def _jax_marks_tp(how: str, n: int, k: int, group: int, tp: int) -> bool:
    """Whether the JAX loader's `mark_tp` gives a whole 8-bit weight [N, K]
    split `how` over tp its tp role (nfai_tpu/models/llama.py): the shard's
    view must fit the JAX kernel. A marked weight keeps its q8 container
    under NFAI_Q8V3."""
    if how == COL:
        return n % tp == 0 and (n // tp) % 128 == 0 and _jax_q8_tiles_fit(k, n // tp, group)
    return k % (tp * group) == 0 and _jax_q8_tiles_fit(k // tp, n, group)


def _repack_q8v3(layers: dict, device) -> dict:
    """The JAX `repack` under NFAI_Q8V3: every eligible 8-bit layer stack
    (or 8-bit layer of a LayerList) → `Q8V3Tensor`, repacked on `device`;
    expert stacks and every other weight as they are."""

    def repack(w):
        return to_q8v3_stacked(w.to(device)) if q8v3_eligible(w) else w

    out = {}
    for key, w in layers.items():
        if key.endswith("_exps"):
            out[key] = w
        elif isinstance(w, LayerList):
            out[key] = LayerList([repack(it) for it in w.items])
        else:
            out[key] = repack(w)
    return out


def _q8v3_shard(w, how: str, tp: int, device):
    """A rank's shard `w` (one layer, or the head) of a weight split `how`
    over tp under NFAI_Q8V3: a `Q8V3Tensor` of the shard where the whole
    weight is one the JAX `q8v3_eligible` takes and its `mark_tp` leaves
    unmarked (the JAX package then shards the whole's q8v3 container,
    whose rows and scale groups are the shard's own), else `w` as it is.
    Such a part is never fused with others (`_stack_layers`), as the JAX
    `_fuse_projections_tp` fuses marked parts only."""
    if not (isinstance(w, Q8Tensor) and w.qs.dim() in (2, 3) and w.group in (16, 32)):
        return w
    n, k = (w.n * tp, w.k) if how == COL else (w.n, w.k * tp)
    if k % Q8V3_K_MULTIPLE or _jax_marks_tp(how, n, k, w.group, tp):
        return w
    w = w.to(device)
    return q8v3_from_codes(w.qs, 8.0 * w.scales, w.mins, w.group)


def load_params(g: GGUFFile, cfg: LlamaConfig, dtype=torch.bfloat16,
                device="cpu", quantized: bool = True, tp: int = 1, tp_rank: int = 0,
                expert_parallel: bool = False) -> dict:
    """GGUF → params dict on `device`. With `quantized` (the engine's
    ``param_dtype="auto"``) a matmul weight keeps a quantized container
    where the JAX `quantizable` holds (its kind has one, K % 64 == 0,
    N % 128 == 0); every other matmul weight, and all of them without
    `quantized`, is dense: decoded to f32 and rounded to `dtype`, one
    tensor at a time.

    - ``embed`` [V, H] dense in `dtype` (dequantized from any kind the
      reader decodes), or None for a tied checkpoint whose table stays
      quantized; a dense tied table is the ``lm_head`` tensor itself;
    - ``layers``: ``attn_norm``/``ffn_norm`` f32 [L, H]; the matmul weights
      as layer stacks of `Q4Tensor`/`Q8Tensor` (a `LayerList` where the
      quantized layers mix kinds) or dense [L, N, K] tensors in `dtype`:
      ``wqkv`` or ``wq``/``wk``/``wv`` (wq/wk rows
      permuted NORM → NEOX for llama and mistral), with qwen2's biases
      ``wqkv_bias`` or ``wq_bias``/``wk_bias``/``wv_bias`` ([L, N] in
      `dtype`), ``wo``, ``w_gate_up`` or
      ``w_gate``/``w_up``, ``w_down``; with q/k norms ``q_norm``/``k_norm``
      f32 [L, D]; with post norms ``post_attn_norm``/``post_ffw_norm`` f32
      [L, H]; a MoE model has ``router`` f32 [L, H, E] and the expert
      stacks ``w_gate_exps``/``w_up_exps``/``w_down_exps`` ([L, E, N, ...]
      containers, a LayerList of [E, N, ...] ones, or dense [L, E, N, K])
      in place of the MLP;
    - ``final_norm`` f32 [H]; ``lm_head`` the 2-D output weight (quantized,
      or dense [V, H]), or for a tied checkpoint the token table itself;
      ``inv_freq`` f32, and gemma3's ``inv_freq_local`` (its local layers' base, without
      the global layers' rope scaling, as the JAX package computes it);
    - ``act_dtype`` (`dtype`) and ``fused_mlp`` (whether the MLP takes K5).

    Under ``NFAI_Q8V3`` (not "0") the eligible 8-bit stacks and an untied
    8-bit head are `Q8V3Tensor`s (module doc).

    With `tp` > 1 the result is rank `tp_rank`'s shard (parallel.sharding):
    a column-split weight keeps its rank's GGUF rows, taken before packing
    (a fused qkv or [gate; up] its rows of each section; wq/wk permuted to
    NEOX on the rank's heads; an expert stack its rows of every expert), a
    row-split one (wo, w_down, w_down_exps) its K-range of the packed
    container (K/tp % 64 == 0, else ValueError), the head its vocabulary
    rows; with `expert_parallel` the expert stacks keep the rank's E/tp
    experts whole instead (`parallel.sharding.expert_range`; the params
    then carry ``expert_parallel``). Whether a weight stays quantized is
    decided on the whole tensor, as the JAX loader decides before it
    shards. Under NFAI_Q8V3 a split 8-bit weight is repacked on the rank
    only where the JAX loader leaves it without a tp role (module doc).
    """
    if expert_parallel and not cfg.n_experts:
        raise ValueError("expert_parallel needs an MoE model")
    hd = cfg.head_dim
    # the fused weights' sections: a rank keeps its rows of each
    sections = {"wqkv": (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd),
                "w_gate_up": (cfg.ffn_dim, cfg.ffn_dim)}

    def split(key: str) -> str | None:
        return split_of(key, expert_parallel) if tp > 1 and key else None

    def rows_of(key: str, n: int):
        """The GGUF rows rank `tp_rank` keeps of a column-split weight (of
        each expert of a stack; None: all of them)."""
        if split(key) != COL:
            return None
        return col_rows(n, tp, tp_rank, sections.get(key))

    def mat(name: str, key: str = ""):
        desc = g.tensors[name]
        *lead, n, k = desc.shape
        how, rows = split(key), rows_of(key, n)
        experts = expert_range(lead[0], tp, tp_rank) if how == EXPERT else None
        if not (quantized and desc.ggml_type in SUPPORTED_QUANT_TYPES
                and k % 64 == 0 and n % 128 == 0):  # the JAX `quantizable`, on the whole tensor
            w = torch.from_numpy(g.tensor_f32(name))
            if experts is not None:
                w = w[experts[0]:experts[1]]
            w = (w if rows is None else w[..., torch.from_numpy(rows), :]).to(dtype)
            return slice_k(w, *row_range(k, tp, tp_rank, False)) if how == ROW else w
        e = int(np.prod(lead, dtype=np.int64))
        # an expert stack [E, N, K] is E*N rows of K (experts contiguous)
        raw = g.tensor_bytes(name).reshape(e, n, tensor_nbytes(k, desc.ggml_type))
        if experts is not None:  # the rank's experts whole
            raw = raw[experts[0]:experts[1]]
            lead, e = [experts[1] - experts[0]], experts[1] - experts[0]
        if rows is not None:  # whole GGUF rows (of every expert), before packing
            if lead:
                expert_cols(n, tp)
            raw, n = raw[:, rows], rows.size
        w = pack_gguf_tensor(raw, desc.ggml_type, (e * n, k))
        if lead:
            w = w._map(lambda t: t.reshape(*lead, n, *t.shape[1:]), n=n)
        if how == ROW:  # the rank's K-range of the packed container
            w = slice_k(w, *row_range(k, tp, tp_rank, True))
        return w

    def vec(name: str, key: str = "") -> torch.Tensor:
        v = torch.from_numpy(np.ascontiguousarray(g.tensor_f32(name), np.float32))
        rows = rows_of(key, v.shape[0])  # a bias follows its projection's rows
        return v if rows is None else v[torch.from_numpy(rows)]

    names = _layer_names(cfg, g.tensors)
    per_layer: dict[str, list] = {k: [] for k in names}
    for i in range(cfg.n_layers):
        for key, template in names.items():
            name = template.format(i=i)
            if key.endswith(("norm", "bias")):
                per_layer[key].append(vec(name, key))
            elif key == "router":  # GGUF [E, H] → [H, E], f32 as the JAX route computes it
                per_layer[key].append(vec(name).T.contiguous())
            else:
                per_layer[key].append(mat(name, key))
    if not cfg.rope_neox and "wq" in per_layer:  # the JAX loader's rule (a pre-fused NORM qkv stays)
        # within each head: on a rank's shard, the permutation of its heads
        q_perm = norm_to_neox_perm(cfg.n_heads // tp, cfg.head_dim)
        k_perm = norm_to_neox_perm(cfg.n_kv_heads // tp, cfg.head_dim)
        per_layer["wq"] = [permute_rows(w, q_perm) for w in per_layer["wq"]]
        per_layer["wk"] = [permute_rows(w, k_perm) for w in per_layer["wk"]]
        if "wq_bias" in per_layer:
            per_layer["wq_bias"] = [b[q_perm] for b in per_layer["wq_bias"]]
            per_layer["wk_bias"] = [b[k_perm] for b in per_layer["wk_bias"]]
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
    inv_freq_local = (torch.from_numpy(compute_inv_freq(cfg.head_dim, cfg.rope_base_local))
                      if cfg.rope_base_local else None)
    if cfg.tied_embeddings:  # one table: the head, and the embedding rows (vocab-parallel under tp)
        lm_head = mat("token_embd.weight", "lm_head")
        embed = lm_head if isinstance(lm_head, torch.Tensor) else None
    else:
        embed = torch.from_numpy(g.tensor_f32("token_embd.weight"))
        lm_head = mat("output.weight", "lm_head")
        if _q8v3_on():  # an untied 8-bit head: no gather reads it
            lm_head = (_q8v3_shard(lm_head, COL, tp, device) if tp > 1
                       else to_q8v3_stacked(lm_head.to(device)) if q8v3_eligible(lm_head) else lm_head)
    if _q8v3_on() and tp > 1:  # each layer's shard, as the JAX loader's marks decide
        for key in per_layer:
            if split(key) in (COL, ROW):
                per_layer[key] = [_q8v3_shard(w, split(key), tp, device) for w in per_layer[key]]
    layers = _stack_layers(per_layer)
    if _q8v3_on() and tp == 1:
        layers = _repack_q8v3(layers, device)
    params = _params(embed, layers, vec("output_norm.weight"), lm_head,
                     torch.from_numpy(inv_freq), inv_freq_local, dtype, device)
    if expert_parallel and tp > 1:
        params["expert_parallel"] = True
    return params


def params_from_jax(np_params: dict, cfg: LlamaConfig, dtype=torch.float32,
                    device="cpu") -> dict:
    """The JAX package's `load_params` output (leaves as numpy; quantized
    leaves as its QTensor dataclass with numpy fields) → this package's
    params.

    Undoes the TPU packings (v2 split-half nibbles with the /16 and -8
    folds, v3 word planes, merged q4v3m scales, the q4mlpg/q4mlpd fused-MLP
    permutations, 8-bit containers, N padding; a "q8v3" container becomes a
    `Q8V3Tensor` with its bf16 scales and mins bit for bit) through
    `ops.qtensor.from_jax_qtensor`, keeps the projections fused or split as
    the JAX package left them, and routes as `load_params` does; a tied
    quantized table (``embed`` None) becomes the head and the embedding
    source. qwen3's and gemma3's q/k norms, gemma's post norms
    and qwen3moe's routers carry over as f32, gemma3's `inv_freq_local` as
    it is, its 4-D expert stacks (v2 4-bit [L, E, K/2, N], 8-bit
    [L, E, K, N], promoted or unified 8-bit) as [L, E, N, ...] containers.
    Dense leaves ([..., K, N]: layer and expert stacks, the head) become
    [..., N, K] tensors in `dtype`; a tied checkpoint's dense head (the
    JAX package keeps the table twice, as ``embed`` and its transpose)
    becomes one tensor serving both."""

    def conv(leaf):
        if not hasattr(leaf, "kind"):  # dense [..., K, N] → [..., N, K]
            dense = torch.from_numpy(np.array(leaf, np.float32))
            return dense.transpose(-1, -2).contiguous().to(dtype)
        return from_jax_qtensor(
            leaf.kind, np.asarray(leaf.qs), np.asarray(leaf.scales),
            None if leaf.mins is None else np.asarray(leaf.mins),
            leaf.k, leaf.n, leaf.sections, leaf.group, leaf.tfb,
        )

    src = np_params["layers"]
    unknown = set(src) - {"attn_norm", "ffn_norm", "wqkv", "wq", "wk", "wv",
                          "wo", "w_gate_up", "w_gate", "w_up", "w_down", "wqkv_bias",
                          *_BIAS_NAMES, *_QK_NORM_NAMES, *_POST_NORM_NAMES, *_MOE_NAMES}
    if unknown:
        raise NotImplementedError(f"layer parameters {sorted(unknown)} are not ported yet")
    per_layer = {}
    for key, leaf in src.items():
        if key.endswith(("norm", "bias")) or key == "router":  # f32 [L, D|H|N] / [L, H, E]
            per_layer[key] = list(torch.from_numpy(np.array(leaf, np.float32)))
        else:
            w = conv(leaf)
            per_layer[key] = (list(w) if isinstance(w, torch.Tensor)
                              else [w.layer(i) for i in range(n_layers(w))])
    embed, local = np_params.get("embed"), np_params.get("inv_freq_local")
    as_f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    lm_head = conv(np_params["lm_head"])
    if embed is not None:  # a dense tied head serves the embedding rows too
        tied_dense = cfg.tied_embeddings and isinstance(lm_head, torch.Tensor)
        embed = lm_head if tied_dense else as_f32(embed)
    return _params(
        embed, _stack_layers(per_layer, fuse=False),
        as_f32(np_params["final_norm"]), lm_head,
        as_f32(np_params["inv_freq"]), None if local is None else as_f32(local), dtype, device,
    )


# ---------------------------------------------------------------------------
# forward


def _embed(params: dict, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows in the activation dtype (gemma: times sqrt(hidden) in f32,
    then rounded, as the JAX package scales them). Under tensor parallelism
    a tied table is vocab-split under the head: `_embed_vocab_parallel`."""
    comm = params.get("comm")
    if comm is not None and (params["embed"] is None or params["embed"] is params["lm_head"]):
        h = _embed_vocab_parallel(params, comm, tokens)
    elif params["embed"] is None:  # tied: rows of the quantized head are the embedding
        h = dequant_gather(params["lm_head"], tokens).to(params["act_dtype"])
    else:
        h = params["embed"][tokens.long()]
    if cfg.embed_scale != 1.0:
        h = (h.float() * cfg.embed_scale).to(h.dtype)
    return h


def _embed_vocab_parallel(params: dict, comm, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of a tied table that is vocab-split under the head: each rank
    takes the ids in its range (rank * V/tp ..), writes zeros for the
    others, and the f32 rows are summed over the tp group (exact: one
    nonzero row an id), then rounded to the activation dtype."""
    head = params["lm_head"]
    v = head.shape[0] if isinstance(head, torch.Tensor) else head.n
    local = tokens.long() - comm.rank * v
    inside = (local >= 0) & (local < v)
    idx = local.clamp(0, v - 1)
    rows = head[idx].float() if isinstance(head, torch.Tensor) else dequant_gather(head, idx)
    rows = torch.where(inside[..., None], rows, 0.0)
    return comm.embed_reduce(rows).to(params["act_dtype"])


def _tp_sum(params: dict, partial: torch.Tensor) -> torch.Tensor:
    """A row-parallel output summed over the tp group in f32 (the JAX
    ``psum``); unchanged on one device."""
    comm = params.get("comm")
    return partial if comm is None else comm.all_reduce_f32(partial)


def _rope_tables(params: dict, cfg: LlamaConfig, positions: torch.Tensor) -> list:
    """Each layer's (cos, sin): gemma3's local layers take the tables of
    `inv_freq_local`, every other layer those of `inv_freq`."""
    glob = rope_cos_sin(positions, params["inv_freq"])
    if "inv_freq_local" not in params:
        return [glob] * cfg.n_layers
    loc = rope_cos_sin(positions, params["inv_freq_local"])
    return [loc if cfg.layer_is_local(i) else glob for i in range(cfg.n_layers)]


def _attn_kw(cfg: LlamaConfig, windows: list, layer: int) -> dict:
    """The attention kernels' options for `layer`: scale, softcap, window."""
    return dict(scale=cfg.query_scale, softcap=cfg.attn_softcap, window=windows[layer])


def _finish_layer(params: dict, cfg: LlamaConfig, h: torch.Tensor, attn: torch.Tensor,
                  layer: int) -> torch.Tensor:
    """The rest of a layer after attention: wo, the residual add, the FFN
    and its residual add, each output RMS-normed first where the model has
    post norms; h stays in its dtype. Under tensor parallelism wo's and the
    FFN's outputs are partial sums, added over the tp group before the post
    norms (which take the full sums), as the JAX psums are placed; a MoE
    FFN's partial is its f32 weighted sum (split over experts or over their
    ffn columns), rounded to h's dtype after the sum as the JAX
    `moe_ffn_ep` rounds it."""
    lp = params["layers"]
    out = _tp_sum(params, linear_layered(attn, lp["wo"], layer))
    if cfg.post_norms:
        out = rms_norm(out, lp["post_attn_norm"][layer], cfg.rms_eps)
    h = (h + out).to(h.dtype)
    # a MoE FFN under tp hands back its f32 partial: summed in f32, then rounded
    out = _tp_sum(params, _mlp(params, cfg, rms_norm(h, lp["ffn_norm"][layer], cfg.rms_eps), layer)).to(h.dtype)
    if cfg.post_norms:
        out = rms_norm(out, lp["post_ffw_norm"][layer], cfg.rms_eps)
    return (h + out).to(h.dtype)


def _qkv(lp: dict, x: torch.Tensor, layer: int, qd: int, kvd: int):
    """q, k, v projections of x [..., H]: one fused matmul where the
    checkpoint allows it, else three; qwen2's biases added after them in
    the projection's dtype (one add on the fused output, else one a part:
    plain PyTorch, as XLA adds them in the JAX forward; no kernel takes a
    bias)."""
    if "wqkv" in lp:
        qkv = linear_layered(x, lp["wqkv"], layer)
        if "wqkv_bias" in lp:
            qkv = qkv + lp["wqkv_bias"][layer].to(qkv.dtype)
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q, k, v = (linear_layered(x, lp[k], layer) for k in ("wq", "wk", "wv"))
    if "wq_bias" in lp:
        q, k, v = (y + lp[f"{n}_bias"][layer].to(y.dtype) for y, n in zip((q, k, v), ("wq", "wk", "wv")))
    return q, k, v


def _norm_rope(lp: dict, cfg: LlamaConfig, layer: int, q: torch.Tensor, k: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor):
    """q [.., Hq, D], k [.., Hkv, D] → per-head RMS-normed (qwen3) and
    roped, in their dtypes."""
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"][layer], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"][layer], cfg.rms_eps)
    return apply_rope_cs(q, cos, sin, neox=True), apply_rope_cs(k, cos, sin, neox=True)


def moe_route(x: torch.Tensor, router: torch.Tensor, n_used: int, norm_topk: bool):
    """Router softmax + top-k over x [N, H] (the JAX `_moe_route`): f32
    logits x @ router [H, E]; returns ([N, n_used] weights, renormalised to
    sum 1 when `norm_topk`, and int64 expert ids), largest first."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_vals, top_idx = torch.topk(probs, n_used, dim=-1)
    if norm_topk:
        top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    return top_vals, top_idx


def group_tm(rows: int) -> int:
    """Rows per grouped-matmul block (the JAX rule): 8 at decode (one weight
    read per hit expert), 32 / 128 as prefill chunks grow."""
    return 8 if rows <= 512 else (32 if rows <= 4096 else 128)


def moe_group_layout(flat_expert: torch.Tensor, n_rows: int, e: int, tm: int):
    """Group-aligned padded row layout (the JAX `_moe_group_layout`): the
    (token, slot) rows, sorted by expert with a stable argsort, go to
    offsets where each expert's rows start on a tm boundary, so every
    tm-row block belongs to one expert. Returns (order [rows], dst [rows]
    padded positions, block_group [m_pad/tm] int32, block_rows [m_pad/tm]
    int32, m_pad). m_pad is static (every active expert wastes < tm rows);
    block_group is JAX's (the empty blocks past the last expert's padded
    end clipped to expert E-1) and block_rows counts each block's real
    rows: 0 exactly on those empty blocks, which the kernels then fill with
    zeros without reading weights. Sizes come from a scatter-add of static
    length: nothing here reads the device back."""
    dev = flat_expert.device
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sizes = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    padded = (sizes + tm - 1) // tm * tm
    offs = torch.cumsum(padded, 0) - padded
    csizes = torch.cumsum(sizes, 0) - sizes
    within = torch.arange(n_rows, device=dev) - csizes[sorted_expert]
    dst = offs[sorted_expert] + within
    m_pad = -(-(n_rows + (tm - 1) * min(e, n_rows)) // tm) * tm
    ends = offs + padded
    block_start = torch.arange(m_pad // tm, device=dev) * tm
    g = torch.searchsorted(ends, block_start, right=True).clamp_max(e - 1)
    block_rows = (offs[g] + sizes[g] - block_start).clamp(0, tm).to(torch.int32)
    return order, dst, g.to(torch.int32), block_rows, m_pad


def expert_layer(w, layer: int):
    """Layer `layer`'s [E, N, ...] expert stack: a container's layer, a
    LayerList's item or a dense stack's [E, N, K] slice."""
    return w[layer] if isinstance(w, torch.Tensor) else w.layer(layer)


def moe_grouped(xf: torch.Tensor, top_vals: torch.Tensor, top_idx: torch.Tensor, wg, wu, wd,
                n_experts: int) -> torch.Tensor:
    """The grouped route of the MoE FFN (the JAX `_moe_ffn_grouped_q`) for
    tokens xf [N, H] routed to experts top_idx [N, used] with weights
    top_vals: lay the rows out group-aligned in bf16, gate / up / down
    through `qmatmul_grouped` (K8 / K9) on the [E, N, ...] stacks wg, wu,
    wd, silu(gate) * up rounded to bf16, then each row weighted and summed
    back to its token. Returns the f32 sums [N, H]."""
    n, hdim = xf.shape
    used = top_idx.shape[1]
    rows = n * used
    tm = group_tm(rows)
    order, dst, block_group, block_rows, m_pad = moe_group_layout(top_idx.reshape(-1), rows, n_experts, tm)
    token_of = order // used
    x_pad = torch.zeros(m_pad, hdim, dtype=torch.bfloat16, device=xf.device)
    x_pad[dst] = xf[token_of].to(torch.bfloat16)
    gate, up = (qmatmul_grouped(x_pad, w, block_group, tm, block_rows) for w in (wg, wu))
    inner = (nnf.silu(gate.float()) * up.float()).to(torch.bfloat16)
    down = qmatmul_grouped(inner, wd, block_group, tm, block_rows)
    dsel = down[dst].float() * top_vals.reshape(-1)[order][:, None]
    return torch.zeros(n, hdim, dtype=torch.float32, device=xf.device).index_add_(0, token_of, dsel)


def moe_ffn(params: dict, cfg: LlamaConfig, x: torch.Tensor, layer: int) -> torch.Tensor:
    """qwen3moe's FFN of layer `layer` for x [..., H] (the JAX `_moe_ffn`):
    route, then `moe_grouped` (K8 / K9) on quantized stacks or
    `_moe_ffn_dense` on dense ones. On one device the result is in x's
    dtype. Under tensor parallelism it is the rank's f32 partial, which
    `_finish_layer` sums over the tp group: with the ffn split every expert
    gives its share of the ffn columns; under expert parallelism
    (``params["expert_parallel"]``) the rank's E/tp experts run
    `parallel.expert_parallel.moe_ffn_ep`."""
    lp = params["layers"]
    ws = [expert_layer(lp[k], layer) for k in ("w_gate_exps", "w_up_exps", "w_down_exps")]
    dense = [isinstance(w, torch.Tensor) for w in ws]
    if any(dense) and not all(dense):
        raise NotImplementedError("expert stacks mixing dense and quantized kinds")
    lead, hdim = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, hdim)
    comm = params.get("comm")
    if params.get("expert_parallel"):
        from ..parallel.expert_parallel import moe_ffn_ep

        out = moe_ffn_ep(xf, lp["router"][layer], *ws, cfg, comm.rank, comm.size)
    else:
        top_vals, top_idx = moe_route(xf, lp["router"][layer], cfg.n_experts_used, cfg.norm_topk_prob)
        if dense[0]:
            out = _moe_ffn_dense(xf, top_vals, top_idx, *ws, cfg.n_experts, cfg.activation)
        else:
            out = moe_grouped(xf, top_vals, top_idx, *ws, cfg.n_experts)
    out = out.reshape(*lead, hdim)
    return out if comm is not None else out.to(x.dtype)


def _moe_ffn_dense(xf: torch.Tensor, top_vals: torch.Tensor, top_idx: torch.Tensor, wg, wu, wd,
                   n_experts: int, act: str) -> torch.Tensor:
    """The MoE FFN over dense expert stacks [E, N, K] (the JAX
    `_moe_ffn_grouped`, XLA's `ragged_dot` there): sort the (token, slot)
    rows by expert (stable), round them to the weights' dtype, one f32
    product per hit expert for gate, up and down, act(gate) * up rounded to
    the weights' dtype, each row weighted and summed back to its token.
    Returns the f32 sums [N, H]. The expert counts are read back to the
    host once a layer."""
    used = top_idx.shape[1]
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token_of = order // used
    xs = xf[token_of].to(wg.dtype)
    down = torch.empty(xs.shape[0], wd.shape[1], dtype=torch.float32, device=xf.device)
    start = 0
    for e, rows in enumerate(torch.bincount(flat, minlength=n_experts).tolist()):
        if rows:
            xe = xs[start:start + rows].float()
            gate, up = xe @ wg[e].float().T, xe @ wu[e].float().T
            inner = (activation(gate, act) * up).to(wg.dtype)
            down[start:start + rows] = inner.float() @ wd[e].float().T
            start += rows
    down = down * top_vals.reshape(-1)[order][:, None]
    out = torch.zeros(xf.shape[0], xf.shape[1], dtype=torch.float32, device=xf.device)
    return out.index_add_(0, token_of, down)


def _mlp(params: dict, cfg: LlamaConfig, x: torch.Tensor, layer: int) -> torch.Tensor:
    """The JAX package's FFN route: `moe_ffn` for a MoE model; K5 (up to
    MLP_FUSED_MAX_ROWS rows) or `mlp_prefill` where the pair is
    fused-eligible; else two (or three) dequant-matmuls around the
    activation (silu, or gemma's tanh-gelu, on every route)."""
    if cfg.n_experts:
        return moe_ffn(params, cfg, x, layer)
    lp, act = params["layers"], cfg.activation
    if params["fused_mlp"]:
        if x.numel() // x.shape[-1] > MLP_FUSED_MAX_ROWS:
            return mlp_prefill(x, lp["w_gate_up"].layer(layer), lp["w_down"].layer(layer), act)
        return fused_mlp_layered(x, lp["w_gate_up"], lp["w_down"], layer, act)
    f = cfg.ffn_dim
    if "w_gate_up" in lp:
        gu = linear_layered(x, lp["w_gate_up"], layer)
        gate, up = gu[..., :f], gu[..., f:]
    else:
        gate, up = (linear_layered(x, lp[k], layer) for k in ("w_gate", "w_up"))
    inner = (activation(gate.float(), act) * up.float()).to(x.dtype)
    return linear_layered(inner, lp["w_down"], layer)


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache, page_tables: torch.Tensor | None = None,
            h0: torch.Tensor | None = None, final_norm: bool = True):
    """Run the stack over tokens/positions [B, T]; returns (hidden [B, T, H]
    after the final norm, cache updated in place). On the dense `KVCache`,
    T == 1 takes the decode path (K2 + the store), T > 1 the prefill path
    (the store + K4). With `page_tables` [B, max_pages] int32 the cache is a
    `PagedKVCache` pool (`_paged_forward`). An int8 cache takes the int8
    entry points (module doc). Under sequence parallelism (``params["sp"]``,
    the sp group's Comm) the dense cache is this rank's S slice
    (`_sp_forward`).

    `h0` / `final_norm` are the pipeline stage seams (the JAX `forward`'s;
    parallel.pipeline_parallel): a stage after the first receives the
    previous stage's hidden state [B, T, H] as `h0` (no embedding), a stage
    before the last passes final_norm=False (the final RMS norm belongs to
    the last stage)."""
    if page_tables is not None:
        h, cache = _paged_forward(params, cfg, tokens, positions, cache, page_tables, h0)
    elif params.get("sp") is not None:
        h, cache = _sp_forward(params, cfg, tokens, positions, cache, h0)
    elif tokens.shape[1] == 1:
        h, cache = _decode_forward(params, cfg, tokens, positions, cache, h0)
    else:
        h, cache = _prefill_forward(params, cfg, tokens, positions, cache, h0)
    return (rms_norm(h, params["final_norm"], cfg.rms_eps) if final_norm else h), cache


def _input(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, h0) -> torch.Tensor:
    """The stack's input: the token rows, or a pipeline stage's `h0`."""
    return _embed(params, cfg, tokens) if h0 is None else h0.to(params["act_dtype"])


def _prefill_forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                     positions: torch.Tensor, cache: KVCache, h0=None):
    """A prefill chunk (T > 1) on the dense cache: per layer the store
    writes the chunk's K and V, then K4 attends over the cache."""
    b, t = tokens.shape
    lp = params["layers"]
    h = _input(params, cfg, tokens, h0)
    act = h.dtype
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    rope, windows = _rope_tables(params, cfg, positions), cfg.layer_windows()
    starts = positions[:, 0].to(torch.int32).contiguous()  # once per chunk, for every layer's K4
    for layer in range(cfg.n_layers):
        x = rms_norm(h, lp["attn_norm"][layer], cfg.rms_eps)
        q, k, v = _qkv(lp, x, layer, qd, kvd)
        q, k = _norm_rope(lp, cfg, layer, q.reshape(b, t, cfg.n_heads, cfg.head_dim),
                          k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim), *rope[layer])
        q = q.to(act)
        scales = {}
        if cache.quantized:  # the chunk is attended in its stored, quantized form
            scales = dict(k_scales=cache.ks[layer], v_scales=cache.vs[layer])
        kv_store(cache.k[layer], cache.v[layer], k.reshape(b, t, kvd), v, starts, cfg.n_kv_heads,
                 **scales)
        attn = _prefill_attention(q.contiguous(), cache.k[layer], cache.v[layer], starts,
                                  cfg.n_kv_heads, _attn_kw(cfg, windows, layer), scales)
        h = _finish_layer(params, cfg, h, attn.reshape(b, t, qd), layer)
    return h, cache


def _decode_forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, cache: KVCache, h0=None):
    """One token per row: K2 attends over cache[:, :starts] plus the new row;
    after the layer loop one store launch writes every layer's new K and V
    rows. An int8 cache is attended through its scales with the new row at
    full precision; the store quantizes the new rows for storage only and
    writes their codes and scales."""
    b = tokens.shape[0]
    lp = params["layers"]
    h = _input(params, cfg, tokens, h0)
    act = h.dtype
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    rope, windows = _rope_tables(params, cfg, positions), cfg.layer_windows()
    starts = positions[:, 0].to(torch.int32).contiguous()  # once per step, for K2 and the store
    # the new rows stay in the activation dtype until they are stored
    k_rows = torch.empty(cfg.n_layers, b, kvd, dtype=act if cache.quantized else cache.k.dtype,
                         device=h.device)
    v_rows = torch.empty_like(k_rows)
    for layer in range(cfg.n_layers):
        x = rms_norm(h, lp["attn_norm"][layer], cfg.rms_eps)
        q, k, v = _qkv(lp, x, layer, qd, kvd)
        q, k = _norm_rope(lp, cfg, layer, q.reshape(b, 1, cfg.n_heads, cfg.head_dim),
                          k.reshape(b, 1, cfg.n_kv_heads, cfg.head_dim), *rope[layer])
        q = q.to(act)
        k_rows[layer] = k.reshape(b, kvd)
        v_rows[layer] = v[:, 0]
        attn = layered_decode_attention(
            q.view(b, cfg.n_heads, cfg.head_dim), k_rows[layer], v_rows[layer], cache.k,
            cache.v, layer, starts, **_attn_kw(cfg, windows, layer), k_scales=cache.ks,
            v_scales=cache.vs,
        )
        h = _finish_layer(params, cfg, h, attn.reshape(b, 1, qd), layer)
    kv_store(cache.k, cache.v, k_rows, v_rows, starts, cfg.n_kv_heads, cache.ks, cache.vs)
    return h, cache


def _sp_forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: KVCache, h0=None):
    """Prefill chunks and decode steps under sequence parallelism: `cache`
    is this rank's slice [L, B, S/sp, KVD] of the dense cache, from global
    slot ``cache.offset``. Per layer the store writes the new K and V rows
    at positions - offset (it drops the rows outside the slice, so each
    rank keeps only its own), then `parallel.seq_parallel.sp_attention`
    attends over the slice (`local_flash`: softcap, window and the int8
    scales included) and merges the partials over the sp group. The JAX
    generic scan's order, store first and then attend
    (nfai_tpu/models/llama.py:761-775), which JAX takes under SP: an int8
    cache reads the new token back quantized, unlike K2's dense decode."""
    from ..parallel.seq_parallel import sp_attention

    b, t = tokens.shape
    lp, sp = params["layers"], params["sp"]
    h = _input(params, cfg, tokens, h0)
    act = h.dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rope, windows = _rope_tables(params, cfg, positions), cfg.layer_windows()
    local = (positions[:, 0] - cache.offset).to(torch.int32).contiguous()  # the store's starts in the slice
    for layer in range(cfg.n_layers):
        x = rms_norm(h, lp["attn_norm"][layer], cfg.rms_eps)
        q, k, v = _qkv(lp, x, layer, hq * hd, hkv * hd)
        q, k = _norm_rope(lp, cfg, layer, q.reshape(b, t, hq, hd), k.reshape(b, t, hkv, hd), *rope[layer])
        scales = {}
        if cache.quantized:
            scales = dict(k_scales=cache.ks[layer], v_scales=cache.vs[layer])
        kv_store(cache.k[layer], cache.v[layer], k.reshape(b, t, hkv * hd), v.reshape(b, t, hkv * hd),
                 local, hkv, **scales)
        attn = sp_attention(q.to(act), cache.k[layer], cache.v[layer], positions, cache.offset, sp,
                            **_attn_kw(cfg, windows, layer), **scales).to(act)
        h = _finish_layer(params, cfg, h, attn.reshape(b, t, hq * hd), layer)
    return h, cache


def _prefill_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, offsets: torch.Tensor,
                       n_kv_heads: int, attn_kw: dict, scales: dict) -> torch.Tensor:
    """K4 over one layer's merged-lane K/V [B, S, KVD] in the layout
    `_PREFILL_KV_LAYOUT` names (an unknown one raises in K4's wrapper):
    "headmajor" first copies them to [B, Hkv, S, D] (the JAX
    `_cached_attention`'s transpose)."""
    layout = _PREFILL_KV_LAYOUT
    if layout == "headmajor":
        kc, vc = head_major(kc, n_kv_heads), head_major(vc, n_kv_heads)
    return flash_prefill_attention(q, kc, vc, offsets, kv_layout=layout, **attn_kw, **scales)


def _gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """One layer's pool [Hkv, P, ps, D] + tables [B, NP] → the dense
    merged-lane [B, NP*ps, Hkv*D] view of each row's pages (a copy of the
    whole table width, as the JAX package gathers it)."""
    hkv, b, s, d = (g := gather_pages(pages, tables)).shape
    return g.permute(1, 2, 0, 3).reshape(b, s, hkv * d)


def _gather_page_scales(spool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """One layer's scale pool [Hkv, P, ps] + tables [B, NP] → the dense
    time-minor [B, Hkv, NP*ps] scales of each row's pages."""
    return gather_pages(spool, tables).transpose(0, 1)


def _paged_attention(q: torch.Tensor, pool: PagedKVCache, layer: int,
                     tables: torch.Tensor, first: torch.Tensor, attn_kw: dict) -> torch.Tensor:
    """Attention of new tokens q [B, T, Hq, D] against layer `layer` of the
    pool (their K/V already written), with the layer's `attn_kw` (scale,
    softcap, window). T == 1: K7 over the tables, `first` the lengths
    (positions[:, 0] + 1, int32). T > 1: K4 over the gathered dense view at
    offsets `first` (positions[:, 0], int32); an int8 pool's pages are
    dequantized into q's dtype first."""
    b, t, hq, d = q.shape
    k_pages, v_pages = pool.k[layer], pool.v[layer]
    hkv = k_pages.shape[0]
    if t == 1:
        scales = {} if not pool.quantized else dict(k_scales=pool.ks[layer], v_scales=pool.vs[layer])
        return paged_decode_attention(q[:, 0], k_pages, v_pages, tables, first, **attn_kw,
                                      **scales)[:, None]
    span = tables.shape[1] * k_pages.shape[2]
    if span % 64:
        raise ValueError(f"a block table spans {span} positions; the prefill attention "
                         "kernel needs a multiple of 64 (its key tile)")
    kd, vd = _gather_pages(k_pages, tables), _gather_pages(v_pages, tables)
    if pool.quantized:
        kd = dequant_kv(kd, _gather_page_scales(pool.ks[layer], tables), q.dtype)
        vd = dequant_kv(vd, _gather_page_scales(pool.vs[layer], tables), q.dtype)
    return _prefill_attention(q.contiguous(), kd, vd, first, hkv, attn_kw, {})


def _paged_forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, pool: PagedKVCache, tables: torch.Tensor, h0=None):
    """`forward` over the page pool: per layer, one store launch writes the
    roped K and V rows (an int8 pool: their codes and scales) through the
    tables, then `_paged_attention` runs. The pool's pages are whole on
    every rank of an sp group (the JAX scheduler's layout): no sequence
    parallelism here."""
    b, t = tokens.shape
    lp = params["layers"]
    h = _input(params, cfg, tokens, h0)
    act = h.dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rope, windows = _rope_tables(params, cfg, positions), cfg.layer_windows()
    slots = positions.to(torch.int32).contiguous()  # once for every layer's store
    first = positions[:, 0].to(torch.int32)
    first = (first + 1 if t == 1 else first).contiguous()
    for layer in range(cfg.n_layers):
        x = rms_norm(h, lp["attn_norm"][layer], cfg.rms_eps)
        q, k, v = _qkv(lp, x, layer, hq * hd, hkv * hd)
        q, k = _norm_rope(lp, cfg, layer, q.reshape(b, t, hq, hd), k.reshape(b, t, hkv, hd),
                          *rope[layer])
        q = q.to(act)
        scales = {} if not pool.quantized else dict(k_scales=pool.ks[layer], v_scales=pool.vs[layer])
        kv_store_paged(pool.k[layer], pool.v[layer], k, v.reshape(b, t, hkv, hd), tables, slots, **scales)
        attn = _paged_attention(q, pool, layer, tables, first, _attn_kw(cfg, windows, layer))
        h = _finish_layer(params, cfg, h, attn.reshape(b, t, hq * hd), layer)
    return h, pool


def logits_for(params: dict, hidden: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """LM head (K1 or K6; the tied table for a tied checkpoint) → f32
    logits, capped by gemma2's final softcap where `cfg` has one. Under
    tensor parallelism the rank's vocabulary slice is gathered from the tp
    group first, so every rank holds the whole logits."""
    logits = linear(hidden, params["lm_head"]).float()
    if (comm := params.get("comm")) is not None:
        logits = comm.gather_vocab(logits)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


@torch.inference_mode()
def prefill_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, last_index: torch.Tensor,
                 cache: KVCache):
    """Process a (padded) prompt chunk [B, T]; returns (logits [B, V] at each
    row's last real token, cache)."""
    h, cache = forward(params, cfg, tokens, positions, cache)
    rows = torch.arange(h.shape[0], device=h.device)
    h_last = h[rows, last_index.long().to(h.device)]
    return logits_for(params, h_last, cfg), cache


@torch.inference_mode()
def decode_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache, page_tables: torch.Tensor | None = None):
    """One token [B] at positions [B] for every row (through `page_tables`
    on a page pool); returns ([B, V] logits, cache)."""
    h, cache = forward(params, cfg, tokens[:, None], positions[:, None], cache, page_tables)
    return logits_for(params, h[:, 0], cfg), cache


def _decode_chunk(params, cfg, tok, pos, cache, page_tables, generator, n_steps,
                  temperature, top_k, top_p, min_p, active, top_k_rows, bias_ids=None,
                  bias_vals=None, presence=None, frequency=None, counts=None, n_logprobs=None,
                  allowed_mask=None, lanes=None):
    """The shared body of `decode_loop` and `paged_decode_loop`. Per step:
    logits → bias → penalties → vocabulary mask → sample → logprobs of the
    sampled token from those same logits; `counts` grow on active rows
    only. Nothing is read back to the host."""
    out, lps = [], []
    if counts is not None:
        counts = counts.clone()  # the caller's tensor stays as it was (the JAX contract)
        inc = (torch.ones(tok.shape[0], dtype=counts.dtype, device=tok.device) if active is None
               else active.to(counts.dtype))[:, None]
    for _ in range(n_steps):
        logits, cache = decode_step(params, cfg, tok, pos, cache, page_tables)
        if bias_ids is not None:
            logits = apply_logit_bias(logits, bias_ids, bias_vals)
        if counts is not None:
            logits = apply_penalties(logits, counts, 0.0 if presence is None else presence,
                                     0.0 if frequency is None else frequency)
        if allowed_mask is not None:  # a constrained row's illegal continuations
            logits = logits.masked_fill(~allowed_mask, float("-inf"))
        nxt = sample_logits(logits, generator, temperature, top_k, top_p,
                            min_p=min_p, top_k_rows=top_k_rows, lanes=lanes).to(tok.dtype)
        out.append(tok)
        if active is None:
            tok, pos = nxt, pos + 1
        else:  # frozen rows keep their token and never advance
            tok, pos = torch.where(active, nxt, tok), torch.where(active, pos + 1, pos)
        if n_logprobs is not None:  # of the token sampled this step: toks[:, 1:] + next_tokens
            lps.append(token_logprobs(logits, tok, n_logprobs))
        if counts is not None:
            counts.scatter_add_(1, tok.long()[:, None], inc)
    tail = () if counts is None else (counts,)
    if n_logprobs is not None:
        tail += tuple(torch.stack(parts, dim=1) for parts in zip(*lps))
    return (torch.stack(out, dim=1), tok, cache, generator) + tail


@torch.inference_mode()
def decode_loop(params: dict, cfg: LlamaConfig, first_tokens: torch.Tensor,
                start_pos: torch.Tensor, cache: KVCache,
                generator: torch.Generator | None, n_steps: int,
                temperature=0.0, top_k: int = 40, top_p=0.95, min_p=0.0,
                active: torch.Tensor | None = None,
                top_k_rows: torch.Tensor | None = None,
                bias_ids: torch.Tensor | None = None, bias_vals: torch.Tensor | None = None,
                presence=None, frequency=None, counts: torch.Tensor | None = None,
                n_logprobs: int | None = None, allowed_mask: torch.Tensor | None = None,
                lanes: tuple[int, int] | None = None):
    """Generate `n_steps` tokens on the device without a host sync per token.

    temperature, top_p and min_p are scalars or per-row [B]; `top_k_rows`
    [B] is a per-row top-k inside the `top_k` window; a row whose `active`
    [B] entry is False neither advances nor changes its token. Returns
    (tokens [B, n_steps], next_tokens [B], cache, generator): every emitted
    token has its K/V written; `next_tokens` is sampled but not yet fed
    through the model (the JAX `decode_loop` contract).

    The OpenAI options, as in the JAX package: `bias_ids`/`bias_vals`
    [B, W] add a fixed-width logit-bias table per row; `counts` [B, V]
    int32 (the output-token counts so far) turns on the presence/frequency
    penalties (`presence`, `frequency`: scalars or [B]) and adds the updated
    counts to the returns; `n_logprobs` (0 = the chosen token only) adds
    (chosen_lp [B, n_steps], top_ids [B, n_steps, k], top_lps [B, n_steps,
    k]), k = max(n_logprobs, 1), where step j describes the token it
    sampled: toks[:, j + 1], and next_tokens for the last step.
    `allowed_mask` [B, V] bool (constrained decoding: the caller runs one
    step a chunk and recomputes it on the host between chunks) sends every
    False entry to -inf after the bias and the penalties, before the sample
    and the logprobs, which then describe the masked distribution.
    `lanes` (lo, total): the B rows are lanes lo .. of a batch of `total`
    (a dp rank's share of the dense BatchEngine's), whose random draws the
    samples take (`ops.sampling.draw`)."""
    return _decode_chunk(params, cfg, first_tokens, start_pos, cache, None, generator,
                         n_steps, temperature, top_k, top_p, min_p, active, top_k_rows,
                         bias_ids, bias_vals, presence, frequency, counts, n_logprobs, allowed_mask,
                         lanes)


@torch.inference_mode()
def paged_decode_loop(params: dict, cfg: LlamaConfig, first_tokens: torch.Tensor,
                      start_pos: torch.Tensor, cache: PagedKVCache, tables: torch.Tensor,
                      generator: torch.Generator | None, n_steps: int,
                      temperature=0.0, top_k: int = 40, top_p=0.95, min_p=0.0,
                      active: torch.Tensor | None = None,
                      top_k_rows: torch.Tensor | None = None,
                      bias_ids: torch.Tensor | None = None, bias_vals: torch.Tensor | None = None,
                      presence=None, frequency=None, counts: torch.Tensor | None = None,
                      n_logprobs: int | None = None, allowed_mask: torch.Tensor | None = None):
    """`decode_loop` over the page pool: K/V rows are stored through the
    block tables [B, max_pages] int32 (sent once per chunk) and every layer
    attends with K7. Same returns and sampling arguments as `decode_loop`."""
    return _decode_chunk(params, cfg, first_tokens, start_pos, cache, tables, generator,
                         n_steps, temperature, top_k, top_p, min_p, active, top_k_rows,
                         bias_ids, bias_vals, presence, frequency, counts, n_logprobs, allowed_mask)


# ---------------------------------------------------------------------------
# speculative decoding


@torch.inference_mode()
def verify_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, positions: torch.Tensor,
                cache: KVCache):
    """Speculative verification (the JAX `verify_step`): T candidate tokens
    [B, T] (the first the committed next token) at positions [B, T] in ONE
    forward; returns (f32 logits at every position [B, T, V], cache). The
    K/V of all T candidates are written; a rejected candidate's rows are
    overwritten by later steps, and attention masks by position, so they
    are never seen."""
    h, cache = forward(params, cfg, tokens, positions, cache)
    return logits_for(params, h, cfg), cache


def _ngram_draft_device(hist: torch.Tensor, hlen: torch.Tensor, n: int, gamma: int):
    """On-device prompt-lookup draft (the JAX `_ngram_draft_device`): the
    most recent position of hist [B, S] (entries 0 .. hlen[b] - 1 valid,
    the pending token last) whose n-gram equals the trailing n-gram; the
    `gamma` tokens after it are the draft. Returns (draft [B, gamma],
    found [B]). On a miss, or where the continuation runs past the
    history, the draft repeats the last token (the verify rejects a bad
    draft: a miss costs acceptance only)."""
    b, s = hist.shape
    dev = hist.device
    hlen = hlen.to(device=dev, dtype=torch.int64)
    qidx = hlen[:, None] + torch.arange(-n, 0, device=dev)[None]
    q = torch.gather(hist, 1, qidx.clamp(0, s - 1))  # [B, n]
    hp = torch.cat([hist, torch.full((b, n), -1, dtype=hist.dtype, device=dev)], dim=1)  # -1 matches nothing
    win = torch.stack([hp[:, i:i + s] for i in range(n)], dim=-1)  # [B, S, n]
    match = (win == q[:, None, :]).all(-1)
    posr = torch.arange(s, device=dev)[None]
    valid = match & (posr < hlen[:, None] - n)  # the query itself is left out
    best = torch.where(valid, posr, -1).amax(1)
    found = (best >= 0) & (hlen >= n + 1)
    didx = best[:, None] + n + torch.arange(gamma, device=dev)[None]
    last = torch.gather(hist, 1, (hlen[:, None] - 1).clamp(0, s - 1))
    cont = torch.gather(hist, 1, didx.clamp(0, s - 1))
    draft = torch.where(found[:, None] & (didx < hlen[:, None]), cont, last)
    return draft, found


def _is_eos(x: torch.Tensor, eos_ids: torch.Tensor) -> torch.Tensor:
    return (x[..., None] == eos_ids).any(-1)


def _verify_forward(params, cfg, tin, pos, act, cache, page_tables):
    """The verify forward of one round: tin [B, T] at pos[b] + t on the
    active rows. A frozen row writes no K/V row: on the dense cache it runs
    at positions from the cache's length on (the store drops them; K4 and
    the rope take them), through the pool on the sink page (its table all
    zeros, positions 0 .. T - 1). Returns f32 logits [B, T, V]."""
    t = tin.shape[1]
    jt = torch.arange(t, device=tin.device)[None]
    if page_tables is None:
        posv = torch.where(act[:, None], pos[:, None] + jt, cache.max_seq + jt)
        tables = None
    else:
        posv = torch.where(act[:, None], pos[:, None] + jt, jt)
        tables = torch.where(act[:, None], page_tables, torch.zeros_like(page_tables))
    h, _ = forward(params, cfg, tin, posv, cache, tables)
    return logits_for(params, h, cfg)


def _accept(logits3, draft, generator, temps, top_k, top_ps, top_k_rows, min_ps, lanes=None):
    """(n_acc [B], new_tok [B]) of one verify: the argmax-prefix rule, or
    with `temps` rejection sampling (`spec_verify_sample`)."""
    if temps is not None:
        return spec_verify_sample(logits3, draft, generator, temps, top_k,
                                  1.0 if top_ps is None else top_ps, top_k_rows,
                                  0.0 if min_ps is None else min_ps, lanes)
    nxt = torch.argmax(logits3, dim=-1)  # [B, T]
    ok = (draft == nxt[:, :-1]).to(torch.int64)
    n_acc = torch.cumprod(ok, dim=1).sum(1)
    return n_acc, torch.gather(nxt, 1, n_acc[:, None])[:, 0]


def _commit(tin, n_acc, new_tok, tok, act, outs, ocnt, eos_ids):
    """A round's emitted tokens: tin[:, :n_acc + 1] ([tok] + the accepted
    drafts), cut before the first EOS (which is not emitted), none on a
    frozen row; they go to outs [B, n_out + 1] at ocnt (the last column
    takes the writes that are dropped). Returns (e [B] tokens emitted,
    hit_eos [B], the next pending token [B])."""
    t = tin.shape[1]
    n_out = outs.shape[1] - 1
    jt = torch.arange(t, device=tin.device)[None]
    e = n_acc + 1
    first_eos = torch.where(_is_eos(tin, eos_ids) & (jt < e[:, None]), jt, n_out).amin(1)
    hit_eos = first_eos < e
    e = torch.where(act, torch.where(hit_eos, first_eos, e), 0)
    new_tok = torch.where(act & ~hit_eos, new_tok, tok)
    oidx = torch.where(jt < e[:, None], ocnt[:, None] + jt, n_out).clamp(max=n_out)
    outs.scatter_(1, oidx, tin)
    return e, hit_eos, new_tok


def _spec_state(tokens, positions, active, eos_ids, n_out):
    """The rounds' starting state: int64 tokens and positions, bool active,
    the EOS ids on the device, and zeroed outs [B, n_out + 1] and counters."""
    dev = tokens.device
    zero = torch.zeros(tokens.shape[0], dtype=torch.int64, device=dev)
    return (tokens.to(torch.int64), positions.to(device=dev, dtype=torch.int64),
            active.to(device=dev, dtype=torch.bool), eos_ids.to(device=dev, dtype=torch.int64),
            torch.zeros(tokens.shape[0], n_out + 1, dtype=torch.int64, device=dev),
            zero, zero.clone(), zero.clone())


@torch.inference_mode()
def spec_decode_rounds(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, positions: torch.Tensor,
                       cache, hist: torch.Tensor, hist_len: torch.Tensor, eos_ids: torch.Tensor,
                       active: torch.Tensor, n_rounds: int, gamma: int, ngram: int,
                       page_tables: torch.Tensor | None = None, generator: torch.Generator | None = None,
                       temps=None, top_k: int = 64, top_ps=None, top_k_rows=None, min_ps=None,
                       lanes: tuple[int, int] | None = None):
    """Prompt-lookup speculative decoding (the JAX `spec_decode_rounds`):
    `n_rounds` of (on-device n-gram draft → one verify forward of gamma + 1
    tokens → accept) with no host read; the caller reads the results once.

    tokens [B] are the pending (sampled, not yet emitted) ids at positions
    [B]; hist [B, S] the history including the pending token, hist_len [B]
    its valid entries (S bounds the positions: a lane needs room for a whole
    round); eos_ids [E] (pad with -1); active [B]. With `page_tables`
    [B, max_pages] the cache is the page pool. Acceptance is the
    argmax-prefix rule (plain greedy's output exactly), or with `temps` [B]
    rejection sampling (`spec_verify_sample`, drawing from `generator`;
    top_k, top_ps, top_k_rows and min_ps as in sampling), under which
    greedy lanes keep the argmax rule; `lanes` as in `decode_loop`.

    A lane stops when its pending token is EOS, an accepted draft is EOS, or
    the cache lacks room for a round; it then writes no K/V row (module
    doc) and its state freezes. Returns (out_tokens [B, n_rounds*(gamma+1)],
    out_counts [B], next_tokens [B], next_pos [B], cache, hist, hist_len,
    active [B], drafted [B], accepted [B]): out_tokens[b, :out_counts[b]]
    are the emitted tokens in order (EOS left out)."""
    b, s_max = hist.shape
    t = gamma + 1
    n_out = n_rounds * t
    tok, pos, act, eos_ids, outs, ocnt, drafted, accepted = _spec_state(tokens, positions, active,
                                                                         eos_ids, n_out)
    dev = tok.device
    jt = torch.arange(t, device=dev)[None]
    # one more column takes the history writes that are dropped
    hist = torch.cat([hist.to(device=dev, dtype=torch.int64),
                      torch.zeros(b, 1, dtype=torch.int64, device=dev)], dim=1)
    hlen = hist_len.to(device=dev, dtype=torch.int64)
    for _ in range(n_rounds):
        act = act & ~_is_eos(tok, eos_ids) & (pos + t <= s_max)
        draft, _ = _ngram_draft_device(hist[:, :s_max], hlen, ngram, gamma)
        tin = torch.cat([tok[:, None], draft], dim=1)
        logits3 = _verify_forward(params, cfg, tin, pos, act, cache, page_tables)
        n_acc, new_tok = _accept(logits3, draft, generator, temps, top_k, top_ps, top_k_rows, min_ps, lanes)
        e, hit_eos, new_tok = _commit(tin, n_acc, new_tok, tok, act, outs, ocnt, eos_ids)
        # the history (which ends with tok) gains [the accepted drafts, the new pending token]
        entries = torch.cat([tin[:, 1:], torch.zeros_like(tin[:, :1])], dim=1)
        entries = torch.where(jt == (e - 1)[:, None], new_tok[:, None], entries)
        write = (act & ~hit_eos)[:, None] & (jt < e[:, None]) & (hlen[:, None] + jt < s_max)
        hist.scatter_(1, torch.where(write, hlen[:, None] + jt, s_max), entries)
        drafted += torch.where(act, gamma, 0)
        accepted += torch.where(act, n_acc, 0)
        act = act & ~hit_eos
        tok, pos, hlen, ocnt = new_tok, pos + e, hlen + e, ocnt + e
    return outs[:, :n_out], ocnt, tok, pos, cache, hist[:, :s_max], hlen, act, drafted, accepted


@torch.inference_mode()
def draft_spec_rounds(params: dict, cfg: LlamaConfig, dparams: dict, dcfg: LlamaConfig,
                      tokens: torch.Tensor, positions: torch.Tensor, cache: KVCache, dcache: KVCache,
                      eos_ids: torch.Tensor, active: torch.Tensor, n_rounds: int, gamma: int,
                      generator: torch.Generator | None = None, temps=None, top_k: int = 64,
                      top_ps=None, min_ps=None, max_seq: int | None = None):
    """Draft-model speculative decoding (the JAX `draft_spec_rounds`): per
    round the draft model rolls out gamma + 1 greedy steps through
    `decode_step` (the last one stores the last draft's K/V, so the draft
    cache has no hole after a full acceptance), the target verifies the
    gamma drafts in one forward, and the accepted prefix commits. Greedy
    acceptance gives the target's greedy output whatever the draft;
    `temps` selects rejection sampling against the greedy rollout (a
    point-mass proposal). `max_seq` bounds the positions (default: the
    shorter cache). The lane conventions and returns are those of
    `spec_decode_rounds` without the history: (out_tokens, out_counts,
    next_tokens, next_pos, cache, dcache, active, drafted, accepted)."""
    s_max = max_seq if max_seq is not None else min(cache.max_seq, dcache.max_seq)
    t = gamma + 1
    tok, pos, act, eos_ids, outs, ocnt, drafted, accepted = _spec_state(tokens, positions, active,
                                                                         eos_ids, n_rounds * t)
    for _ in range(n_rounds):
        act = act & ~_is_eos(tok, eos_ids) & (pos + t <= s_max)
        dtok, rollout = tok, []
        for j in range(t):  # a frozen lane runs past the draft cache's end: nothing is stored
            dlogits, dcache = decode_step(dparams, dcfg, dtok, torch.where(act, pos + j, dcache.max_seq),
                                          dcache)
            dtok = torch.where(act, torch.argmax(dlogits.float(), dim=-1), dtok)
            rollout.append(dtok)
        draft = torch.stack(rollout[:gamma], dim=1)
        tin = torch.cat([tok[:, None], draft], dim=1)
        logits3 = _verify_forward(params, cfg, tin, pos, act, cache, None)
        n_acc, new_tok = _accept(logits3, draft, generator, temps, top_k, top_ps, None, min_ps)
        e, hit_eos, new_tok = _commit(tin, n_acc, new_tok, tok, act, outs, ocnt, eos_ids)
        drafted += torch.where(act, gamma, 0)
        accepted += torch.where(act, n_acc, 0)
        act = act & ~hit_eos
        tok, pos, ocnt = new_tok, pos + e, ocnt + e
    return outs[:, :-1], ocnt, tok, pos, cache, dcache, act, drafted, accepted


@torch.inference_mode()
def paged_prefill_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                       positions: torch.Tensor, last_index: torch.Tensor,
                       cache: PagedKVCache, tables: torch.Tensor):
    """Prefill one sequence's (padded) chunk [1, T] through its block table
    [1, max_pages]; returns (logits [1, V] at the chunk's last real token,
    the pool, updated in place). The table isolates the slot's pages."""
    h, cache = forward(params, cfg, tokens, positions, cache, page_tables=tables)
    rows = torch.arange(h.shape[0], device=h.device)
    return logits_for(params, h[rows, last_index.long().to(h.device)], cfg), cache


@torch.inference_mode()
def prefill_slot_step(params: dict, cfg: LlamaConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, last_index: torch.Tensor,
                      cache: KVCache, slot: int):
    """Prefill one sequence's chunk [1, T] into batch slot `slot` of a dense
    batched cache [L, B, S, KVD]: the chunk runs as a batch-1 forward on the
    slot's lane, a view (cache.k[:, slot:slot+1], and an int8 cache's
    ks/vs[:, slot:slot+1]), so it writes the shared cache in place and
    nothing is copied back. Returns (logits [1, V], cache)."""
    logits, _ = prefill_step(params, cfg, tokens, positions, last_index, cache.lane(slot))
    return logits, cache
