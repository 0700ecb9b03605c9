"""The Megatron split of the llama-schema params over the tp axis.

Counterpart of nfai_tpu/parallel/sharding.py. The split table mirrors
`llama_param_shardings`:

- column-split (the output axis N, whole GGUF rows): ``wq``, ``wk``,
  ``wv`` (and a fused ``wqkv`` as ``[q_r | k_r | v_r]``), ``w_gate``,
  ``w_up`` (and a fused ``w_gate_up`` as ``[gate_r | up_r]``), qwen2's
  biases, and ``lm_head`` over the vocabulary;
- row-split (the input axis K): ``wo`` and ``w_down``, whose outputs are
  partial sums that `parallel.comm.Comm.all_reduce_f32` adds;
- a MoE model (qwen3moe): the ``router`` replicated; without expert
  parallelism the stacked experts split over their ffn columns, as the
  JAX table does (nfai_tpu/parallel/sharding.py:130-146):
  ``w_gate_exps`` and ``w_up_exps`` column-split (each expert's N/tp
  rows), ``w_down_exps`` row-split (its K range); with
  `EngineConfig.expert_parallel` the three split over their expert axis
  instead ("expert": a rank's E/tp experts whole, the JAX
  `expert_shardings`), while attention keeps its Megatron split;
- replicated: the norms, the q/k norms, an untied ``embed``, ``inv_freq``
  (and gemma3's ``inv_freq_local``). A tied table (``embed`` None for a
  quantized one, or the dense head itself) lives under the vocab-split
  head, and the embedding gathers its rows vocab-parallel
  (`Comm.embed_reduce`); the JAX package keeps a replica of a dense tied
  table as ``embed``, the port one tensor for both.

``dp`` replicates the model. Each rank holds one standalone container a
weight (`Q4Tensor`, `Q8Tensor`, dense), so the JAX package's per-section
packing of row-parallel 4-bit weights (``QTensor.sections``, needed there
because GSPMD shards one packed array) has no counterpart: a rank's
K-range is sliced out of the packed container at a multiple of its scale
group, under the JAX rule K/tp % 64 == 0 (`ROW_K_MULTIPLE`).

A rank runs the unchanged forward on a local config (`local_config`):
n_heads, n_kv_heads, ffn_dim (and moe_ffn_dim under the ffn split) divided
by tp; head_dim, the attention scale (computed from the global widths at
load), embed_scale, the windows, the experts and the vocabulary stay those
of the whole model.

The grouped expert kernels (K8, K9) need N % 64 == 0 for the prefill's row
blocks of 32 and more: a column split of quantized experts whose N/tp
breaks it raises ValueError naming the rule (`expert_cols`), as a row
split whose K/tp % 64 != 0 does (`row_range`); neither falls back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.qtensor import Q4Tensor, Q8Tensor

COL, ROW, EXPERT = "col", "row", "expert"
# params["layers"] key -> split (absent: replicated)
LAYER_SPLITS = {
    "wq": COL, "wk": COL, "wv": COL, "wqkv": COL, "w_gate": COL, "w_up": COL, "w_gate_up": COL,
    "wq_bias": COL, "wk_bias": COL, "wv_bias": COL, "wqkv_bias": COL,
    "wo": ROW, "w_down": ROW,
    "w_gate_exps": COL, "w_up_exps": COL, "w_down_exps": ROW,
}
EXPERT_KEYS = ("w_gate_exps", "w_up_exps", "w_down_exps")
ROW_K_MULTIPLE = 64  # a row-split container's K per rank (the JAX rule, qtensor.py)
GROUPED_N_MULTIPLE = 64  # K8/K9's N rule for row blocks of 32 and more (ops/qmatmul.py)


def split_of(key: str, expert_parallel: bool = False) -> str | None:
    """A params key's split: its layer split ("expert" for the expert
    stacks under expert parallelism), "col" for the head (over the
    vocabulary), None (replicated) for the rest."""
    if key == "lm_head":
        return COL
    if expert_parallel and key in EXPERT_KEYS:
        return EXPERT
    return LAYER_SPLITS.get(key)


def validate_tp(cfg, tp: int) -> None:
    """The JAX `validate_tp`: every split width must divide by tp."""
    problems = []
    if cfg.n_heads % tp:
        problems.append(f"n_heads={cfg.n_heads}")
    if cfg.n_kv_heads % tp:
        problems.append(f"n_kv_heads={cfg.n_kv_heads}")
    if cfg.ffn_dim % tp:
        problems.append(f"ffn_dim={cfg.ffn_dim}")
    if getattr(cfg, "moe_ffn_dim", 0) and cfg.moe_ffn_dim % tp:
        problems.append(f"moe_ffn_dim={cfg.moe_ffn_dim}")
    if cfg.vocab_size % tp:
        problems.append(f"vocab_size={cfg.vocab_size}")
    if problems:
        raise ValueError(
            f"tensor-parallel size {tp} does not divide: {', '.join(problems)}"
        )


def param_splits(params: dict) -> dict:
    """The split of every entry of a (single-device or rank) params tree:
    "col", "row" or None (replicated); ``embed`` None where the table is
    tied (it lives under the head)."""
    tied = params["embed"] is None or params["embed"] is params["lm_head"]
    ep = bool(params.get("expert_parallel"))
    return {
        "embed": None,
        "tied": tied,
        "layers": {k: split_of(k, ep) for k in params["layers"]},
        "final_norm": None,
        "lm_head": split_of("lm_head"),
        "inv_freq": None,
        **({"inv_freq_local": None} if "inv_freq_local" in params else {}),
    }


def local_config(cfg, tp: int, expert_parallel: bool = False):
    """The config a rank's forward runs: heads and ffn divided by tp (the
    experts' ffn too, unless they split over the expert axis), everything
    derived from the whole model kept."""
    if tp == 1:
        return cfg
    moe = getattr(cfg, "moe_ffn_dim", 0)
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                               ffn_dim=cfg.ffn_dim // tp,
                               **({"moe_ffn_dim": moe // tp} if moe and not expert_parallel else {}))


def col_rows(n: int, tp: int, rank: int, sections: tuple[int, ...] | None = None) -> np.ndarray:
    """The output rows rank `rank` keeps of an N-row weight: a contiguous
    N/tp block, or of a fused weight whose N is `sections` (q, k, v or gate,
    up) the rank's block of each section, joined in section order."""
    sections = sections or (n,)
    if sum(sections) != n:
        raise ValueError(f"sections {sections} do not add up to N={n}")
    out, base = [], 0
    for s in sections:
        w = s // tp
        out.append(np.arange(base + rank * w, base + (rank + 1) * w))
        base += s
    return np.concatenate(out)


def slice_k(w, k0: int, k1: int):
    """Columns k0 .. k1 - 1 of a weight (the input axis): a quantized
    container is sliced at a multiple of its scale group (K/tp % 64 == 0 is
    required by `row_range`), a dense [..., N, K] tensor directly; the
    result is contiguous (the kernels read it as a standalone container)."""
    if isinstance(w, torch.Tensor):
        return w[..., k0:k1].contiguous()
    if not isinstance(w, (Q4Tensor, Q8Tensor)):
        raise NotImplementedError(f"no row split for a {type(w).__name__}")
    g = w.group
    if k0 % g or k1 % g:
        raise ValueError(f"K slice {k0}..{k1} is not at a multiple of the scale group {g}")
    per_byte = 2 if isinstance(w, Q4Tensor) else 1
    qs = w.qs[..., k0 // per_byte:k1 // per_byte].contiguous()
    cut = lambda t: None if t is None else t[..., k0 // g:k1 // g].contiguous()  # noqa: E731
    return dataclasses.replace(w, qs=qs, scales=cut(w.scales), mins=cut(w.mins), k=k1 - k0)


def expert_cols(n: int, tp: int) -> None:
    """A column-split quantized expert stack keeps N/tp rows an expert,
    which K8/K9 take at every row block only where N/tp % 64 == 0."""
    if (n // tp) % GROUPED_N_MULTIPLE:
        raise ValueError(f"a column-split quantized expert stack needs N/tp % {GROUPED_N_MULTIPLE} == 0 "
                         f"(the grouped matmul's rule for row blocks of 32 and more); N={n}, tp={tp} "
                         f"gives {n // tp}")


def expert_range(e: int, tp: int, rank: int) -> tuple[int, int]:
    """Rank `rank`'s experts [e0, e1) of E under expert parallelism."""
    if e % tp:
        raise ValueError(f"n_experts={e} must be divisible by tp={tp} for expert_parallel")
    w = e // tp
    return rank * w, (rank + 1) * w


def row_range(k: int, tp: int, rank: int, quantized: bool) -> tuple[int, int]:
    """Rank `rank`'s K-range of a row-split weight; a quantized one needs
    K/tp % 64 == 0 (raised at load where it fails)."""
    if k % tp:
        raise ValueError(f"K={k} does not divide by tp={tp}")
    w = k // tp
    if quantized and w % ROW_K_MULTIPLE:
        raise ValueError(f"a row-split quantized weight needs K/tp % {ROW_K_MULTIPLE} == 0; "
                         f"K={k}, tp={tp} gives {w}")
    return rank * w, (rank + 1) * w
