"""Inference engine: model loading, chunked prefill, streaming decode, chat.

Counterpart of nfai_tpu/runtime/engine.py for a single device. The prompt
is prefilled in bucketed chunks (`prefill_step`), then tokens are generated
in chunks of up to `decode_chunk` steps (`decode_loop`) whose sampled ids
are read back once per chunk; EOS, the token budget and the cache length
end generation exactly as in the JAX engine, so greedy output is the same.

`EngineConfig(kv_dtype="int8")` keeps the KV cache as int8 codes with
per-(token, kv head) f32 scales (`KVCache.zeros(..., quantized=True)`; the
model's int8 routes are described in models.llama).

`EngineConfig(param_dtype=...)`: "auto" keeps every GGUF weight whose kind
and shape have a kernel layout quantized; a dtype name dequantizes every
matmul weight at load into the activation dtype (dense weights, K11), as
the JAX engine does for any value but "auto". The port takes only "auto"
or the activation dtype's own name: the JAX engine reads a misspelt value,
or another dtype, as a request for the activation dtype.

`generate` takes the OpenAI options of `SamplingParams` as the JAX engine
does: a logit bias (the first token's at prefill too), presence/frequency
penalties over the output tokens (a [1, V] count that the decode chunks
carry on the device) and logprobs (`GenerationMetrics.logprobs`, one entry
per emitted token, read back with the chunk's tokens). `ChatSession.save`
and `load` write and read the JAX package's session file.

Constrained requests (`response_format` "json"/"json_schema", `json_schema`,
`grammar` GBNF, `regex`) run one token a step: the host automaton
(`grammar.machine_for`, or `constrained.JsonMachine` for plain JSON) gives a
[V] mask of legal continuations, applied after the logit bias and the
penalties (the JAX engine's constrained path drops both; its BatchEngine
applies them), and the sample is read back each step. Near the token budget
the masks only close the structure, so the output ends as a complete match.

`EngineConfig(speculative="ngram")` drafts from the most recent n-gram of the
prompt and output (`models.llama.spec_decode_rounds`), `"draft"` from a
second, smaller GGUF of the same vocabulary (`draft_gguf`,
`draft_spec_rounds`); `spec_rounds` rounds of gamma = `spec_tokens` drafts
and one verify forward each run per read-back. Greedy requests give plain
greedy's tokens, sampled ones plain sampling's law. A request with a logit
bias, penalties, logprobs or a constraint decodes without speculation, as
in the JAX engine. Any other `speculative` value is a ValueError (the JAX
engine runs plain decoding on a misspelt one).

`EngineConfig(mesh_shape={"dp": d, "tp": t, ...})` runs the engine as one
rank of a `torch.distributed` world (parallel/: `init_distributed` first,
one process a rank, rank r on cuda:(r % device count) unless the caller
asks for the CPU): `make_mesh` then `validate_tp` and the checks of the
options (the JAX order), then the rank loads only its shard of every
column- and row-parallel weight (`load_params(tp=, tp_rank=)`), holds only
its kv-heads in the cache and the BatchEngine's pool, and runs the forward
on its local config (`model_cfg`; `global_cfg` is the whole model's) with
the engine's `parallel.comm.Comm` (two f32 all-reduces a layer, one gather
of the vocab-split logits). dp replicates the model: a dense cache of B
lanes, B a multiple of dp, holds on a rank its dp group's B/dp lanes
(`lanes`, `new_cache`; the JAX `kv_cache_sharding`), which the dense
BatchEngine decodes and prefills there (runtime.scheduler); any other
batch (`generate`'s one row) replicates over dp, and the engine's own
calls run whole on every dp group (``dp_comm`` is the dp group's Comm).
An axis other than dp, tp and sp (any name the caller gives) replicates.
Every rank runs this host code on the same inputs; the logits are
gathered to every rank, so with one shared seed (a request without one
takes rank 0's) all ranks sample the same tokens. The groups live on the
engine and its params, so engines in one process keep theirs; an engine
given a `Mesh` of its mesh shape (`mesh=`) takes its groups instead of
making new ones, as the draft engine takes its target's.

A MoE model under tp splits its expert stacks over their ffn columns (gate
and up by columns, down by rows: K8/K9 at the rank's widths, one f32 sum
of the FFN a layer); `expert_parallel=True` (n_experts divisible by tp)
splits them over their experts instead (parallel.expert_parallel, one f32
sum of the FFN a layer). `seq_parallel=True` with an "sp" axis (sp > 1,
max_seq_len divisible by sp) gives each rank of an sp group its slice of
the dense cache's S axis (`new_cache`: slots sp_rank * S/sp ..) and runs
attention over the slice with the partials merged over the group
(parallel.seq_parallel; ``sp_comm``); a session saved under it gathers
the slices, and resumes on one device. A mesh with an "sp" axis and
seq_parallel off replicates over sp. Either flag without a mesh raises
ValueError (the JAX engine ignores it). The draft model
(speculative="draft") runs under any mesh: its engine takes the target's
config, mesh shape included, and the target's `Mesh`, with a Comm of its
own on its own params. NFAI_Q8V3 under tp > 1 repacks what the JAX loader
repacks there (models.llama, `load_params`).
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from ..config import EngineConfig, SamplingParams
from ..device import resolve_device
from ..gguf import GGUFFile, Keys
from ..constrained import JsonMachine, constraint_for
from ..grammar import machine_for
from ..models import KVCache, decode_loop, prefill_step, resolve
from ..models.llama import draft_spec_rounds, spec_decode_rounds
from ..ops.sampling import apply_logit_bias, logprob_entry, sample_logits, token_logprobs
from ..parallel import Comm, local_config, make_mesh, mesh_dims, validate_tp
from ..parallel.distributed import local_device_index
from ..parallel.mesh import DP_AXIS, SP_AXIS, Mesh
from ..tokenizer import (
    ChatTemplate,
    Message,
    StreamDetokenizer,
    TextStopper,
    tokenizer_from_gguf,
)

_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


def _ngram_propose(history: list[int], n: int, gamma: int) -> list[int] | None:
    """Most recent occurrence of the trailing n-gram in `history`; returns up
    to `gamma` continuation tokens (prompt-lookup decoding on the host, the
    JAX `_ngram_propose`)."""
    ln = len(history)
    if ln < n + 1:
        return None
    key = history[-n:]
    for j in range(ln - n - 1, -1, -1):
        if history[j:j + n] == key:
            return history[j + n:j + n + gamma] or None
    return None


def _bucket(n: int, cap: int) -> int:
    for b in _PREFILL_BUCKETS:
        if n <= b and b <= cap:
            return b
    return cap


SPECULATIVE = ("off", "ngram", "draft")


def _check_config(config: EngineConfig) -> None:
    if config.kv_dtype not in ("auto", "", "int8"):
        raise NotImplementedError(f"kv_dtype={config.kv_dtype!r} is not ported ('auto' or 'int8')")
    if config.speculative not in SPECULATIVE:
        raise ValueError(f"speculative={config.speculative!r}: use one of {SPECULATIVE}")
    if config.param_dtype not in ("auto", config.dtype):
        raise ValueError(
            f"param_dtype={config.param_dtype!r}: use 'auto' (keep quantized weights) or the "
            f"activation dtype {config.dtype!r} (dequantize every matmul weight into it)"
        )


def _check_parallel(config: EngineConfig, mesh, cfg) -> None:
    """The JAX engine's checks of seq_parallel and expert_parallel, in its
    order (after `make_mesh` and `validate_tp`), with the messages the right
    way round; either flag without a mesh raises (the JAX engine ignores
    it)."""
    if mesh is None:
        if flags := [k for k in ("seq_parallel", "expert_parallel") if getattr(config, k)]:
            raise ValueError(f"EngineConfig {flags} needs a mesh (no mesh_shape is set)")
        return
    if config.seq_parallel:
        if mesh.sp <= 1:
            raise ValueError("seq_parallel needs mesh_shape={'sp': n>1}")
        if config.max_seq_len % mesh.sp:
            raise ValueError(f"max_seq_len={config.max_seq_len} must be divisible by the sp axis ({mesh.sp})")
    if config.expert_parallel:
        if not cfg.n_experts:
            raise ValueError("expert_parallel needs an MoE model")
        if cfg.n_experts % mesh.tp:
            raise ValueError(f"n_experts={cfg.n_experts} must be divisible by tp={mesh.tp} for expert_parallel")


def check_bias_ids(sampling: SamplingParams, vocab_size: int) -> None:
    """A logit_bias id outside the vocabulary is a ValueError (an index
    the device scatter cannot take; the JAX scatter drops it silently)."""
    bad = [int(i) for i, _ in sampling.logit_bias if not 0 <= int(i) < vocab_size]
    if bad:
        raise ValueError(f"logit_bias token ids {bad} are outside the vocabulary (size {vocab_size})")


@dataclass
class GenerationMetrics:
    """Request-level metrics: TTFT and decode tokens/s."""

    prompt_tokens: int = 0
    new_tokens: int = 0
    ttft_s: float = 0.0
    decode_s: float = 0.0
    spec_drafted: int = 0  # speculative: draft tokens proposed
    spec_accepted: int = 0  # speculative: draft tokens accepted
    # SamplingParams.logprobs: one dict per emitted token (appended BEFORE
    # the token is yielded) — {"id", "logprob", "top": [(id, lp), ...]}
    logprobs: list = field(default_factory=list)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.new_tokens / self.decode_s if self.decode_s > 0 else 0.0


class InferenceEngine:
    """Single-model engine on one device ("cuda" unless the caller passes
    device="cpu"; CUDA absent raises), or one rank of a mesh (module doc;
    `mesh`: a `Mesh` of the config's mesh shape to take the groups of)."""

    def __init__(
        self,
        gguf: str | Path | GGUFFile,
        config: EngineConfig | None = None,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config or EngineConfig()
        _check_config(self.config)
        dtype = getattr(torch, self.config.dtype)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels take bfloat16 activations; use dtype='bfloat16'")
        g = gguf if isinstance(gguf, GGUFFile) else GGUFFile.open(gguf)
        self.gguf = g
        self.family = resolve(g)
        self.global_cfg = self.family.config_from_gguf(g)
        self.model_name = str(g.metadata.get(Keys.NAME, g.architecture))
        self.mesh = self.comm = self.sp_comm = self.dp_comm = None
        tp, tp_rank = 1, 0
        if self.config.mesh_shape:
            if mesh is not None and mesh.dims != mesh_dims(self.config.mesh_shape, math.prod(mesh.dims.values())):
                raise ValueError(f"mesh {mesh.dims} is not mesh_shape={self.config.mesh_shape}")
            self.mesh = mesh or make_mesh(self.config.mesh_shape)
            validate_tp(self.global_cfg, self.mesh.tp)
        _check_parallel(self.config, self.mesh, self.global_cfg)
        ep = self.config.expert_parallel
        if self.mesh is not None:
            tp, tp_rank = self.mesh.tp, self.mesh.tp_rank
            if self.mesh.tp_group is not None:
                self.comm = Comm(self.mesh)
                if self.config.seq_parallel:
                    self.sp_comm = Comm(self.mesh, SP_AXIS)
                if self.mesh.dp > 1:
                    self.dp_comm = Comm(self.mesh, DP_AXIS)
            if self.device.type == "cuda" and torch.device(device).index is None:
                self.device = torch.device("cuda", local_device_index(self.mesh.rank))
        self.model_cfg = local_config(self.global_cfg, tp, ep)
        self.params = self.family.load_params(g, self.global_cfg, dtype=dtype, device=self.device,
                                              quantized=self.config.param_dtype == "auto",
                                              tp=tp, tp_rank=tp_rank, expert_parallel=ep)
        if self.comm is not None and tp > 1:
            self.params["comm"] = self.comm
        if self.sp_comm is not None:
            self.params["sp"] = self.sp_comm
        self.tokenizer = tokenizer_from_gguf(g.metadata)
        bos = (
            self.tokenizer.id_to_token.get(self.tokenizer.bos_id, "")
            if self.tokenizer.bos_id is not None else ""
        )
        eos = (
            self.tokenizer.id_to_token.get(self.tokenizer.eos_id, "")
            if self.tokenizer.eos_id is not None else ""
        )
        self.chat_template = ChatTemplate(
            g.metadata.get(Keys.TOKENIZER_CHAT_TEMPLATE), bos_token=bos, eos_token=eos
        )
        self.cache_dtype = dtype
        self.kv_quantized = self.config.kv_dtype == "int8"
        self.max_seq_len = min(self.config.max_seq_len, self.model_cfg.context_length)

    # -- low level ---------------------------------------------------------
    def lanes(self, batch: int) -> tuple[int, int]:
        """(first lane, lanes) of a `batch`-lane dense cache that this rank
        holds: under a mesh with dp > 1 dividing `batch`, its dp group's
        batch/dp lanes from dp_rank * batch/dp on (the JAX
        `kv_cache_sharding`: B over dp); else all of them (a batch that dp
        does not divide, as generate's one row, replicates)."""
        dp = self.dp_comm.size if self.dp_comm is not None else 1
        if dp > 1 and batch % dp == 0:
            return self.dp_comm.rank * (batch // dp), batch // dp
        return 0, batch

    def new_cache(self, batch: int = 1) -> KVCache:
        """A zeroed cache for `batch` rows (int8 codes and scales under
        kv_dtype="int8"), of which a rank holds its `lanes`. Its length is
        max_seq_len rounded up to a multiple of 64 (the prefill kernel's key
        tile); attention masks by position, so the extra slots are never
        read. Under sequence parallelism it is this rank's slice of a cache
        of max_seq_len rounded up to 64 * sp slots: S/sp slots from sp_rank
        * S/sp on."""
        sp = self.sp_comm.size if self.sp_comm is not None else 1
        slots = -(-self.max_seq_len // (64 * sp)) * 64 * sp
        cache = KVCache.zeros(self.model_cfg, self.lanes(batch)[1], slots // sp, self.cache_dtype, self.device,
                              quantized=self.kv_quantized)
        if sp > 1:
            cache.offset, cache.span = self.sp_comm.rank * (slots // sp), slots
        return cache

    def prefill(
        self, cache: KVCache, token_ids: Sequence[int], start_pos: int = 0
    ) -> tuple[torch.Tensor, KVCache]:
        """Prefill tokens (batch 1) in bucketed chunks; returns (last logits
        [1, V], cache)."""
        ids = np.asarray(token_ids, np.int32)
        if start_pos + ids.size > self.max_seq_len:
            raise ValueError(
                f"prompt of {ids.size} tokens at position {start_pos} exceeds "
                f"max_seq_len={self.max_seq_len}"
            )
        logits = None
        pos = start_pos
        chunk_cap = self.config.prefill_chunk
        while pos < start_pos + ids.size:
            take = min(chunk_cap, start_pos + ids.size - pos)
            # the padded bucket must not overrun the cache
            bucket = min(_bucket(take, chunk_cap), self.max_seq_len - pos)
            chunk = np.zeros(bucket, np.int64)
            chunk[:take] = ids[pos - start_pos: pos - start_pos + take]
            positions = np.arange(pos, pos + bucket, dtype=np.int64)
            logits, cache = prefill_step(
                self.params, self.model_cfg,
                torch.from_numpy(chunk[None]).to(self.device),
                torch.from_numpy(positions[None]).to(self.device),
                torch.tensor([take - 1], device=self.device),
                cache,
            )
            pos += take
        return logits, cache

    def _generator(self, seed: int | None) -> torch.Generator:
        """A generator seeded with `seed`, or without one a random seed (rank
        0's on every rank of a mesh, so the ranks sample alike)."""
        if seed is None:
            seed = int(np.random.randint(2**31))
            if self.comm is not None:
                seed = self.comm.broadcast_object(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    # -- generation --------------------------------------------------------
    def generate(
        self,
        prompt_ids: Sequence[int],
        sampling: SamplingParams | None = None,
        cache: KVCache | None = None,
        start_pos: int = 0,
        metrics: GenerationMetrics | None = None,
    ) -> Iterator[int]:
        """Stream generated token ids until EOS / max tokens / cache full."""
        sampling = sampling or SamplingParams()
        check_bias_ids(sampling, self.model_cfg.vocab_size)
        machine = None
        if sampling.constrained:  # a bad grammar raises before the prefill
            machine = machine_for(sampling) or JsonMachine(require_object=True)
        metrics = metrics if metrics is not None else GenerationMetrics()
        if cache is None:
            cache = self.new_cache(1)
        gen = self._generator(sampling.seed)
        dev = self.device
        extras = {}
        if sampling.logit_bias:
            pairs = tuple(sampling.logit_bias)
            extras.update(bias_ids=torch.tensor([[int(i) for i, _ in pairs]], device=dev),
                          bias_vals=torch.tensor([[float(v) for _, v in pairs]], device=dev))
        counts = None
        if sampling.has_penalties:
            counts = torch.zeros((1, self.model_cfg.vocab_size), dtype=torch.int32, device=dev)
            extras.update(presence=sampling.presence_penalty,
                          frequency=sampling.frequency_penalty)
        want_lp, lp_k = sampling.logprobs is not None, sampling.top_logprobs
        if want_lp:
            extras["n_logprobs"] = lp_k
        t0 = time.perf_counter()
        logits, cache = self.prefill(cache, prompt_ids, start_pos)
        pos = start_pos + len(prompt_ids)
        metrics.prompt_tokens = len(prompt_ids)
        if "bias_ids" in extras:  # the output counts are still zero: no penalty yet
            logits = apply_logit_bias(logits, extras["bias_ids"], extras["bias_vals"])
        if machine is not None:  # the first token under the first mask, after the bias
            # one pinned buffer takes every step's mask up without a host sync
            mask_buf = torch.empty(self.model_cfg.vocab_size, dtype=torch.bool, pin_memory=dev.type == "cuda")
            mask = self._upload_mask(mask_buf, machine, sampling.max_new_tokens)
            logits = logits.masked_fill(~mask[None], float("-inf"))
        token = sample_logits(
            logits, gen, sampling.temperature, sampling.top_k, sampling.top_p,
            min_p=sampling.min_p,
        )
        if counts is not None:
            counts.scatter_add_(1, token[:, None], torch.ones_like(counts[:, :1]))
        if want_lp:
            first_lp = token_logprobs(logits, token, lp_k)
        token_host = int(token[0])  # sync: TTFT includes the first sample
        metrics.ttft_s = time.perf_counter() - t0
        self._last_cache, self._last_pos = cache, pos
        if machine is not None:
            yield from self._generate_constrained(
                token, token_host, pos, cache, sampling, metrics, gen, machine, mask_buf, extras, counts,
                logprob_entry(*(a.tolist() for a in first_lp), 0, lp_k, token_host) if want_lp else None)
            return
        if self.config.speculative != "off" and not extras and counts is None:
            # no speculation with a bias, penalties or logprobs (`extras`)
            spec = self._generate_draft if self.config.speculative == "draft" else self._generate_ngram
            yield from spec(token_host, pos, cache, [int(t) for t in prompt_ids], sampling, metrics, gen)
            return
        if want_lp:
            carry_lp = logprob_entry(*(a.tolist() for a in first_lp), 0, lp_k, token_host)

        t_dec = time.perf_counter()
        emitted = 0
        done = False
        budget_left = sampling.max_new_tokens
        while not done:
            budget = min(budget_left, self.max_seq_len - pos)
            if budget <= 0:
                break
            n = min(self.config.decode_chunk, budget)
            n = 1 << (n.bit_length() - 1)
            out = decode_loop(
                self.params, self.model_cfg, token,
                torch.tensor([pos], device=dev), cache, gen, n,
                sampling.temperature, sampling.top_k, sampling.top_p,
                sampling.min_p, counts=counts, **extras,
            )
            toks, token, cache, gen = out[:4]
            rest = list(out[4:])
            if counts is not None:
                counts = rest.pop(0)
            toks_host = toks[0].tolist()  # one sync per chunk
            if want_lp:  # [n], [n, k], [n, k], read after that sync
                lp_host = [a[0].tolist() for a in rest]
                next_host = int(token[0])
            for j, t in enumerate(toks_host):
                if self.tokenizer.is_eos(t) or emitted >= sampling.max_new_tokens:
                    done = True
                    self._last_pos = pos + j
                    break
                if want_lp:
                    # toks[0]'s logprob came from the previous chunk (or the
                    # prefill); step j's arrays describe toks[j + 1]
                    metrics.logprobs.append(carry_lp)
                    carry_lp = logprob_entry(*lp_host, j, lp_k,
                                             toks_host[j + 1] if j + 1 < n else next_host)
                yield t
                emitted += 1
            else:
                self._last_pos = pos + n
            self._last_cache = cache
            pos += n
            budget_left -= n
        if not done:
            # budget exhausted mid-stream: the final sampled token needs no
            # KV slot
            token_host = int(token[0])
            if emitted < sampling.max_new_tokens and not self.tokenizer.is_eos(token_host):
                if want_lp:
                    metrics.logprobs.append(carry_lp)
                yield token_host
                emitted += 1
        metrics.new_tokens = emitted
        metrics.decode_s = time.perf_counter() - t_dec

    # -- speculative decoding ----------------------------------------------
    def _spec_kw(self, sampling: SamplingParams, gen: torch.Generator) -> dict:
        """The rounds' sampling arguments: none for a greedy request (the
        argmax-prefix rule), else rejection sampling with the request's
        settings and generator."""
        if sampling.greedy:
            return {}
        row = lambda v: torch.tensor([v], dtype=torch.float32, device=self.device)  # noqa: E731
        return dict(generator=gen, temps=row(sampling.temperature), top_k=max(1, sampling.top_k),
                    top_ps=row(sampling.top_p), min_ps=row(sampling.min_p))

    def _eos_tensor(self) -> torch.Tensor:
        return torch.tensor(sorted(self.tokenizer.eos_ids) or [-2], device=self.device)

    def _plain_chunk(self, tok_id, pos, cache, room, emitted, sampling, gen):
        """One plain decode chunk of a power-of-two length that fits the
        room and the budget (a speculative path's cache tail or rejection
        streak); returns (tokens, the next pending token, cache)."""
        m = min(self.config.decode_chunk, room, sampling.max_new_tokens - emitted)
        m = 1 << (max(m, 1).bit_length() - 1)
        toks, nxt, cache, _ = decode_loop(
            self.params, self.model_cfg, torch.tensor([tok_id], device=self.device),
            torch.tensor([pos], device=self.device), cache, gen, m, sampling.temperature,
            max(1, sampling.top_k), sampling.top_p, sampling.min_p)
        return toks[0].tolist(), int(nxt[0]), cache

    def _spec_loop(self, tok_id, pos, cache, s, sampling, metrics, gen, rounds_call,
                   after_plain=None, streak_fallback=False) -> Iterator[int]:
        """The emit loop both speculative paths share. `rounds_call(tok_id,
        pos, cache)` runs one call of rounds and reads it back once: it
        returns (emitted tokens, next pending token, cache, live, drafted,
        accepted). The cache tail (less room than a round, `s` the room's
        end) takes plain chunks, `after_plain(tokens, pending)` then sees
        them; with `streak_fallback` a call that accepted nothing is
        followed by one plain chunk (the JAX ngram path's rejection
        streak)."""
        gamma = max(1, self.config.spec_tokens)
        t_dec = time.perf_counter()
        emitted = 0
        force_plain = False

        def emit_ok():
            return emitted < sampling.max_new_tokens and not self.tokenizer.is_eos(tok_id)

        while emit_ok():
            room = s - pos
            plain = room < gamma + 1 or force_plain
            if plain and room <= 0:  # the final token needs no K/V slot
                yield tok_id
                emitted += 1
                break
            if plain:
                force_plain = False
                toks, nxt, cache = self._plain_chunk(tok_id, pos, cache, room, emitted, sampling, gen)
            else:
                toks, nxt, cache, live, drafted, accepted = rounds_call(tok_id, pos, cache)
                metrics.spec_drafted += drafted
                metrics.spec_accepted += accepted
            stop = False
            for j, t in enumerate(toks):
                tok_id = t
                if not emit_ok():
                    stop = True
                    self._last_pos = pos + j
                    break
                yield t
                emitted += 1
            self._last_cache = cache
            if stop:
                break
            pos += len(toks)
            self._last_pos = pos
            tok_id = nxt
            if plain:
                if after_plain is not None:
                    after_plain(toks, nxt)
            elif not live:
                if s - pos >= gamma + 1:
                    break  # EOS inside the rounds
                # else out of room mid-call: the tail path takes over
            else:
                force_plain = streak_fallback and accepted == 0
        else:
            self._last_cache = cache
        metrics.new_tokens = emitted
        metrics.decode_s = time.perf_counter() - t_dec

    def _generate_ngram(self, tok_id, pos, cache, history, sampling, metrics, gen) -> Iterator[int]:
        """Prompt-lookup speculative decoding (the JAX `_generate_ngram`):
        `spec_decode_rounds` runs `spec_rounds` rounds of (on-device n-gram
        draft → one verify forward → accept) per read-back. After a call
        that accepted nothing it runs one plain chunk before drafting again,
        and the cache tail (less room than a round) takes plain chunks."""
        gamma = max(1, self.config.spec_tokens)
        n = max(1, self.config.spec_ngram)
        rounds = max(1, self.config.spec_rounds)
        spec_kw = self._spec_kw(sampling, gen)
        dev = self.device
        s = self.max_seq_len
        eos = self._eos_tensor()
        hist = torch.zeros((1, s), dtype=torch.int64, device=dev)
        hist[0, :len(history) + 1] = torch.tensor(history + [tok_id], device=dev)
        hlen = len(history) + 1

        def rounds_call(tok_id, pos, cache):
            nonlocal hist, hlen
            outs, ocnt, pend, _, cache, hist, _, act, dr, ac = spec_decode_rounds(
                self.params, self.model_cfg, torch.tensor([tok_id], device=dev),
                torch.tensor([pos], device=dev), cache, hist, torch.tensor([hlen], device=dev),
                eos, torch.ones(1, dtype=torch.bool, device=dev), rounds, gamma, n, **spec_kw)
            cnt = int(ocnt[0])  # the call's one read-back
            hlen += cnt
            return outs[0, :cnt].tolist(), int(pend[0]), cache, bool(act[0]), int(dr[0]), int(ac[0])

        def after_plain(toks, pending):
            nonlocal hlen
            # the device history follows: [toks[1:], the new pending token]
            entries = (toks[1:] + [pending])[:s - hlen]
            with torch.inference_mode():  # hist came out of the rounds
                hist[0, hlen:hlen + len(entries)] = torch.tensor(entries, device=dev)
            hlen += len(entries)

        yield from self._spec_loop(tok_id, pos, cache, s, sampling, metrics, gen, rounds_call,
                                   after_plain, streak_fallback=True)

    @property
    def draft_engine(self) -> "InferenceEngine":
        """The second engine of speculative="draft" (`draft_gguf`), on this
        engine's device, made on first use with this engine's config (the
        JAX `draft_engine`'s), mesh shape included: under a mesh it takes
        this engine's `Mesh` and its groups, loads its own shard and has
        its own Comm. Its vocabulary must be the target's."""
        if getattr(self, "_draft_engine", None) is None:
            if not self.config.draft_gguf:
                raise ValueError("speculative='draft' requires EngineConfig.draft_gguf")
            draft = InferenceEngine(
                self.config.draft_gguf,
                replace(self.config, gguf_path=self.config.draft_gguf, speculative="off", draft_gguf=""),
                device=self.device, mesh=self.mesh)
            if draft.model_cfg.vocab_size != self.model_cfg.vocab_size:
                raise ValueError("draft model vocabulary differs from the target's")
            self._draft_engine = draft
        return self._draft_engine

    def _generate_draft(self, tok_id, pos, cache, history, sampling, metrics, gen) -> Iterator[int]:
        """Draft-model speculative decoding (the JAX `_generate_draft`): the
        draft GGUF prefills the same prompt into its own cache, then
        `draft_spec_rounds` runs `spec_rounds` rounds of (gamma + 1 draft
        steps → one target verify → accept) per read-back; the cache tail
        takes plain chunks on the target. Like the JAX engine, the draft
        cache holds this call's prompt from position 0 (a ChatSession turn's
        earlier tokens are not in it: they lower acceptance only)."""
        gamma = max(1, self.config.spec_tokens)
        rounds = max(1, self.config.spec_rounds)
        de = self.draft_engine
        spec_kw = self._spec_kw(sampling, gen)
        dev = self.device
        s = min(self.max_seq_len, de.max_seq_len)
        eos = self._eos_tensor()
        _, dcache = de.prefill(de.new_cache(1), history)

        def rounds_call(tok_id, pos, cache):
            nonlocal dcache
            outs, ocnt, pend, _, cache, dcache, act, dr, ac = draft_spec_rounds(
                self.params, self.model_cfg, de.params, de.model_cfg, torch.tensor([tok_id], device=dev),
                torch.tensor([pos], device=dev), cache, dcache, eos,
                torch.ones(1, dtype=torch.bool, device=dev), rounds, gamma, max_seq=s, **spec_kw)
            cnt = int(ocnt[0])  # the call's one read-back
            return outs[0, :cnt].tolist(), int(pend[0]), cache, bool(act[0]), int(dr[0]), int(ac[0])

        yield from self._spec_loop(tok_id, pos, cache, s, sampling, metrics, gen, rounds_call)

    # -- constrained decoding ----------------------------------------------
    @property
    def json_constraint(self):
        """The vocabulary-wide TokenConstraint (built once per engine)."""
        if getattr(self, "_json_constraint", None) is None:
            self._json_constraint = constraint_for(self.tokenizer, "json")
        return self._json_constraint

    def constraint_mask(self, machine, budget: int) -> np.ndarray:
        """bool [V]: the tokens `machine` may take next. When the bytes the
        structure needs to close, plus 4, reach the remaining token
        `budget`, only those that close it (`closing_allowed`), so the
        output ends as a complete match (the JAX engine's policy)."""
        cons = self.json_constraint
        closing = len(machine.closing_string()) + 4 >= budget
        allowed = cons.closing_allowed(machine) if closing else cons.allowed(machine)
        out = np.zeros(self.model_cfg.vocab_size, bool)
        out[:allowed.shape[0]] = allowed
        return out

    def _upload_mask(self, buf: torch.Tensor, machine, budget: int) -> torch.Tensor:
        """`constraint_mask` written into the pinned host buffer `buf` and
        sent to the device without a host sync (the previous step's copy
        from `buf` is done: its token was read back)."""
        buf.numpy()[:] = self.constraint_mask(machine, budget)
        return buf.to(self.device, non_blocking=True)

    def _generate_constrained(self, token, token_host, pos, cache, sampling, metrics, gen, machine,
                              mask_buf, extras, counts, carry_lp) -> Iterator[int]:
        """Grammar-constrained decoding (the JAX `_generate_constrained`):
        `token` was sampled from the prefill under the first mask; then
        one-step `decode_loop` calls, each with the next [V] mask
        (`constraint_mask`) applied after the logit bias and the penalties,
        the order of the BatchEngine's chunks (the JAX engine's constrained
        path drops both). Logprobs describe the masked distribution. The
        masks go up through `mask_buf` and the position stays on the
        device: the token is the step's one read-back, which the next mask
        needs."""
        token_bytes = self.json_constraint.token_bytes
        dev = self.device
        lp_k = sampling.top_logprobs
        pos_dev = torch.tensor([pos], device=dev)
        emitted = 0
        t_dec = time.perf_counter()
        while not self.tokenizer.is_eos(token_host):
            if not machine.advance_bytes(token_bytes[token_host]):
                raise RuntimeError(f"constrained sampler emitted an illegal token {token_host}")
            if carry_lp is not None:
                metrics.logprobs.append(carry_lp)
            yield token_host
            emitted += 1
            if emitted >= sampling.max_new_tokens or machine.complete or pos >= self.max_seq_len:
                break
            mask = self._upload_mask(mask_buf, machine, sampling.max_new_tokens - emitted)
            out = decode_loop(
                self.params, self.model_cfg, token, pos_dev, cache, gen, 1, sampling.temperature,
                sampling.top_k, sampling.top_p, sampling.min_p, counts=counts, allowed_mask=mask[None],
                **extras)
            _, token, cache, gen = out[:4]
            rest = list(out[4:])
            if counts is not None:
                counts = rest.pop(0)
            token_host = int(token[0])  # the step's one host read: the next mask needs it
            if carry_lp is not None:
                carry_lp = logprob_entry(*(a[0].tolist() for a in rest), 0, lp_k, token_host)
            pos, pos_dev = pos + 1, pos_dev + 1
            self._last_cache, self._last_pos = cache, pos
        metrics.new_tokens = emitted
        metrics.decode_s = time.perf_counter() - t_dec

    def generate_text(self, prompt: str, sampling: SamplingParams | None = None) -> str:
        ids = self.tokenizer.encode(prompt)
        detok = StreamDetokenizer(self.tokenizer)
        out = [detok.push(t) for t in self.generate(ids, sampling)]
        return "".join(out) + detok.flush()


@dataclass
class ChatSession:
    """Multi-turn chat with KV-cache reuse across turns: the rendered
    conversation is re-tokenized each turn and only the suffix beyond the
    cached prefix is prefilled."""

    engine: InferenceEngine
    sampling: SamplingParams = field(default_factory=SamplingParams)
    messages: list[Message] = field(default_factory=list)
    _cache: Any = None
    _cached_ids: list[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.messages and self.engine.config.system_prompt:
            self.messages.append(Message("system", self.engine.config.system_prompt))

    def stream(self, user_text: str) -> Iterator[str]:
        """Send a user message; yields assistant text pieces."""
        self.messages.append(Message("user", user_text))
        prompt = self.engine.chat_template.render(self.messages, add_generation_prompt=True)
        ids = self.engine.tokenizer.encode(prompt, add_bos=False)
        common = 0
        for a, b in zip(self._cached_ids, ids):
            if a != b:
                break
            common += 1
        if common == len(ids):  # always leave at least one token to prefill
            common = max(0, len(ids) - 1)
        if self._cache is None or common == 0:
            self._cache = self.engine.new_cache(1)
            common = 0
        new_ids = ids[common:]

        detok = StreamDetokenizer(self.engine.tokenizer)
        stopper = TextStopper(self.sampling.stop)
        reply_ids: list[int] = []
        metrics = GenerationMetrics()
        for tok in self.engine.generate(
            new_ids, self.sampling, cache=self._cache, start_pos=common,
            metrics=metrics,
        ):
            reply_ids.append(tok)
            piece = detok.push(tok)
            if piece:
                emit, done = stopper.feed(piece)
                if emit:
                    yield emit
                if done:
                    break
        else:
            tail = detok.flush()
            if tail:
                emit, _ = stopper.feed(tail)
                if emit:
                    yield emit
            final = stopper.flush()
            if final:
                yield final
        self.last_metrics = metrics
        # the cache holds KV for exactly _last_pos tokens (the final sampled
        # token may never have run through the model)
        self._cache = self.engine._last_cache
        self._cached_ids = (ids + reply_ids)[: self.engine._last_pos]
        reply_text = self.engine.tokenizer.decode(reply_ids, skip_special=True)
        self.messages.append(Message("assistant", reply_text))

    def send(self, user_text: str) -> str:
        return "".join(self.stream(user_text))

    # -- session persistence: the JAX package's file (np.savez_compressed) --
    def save(self, path) -> None:
        """Write the conversation and the KV cache so the session can resume
        in another process without prefilling again, in the JAX package's
        format: `meta` (JSON: messages, cached_ids, model, max_seq_len) and
        `cache_k`/`cache_v` [L, 1, max_seq_len, KVD] (+ `cache_ks`/`cache_vs`
        [L, 1, Hkv, max_seq_len] f32 on an int8 cache). A bf16 cache is
        written as the raw 2-byte records (`|V2`) numpy makes of the JAX
        package's bf16 arrays. Under a mesh every rank calls it: the ranks'
        kv-heads (and under sequence parallelism their S slices) are
        gathered and rank 0 writes the whole cache, which a single-device
        engine or a mesh of any tp or sp loads."""
        meta = {
            "messages": [m.asdict() for m in self.messages],
            "cached_ids": list(self._cached_ids),
            "model": self.engine.model_name,
            "max_seq_len": self.engine.max_seq_len,
        }
        arrays = {}
        comm = self.engine.comm
        if self._cache is not None:
            s = self.engine.max_seq_len  # the cache's slots past it are never written
            c = self._cache
            if comm is not None:  # a rank's kv-heads: the whole cache, joined in rank order
                c = KVCache(comm.gather_heads(c.k, -1), comm.gather_heads(c.v, -1),
                            *(None if t is None else comm.gather_heads(t, 2) for t in (c.ks, c.vs)))
            if (sp := self.engine.sp_comm) is not None:  # then the S slices, in sp-rank order
                c = KVCache(sp.gather(c.k, 2, "gather_slots"), sp.gather(c.v, 2, "gather_slots"),
                            *(None if t is None else sp.gather(t, 3, "gather_slots") for t in (c.ks, c.vs)))
            arrays["cache_k"], arrays["cache_v"] = _to_numpy(c.k[:, :, :s]), _to_numpy(c.v[:, :, :s])
            if c.quantized:
                arrays["cache_ks"], arrays["cache_vs"] = _to_numpy(c.ks[..., :s]), _to_numpy(c.vs[..., :s])
        if comm is None or comm.is_root:  # one file, from rank 0 of a mesh
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, engine: InferenceEngine, path, sampling: SamplingParams | None = None) -> "ChatSession":
        """Read a session written by `save` (or by the JAX package's
        ChatSession.save) onto `engine.device`. The model name and
        max_seq_len must match the engine's, and an int8 cache needs an
        int8 engine (and a bf16/f32 cache one that is not); a float cache
        is cast to the engine's cache dtype."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta["model"] != engine.model_name:
                raise ValueError(f"session was saved for model {meta['model']!r}, "
                                 f"engine runs {engine.model_name!r}")
            if meta["max_seq_len"] != engine.max_seq_len:
                raise ValueError(f"session cache length {meta['max_seq_len']} != engine "
                                 f"max_seq_len {engine.max_seq_len}")
            session = cls(engine, sampling or SamplingParams(), messages=[])
            session.messages = [Message(**m) for m in meta["messages"]]
            session._cached_ids = [int(t) for t in meta["cached_ids"]]
            if "cache_k" in z:
                session._cache = _cache_from_arrays(engine, {k: z[k] for k in z.files if k != "meta"})
        return session


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A cache tensor on the host; bf16 as the raw 2-byte records (|V2)
    numpy writes for the JAX package's bf16 arrays."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """`_to_numpy`'s inverse: 2-byte void records are bf16 bits."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _cache_from_arrays(engine: InferenceEngine, arrays: dict) -> KVCache:
    """A saved batch-1 cache ([L, 1, S, KVD], + [L, 1, Hkv, S] scales) in
    a new engine cache on the engine's device, its S slots first; a rank of
    a mesh takes its kv-heads' lanes and scales, and under sequence
    parallelism the saved slots of its S slice."""
    k = arrays["cache_k"]
    if k.ndim != 4:  # the JAX package's pre-merged-lane sessions: [L, Hkv, B, S, D]
        raise ValueError("session cache uses the old per-head KV layout; re-create the session "
                         "(cache layout is now [L, B, S, Hkv*D])")
    if engine.comm is not None:
        r, hkv, d = engine.comm.rank, engine.model_cfg.n_kv_heads, engine.model_cfg.head_dim
        lanes, heads = slice(r * hkv * d, (r + 1) * hkv * d), slice(r * hkv, (r + 1) * hkv)
        arrays = {key: a[..., lanes] if key in ("cache_k", "cache_v") else a[:, :, heads]
                  for key, a in arrays.items()}
        k = arrays["cache_k"]
    quantized = "cache_ks" in arrays
    if quantized != engine.kv_quantized:
        raise ValueError(f"session cache is {'int8' if quantized else 'not int8'}; the engine's "
                         f"kv_dtype is {engine.config.kv_dtype!r}")
    cache = engine.new_cache(1)
    s = k.shape[2]
    if k.shape[:2] + k.shape[3:] != cache.k.shape[:2] + cache.k.shape[3:] or s > cache.max_seq:
        raise ValueError(f"session cache shape {k.shape} does not fit the engine's {tuple(cache.k.shape)}")
    lo, hi = cache.offset, min(s, cache.offset + cache.k.shape[2])  # the saved slots this cache holds
    pairs = [("k", "cache_k"), ("v", "cache_v")] + ([("ks", "cache_ks"), ("vs", "cache_vs")] if quantized else [])
    for attr, key in pairs:
        if hi <= lo:
            break
        dst, src = getattr(cache, attr), arrays[key]
        if attr in ("k", "v"):
            dst, src = dst[:, :, :hi - lo], src[:, :, lo:hi]
        else:
            dst, src = dst[..., :hi - lo], src[..., lo:hi]
        dst.copy_(_from_numpy(src))
    return cache
