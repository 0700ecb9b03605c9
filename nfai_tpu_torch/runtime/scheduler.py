"""Continuous batching: a slot-based scheduler that admits and evicts
requests between fused decode chunks.

Counterpart of nfai_tpu/runtime/scheduler.py. Up to `max_batch` requests
decode in lockstep; new arrivals prefill one chunk per scheduler step into
free slots while the others keep decoding. Decode uses per-slot positions
and per-slot sampling settings (temperature, top-k inside a static window,
top-p, min-p); finished slots are masked `active=False` so their lanes
neither advance nor touch another slot's cache.

By default the KV lives in the paged pool (runtime.paged_cache): pages are
allocated as sequences grow, prompt prefixes are shared across requests,
the youngest request is preempted (and later recomputed) when the pool runs
dry, and the decode runs at the smallest power-of-two width covering the
active slots (lane compaction). `paged=False` keeps dense per-slot lanes.
Under `EngineConfig(kv_dtype="int8")` both hold int8 codes with f32
scales (the pool's MB counts the scales).

The OpenAI options run as in the JAX scheduler: a fixed-width logit-bias
table per slot (`bias_width`, the largest-magnitude entries kept), the
presence/frequency penalties over a lazy [max_batch, V] int32 count of each
slot's output tokens (gathered for the rows of a compacted decode and
written back to their slots), and logprobs (`Request.logprob_data`, one
entry per streamed token, read back with the chunk's tokens). The first
token is sampled at the end of the prefill with the same options. A
preempted request's counts are rebuilt from the tokens it already emitted
(the JAX scheduler restarts them from zero).

Constrained requests (grammar, regex, JSON, JSON Schema) keep a host
automaton per slot (`_Slot.machine`, rebuilt from the emitted tokens when a
preempted request comes back): while one runs, decode chunks are one step
long and each step carries a [rows, V] mask, all True on the other rows,
applied after the bias and the penalties. A token the automaton rejects
fails its own request only.

With `EngineConfig(speculative="ngram")` the decoding slots speculate
together (`_spec_step`, `models.llama.spec_decode_rounds`): greedy slots by
the argmax-prefix rule, sampled ones by rejection sampling, in one batch,
unless a slot asks for a bias, penalties, logprobs or a constraint, or a
slot lacks the cache room for a call's rounds. On the page pool the call
runs on the compacted rows, its pad lanes on the sink page; on the dense
cache a lane that is not decoding (empty, or mid-prefill) writes no K/V row
(the JAX BatchEngine's frozen lanes write row 0 of theirs).

Under a mesh (the engine's `comm`) every rank runs this scheduler on its
shard of the pool (its kv-heads; the pages and block tables are the same on
every rank, as the JAX pool replicates its page axis). What comes from
outside must be the same on every rank: submits and cancels arrive on rank
0's threads, and at the top of every `step` rank 0 broadcasts the requests
that arrived and the ids cancelled since the last step to the world
(`_sync`); every rank applies them before admission, so admission,
preemption, page growth and prefix sharing are deterministic and equal on
all ranks. The other ranks run `follow`, which steps until rank 0's `close`
broadcasts the end. Rank 0's idle loop steps every 50 ms at least (the
followers' collectives then never wait past their timeout), and a failed
step under a mesh fails its requests and stops the loop: no rank carries on
alone. Under an sp mesh the pool's pages stay whole on every sp rank (the
JAX scheduler shards only the kv-heads over tp), so the paged path runs
K7 and the paged store unchanged there; the dense cache of `paged=False`
is each rank's S slice (`InferenceEngine.new_cache`). A MoE model's
experts split as its engine splits them (over experts or ffn columns).

Under a mesh with dp > 1 dividing `max_batch`, the dense cache
(`paged=False`) holds a rank's dp group's max_batch/dp lanes
(`InferenceEngine.lanes`, the JAX `kv_cache_sharding`), and a rank
computes only those: a slot's prefill runs in the dp group that owns its
lane, which then broadcasts the first token (and its logprobs) over dp;
each decode chunk or speculative call runs on the group's lanes and its
tokens (with the logprobs, or the speculative counts) are gathered over dp
in lane order, one gather a step, so every rank keeps the whole host state
and steps in lockstep. Every rank draws the whole batch's random numbers
from the shared generator and samples its own lanes' rows with them
(`ops.sampling.draw`; a rank that does not own a prefilling slot draws
its first token's numbers too), so the tokens are one device's, greedy or
sampled. The penalty counts of a lane live on the group that owns it. The
page pool is not split over dp (the JAX pool is sharded over tp only).
"""
from __future__ import annotations

import itertools
import logging
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Iterator, Sequence

import numpy as np
import torch

from ..config import SamplingParams
from ..constrained import JsonMachine
from ..grammar import machine_for
from ..models import decode_loop, paged_decode_loop, paged_prefill_step, prefill_slot_step
from ..models.llama import spec_decode_rounds
from ..ops.sampling import (
    apply_logit_bias, apply_penalties, logprob_entry, sample_logits, token_logprobs,
)
from .engine import _bucket as _next_bucket
from .engine import check_bias_ids
from .paged_cache import OutOfPages, PageAllocator, PagedKVCache

log = logging.getLogger(__name__)

_END = object()  # stream sentinel


class QueueFull(RuntimeError):
    """The bounded request queue is full: retry later (the server's 503)."""


class RequestState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class Request:
    """One generation request; tokens stream into `out`."""

    id: int
    prompt_ids: list[int]
    sampling: SamplingParams
    state: RequestState = RequestState.QUEUED
    output_ids: list[int] = field(default_factory=list)
    out: queue.Queue = field(default_factory=queue.Queue)
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: float | None = None
    finished_at: float | None = None
    # SamplingParams.logprobs: one dict per emitted token —
    # {"id", "logprob", "top": [(token_id, logprob), ...]}
    logprob_data: list[dict] = field(default_factory=list)
    _cancel: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Stop generating for this request (client disconnected / abort).
        Safe from any thread; the scheduler frees the slot between chunks."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def stream(self, timeout: float | None = None) -> Iterator[int]:
        """Yield generated token ids as they arrive (blocking iterator)."""
        while True:
            item = self.out.get(timeout=timeout)
            if item is _END:
                return
            yield item

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclass
class _Slot:
    request: Request | None = None
    pos: int = 0  # tokens with KV written
    budget: int = 0  # max tokens this request may still emit
    next_token: int = 0  # token sampled but not yet fed through the model
    pages: list[int] = field(default_factory=list)  # paged mode: block table
    # incremental prefill: remaining ids to push through the model; None once
    # the slot is decoding
    prefill_ids: np.ndarray | None = None
    prefill_next: int = 0  # next absolute position to prefill
    # a constrained request's host automaton (None for the others): the next
    # step's vocabulary mask comes from it
    machine: object | None = None

    @property
    def prefilling(self) -> bool:
        return self.prefill_ids is not None


def _table_width(max_seq: int, page_size: int) -> int:
    """Pages per block table: enough for max_seq positions, rounded up so
    that the table spans a multiple of 64 positions (K4's key tile, which
    attends a prefill chunk over the gathered pages); the extra entries are
    sink pages, masked by position."""
    tile = math.lcm(page_size, 64)
    return -(-max_seq // tile) * (tile // page_size)


class BatchEngine:
    """Continuous-batching executor over an `InferenceEngine`'s model.

    Drive it synchronously with `step()` (tests) or start the background
    thread with `start()` (server). `submit` may be called from any thread;
    `step` must run on one thread only.

    With `paged=True` (the default, `EngineConfig.paged_kv`) KV lives in a
    shared page pool with per-slot block tables: page-granular allocation,
    prompt-prefix sharing across requests (a request whose prompt starts with
    a previously served prefix skips prefilling those pages), and
    recompute-preemption when the pool runs dry mid-generation.
    """

    def __init__(
        self,
        engine,
        max_batch: int = 8,
        decode_chunk: int = 8,
        paged: bool | None = None,
        pool_tokens: int | None = None,
        queue_cap: int = 256,
        prefill_ticks_per_step: int = 1,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.decode_chunk = decode_chunk
        # arrivals prefill one chunk per scheduler step (between decode
        # chunks) instead of stalling every running slot for whole prompts
        self.prefill_ticks_per_step = max(1, prefill_ticks_per_step)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: queue.Queue[Request] = queue.Queue(maxsize=queue_cap)
        self._parked: deque[Request] = deque()  # requeued (preempted) heads
        self._ids = itertools.count()
        # under a mesh: the arrivals rank 0 broadcast, not yet admitted, and
        # the request ids cancelled as of the last broadcast
        self.comm = engine.comm
        self._pending: deque[Request] = deque()
        self._cancelled: set[int] = set()
        self._wake = threading.Event()
        self._closed = self._broken = False
        self.generator = torch.Generator(device=engine.device)
        self.generator.manual_seed(0)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # the sampling window is static; per-request top_k is applied by
        # masking ranks inside it (sample_logits top_k_rows). Requests asking
        # for more are clamped to it, logged once per engine.
        self.top_k = 64
        self._warned_topk_clamp = False
        self.preemptions = 0
        # the OpenAI options: a fixed-width logit-bias table per slot, and
        # the output-token counts of the penalties (made on first use)
        self.bias_width = 16
        self._warned_bias_clamp = False
        self._counts: torch.Tensor | None = None  # [max_batch, V] int32
        self.spec_drafted = 0  # speculative: draft tokens proposed, all slots
        self.spec_accepted = 0  # and accepted

        cfg = engine.config
        self.paged = cfg.paged_kv if paged is None else paged
        if self.paged:
            ps = cfg.page_size
            tokens = pool_tokens or cfg.kv_pool_tokens or (max_batch * engine.max_seq_len)
            n_pages = -(-tokens // ps) + 1  # + reserved sink page
            self.page_size = ps
            self.max_pages = _table_width(engine.max_seq_len, ps)
            self.alloc = PageAllocator(n_pages, ps)
            self.cache = PagedKVCache.zeros(
                engine.model_cfg, n_pages, ps, engine.cache_dtype, engine.device,
                quantized=engine.kv_quantized,
            )
            log.info("paged KV pool: %d pages x %d tokens (%.1f MB)", n_pages, ps,
                     self.cache.nbytes / 1e6)
        else:
            self.cache = engine.new_cache(max_batch)
        # the lanes this rank decodes: a dp group's share of the dense cache, else all
        lo, n = (0, max_batch) if self.paged else engine.lanes(max_batch)
        self.lanes = range(lo, lo + n)
        self.dp_comm = engine.dp_comm if n < max_batch else None

    # -- client API --------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], sampling: SamplingParams | None = None) -> Request:
        if self.comm is not None and not self.comm.is_root:
            raise RuntimeError("requests enter a mesh on rank 0; the other ranks follow()")
        if self._broken:
            raise RuntimeError("the mesh's scheduler stopped after a failed step")
        sampling = sampling or SamplingParams()
        check_bias_ids(sampling, self.engine.model_cfg.vocab_size)
        try:  # a bad grammar, regex or schema is the caller's error, raised here and not in `step`
            machine_for(sampling)
        except ValueError as e:
            field = "grammar" if sampling.grammar else "regex" if sampling.regex else "json_schema"
            raise ValueError(f"{field}: {e}") from e
        req = Request(id=next(self._ids), prompt_ids=list(prompt_ids), sampling=sampling)
        max_prompt = self.engine.max_seq_len - 1
        if len(req.prompt_ids) > max_prompt:
            req.state = RequestState.FAILED
            req.out.put(_END)
            raise ValueError(
                f"prompt of {len(req.prompt_ids)} tokens exceeds capacity {max_prompt}"
            )
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            req.state = RequestState.FAILED
            req.out.put(_END)
            raise QueueFull(f"request queue full ({self.queue.maxsize}); retry later") from None
        self._wake.set()
        return req

    # -- the mesh: rank 0's inbox on every rank ----------------------------
    def _sync(self, close: bool = False) -> bool:
        """Under a mesh, rank 0 broadcasts the requests that arrived since
        the last step (id, prompt, sampling, submit time) and the ids
        cancelled by then; every rank queues and applies them. Returns
        whether rank 0 closed (then no step follows)."""
        if self.comm is None:
            return False
        if self.comm.is_root:
            new = []
            while True:
                try:
                    new.append(self.queue.get_nowait())
                except queue.Empty:
                    break
            known = ([s.request for s in self.slots if s.request is not None]
                     + list(self._parked) + list(self._pending) + new)
            cancels = sorted(r.id for r in known if r.cancelled)
            self.comm.broadcast_object(
                (close, [(r.id, r.prompt_ids, r.sampling, r.submitted_at) for r in new], cancels))
        else:
            close, subs, cancels = self.comm.broadcast_object()
            new = [Request(id=i, prompt_ids=p, sampling=sp, submitted_at=t) for i, p, sp, t in subs]
        self._pending.extend(new)
        self._cancelled.update(cancels)
        return close

    def _is_cancelled(self, req: Request) -> bool:
        """Cancelled as of the last broadcast under a mesh (the same answer on
        every rank), else as of now."""
        return req.id in self._cancelled if self.comm is not None else req.cancelled

    def follow(self) -> None:
        """A rank other than 0 of a mesh: step in lockstep with rank 0 until
        its `close`."""
        if self.comm is None or self.comm.is_root:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh")
        while not self._sync():
            self._step()

    # -- scheduler ---------------------------------------------------------
    def _next_queued(self) -> Request | None:
        while True:
            if self._parked:
                req = self._parked.popleft()
            elif self.comm is not None:  # what rank 0 broadcast, in its order
                if not self._pending:
                    return None
                req = self._pending.popleft()
            else:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    return None
            if self._is_cancelled(req):
                req.state = RequestState.CANCELLED
                req.out.put(_END)
                continue
            return req

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                continue
            req = self._next_queued()
            if req is None:
                return
            if not self._begin_prefill(i, req):
                # pool exhausted: park the request and stop admitting until
                # capacity frees up
                self._requeue_front(req)
                return

    def _requeue_front(self, req: Request) -> None:
        req.state = RequestState.QUEUED
        self._parked.appendleft(req)

    def _begin_prefill(self, slot_idx: int, req: Request) -> bool:
        """Assign a request to a slot and reserve its KV pages; the prompt is
        prefilled by `_prefill_tick`, one chunk per scheduler step. Returns
        False when the pool cannot hold it (the caller requeues). A preempted
        request's already-emitted tokens are part of the sequence to rebuild."""
        eng = self.engine
        full_ids = list(req.prompt_ids) + list(req.output_ids)
        ids = np.asarray(full_ids, np.int32)
        chunk_cap = eng.config.prefill_chunk

        slot = self.slots[slot_idx]
        start = 0
        if self.paged:
            shared, start = self.alloc.lookup_prefix(full_ids)
            ps = self.page_size
            # page coverage must include the padded chunk tails (their writes
            # land in the slot's own pages past the prompt, masked by position)
            pos, max_end = start, start
            while pos < ids.size:
                take = min(chunk_cap, ids.size - pos)
                bucket = min(_next_bucket(take, chunk_cap), eng.max_seq_len - pos)
                max_end = max(max_end, pos + bucket)
                pos += take
            need = -(-max_end // ps) - len(shared)
            try:
                new_pages = self.alloc.alloc(need) if need > 0 else []
            except OutOfPages:
                self.alloc.release(shared)
                return False
            slot.pages = list(shared) + list(new_pages)
            if start:
                log.debug("req %d: prefix cache hit, %d/%d tokens shared", req.id, start, ids.size)
        slot.request = req
        slot.prefill_ids = ids
        slot.prefill_next = start
        slot.machine = self._build_machine(req) if req.sampling.constrained else None
        req.state = RequestState.RUNNING
        if self._counts is not None:
            self._counts[slot_idx] = 0
        return True

    # -- constrained decoding ------------------------------------------------
    @property
    def _cons(self):
        """The vocabulary-wide TokenConstraint, shared with the engine."""
        return self.engine.json_constraint

    def _build_machine(self, req: Request):
        """A request's automaton, fed the tokens it already emitted, so a
        preempted request resumes where it stood."""
        m = machine_for(req.sampling) or JsonMachine(require_object=True)
        tb = self._cons.token_bytes
        for t in req.output_ids:
            if not m.advance_bytes(tb[t]):
                log.error("req %d: constraint replay failed on token %d", req.id, t)
                break
        return m

    def _mask_row(self, slot: _Slot, budget: int) -> np.ndarray:
        """bool [V] of a constrained slot's legal next tokens
        (`InferenceEngine.constraint_mask`: near the budget only those that
        close the structure)."""
        return self.engine.constraint_mask(slot.machine, budget)

    def _advance_machine(self, slot_idx: int, tokens: list[int]) -> bool:
        """Feed emitted tokens to the slot's automaton (EOS stops it). A
        token it rejects fails this request alone: returns False."""
        slot = self.slots[slot_idx]
        tb = self._cons.token_bytes
        for t in tokens:
            if self.engine.tokenizer.is_eos(t) or slot.machine.complete:
                break
            if not slot.machine.advance_bytes(tb[t]):
                log.error("req %d: the constrained sampler emitted illegal token %d", slot.request.id, t)
                self._finish(slot_idx, RequestState.FAILED)
                return False
        return True

    def _emit_constrained(self, slot_idx: int, tokens: list[int], logprobs=None) -> None:
        """`_emit` for any slot; a constrained one's automaton takes the
        tokens first, and the request ends once its structure is complete."""
        slot = self.slots[slot_idx]
        if slot.machine is not None and not self._advance_machine(slot_idx, tokens):
            return
        self._emit(slot_idx, tokens, logprobs)
        if self.slots[slot_idx].request is not None and slot.machine is not None and slot.machine.complete:
            self._finish(slot_idx)

    def _prefill_tick(self, slot_idx: int) -> None:
        """Run ONE prefill chunk for the slot; on prompt completion, sample
        the first token (one host read) and switch the slot to decoding."""
        eng = self.engine
        dev = eng.device
        slot = self.slots[slot_idx]
        req = slot.request
        ids = slot.prefill_ids
        chunk_cap = eng.config.prefill_chunk
        pos = slot.prefill_next
        take = min(chunk_cap, ids.size - pos)
        bucket = min(_next_bucket(take, chunk_cap), eng.max_seq_len - pos)
        chunk = np.zeros(bucket, np.int64)
        chunk[:take] = ids[pos: pos + take]
        positions = np.arange(pos, pos + bucket, dtype=np.int64)
        own = slot_idx in self.lanes  # under a dp split, the group that owns the lane computes it
        if own:
            args = (eng.params, eng.model_cfg, torch.from_numpy(chunk[None]).to(dev),
                    torch.from_numpy(positions[None]).to(dev),
                    torch.tensor([take - 1], device=dev), self.cache)
            if self.paged:
                table = torch.from_numpy(self._table_row(slot_idx)[None]).to(dev)
                logits, self.cache = paged_prefill_step(*args, table)
            else:
                logits, self.cache = prefill_slot_step(*args, slot_idx - self.lanes.start)
        slot.prefill_next = pos + take
        if slot.prefill_next < ids.size:
            return  # more chunks to go; decode proceeds meanwhile
        # prompt complete: sample the first token (bias → penalties → sample
        # → logprobs, as a decode step does)
        if self.paged:
            self.alloc.publish_prefix([int(t) for t in ids], slot.pages)
        s = req.sampling
        if not own:  # another dp group's lane: draw what its sample draws, then take its token
            sample_logits(torch.zeros((1, eng.model_cfg.vocab_size), device=dev), self.generator,
                          s.temperature, self.top_k, s.top_p, min_p=s.min_p,
                          top_k_rows=torch.tensor([self._effective_top_k(s.top_k)], device=dev))
            tok, lps = self._first_from_owner(slot_idx, None, None, s)
            self._start_decoding(slot_idx, tok, lps)
            return
        if s.logit_bias:
            b_ids, b_vals = self._bias_row(s)
            logits = apply_logit_bias(logits, torch.from_numpy(b_ids[None]).to(dev),
                                      torch.from_numpy(b_vals[None]).to(dev))
        if s.has_penalties:
            # the tokens a preempted request already emitted count again
            counts = self._counts_on()
            counts[slot_idx] = torch.bincount(
                torch.tensor(req.output_ids, dtype=torch.int64),
                minlength=eng.model_cfg.vocab_size).to(device=dev, dtype=counts.dtype)
            logits = apply_penalties(logits, counts[slot_idx:slot_idx + 1],
                                     s.presence_penalty, s.frequency_penalty)
        if slot.machine is not None:
            mask = self._mask_row(slot, s.max_new_tokens - len(req.output_ids))
            logits = logits.masked_fill(~torch.from_numpy(mask).to(dev)[None], float("-inf"))
        tok_dev = sample_logits(
            logits, self.generator, s.temperature, self.top_k, s.top_p, min_p=s.min_p,
            top_k_rows=torch.tensor([self._effective_top_k(s.top_k)], device=dev),
        )
        if s.has_penalties:
            self._counts[slot_idx:slot_idx + 1].scatter_add_(
                1, tok_dev[:, None], torch.ones_like(self._counts[:1, :1]))
        lp_dev = None if s.logprobs is None else token_logprobs(logits, tok_dev, s.top_logprobs)
        if self.dp_comm is not None:
            tok, lps = self._first_from_owner(slot_idx, tok_dev, lp_dev, s)
        else:
            tok = int(tok_dev[0])  # the one host read of the prefill's end
            lps = None if lp_dev is None else [logprob_entry(*(a.tolist() for a in lp_dev), 0, s.top_logprobs, tok)]
        self._start_decoding(slot_idx, tok, lps)

    def _start_decoding(self, slot_idx: int, tok: int, lps) -> None:
        """A slot whose prompt is in: its first token `tok` is emitted and
        it decodes from the next step on."""
        slot = self.slots[slot_idx]
        req, n = slot.request, int(slot.prefill_ids.size)
        slot.prefill_ids = None
        slot.pos = n
        slot.budget = min(req.sampling.max_new_tokens - len(req.output_ids), self.engine.max_seq_len - n)
        slot.next_token = tok
        self._emit_constrained(slot_idx, [tok], lps)

    def _first_from_owner(self, slot_idx: int, tok_dev, lp_dev, s) -> tuple[int, list | None]:
        """Under a dp split: the first token of `slot_idx` (and its logprob
        entry), broadcast over dp from the group that owns the lane (which
        passes `tok_dev` and `lp_dev`; the others None)."""
        k = max(s.top_logprobs, 1)
        width = 1 + (0 if s.logprobs is None else 1 + 2 * k)
        if tok_dev is None:
            buf = torch.empty((1, width), dtype=torch.float64, device=self.engine.device)
        else:
            buf = self._rows(tok_dev[:, None], *(() if lp_dev is None else lp_dev))
        self.dp_comm.broadcast_from(buf, slot_idx // len(self.lanes), "broadcast_first")
        row = buf[0].tolist()  # the host read of the prefill's end
        tok = int(row[0])
        if s.logprobs is None:
            return tok, None
        arrays = [[row[1]], [row[2:2 + k]], [row[2 + k:]]]
        return tok, [logprob_entry(*arrays, 0, s.top_logprobs, tok)]

    @staticmethod
    def _rows(*parts: torch.Tensor) -> torch.Tensor:
        """[B, ...] tensors as one [B, X] f64 tensor (exact for token ids
        and f32 logprobs): what a dp group sends of its lanes."""
        return torch.cat([p.reshape(p.shape[0], -1).to(torch.float64) for p in parts], dim=1)

    def _gather_lanes(self, *parts: torch.Tensor) -> list[torch.Tensor]:
        """Every dp group's rows of `parts` ([lanes, ...] tensors), joined
        in lane order over dp (one gather) and cast back to each part's
        dtype: [max_batch, ...] each."""
        full = self.dp_comm.gather(self._rows(*parts), 0, "gather_lanes")
        out, at = [], 0
        for p in parts:
            w = math.prod(p.shape[1:])
            out.append(full[:, at:at + w].reshape(-1, *p.shape[1:]).to(p.dtype))
            at += w
        return out

    def _counts_on(self) -> torch.Tensor:
        """The output-token counts [max_batch, V] int32, made on first use."""
        if self._counts is None:
            self._counts = torch.zeros((self.max_batch, self.engine.model_cfg.vocab_size),
                                       dtype=torch.int32, device=self.engine.device)
        return self._counts

    def _bias_row(self, sampling) -> tuple[np.ndarray, np.ndarray]:
        """Fixed-width (ids, biases) row; requests with more than
        `bias_width` entries keep the largest-magnitude ones."""
        ids = np.zeros(self.bias_width, np.int64)
        vals = np.zeros(self.bias_width, np.float32)
        pairs = sorted(sampling.logit_bias, key=lambda p: -abs(float(p[1])))
        if len(pairs) > self.bias_width and not self._warned_bias_clamp:
            self._warned_bias_clamp = True
            log.warning("request logit_bias has %d entries; keeping the %d largest "
                        "(BatchEngine.bias_width)", len(pairs), self.bias_width)
        for j, (tid, b) in enumerate(pairs[: self.bias_width]):
            ids[j] = int(tid)
            vals[j] = float(b)
        return ids, vals

    def _table_row(self, slot_idx: int) -> np.ndarray:
        row = np.zeros(self.max_pages, np.int32)  # sink-padded
        pages = self.slots[slot_idx].pages
        row[: len(pages)] = pages
        return row

    def _effective_top_k(self, requested: int) -> int:
        """Clamp a request's top_k to the static sampling window. top_k <= 0
        means "disabled" (sample from the whole window)."""
        if requested <= 0 or requested >= self.top_k:
            if requested > self.top_k and not self._warned_topk_clamp:
                self._warned_topk_clamp = True
                log.warning("request top_k=%d exceeds the engine sampling window (%d); "
                            "clamping (larger windows: BatchEngine.top_k)", requested, self.top_k)
            return self.top_k
        return requested

    def _emit(self, slot_idx: int, tokens: list[int], logprobs: list[dict] | None = None) -> None:
        """Push tokens to the request stream; finish on EOS/budget.
        `logprobs` (when the request asked for them) runs parallel to
        `tokens`; entries for tokens cut by EOS/budget are dropped too."""
        slot = self.slots[slot_idx]
        req = slot.request
        tok_eos = self.engine.tokenizer.is_eos
        for j, t in enumerate(tokens):
            if req.first_token_at is None:
                req.first_token_at = time.perf_counter()
            if tok_eos(t) or slot.budget <= 0:
                self._finish(slot_idx)
                return
            req.output_ids.append(t)
            if logprobs is not None:
                req.logprob_data.append(logprobs[j])
            req.out.put(t)
            slot.budget -= 1
        if slot.budget <= 0:
            self._finish(slot_idx)

    def _finish(self, slot_idx: int, state: RequestState = RequestState.FINISHED) -> None:
        slot = self.slots[slot_idx]
        req = slot.request
        req.state = state
        req.finished_at = time.perf_counter()
        req.out.put(_END)
        self._cancelled.discard(req.id)
        if self.paged and slot.pages:
            self.alloc.release(slot.pages)
        self.slots[slot_idx] = _Slot()

    def _preempt(self, slot_idx: int) -> None:
        """Recompute-preemption: free the slot's pages and requeue the
        request; on re-admission its prompt + already-emitted tokens are
        prefilled again (usually cheap: the pages stay warm in the prefix
        cache) and generation continues without visible interruption."""
        slot = self.slots[slot_idx]
        req = slot.request
        self.preemptions += 1
        log.info("preempting request %d (%d tokens generated): KV pool full",
                 req.id, len(req.output_ids))
        if slot.pages:
            self.alloc.release(slot.pages)
        self.slots[slot_idx] = _Slot()
        self._requeue_front(req)

    def _grow_tables(self, active_idx: list[int], n: int) -> list[int]:
        """Ensure each active slot's block table covers pos + n more tokens;
        preempts the youngest slots when the pool is exhausted. Returns the
        still-occupied slot indices."""
        ps = self.page_size
        # oldest-first page growth; youngest-first preemption victims
        for i in sorted(active_idx, key=lambda j: self.slots[j].request.submitted_at):
            slot = self.slots[i]
            if slot.request is None:  # preempted for an older slot in this loop
                continue
            need = -(-(slot.pos + n) // ps) - len(slot.pages)
            while need > 0:
                try:
                    slot.pages.extend(self.alloc.alloc(need))
                    need = 0
                except OutOfPages:
                    victims = [j for j in active_idx
                               if j != i and self.slots[j].request is not None]
                    if not victims:
                        log.warning("request %d out of KV pages with no victim to preempt; "
                                    "finishing early", slot.request.id)
                        self._finish(i)
                        break
                    victim = max(victims, key=lambda j: self.slots[j].request.submitted_at)
                    self._preempt(victim)
        return [i for i, s in enumerate(self.slots) if s.request is not None]

    def _sweep_cancelled(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.request is not None and self._is_cancelled(slot.request):
                self._finish(i, RequestState.CANCELLED)

    def _busy(self) -> int:
        return sum(1 for s in self.slots if s.request is not None)

    def step(self) -> int:
        """One scheduler iteration: admit, advance up to
        `prefill_ticks_per_step` pending prefills by one chunk each, then one
        fused decode chunk for the decoding slots (one host read-back).
        Returns the number of occupied slots after the step. Under a mesh
        only rank 0 calls it (the others `follow`); it first broadcasts the
        inbox."""
        if self.comm is not None and not self.comm.is_root:
            raise RuntimeError("the ranks other than 0 of a mesh run follow(), not step()")
        self._sync()
        return self._step()

    def _step(self) -> int:
        self._admit()
        self._sweep_cancelled()
        prefilling = [i for i, s in enumerate(self.slots) if s.prefilling]
        for i in prefilling[: self.prefill_ticks_per_step]:
            self._prefill_tick(i)
        active_idx = [i for i, s in enumerate(self.slots)
                      if s.request is not None and not s.prefilling]
        if not active_idx:
            return self._busy()
        max_seq = self.engine.max_seq_len
        # the chunk must fit the tightest slot's remaining cache room
        n = min(self.decode_chunk, min(max_seq - self.slots[i].pos for i in active_idx))
        if any(self.slots[i].machine is not None for i in active_idx):
            n = 1  # a constrained slot's next mask needs this step's token
        elif self._spec_eligible(active_idx):
            self._spec_step(active_idx)
            return self._busy()
        if self.paged:
            active_idx = self._grow_tables(active_idx, n)
            active_idx = [i for i in active_idx if not self.slots[i].prefilling]
            if not active_idx:
                return self._busy()
            # lane compaction: block tables make lanes virtual, so the chunk
            # runs at the smallest power of two covering the active slots
            rows = list(active_idx)
            width = min(1 << (len(rows) - 1).bit_length(), self.max_batch)
        else:  # the lanes this rank holds (all of them without a dp split)
            rows = list(self.lanes)
            width = len(rows)
        row_of = {i: j for j, i in enumerate(rows)}
        tokens = np.zeros(width, np.int64)
        positions = np.zeros(width, np.int64)
        active = np.zeros(width, bool)
        temps = np.zeros(width, np.float32)
        top_ps = np.ones(width, np.float32)
        top_ks = np.full(width, self.top_k, np.int64)
        min_ps = np.zeros(width, np.float32)
        pres = np.zeros(width, np.float32)
        freqs = np.zeros(width, np.float32)
        bias_ids = np.zeros((width, self.bias_width), np.int64)
        bias_vals = np.zeros((width, self.bias_width), np.float32)
        any_bias = any_pen = False
        if not self.paged:
            # a dense lane that is mid-prefill writes its frozen row at the
            # next position its prefill will overwrite, not at 0
            for i in rows:
                if self.slots[i].prefilling:
                    positions[row_of[i]] = self.slots[i].prefill_next
        for i in active_idx:
            if i not in row_of:  # another dp group's lane
                continue
            j = row_of[i]
            s = self.slots[i]
            tokens[j] = s.next_token
            positions[j] = s.pos
            active[j] = True
            sp = s.request.sampling
            temps[j] = sp.temperature
            top_ps[j] = sp.top_p
            top_ks[j] = self._effective_top_k(sp.top_k)
            min_ps[j] = sp.min_p
            pres[j] = sp.presence_penalty
            freqs[j] = sp.frequency_penalty
            if sp.logit_bias:
                bias_ids[j], bias_vals[j] = self._bias_row(sp)
                any_bias = True
            any_pen |= sp.has_penalties
        want_lp = [self.slots[i].request.sampling.top_logprobs for i in active_idx
                   if self.slots[i].request.sampling.logprobs is not None]
        dev = self.engine.device
        on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        kw = dict(temperature=on(temps), top_k=self.top_k, top_p=on(top_ps), min_p=on(min_ps),
                  active=on(active), top_k_rows=on(top_ks))
        if any_bias:
            kw.update(bias_ids=on(bias_ids), bias_vals=on(bias_vals))
        if any_pen:
            # the compacted rows' counts (pad lanes read slot 0's, and are dropped)
            row_sel = on(np.asarray(rows + [0] * (width - len(rows)), np.int64))
            kw.update(presence=on(pres), frequency=on(freqs),
                      counts=self._counts_on().index_select(0, row_sel))
        if want_lp:
            kw["n_logprobs"] = max(want_lp)
        constrained = [i for i in active_idx if self.slots[i].machine is not None and i in row_of]
        if constrained:  # every other row may take any token
            amask = np.ones((width, self.engine.model_cfg.vocab_size), bool)
            for i in constrained:
                amask[row_of[i]] = self._mask_row(self.slots[i], self.slots[i].budget)
            kw["allowed_mask"] = on(amask)
        if self.paged:
            tables = np.zeros((width, self.max_pages), np.int32)  # pad lanes: the sink page
            for j, i in enumerate(rows):
                tables[j] = self._table_row(i)
            out = paged_decode_loop(
                self.engine.params, self.engine.model_cfg, on(tokens), on(positions),
                self.cache, on(tables), self.generator, n, **kw)
        else:
            if self.dp_comm is not None:  # the whole batch's draws, this rank's rows
                kw["lanes"] = (self.lanes.start, self.max_batch)
            out = decode_loop(
                self.engine.params, self.engine.model_cfg, on(tokens), on(positions),
                self.cache, self.generator, n, **kw)
        toks, nxt, self.cache, _ = out[:4]
        rest = list(out[4:])
        if any_pen:
            self._counts.index_copy_(0, on(np.asarray(rows, np.int64)), rest.pop(0)[: len(rows)])
        if self.dp_comm is not None:  # every dp group's lanes, in lane order
            toks, nxt, *rest = self._gather_lanes(toks, nxt, *rest)
            row_of = {i: i for i in range(self.max_batch)}
        host = torch.cat([toks, nxt[:, None]], dim=1).tolist()  # the chunk's one sync
        lp_host = [a.tolist() for a in rest] if want_lp else None  # read after that sync
        for i in active_idx:
            j = row_of[i]
            row = host[j]
            slot = self.slots[i]
            # toks[j] = [prev next_token (already emitted), t1, ..., t_{n-1}];
            # fresh tokens for the stream are t1..t_{n-1} plus the new tail
            fresh = row[1:]
            lps = None
            sp = slot.request.sampling
            if lp_host is not None and sp.logprobs is not None:
                # step k's arrays describe fresh[k]
                lp_a, tid_a, tlp_a = (a[j] for a in lp_host)
                lps = [logprob_entry(lp_a, tid_a, tlp_a, k, sp.top_logprobs, fresh[k]) for k in range(n)]
            slot.pos += n
            slot.next_token = row[-1]
            self._emit_constrained(i, fresh, lps)
            if self.slots[i].request is not None and slot.pos >= max_seq:
                self._finish(i)  # out of cache room
        return self._busy()

    # -- batched speculative decoding ----------------------------------------
    def _spec_eligible(self, active_idx: list[int]) -> bool:
        """The decoding slots speculate together when the engine asks for
        "ngram" (the JAX BatchEngine speculates for nothing else), every
        slot has room for a call's rounds, and none asks for a logit bias,
        penalties, logprobs or a constraint (the verify does not model
        them). Greedy and sampled slots mix."""
        cfg = self.engine.config
        if cfg.speculative != "ngram" or not active_idx:
            return False
        lookahead = max(1, cfg.spec_rounds) * (max(1, cfg.spec_tokens) + 1)
        if min(self.engine.max_seq_len - self.slots[i].pos for i in active_idx) < lookahead:
            return False  # the cache tail: plain chunks
        for i in active_idx:
            slot = self.slots[i]
            sp = slot.request.sampling
            if sp.logit_bias or sp.has_penalties or sp.logprobs is not None or slot.machine is not None:
                return False
        return True

    def _spec_step(self, active_idx: list[int]) -> None:
        """One `spec_decode_rounds` call for every decoding slot (the JAX
        `_spec_step`), read back once. Paged: the rows are the decoding
        slots compacted to a power-of-two width, the pad lanes inactive on
        the sink page. Dense: the max_batch lanes, those not decoding
        inactive (they write no K/V row)."""
        cfg = self.engine.config
        gamma, ngram, rounds = max(1, cfg.spec_tokens), max(1, cfg.spec_ngram), max(1, cfg.spec_rounds)
        if self.paged:
            active_idx = self._grow_tables(active_idx, rounds * (gamma + 1))
            active_idx = [i for i in active_idx if not self.slots[i].prefilling]
            if not active_idx:
                return
            rows = list(active_idx)
            width = min(1 << (len(rows) - 1).bit_length(), self.max_batch)
        else:  # the lanes this rank holds (all of them without a dp split)
            rows = list(self.lanes)
            width = len(rows)
        row_of = {i: j for j, i in enumerate(rows)}
        s = self.engine.max_seq_len
        tokens = np.zeros(width, np.int64)
        positions = np.zeros(width, np.int64)
        active = np.zeros(width, bool)
        hist = np.zeros((width, s), np.int64)
        hlen = np.ones(width, np.int64)  # >= 1 keeps the drafter's indices in range
        temps = np.zeros(width, np.float32)
        top_ps = np.ones(width, np.float32)
        top_ks = np.full(width, self.top_k, np.int64)
        min_ps = np.zeros(width, np.float32)
        for i in active_idx:
            if i not in row_of:  # another dp group's lane
                continue
            j = row_of[i]
            slot = self.slots[i]
            sp = slot.request.sampling
            # the host record ends with the pending token (next_token == output_ids[-1])
            ids = (list(slot.request.prompt_ids) + list(slot.request.output_ids))[-s:]
            hist[j, :len(ids)] = ids
            hlen[j] = len(ids)
            tokens[j], positions[j], active[j] = slot.next_token, slot.pos, True
            temps[j], top_ps[j], min_ps[j] = sp.temperature, sp.top_p, sp.min_p
            top_ks[j] = self._effective_top_k(sp.top_k)
        dev = self.engine.device
        on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        kw = {}
        # rejection sampling where any slot samples (all dp groups alike); greedy lanes keep the argmax rule
        if any(self.slots[i].request.sampling.temperature > 0 for i in active_idx):
            kw = dict(generator=self.generator, temps=on(temps), top_k=self.top_k, top_ps=on(top_ps),
                      top_k_rows=on(top_ks), min_ps=on(min_ps))
            if self.dp_comm is not None:
                kw["lanes"] = (self.lanes.start, self.max_batch)
        if self.paged:
            tables = np.zeros((width, self.max_pages), np.int32)  # pad lanes: the sink page
            for j, i in enumerate(rows):
                tables[j] = self._table_row(i)
            kw["page_tables"] = on(tables)
        eos = torch.tensor(sorted(self.engine.tokenizer.eos_ids) or [-2], device=dev)
        outs, ocnt, pend, _, self.cache, _, _, act, dr, ac = spec_decode_rounds(
            self.engine.params, self.engine.model_cfg, on(tokens), on(positions), self.cache, on(hist),
            on(hlen), eos, on(active), rounds, gamma, ngram, **kw)
        res = torch.cat([outs, torch.stack([ocnt, pend, act.long(), dr, ac], dim=1)], dim=1)
        if self.dp_comm is not None:  # every dp group's lanes, in lane order
            res = self._gather_lanes(res)[0]
            row_of = {i: i for i in range(self.max_batch)}
        host = res.tolist()
        n_out = outs.shape[1]
        for i in active_idx:
            row = host[row_of[i]]
            cnt, nxt, live, drafted, accepted = row[n_out:]
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            slot = self.slots[i]
            # row[0] is the pending token, already emitted; the new ones are
            # row[1:cnt] and the new pending token, unless the lane hit EOS
            fresh = row[1:cnt] + ([nxt] if live else [])
            slot.pos += cnt
            slot.next_token = nxt
            self._emit(i, fresh)
            if self.slots[i].request is not None and not live:
                self._finish(i)  # EOS inside the rounds (not streamed)

    # -- background driving -------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.step()
            except Exception:  # noqa: BLE001 - the worker must keep serving
                log.exception("scheduler step failed; failing the running requests")
                for i, s in enumerate(self.slots):
                    if s.request is not None:
                        self._finish(i, RequestState.FAILED)
                if self.comm is not None:  # a rank or a collective failed: stop, do not go on alone
                    self._broken = True
                    return
                continue
            if n == 0:
                if self.comm is None:
                    time.sleep(0.002)
                else:  # idle: step again on the next submit, or within 50 ms
                    self._wake.wait(0.05)
                    self._wake.clear()

    def close(self) -> None:
        """Stop the background thread; under a mesh rank 0 then broadcasts
        the end, which returns the other ranks from `follow`."""
        self._stop.set()
        if self._thread is not None:
            self._wake.set()
            self._thread.join(timeout=30)
            self._thread = None
        if self.comm is not None and self.comm.is_root and not (self._closed or self._broken):
            self._closed = True
            self._sync(close=True)
