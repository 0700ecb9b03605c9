"""Chip smoke for the PyTorch/CUDA port (nfai_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only build,kernels   # a quick kernel check
    python3 chip_smoke.py --only build,kernels --kernels k12   # one matmul kernel's rows
    python3 chip_smoke.py --only build,kernels --kernels k11   # K11 (dense) alone
    python3 chip_smoke.py --only build,kernels --kernels k4    # K4 (prefill attention) alone
    python3 chip_smoke.py --only build,kernels --kernels k2,k7 # K2 / K7 (decode attention), int8 and Gemma rows
    python3 chip_smoke.py --only build,kernels --kernels k5    # K5 (fused MLP) alone
    python3 chip_smoke.py --only build,kernels --kernels k3    # K3 / K10 and the K/V store
    python3 chip_smoke.py --only build,serve,batch,profile --models E   # one model's path
    python3 chip_smoke.py --only build,options,eval   # the OpenAI options, sessions and eval on A / A8
    python3 chip_smoke.py --only build,constrained,spec   # constrained and speculative decoding on A
    python3 chip_smoke.py --only build,serve,batch,profile,server,parity --models Q,P,M   # the families
    python3 chip_smoke.py --only build,tools   # the host tools and the native dequant library
    python3 chip_smoke.py --only build,parallel   # the mesh: NCCL at world size 1, tp, sp, EP over gloo

Phases (each failure propagates, the exit code is then non-zero):
  build    print the card, its power limit and the versions; build every
           kernel from csrc/ (one nvcc per source, in parallel)
  kernels  hold K1-K11 against their plain PyTorch versions on the card at
           the slice's shapes (K1 at rows 1, 8, 16, 64, 256 and 1024, each
           path of it: the CUDA-core GEMV, the tensor-core GEMV and the wgmma
           tiles 16, 64 and 128 wide, three launches with the same bits;
           K6 the same at every (K, N) of the path, the heads of models B,
           C and G, a g32 layer with mins, at rows 1, 2, 8, 16, 24, 32,
           64, 256 and 1024 (G's head at 1 and 8);
           K2/K3/K4/K7 at head_dim 64, 96 and 128 (K2/K7 at GQA ratios
           5, 6, 7 and 16: the families' heads); K8/K9 at
           the decode layouts of a batch-1 and a batch-8 routing and a
           256-token prefill chunk); the int8 KV cache's kernels on int8
           codes and scales from quantize_kv: K2-i8, K4-i8 and K7-i8 at the
           K2/K4/K7 cases, K2 and K7 (bf16 and int8) also at batch 8 with
           4000 keys in a 4096-slot cache, K10 (the scale write) exactly at
           models A's and C's scale arrays; the K/V store (--kernels k3)
           bit for bit against its plain version run on the CPU: the dense
           decode store at A's, C's and G's caches (all layers' K and V in
           one launch), the dense prefill store (8x128 and batch-1 chunks,
           one with its tail past the cache) and the paged store (decode at
           page sizes 128 and 16, a 256-token chunk; C's and G's heads),
           bf16 and int8, ragged positions and a dropped row in every case,
           each timed beside the route it replaced; K5 three times on the same
           inputs (the same bits); Gemma's K2/K4/K7 (bf16 and int8) at
           head_dim 256: model G's heads with softcap 50 and window 0 or
           4096, Gemma-3-1B's with window 512, Gemma 2B's (r = 8), and at
           4000 keys window 512 beside window 0; K11 (dense matmul) at model
           D's projections and Gemma-3-1B's K = 1152, rows 1, 8, 16, 24,
           32, 64, 256 and 1024 (the GEMVs, each wgmma tile width and the
           cluster K split), three launches with the same bits; K12 (q8v3 matmul) at
           model E's projections and head, rows 1, 8, 16, 32, 64, 256 (and
           1024 below the head), model B's Q6_K wv and w_down at rows 16,
           256 and 1024, and wo in the g16 / mins kinds, three launches with
           the same bits, beside K6 on the same int8 codes; K4 (every case
           in `_kernels_k4`, --kernels k4): the verify forward's shape (T =
           9 at batch 1 and 8, ragged offsets, a lane frozen at the cache's
           length), "full" at models A's, C's, E's,
           the 3B's and Gemma's heads (A's batch-1 16-token bucket at offset
           1000: the short grid), bf16 and int8, then the "headmajor"
           (K4-hm) and "merged" layouts, bf16 and int8, at model E's heads,
           A's (D = 64: "merged" must be refused) and G's (softcap, window),
           each against its plain version and against "full" on the same
           values; time kernel, plain version and the library yardstick
           with CUDA events (L2 flushed before each launch)
  serve    per model, write a GGUF of published widths (random raw blocks),
           load it with InferenceEngine(device="cuda") and answer three
           ChatSession requests through its chat template (one prompt > 256
           tokens: a second prefill chunk runs at an offset); TTFT and
           decode tok/s per request
  batch    prefill_step on an 8x128 prompt, then decode_loop for 64 tokens
           at batch 8, S = 1024 (the bench.py shape); decode tok/s, the
           kernel launches and host syncs per decode step, the byte bound,
           the cache MB; for A and A8 also the long context: batch 8 in a
           4096-slot cache with 3500 positions of random rows, 32 decode
           steps under the profiler (device ms/step, K2 ms per launch, each
           beside its byte bound)
  profile  torch.profiler over 8 more decode steps of that batch: device
           busy share of the wall time and device time by kernel (K1's,
           K6's, K11's, K12's and K4's ms a step tallied by their functions'
           names); for models E and D also over one more 8x128 prefill
           chunk, whose matmul device time is tallied by path (E: K12's GEMV
           for the head, wgmma tiles for the layers; D: K11's tiles) beside
           K4's (once a layer)
  server   continuous batching on model A's engine: paged vs dense
           forwards on the card (a 300-token prefill, 8 teacher-forced
           decode steps at batch 4), a timed and profiled batch-8 paged
           decode, then the main path with the counts zeroed: a paged
           BatchEngine serving 16 requests (prefix sharing, a 3-chunk
           prompt, mixed sampling), a starved pool that must preempt, and
           8 concurrent HTTP requests (SSE and blocking) through the server;
           the same on A8's engine (the int8 pool, 4 HTTP requests; its
           paged-vs-dense check is held to INT8_TOL or, where larger, the
           int8 cache's own error against a bf16 cache on the same forward:
           the dense decode folds
           the new token in at full precision, the paged one reads it back
           quantized); the paged-vs-dense forwards run on A's K5 route,
           whose two identical dense prefills must give the same bits; on
           model C's and model G's engines a paged BatchEngine serving 8
           requests; on model D's engine the same 8-request paged BatchEngine
  parity   2-layer full-width copies on cuda and on cpu (plain versions):
           three Llama-3.2-1B kinds (Q4_K, the Q4_K_M mix, F16;
           the Q8_0 kind is the tools phase's requantized copy) and the
           Llama-3.2-3B widths (K1 at K =
           3072, K5 at H = 3072, K2/K4 at head_dim 128): prefill logits and
           4 teacher-forced decode steps within tolerance; the Q4_K copy
           also prefills one chunk of more than 1024 rows (the mlp_prefill
           route) and runs the same steps through the paged pool; model C:
           each layer's MoE FFN on one routing fed to both sides, then every
           prompt row and 4 decode steps, router near-ties left out and
           counted; the Q4_K copy (dense and paged) and model C's again
           with an int8 cache on both sides (within INT8_TOL: each device
           quantizes its own K/V); a Gemma-3-1B-width copy (layer 0 local
           with window 512 and the local rope base, layer 1 global) on a
           700-token prompt and 4 decode steps past it, dense and paged,
           bf16 and int8; the same on llama.cpp's Q4_K_M mix of Gemma-3-1B
           (Q5_0 and a dequantized Q8_0 layer dense, through K11 beside K1
           and K6); dense weights: the F16 copy (dense and paged),
           the Q4_K_M copy and model C's with param_dtype="bfloat16" (every
           weight dequantized at load: K11, no K1/K5/K6/K8/K9); the Q4_K_M
           copy again under NFAI_Q8V3=1 (its Q6_K layers on K12, its tied
           Q6_K head on K6); model E's 2-layer copy under NFAI_Q8V3=1:
           "headmajor" dense and paged on bf16 and int8 caches, "merged"
           dense (K12, K4-hm, K4-hm-i8 and K4's merged variant); the
           families' 2-layer copies (Q, P, M; Q also on int8 caches), dense
           and paged, each also against the CPU's f32 forward
  options  on model A's engine, with the counts zeroed: generate at batch 1
           with a +100 logit bias (its token forced on every greedy step),
           then a frequency penalty of 30 (the repeat broken within 4),
           logprobs with the top 5 (finite, <= 0, sorted); a ChatSession
           saved, loaded and continued (the loaded cache holds the saved
           bits on the card, the continuation equals the uninterrupted
           session); the batch-8 decode with the three options off and on
           (wall and device ms a step, the launches they add a step) and
           its host syncs per step with them on (must be 0): the path "A
           options"; then the paged BatchEngine at batch 8 with mixed slots
           (each greedy slot's tokens equal generate's, up to a near-tie)
           and one HTTP request with logprobs, whole and streamed: "A
           options server"; on A8's engine the session round trip on the
           int8 cache and generate with the options: "A8 options"
  constrained  on model A's engine: generate at batch 1, greedy, with JSON
           mode, a JSON Schema, a GBNF grammar and a regex (each text must
           satisfy its constraint: json.loads, the schema's required keys,
           re.fullmatch), the host syncs a constrained step ("A
           constrained"); the paged BatchEngine at batch 8 with the four
           constraints beside four plain slots ("A constrained server")
  spec     on model A's engine: speculative="ngram" and "draft" (a 2-layer
           GGUF of A's widths and vocabulary) at batch 1, greedy, each equal
           to plain greedy decoding up to the plain stream's first top-two
           logit gap below TOL x the logit scale (printed with its gap), with
           tokens per verify forward, acceptance and wall tok/s against plain;
           a sampled ngram request; the verify forward (T = 9) at batch 1 and
           8 against the same tokens fed one decode step at a time (a frozen
           lane's rows unchanged, no host sync) and its device ms against one
           decode step's ("A spec"); the paged BatchEngine at batch 8 with
           greedy and sampled slots speculating together ("A spec server")
  eval     nfai_tpu_torch.eval on model A: one 512-token window of a seeded
           id stream on a bf16 and on an int8 cache, seconds a window
           ("A eval": K4 / K4-i8, the store and K5 once a layer a window,
           K1 for wqkv, wo and the head at M = 512); K1's head at M = 512
           timed beside its plain version and cuBLAS, with its bound; the
           2-layer Q4_K copy's window on the card against the CPU's plain
           versions (mean NLL within TOL, INT8_TOL on the int8 cache)
  tools    the host tools (nfai_tpu_torch.tools) and the native dequant
           library on the card machine's host: the 13 kinds the library
           decodes, on random blocks at normal and subnormal f16 scales and
           on encoded values, bit for bit against the numpy codecs, and its
           fused transpose against the decode's transpose; model A's F16
           token table, a Q6_K tensor of C, Q's tied Q6_K table and every
           F16 weight of D decoded both ways (the same bits; seconds each,
           the OpenMP team); A's and D's engine loads again with the numpy
           codecs forced, beside serve's loads; `validate` on model A at
           full width and depth (--update through the entry point, then on
           A's loaded engine: exit 0, and 1 with the fixture's ppl moved by
           1%) and on a 2-layer copy of A written with another seed (exit 2;
           its card ppl beside the CPU's f32 ppl on the same file): "A
           validate"; that copy requantized to Q8_0 and inspected, then
           served on the card (every projection and the head on K6, no K1
           or K5, 4 x layers + 1 K6 launches a decode step; prefill and 4
           decode steps within TOL of the CPU's plain versions: "A q8_0")
           and through a paged BatchEngine ("A q8_0 server"); every model's
           engine load time at the end
  parallel the mesh and Megatron tensor parallelism (nfai_tpu_torch.parallel) in
           child processes, waited on by a thread while the parity copies
           run (they time nothing), each world within PAR_TIMEOUT_S (a child
           that fails, hangs or exits non-zero fails the phase): NCCL at
           world size 1, model A at full width and depth as a {"tp": 1} mesh
           beside the single-device engine in the same process (prefill
           logits and 16 greedy tokens bit-equal; it also writes the
           single-device references below and prints that engine's own
           spread between two prefill chunkings); then tp = 2 over gloo
           with both ranks on the one card (NCCL takes one rank a device):
           each rank's local heads, weight bytes beside one device's, A's
           prefill and 8 teacher-forced decode steps against the
           single-device engine (PATH_TOL per row: A's bf16 routes against
           each other at 16 random layers), a decode step's collectives (2L
           + 1, and the gathers staged through the host under gloo) and
           launches (the route the containers imply), greedy and sampled
           tokens equal on both ranks, a paged BatchEngine of 8 requests (4
           share a prefix) and one SSE chat and one completion over HTTP
           served by rank 0 while rank 1 follows; then 2-layer copies of A
           and of Q (Qwen2.5-1.5B's widths: biases, 6 / 1 heads a rank, the
           tied Q6_K head split over the vocabulary on K6, the
           vocab-parallel embedding) against one device (TOL per row);
           then, in the same world: speculative="draft" on A with its
           2-layer copy drafting (the draft engine on the target's Mesh,
           its own Comm; greedy against plain greedy by the near-tie rule),
           {"dp": 2, "tp": 1} on A's dense BatchEngine (each rank 4 of 8
           lanes: cache bytes half of one device's, a step's launches, one
           gather over dp a chunk, the streams against one device's by the
           near-tie rule), {"tp": 1, "x": 2} on A's 2-layer copy (bit-equal
           to one device), and 2-layer full-width copies of D (F16, K11) and
           of E (Q8_0 under NFAI_Q8V3=1 around its load, K6: no split weight
           takes K12 at E's widths) at tp = 2 against one device. Each
           rank's paths join the launch counts ("parallel ..."). Then, over
           gloo on the one card: a references child (one device: model A
           and its 2-layer copy on SP_PROMPT tokens in SP_SLOTS slots, bf16
           and int8 caches; model C and its 2-layer copy with each row's
           router near-tie flag); sp = 2 with seq_parallel (each rank half
           of every layer's cache; A prefill + 16 teacher-forced steps
           within PATH_TOL, the copies within TOL, a decode step's max and
           sums over sp, the ring against the stats merge on layer 0's
           slices, no K2 / K4 on the path: attention is PyTorch ops, as in
           JAX); tp = 2 on model C with expert_parallel and with the ffn
           split (expert bytes half of one device's, C within PATH_TOL and
           its copy within TOL on the rows without a router near-tie, a
           decode step's collectives and K8 / K9 launches, a paged
           BatchEngine of 8 requests); and in this process A in two
           pipeline stages on cuda:0 against its one-stage forward. Two
           ranks time-sharing one card say nothing of TP's, SP's or EP's
           speed
With only options, eval, constrained, spec or tools (no serve or batch) the
main path is model A (and A8 for options) alone; each needs serve's load of
those engines, which runs. With tools, models C, Q and D are also written,
for their host decodes alone.
The main path is nine models, A8, E8 and Q8, each driven by serve, batch
and profile; A's and A8's engines then serve continuously batched traffic,
and so do C's, G's, D's, E's, Q's, P's and M's (the last three also one SSE
chat and one completion over HTTP):
  A  the untied Q4_K Llama-3.2-1B in the JAX package's default
     configuration: every layer's MLP is one K5 launch (16 per decode
     step), no K6;
  B  the Q4_K_M mix llama.cpp writes, 8 of the 16 layers (B_LAYERS, cut
     for the run's time: it repeats A's widths): tied Q6_K table
     (K6 head, embedding rows gathered from it), Q6_K attn_v/ffn_down on the
     layers `use_more_bits` picks (4 of 8, K6), Q4_K elsewhere (K1); no K5,
     as the JAX route;
  C  qwen3moe at Qwen3-30B-A3B's widths, 8 of its 48 layers (C_LAYERS),
     in the Q4_K_M mix: q/k norms, NEOX rope, head_dim 128 (K2/K4 at
     D = 128, r = 8), per layer K8 for the gate and up experts and for a
     4-bit down, K9 for a Q6_K down, K6 for the Q6_K head and attn_v; no K5;
  G  gemma2 at Gemma-2-2B's widths (hidden 2304, 8 of 26 layers (G_LAYERS), 8 / 4 heads of
     head_dim 256, ffn 9216, vocab 256000 of SPM pieces, window 4096 on
     every second layer, softcaps 50 / 30, tied embeddings) in the Q4_K_M
     mix: K2/K4 at D = 256 with softcap on every layer and the window on
     the local ones, K1 and K6 (Q6_K attn_v / ffn_down, the tied head); no
     K5 (K = 2304); its server path K7 with the same options;
  D  Llama-3.2-1B as llama.cpp's f16 conversion writes it (F16 matmul
     weights, a tied F16 table; 8 of 16 layers, D_LAYERS): every projection dense through K11
     (4 launches a layer: wqkv, wo, gate_up, down; no K1/K5/K6), the tied
     head torch.matmul, the embedding rows gathered from the same table;
     its profile phase also records one 8x128 prefill chunk, whose 64
     projections must all run K11's wgmma tiles;
  E  Llama-3.1-8B's widths (hidden 4096, 32 / 8 heads of 128, ffn 14336,
     vocab 128256, untied) as llama.cpp's Q8_0 conversion writes it, 8 of
     32 layers (E_LAYERS), loaded under NFAI_Q8V3=1 and run with K4's
     "headmajor" layout: 33 K12 a decode step (wqkv, wo, gate_up, down on
     each layer, the head) and no K1/K5/K6/K11, K4-hm once a layer a
     prefill chunk and no K4 "full"; its server path ("merged") K7 at
     decode and K4's merged variant on the gathered pages;
  E8  model E's GGUF on a second engine with EngineConfig(kv_dtype="int8"),
     "headmajor": K4-hm's int8 entry point at prefill, K2-i8, the int8 store;
  Q  qwen2 at Qwen2.5-1.5B's widths (hidden 1536, 8 of 28 layers (Q_LAYERS), 12 / 2 heads
     of 128: r = 6, ffn 8960, vocab 151936, tied, q/k/v biases), llama.cpp's
     Q4_K_M mix: K1, K6 (the tied Q6_K head, the Q6_K attn_v /
     ffn_down layers), K2/K4 at r = 6, q/k/v split on every layer with
     their biases as plain adds (its profile runs again without them: what
     they add a step); no K5 (down mixes kinds); Q8 the same GGUF on an int8
     cache (K2-i8 / K4-i8 at r = 6);
  P  phi3 at Phi-3-mini-4k's widths (hidden 3072, 32 / 32 heads of 96, ffn
     8192, vocab 32064, untied), 8 of 32 layers (P_LAYERS), the Q4_K_M mix:
     its pre-fused attn_qkv in Q5_K on K6, the [gate; up] ffn_up on K1,
     K2/K4/K7 and the store at head_dim 96, the dense head (N = 32064 is
     not a multiple of 128) on torch.matmul;
  M  mistral at Mistral-7B-v0.3's widths (hidden 4096, 32 / 8 heads of 128,
     ffn 14336, vocab 32768, NORM rope, untied), 8 of 32 layers (M_LAYERS),
     plain Q4_K: K5 once a layer at a 7B width, K1 for wqkv, wo and the head;
  A8  model A's GGUF on a second engine with EngineConfig(kv_dtype="int8"),
     loaded after A's phases and freed before B: int8 codes with f32
     scales; per decode step K2-i8 once per layer, the int8 store once,
     no host sync; prefill through K4-i8; no bf16 attention kernel;
  server  model A through the paged pool: K7 and the paged store for every
     decode layer, the paged store and K4 on the gathered pages for
     prefill, no K2 and no dense store; C server the same for C; A8 server
     through the int8 pool: K7-i8, the int8 paged store, K4 (bf16) on the
     gathered pages dequantized, no K2/K4-i8 of either kind.
Every dense path stores its K/V with one store launch a decode step and one
a layer a prefill chunk, every paged path one a layer; K3 and K10 in their
own contracts launch on no path.
The kernels' launch counts are zeroed just before each path and read just
after; every kernel of that path must have launched, the kernels off its
route must not, the per-step counts must match the route, and model G's
attention launches must include the softcapped local and global variants.
The line before the last is {"kernels": [...]} (launches summed over the
paths, the attention kernels' also by variant),
the last {"ok": true, "device": {...}}; a run of a subset of the phases,
kernels (--kernels) or models (--models) ends with "ok": false, since the
main paths' launch checks did not run in full. Kernel errors are taken per
output row (per batch row for decode attention, per query token for
prefill attention, per input row for the matmuls and the MLP, per routed
row for the grouped matmuls), so a row whose output is small is held to
the same tolerance as the largest one.
Needs the repo checkout (nfai_tpu_torch) and a CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_S = 989e12  # H100 SXM dense bf16 tensor-core rate
GGUF_Q4K_BYTES_PER_WEIGHT = 144 / 256  # Q4_K's own encoding (the port's container holds 0.75)
TOL = 2e-2  # max|got - want| / max|want|, the JAX package's kernel-parity rule
# whole models on an int8 KV cache compared across two routes or devices that
# quantize or dequantize differently: the JAX package's int8 rule (int8 vs
# bf16 cache logits within 5e-2 of the logit scale, tests/test_kv_int8.py)
INT8_TOL = 5e-2

PHASES = ("build", "kernels", "serve", "batch", "profile", "server", "parity", "options", "eval",
          "constrained", "spec", "tools", "parallel")
# main-path model -> make_llama_1b_gguf kind ("qwen3moe": make_qwen3moe_gguf)
MODELS = {"A": "q4_k", "B": "q4_k_m", "C": "qwen3moe", "G": "gemma2_2b", "D": "f16",
          "E": "llama_8b_q8_0", "Q": "qwen2", "P": "phi3", "M": "mistral"}
C_LAYERS = 8  # model C's depth: 8 of Qwen3-30B-A3B's 48 layers, every width kept
E_LAYERS = 8  # model E's depth: 8 of Llama-3.1-8B's 32 layers, every width kept
B_LAYERS = 8  # model B's depth, cut for the run's time: it repeats A's widths (16 layers)
G_LAYERS = 8  # model G's depth, cut for the run's time: 8 of Gemma-2-2B's 26 layers, every width kept
Q_LAYERS = 8  # model Q's depth, cut for the run's time: 8 of Qwen2.5-1.5B's 28 layers, every width kept
D_LAYERS = 8  # model D's depth, cut for the run's time: 8 of Llama-3.2-1B's 16 layers (A keeps 16)
P_LAYERS = 8  # model P's depth: 8 of Phi-3-mini's 32 layers, every width kept
M_LAYERS = 8  # model M's depth: 8 of Mistral-7B-v0.3's 32 layers, every width kept
# the families' builders (nfai_tpu_torch.testing) and depths, by MODELS kind
FAMILY_BUILDERS = {"qwen2": ("make_qwen2_1_5b_gguf", Q_LAYERS), "phi3": ("make_phi3_mini_gguf", P_LAYERS),
                   "mistral": ("make_mistral_7b_gguf", M_LAYERS)}
FAMILY_MODELS = {m: kind for m, kind in MODELS.items() if kind in FAMILY_BUILDERS}  # Q, P, M
# model E runs under the JAX package's two opt-ins: NFAI_Q8V3=1 around its load,
# and K4's layout per path ("headmajor" for its engine, "merged" for its server)
E_LAYOUTS = {"E": "headmajor", "E8": "headmajor", "E server": "merged"}
GEMMA3_PROMPT = 700  # the Gemma-3-1B copy's prompt: past its 512-token window
# (the Q8_0 kind at A's widths is the tools phase's requantized copy, `_serve_requantized`)
# the tied Q4_0 and BF16 copies left for the run's time (they repeat A's widths): A keeps K1
# at them, the Gemma-3-1B copy Q4_0 on K1 and the F16 copy K11; the tied
# Q4_0 table stays in tests/test_torch_kinds.py and the card's tests/test_torch_cuda.py
PARITY_KINDS = ("q4_k", "q4_k_m", "f16", "llama_3b")
# parity copies that also run their steps through the page pool (the families' too)
PAGED_PARITY_KINDS = ("q4_k", "f16", "qwen2", "phi3", "mistral")
DENSE_KINDS = ("f16", "bf16")  # every matmul weight dense: K11, no K1/K5/K6
# parity copies that run again with every weight dequantized at load
PARITY_PARAM_DTYPE = {"q4_k_m": "bfloat16"}
NEAR_TIE = 0.01  # router-logit gap below which card and CPU may pick different experts
# the profile's device ms a step of K1, K6, K11, K12, K4 and K5, tallied by their CUDA functions' names
KERNEL_FUNCTIONS = {"q4_matmul": ("q4_gemv", "q4_wgmma"), "q8_matmul": ("q8_gemv", "q8_wgmma"),
                    "q8v3_matmul": ("q8v3_gemv", "q8v3_wgmma"),
                    # K11: both GEMVs, the wgmma tiles, the WMMA tiles of unaligned shapes
                    "dense_matmul": ("dense_gemv", "dense_wgmma", "dense_mma"),
                    # K4, every instance (prefill_attn_wgmma<D, groups, cache element, EXT>)
                    "prefill_attention": ("prefill_attn",),
                    # K5: the decode kernel (M <= 16), the tiles above
                    "fused_mlp": ("fused_mlp_decode", "fused_mlp_tiles"),
                    # K8 (4-bit) and K9 (8-bit): the GEMV at tm = 8, the wgmma tiles above
                    "grouped_q4": ("grouped_gemv_kernel<true", "grouped_wgmma_kernel<true"),
                    "grouped_q8": ("grouped_gemv_kernel<false", "grouped_wgmma_kernel<false"),
                    # the K/V store, dense and paged, bf16 and int8 (and K3 / K10 in their contracts)
                    "kv_store": ("kv_store_kernel",)}
# device functions the profiles tally one by one (a kernel's paths)
PATH_FUNCTIONS = tuple(f for fs in KERNEL_FUNCTIONS.values() for f in fs)
# models whose profile phase also records one 8x128 prefill chunk: the
# launches of a chunk by device function, from the loaded engine. E and D:
# every projection of a layer (wqkv, wo, gate_up, down) runs the tiles at
# M = 1024, K4 (E's head-major instance, D's "full") once a layer; E's head
# is K12's GEMV (8 rows), D's tied F16 head torch.matmul. C: K8's tiles for
# gate, up and each 4-bit down, K9's for each Q6_K down (8192 rows, tm 128),
# K4 once a layer
PREFILL_PROFILED = {
    "E": lambda engine, n: {"q8v3_wgmma": 4 * n, "q8v3_gemv": 1, "prefill_attn": n},
    "D": lambda engine, n: {"dense_wgmma": 4 * n, "dense_gemv": 0, "prefill_attn": n},
    "C": lambda engine, n: {"grouped_wgmma_kernel<true": 2 * n + _q4_downs(engine),
                            "grouped_wgmma_kernel<false": n - _q4_downs(engine), "prefill_attn": n},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def errors(got, want, row_dims: int = 0) -> tuple[float, float]:
    """(max|got - want|, the worst over rows of max|got - want| / max|want|
    within a row). The leading `row_dims` axes index the rows; 0 takes the
    whole tensor as one row."""
    got, want = got.float().cpu().flatten(row_dims), want.float().cpu().flatten(row_dims)
    diff = (got - want).abs().amax(-1)
    rel = diff / want.abs().amax(-1).clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def check(name: str, got, want, tol: float = TOL, row_dims: int = 0) -> float:
    """Assert errors(...)[1] < tol; returns max|got - want|."""
    abs_err, rel = errors(got, want, row_dims)
    log(f"  {name}: max abs err {abs_err:.3e}, rel {rel:.3e} "
        f"({'worst of per-row' if row_dims else 'whole tensor'}, tol {tol:g})")
    if not rel < tol:
        raise AssertionError(f"{name}: rel err {rel:.3e} exceeds {tol:g}")
    return abs_err


def same_bits(name: str, got, fn) -> None:
    """Two more launches of fn() give got's bits (no atomics)."""
    if not all(fn().equal(got) for _ in range(2)):
        raise AssertionError(f"{name}: three launches on the same inputs differ")


class Timer:
    """Median CUDA-event time of one fn() launch over `iters` launches.

    Before each launch a 128 MB read evicts the 50 MB L2 (the decode path
    reads each weight once per step, so it meets a cold cache), then a GPU
    spin of ~0.5 ms keeps the device busy while the host enqueues the two
    events and fn(): the events bracket the kernels alone, not the host's
    Python and launch overhead."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush_buf.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase: build


def phase_build(torch, kernels_mod) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = kernels_mod.build_all(verbose=True)
    for name, out in logs.items():
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "warning")):
                log(f"  [{name}] {line.strip()}")
    log(f"  built {sorted(kernels_mod.KERNELS)} in {time.perf_counter() - t0:.1f}s")
    return {"smi": smi}


# ---------------------------------------------------------------------------
# phase: kernels


def _q4_weight(torch, n, k, gen):
    from nfai_tpu_torch.ops.qtensor import Q4Tensor

    qs = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device="cuda", generator=gen)
    sc = torch.rand(n, k // 32, device="cuda", generator=gen) * 2e-3 + 1e-4
    mn = torch.rand(n, k // 32, device="cuda", generator=gen) * 1.5e-2
    return Q4Tensor(qs, sc, mn, k, n)


def _q8_weight(torch, n, k, group, qmax, gen, with_mins=False):
    from nfai_tpu_torch.ops.qtensor import Q8Tensor

    qs = torch.randint(-qmax, qmax, (n, k), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(n, k // group, device="cuda", generator=gen) * 2e-3 / qmax * 16 + 1e-5
    mn = torch.rand(n, k // group, device="cuda", generator=gen) * 1e-2 if with_mins else None
    return Q8Tensor(qs, sc, mn, k, n, group)


def _kernels_k1(torch, timer, gen) -> dict:
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import dequant

    bf = torch.bfloat16
    results = {}
    # K1 at every (K, N) of the path (wk/wv: model B's split Q4_K layers),
    # decode rows 1 (the CUDA-core GEMV) and 8 (the tensor-core GEMV),
    # prefill rows 16, 24, 32 and 64 (batch-1 buckets: wgmma tiles 16, 32
    # and 64 wide, in the K split at N <= 5120 and the row split on the
    # head), 256 and 1024 (the batch prefill's 8x128 chunk; the head sees
    # one row per sequence); three launches with the same bits
    shapes = {"wqkv": (2048, 3072), "wo": (2048, 2048), "wk/wv": (2048, 512),
              "gate_up": (2048, 16384), "down": (8192, 2048), "lm_head": (2048, 128256),
              "C wq": (2048, 4096), "C wo": (4096, 2048),  # model C's head_dim-128 q and o
              "3B wqkv": (3072, 5120), "3B wo": (3072, 3072),  # the 3B's K = 3072 (K % 2048 != 0)
              "G wqkv": (2304, 4096),  # model G's K = 2304
              # models Q (K = 1536; split q/k/v), P (K = 3072, its fused gate_up) and M (K = 4096,
              # its Q4_K head of N = 32768): decode rows and the 8x128 chunk's (a head: 256)
              "Q wq": (1536, 1536), "Q wk/wv": (1536, 256), "Q gate_up": (1536, 17920),
              "Q down": (8960, 1536), "P wo": (3072, 3072), "P gate_up": (3072, 16384),
              "M wqkv": (4096, 6144), "M lm_head": (4096, 32768),
              # a tp = 2 rank's shards (the parallel phase): model A's local [q|k|v], its
              # row-split wo (K = 1024) and vocab-split head; the Q copy's Q4_K parts
              "tp2 A wqkv": (2048, 1536), "tp2 A wo": (1024, 2048), "tp2 A lm_head": (2048, 64128),
              "tp2 Q wq": (1536, 768), "tp2 Q wk/wv": (1536, 128), "tp2 Q gate/up": (1536, 4480),
              "tp2 Q down": (4480, 1536)}
    cases = []
    for label, (k, n) in shapes.items():
        w = _q4_weight(torch, n, k, gen)
        wd = dequant(w).to(bf)
        verify = (9, 72) if label in ("wqkv", "wo", "lm_head") else ()  # a verify forward's B x 9 rows
        dp_rank = (4,) if label in ("wqkv", "wo", "lm_head") else ()  # a dp = 2 rank's 4 of 8 lanes
        rows = (1, 8, 16, 24, 32, 64, 256) + verify + dp_rank + (() if label == "lm_head" else (1024,))
        if label[:2] in ("Q ", "P ", "M "):
            rows = (1, 8, 256) if label.endswith("head") else (1, 8, 1024)
        if label.startswith("tp2 "):  # batch-1 and batch-8 decode
            rows = (1, 8)
        for m in rows:
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = qm.q4_matmul(x, w)
            torch.cuda.synchronize()
            err = check(f"K1 {label} M={m} K={k} N={n}", got, qm.matmul_plain(x, w), row_dims=1)
            if not all(torch.equal(qm.q4_matmul(x, w), got) for _ in range(2)):
                raise AssertionError(f"K1 {label} M={m}: two launches on the same inputs differ")
            ms = timer(lambda: qm.q4_matmul(x, w))
            plain_ms = timer(lambda: qm.matmul_plain(x, w), iters=3)
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            nbytes = m * k * 2 + n * k // 2 + n * k // 32 * 8 + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * n * k)
            # the same work with the weight at GGUF Q4_K's own 0.5625 B/weight
            b_gguf, _ = bound_ms(m * k * 2 + n * k * GGUF_Q4K_BYTES_PER_WEIGHT + m * n * 2, 2.0 * m * n * k)
            cases.append(dict(shape=f"{label} M={m}", max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=b, bound_by=by,
                              bound_gguf_ms=b_gguf, library_ms=lib_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by} with the 0.75 B/weight container, "
                f"{b_gguf:.4f} at Q4_K's 0.5625 B/weight; plain {plain_ms:.3f}, "
                f"cuBLAS on dequantized bf16 {lib_ms:.4f})")
        del w, wd
    results["q4_matmul"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/q4_matmul.cu",
        replaces="nfai_tpu/ops/qmatmul.py:415",
        also_replaces=["nfai_tpu/ops/qmatmul.py:735", "nfai_tpu/ops/qmatmul.py:282"],
        headline=next(c for c in cases if c["shape"] == "lm_head M=8"), cases=cases,
    )
    return results


def phase_kernels(torch, timer, subset=None) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    if subset is not None:  # only these kernels' phases (a quick check)
        return {k: v for name in subset for k, v in KERNEL_PHASES[name](torch, timer, gen).items()}
    results = _kernels_k1(torch, timer, gen)
    results.update(_kernels_k2(torch, timer, gen))
    results.update(_kernels_k3(torch, timer, gen))
    results.update(_kernels_k5(torch, timer, gen))
    results.update(_kernels_k6(torch, timer, gen))
    results.update(_kernels_k7(torch, timer, gen))
    results.update(_kernels_k8_k9(torch, timer, gen))
    results.update(_kernels_k11(torch, timer, gen))
    results.update(_kernels_k12(torch, timer, gen))
    results.update(_kernels_k4(torch, timer, gen))
    return results


# the decode shapes of K2 and K3: (layers, Hq, Hkv, D, B, S) of the 1B (L=16,
# Hq=32, Hkv=8, D=64), model C (L=8, Hq=32, Hkv=4, D=128, r = 8; K3's row is
# 512 wide in both) and the 3B (Hq=24, Hkv=8, D=128, r = 3; 2 layers of cache),
# and a dp = 2 rank's 4 of the 1B's 8 lanes
DECODE_SHAPES = ((16, 32, 8, 64, 1, 512), (16, 32, 8, 64, 8, 1024), (8, 32, 4, 128, 1, 512),
                 (8, 32, 4, 128, 8, 1024), (2, 24, 8, 128, 8, 1024), (16, 32, 8, 64, 4, 1024))


def _split_of(torch, b, hkv, capacity, d) -> int | None:
    """The blocks K2/K7 split a row's keys across at this grid (None before
    the split existed), for the log."""
    from nfai_tpu_torch.ops import fused_decode as fd

    split = getattr(fd, "decode_split", None)
    return None if split is None else split(b, hkv, capacity, fd.sm_count(torch.cuda.current_device()), d)


def _kernels_k2(torch, timer, gen) -> dict:
    """K2 (`--kernels k2`): bf16 at the decode shapes, then K2-i8 (with K2
    beside it at 4000 keys) and Gemma's head_dim-256 rows, bf16 and int8."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_decode as fd

    bf = torch.bfloat16
    cases2 = []
    for L, hq, hkv, d, b, s in DECODE_SHAPES:
        kvd = hkv * d
        kc = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen)
        kn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        vn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        start = s - 1
        # rows hold s-1 old tokens, except at B > 1 an empty row and one at s/3
        starts = torch.full((b,), start, dtype=torch.int32, device="cuda")
        if b > 1:
            starts[0] = 0
            starts[1] = s // 3
        layer = L // 3
        scale = d**-0.5
        got = fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts, scale)
        want = fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts, scale)
        torch.cuda.synchronize()
        err = check(f"K2 D={d} Hq={hq} Hkv={hkv} B={b} S={s} starts={starts.tolist()[:3]}... "
                    f"split {_split_of(torch, b, hkv, s, d)}", got, want, row_dims=1)
        same_bits(f"K2 D={d} B={b}", got, lambda: fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts,
                                                                             scale))
        # timing: every row holds start old tokens
        starts_t = torch.full((b,), start, dtype=torch.int32, device="cuda")
        ms = timer(lambda: fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts_t, scale))
        plain_ms = timer(lambda: fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts_t, scale))
        kd = torch.cat([kc[layer, :, :start], kn[:, None]], 1).view(b, start + 1, hkv, d).transpose(1, 2).contiguous()
        vd = torch.cat([vc[layer, :, :start], vn[:, None]], 1).view(b, start + 1, hkv, d).transpose(1, 2).contiguous()
        q4 = q[:, :, None]
        lib_ms = timer(lambda: nnf.scaled_dot_product_attention(q4, kd, vd, scale=scale, enable_gqa=True))
        nbytes = 2 * (2 * b * hq * d + 2 * b * kvd + 2 * b * start * kvd)
        bb, by = bound_ms(nbytes, 4.0 * b * hq * (start + 1) * d)
        cases2.append(dict(shape=f"D={d} Hkv={hkv} B={b} S={s} start={start}", max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, SDPA {lib_ms:.4f})")
        del kc, vc, kd, vd
    results = {"decode_attention": dict(
        route="cuda", source="nfai_tpu_torch/csrc/decode_attention.cu",
        replaces="nfai_tpu/ops/fused_decode.py:465", also_replaces=["nfai_tpu/ops/fused_decode.py:200"],
        headline=cases2[1], cases=cases2,
    )}
    results["decode_attention_i8"] = _k2_int8(torch, timer, gen, results)
    _gemma_k2(torch, timer, gen, results)
    return results


def _kernels_kv_write(torch, timer, gen) -> dict:
    """K3 at the decode shapes (and on int8 rows) and K10 at models A's and
    C's scale arrays, both exactly."""
    from nfai_tpu_torch.ops import fused_decode as fd

    bf = torch.bfloat16
    cases3 = []
    for L, hq, hkv, d, b, s in DECODE_SHAPES:
        kvd = hkv * d
        kc = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        starts = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
        if b > 1:
            starts[0] = 0
            starts[1] = s // 3
        starts_t = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
        rows = torch.randn(L, b, kvd, device="cuda", dtype=bf, generator=gen)
        starts_w = starts.clone()
        starts_w[-1] = s  # dropped
        ref = kc.clone()
        fd.write_all_layers_plain(ref, rows, starts_w)
        got = fd.write_all_layers(kc.clone(), rows, starts_w)
        torch.cuda.synchronize()
        err3 = check(f"K3 L={L} B={b} S={s} KVD={kvd}", got, ref, tol=1e-30)  # exact copy
        cache_t = kc.clone()
        ms = timer(lambda: fd.write_all_layers(cache_t, rows, starts_t))
        plain_ms = timer(lambda: fd.write_all_layers_plain(cache_t, rows, starts_t))
        bidx = torch.arange(b, device="cuda")
        sidx = starts_t.long()

        def index_put():  # one advanced-index assignment = index_put_
            cache_t[:, bidx, sidx] = rows

        lib_ms = timer(index_put)
        bb, by = bound_ms(2 * rows.numel() * 2, 0)
        cases3.append(dict(shape=f"L={L} B={b} S={s} KVD={kvd}", max_abs_err=err3, ms=ms,
                           plain_ms=plain_ms, bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}, plain {plain_ms:.4f}, index_put_ {lib_ms:.4f})")
        del kc, cache_t, ref
    results = {"kv_write": dict(
        route="cuda", source="nfai_tpu_torch/csrc/kv_write.cu",
        replaces="nfai_tpu/ops/fused_decode.py:601", also_replaces=[],
        headline=cases3[1], cases=cases3,
    )}
    results["kv_write_t"] = _k10(torch, timer, gen)
    return results


def _kernels_k5(torch, timer, gen) -> dict:
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_mlp as fm
    from nfai_tpu_torch.ops import qmatmul as qm

    bf = torch.bfloat16
    results = {}
    # K5 at the 1B MLP (K = H = 2048, F = 8192; the decode kernel's rows 1,
    # 2, 8 and 16, the tiles' 17, 32 and 64 (batch-1 buckets), 256 and 1024
    # (the 8x128 chunk)) and at the 3B's (K = H = 3072, rows 1, 8, 256)
    cases = []
    # (and 9, 72: a verify forward's B x 9 rows at batch 1 and 8)
    # (and model M's, K = H = 4096, F = 14336: Mistral-7B's MLP, rows 1, 8, 256, 1024)
    # (and a tp = 2 rank's half of A's MLP, F = 4096: rows 1 and 8; row 4: a dp = 2 rank's decode)
    for k, f, h, rows in ((2048, 8192, 2048, (1, 2, 8, 9, 16, 17, 32, 64, 72, 256, 1024, 4)),
                          (3072, 8192, 3072, (1, 8, 256)), (4096, 14336, 4096, (1, 8, 256, 1024)),
                          (2048, 4096, 2048, (1, 8))):
        gu, dn = _q4_weight(torch, 2 * f, k, gen), _q4_weight(torch, h, f, gen)

        def replaced_route(x):  # what K5 replaces: K1 gate_up, silu * up, K1 down
            g_u = qm.q4_matmul(x, gu)
            return qm.q4_matmul((nnf.silu(g_u[:, :f].float()) * g_u[:, f:].float()).to(bf), dn)

        for m in rows:
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = fm.fused_mlp(x, gu, dn)
            torch.cuda.synchronize()
            err = check(f"K5 M={m} K={k} F={f} H={h}", got, fm.fused_mlp_plain(x, gu, dn), row_dims=1)
            # the F-tile partials are summed in a fixed order: the same bits every launch
            if not all(torch.equal(fm.fused_mlp(x, gu, dn), got) for _ in range(2)):
                raise AssertionError(f"K5 M={m}: two launches on the same inputs differ")
            log(f"  K5 M={m}: three launches on the same inputs give the same bits")
            ms = timer(lambda: fm.fused_mlp(x, gu, dn))
            plain_ms = timer(lambda: fm.fused_mlp_plain(x, gu, dn), iters=3)
            route_ms = timer(lambda: replaced_route(x))
            nbytes = m * k * 2 + (2 * f * k + h * f) * 3 // 4 + m * h * 2
            b, by = bound_ms(nbytes, 2.0 * m * k * 2 * f + 2.0 * m * f * h)
            cases.append(dict(shape=f"M={m}" + ("" if (k, f) == (2048, 8192) else f" H={h} F={f}"), max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                              replaced_route_ms=route_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
                f"replaced route K1 + silu*mul + K1 {route_ms:.4f}; no single library call)")
        del gu, dn
    results["fused_mlp"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/fused_mlp.cu",
        replaces="nfai_tpu/ops/fused_mlp.py:201", also_replaces=[],
        headline=cases[2], cases=cases,
    )
    return results


def _kernels_k6(torch, timer, gen) -> dict:
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import dequant

    bf = torch.bfloat16
    results = {}
    # K6 at every (K, N) of the path: the tied Q6_K heads of models B (and
    # the 1B copies), C and G, Q8_0 wqkv and down, model B's Q6_K wv and
    # w_down, model G's Q6_K ffn_down (K = 9216), and a g32 layer with mins
    # (Q5_K); decode rows 1 (the CUDA-core GEMV), 2 and 8 (the tensor-core
    # GEMV), prefill rows 16, 24, 32 and 64 (batch-1 buckets: wgmma tiles 16,
    # 32 and 64 wide) and 256 and, below the heads, 1024 (the batch prefill's
    # 8x128 chunk; a head sees one row per sequence, G's at most 8 here);
    # three launches with the same bits
    shapes = {"Q6_K head": (2048, 128256, 16, 32, False), "C Q6_K head": (2048, 151936, 16, 32, False),
              "G Q6_K head": (2304, 256000, 16, 32, False), "Q8_0 wqkv": (2048, 3072, 32, 127, False),
              "Q8_0 down": (8192, 2048, 32, 127, False), "Q6_K wv": (2048, 512, 16, 32, False),
              "Q6_K w_down": (8192, 2048, 16, 32, False),
              "G Q6_K ffn_down": (9216, 2304, 16, 32, False),
              "Q5_K wqkv (mins)": (2048, 3072, 32, 127, True),
              # model Q's tied Q6_K head (N = 151936) and ffn_down (K = 8960); model P's
              # Q5_K attn_qkv (g32 with mins, 9216 x 3072) and Q6_K ffn_down; a Q6_K
              # head at P's N = 32064, not a multiple of 128 (P's own head is dense by
              # the JAX `quantizable` rule: this row checks the tiles' ragged N edge)
              "Q Q6_K head": (1536, 151936, 16, 32, False), "Q Q6_K ffn_down": (8960, 1536, 16, 32, False),
              "P Q5_K attn_qkv (mins)": (3072, 9216, 32, 127, True),
              "P Q6_K ffn_down": (8192, 3072, 16, 32, False),
              "N=32064 Q6_K head": (3072, 32064, 16, 32, False),
              # a tp = 2 rank's shards of the Q copy: the vocab-split tied head (N = 75968,
              # not a multiple of 128), its row-split ffn_down (K = 4480), a kv-head's wv
              "tp2 Q Q6_K head": (1536, 75968, 16, 32, False), "tp2 Q Q6_K ffn_down": (4480, 1536, 16, 32, False),
              "tp2 Q Q6_K wv": (1536, 128, 16, 32, False),
              # a tp = 2 rank's shards of model E under NFAI_Q8V3=1 (the JAX loader marks every
              # split 8-bit weight at these widths, so they keep K6's container): its local
              # [q|k|v], the row-split wo (K = 2048) and down (K = 7168), its half of gate_up,
              # the vocab-split head
              "tp2 E Q8_0 wqkv": (4096, 3072, 32, 127, False), "tp2 E Q8_0 wo": (2048, 4096, 32, 127, False),
              "tp2 E Q8_0 gate_up": (4096, 14336, 32, 127, False),
              "tp2 E Q8_0 down": (7168, 4096, 32, 127, False), "tp2 E Q8_0 head": (4096, 64128, 32, 127, False)}
    cases = []
    for label, (k, n, group, qmax, with_mins) in shapes.items():
        w = _q8_weight(torch, n, k, group, qmax, gen, with_mins=with_mins)
        wd = dequant(w).to(bf)
        rows = ((1, 8) if label.startswith("G") and label.endswith("head")
                else (1, 8, 256) if label[:2] in ("Q ", "P ", "N=")
                else (1, 2, 8, 16, 24, 32, 64, 256) if label.endswith("head")
                else (1, 2, 8, 16, 24, 32, 64, 256, 1024))
        if label.startswith("P ") and not label.endswith("head"):
            rows += (1024,)
        if label.startswith("tp2 "):  # batch-1 and batch-8 decode
            rows = (1, 8)
        if label in ("Q6_K head", "Q8_0 wqkv"):
            rows += (9, 72)  # a verify forward's B x 9 rows
        for m in rows:
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = qm.q8_matmul(x, w)
            torch.cuda.synchronize()
            err = check(f"K6 {label} M={m} K={k} N={n} g{group}", got, qm.matmul_plain(x, w),
                        row_dims=1)
            if not all(torch.equal(qm.q8_matmul(x, w), got) for _ in range(2)):
                raise AssertionError(f"K6 {label} M={m}: two launches on the same inputs differ")
            ms = timer(lambda: qm.q8_matmul(x, w))
            plain_ms = timer(lambda: qm.matmul_plain(x, w), iters=3)
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            nbytes = m * k * 2 + n * k + n * (k // group) * 4 * (2 if with_mins else 1) + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * n * k)
            cases.append(dict(shape=f"{label} M={m}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b, bound_by=by, library_ms=lib_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
                f"cuBLAS on dequantized bf16 {lib_ms:.4f})")
        del w, wd
    results["q8_matmul"] = dict(
        route="cuda", source="nfai_tpu_torch/csrc/q8_matmul.cu",
        replaces="nfai_tpu/ops/qmatmul.py:190", also_replaces=["nfai_tpu/ops/qmatmul.py:541"],
        headline=next(c for c in cases if c["shape"] == "Q6_K head M=8"), cases=cases,
    )
    return results


def _shuffled_tables(torch, b, n_p, n_pages, seed, device="cuda"):
    """[b, n_p] int32 block tables: distinct page ids drawn without order
    from 1 .. n_pages - 1 (page 0 is the sink), never contiguous runs."""
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))[: b * n_p] + 1
    return perm.view(b, n_p).to(torch.int32).to(device)


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _kernels_k7(torch, timer, gen) -> dict:
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import fused_decode as fd
    from nfai_tpu_torch.ops import paged_attention as pa

    bf = torch.bfloat16
    ragged = [1, 127, 128, 129, 500, 777, 1000, 1024]
    # (label, Hq, Hkv, D, B, page size, lengths); every case is checked per
    # batch row; the 1B's heads (Hkv=8, D=64), model C's (Hkv=4, D=128), the
    # 3B's (Hq=24, r = 3)
    cases_in = (("B=8 ps=128 S=1024", 32, 8, 64, 8, 128, [1024] * 8),
                ("B=8 ps=128 ragged", 32, 8, 64, 8, 128, ragged),
                ("B=1 ps=128 len=512", 32, 8, 64, 1, 128, [512]),
                ("B=8 ps=16 S=1024", 32, 8, 64, 8, 16, [1024] * 8),
                ("B=8 ps=16 ragged", 32, 8, 64, 8, 16, [1, 15, 16, 17, 500, 777, 1000, 1024]),
                ("D=128 Hkv=4 B=8 ps=128 S=1024", 32, 4, 128, 8, 128, [1024] * 8),
                ("D=128 Hkv=4 B=8 ps=128 ragged", 32, 4, 128, 8, 128, ragged),
                ("D=128 Hkv=4 B=1 ps=128 len=512", 32, 4, 128, 1, 128, [512]),
                ("D=128 Hq=24 Hkv=8 B=8 ps=128 ragged", 24, 8, 128, 8, 128, ragged))
    cases = []
    for label, hq, hkv, d, b, ps, lens in cases_in:
        scale = d**-0.5
        n_p = -(-max(lens) // ps)
        n_pages = b * n_p + 16  # >= 80 pages at ps = 128
        kp = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        vp = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        tables = _shuffled_tables(torch, b, n_p, n_pages, seed=len(cases))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen)
        got = pa.paged_decode_attention(q, kp, vp, tables, lengths, scale)
        torch.cuda.synchronize()
        err = check(f"K7 {label} lengths={lens} split {_split_of(torch, b, hkv, n_p * ps, d)}", got,
                    pa.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale), row_dims=1)
        same_bits(f"K7 {label}", got, lambda: pa.paged_decode_attention(q, kp, vp, tables, lengths, scale))
        ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, tables, lengths, scale))
        plain_ms = timer(lambda: pa.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale), iters=3)
        s = n_p * ps
        tl = tables.long()
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]

        def gather_sdpa():  # the yardstick: one page gather, then SDPA over the dense view
            kg = kp[:, tl].view(hkv, b, s, d).transpose(0, 1)
            vg = vp[:, tl].view(hkv, b, s, d).transpose(0, 1)
            return nnf.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask,
                                                    scale=scale, enable_gqa=True)

        lib_ms = timer(gather_sdpa)
        keys = sum(lens)
        nbytes = 2 * (2 * b * hq * d) + 4 * (tables.numel() + b) + 2 * (2 * keys * hkv * d)
        bb, by = bound_ms(nbytes, 4.0 * hq * d * keys)
        # K2 at the same dense shape: lengths[b] - 1 cached tokens plus the folded-in new one
        kc = torch.randn(b, max(lens), hkv * d, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(b, max(lens), hkv * d, device="cuda", dtype=bf, generator=gen)
        kn = torch.randn(b, hkv * d, device="cuda", dtype=bf, generator=gen)
        starts = (lengths - 1).contiguous()
        k2_ms = timer(lambda: fd.decode_attention(q, kn, kn, kc, vc, starts, scale))
        cases.append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb,
                          bound_by=by, library_ms=lib_ms, library="page gather + SDPA",
                          k2_same_shape_ms=k2_ms))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, "
            f"page gather + SDPA {lib_ms:.4f}, K2 at the same dense shape {k2_ms:.4f})")
        del kp, vp, kc, vc
    results = {"paged_attention": dict(
        route="cuda", source="nfai_tpu_torch/csrc/paged_attention.cu",
        replaces="nfai_tpu/ops/paged_attention.py:113", also_replaces=[],
        headline=cases[0], cases=cases,
    )}
    results["paged_attention_i8"] = _k7_int8(torch, timer, gen, results)
    _gemma_k7(torch, timer, gen, results)
    return results


def _kv_codes(torch, x, hkv):
    """bf16 K or V rows [..., S, Hkv*D] → (int8 codes [..., S, Hkv*D], f32
    time-minor scales [..., Hkv, S]) through the port's quantize_kv."""
    from nfai_tpu_torch.models.llama import quantize_kv

    q, sc = quantize_kv(x, hkv)
    return q, sc.transpose(-1, -2).contiguous()


def _pool_codes(torch, pages):
    """A bf16 page pool [Hkv, P, ps, D] → (int8 codes, f32 scales [Hkv, P,
    ps]): one scale per (kv head, token), as the int8 pool stores them."""
    from nfai_tpu_torch.models.llama import quantize_kv

    q, sc = quantize_kv(pages, 1)
    return q, sc[..., 0].contiguous()


def _k2_int8(torch, timer, gen, results) -> dict:
    """K2-i8 against its plain version on the same int8 codes and scales
    (made by quantize_kv from bf16 draws) at K2's cases and at B = 8 with
    4000 keys in a 4096-slot cache, where K2 also runs on the bf16 cache
    for the comparison (appended to results["decode_attention"]).
    Yardstick: the cache dequantized to bf16, then SDPA."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.models.llama import dequant_kv
    from nfai_tpu_torch.ops import fused_decode as fd

    bf = torch.bfloat16

    # K2-i8 (and K2 bf16 at the 4096-slot case)
    cases = []
    for L, hq, hkv, d, b, s, start in ((16, 32, 8, 64, 1, 512, 511), (16, 32, 8, 64, 8, 1024, 1023),
                                       (8, 32, 4, 128, 1, 512, 511), (8, 32, 4, 128, 8, 1024, 1023),
                                       (2, 24, 8, 128, 8, 1024, 1023), (2, 32, 8, 64, 8, 4096, 4000)):
        kvd = hkv * d
        kf = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vf = torch.randn(L, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        (kc, ks), (vc, vs) = _kv_codes(torch, kf, hkv), _kv_codes(torch, vf, hkv)
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen)
        kn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        vn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        starts = torch.full((b,), start, dtype=torch.int32, device="cuda")
        if b > 1:
            starts[0] = 0
            starts[1] = s // 3
        layer, scale = L // 3, d**-0.5
        sc = dict(k_scales=ks, v_scales=vs)
        got = fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts, scale, **sc)
        want = fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts, scale, ks[layer], vs[layer])
        torch.cuda.synchronize()
        err = check(f"K2-i8 D={d} Hq={hq} Hkv={hkv} B={b} S={s} starts={starts.tolist()[:3]}...", got,
                    want, row_dims=1)
        starts_t = torch.full((b,), start, dtype=torch.int32, device="cuda")
        ms = timer(lambda: fd.layered_decode_attention(q, kn, vn, kc, vc, layer, starts_t, scale, **sc))
        plain_ms = timer(lambda: fd.decode_attention_plain(q, kn, vn, kc[layer], vc[layer], starts_t, scale,
                                                           ks[layer], vs[layer]), iters=3)

        def dequant_sdpa():  # the yardstick: the layer's old tokens dequantized, then SDPA
            kd = torch.cat([dequant_kv(kc[layer, :, :start], ks[layer, :, :, :start], bf), kn[:, None]], 1)
            vd = torch.cat([dequant_kv(vc[layer, :, :start], vs[layer, :, :, :start], bf), vn[:, None]], 1)
            return nnf.scaled_dot_product_attention(
                q[:, :, None], kd.view(b, start + 1, hkv, d).transpose(1, 2),
                vd.view(b, start + 1, hkv, d).transpose(1, 2), scale=scale, enable_gqa=True)

        lib_ms = timer(dequant_sdpa)
        nbytes = 2 * (2 * b * hq * d + 2 * b * kvd) + 2 * b * start * kvd + 2 * 4 * b * hkv * start
        bb, by = bound_ms(nbytes, 4.0 * b * hq * (start + 1) * d)
        shape = f"D={d} Hkv={hkv} B={b} S={s} start={start}"
        cases.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb,
                          bound_by=by, library_ms=lib_ms, library="dequantize + SDPA"))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, dequantize + SDPA {lib_ms:.4f})")
        if s == 4096:  # K2 on the bf16 cache at the same shape
            got = fd.layered_decode_attention(q, kn, vn, kf, vf, layer, starts, scale)
            torch.cuda.synchronize()
            err = check(f"K2 {shape}", got, fd.decode_attention_plain(q, kn, vn, kf[layer], vf[layer], starts,
                                                                    scale), row_dims=1)
            ms = timer(lambda: fd.layered_decode_attention(q, kn, vn, kf, vf, layer, starts_t, scale))
            plain_ms = timer(lambda: fd.decode_attention_plain(q, kn, vn, kf[layer], vf[layer], starts_t,
                                                               scale), iters=3)
            kd = torch.cat([kf[layer, :, :start], kn[:, None]], 1).view(b, start + 1, hkv, d).transpose(1, 2)
            vd = torch.cat([vf[layer, :, :start], vn[:, None]], 1).view(b, start + 1, hkv, d).transpose(1, 2)
            lib_ms = timer(lambda: nnf.scaled_dot_product_attention(q[:, :, None], kd.contiguous(),
                                                                    vd.contiguous(), scale=scale,
                                                                    enable_gqa=True))
            bb, by = bound_ms(2 * (2 * b * hq * d + 2 * b * kvd + 2 * b * start * kvd),
                              4.0 * b * hq * (start + 1) * d)
            results["decode_attention"]["cases"].append(dict(
                shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by,
                library_ms=lib_ms))
            log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, SDPA {lib_ms:.4f})")
        del kf, vf, kc, vc
    return dict(
        route="cuda", source="nfai_tpu_torch/csrc/decode_attention.cu",
        replaces="nfai_tpu/ops/fused_decode.py:465", also_replaces=["nfai_tpu/ops/fused_decode.py:200"],
        headline=cases[1], cases=cases,
    )


def _k10(torch, timer, gen) -> dict:
    """K10 exactly at model A's (L 16, Hkv 8) and model C's (L 8, Hkv 4)
    scale arrays, and K3 on int8 code rows. Yardstick: index_put_."""
    from nfai_tpu_torch.ops import fused_decode as fd

    # K10 at model A's and model C's scale arrays; K3 on int8 code rows
    cases = []
    for L, b, hkv, s in ((16, 8, 8, 1024), (8, 8, 4, 1024)):
        arr = torch.rand(L, b, hkv, s, device="cuda", generator=gen)
        rows = torch.rand(L, b, hkv, device="cuda", generator=gen)
        starts = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
        starts[0], starts[1], starts[-1] = 0, s // 3, s  # the last row is dropped
        ref = fd.write_all_layers_t_plain(arr.clone(), rows, starts)
        got = fd.write_all_layers_t(arr.clone(), rows, starts)
        torch.cuda.synchronize()
        err = check(f"K10 L={L} B={b} Hkv={hkv} S={s}", got, ref, tol=1e-30)  # exact
        arr_t, starts_t = arr.clone(), torch.full((b,), 128, dtype=torch.int32, device="cuda")
        ms = timer(lambda: fd.write_all_layers_t(arr_t, rows, starts_t))
        plain_ms = timer(lambda: fd.write_all_layers_t_plain(arr_t, rows, starts_t))
        bidx, sidx, rows_b = torch.arange(b, device="cuda"), starts_t.long(), rows.permute(1, 0, 2).contiguous()
        lib_ms = timer(lambda: arr_t.permute(1, 3, 0, 2).index_put_((bidx, sidx), rows_b))
        bb, by = bound_ms(2 * rows.numel() * 4, 0)
        cases.append(dict(shape=f"L={L} B={b} Hkv={hkv} S={s}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bb, bound_by=by, library_ms=lib_ms))
        log(f"    {ms:.4f} ms (bound {bb:.6f} by {by}, plain {plain_ms:.4f}, index_put_ {lib_ms:.4f})")
        if hkv == 8:
            codes = torch.randint(-127, 128, (L, b, s, 512), dtype=torch.int8, device="cuda", generator=gen)
            crow = torch.randint(-127, 128, (L, b, 512), dtype=torch.int8, device="cuda", generator=gen)
            check(f"K3 int8 rows L={L} B={b} S={s} KVD=512", fd.write_all_layers(codes.clone(), crow, starts),
                  fd.write_all_layers_plain(codes.clone(), crow, starts), tol=1e-30)
            del codes
    return dict(
        route="cuda", source="nfai_tpu_torch/csrc/kv_write.cu",
        replaces="nfai_tpu/ops/fused_decode.py:659", also_replaces=[],
        headline=cases[0], cases=cases,
    )


# the store's dense decode cases: (label, L, B, Hkv, D, S) of models A (and A8), C and G
STORE_STEP_CASES = (("A", 16, 8, 8, 64, 1024), ("C", 8, 8, 4, 128, 1024), ("G", 26, 8, 4, 256, 1024),
                    ("Q", 28, 8, 2, 128, 1024), ("P", 8, 8, 32, 96, 1024),
                    ("tp2 A", 16, 8, 4, 64, 1024))  # a tp = 2 rank's 4 of A's 8 kv-heads
# its dense prefill cases, one layer: (label, B, T, Hkv, D, S, offset); A's batch-1
# chunk at S - 128 keeps 128 of its 256 rows (the rest are dropped)
# (and a verify forward's 9 rows a lane at batch 8, its last lane frozen at S:
# all of its rows are dropped)
STORE_CHUNK_CASES = (("A 8x128", 8, 128, 8, 64, 1024, 0), ("A B=1 T=256 tail", 1, 256, 8, 64, 1024, 896),
                     ("C B=1 T=256", 1, 256, 4, 128, 1024, 256), ("G 8x128", 8, 128, 4, 256, 1024, 0),
                     ("A verify B=8 T=9", 8, 9, 8, 64, 1024, 500), ("P 8x128", 8, 128, 32, 96, 1024, 0),
                     ("P B=1 T=256 tail", 1, 256, 32, 96, 1024, 896))
# its paged cases, one layer: (label, B, T, Hkv, D, page size); a row of every
# case lands on a page outside the pool and is dropped
STORE_PAGED_CASES = (("A decode ps=128", 8, 1, 8, 64, 128), ("A decode ps=16", 8, 1, 8, 64, 16),
                     ("A chunk B=1 T=256", 1, 256, 8, 64, 128), ("C decode", 8, 1, 4, 128, 128),
                     ("G decode", 8, 1, 4, 256, 128), ("A verify B=8 T=9 ps=16", 8, 9, 8, 64, 16),
                     ("P decode", 8, 1, 32, 96, 128), ("P chunk B=1 T=256", 1, 256, 32, 96, 128),
                     ("Q decode ps=16", 8, 1, 2, 128, 16),
                     ("tp2 A decode ps=128", 8, 1, 4, 64, 128))  # a tp = 2 rank's kv-heads


def _equal(name, got, want) -> float:
    """Bit-for-bit equality of a card tensor with the CPU's; returns max|got - want| (0)."""
    import torch

    got = got.cpu()
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(want.dtype)
    same = got.dtype == want.dtype and (got.view(bits).equal(want.view(bits)) if bits else got.equal(want))
    if not same:
        diff = (got.float() - want.float()).abs()
        raise AssertionError(f"{name}: {int((got != want).sum())} elements differ from the CPU's "
                             f"plain version, max {float(diff.max()):.3e}")
    return 0.0


def _kernels_k3(torch, timer, gen) -> dict:
    """K3 and K10 in their own contracts (`_kernels_kv_write`, `_k10`), then
    the K/V store that replaces them on the main path: the dense decode
    store at A's, C's and G's caches, the dense prefill store and the paged
    store (decode and a prefill chunk, page sizes 128 and 16), bf16 and
    int8, each case with ragged positions and a dropped row, held bit for
    bit against its plain version run on the CPU copy of the same inputs,
    then timed beside the route it replaces (two K3; 2 quantize_kv + 2 K10 +
    2 K3; the old index_put_ writes; the paged scatters)."""
    results = _kernels_kv_write(torch, timer, gen)
    results.update(_kv_store_cases(torch, timer, gen))
    return results


def _store_bytes(n_rows, kvd, hkv, quant, index_bytes) -> float:
    """Bytes the store must move: K and V rows read (bf16) and written (bf16,
    or int8 codes and an f32 scale a head), the indices read once."""
    out = n_rows * (kvd + 4 * hkv) if quant else n_rows * kvd * 2
    return 2 * (n_rows * kvd * 2 + out) + index_bytes


def _old_write_cache(cache_l, new, starts):
    """The dense prefill write the store replaced (one index_put_, no drop)."""
    import torch

    b, t, _ = new.shape
    rows = starts.long()[:, None] + torch.arange(t, device=new.device)[None]
    cache_l[torch.arange(b, device=new.device)[:, None], rows] = new.to(cache_l.dtype)


def _kv_store_cases(torch, timer, gen) -> dict:
    """The store's cases (see `_kernels_k3`); also how the card's own plain
    quantize_kv differs from the CPU's (a division by a Python scalar on CUDA
    is a product with its reciprocal)."""
    from nfai_tpu_torch.ops import fused_decode as fd
    from nfai_tpu_torch.ops import kv_store as ks
    from nfai_tpu_torch.runtime.paged_cache import flat_slots, scatter_rows

    bf, dev = torch.bfloat16, "cuda"
    cpu = lambda *ts: [None if t is None else t.cpu() for t in ts]  # noqa: E731
    step_cases, chunk_cases, paged_cases = [], [], []
    diffs = {}
    for label, L, b, hkv, d, s in STORE_STEP_CASES:
        kvd = hkv * d
        rows = [torch.randn(L, b, kvd, device=dev, dtype=bf, generator=gen) * 3 for _ in range(2)]
        starts = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
        starts[0], starts[1], starts[-1] = 0, s // 3, s  # the last row is dropped
        if label == "A":  # the card's plain quantize_kv against the CPU's, the same rows
            q_cuda, sc_cuda = ks.quantize_kv(rows[0], hkv)
            q_cpu, sc_cpu = ks.quantize_kv(rows[0].cpu(), hkv)
            diffs = dict(scales=int((sc_cuda.cpu() != sc_cpu).sum()), scale_count=sc_cpu.numel(),
                         codes=int((q_cuda.cpu() != q_cpu).sum()), code_count=q_cpu.numel(),
                         max_scale_ulps=float(((sc_cuda.cpu().view(torch.int32) - sc_cpu.view(torch.int32))
                                               .abs().max())))
            log(f"  quantize_kv on the card vs the CPU, A's {L}x{b} rows: {diffs['scales']} of "
                f"{diffs['scale_count']} scales differ (at most {diffs['max_scale_ulps']:.0f} ulp), "
                f"{diffs['codes']} of {diffs['code_count']} codes")
        for quant in (False, True):
            kc, vc = (torch.randint(-127, 128, (L, b, s, kvd), dtype=torch.int8, device=dev, generator=gen)
                      if quant else torch.randn(L, b, s, kvd, device=dev, dtype=bf, generator=gen)
                      for _ in range(2))
            kss, vss = ((torch.rand(L, b, hkv, s, device=dev, generator=gen) for _ in range(2)) if quant
                        else (None, None))
            want = cpu(kc, vc, kss, vss)
            ks.kv_store_plain(*want[:2], *cpu(*rows), starts.cpu(), hkv, *want[2:])
            got = [t.clone() if t is not None else None for t in (kc, vc, kss, vss)]
            ks.kv_store(*got[:2], *rows, starts, hkv, *got[2:])
            torch.cuda.synchronize()
            tag = f"store {'int8' if quant else 'bf16'} decode {label} L={L} B={b} Hkv={hkv} D={d} S={s}"
            err = max(_equal(f"{tag} {n}", g, w) for n, g, w in zip(("k", "v", "ks", "vs"), got, want)
                      if w is not None)
            log(f"  {tag}: codes/rows{' and scales' if quant else ''} equal the CPU's bit for bit")
            st = torch.full((b,), 128, dtype=torch.int32, device=dev)
            ms = timer(lambda: ks.kv_store(*got[:2], *rows, st, hkv, *got[2:]))
            plain_ms = timer(lambda: ks.kv_store_plain(*got[:2], *rows, st, hkv, *got[2:]), iters=3)

            def route():  # what the decode step ran before: quantize_kv, K10 and K3 twice each
                for cache, scales, r in ((got[0], got[2], rows[0]), (got[1], got[3], rows[1])):
                    if quant:
                        r, sc = ks.quantize_kv(r, hkv)
                        fd.write_all_layers_t(scales, sc, st)
                    fd.write_all_layers(cache, r, st)

            route_ms = timer(route)
            bb, by = bound_ms(_store_bytes(L * b, kvd, hkv, quant, b * 4), 0)
            step_cases.append(dict(shape=f"{'int8' if quant else 'bf16'} {label} decode L={L} B={b} "
                                         f"Hkv={hkv} D={d}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bb, bound_by=by, library_ms=None, replaced_route_ms=route_ms))
            log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}; the route it replaces {route_ms:.4f}; plain "
                f"{plain_ms:.3f})")
            del kc, vc, got, want
    for label, b, t, hkv, d, s, off in STORE_CHUNK_CASES:
        kvd = hkv * d
        # v as a column slice of a fused qkv output, as `_qkv` hands it over
        qkv = torch.randn(b, t, 3 * kvd, device=dev, dtype=bf, generator=gen) * 3
        k, v = qkv[..., :kvd].contiguous(), qkv[..., 2 * kvd:]
        starts = torch.full((b,), off, dtype=torch.int32, device=dev)
        if b > 1:
            starts[1], starts[-1] = 17, s - t // 2  # the last row's tail is dropped
        if label.startswith("A verify"):
            starts[-1] = s  # a frozen lane
        for quant in (False, True):
            kc, vc = (torch.zeros(b, s, kvd, dtype=torch.int8 if quant else bf, device=dev) for _ in range(2))
            kss, vss = ((torch.zeros(b, hkv, s, device=dev) for _ in range(2)) if quant else (None, None))
            want = cpu(kc, vc, kss, vss)
            ks.kv_store_plain(*want[:2], *cpu(k, v), starts.cpu(), hkv, *want[2:])
            got = [t_.clone() if t_ is not None else None for t_ in (kc, vc, kss, vss)]
            ks.kv_store(*got[:2], k, v, starts, hkv, *got[2:])
            torch.cuda.synchronize()
            tag = f"store {'int8' if quant else 'bf16'} chunk {label} Hkv={hkv} D={d} starts {starts.tolist()[:3]}"
            err = max(_equal(f"{tag} {n}", g, w) for n, g, w in zip(("k", "v", "ks", "vs"), got, want)
                      if w is not None)
            log(f"  {tag}: equal the CPU's bit for bit")
            st = torch.full((b,), min(off, s - t), dtype=torch.int32, device=dev)
            ms = timer(lambda: ks.kv_store(*got[:2], k, v, st, hkv, *got[2:]))
            plain_ms = timer(lambda: ks.kv_store_plain(*got[:2], k, v, st, hkv, *got[2:]), iters=3)

            def route():  # the prefill's writes before: quantize_kv, then index_put_ on scales and rows
                for cache, scales, r in ((got[0], got[2], k), (got[1], got[3], v)):
                    if quant:
                        r, sc = ks.quantize_kv(r, hkv)
                        _old_write_cache(scales.transpose(1, 2), sc, st)
                    _old_write_cache(cache, r, st)

            route_ms = timer(route)
            bb, by = bound_ms(_store_bytes(b * t, kvd, hkv, quant, b * 4), 0)
            chunk_cases.append(dict(shape=f"{'int8' if quant else 'bf16'} {label} chunk Hkv={hkv} D={d}",
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by,
                                    library_ms=None, replaced_route_ms=route_ms))
            log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}; the route it replaces {route_ms:.4f}; plain "
                f"{plain_ms:.3f})")
            del kc, vc, got, want
    for label, b, t, hkv, d, ps in STORE_PAGED_CASES:
        n_p = -(-max(t, 1024) // ps)  # pages a table: 1024 positions, or the chunk's
        n_pages = b * n_p + 9
        tables = _shuffled_tables(torch, b, n_p, n_pages, seed=ps + t)
        if t == 1:  # ragged lengths, the new token at the last of them
            lens = [1, ps - 1, ps, ps + 1, 500, 777, 1000, 1024][:b]
            positions = torch.tensor([[n - 1] for n in lens], dtype=torch.int32, device=dev)
        else:
            positions = (torch.arange(t, dtype=torch.int32, device=dev) + 3)[None].repeat(b, 1).contiguous()
        tables[-1, int(positions[-1, -1]) // ps] = n_pages  # a page outside the pool: that row is dropped
        rows = [torch.randn(b, t, hkv, d, device=dev, dtype=bf, generator=gen) * 3 for _ in range(2)]
        for quant in (False, True):
            kp, vp = (torch.randint(-127, 128, (hkv, n_pages, ps, d), dtype=torch.int8, device=dev, generator=gen)
                      if quant else torch.randn(hkv, n_pages, ps, d, device=dev, dtype=bf, generator=gen)
                      for _ in range(2))
            kss, vss = ((torch.rand(hkv, n_pages, ps, device=dev, generator=gen) for _ in range(2)) if quant
                        else (None, None))
            want = cpu(kp, vp, kss, vss)
            ks.kv_store_paged_plain(*want[:2], *cpu(*rows), tables.cpu(), positions.cpu(), *want[2:])
            got = [t_.clone() if t_ is not None else None for t_ in (kp, vp, kss, vss)]
            ks.kv_store_paged(*got[:2], *rows, tables, positions, *got[2:])
            torch.cuda.synchronize()
            tag = f"store {'int8' if quant else 'bf16'} paged {label} Hkv={hkv} D={d}"
            err = max(_equal(f"{tag} {n}", g, w) for n, g, w in zip(("k", "v", "ks", "vs"), got, want)
                      if w is not None)
            log(f"  {tag}: equal the CPU's bit for bit (one row on a page outside the pool)")
            tables_t = tables.clone()
            tables_t[-1, int(positions[-1, -1]) // ps] = 1
            ms = timer(lambda: ks.kv_store_paged(*got[:2], *rows, tables_t, positions, *got[2:]))
            plain_ms = timer(lambda: ks.kv_store_paged_plain(*got[:2], *rows, tables_t, positions, *got[2:]),
                             iters=3)
            flat = flat_slots(tables_t, positions, ps)  # once a forward on the route it replaces

            def route():  # a layer of the paged forward before: quantize_kv, then the scatters
                for pages, scales, r in ((got[0], got[2], rows[0]), (got[1], got[3], rows[1])):
                    if quant:
                        r, sc = ks.quantize_kv(r.reshape(b, t, hkv * d), hkv)
                        scatter_rows(scales[..., None], sc[..., None], flat)
                        r = r.view(b, t, hkv, d)
                    scatter_rows(pages, r, flat)

            route_ms = timer(route)
            bb, by = bound_ms(_store_bytes(b * t, hkv * d, hkv, quant, 2 * b * t * 4), 0)
            paged_cases.append(dict(shape=f"{'int8' if quant else 'bf16'} {label} Hkv={hkv} D={d}",
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by,
                                    library_ms=None, replaced_route_ms=route_ms))
            log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}; the route it replaces, flat_slots aside, "
                f"{route_ms:.4f}; plain {plain_ms:.3f})")
            del kp, vp, got, want
    return {
        "kv_store": dict(route="cuda", source="nfai_tpu_torch/csrc/kv_write.cu",
                         replaces="nfai_tpu/ops/fused_decode.py:601",
                         also_replaces=["nfai_tpu/ops/fused_decode.py:659"],
                         headline=step_cases[1], cases=step_cases + chunk_cases, cuda_plain_vs_cpu=diffs),
        "kv_store_paged": dict(route="cuda", source="nfai_tpu_torch/csrc/kv_write.cu",
                               replaces="nfai_tpu/ops/fused_decode.py:601",
                               also_replaces=["nfai_tpu/ops/fused_decode.py:659"],
                               headline=paged_cases[1], cases=paged_cases),
    }


def _k7_int8(torch, timer, gen, results) -> dict:
    """K7-i8 against its plain version on quantize_kv codes at K7's cases
    and at 4000 keys, where K7 also runs on the bf16 pool (appended to
    results["paged_attention"]). Yardstick: the gathered pages dequantized,
    then SDPA."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import paged_attention as pga

    bf = torch.bfloat16
    # K7-i8 at K7's cases, and at 4000 keys (with K7 on the bf16 pool beside it)
    ragged = [1, 127, 128, 129, 500, 777, 1000, 1024]
    cases = []
    for label, hq, hkv, d, b, ps, lens in (
            ("B=8 ps=128 S=1024", 32, 8, 64, 8, 128, [1024] * 8),
            ("B=8 ps=128 ragged", 32, 8, 64, 8, 128, ragged),
            ("B=1 ps=128 len=512", 32, 8, 64, 1, 128, [512]),
            ("B=8 ps=16 S=1024", 32, 8, 64, 8, 16, [1024] * 8),
            ("B=8 ps=16 ragged", 32, 8, 64, 8, 16, [1, 15, 16, 17, 500, 777, 1000, 1024]),
            ("D=128 Hkv=4 B=8 ps=128 S=1024", 32, 4, 128, 8, 128, [1024] * 8),
            ("D=128 Hkv=4 B=8 ps=128 ragged", 32, 4, 128, 8, 128, ragged),
            ("D=128 Hkv=4 B=1 ps=128 len=512", 32, 4, 128, 1, 128, [512]),
            ("D=128 Hq=24 Hkv=8 B=8 ps=128 ragged", 24, 8, 128, 8, 128, ragged),
            ("B=8 ps=128 4000 keys", 32, 8, 64, 8, 128, [4000] * 8)):
        scale = d**-0.5
        n_p = -(-max(lens) // ps)
        n_pages = b * n_p + 16
        kf = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        vf = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        (kp, ksp), (vp, vsp) = _pool_codes(torch, kf), _pool_codes(torch, vf)
        tables = _shuffled_tables(torch, b, n_p, n_pages, seed=100 + len(cases))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen)
        sc = dict(k_scales=ksp, v_scales=vsp)
        got = pga.paged_decode_attention(q, kp, vp, tables, lengths, scale, **sc)
        torch.cuda.synchronize()
        err = check(f"K7-i8 {label} lengths={lens}", got,
                    pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale, ksp, vsp), row_dims=1)
        ms = timer(lambda: pga.paged_decode_attention(q, kp, vp, tables, lengths, scale, **sc))
        plain_ms = timer(lambda: pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, scale, ksp, vsp),
                         iters=3)
        s = n_p * ps
        tl = tables.long()
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]

        def gather_dequant_sdpa():  # the pages gathered and dequantized, then SDPA
            kg = (kp[:, tl].float() * ksp[:, tl][..., None]).to(bf).view(hkv, b, s, d).transpose(0, 1)
            vg = (vp[:, tl].float() * vsp[:, tl][..., None]).to(bf).view(hkv, b, s, d).transpose(0, 1)
            return nnf.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask, scale=scale,
                                                    enable_gqa=True)

        lib_ms = timer(gather_dequant_sdpa)
        keys = sum(lens)
        nbytes = 2 * (2 * b * hq * d) + 4 * (tables.numel() + b) + 2 * keys * hkv * d + 2 * 4 * keys * hkv
        bb, by = bound_ms(nbytes, 4.0 * hq * d * keys)
        cases.append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by,
                          library_ms=lib_ms, library="page gather + dequantize + SDPA"))
        log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, "
            f"page gather + dequantize + SDPA {lib_ms:.4f})")
        if max(lens) == 4000:  # K7 on the bf16 pool at the same shape
            got = pga.paged_decode_attention(q, kf, vf, tables, lengths, scale)
            torch.cuda.synchronize()
            err = check(f"K7 {label}", got, pga.paged_decode_attention_plain(q, kf, vf, tables, lengths, scale),
                        row_dims=1)
            ms = timer(lambda: pga.paged_decode_attention(q, kf, vf, tables, lengths, scale))
            plain_ms = timer(lambda: pga.paged_decode_attention_plain(q, kf, vf, tables, lengths, scale), iters=3)

            def gather_sdpa():
                kg = kf[:, tl].view(hkv, b, s, d).transpose(0, 1)
                vg = vf[:, tl].view(hkv, b, s, d).transpose(0, 1)
                return nnf.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask, scale=scale,
                                                        enable_gqa=True)

            lib_ms = timer(gather_sdpa)
            bb, by = bound_ms(2 * (2 * b * hq * d) + 4 * (tables.numel() + b) + 2 * (2 * keys * hkv * d),
                              4.0 * hq * d * keys)
            results["paged_attention"]["cases"].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb, bound_by=by,
                library_ms=lib_ms, library="page gather + SDPA"))
            log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, page gather + SDPA {lib_ms:.4f})")
        del kf, vf, kp, vp
    return dict(
        route="cuda", source="nfai_tpu_torch/csrc/paged_attention.cu",
        replaces="nfai_tpu/ops/paged_attention.py:113", also_replaces=[],
        headline=cases[0], cases=cases,
    )


# Gemma head layouts at head_dim 256: (label, Hq, Hkv); model G is Gemma-2-2B
GEMMA_HEADS = {"G": (8, 4), "3-1B": (4, 1), "2B": (8, 1)}


def _record(timer, results, name, label, err, run, plain, lib, nbytes, flops, library):
    """Time a Gemma row (kernel, plain version, yardstick) and append it to
    results[name]'s cases."""
    ms = timer(run)
    plain_ms = timer(plain, iters=3)
    lib_ms = timer(lib)
    bb, by = bound_ms(nbytes, flops)
    results[name]["cases"].append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bb, bound_by=by, library_ms=lib_ms, library=library))
    log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, {library} {lib_ms:.4f})")


# K2 / K7 at the GQA ratios and head width of the families PR 21 added:
# (label, Hq, Hkv, D): Qwen2.5-1.5B's 12 / 2 (r = 6, model Q), Qwen2.5-7B's
# 28 / 4 (r = 7), Qwen3-14B's 40 / 8 (r = 5), Qwen3-235B-A22B's 64 / 4
# (r = 16: two groups of 8 head columns) at head_dim 128, and Phi-3-mini's
# 32 / 32 at head_dim 96 (model P)
# (and a tp = 2 rank's heads: Llama-3.2-1B's 16 / 4 of 64, the Q copy's 6 / 1 of 128)
FAMILY_HEADS = (("Qwen2.5-1.5B", 12, 2, 128), ("Qwen2.5-7B", 28, 4, 128), ("Qwen3-14B", 40, 8, 128),
                ("Qwen3-235B", 64, 4, 128), ("Phi-3-mini", 32, 32, 96),
                ("tp2 Llama-3.2-1B", 16, 4, 64), ("tp2 Qwen2.5-1.5B", 6, 1, 128))


def _gemma_k2(torch, timer, gen, results) -> None:
    """K2 (and, in `_gemma_k7`, K7) at head_dim 256 with Gemma's options,
    bf16 and int8 (the int8 entry points on quantize_kv codes), appended to
    those kernels' cases (K4's: `_kernels_k4`): model G's heads (Gemma-2-2B, r = 2) with
    softcap 50 and window 0 or 4096, Gemma-3-1B's (r = 4) with window 512
    and no softcap, Gemma 2B's (r = 8, multi-query) once without either;
    both also at batch 8 with 4000 keys in a 4096-slot cache, window 512
    beside window 0 (the skipped tiles). Queries are drawn at 8x
    scale under a softcap, so that the cap changes the scores. Each case is
    checked per row against the plain version (ragged starts), then timed
    with every row full; the bound counts the bytes and operations of the
    keys the window leaves visible. Yardstick: SDPA over the visible keys
    (int8: dequantized first; K7: the pages gathered first), without the
    softcap, which SDPA does not take. Then the families' rows
    (FAMILY_HEADS, batch 8, 1023 keys, no options)."""
    rows = [(f"D=256 {heads} heads", *GEMMA_HEADS[heads], 256, b, s, start, cap, win)
            for heads, b, s, start, cap, win in (
                ("G", 8, 1024, 1023, 50.0, 0), ("G", 8, 1024, 1023, 50.0, 4096),
                ("G", 8, 4096, 4000, 50.0, 0), ("G", 8, 4096, 4000, 50.0, 512),
                ("3-1B", 8, 1024, 1023, 0.0, 512), ("3-1B", 8, 4096, 4000, 0.0, 0),
                ("3-1B", 8, 4096, 4000, 0.0, 512), ("2B", 8, 1024, 1023, 0.0, 0))]
    rows += [(f"D={d} {name} heads", hq, hkv, d, 8, 1024, 1023, 0.0, 0) for name, hq, hkv, d in FAMILY_HEADS]
    _decode_rows(torch, timer, gen, results, rows)


def _decode_rows(torch, timer, gen, results, rows) -> None:
    """K2 and K2-i8 at `rows` ((label, Hq, Hkv, D, B, S, start, softcap,
    window)): checked per row against the plain version (ragged starts),
    the same bits on three launches, then timed with every row full."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.models.llama import dequant_kv
    from nfai_tpu_torch.ops import fused_decode as fd

    bf = torch.bfloat16
    for heads, hq, hkv, d, b, s, start, cap, win in rows:
        kvd = hkv * d
        kf = torch.randn(2, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vf = torch.randn(2, b, s, kvd, device="cuda", dtype=bf, generator=gen)
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen) * (8 if cap else 1)
        kn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        vn = torch.randn(b, kvd, device="cuda", dtype=bf, generator=gen)
        starts = torch.full((b,), start, dtype=torch.int32, device="cuda")
        starts[0], starts[1] = 0, s // 3
        starts_t = torch.full((b,), start, dtype=torch.int32, device="cuda")
        first = max(start - win + 1, 0) if win else 0  # the first visible old key
        vis = start - first
        for quant in (False, True):
            if quant:
                (kc, ks), (vc, vs) = _kv_codes(torch, kf, hkv), _kv_codes(torch, vf, hkv)
                sc, name = dict(k_scales=ks, v_scales=vs), "decode_attention_i8"
            else:
                kc, vc, ks, vs, sc, name = kf, vf, None, None, {}, "decode_attention"
            label = f"{heads} Hq={hq} Hkv={hkv} B={b} S={s} start={start} softcap={cap:g} window={win}"

            def run(st):
                return fd.layered_decode_attention(q, kn, vn, kc, vc, 1, st, d**-0.5, softcap=cap,
                                                   window=win, **sc)

            got = run(starts)
            torch.cuda.synchronize()
            lsc = (ks[1], vs[1]) if quant else (None, None)
            err = check(f"{'K2-i8' if quant else 'K2'} {label} split {_split_of(torch, b, hkv, s, d)}", got,
                        fd.decode_attention_plain(q, kn, vn, kc[1], vc[1], starts, d**-0.5, *lsc, cap, win),
                        row_dims=1)
            same_bits(f"{'K2-i8' if quant else 'K2'} {label}", got, lambda: run(starts))

            def lib():  # the visible keys (dequantized for int8) and the new one, SDPA
                if quant:
                    kd = dequant_kv(kc[1, :, first:start], ks[1, :, :, first:start], bf)
                    vd = dequant_kv(vc[1, :, first:start], vs[1, :, :, first:start], bf)
                else:
                    kd, vd = kc[1, :, first:start], vc[1, :, first:start]
                kd = torch.cat([kd, kn[:, None]], 1).view(b, vis + 1, hkv, d).transpose(1, 2)
                vd = torch.cat([vd, vn[:, None]], 1).view(b, vis + 1, hkv, d).transpose(1, 2)
                return nnf.scaled_dot_product_attention(q[:, :, None], kd, vd, scale=d**-0.5,
                                                        enable_gqa=True)

            elem = 1 if quant else 2
            nbytes = 2 * (2 * b * hq * d + 2 * b * kvd) + 2 * b * vis * kvd * elem + (
                2 * 4 * b * hkv * vis if quant else 0)
            _record(timer, results, name, label, err, lambda: run(starts_t),
                    lambda: fd.decode_attention_plain(q, kn, vn, kc[1], vc[1], starts_t, d**-0.5, *lsc,
                                                      cap, win),
                    lib, nbytes, 4.0 * b * hq * (vis + 1) * d,
                    "dequantize + SDPA" if quant else "SDPA")
            del kc, vc
        del kf, vf


def _gemma_k7(torch, timer, gen, results) -> None:
    """K7 and K7-i8 at head_dim 256 with Gemma's options (see `_gemma_k2`),
    through shuffled tables of 128-slot pages; then the families' rows
    (FAMILY_HEADS, batch 8, ragged lengths up to 1024)."""
    ragged = [1, 127, 128, 129, 500, 777, 1000, 1024]
    rows = [(f"D=256 {heads} heads", *GEMMA_HEADS[heads], 256, b, ps, lens, cap, win)
            for heads, b, ps, lens, cap, win in (
                ("G", 8, 128, [1024] * 8, 50.0, 0), ("G", 8, 128, ragged, 50.0, 4096),
                ("G", 8, 128, [4000] * 8, 50.0, 0), ("G", 8, 128, [4000] * 8, 50.0, 512),
                ("3-1B", 8, 128, ragged, 0.0, 512), ("3-1B", 8, 128, [4000] * 8, 0.0, 0),
                ("3-1B", 8, 128, [4000] * 8, 0.0, 512), ("2B", 8, 128, [1024] * 8, 0.0, 0))]
    rows += [(f"D={d} {name} heads", hq, hkv, d, 8, 128, ragged, 0.0, 0) for name, hq, hkv, d in FAMILY_HEADS]
    _paged_rows(torch, timer, gen, results, rows)


def _paged_rows(torch, timer, gen, results, rows) -> None:
    """K7 and K7-i8 at `rows` ((label, Hq, Hkv, D, B, page size, lengths,
    softcap, window)) through shuffled tables: checked per row against the
    plain version, the same bits on three launches, timed."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import paged_attention as pga

    bf = torch.bfloat16
    for heads, hq, hkv, d, b, ps, lens, cap, win in rows:
        n_p = -(-max(lens) // ps)
        n_pages = b * n_p + 16
        kf = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        vf = torch.randn(hkv, n_pages, ps, d, device="cuda", dtype=bf, generator=gen)
        tables = _shuffled_tables(torch, b, n_p, n_pages, seed=200 + len(results["paged_attention"]["cases"]))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(b, hq, d, device="cuda", dtype=bf, generator=gen) * (8 if cap else 1)
        s = n_p * ps
        tl = tables.long()
        pos = torch.arange(s, device="cuda")[None, :]
        lim = lengths[:, None].long()
        mask = ((pos < lim) & ((pos >= lim - win) if win else True))[:, None, None, :]
        keys = int(mask.sum())
        for quant in (False, True):
            if quant:
                (kp, ksp), (vp, vsp) = _pool_codes(torch, kf), _pool_codes(torch, vf)
                sc, name = dict(k_scales=ksp, v_scales=vsp), "paged_attention_i8"
            else:
                kp, vp, ksp, vsp, sc, name = kf, vf, None, None, {}, "paged_attention"
            label = f"{heads} Hq={hq} Hkv={hkv} B={b} ps={ps} lengths={lens[0]}..{lens[-1]} " \
                    f"softcap={cap:g} window={win}"
            run = lambda: pga.paged_decode_attention(q, kp, vp, tables, lengths, d**-0.5, softcap=cap, window=win, **sc)  # noqa: E731
            got = run()
            torch.cuda.synchronize()
            plain = lambda: pga.paged_decode_attention_plain(q, kp, vp, tables, lengths, d**-0.5, ksp, vsp,  # noqa: E731
                                                             cap, win)
            tag = f"{'K7-i8' if quant else 'K7'} {label}"
            err = check(f"{tag} split {_split_of(torch, b, hkv, s, d)}", got, plain(), row_dims=1)
            same_bits(tag, got, run)

            def lib():
                kg, vg = kp[:, tl], vp[:, tl]
                if quant:
                    kg = (kg.float() * ksp[:, tl][..., None]).to(bf)
                    vg = (vg.float() * vsp[:, tl][..., None]).to(bf)
                kg, vg = (x.reshape(hkv, b, s, d).transpose(0, 1) for x in (kg, vg))
                return nnf.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask, scale=d**-0.5,
                                                        enable_gqa=True)

            nbytes = 2 * (2 * b * hq * d) + 4 * (tables.numel() + b) + 2 * keys * hkv * d * (1 if quant else 2) + (
                2 * 4 * keys * hkv if quant else 0)
            _record(timer, results, name, label, err, run, plain, lib, nbytes, 4.0 * hq * d * keys,
                    "page gather + dequantize + SDPA" if quant else "page gather + SDPA")
            del kp, vp
        del kf, vf


def _routing_layout(torch, n_tokens, e, used, gen, ep=1):
    """A batch of n_tokens each routed to `used` distinct experts drawn at
    random (a random-weight router's routing), laid out group-aligned as
    moe_ffn lays it out: (x_pad rows, dst, block_group, block_rows, tm,
    distinct experts hit). With `ep` > 1 the layout rank 0 of an expert
    parallel group of `ep` builds over its E/ep experts (moe_ffn_ep: the
    other ranks' rows clipped to its last expert)."""
    from nfai_tpu_torch.models.llama import group_tm, moe_group_layout

    idx = torch.rand(n_tokens, e, device="cuda", generator=gen).argsort(-1)[:, :used]
    rows = n_tokens * used
    tm = group_tm(rows)
    el = e // ep
    local = idx.clamp(0, el - 1)
    _, dst, bg, br, m_pad = moe_group_layout(local.reshape(-1), rows, el, tm)
    return m_pad, dst, bg, br, tm, int(torch.unique(local).numel())


def _kernels_k8_k9(torch, timer, gen) -> dict:
    """K8 (4-bit) and K9 (8-bit) at model C's expert shapes (`--kernels k8`):
    gate/up [128, 768, 2048] and down [128, 2048, 768], at the decode layouts
    of a batch-1 and a batch-8 routing (8 and 64 rows, tm 8), a 256-token
    prefill chunk (2048 rows, tm 32) and the batch phase's 8 x 128-token
    prefill (8192 rows, tm 128); then a tp = 2 rank's stacks at the first
    three layouts: expert parallelism's [64, 768, 2048] / [64, 2048, 768]
    on its local layout, the ffn split's [128, 384, 2048] / [128, 2048, 384];
    per routed row against the plain version,
    with x's padding rows random (the kernels must write zeros there from
    block_rows alone), three launches with the same bits. Yardsticks: the
    hit experts of every block dequantized to bf16, then one torch.bmm over
    the blocks (library_ms); and K1's, torch.bmm over the non-empty blocks
    alone with their experts' bf16 weights gathered before the timer
    (bmm_dequantized_ms)."""
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import Q4Tensor, Q8Tensor, dequant

    bf = torch.bfloat16
    e, used, h, f = 128, 8, 2048, 768

    def stack(kind, n, k, group=32, with_mins=False, e=e):
        if kind == "q4":
            return Q4Tensor(
                torch.randint(0, 256, (e, n, k // 2), dtype=torch.uint8, device="cuda", generator=gen),
                torch.rand(e, n, k // 32, device="cuda", generator=gen) * 2e-3 + 1e-4,
                torch.rand(e, n, k // 32, device="cuda", generator=gen) * 1.5e-2, k, n)
        return Q8Tensor(
            torch.randint(-32, 32, (e, n, k), dtype=torch.int8, device="cuda", generator=gen),
            torch.rand(e, n, k // group, device="cuda", generator=gen) * 1e-3 + 1e-5,
            torch.rand(e, n, k // group, device="cuda", generator=gen) * 1e-2 if with_mins else None,
            k, n, group)

    weights = {"grouped_q4": {"gate/up": stack("q4", f, h), "down": stack("q4", h, f)},
               "grouped_q8": {"Q6_K down": stack("q8", h, f, group=16)}}
    layouts = {"batch 1": _routing_layout(torch, 1, e, used, gen),
               "batch 8": _routing_layout(torch, 8, e, used, gen),
               "prefill 256": _routing_layout(torch, 256, e, used, gen),
               "batch prefill 8x128": _routing_layout(torch, 8 * 128, e, used, gen)}
    # a tp = 2 rank's stacks (the parallel phase's C worlds): expert parallelism's
    # 64 whole experts, its layout over them (the other rank's rows clipped to the
    # last local expert, weighted 0); the ffn split's 128 experts of half the ffn
    # columns (gate/up N = 384, down K = 384), the whole layout
    rank_e = e // 2
    rank_cases = {"EP rank": ({"gate/up": stack("q4", f, h, e=rank_e), "down": stack("q4", h, f, e=rank_e),
                               "Q6_K down": stack("q8", h, f, group=16, e=rank_e)},
                              {n: _routing_layout(torch, t, e, used, gen, ep=2) for n, t in
                               (("batch 1", 1), ("batch 8", 8), ("prefill 256", 256))}),
                  "ffn-split rank": ({"gate/up": stack("q4", f // 2, h), "down": stack("q4", h, f // 2),
                                      "Q6_K down": stack("q8", h, f // 2, group=16)},
                                     {n: layouts[n] for n in ("batch 1", "batch 8", "prefill 256")})}
    results = {}
    for name, ws in weights.items():
        cases = []
        kname = "K8" if name == "grouped_q4" else "K9"
        work = [(label, w, layouts) for label, w in ws.items()]
        for rank, (rank_ws, rank_layouts) in rank_cases.items():
            work += [(f"{rank} {label}", w, rank_layouts) for label, w in rank_ws.items()
                     if (label == "Q6_K down") == (name == "grouped_q8")]
        for label, w, w_layouts in work:
            per_expert = sum(t[0].numel() * t.element_size()
                             for t in (w.qs, w.scales) + (() if w.mins is None else (w.mins,)))
            for lname, (m_pad, dst, bg, br, tm, hit) in w_layouts.items():
                rows = dst.numel()
                x = torch.randn(m_pad, w.k, device="cuda", dtype=bf, generator=gen)  # padding too
                got = qm.qmatmul_grouped(x, w, bg, tm, br)
                torch.cuda.synchronize()
                want = qm.qmatmul_grouped_plain(x, w, bg, tm, br)
                err = check(f"{kname} {label} {lname}: {rows} rows, m_pad {m_pad}, tm {tm}, {hit} "
                            f"experts hit", got[dst], want[dst], row_dims=1)
                if bool((got.float().abs().sum(-1) == 0).sum() != m_pad - rows):
                    raise AssertionError("padding rows must be zero and routed rows not")
                same_bits(f"{kname} {label} {lname}", got, lambda: qm.qmatmul_grouped(x, w, bg, tm, br))
                ms = timer(lambda: qm.qmatmul_grouped(x, w, bg, tm, br))
                plain_ms = timer(lambda: qm.qmatmul_grouped_plain(x, w, bg, tm, br), iters=3)
                g = bg.long()
                xb = x.view(m_pad // tm, tm, w.k)
                lib_ms = timer(lambda: torch.bmm(xb, dequant(w._map(lambda t: t[g])).to(bf).transpose(1, 2)),
                               iters=3)
                live = (br > 0).nonzero().flatten()  # the non-empty blocks, their weights gathered
                x_live, w_live = xb[live].contiguous(), dequant(w._map(lambda t: t[g[live]])).to(bf)
                bmm_ms = timer(lambda: torch.bmm(x_live, w_live.transpose(1, 2)))
                del x_live, w_live
                nbytes = hit * per_expert + rows * (w.k + w.n) * 2 + bg.numel() * 8
                b, by = bound_ms(nbytes, 2.0 * rows * w.k * w.n)
                cases.append(dict(shape=f"{label} K={w.k} N={w.n} {lname} ({rows} rows, tm {tm})",
                                  max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                                  bound_by=by, library_ms=lib_ms, bmm_dequantized_ms=bmm_ms,
                                  library="dequantized hit experts + torch.bmm"))
                log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, "
                    f"dequantize hit experts + bmm {lib_ms:.4f}, bmm on gathered bf16 {bmm_ms:.4f})")
                del x, want, got
        if name == "grouped_q8":  # with mins (Q5_K / Q2_K kinds), g32: checked, not timed
            wm = stack("q8", h, f, group=32, with_mins=True)
            for lname in ("batch 8", "prefill 256"):
                m_pad, dst, bg, br, tm, _ = layouts[lname]
                x = torch.randn(m_pad, f, device="cuda", dtype=bf, generator=gen)
                check(f"K9 g32 with mins {lname}", qm.qmatmul_grouped(x, wm, bg, tm, br)[dst],
                      qm.qmatmul_grouped_plain(x, wm, bg, tm, br)[dst], row_dims=1)
        results[name] = dict(
            route="cuda", source="nfai_tpu_torch/csrc/grouped_matmul.cu",
            replaces="nfai_tpu/ops/qmatmul.py:1098" if name == "grouped_q4" else "nfai_tpu/ops/qmatmul.py:1144",
            also_replaces=["nfai_tpu/ops/qmatmul.py:1014"],
            headline=cases[1], cases=cases,
        )
    return results


def _kernels_k11(torch, timer, gen) -> dict:
    """K11 (dense layer-stacked matmul) at model D's projections, a 2-layer
    bf16 stack read at layer 1: wqkv 2048 x 3072, wo 2048 x 2048, gate_up
    2048 x 16384, down 8192 x 2048, and Gemma-3-1B's K = 1152 (q and
    gate_up), at decode rows 1 and 8 (the GEMVs), 16, 24, 32 and 64 (the
    batch-1 buckets: wgmma tiles 16, 32 and 64 wide, the cluster K split
    at small N) and the prefill rows 256 and 1024; per input row against
    the plain version, three launches with the same bits. Yardstick:
    torch.matmul(x, w[layer].T) (cuBLAS)."""
    from nfai_tpu_torch.ops import qmatmul as qm

    bf = torch.bfloat16
    shapes = {"wqkv": (2048, 3072), "wo": (2048, 2048), "gate_up": (2048, 16384),
              "down": (8192, 2048), "3-1B wq": (1152, 1024), "3-1B gate_up": (1152, 13824),
              # a tp = 2 rank's shards of model D (the parallel phase): its local [q|k|v],
              # the row-split wo (K = 1024) and down (K = 4096), its half of gate_up;
              # decode rows 1 and 8 and the 8x128 prefill chunk
              "tp2 D wqkv": (2048, 1536), "tp2 D wo": (1024, 2048), "tp2 D gate_up": (2048, 8192),
              "tp2 D down": (4096, 2048)}
    cases = []
    for label, (k, n) in shapes.items():
        w = torch.randn(2, n, k, device="cuda", dtype=bf, generator=gen) * 0.03
        for m in (1, 8, 1024) if label.startswith("tp2 ") else (1, 8, 16, 24, 32, 64, 256, 1024):
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = qm.dense_matmul_layered(x, w, 1)
            torch.cuda.synchronize()
            err = check(f"K11 {label} M={m} K={k} N={n}", got, qm.dense_matmul_plain(x, w, 1), row_dims=1)
            if not all(torch.equal(qm.dense_matmul_layered(x, w, 1), got) for _ in range(2)):
                raise AssertionError(f"K11 {label} M={m}: two launches on the same inputs differ")
            ms = timer(lambda: qm.dense_matmul_layered(x, w, 1))
            plain_ms = timer(lambda: qm.dense_matmul_plain(x, w, 1), iters=3)
            lib_ms = timer(lambda: torch.matmul(x, w[1].T))
            b, by = bound_ms(2 * (k * n + m * k + m * n), 2.0 * m * n * k)
            cases.append(dict(shape=f"{label} M={m}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b, bound_by=by, library_ms=lib_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, cuBLAS {lib_ms:.4f}; "
                f"{ms / lib_ms:.2f}x cuBLAS)")
        del w
    return {"dense_matmul": dict(
        route="cuda", source="nfai_tpu_torch/csrc/dense_matmul.cu",
        replaces="nfai_tpu/ops/qmatmul.py:965", also_replaces=[],
        headline=next(c for c in cases if c["shape"] == "gate_up M=8"), cases=cases,
    )}


def _kernels_k12(torch, timer, gen) -> dict:
    """K12 (q8v3 matmul) at model E's projections (Llama-3.1-8B widths):
    wqkv 4096 x 6144, wo 4096 x 4096, gate_up 4096 x 28672, down 14336 x
    4096 at rows 1 and 8 (the GEMV), 16, 32 and 64 (batch-1 buckets: wgmma
    tiles 16, 32 and 64 wide), 256 and 1024 (the batch prefill's 8x128
    chunk), the untied head 4096 x 128256 at rows 1 to 256 (Q8_0 codes,
    groups of 32, no mins); model B's Q6_K layers under the switch, wv 2048
    x 512 and w_down 8192 x 2048 (g16, codes in -32..31), at rows 16, 256
    and 1024 (the cluster K split at small N); and wo at rows 8 and 256 in
    the other kinds the container takes (g16 without mins, as Q6_K/Q3_K;
    g32 and g16 with mins, as Q5_K and Q2_K). Per input row against the
    plain version; three launches with the same bits. In the same call: K6
    on the same int8 codes (the container the switch replaces) and cuBLAS on
    the dequantized bf16 weight (the library yardstick)."""
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import Q8Tensor, dequant, to_q8v3_stacked

    bf = torch.bfloat16
    shapes = {"wqkv": (4096, 6144), "wo": (4096, 4096), "gate_up": (4096, 28672),
              "down": (14336, 4096), "lm_head": (4096, 128256)}
    b_shapes = {"B Q6_K wv": (2048, 512), "B Q6_K w_down": (8192, 2048)}
    kinds = {"g16": (16, False), "g32 mins": (32, True), "g16 mins": (16, True)}
    cases = []

    def run(label, k, n, group, with_mins, rows, qmax=128):
        qs = torch.randint(-qmax, qmax, (n, k), dtype=torch.int8, device="cuda", generator=gen)
        sc = torch.rand(n, k // group, device="cuda", generator=gen) * 2e-3 / qmax * 8 + 1e-5
        mn = torch.rand(n, k // group, device="cuda", generator=gen) * 1e-2 if with_mins else None
        w8 = Q8Tensor(qs, sc, mn, k, n, group)
        w = to_q8v3_stacked(w8)
        wd = dequant(w).to(bf)
        for m in rows:
            x = torch.randn(m, k, device="cuda", dtype=bf, generator=gen)
            got = qm.q8v3_matmul(x, w)
            torch.cuda.synchronize()
            err = check(f"K12 {label} M={m} K={k} N={n} g{group}{' mins' if with_mins else ''}",
                        got, qm.q8v3_matmul_plain(x, w), row_dims=1)
            if not all(torch.equal(qm.q8v3_matmul(x, w), got) for _ in range(2)):
                raise AssertionError(f"K12 {label} M={m}: two launches on the same inputs differ")
            ms = timer(lambda: qm.q8v3_matmul(x, w))
            plain_ms = timer(lambda: qm.q8v3_matmul_plain(x, w), iters=3)
            k6_ms = timer(lambda: qm.q8_matmul(x, w8))
            lib_ms = timer(lambda: torch.matmul(x, wd.T))
            nbytes = m * k * 2 + n * k + n * (k // group) * 2 * (2 if with_mins else 1) + m * n * 2
            b, by = bound_ms(nbytes, 2.0 * m * n * k)
            cases.append(dict(shape=f"{label} M={m}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b, bound_by=by, library_ms=lib_ms, k6_same_codes_ms=k6_ms))
            log(f"    {ms:.4f} ms (bound {b:.4f} by {by}, plain {plain_ms:.3f}, K6 on the same "
                f"codes {k6_ms:.4f}, cuBLAS on dequantized bf16 {lib_ms:.4f}; "
                f"{ms / lib_ms:.2f}x cuBLAS)")
        del qs, w8, w, wd

    for label, (k, n) in shapes.items():
        run(label, k, n, 32, False, (1, 8, 16, 32, 64, 256) + (() if label == "lm_head" else (1024,)))
    for label, (k, n) in b_shapes.items():
        run(label, k, n, 16, False, (16, 256, 1024), qmax=32)
    for label, (group, with_mins) in kinds.items():
        run(f"wo {label}", 4096, 4096, group, with_mins, (8, 256))
    return {"q8v3_matmul": dict(
        route="cuda", source="nfai_tpu_torch/csrc/q8v3_matmul.cu",
        replaces="nfai_tpu/ops/qmatmul.py:881", also_replaces=[],
        headline=next(c for c in cases if c["shape"] == "gate_up M=8"), cases=cases,
    )}




# K4's "full" cases, bf16 and int8 (label, Hq, Hkv, D, B, T, S, offset):
# model A's heads (32 / 8 of 64) at a 256-token chunk at offsets 0 and 256,
# the 8 x 128 batch prefill, two rows of 16 at offset 100 and the batch-1
# 16-token bucket at offset 1000 (8 blocks on the SMs: the short grid);
# model C's (32 / 4 of 128) the same, model E's (32 / 8 of 128) at the 8 x
# 128 prefill, the 3B's (24 / 8 of 128, r = 3: padding rows)
K4_CASES = (("A", 32, 8, 64, 1, 256, 1024, 0), ("A", 32, 8, 64, 1, 256, 1024, 256),
            ("A", 32, 8, 64, 8, 128, 1024, 0), ("A", 32, 8, 64, 2, 16, 512, 100),
            ("A", 32, 8, 64, 1, 16, 1024, 1000),
            ("C", 32, 4, 128, 1, 256, 1024, 0), ("C", 32, 4, 128, 1, 256, 1024, 256),
            ("C", 32, 4, 128, 8, 128, 1024, 0), ("E", 32, 8, 128, 8, 128, 1024, 0),
            ("3B", 24, 8, 128, 1, 256, 1024, 256),
            ("Q", 12, 2, 128, 8, 128, 1024, 0), ("Q", 12, 2, 128, 1, 256, 1024, 256),
            ("P", 32, 32, 96, 8, 128, 1024, 0), ("P", 32, 32, 96, 1, 256, 1024, 256),
            ("D=96 r=6", 12, 2, 96, 1, 256, 1024, 256), ("M", 32, 8, 128, 8, 128, 1024, 0),
            # a tp = 2 rank's heads: model A's 16 / 4, the Q copy's 6 / 1
            ("tp2 A", 16, 4, 64, 1, 256, 1024, 0), ("tp2 A", 16, 4, 64, 8, 128, 1024, 0),
            ("tp2 Q", 6, 1, 128, 1, 256, 1024, 0))
# K4 at head_dim 256 (heads of GEMMA_HEADS, B, T, S, offset, softcap,
# window): model G's with softcap 50 at chunks of 256 (window 4096 and, at
# offset 768, 512: the window bites) and the 8 x 128 prefill; Gemma-3-1B's
# with window 512; Gemma 2B's (r = 8) without either
GEMMA_K4_CASES = (("G", 1, 256, 1024, 0, 50.0, 4096), ("G", 1, 256, 1024, 256, 50.0, 4096),
                  ("G", 8, 128, 1024, 0, 50.0, 4096), ("G", 1, 256, 1024, 768, 50.0, 512),
                  ("3-1B", 1, 256, 1024, 768, 0.0, 512), ("2B", 1, 256, 1024, 256, 0.0, 0))


def _kernels_k4(torch, timer, gen) -> dict:
    """K4 (flash prefill attention) and its int8, head-major and merged-lane
    instances against their plain versions: "full" at K4_CASES and
    GEMMA_K4_CASES, bf16 and int8 (quantize_kv codes of the same values;
    under a softcap the queries are drawn at 8x scale, so that the cap
    changes the scores), then the layouts (`_k4_layouts`). Each case is
    checked per query token, then timed beside the plain version and the
    yardstick: SDPA over the visible span of a head-major copy made
    beforehand (int8: the span dequantized, then SDPA; softcap: SDPA
    without it, which it does not take). The bound counts the bytes and
    operations of the keys the window leaves visible."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.models.llama import dequant_kv
    from nfai_tpu_torch.ops import prefill_attention as pa

    bf = torch.bfloat16
    out = {"prefill_attention": [], "prefill_attention_i8": []}
    cases = [(f"{m} heads", hq, hkv, d, b, t, s, off, 0.0, 0) for m, hq, hkv, d, b, t, s, off in K4_CASES]
    cases += [(f"{heads} heads", *GEMMA_HEADS[heads], 256, b, t, s, off, cap, win)
              for heads, b, t, s, off, cap, win in GEMMA_K4_CASES]
    for model, hq, hkv, d, b, t, s, off, cap, win in cases:
        kvd, scale = hkv * d, d**-0.5
        q = torch.randn(b, t, hq, d, device="cuda", dtype=bf, generator=gen) * (8 if cap else 1)
        kf = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vf = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        offs = torch.full((b,), off, dtype=torch.int32, device="cuda")
        span = off + t
        qpos = off + torch.arange(t, device="cuda")[:, None]
        keys = torch.arange(span, device="cuda")[None, :]
        mask = (keys <= qpos) & ((keys > qpos - win) if win else True)
        visible = int(mask.sum())
        first = max(off - win + 1, 0) if win else 0  # the first key of the chunk's windows
        qt = q.transpose(1, 2)
        kd, vd = (x[:, :span].view(b, span, hkv, d).transpose(1, 2).contiguous() for x in (kf, vf))
        for quant in (False, True):
            if quant:
                (kc, ks), (vc, vs) = _kv_codes(torch, kf, hkv), _kv_codes(torch, vf, hkv)
                sc, name = dict(k_scales=ks, v_scales=vs), "prefill_attention_i8"
            else:
                kc, vc, ks, vs, sc, name = kf, vf, None, None, {}, "prefill_attention"
            label = f"{model} Hq={hq} Hkv={hkv} D={d} B={b} T={t} S={s} offset={off}" + (
                f" softcap={cap:g} window={win}" if cap or win else "")
            run = lambda: pa.flash_prefill_attention(q, kc, vc, offs, scale, softcap=cap, window=win, **sc)  # noqa: B023,E731
            got = run()
            torch.cuda.synchronize()
            plain = lambda: pa.flash_prefill_attention_plain(q, kc, vc, offs, scale, ks, vs, cap, win)  # noqa: B023,E731
            err = check(f"{'K4-i8' if quant else 'K4'} {label}", got, plain(), row_dims=2)
            if quant:
                def lib():  # noqa: B023
                    kq = dequant_kv(kc[:, :span], ks[:, :, :span], bf).view(b, span, hkv, d).transpose(1, 2)
                    vq = dequant_kv(vc[:, :span], vs[:, :, :span], bf).view(b, span, hkv, d).transpose(1, 2)
                    return nnf.scaled_dot_product_attention(qt, kq, vq, attn_mask=mask, scale=scale,
                                                            enable_gqa=True)
            else:
                def lib():  # noqa: B023
                    return nnf.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, scale=scale,
                                                            enable_gqa=True)
            ms = timer(run)
            plain_ms = timer(plain, iters=3)
            lib_ms = timer(lib)
            read = span - first  # the keys of the chunk's windows, read once
            nbytes = 2 * (2 * b * t * hq * d) + 2 * b * read * kvd * (1 if quant else 2) + (
                2 * 4 * b * hkv * read if quant else 0)
            bb, by = bound_ms(nbytes, 4.0 * b * hq * d * visible)
            library = "dequantize + SDPA" if quant else "SDPA"
            out[name].append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb,
                                  bound_by=by, library_ms=lib_ms, library=library))
            log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, {library} {lib_ms:.4f}, "
                f"x{ms / lib_ms:.2f})")
            del kc, vc
        del kf, vf, kd, vd
    _k4_verify(torch, timer, gen, out)
    src = "nfai_tpu_torch/csrc/prefill_attention.cu"
    rows = {name: dict(route="cuda", source=src, replaces="nfai_tpu/ops/prefill_attention.py:267",
                       also_replaces=[], headline=c[2], cases=c) for name, c in out.items()}
    layouts = _k4_layouts(torch, timer, gen)
    # "merged" is K4's merged-lane instance: its cases join K4's (and K4-i8's) rows
    rows["prefill_attention"]["merged_cases"] = layouts.pop("merged")
    rows["prefill_attention_i8"]["merged_cases"] = layouts.pop("merged_i8")
    rows.update(layouts)
    return rows


# K4 at the verify forward's shape (T = spec_tokens + 1 = 9, model A's heads,
# S = 1024): (B, each row's offset); at batch 8 the offsets are ragged across
# key tiles and the last lane is frozen at S (it reads every key; nothing
# past the cache)
K4_VERIFY_CASES = ((1, (500,)), (8, (0, 5, 63, 64, 300, 700, 1015, 1024)))


def _k4_verify(torch, timer, gen, out) -> None:
    """K4 and K4-i8 at K4_VERIFY_CASES against their plain versions (per
    query token), timed beside SDPA over the whole cache with each row's
    causal mask (int8: the cache dequantized, then SDPA); the cases join
    `out`'s rows. The bound counts each row's visible keys."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.models.llama import dequant_kv
    from nfai_tpu_torch.ops import prefill_attention as pa

    bf = torch.bfloat16
    hq, hkv, d, t, s = 32, 8, 64, 9, 1024
    kvd, scale = hkv * d, d**-0.5
    for b, offsets in K4_VERIFY_CASES:
        q = torch.randn(b, t, hq, d, device="cuda", dtype=bf, generator=gen)
        kf = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vf = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
        qpos = offs.long()[:, None, None] + torch.arange(t, device="cuda")[None, :, None]
        mask = (torch.arange(s, device="cuda")[None, None, :] <= qpos)[:, None]  # [B, 1, T, S]
        visible = int(mask.sum())
        keys_read = sum(min(o + t, s) for o in offsets)
        qt = q.transpose(1, 2)
        kd, vd = (x.view(b, s, hkv, d).transpose(1, 2).contiguous() for x in (kf, vf))
        for quant in (False, True):
            if quant:
                (kc, ks), (vc, vs) = _kv_codes(torch, kf, hkv), _kv_codes(torch, vf, hkv)
                sc, name = dict(k_scales=ks, v_scales=vs), "prefill_attention_i8"
            else:
                kc, vc, ks, vs, sc, name = kf, vf, None, None, {}, "prefill_attention"
            label = f"A verify Hq={hq} Hkv={hkv} D={d} B={b} T={t} S={s} offsets {list(offsets)}"
            run = lambda: pa.flash_prefill_attention(q, kc, vc, offs, scale, **sc)  # noqa: B023,E731
            got = run()
            torch.cuda.synchronize()
            plain = lambda: pa.flash_prefill_attention_plain(q, kc, vc, offs, scale, ks, vs)  # noqa: B023,E731
            err = check(f"{'K4-i8' if quant else 'K4'} {label}", got, plain(), row_dims=2)
            if quant:
                def lib():  # noqa: B023
                    kq = dequant_kv(kc, ks, bf).view(b, s, hkv, d).transpose(1, 2)
                    vq = dequant_kv(vc, vs, bf).view(b, s, hkv, d).transpose(1, 2)
                    return nnf.scaled_dot_product_attention(qt, kq, vq, attn_mask=mask, scale=scale,
                                                            enable_gqa=True)
            else:
                def lib():  # noqa: B023
                    return nnf.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, scale=scale,
                                                            enable_gqa=True)
            ms = timer(run)
            plain_ms = timer(plain, iters=3)
            lib_ms = timer(lib)
            nbytes = 2 * (2 * b * t * hq * d) + 2 * keys_read * kvd * (1 if quant else 2) + (
                2 * 4 * hkv * keys_read if quant else 0)
            bb, by = bound_ms(nbytes, 4.0 * hq * d * visible)
            library = "dequantize + SDPA" if quant else "SDPA"
            out[name].append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bb,
                                  bound_by=by, library_ms=lib_ms, library=library))
            log(f"    {ms:.4f} ms (bound {bb:.5f} by {by}, plain {plain_ms:.3f}, {library} {lib_ms:.4f}, "
                f"x{ms / lib_ms:.2f})")
            del kc, vc


# (label, Hq, Hkv, D, B, T, S, offset, softcap, window): model E's heads (32 / 8 of
# 128) at the batch prefill's 8 x 128 chunk and a 256-token chunk at offsets 0
# and 256; model A's heads (D = 64, "headmajor" only); model G's (8 / 4 of 256)
# with softcap 50 and window 512
LAYOUT_CASES = (("E B=8 T=128", 32, 8, 128, 8, 128, 1024, 0, 0.0, 0),
                ("E B=1 T=256 offset 0", 32, 8, 128, 1, 256, 1024, 0, 0.0, 0),
                ("E B=1 T=256 offset 256", 32, 8, 128, 1, 256, 1024, 256, 0.0, 0),
                ("A D=64 B=1 T=256 offset 256", 32, 8, 64, 1, 256, 1024, 256, 0.0, 0),
                ("G D=256 softcap window B=1 T=256 offset 768", 8, 4, 256, 1, 256, 1024, 768,
                 50.0, 512),
                ("P D=96 B=1 T=256 offset 256", 32, 32, 96, 1, 256, 1024, 256, 0.0, 0),
                ("D=96 r=6 B=8 T=128", 12, 2, 96, 8, 128, 1024, 0, 0.0, 0))


def _k4_layouts(torch, timer, gen) -> dict:
    """K4 in the "headmajor" layout (K4-hm: its own entry points, the cache
    copied to [B, Hkv, S, D]) and "merged" (K4's merged-lane instance under
    its own variant label) at LAYOUT_CASES, bf16 and int8 (codes and scales
    from quantize_kv): each against the plain version (per query token) and
    against "full" on the same values; "merged" at D = 64 must raise. Timed
    beside the plain version and SDPA over the head-major copy (int8:
    dequantize, then SDPA)."""
    import torch.nn.functional as nnf

    from nfai_tpu_torch.ops import prefill_attention as pa

    bf = torch.bfloat16
    out = {name: [] for name in ("prefill_attention_hm", "prefill_attention_hm_i8",
                                 "merged", "merged_i8")}
    for label, hq, hkv, d, b, t, s, off, cap, win in LAYOUT_CASES:
        kvd, scale = hkv * d, d**-0.5
        q = torch.randn(b, t, hq, d, device="cuda", dtype=bf, generator=gen)
        kc = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        vc = torch.randn(b, s, kvd, device="cuda", dtype=bf, generator=gen)
        offs = torch.full((b,), off, dtype=torch.int32, device="cuda")
        span = off + t
        mask = (torch.arange(span, device="cuda")[None, :]
                <= (off + torch.arange(t, device="cuda"))[:, None])
        if win:
            mask &= torch.arange(span, device="cuda")[None, :] > (
                off + torch.arange(t, device="cuda"))[:, None] - win
        qt = q.transpose(1, 2)
        visible = int(mask.sum())
        for quant in (False, True):
            kw = dict(scale=scale, softcap=cap, window=win)
            if quant:
                (kq, ks), (vq, vs) = _kv_codes(torch, kc, hkv), _kv_codes(torch, vc, hkv)
                kw.update(k_scales=ks, v_scales=vs)
                kin, vin = kq, vq
            else:
                kin, vin = kc, vc
            full = pa.flash_prefill_attention(q, kin, vin, offs, **kw)
            kh, vh = pa.head_major(kin, hkv), pa.head_major(vin, hkv)
            tag = f"{label}{' int8' if quant else ''}"
            layouts = ("headmajor", "merged") if d % 128 == 0 else ("headmajor",)
            if d % 128:
                try:
                    pa.flash_prefill_attention(q, kin, vin, offs, kv_layout="merged", **kw)
                except ValueError:
                    log(f"  K4 merged {tag}: refused (D % 128 != 0), as the JAX function")
                else:
                    raise AssertionError(f"K4 merged {tag}: D = {d} was not refused")
            for layout in layouts:
                kl, vl = (kh, vh) if layout == "headmajor" else (kin, vin)
                run = lambda: pa.flash_prefill_attention(q, kl, vl, offs, kv_layout=layout, **kw)  # noqa: B023,E731
                got = run()
                torch.cuda.synchronize()
                plain = lambda: pa.flash_prefill_attention_plain(  # noqa: B023,E731
                    q, kl, vl, offs, scale, kw.get("k_scales"), kw.get("v_scales"), cap, win, layout)
                err = check(f"K4 {layout} {tag}", got, plain(), INT8_TOL if quant else TOL, row_dims=2)
                check(f"K4 {layout} {tag} against full", got, full, 1e-6, row_dims=2)
                ms = timer(run)
                plain_ms = timer(plain, iters=3)
                if quant:  # the yardstick dequantizes, then SDPA
                    def lib():
                        kd = (kq.view(b, s, hkv, d).float() * ks.transpose(1, 2)[..., None]).to(bf)
                        vd = (vq.view(b, s, hkv, d).float() * vs.transpose(1, 2)[..., None]).to(bf)
                        return nnf.scaled_dot_product_attention(
                            qt, kd[:, :span].transpose(1, 2), vd[:, :span].transpose(1, 2),
                            attn_mask=mask, scale=scale, enable_gqa=True)
                else:
                    def lib():
                        return nnf.scaled_dot_product_attention(
                            qt, kh[:, :, :span], vh[:, :, :span], attn_mask=mask, scale=scale,
                            enable_gqa=True)
                lib_ms = timer(lib)
                elem = 1 if quant else 2
                nbytes = 2 * (2 * b * t * hq * d) + 2 * b * span * kvd * elem + (
                    2 * 4 * b * hkv * span if quant else 0)
                bb, by = bound_ms(nbytes, 4.0 * b * hq * d * visible)
                key = ("prefill_attention_hm" if layout == "headmajor" else "merged") + (
                    "_i8" if quant else "")
                out[key].append(dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=bb, bound_by=by, library_ms=lib_ms,
                                     library="dequantize + SDPA" if quant else "SDPA"))
                log(f"    {ms:.4f} ms (bound {bb:.4f} by {by}, plain {plain_ms:.3f}, "
                    f"{'dequantize + ' if quant else ''}SDPA {lib_ms:.4f})")
    src = "nfai_tpu_torch/csrc/prefill_attention.cu"
    row = lambda cases: dict(route="cuda", source=src, replaces="nfai_tpu/ops/prefill_attention.py:70",  # noqa: E731
                             also_replaces=["nfai_tpu/ops/prefill_attention.py:414"],
                             headline=cases[0], cases=cases)
    return {"prefill_attention_hm": row(out["prefill_attention_hm"]),
            "prefill_attention_hm_i8": row(out["prefill_attention_hm_i8"]),
            "merged": out["merged"], "merged_i8": out["merged_i8"]}


# the kernel phases `--kernels` takes: the matmuls (`k8`: K8 and K9), K4, K5,
# K2 / K7 (each with its int8 entry point and Gemma's head_dim-256 rows:
# `--kernels k2,k7`), and K3 / K10 with the K/V store (`k3`)
KERNEL_PHASES = {"k1": _kernels_k1, "k2": _kernels_k2, "k3": _kernels_k3, "k4": _kernels_k4, "k5": _kernels_k5,
                 "k6": _kernels_k6, "k7": _kernels_k7, "k8": _kernels_k8_k9, "k11": _kernels_k11,
                 "k12": _kernels_k12}


# ---------------------------------------------------------------------------
# phases: serve, batch, parity


class _Switches:
    """NFAI_Q8V3 (read by load_params) and K4's layout (the port's
    `_PREFILL_KV_LAYOUT`) set for a block and restored after it, so the
    other models run as before."""

    def __init__(self, q8v3: bool = False, layout: str | None = None):
        self.q8v3, self.layout = q8v3, layout

    def __enter__(self):
        from nfai_tpu_torch.models import llama

        self.saved = os.environ.get("NFAI_Q8V3"), llama._PREFILL_KV_LAYOUT
        if self.q8v3:
            os.environ["NFAI_Q8V3"] = "1"
        if self.layout:
            llama._PREFILL_KV_LAYOUT = self.layout

    def __exit__(self, *exc):
        from nfai_tpu_torch.models import llama

        env, llama._PREFILL_KV_LAYOUT = self.saved
        if env is None:
            os.environ.pop("NFAI_Q8V3", None)
        else:
            os.environ["NFAI_Q8V3"] = env


def phase_serve(torch, path, kv_dtype="auto", q8v3=False) -> dict:
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.runtime.engine import ChatSession, InferenceEngine

    t0 = time.perf_counter()
    with _Switches(q8v3=q8v3):
        engine = InferenceEngine(path, EngineConfig(max_seq_len=1024, kv_dtype=kv_dtype), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"  loaded {engine.model_name}: {engine.model_cfg.n_layers} layers, kv_dtype {kv_dtype}, "
        f"hidden {engine.model_cfg.hidden_size}, vocab {engine.model_cfg.vocab_size} "
        f"in {load_s:.2f}s; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    session = ChatSession(engine, SamplingParams(temperature=0.0, max_new_tokens=64))
    prompts = [
        "Hello! Who are you?",
        "Summarise this: " + " ".join(f"item{i}" for i in range(45)),  # > 256 tokens
        "Thanks. One more line, please.",
    ]
    reqs = []
    for p in prompts:
        text = session.send(p)
        m = session.last_metrics
        reqs.append(dict(prompt_tokens=m.prompt_tokens, new_tokens=m.new_tokens,
                         ttft_ms=m.ttft_s * 1e3, decode_tok_s=m.decode_tokens_per_s))
        log(f"  request: {m.prompt_tokens} prompt tok, {m.new_tokens} new, "
            f"TTFT {m.ttft_s * 1e3:.1f} ms, decode {m.decode_tokens_per_s:.1f} tok/s, "
            f"{len(text)} chars")
        if m.new_tokens <= 0:
            raise AssertionError("a request produced no tokens")
    if max(r["prompt_tokens"] for r in reqs) <= 256:
        raise AssertionError("no prompt exceeded one 256-token prefill chunk")
    return {"engine": engine, "requests": reqs, "load_s": load_s}


def phase_batch(torch, engine, kernels_mod) -> dict:
    from nfai_tpu_torch.models import decode_loop, prefill_step

    b, t, n = 8, 128, 64
    cfg = engine.model_cfg
    cache = engine.new_cache(b)
    if cache.max_seq != 1024:
        raise AssertionError("batch phase expects S = 1024")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (b, t), device="cuda", generator=gen)
    positions = torch.arange(t, device="cuda")[None].expand(b, t).contiguous()
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    t0 = time.perf_counter()
    logits, cache = prefill_step(engine.params, cfg, tokens, positions,
                                 torch.full((b,), t - 1, device="cuda"), cache)
    first = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_chunk = {k.name: k.launches - before[k.name] for k in kernels_mod.KERNELS.values()}
    pos = torch.full((b,), t, device="cuda")
    decode_loop(engine.params, cfg, first, pos, cache, gen, 2)  # warm-up steps
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    t0 = time.perf_counter()
    toks, _, cache, _ = decode_loop(engine.params, cfg, first, pos, cache, gen, n)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    per_step = {k.name: (k.launches - before[k.name]) / n for k in kernels_mod.KERNELS.values()}
    if not bool((toks >= 0).all() & (toks < cfg.vocab_size).all()):
        raise AssertionError("decode produced out-of-range token ids")
    syncs, where = _syncs_per_step(torch, engine, (first, pos + n, cache, gen))
    out = dict(prefill_ms=prefill_s * 1e3, prefill_tok_s=b * t / prefill_s,
               decode_ms_per_step=dec_s / n * 1e3, decode_tok_s=b * n / dec_s,
               launches_per_step=per_step, launches_per_prefill_chunk=per_chunk,
               host_syncs_per_step=syncs,
               decode_bound_ms={f"batch {bb}": _decode_bound_ms(engine, bb) for bb in (1, b)},
               cache_mb=cache.nbytes / 1e6, state=(first, pos + n + 2, cache, gen))
    log(f"  batch {b}, prompt {t}, S 1024: prefill {prefill_s * 1e3:.1f} ms "
        f"({b * t / prefill_s:.0f} tok/s); decode {n} steps {dec_s * 1e3:.1f} ms "
        f"= {dec_s / n * 1e3:.2f} ms/step, {b * n / dec_s:.1f} tok/s; "
        f"kernel launches per step {per_step}; host syncs per step {syncs} {where}; "
        f"byte bound of a step {out['decode_bound_ms']} ms; cache {out['cache_mb']:.1f} MB")
    return out


def phase_long_context(torch, engine) -> dict:
    """Batch 8 in a 4096-slot cache whose first 3500 positions hold random
    rows (through quantize_kv for an int8 cache), then 32 decode steps, the
    last 8 under the profiler: wall ms/step of the first 24, device ms/step
    and K2's device ms per launch of the last 8, each beside its byte bound
    (the step's weights plus the K/V and scales read; K2's keys of one
    layer). K2's launch count must be one per layer a step; a profile that
    lost one of its kernel records is taken again, at most three times."""
    from nfai_tpu_torch.models import KVCache, decode_loop
    from nfai_tpu_torch.models.llama import quantize_kv
    from nfai_tpu_torch.ops.fused_decode import K2, K2_I8
    from torch.profiler import ProfilerActivity, profile

    cfg, b, s, fill, n, n_prof = engine.model_cfg, 8, 4096, 3500, 24, 8
    hkv, d = cfg.n_kv_heads, cfg.head_dim
    cache = KVCache.zeros(cfg, b, s, engine.cache_dtype, engine.device, quantized=engine.kv_quantized)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for layer in range(cfg.n_layers):
        for dst, sdst in ((cache.k, cache.ks), (cache.v, cache.vs)):
            rows = torch.randn(b, fill, hkv * d, device="cuda", dtype=torch.bfloat16, generator=gen)
            if cache.quantized:
                rows, sc = quantize_kv(rows, hkv)
                sdst[layer, :, :, :fill] = sc.transpose(1, 2)
            dst[layer, :, :fill] = rows
    tok = torch.randint(0, 1000, (b,), device="cuda", generator=gen)
    pos = torch.full((b,), fill, device="cuda")
    decode_loop(engine.params, cfg, tok, pos, cache, gen, 2)  # warm-up (rewrites positions 3500-3501)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, pos = decode_loop(engine.params, cfg, tok, pos, cache, gen, n)[1], pos + n
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    k2 = K2_I8 if cache.quantized else K2
    for attempt in range(3):  # the profiler may drop a kernel record; the window is then profiled again
        launched = k2.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tok = decode_loop(engine.params, cfg, tok, pos, cache, gen, n_prof)[1]
            torch.cuda.synchronize()
        launched = k2.launches - launched
        if launched != n_prof * cfg.n_layers:
            raise AssertionError(f"long context: K2 launched {launched} times in {n_prof} steps, "
                                 f"not once per layer ({cfg.n_layers})")
        table = _kernel_table(prof)
        k2_n = sum(n_ for name, (_, n_) in table.items() if "decode_attn_kernel" in name)
        if k2_n == launched:
            break
        log(f"  long context: the profile holds {k2_n} of the {launched} K2 launches; profiling again")
        pos = pos + n_prof
    busy = sum(ms for ms, _ in table.values())
    k2_ms = sum(ms for name, (ms, _) in table.items() if "decode_attn_kernel" in name)
    keys = fill + n + attempt * n_prof + (n_prof - 1) / 2  # the mean number of old keys over the profiled steps
    elem = 1 if cache.quantized else 2
    kv_bytes = cfg.n_layers * 2 * b * keys * hkv * (d * elem + (4 if cache.quantized else 0))
    out = dict(batch=b, slots=s, filled=fill, steps=n + (attempt + 1) * n_prof, wall_ms_per_step=wall_ms / n,
               device_ms_per_step=busy / n_prof, step_bound_ms=_decode_bound_ms(engine, b)
               + kv_bytes / PEAK_BYTES_S * 1e3, k2_ms_per_launch=k2_ms / max(k2_n, 1),
               k2_launches=k2_n, k2_bound_ms=kv_bytes / cfg.n_layers / PEAK_BYTES_S * 1e3,
               cache_mb=cache.nbytes / 1e6)
    log(f"  long context ({'int8' if cache.quantized else 'bf16'} cache, {cache.nbytes / 1e6:.0f} MB): batch {b}, "
        f"{fill} filled of {s}, {n} + {(attempt + 1) * n_prof} steps: wall {out['wall_ms_per_step']:.2f} ms/step; "
        f"profiled: device {out['device_ms_per_step']:.3f} ms/step (bound {out['step_bound_ms']:.3f}), K2 "
        f"{out['k2_ms_per_launch']:.4f} ms per launch over {k2_n} launches (bound {out['k2_bound_ms']:.4f})")
    if k2_n != n_prof * cfg.n_layers:
        raise AssertionError(f"long context: {k2_n} K2 launches in the profile, not {n_prof * cfg.n_layers}, "
                             f"after {attempt + 1} profiled windows")
    del cache
    return out


def _kernel_table(prof) -> dict[str, tuple[float, int]]:
    """Device kernels of a profile (ops would double count; a scheduled
    profile's step annotation spans the step on the device too): name →
    (device ms, launches)."""
    from torch.autograd import DeviceType

    table: dict[str, tuple[float, int]] = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("ProfilerStep"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        ms, count = table.get(ev.key, (0.0, 0))
        table[ev.key] = (ms + dev_us / 1e3, count + ev.count)
    return table


def _syncs_per_step(torch, engine, state, n=2, **options):
    """Host syncs per decode step, counted with torch.cuda.set_sync_debug_mode
    ("warn") over n steps (with `options`, decode_loop's OpenAI options);
    returns (syncs per step, the distinct warnings)."""
    import warnings

    from nfai_tpu_torch.models import decode_loop

    tok, pos, cache, gen = state
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode_loop(engine.params, engine.model_cfg, tok, pos, cache, gen, n, **options)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0][:120] for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(syncs) / n, sorted(set(syncs))


def _decode_bound_ms(engine, batch: int) -> float:
    """The least time of one decode step at `batch` rows: every weight the
    step reads, once, over the HBM rate, from the containers loaded (a MoE
    layer reads the experts a random routing is expected to hit:
    E (1 - (1 - k/E)^batch) of each stack). Caches and activations are
    left out."""
    from nfai_tpu_torch.ops.qtensor import LayerList

    cfg = engine.model_cfg

    def nbytes(w):
        if isinstance(w, LayerList):
            return sum(nbytes(it) for it in w.items)
        if hasattr(w, "qs"):
            return sum(t.numel() * t.element_size()
                       for t in (w.qs, w.scales) + (() if w.mins is None else (w.mins,)))
        return w.numel() * w.element_size()

    total = nbytes(engine.params["lm_head"])
    for key, w in engine.params["layers"].items():
        part = nbytes(w)
        if key.endswith("_exps"):
            e, k = cfg.n_experts, cfg.n_experts_used
            part *= (1 - (1 - k / e) ** batch)
        total += part
    return total / PEAK_BYTES_S * 1e3


def phase_profile(torch, engine, state, tables=None) -> dict:
    """Device busy share and per-kernel device time of 8 decode steps at
    batch 8 (the wall clock includes the host's launch work); through the
    page pool when `tables` are given."""
    from torch.profiler import ProfilerActivity, profile

    from nfai_tpu_torch.models import decode_loop, paged_decode_loop

    tok, pos, cache, gen = state
    n = 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if tables is None:
            decode_loop(engine.params, engine.model_cfg, tok, pos, cache, gen, n)
        else:
            paged_decode_loop(engine.params, engine.model_cfg, tok, pos, cache, tables, gen, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = _kernel_table(prof)
    by_kernel = {name: ms for name, (ms, _) in table.items() if ms > 0}
    n_kernels = sum(count for _, count in table.values())
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    family_ms = {name: sum(ms for k, ms in by_kernel.items() if any(f in k for f in functions)) / n
                 for name, functions in KERNEL_FUNCTIONS.items()}
    out = dict(steps=n, kernels_per_step=n_kernels / n,
               wall_ms_per_step=wall_ms / n, device_ms_per_step=busy_ms / n,
               device_idle_share=1.0 - busy_ms / wall_ms, kernel_ms_per_step=family_ms,
               top_kernels_ms_per_step={k[:60]: v / n for k, v in top})
    log(f"  profiled {n} steps: {n_kernels / n:.0f} kernels/step, wall {wall_ms / n:.2f} ms/step, device busy "
        f"{busy_ms / n:.2f} ms/step, idle share {out['device_idle_share']:.3f}; device ms a step "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in family_ms.items()))
    for k, v in top:
        log(f"    {v / n:8.4f} ms/step  {k[:90]}")
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def phase_profile_prefill(torch, engine, expect: dict[str, int]) -> dict:
    """torch.profiler over one more prefill chunk of the batch phase's shape
    (8 x 128, M = 1024 rows for every projection) on a fresh cache: host
    wall (synchronised), device busy ms, and the device ms of each path of
    the matmul kernels and of K4, tallied by function name (E: K12's GEMV
    for the head's 8 rows, its wgmma tiles for the layers', K4-hm; D: K11's
    wgmma tiles, no GEMV, K4; C: K8's and K9's tiles for the experts (tm
    128), K4; A: K1's tiles for wqkv and wo, K5 for the MLP, K1's GEMV for
    the head, K4). `expect` gives the
    launches of a chunk by function name. The profiler loses the records of
    the first kernels after it starts (seen on the card: 1 to 12 of the 32
    tile launches), so a first chunk runs as the profiler's warm-up step and
    the second is recorded; a profile that still holds other counts is
    taken again, at most three times. Before the profile, the chunk's host
    wall (synchronised) is taken as the median of five runs without the
    profiler: one chunk's wall follows the host's speed of the moment."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from nfai_tpu_torch.models import prefill_step

    b, t = 8, 128
    cfg = engine.model_cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 256, (b, t), device="cuda", generator=gen)
    positions = torch.arange(t, device="cuda")[None].expand(b, t).contiguous()
    last = torch.full((b,), t - 1, device="cuda")
    walls = []
    for _ in range(5):
        cache = engine.new_cache(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_step(engine.params, cfg, tokens, positions, last, cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    median_ms = sorted(walls)[len(walls) // 2]
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up chunk, then the recorded one
                cache = engine.new_cache(b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill_step(engine.params, cfg, tokens, positions, last, cache)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        table = _kernel_table(prof)
        count = {f: sum(n for k, (_, n) in table.items() if f in k) for f in expect}
        if count == expect:
            break
        log(f"  profiled prefill 8x128: launches {count}, not {expect}: the profile lost records, again")
    else:
        raise AssertionError(f"three prefill profiles held launches {count}, not {expect}")
    busy_ms = sum(ms for ms, _ in table.values())
    by_function = {f: sum(ms for k, (ms, _) in table.items() if f in k) for f in (*PATH_FUNCTIONS, *expect)}
    top = sorted(table.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"  profiled prefill 8x128: wall {wall_ms:.2f} ms (under the profiler; median of five "
        f"without it {median_ms:.2f}), device busy {busy_ms:.2f} ms; device ms by function "
        + ", ".join(f"{f} {ms:.4f}" for f, ms in by_function.items() if ms > 0))
    for k, (ms, n) in top:
        log(f"    {ms:8.4f} ms  x{n:<4d} {k[:90]}")
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return dict(wall_ms=wall_ms, median_wall_ms=median_ms, device_ms=busy_ms,
                device_ms_by_function=by_function)


def phase_parity(torch, path2, kind, kv_dtypes=("auto",), param_dtype="auto", q8v3=False) -> dict:
    """A 2-layer full-width copy on cuda and on cpu: prefill logits and 4
    teacher-forced decode steps; for the Q4_K kind also one prefill chunk
    of 1100 rows (above MLP_FUSED_MAX_ROWS: the mlp_prefill route; bf16
    cache only), and for it and the F16 kind the same steps through the
    page pool. For "int8" in kv_dtypes the same engines run it again with
    int8 caches on both sides (K2/K4/K7 through their int8 entry points and
    the int8 store on the card). With a `param_dtype` other than "auto" every matmul
    weight is dequantized at load; with `q8v3` both engines load under
    NFAI_Q8V3=1 (model B's mix: its Q6_K layers on K12, its tied head on K6). Returns the result of each run by
    name."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(os.cpu_count() or 8)
    config = EngineConfig(max_seq_len=256, param_dtype=param_dtype)
    with _Switches(q8v3=q8v3):
        engines = {dev: InferenceEngine(path2, config, device=dev) for dev in ("cuda", "cpu")}
    ids = engines["cpu"].tokenizer.encode("Parity between the card and the plain versions.")
    name = kind if param_dtype == "auto" else f"{kind} param_dtype {param_dtype}"
    name += " NFAI_Q8V3=1" if q8v3 else ""
    out = {name if kv == "auto" else f"{name} {kv}": _parity_run(
        torch, engines, ids, kind, kv == "int8", dense=kind in DENSE_KINDS or param_dtype != "auto")
        for kv in kv_dtypes}
    if kind in FAMILY_BUILDERS:
        out[name]["f32_witness"] = _f32_witness(torch, engines, path2, ids, name)
    if q8v3:  # B's mix: the Q6_K layers of its LayerLists on K12, the tied Q6_K head on K6
        from nfai_tpu_torch.ops.qtensor import LayerList, Q8Tensor, Q8V3Tensor

        lp = engines["cuda"].params["layers"]
        mixed = [k for k, w in lp.items() if isinstance(w, LayerList)]
        launches = out[name]["launches"]
        log(f"  {name}: LayerLists {mixed}, their kinds "
            f"{ {k: [type(it).__name__ for it in lp[k].items] for k in mixed} }; launches {launches}")
        if not mixed or not all(any(isinstance(it, Q8V3Tensor) for it in lp[k].items) for k in mixed) \
                or not isinstance(engines["cuda"].params["lm_head"], Q8Tensor) \
                or launches["q8v3_matmul"] <= 0 or launches["q8_matmul"] <= 0:
            raise AssertionError(f"{name}: the Q6_K layers are not on K12 or the tied head not on K6")
    return out


def _f32_witness(torch, engines, path2, ids, name) -> dict:
    """How far a family copy's two bf16 forwards (the card's kernels, the
    CPU's plain versions) each sit from the exact function: prefill logits
    and 4 teacher-forced decode steps against the CPU's f32 forward of the
    same file. Each card output is held to the larger of TOL and 1.5 x the
    CPU bf16 forward's own distance (tests/test_torch_cuda.py's rule)."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import KVCache, decode_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    runs = dict(engines, f32=InferenceEngine(path2, EngineConfig(max_seq_len=256, dtype="float32"),
                                             device="cpu"))
    outs = {}
    for run, e in runs.items():
        cache = KVCache.zeros(e.model_cfg, 1, 256, e.cache_dtype, e.device)
        logits, cache = e.prefill(cache, ids)
        outs[run], pos = [logits.float().cpu()], len(ids)
        for tok in (17, 99, 200, 42):
            logits, cache = decode_step(e.params, e.model_cfg, torch.tensor([tok], device=e.device),
                                        torch.tensor([pos], device=e.device), cache)
            outs[run].append(logits.float().cpu())
            pos += 1
    card = [errors(g, w)[1] for g, w in zip(outs["cuda"], outs["f32"])]
    cpu = [errors(g, w)[1] for g, w in zip(outs["cpu"], outs["f32"])]
    log(f"  {name} against the CPU's f32 forward (prefill, 4 decode steps): card bf16 "
        f"{[f'{x:.3e}' for x in card]}, CPU bf16 {[f'{x:.3e}' for x in cpu]}")
    if any(not c < max(TOL, 1.5 * p) for c, p in zip(card, cpu)):
        raise AssertionError(f"{name}: the card sits farther from f32 than 1.5 x the CPU's bf16 forward")
    return dict(card_vs_f32=max(card), cpu_bf16_vs_f32=max(cpu))


def _parity_run(torch, engines, ids, kind, quant, dense=False) -> dict:
    """`phase_parity` on one cache kind (int8 when `quant`)."""
    from nfai_tpu_torch.kernels import KERNELS
    from nfai_tpu_torch.models import KVCache, decode_step, prefill_step
    from nfai_tpu_torch.ops.fused_mlp import MLP_FUSED_MAX_ROWS

    before = {k.name: k.launches for k in KERNELS.values()}
    rels = []
    tag = (f"{kind} param_dtype" if dense and kind not in DENSE_KINDS else kind) + (
        " int8 cache" if quant else "")
    tol = INT8_TOL if quant else TOL  # each device quantizes its own K/V

    def compare(name, logits):
        check(f"{tag} {name}", logits["cuda"], logits["cpu"], tol)
        rels.append(errors(logits["cuda"], logits["cpu"])[1])

    logits, caches = {}, {}
    for dev, e in engines.items():
        cache = KVCache.zeros(e.model_cfg, 1, 256, e.cache_dtype, e.device, quantized=quant)
        logits[dev], caches[dev] = e.prefill(cache, ids)
    compare(f"prefill logits ({len(ids)} tokens)", logits)
    pos = len(ids)
    for step, tok in enumerate((17, 99, 200, 42)):
        for dev, e in engines.items():
            logits[dev], caches[dev] = decode_step(
                e.params, e.model_cfg, torch.tensor([tok], device=dev),
                torch.tensor([pos], device=dev), caches[dev])
        compare(f"decode step {step} logits", logits)
        pos += 1
    if kind == "q4_k" and not quant and not dense:
        t = 1100
        if not (t > MLP_FUSED_MAX_ROWS and engines["cuda"].params["fused_mlp"]):
            raise AssertionError("the Q4_K copy should take the fused-MLP route")
        tokens = torch.randint(0, 256, (1, t), generator=torch.Generator().manual_seed(1))
        for dev, e in engines.items():
            logits[dev], _ = prefill_step(
                e.params, e.model_cfg, tokens.to(dev), torch.arange(t, device=dev)[None],
                torch.tensor([t - 1], device=dev),
                KVCache.zeros(e.model_cfg, 1, 1152, e.cache_dtype, e.device))
        compare(f"prefill logits ({t} rows in one chunk: mlp_prefill)", logits)
    if kind in PAGED_PARITY_KINDS:
        _paged_parity(torch, engines, ids, compare, quant)
    launches = {k.name: k.launches - before[k.name] for k in KERNELS.values()}
    if dense:  # every matmul weight dense: K11 and no dequant-matmul kernel
        log(f"  {tag} (dense weights) launches: {launches}")
        if launches["dense_matmul"] <= 0 or any(launches[n] for n in (
                "q4_matmul", "q8_matmul", "fused_mlp")):
            raise AssertionError(f"the {tag} copy did not take the dense route: {launches}")
    if quant:
        log(f"  {tag} launches: {launches}")
        want = ("decode_attention_i8", "prefill_attention_i8", "kv_store") + (
            ("paged_attention_i8", "kv_store_paged") if kind in PAGED_PARITY_KINDS else ())
        if any(launches[n] <= 0 for n in want) or launches["decode_attention"] or launches["paged_attention"]:
            raise AssertionError(f"the {tag} copy did not take the int8 routes: {launches}")
    if kind == "llama_3b":  # K = 3072, head_dim 128; K5 where mlp_eligible takes H = 3072
        cfg = engines["cuda"].model_cfg
        log(f"  llama_3b copy (hidden {cfg.hidden_size}, head_dim {cfg.head_dim}, fused MLP "
            f"{engines['cuda'].params['fused_mlp']}) launches: {launches}")
        if cfg.head_dim != 128 or not engines["cuda"].params["fused_mlp"] or any(
                launches[n] <= 0 for n in ("q4_matmul", "fused_mlp", "decode_attention",
                                           "prefill_attention")):
            raise AssertionError(f"the 3B-width copy did not take its route: {launches}")
    return {"max_rel_err": max(rels), "launches": launches}


def phase_parity_moe(torch, path2, kv_dtypes=("auto",), param_dtype="auto") -> dict:
    """A 2-layer model C copy on cuda and on cpu. First each layer's MoE FFN
    with one routing fed to both sides (the CPU's), per row within TOL; then
    the whole model on a ChatML prompt: the logits of every prompt row and of
    4 teacher-forced decode steps, per row, leaving out the rows whose own
    token has a near-tie in the router (k-th and (k+1)-th router logits
    within NEAR_TIE on the CPU, at any layer), where the card may rightly
    pick another expert; their count is printed. For "int8" in kv_dtypes
    the same engines run the whole-model check again with int8 caches on
    both sides (the FFN check, which no cache reaches, is not repeated).
    With a `param_dtype` other than "auto" every weight, the experts too, is
    dense: the experts run `_moe_ffn_dense` (no grouped kernel, the JAX
    package's ragged_dot route in plain PyTorch) and the projections K11.
    Returns the result of each whole-model run by name."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.kernels import KERNELS
    from nfai_tpu_torch.models import llama as tllama
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(os.cpu_count() or 8)
    config = EngineConfig(max_seq_len=256, param_dtype=param_dtype)
    engines = {dev: InferenceEngine(path2, config, device=dev) for dev in ("cuda", "cpu")}
    cfg = engines["cpu"].model_cfg
    route = tllama.moe_route
    name = "qwen3moe" if param_dtype == "auto" else f"qwen3moe param_dtype {param_dtype}"
    before = {k.name: k.launches for k in KERNELS.values()}
    try:
        x = torch.randn(24, cfg.hidden_size, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
        for layer in range(cfg.n_layers):
            vals, idx = route(x, engines["cpu"].params["layers"]["router"][layer],
                              cfg.n_experts_used, cfg.norm_topk_prob)
            tllama.moe_route = lambda xx, *_: (vals.to(xx.device), idx.to(xx.device))
            ffn = {dev: tllama.moe_ffn(e.params, cfg, x.to(e.device), layer)
                   for dev, e in engines.items()}
            down = engines["cpu"].params["layers"]["w_down_exps"]
            kind = "dense" if isinstance(down, torch.Tensor) else type(down.layer(layer)).__name__
            check(f"{name} layer {layer} MoE FFN (down {kind}), one routing fed to both", ffn["cuda"],
                  ffn["cpu"], row_dims=1)
        margins = []

        def recording(xx, router, n_used, norm_topk):
            if xx.device.type == "cpu":
                top = torch.topk(xx.float() @ router.float(), n_used + 1, dim=-1).values
                margins.append(top[:, n_used - 1] - top[:, n_used])
            return route(xx, router, n_used, norm_topk)

        tllama.moe_route = recording
        tok = engines["cpu"].tokenizer
        ids = tok.encode(engines["cpu"].chat_template.render(
            [{"role": "user", "content": "Parity between the card and the plain versions."}]),
            add_bos=False)
        out = {name if kv == "auto" else f"{name} {kv}": _moe_model_parity(
                   torch, engines, ids, margins, kv == "int8", name) for kv in kv_dtypes}
    finally:
        tllama.moe_route = route
    if param_dtype != "auto":
        launches = {k.name: k.launches - before[k.name] for k in KERNELS.values()}
        log(f"  {name} launches: {launches}")
        if launches["dense_matmul"] <= 0 or any(launches[n] for n in (
                "q4_matmul", "q8_matmul", "grouped_q4", "grouped_q8")):
            raise AssertionError(f"the {name} copy did not take the dense route: {launches}")
    return out


def _moe_model_parity(torch, engines, ids, margins, quant, name="qwen3moe") -> dict:
    """`phase_parity_moe`'s whole-model check on one cache kind; `margins`
    collects the CPU router's k-th vs (k+1)-th gaps of each forward."""
    from nfai_tpu_torch.models import KVCache, decode_step, forward, logits_for

    cfg = engines["cpu"].model_cfg
    tag = f"{name} int8 cache" if quant else name
    n = len(ids)
    logits, caches = {}, {}
    margins.clear()
    for dev, e in engines.items():
        cache = KVCache.zeros(cfg, 1, 256, e.cache_dtype, e.device, quantized=quant)
        h, caches[dev] = forward(e.params, cfg, torch.tensor([ids], device=e.device),
                                 torch.arange(n, device=e.device)[None], cache)
        logits[dev] = logits_for(e.params, h[0], cfg)
    rows = [(f"prompt row {i}", logits["cuda"][i], logits["cpu"][i]) for i in range(n)]
    near = [float(torch.stack([m[i] for m in margins]).min()) < NEAR_TIE for i in range(n)]
    pos = n
    for step, t in enumerate((17, 99, 200, 42)):
        margins.clear()
        for dev, e in engines.items():
            logits[dev], caches[dev] = decode_step(
                e.params, cfg, torch.tensor([t], device=e.device),
                torch.tensor([pos], device=e.device), caches[dev])
        rows.append((f"decode step {step}", logits["cuda"][0], logits["cpu"][0]))
        near.append(float(torch.stack([m[0] for m in margins]).min()) < NEAR_TIE)
        pos += 1
    kept = [(name, a, b) for (name, a, b), nt in zip(rows, near) if not nt]
    log(f"  {tag}: {sum(near)} of {len(rows)} rows left out as router near-ties "
        f"(gap < {NEAR_TIE}); {len(kept)} compared")
    if len(kept) < len(rows) // 2:
        raise AssertionError("too many near-ties for the parity to mean anything")
    got = torch.stack([a.float().cpu() for _, a, _ in kept])
    want = torch.stack([b.float().cpu() for _, _, b in kept])
    check(f"{tag} logits of {len(kept)} rows (prompt {n} tokens, 4 decode steps)", got, want,
          INT8_TOL if quant else TOL, row_dims=1)
    return dict(rows=len(rows), near_ties=sum(near), max_rel_err=errors(got, want, 1)[1])


def phase_parity_gemma3(torch, kernels_mod, path2, kind="q4_0") -> dict:
    """A 2-layer Gemma-3-1B-width copy on cuda and on cpu. Its swa pattern
    is cut with its depth, from 6 to 2, so that layer 0 is local (window
    512, the local rope base) and layer 1 global. A 700-token prompt is
    prefilled in the engine's chunks (the last ones past the window), then 4
    teacher-forced steps decode at positions 700-703: dense, then through a
    shuffled 6-page table, on bf16 caches (within TOL) and on int8 caches
    (within INT8_TOL: each device quantizes its own K/V). On the card K2, K4
    and K7 must run both the windowed and the global layer at D = 256. Kind
    "q4_k_m" is llama.cpp's real mix (`make_gemma3_1b_gguf`): dense Q5_0
    q/k/gate/up through K11, a wv stack of a Q5_0 and a dequantized Q8_0
    layer (q/k/v split), K1 for attn_output and layer 0's ffn_down, K6 for
    layer 1's Q6_K ffn_down and the Q8_0 head; all three must launch."""
    import dataclasses

    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import KVCache, decode_step, paged_prefill_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    torch.set_num_threads(os.cpu_count() or 8)
    engines = {dev: InferenceEngine(path2, EngineConfig(max_seq_len=1024), device=dev)
               for dev in ("cuda", "cpu")}
    for e in engines.values():
        e.model_cfg = dataclasses.replace(e.model_cfg, swa_pattern=2)
    cfg = engines["cpu"].model_cfg
    if cfg.layer_windows() != [512, 0] or cfg.head_dim != 256 or "inv_freq_local" not in engines["cpu"].params:
        raise AssertionError(f"the Gemma-3-1B copy: windows {cfg.layer_windows()}, head_dim {cfg.head_dim}")
    ids = torch.randint(300, cfg.vocab_size, (GEMMA3_PROMPT,), generator=torch.Generator().manual_seed(12)).tolist()
    n = len(ids)
    perm = torch.randperm(15, generator=torch.Generator().manual_seed(13))[:6] + 1
    out = {}
    kernels_mod.reset_launches()
    name = "gemma3-1b" if kind == "q4_0" else f"gemma3-1b {kind}"
    if kind == "q4_k_m":
        lp = engines["cuda"].params["layers"]
        if "wqkv" in lp or not all(isinstance(lp[k], torch.Tensor) for k in ("wq", "wk", "wv", "w_gate_up")):
            raise AssertionError(f"the Gemma-3-1B mix loaded {({k: type(v).__name__ for k, v in lp.items()})}")
    for quant in (False, True):
        tag = f"{name} int8 cache" if quant else name
        tol, rels = (INT8_TOL if quant else TOL), []

        def compare(name, logits):
            check(f"{tag} {name}", logits["cuda"], logits["cpu"], tol)
            rels.append(errors(logits["cuda"], logits["cpu"])[1])

        for paged in (False, True):
            logits, caches, tables = {}, {}, {}
            for dev, e in engines.items():
                if paged:
                    tables[dev] = perm.view(1, 6).to(torch.int32).to(dev)
                    pool = PagedKVCache.zeros(cfg, 16, 128, e.cache_dtype, dev, quantized=quant)
                    logits[dev], caches[dev] = paged_prefill_step(
                        e.params, cfg, torch.tensor([ids], device=dev), torch.arange(n, device=dev)[None],
                        torch.tensor([n - 1], device=dev), pool, tables[dev])
                else:
                    tables[dev] = None
                    cache = KVCache.zeros(cfg, 1, 1024, e.cache_dtype, e.device, quantized=quant)
                    logits[dev], caches[dev] = e.prefill(cache, ids)
            route = "paged" if paged else "dense"
            compare(f"{route} prefill logits ({n} tokens, window 512)", logits)
            for step, tok in enumerate((17, 99, 200, 42)):
                for dev, e in engines.items():
                    logits[dev], caches[dev] = decode_step(
                        e.params, cfg, torch.tensor([tok], device=dev), torch.tensor([n + step], device=dev),
                        caches[dev], page_tables=tables[dev])
                compare(f"{route} decode step {step} logits (position {n + step})", logits)
        out[tag] = {"max_rel_err": max(rels)}
    variants = {k.name: dict(k.variants) for k in kernels_mod.KERNELS.values() if k.variants}
    log(f"  {name} copy attention launches by variant: {variants}")
    want = ("D=256 window", "D=256")
    for kname in ("decode_attention", "prefill_attention", "paged_attention", "decode_attention_i8",
                  "prefill_attention_i8", "paged_attention_i8"):
        if any(variants.get(kname, {}).get(v, 0) <= 0 for v in want):
            raise AssertionError(f"the {name} copy: {kname} launched {variants.get(kname)}, not all of {want}")
    if kind == "q4_k_m":
        launches = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
        log(f"  {name} copy launches: {launches}")
        if any(launches[k] <= 0 for k in ("dense_matmul", "q4_matmul", "q8_matmul")):
            raise AssertionError(f"the {name} copy did not launch K11, K1 and K6: {launches}")
    return out


def _paged_parity(torch, engines, ids, compare, quant) -> None:
    """The same prompt and 4 teacher-forced steps through the page pool
    (a shuffled 2-page table of a 12-page pool): K7 and K4 on the gathered
    pages on the card against their plain versions on the CPU."""
    from nfai_tpu_torch.models import decode_step, paged_prefill_step
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    perm = torch.randperm(11, generator=torch.Generator().manual_seed(2))[:2] + 1
    logits, pools, tables = {}, {}, {}
    n = len(ids)
    for dev, e in engines.items():
        tables[dev] = perm.view(1, 2).to(torch.int32).to(dev)
        pools[dev] = PagedKVCache.zeros(e.model_cfg, 12, 128, e.cache_dtype, dev, quantized=quant)
        logits[dev], pools[dev] = paged_prefill_step(
            e.params, e.model_cfg, torch.tensor([ids], device=dev), torch.arange(n, device=dev)[None],
            torch.tensor([n - 1], device=dev), pools[dev], tables[dev])
    compare(f"paged prefill logits ({n} tokens, table {perm.tolist()})", logits)
    pos = n
    for step, tok in enumerate((17, 99, 200, 42)):
        for dev, e in engines.items():
            logits[dev], pools[dev] = decode_step(
                e.params, e.model_cfg, torch.tensor([tok], device=dev),
                torch.tensor([pos], device=dev), pools[dev], page_tables=tables[dev])
        compare(f"paged decode step {step} logits", logits)
        pos += 1


def _e_steps(torch, e, ids, paged, quant) -> list:
    """Prefill logits and 4 teacher-forced decode steps of engine `e`, on a
    dense cache or through a shuffled 2-page table of a 12-page pool."""
    from nfai_tpu_torch.models import KVCache, decode_step, paged_prefill_step
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    dev, cfg, n = e.device, e.model_cfg, len(ids)
    if paged:
        table = (torch.randperm(11, generator=torch.Generator().manual_seed(2))[:2] + 1)
        table = table.view(1, 2).to(torch.int32).to(dev)
        cache = PagedKVCache.zeros(cfg, 12, 128, e.cache_dtype, dev, quantized=quant)
        logits, cache = paged_prefill_step(
            e.params, cfg, torch.tensor([ids], device=dev), torch.arange(n, device=dev)[None],
            torch.tensor([n - 1], device=dev), cache, table)
    else:
        table = None
        logits, cache = e.prefill(KVCache.zeros(cfg, 1, 256, e.cache_dtype, dev, quantized=quant), ids)
    out = [logits]
    for step, tok in enumerate((17, 99, 200, 42)):
        logits, cache = decode_step(e.params, cfg, torch.tensor([tok], device=dev),
                                    torch.tensor([n + step], device=dev), cache, page_tables=table)
        out.append(logits)
    return out


def phase_parity_e(torch, kernels_mod, path2) -> dict:
    """Model E's 2-layer copy (Llama-3.1-8B widths, Q8_0, untied) loaded
    under NFAI_Q8V3=1 on cuda and on cpu: the prefill logits and 4
    teacher-forced decode steps, "headmajor" dense and paged on bf16 and
    int8 caches (within TOL and INT8_TOL: each device quantizes its own
    K/V), "merged" dense on bf16. The CPU's plain K4 reads every layout the
    same way, so its runs are shared between the layouts. On the card K12,
    K4-hm (bf16 and int8) and K4's merged variant must launch, and no K1,
    K6 or K11."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.ops.qtensor import Q8V3Tensor
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(os.cpu_count() or 8)
    with _Switches(q8v3=True):
        engines = {dev: InferenceEngine(path2, EngineConfig(max_seq_len=256), device=dev)
                   for dev in ("cuda", "cpu")}
    if not all(isinstance(e.params["lm_head"], Q8V3Tensor) for e in engines.values()):
        raise AssertionError("the E copy did not load its q8v3 head")
    ids = engines["cpu"].tokenizer.encode("Parity between the card and the plain versions.")
    ref, out = {}, {}
    kernels_mod.reset_launches()
    runs = (("headmajor", False, False), ("headmajor", True, False), ("headmajor", False, True),
            ("headmajor", True, True), ("merged", False, False))
    for layout, paged, quant in runs:
        tag = f"E copy {layout} {'paged' if paged else 'dense'}{' int8 cache' if quant else ''}"
        with _Switches(layout=layout):
            if (paged, quant) not in ref:
                ref[(paged, quant)] = _e_steps(torch, engines["cpu"], ids, paged, quant)
            got = _e_steps(torch, engines["cuda"], ids, paged, quant)
        rels = []
        for step, (g, w) in enumerate(zip(got, ref[(paged, quant)])):
            what = "prefill logits" if step == 0 else f"decode step {step - 1} logits"
            check(f"{tag} {what}", g, w, INT8_TOL if quant else TOL)
            rels.append(errors(g, w)[1])
        out[tag] = {"max_rel_err": max(rels)}
    launches = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    variants = {k.name: dict(k.variants) for k in kernels_mod.KERNELS.values() if k.variants}
    log(f"  E copy launches: {launches}; attention variants {variants}")
    if any(launches[k] <= 0 for k in ("q8v3_matmul", "prefill_attention_hm", "prefill_attention_hm_i8")) \
            or variants.get("prefill_attention", {}).get("merged D=128", 0) <= 0 \
            or any(launches[k] for k in ("q4_matmul", "q8_matmul", "dense_matmul")):
        raise AssertionError(f"the E copy did not take its routes: {launches}, {variants}")
    return out


def _pcts(xs) -> dict:
    xs = sorted(xs)
    at = lambda f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
    return dict(p50=at(0.5), p90=at(0.9), max=xs[-1])


def _server_parity(torch, engine, kernels_mod) -> dict:
    """Paged vs dense forwards on the card, outside the main-path window
    (on the engine's cache kind: bf16, or int8 codes and scales):
    a 300-token prefill through a shuffled table (paged_prefill_step)
    against prefill_step, then 4 rows of ragged length (prefilled with
    paged_prefill_step / prefill_slot_step) decode 8 teacher-forced steps at
    batch 4 through one-step paged decodes and dense decode_step; every
    paged step must launch K7 exactly once per layer.

    Model A's MLP is K5, whose F-tile partials are summed in a fixed order,
    so two identical dense runs give the same bits (checked first:
    `k5_dense_noise` must be 0). K4 sees the same bytes on both sides, and
    K7 splits, tiles and merges a row's keys as K2 does (the last key as
    K2's new token), so paged and dense must agree well inside 2e-2
    (exactly, by design). With an int8 cache the two no longer agree
    bit for bit:
    the dense decode folds the new token in at full precision, the paged
    one reads it back quantized, and the paged prefill attends pages
    dequantized to bf16 where the dense one applies the scales in f32. On
    an H100 those roundings grew to 3.3e-2 (prefill) and 4.9e-2 (decode)
    over model A's 16 layers, as K5's f32 atomics order alone gives 1.7e-2,
    while the int8 cache sat 6.8e-2 from the bf16 cache on the same
    prefill. So each int8 comparison must come out below the larger of
    INT8_TOL and the int8 cache's own error against a bf16 cache on the
    same dense forward (run beside it): the two int8 routes agree at least
    as well as the JAX package's int8 rule, or as int8 agrees with bf16."""
    from nfai_tpu_torch.models import (
        KVCache, decode_step, paged_prefill_step, prefill_slot_step, prefill_step,
    )
    from nfai_tpu_torch.ops.paged_attention import K7, K7_I8
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    cfg, dev, quant = engine.model_cfg, engine.device, engine.kv_quantized
    k7 = K7_I8 if quant else K7
    params = engine.params
    ps, n_p, lens = 128, 8, [300, 137, 77, 255]
    pool = PagedKVCache.zeros(cfg, len(lens) * n_p + 9, ps, engine.cache_dtype, dev, quantized=quant)
    tables = _shuffled_tables(torch, len(lens), n_p, pool.n_pages, seed=7, device=dev)
    dense = KVCache.zeros(cfg, len(lens), n_p * ps, engine.cache_dtype, dev, quantized=quant)
    # int8: the same dense forwards on a bf16 cache set each comparison's bound
    dense_bf16 = KVCache.zeros(cfg, len(lens), n_p * ps, engine.cache_dtype, dev) if quant else None
    bounds = []

    def bound(got_int8, got_bf16, row_dims=0):
        """For an int8 cache: INT8_TOL, or the int8 cache's own error
        against the bf16 cache on the same forward when that is larger."""
        bounds.append(errors(got_int8, got_bf16, row_dims)[1])
        return max(INT8_TOL, bounds[-1])

    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 1000, (1, n), generator=gen).to(dev) for n in lens]
    rels = []

    def prefill_args(i):
        n = lens[i]
        return (prompts[i], torch.arange(n, device=dev)[None], torch.tensor([n - 1], device=dev))

    fresh = lambda: KVCache.zeros(cfg, 1, n_p * ps, engine.cache_dtype, dev, quantized=quant)  # noqa: E731
    d1, _ = prefill_step(params, cfg, *prefill_args(0), fresh())
    d2, _ = prefill_step(params, cfg, *prefill_args(0), fresh())
    noise = errors(d2, d1)[1]
    log(f"  two dense 300-token prefills through K5: rel {noise:.3e} (must be 0: K5 sums in a fixed order)")
    if noise != 0:
        raise AssertionError("two identical dense prefills on the K5 route differ")

    for i in range(len(lens)):
        lp, pool = paged_prefill_step(params, cfg, *prefill_args(i), pool, tables[i:i + 1])
        ld, dense = prefill_slot_step(params, cfg, *prefill_args(i), dense, i)
        if quant:
            lb, dense_bf16 = prefill_slot_step(params, cfg, *prefill_args(i), dense_bf16, i)
        if i == 0:
            ref, _ = prefill_step(params, cfg, *prefill_args(0),
                                  KVCache.zeros(cfg, 1, n_p * ps, engine.cache_dtype, dev, quantized=quant))
            check("paged vs dense prefill logits (300 tokens, shuffled table)", lp, ref,
                  bound(ld, lb) if quant else TOL)
            check("prefill_slot_step vs prefill_step logits (300 tokens)", ld, ref)
            rels += [errors(lp, ref)[1], errors(ld, ref)[1]]
    positions = torch.tensor(lens, device=dev)
    for step in range(8):
        toks = torch.randint(0, 1000, (len(lens),), generator=gen).to(dev)
        before = k7.launches
        lp, pool = decode_step(params, cfg, toks, positions, pool, page_tables=tables)
        if k7.launches - before != cfg.n_layers:
            raise AssertionError(f"a paged decode step launched {k7.name} {k7.launches - before} times, "
                                 f"not once per layer ({cfg.n_layers})")
        ld, dense = decode_step(params, cfg, toks, positions, dense)
        tol = TOL
        if quant:
            lb, dense_bf16 = decode_step(params, cfg, toks, positions, dense_bf16)
            tol = bound(ld, lb, row_dims=1)
        check(f"paged vs dense decode step {step} logits (batch 4, positions "
              f"{positions.tolist()})", lp, ld, tol, row_dims=1)
        rels.append(errors(lp, ld, row_dims=1)[1])
        positions = positions + 1
    out = {"max_rel_err": max(rels), "k5_dense_noise": noise}
    if quant:
        out["int8_vs_bf16"] = bounds
        log(f"  int8 vs bf16 cache on the same dense forwards (each bound above is the larger of this and INT8_TOL): "
            f"{', '.join(f'{b:.3e}' for b in bounds)}")
    return out


def _paged_decode_timing(torch, engine, kernels_mod) -> dict:
    """Batch-8 paged decode as the batch phase runs dense decode (positions
    from 128, 64 steps, pool pages filled at random), then 8 steps under
    the profiler; outside the main-path window."""
    from nfai_tpu_torch.models import paged_decode_loop
    from nfai_tpu_torch.runtime.paged_cache import PagedKVCache

    cfg, b, n, ps, dev = engine.model_cfg, 8, 64, 128, engine.device
    pool = PagedKVCache.zeros(cfg, b * 8 + 9, ps, engine.cache_dtype, dev, quantized=engine.kv_quantized)
    for dst, sdst in ((pool.k, pool.ks), (pool.v, pool.vs)):
        rows = torch.randn(dst.shape, device=dev, dtype=torch.bfloat16) * 0.5
        if pool.quantized:
            rows, sc = _pool_codes(torch, rows)
            sdst.copy_(sc)
        dst.copy_(rows)
    tables = _shuffled_tables(torch, b, 8, pool.n_pages, seed=11, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, 1000, (b,), device=dev, generator=gen)
    pos = torch.full((b,), 128, device=dev)
    paged_decode_loop(engine.params, cfg, tok, pos, pool, tables, gen, 2)  # warm-up
    _sync(torch)
    before = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    t0 = time.perf_counter()
    paged_decode_loop(engine.params, cfg, tok, pos, pool, tables, gen, n)
    _sync(torch)
    dec_s = time.perf_counter() - t0
    per_step = {k.name: (k.launches - before[k.name]) / n for k in kernels_mod.KERNELS.values()}
    k7 = "paged_attention_i8" if pool.quantized else "paged_attention"
    for name in (k7, "kv_store_paged"):
        if per_step[name] != cfg.n_layers:
            raise AssertionError(f"paged decode chunk: {per_step[name]} {name} launches per "
                                 f"step, not one per layer ({cfg.n_layers})")
    log(f"  paged batch {b}, positions 128..{128 + n}: {dec_s / n * 1e3:.2f} ms/step, "
        f"{b * n / dec_s:.1f} tok/s; launches per step {per_step}")
    prof = phase_profile(torch, engine, (tok, pos, pool, gen), tables=tables)
    pool_mb = pool.nbytes / 1e6
    del pool
    return dict(decode_ms_per_step=dec_s / n * 1e3, decode_tok_s=b * n / dec_s,
                launches_per_step=per_step, profile=prof, pool_mb=pool_mb)


def _drive(be, reqs, max_steps=5000):
    from nfai_tpu_torch.runtime.scheduler import RequestState

    for _ in range(max_steps):
        if be.step() == 0 and be.queue.empty() and not be._parked:
            break
    bad = [r.id for r in reqs if r.state != RequestState.FINISHED]
    if bad:
        raise AssertionError(f"requests {bad} did not finish")


def _batch_engine_run(torch, engine) -> dict:
    """16 requests at once on a paged BatchEngine (max_batch 8, chunk 8):
    8 share a 300-token prefix (2 full pages) with tails of 20-200 tokens,
    8 are distinct (30-700 tokens, one of them 3 prefill chunks); half
    greedy, half temperature 0.8 with top_k 20 or 40 and top_p 0.95."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(5)
    ids = lambda n: torch.randint(0, 1000, (n,), generator=rng).tolist()  # noqa: E731
    prefix = ids(300)
    shared = [prefix + ids(t) for t in (20, 45, 70, 95, 120, 150, 175, 200)]
    distinct = [ids(n) for n in (30, 90, 150, 230, 310, 420, 512, 700)]
    prompts = [shared[0]] + distinct + shared[1:]  # the prefix is published before its sharers arrive
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=64) if i % 2 == 0 else
                SamplingParams(temperature=0.8, top_k=(20, 40)[i // 2 % 2], top_p=0.95,
                               max_new_tokens=64) for i in range(len(prompts))]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    _sync(torch)
    t0 = time.perf_counter()
    reqs = [be.submit(p, s) for p, s in zip(prompts, sampling)]
    _drive(be, reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    n_out = sum(len(r.output_ids) for r in reqs)
    ttft = _pcts([r.ttft_s * 1e3 for r in reqs])
    out = dict(requests=len(reqs), prompt_tokens=sum(map(len, prompts)), new_tokens=n_out,
               wall_s=wall, tok_s=n_out / wall, ttft_ms=ttft, prefix_hits=be.alloc.hits,
               prefix_misses=be.alloc.misses, pool_mb=be.cache.nbytes / 1e6,
               preemptions=be.preemptions)
    log(f"  BatchEngine: {len(reqs)} requests, {out['prompt_tokens']} prompt tokens, {n_out} new "
        f"in {wall:.2f} s = {n_out / wall:.1f} tok/s aggregate; TTFT p50 {ttft['p50']:.1f} / "
        f"p90 {ttft['p90']:.1f} / max {ttft['max']:.1f} ms; prefix hits {be.alloc.hits}, misses "
        f"{be.alloc.misses}; pool {out['pool_mb']:.1f} MB; preemptions {be.preemptions}")
    if be.alloc.hits <= 0:
        raise AssertionError("no prefix-cache hit")
    if any(not 0 < len(r.output_ids) <= 64 for r in reqs):
        raise AssertionError(f"output lengths {[len(r.output_ids) for r in reqs]}")
    del be
    return out


def _preemption_run(torch, engine) -> dict:
    """A pool that admits 8 prompts of 240-250 tokens (2 pages each, 16
    pages) but cannot grow them all to 314 tokens (24 pages): the youngest
    are preempted and recomputed; every request must still finish."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, 1000, (240 + i,), generator=rng).tolist() for i in range(8)]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True, pool_tokens=2048)
    t0 = time.perf_counter()
    reqs = [be.submit(p, SamplingParams(temperature=0.0, max_new_tokens=64)) for p in prompts]
    _drive(be, reqs)
    wall = time.perf_counter() - t0
    lens = [len(r.output_ids) for r in reqs]
    log(f"  preemption: pool {be.alloc.n_pages} pages, {be.preemptions} preemptions, outputs {lens}, "
        f"{wall:.2f} s")
    if be.preemptions < 1:
        raise AssertionError("the starved pool preempted nothing")
    if not (be.alloc.refs[1:] == 0).all():
        raise AssertionError("pages were not all returned after the preempting run")
    if any(not 0 < n <= 64 for n in lens):
        raise AssertionError(f"output lengths {lens}")
    return dict(preemptions=be.preemptions, output_lengths=lens, wall_s=wall,
                full_length=sum(n == 64 for n in lens))


def _http_run(torch, engine, n: int = 8) -> dict:
    """ServerState + make_handler on the same engine (127.0.0.1, port 0): n
    concurrent requests from threads, n/2 SSE chat, n/2 - 1 blocking chat, 1
    /v1/completions; TTFT is the time to the first SSE chunk."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nfai_tpu_torch.runtime.scheduler import BatchEngine
    from nfai_tpu_torch.server import ServerState, make_handler

    batch = BatchEngine(engine, max_batch=8, decode_chunk=8)
    batch.start()
    state = ServerState(engine, batch)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, errs = {}, []

    def hit(i):
        stream = i < n // 2
        path, body = ("/v1/completions", {"prompt": f"Request {i}: count to ten."}) if i == n - 1 else (
            "/v1/chat/completions", {"messages": [{"role": "user", "content": f"Request {i}: hello"}]})
        body.update(temperature=0, max_tokens=32, stream=stream)
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                if not stream:
                    obj = json.loads(r.read())
                    c = obj["choices"][0]
                    results[i] = dict(code=r.status, text=c.get("text", c.get("message", {}).get("content")))
                    return
                events, first = [], None
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("data: "):
                        if first is None:
                            first = time.perf_counter() - t0
                        events.append(line[6:])
                text = "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                               for e in events[:-1])
                results[i] = dict(code=r.status, text=text, done=events[-1] == "[DONE]",
                                  ttft_ms=first * 1e3)
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(f"request {i}: {e!r}")

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batch.close()
    if errs or len(results) != n:
        raise AssertionError(f"HTTP requests failed: {errs or sorted(results)}")
    if any(r["code"] != 200 or not r["text"] for r in results.values()):
        raise AssertionError(f"HTTP results: {results}")
    if not all(results[i]["done"] for i in range(n // 2)):
        raise AssertionError("an SSE stream did not end in [DONE]")
    if health["requests_served"] != n:
        raise AssertionError(f"/healthz reports {health['requests_served']} requests served")
    ttft = _pcts([results[i]["ttft_ms"] for i in range(n // 2)])
    log(f"  HTTP: {n} concurrent requests ({n // 2} SSE, {n // 2 - 1} blocking chat, 1 completion) all "
        f"200 in {wall:.2f} s; SSE TTFT p50 {ttft['p50']:.1f} / max {ttft['max']:.1f} ms; /healthz "
        f"{health['requests_served']} served")
    return dict(wall_s=wall, sse_ttft_ms=ttft, chars=[len(results[i]["text"]) for i in range(n)])


def phase_server(torch, engine, kernels_mod, route="server", n_http=8) -> tuple[dict, dict]:
    """The continuous-batching path on model A's engine (`route` "server",
    or "A8 server" on the int8-cache engine). Returns (results, the launch
    counts of its main-path window)."""
    out = dict(paged_vs_dense=_server_parity(torch, engine, kernels_mod),
               paged_decode=_paged_decode_timing(torch, engine, kernels_mod))
    kernels_mod.reset_launches()
    out["batch_engine"] = _batch_engine_run(torch, engine)
    out["preemption"] = _preemption_run(torch, engine)
    out["http"] = _http_run(torch, engine, n_http)
    return out, _check_route(kernels_mod, route, f"the {route} path")


# ---------------------------------------------------------------------------
# phases: options (the OpenAI sampling options and sessions) and eval


FORCED = 1000  # a plain vocabulary entry the options phase forces with a logit bias


def _options_kw(torch, b, vocab) -> dict:
    """decode_loop's three OpenAI options at batch b, all on: a 16-wide
    random logit-bias table a row, presence and frequency penalties over
    output counts, logprobs with the top 5."""
    gen = torch.Generator().manual_seed(9)
    return dict(bias_ids=torch.randint(0, vocab, (b, 16), generator=gen).cuda(),
                bias_vals=(torch.rand(b, 16, generator=gen) * 4 - 2).cuda(),
                presence=torch.full((b,), 0.5, device="cuda"), frequency=torch.full((b,), 0.5, device="cuda"),
                counts=torch.zeros((b, vocab), dtype=torch.int32, device="cuda"), n_logprobs=5)


def _check_logprobs(name, entries, ids, k) -> None:
    """GenerationMetrics.logprobs / Request.logprob_data: one entry per
    token, finite, <= 0, the top list k long and sorted."""
    import math

    if [e["id"] for e in entries] != list(ids):
        raise AssertionError(f"{name}: logprob entries do not follow the tokens")
    for e in entries:
        vals = [v for _, v in e["top"]]
        if not (math.isfinite(e["logprob"]) and e["logprob"] <= 1e-6 and len(vals) == k
                and all(math.isfinite(v) and v <= 1e-6 for v in vals)
                and all(a >= b for a, b in zip(vals, vals[1:]))):
            raise AssertionError(f"{name}: bad logprob entry {e}")


def _near_tie_prefix(name, got, want, entries, margin) -> int:
    """The common prefix of two greedy streams; where they part, `got`'s
    token must lie within `margin` of the top of `want`'s logprobs there
    (two routes that round differently may pick either of a near-tie)."""
    for d, (g, w) in enumerate(zip(got, want)):
        if g != w:
            top = dict(entries[d]["top"])
            if g not in top or top[g] < entries[d]["top"][0][1] - margin:
                raise AssertionError(f"{name}: token {d} is {g}, not {w}, and not a near-tie: {entries[d]}")
            return d
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} tokens against {len(want)}")
    return len(got)


def _generate_options(torch, engine) -> dict:
    """generate at batch 1 with each option: a +100 bias forces its token
    on every greedy step; a frequency penalty of 30 a repeat takes it off
    after at most 4 (+100 - 4 x 30); logprobs with the top 5 follow the
    tokens, finite, <= 0, sorted, the greedy token's equal to the top."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import GenerationMetrics

    ids = engine.tokenizer.encode("Options on the card: a logit bias, penalties and logprobs.")
    forced = list(engine.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=16,
                                                      logit_bias=((FORCED, 100.0),))))
    if forced != [FORCED] * 16:
        raise AssertionError(f"a +100 logit bias did not force token {FORCED}: {forced}")
    m = GenerationMetrics()
    pen = list(engine.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=16,
                                                   logit_bias=((FORCED, 100.0),), frequency_penalty=30.0,
                                                   logprobs=5), metrics=m))
    n_forced = pen.count(FORCED)
    if pen[0] != FORCED or not 1 <= n_forced <= 4 or len(set(pen)) < 16 - n_forced + 1:
        raise AssertionError(f"the frequency penalty did not break the greedy repeat: {pen}")
    _check_logprobs("generate with bias and penalty", m.logprobs, pen, 5)
    m = GenerationMetrics()
    plain = list(engine.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=32, logprobs=5), metrics=m))
    _check_logprobs("generate with logprobs", m.logprobs, plain, 5)
    if any(abs(e["top"][0][1] - e["logprob"]) > 1e-5 for e in m.logprobs):
        raise AssertionError("a greedy token's logprob is not the top one")
    log(f"  generate options: a +100 bias forces {FORCED} 16 times; with frequency 30 it repeats "
        f"{n_forced} times in {pen}; logprobs of 32 greedy tokens: the first "
        f"{m.logprobs[0]['logprob']:.4f}, top 5 {[round(v, 3) for _, v in m.logprobs[0]['top']]}")
    return dict(forced_repeats_with_penalty=n_forced, first_logprob=m.logprobs[0]["logprob"])


def _session_round_trip(torch, engine, tmp, kv) -> dict:
    """ChatSession.save → load → continue on the card: the loaded cache
    holds the saved bits, and the continued session's second reply and
    tokens are those of the session never saved."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import ChatSession

    greedy = SamplingParams(temperature=0.0, max_new_tokens=24)
    s = ChatSession(engine, greedy)
    s.send("Hello! Remember the number forty-two, please.")
    path = os.path.join(tmp, f"session_{kv}.npz")
    t0 = time.perf_counter()
    s.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s2 = ChatSession.load(engine, path, greedy)
    _sync(torch)
    load_s = time.perf_counter() - t0
    n = engine.max_seq_len
    for a in ("k", "v", "ks", "vs"):
        saved, loaded = getattr(s._cache, a), getattr(s2._cache, a)
        if saved is None:
            continue
        cut = (slice(None),) * (2 if a in ("k", "v") else 3) + (slice(0, n),)
        if loaded.device != engine.device or not torch.equal(loaded[cut], saved[cut]):
            raise AssertionError(f"session ({kv}): the loaded cache.{a} is not the saved one on the card")
    r2 = s2.send("Which number was it?")
    want = s.send("Which number was it?")  # the uninterrupted session
    if r2 != want or s2._cached_ids != s._cached_ids:
        raise AssertionError(f"session ({kv}): the loaded session went on as {r2!r}, the saved one as {want!r}")
    size = os.path.getsize(path)
    os.remove(path)
    log(f"  session ({kv} cache): {len(s._cached_ids)} cached tokens, file {size / 1e6:.2f} MB, save "
        f"{save_s * 1e3:.0f} ms, load {load_s * 1e3:.0f} ms; the continued session equals the uninterrupted one")
    return dict(file_mb=size / 1e6, save_ms=save_s * 1e3, load_ms=load_s * 1e3, cached_tokens=len(s._cached_ids))


def _options_profile(torch, engine) -> dict:
    """A's batch-8 decode (S 1024, after an 8x128 prefill) with the three
    options off and on: the wall a step (median of three 8-step chunks,
    synchronised, no profiler), and under torch.profiler (a warm-up chunk,
    then a recorded one) the device ms and kernel launches a step. Returns
    the numbers and the state to count host syncs on."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from nfai_tpu_torch.models import decode_loop, prefill_step

    b, t, n = 8, 128, 8
    cfg = engine.model_cfg
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (b, t), device="cuda", generator=gen)
    cache = engine.new_cache(b)
    logits, cache = prefill_step(engine.params, cfg, tokens,
                                 torch.arange(t, device="cuda")[None].expand(b, t).contiguous(),
                                 torch.full((b,), t - 1, device="cuda"), cache)
    first, pos = logits.argmax(-1), torch.full((b,), t, device="cuda")
    out, tables = {}, {}
    for label in ("off", "on"):
        kw = _options_kw(torch, b, cfg.vocab_size) if label == "on" else {}
        walls = []
        for _ in range(4):  # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_loop(engine.params, cfg, first, pos, cache, gen, n, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / n)
        wall = sorted(walls[1:])[1]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                decode_loop(engine.params, cfg, first, pos, cache, gen, n, **kw)
                torch.cuda.synchronize()
                prof.step()
        table = tables[label] = _kernel_table(prof)
        device_ms = sum(ms for ms, _ in table.values()) / n
        launches = sum(c for _, c in table.values()) / n
        out[label] = dict(wall_ms_per_step=wall, device_ms_per_step=device_ms, kernels_per_step=launches)
        if device_ms <= 0:
            raise AssertionError("the profiler saw no device time")
    added = out["on"]["kernels_per_step"] - out["off"]["kernels_per_step"]
    log(f"  batch-8 decode, options off: wall {out['off']['wall_ms_per_step']:.3f} ms/step, device "
        f"{out['off']['device_ms_per_step']:.3f} ms/step, {out['off']['kernels_per_step']:.1f} kernels/step; "
        f"all three on (bias 16 wide, penalties, logprobs top 5): wall {out['on']['wall_ms_per_step']:.3f}, "
        f"device {out['on']['device_ms_per_step']:.3f}, {out['on']['kernels_per_step']:.1f} kernels/step "
        f"(+{added:.1f} launches a step)")
    out["launches_added_per_step"] = added
    # what the options add, by kernel name: launches and device ms a step
    extra = {k: ((ms - tables["off"].get(k, (0.0, 0))[0]) / n, (c - tables["off"].get(k, (0.0, 0))[1]) / n)
             for k, (ms, c) in tables["on"].items()}
    extra = sorted(((k, v) for k, v in extra.items() if v[1] > 0), key=lambda kv: -kv[1][1])
    for k, (ms, c) in extra[:16]:
        log(f"    +{c:5.2f} launches, +{ms:.4f} ms a step  {k[:100]}")
    out["added_by_kernel"] = {k[:80]: dict(launches=c, ms=ms) for k, (ms, c) in extra}
    return out, (first, pos, cache, gen)


def _options_batch_engine(torch, engine):
    """The paged BatchEngine at batch 8 with mixed slots: four greedy (the
    options one by one) and four sampled at temperature 0.8 with options.
    Returns (results, a check to run outside the main-path window: each
    greedy slot's tokens equal generate's for the same request, up to a
    near-tie (TOL of the logit scale, by generate's own logprobs))."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import GenerationMetrics
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, 1000, (n,), generator=rng).tolist() for n in (40, 90, 150, 230, 60, 120, 200, 300)]
    banned = range(FORCED + 1, FORCED + 17)
    bans = tuple((i, -100.0) for i in banned)
    options = [dict(logprobs=5), dict(logit_bias=((FORCED, 100.0),), frequency_penalty=30.0, logprobs=2),
               dict(presence_penalty=1.0, frequency_penalty=0.5), dict(logit_bias=bans, logprobs=0)]
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=64, **o) for o in options] + [
        SamplingParams(temperature=0.8, top_k=40, top_p=0.95, max_new_tokens=64, seed=i, **o)
        for i, o in enumerate(options)]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    _sync(torch)
    t0 = time.perf_counter()
    reqs = [be.submit(p, s) for p, s in zip(prompts, sampling)]
    _drive(be, reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    for i, (s, r) in enumerate(zip(sampling, reqs)):
        if s.logprobs is not None:
            _check_logprobs(f"BatchEngine slot {i}", r.logprob_data, r.output_ids, s.logprobs)
        elif r.logprob_data:
            raise AssertionError(f"slot {i} asked for no logprobs and got some")
        if not 0 < len(r.output_ids) <= 64:
            raise AssertionError(f"slot {i}: {len(r.output_ids)} tokens")
    if reqs[1].output_ids[0] != FORCED or reqs[1].output_ids.count(FORCED) > 4:
        raise AssertionError(f"slot 1's bias and penalty: {reqs[1].output_ids[:8]}")
    if set(banned) & set(reqs[3].output_ids + reqs[7].output_ids):
        raise AssertionError("a banned token was sampled")
    n_out = sum(len(r.output_ids) for r in reqs)
    log(f"  BatchEngine with options: 8 requests (4 greedy, 4 at temperature 0.8), {n_out} tokens in "
        f"{wall:.2f} s")
    out = dict(wall_s=wall, new_tokens=n_out)

    def against_generate():
        scale = float(engine.prefill(engine.new_cache(1), prompts[0])[0].abs().max())
        agreed = []
        for i, (p, s, r) in enumerate(zip(prompts, sampling, reqs)):
            if s.temperature <= 0:
                m = GenerationMetrics()
                ref = list(engine.generate(p, dataclasses.replace(s, logprobs=5), metrics=m))
                agreed.append(_near_tie_prefix(f"BatchEngine slot {i} against generate", r.output_ids, ref,
                                               m.logprobs, TOL * scale))
        log(f"  BatchEngine greedy slots equal generate for {agreed} of 64 tokens (the rest after a "
            f"near-tie within {TOL} x the logit scale {scale:.2f})")
        out.update(greedy_agreed=agreed, logit_scale=scale)

    return out, against_generate


def _http_logprobs(torch, engine) -> dict:
    """One chat request with logprobs (top 3), a logit bias and a frequency
    penalty through the server, whole and streamed: 200, one logprob entry
    per completion token in the chat layout, the same text both ways."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from nfai_tpu_torch.runtime.scheduler import BatchEngine
    from nfai_tpu_torch.server import ServerState, make_handler

    batch = BatchEngine(engine, max_batch=8, decode_chunk=8)
    batch.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ServerState(engine, batch)))
    srv = threading.Thread(target=httpd.serve_forever, daemon=True)
    srv.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = {"messages": [{"role": "user", "content": "Tell me about logprobs."}], "temperature": 0,
            "max_tokens": 24, "logprobs": True, "top_logprobs": 3, "logit_bias": {str(FORCED + 1): -100},
            "frequency_penalty": 0.5}

    def post(b):
        req = urllib.request.Request(base + "/v1/chat/completions", data=json.dumps(b).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    try:
        with post(body) as r:
            whole = json.loads(r.read())
            code = r.status
        with post(dict(body, stream=True)) as r:
            events = [line.decode().strip()[6:] for line in r if line.decode().startswith("data: ")]
    finally:
        httpd.shutdown()
        httpd.server_close()
        batch.close()
    choice = whole["choices"][0]
    content = choice["logprobs"]["content"]
    n = whole["usage"]["completion_tokens"]
    if code != 200 or len(content) != n or any(len(e["top_logprobs"]) != 3 or e["logprob"] > 1e-6
                                               for e in content):
        raise AssertionError(f"HTTP logprobs: {code}, {len(content)} entries for {n} tokens")
    chunks = [json.loads(e) for e in events[:-1]]
    streamed = [e for c in chunks for e in (c["choices"][0].get("logprobs") or {}).get("content", [])]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    if events[-1] != "[DONE]" or text != choice["message"]["content"] or len(streamed) != n:
        raise AssertionError(f"HTTP logprobs streamed: {len(streamed)} entries for {n} tokens, "
                             f"text {text!r} against {choice['message']['content']!r}")
    log(f"  HTTP with logprobs: {n} tokens, whole and streamed, {len(chunks)} SSE chunks, the same text; "
        f"first token {content[0]['token']!r} logprob {content[0]['logprob']:.4f}")
    return dict(tokens=n, sse_chunks=len(chunks))


def phase_options(torch, engine, kernels_mod, label, tmp) -> tuple[dict, dict]:
    """The OpenAI options and sessions on model A's engine (or A8's: its
    session on the int8 cache and generate with the options), each window
    of main-path launches zeroed before and checked after: "A options"
    (generate, a session round trip, the batch-8 decode with the options
    off and on, host syncs per step with them on), "A options server" (the
    paged BatchEngine at batch 8 with mixed slots, one HTTP request with
    logprobs); "A8 options". Returns (results, launches by path)."""
    out, paths = {}, {}
    kernels_mod.reset_launches()
    if label == "A8":
        out["session"] = _session_round_trip(torch, engine, tmp, "int8")
        out["generate"] = _generate_options(torch, engine)
        paths["A8 options"] = _check_route(kernels_mod, "A8 options", "model A8's options")
        return out, paths
    out["generate"] = _generate_options(torch, engine)
    out["session"] = _session_round_trip(torch, engine, tmp, "bf16")
    out["decode"], state = _options_profile(torch, engine)
    syncs, where = _syncs_per_step(torch, engine, state, **_options_kw(torch, 8, engine.model_cfg.vocab_size))
    out["host_syncs_per_step"] = syncs
    log(f"  host syncs per decode step with every option on: {syncs} {where}")
    if syncs != 0:
        raise AssertionError(f"the options add host syncs to a decode step: {where}")
    del state
    paths["A options"] = _check_route(kernels_mod, "A options", "model A's options")
    kernels_mod.reset_launches()
    out["batch_engine"], against_generate = _options_batch_engine(torch, engine)
    out["http"] = _http_logprobs(torch, engine)
    paths["A options server"] = _check_route(kernels_mod, "A options server", "model A's options server")
    against_generate()  # dense runs, outside the paged path's window
    return out, paths


EVAL_WINDOW = 512


def _eval_windows(torch, params, cfg, ids, name) -> dict:
    """One EVAL_WINDOW window of `ids` on a bf16 and on an int8 cache:
    perplexity and seconds of each (synchronised)."""
    import math

    from nfai_tpu_torch.eval import perplexity

    out = {}
    for kv, quant in (("bf16", False), ("int8", True)):
        dev = params["final_norm"].device
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl = perplexity(params, cfg, ids, EVAL_WINDOW, torch.bfloat16, kv_quant=quant)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[kv] = dict(ppl=ppl, window_s=time.perf_counter() - t0)
        if not (math.isfinite(ppl) and ppl > 1):
            raise AssertionError(f"{name} {kv}: perplexity {ppl}")
    log(f"  eval {name} ({EVAL_WINDOW}-token window, {dev.type}): bf16 cache ppl {out['bf16']['ppl']:.4f} in "
        f"{out['bf16']['window_s']:.3f} s; int8 cache ppl {out['int8']['ppl']:.4f} in "
        f"{out['int8']['window_s']:.3f} s")
    return out


def _k1_head_m512(torch, engine) -> dict:
    """K1 on model A's head at M = 512 (an eval window's logits), against
    its plain version per row, timed beside the plain version and cuBLAS
    on the dequantized bf16 weight, with its bound."""
    from nfai_tpu_torch.ops import qmatmul as qm
    from nfai_tpu_torch.ops.qtensor import dequant

    timer = Timer(torch)
    w = engine.params["lm_head"]
    m, k, n = EVAL_WINDOW, w.k, w.n
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=torch.Generator(device="cuda").manual_seed(3))
    got = qm.q4_matmul(x, w)
    err = check(f"K1 head M={m} K={k} N={n}", got, qm.matmul_plain(x, w), row_dims=1)
    ms = timer(lambda: qm.q4_matmul(x, w))
    plain_ms = timer(lambda: qm.matmul_plain(x, w), iters=3)
    wd = dequant(w).to(torch.bfloat16)
    lib_ms = timer(lambda: torch.matmul(x, wd.T))
    del wd
    nbytes = m * k * 2 + n * k // 2 + n * k // 32 * 8 + m * n * 2
    b, by = bound_ms(nbytes, 2.0 * m * n * k)
    log(f"    K1 head M={m}: {ms:.4f} ms (bound {b:.4f} by {by}; plain {plain_ms:.3f}, cuBLAS on the "
        f"dequantized bf16 weight {lib_ms:.4f})")
    return dict(shape=f"lm_head M={m}", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms)


def phase_eval(torch, engine, kernels_mod, tmp) -> tuple[dict, dict]:
    """nfai_tpu_torch.eval on the card: model A scores one 512-token window
    of a seeded id stream on a bf16 and an int8 cache (the main-path window
    "A eval": per window K4 (or K4-i8), the store and K5 once a layer, K1
    for wqkv and wo on every layer and the head at M = 512); then K1's head
    at M = 512 is timed; then Llama-3.2-1B's 2-layer Q4_K copy scores the
    same window on the card and on the CPU's plain versions: mean NLL
    within TOL relative on the bf16 cache, INT8_TOL on the int8 one (each
    device quantizes its own K/V)."""
    import math

    from nfai_tpu_torch.gguf import GGUFFile
    from nfai_tpu_torch.models import LlamaConfig, load_params
    from nfai_tpu_torch.testing import make_llama_1b_gguf

    cfg = engine.model_cfg
    ids = torch.randint(0, cfg.vocab_size, (EVAL_WINDOW,), generator=torch.Generator().manual_seed(12)).numpy()
    kernels_mod.reset_launches()
    out = {"A": _eval_windows(torch, engine.params, cfg, ids, "model A")}
    launches = _check_route(kernels_mod, "A eval", "model A's eval")
    L = cfg.n_layers
    want = {"prefill_attention": L, "prefill_attention_i8": L, "kv_store": 2 * L, "fused_mlp": 2 * L,
            "q4_matmul": 2 * (2 * L + 1)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"model A's eval windows launched {got}; the route implies {want}")
    out["k1_head_m512"] = _k1_head_m512(torch, engine)
    t0 = time.perf_counter()
    path2 = make_llama_1b_gguf(os.path.join(tmp, "llama1b_2l_q4_k_eval.gguf"), kind="q4_k", n_layers=2)
    torch.set_num_threads(os.cpu_count() or 8)
    with GGUFFile.open(path2) as g:
        cfg2 = LlamaConfig.from_gguf(g)
        res = {dev: _eval_windows(torch, load_params(g, cfg2, dtype=torch.bfloat16, device=dev), cfg2, ids,
                                  "2-layer Q4_K copy") for dev in ("cuda", "cpu")}
    os.remove(path2)
    for kv, tol in (("bf16", TOL), ("int8", INT8_TOL)):
        nll = {dev: math.log(res[dev][kv]["ppl"]) for dev in ("cuda", "cpu")}
        rel = abs(nll["cuda"] - nll["cpu"]) / nll["cpu"]
        log(f"  eval parity ({kv} cache): mean NLL card {nll['cuda']:.5f}, CPU {nll['cpu']:.5f}, rel "
            f"{rel:.2e} (tol {tol:g})")
        if not rel < tol:
            raise AssertionError(f"eval parity ({kv}): the card's mean NLL is {rel:.2e} from the CPU's")
        res[f"rel_nll_{kv}"] = rel
    out["parity"] = res
    out["parity_s"] = time.perf_counter() - t0
    return out, launches


# ---------------------------------------------------------------------------
# phase: tools (the host tools and the native dequant library)

# the tensors of each model's GGUF the tools phase decodes on the host, with
# the native library and with the numpy codecs (None: every F16 tensor)
HOST_DECODE = {"A": ("token_embd.weight",),  # the untied F16 table [128256, 2048], decoded at load
               "C": ("blk.0.attn_v.weight",),  # a Q6_K tensor (use_more_bits' layer 0)
               "Q": ("token_embd.weight",),  # the tied Q6_K table [151936, 1536]
               "D": None}  # every F16 weight: D loads each one dense
NUMPY_LOADS = ("A", "D")  # their engine loads are timed again with the numpy codecs forced
VALIDATE_PPL_TOL = 0.005  # the validate tool's default --ppl-tol


def _same_bits(name, got, want) -> None:
    import numpy as np

    if got.shape != want.shape or not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError(f"{name}: the native library and the numpy codecs give different bits")


def _openmp_runtimes() -> list:
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f if "gomp" in line})


def _native_kinds() -> dict:
    """Every kind the library decodes, on random blocks (random codes, f16
    scales in [1e-3, 1e-2) and log-uniform in [1e-7, 5e-5]: subnormal) and
    on the encoders' blocks of N(0, 1) and N(0, 1e-4) values, against the
    numpy codecs; then the fused transpose of a [96, 1024] tensor of each
    kind against the decode's transpose."""
    import numpy as np

    from nfai_tpu_torch.gguf import GGML_BLOCK_LAYOUT, GGMLType, native, quants

    scales = {GGMLType.Q4_0: (0,), GGMLType.Q4_1: (0, 2), GGMLType.Q5_0: (0,), GGMLType.Q5_1: (0, 2),
              GGMLType.Q8_0: (0,), GGMLType.Q2_K: (80, 82), GGMLType.Q3_K: (108,),
              GGMLType.Q4_K: (0, 2), GGMLType.Q5_K: (0, 2), GGMLType.Q6_K: (208,)}
    rng = np.random.default_rng(22)

    def blocks(kind, subnormal, n_blocks):
        layout = GGML_BLOCK_LAYOUT[kind]
        n = n_blocks * layout.block_size
        mag = 1e-6 if subnormal else 1.0
        if kind == GGMLType.F16:
            return (rng.standard_normal(n) * mag).astype(np.float16).view(np.uint8), n
        if kind == GGMLType.BF16:
            return quants.quant_bf16((rng.standard_normal(n) * (1e-39 if subnormal else 1.0)).astype(np.float32)), n
        raw = np.frombuffer(rng.bytes(n_blocks * layout.type_size), np.uint8).reshape(n_blocks, -1).copy()
        d = 10.0 ** rng.uniform(-7, np.log10(5e-5), n_blocks) if subnormal else rng.uniform(1e-3, 1e-2, n_blocks)
        for off in scales.get(kind, ()):
            raw[:, off:off + 2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
        if kind == GGMLType.Q8_K:
            raw[:, :4] = d.astype(np.float32).view(np.uint8).reshape(-1, 4)
        return raw.reshape(-1), n

    kinds = sorted(native._NATIVE_TYPES, key=int)
    for kind in kinds:
        for subnormal in (False, True):
            raw, n = blocks(kind, subnormal, 64)
            _same_bits(f"{kind.name} random blocks", native.dequantize_native(raw, n, kind),
                       quants.dequantize(raw, n, kind))
            if kind in quants.QUANTIZERS or kind == GGMLType.F16:
                x = (rng.standard_normal(4096) * (1e-4 if subnormal else 1.0)).astype(np.float32)
                enc = quants.quantize(x, kind)
                _same_bits(f"{kind.name} encoded", native.dequantize_native(enc, x.size, kind),
                           quants.dequantize(enc, x.size, kind))
        raw, _ = blocks(kind, False, 96 * 1024 // GGML_BLOCK_LAYOUT[kind].block_size)
        t = native.dequant_transpose_native(raw, kind, 96, 1024)
        _same_bits(f"{kind.name} fused transpose", t,
                   np.ascontiguousarray(quants.dequantize(raw, 96 * 1024, kind).reshape(96, 1024).T))
    out = dict(kinds=[k.name for k in kinds], threads=native.num_threads(), host_cores=os.cpu_count(),
               openmp_runtimes=_openmp_runtimes())
    log(f"  native dequant library: {len(kinds)} kinds ({', '.join(out['kinds'])}) bit-equal to the numpy "
        f"codecs on random blocks at normal and subnormal f16 scales and on encoded values; the fused "
        f"transpose of each equals the decode's transpose; OpenMP team {out['threads']} on {out['host_cores']} "
        f"host cores; OpenMP runtimes mapped {out['openmp_runtimes']}")
    return out


def _host_decode(torch, label, path) -> dict:
    """Model `label`'s HOST_DECODE tensors decoded by the library and by the
    numpy codecs: the same bits, and the seconds of each (the file was just
    written: its pages are warm). Model A also times the fused transpose of
    a layer's ffn_down against decode + transpose, and models NUMPY_LOADS
    time an InferenceEngine load with the numpy codecs forced (the port
    before the library), beside serve's load."""
    import numpy as np

    from nfai_tpu_torch.gguf import GGMLType, GGUFFile, native, quants

    out = {}
    if label == "A":
        t0 = time.perf_counter()
        native.load_library()  # the g++ build, at first use
        out["library_s"] = time.perf_counter() - t0
        log(f"  native dequant library built and loaded in {out['library_s']:.2f} s")
        out["kinds"] = _native_kinds()
    with GGUFFile.open(path) as g:
        names = HOST_DECODE[label] or [n for n, d in g.tensors.items() if d.ggml_type == GGMLType.F16]
        t_native = t_numpy = 0.0
        for name in names:
            desc = g.tensors[name]  # (no view of the mapped file outlives the loop: close() needs none)
            t0 = time.perf_counter()
            got = native.dequantize_native(g.tensor_bytes(name), desc.n_elements, desc.ggml_type)
            t_native += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = quants.dequantize(g.tensor_bytes(name), desc.n_elements, desc.ggml_type)
            t_numpy += time.perf_counter() - t0
            _same_bits(f"model {label} {name}", got, want)
            del got, want
        values = sum(g.tensors[n].n_elements for n in names)
        kinds = sorted({g.tensors[n].ggml_type.name for n in names})
        what = f"{names[0]} {g.tensors[names[0]].shape}" if len(names) == 1 else f"{len(names)} tensors"
        out.update(tensors=what, values=values, native_s=t_native, numpy_s=t_numpy)
        log(f"  host decode, model {label}: {what}, {values / 1e6:.1f}M values of {kinds}: native "
            f"{t_native:.3f} s, numpy {t_numpy:.3f} s (x{t_numpy / t_native:.1f}), the same bits; "
            f"OpenMP team {native.num_threads()}, torch threads {torch.get_num_threads()}")
        if label == "A":
            name = "blk.0.ffn_down.weight"
            t0 = time.perf_counter()
            fused = g.tensor_f32_transposed(name)
            t_fused = time.perf_counter() - t0
            t0 = time.perf_counter()
            plain = np.ascontiguousarray(g.tensor_f32(name).T)
            t_two = time.perf_counter() - t0
            _same_bits(f"model A {name} transposed", fused, plain)
            out["transpose"] = dict(tensor=name, fused_s=t_fused, decode_then_transpose_s=t_two)
            log(f"  fused dequant-transpose of {name} {g.tensors[name].shape} (Q4_K): {t_fused:.4f} s, "
                f"decode then transpose {t_two:.4f} s, the same bits")
    if label in NUMPY_LOADS:
        from nfai_tpu_torch.config import EngineConfig
        from nfai_tpu_torch.runtime.engine import InferenceEngine

        saved, native._NATIVE_TYPES = native._NATIVE_TYPES, frozenset()  # the numpy codecs, forced
        try:
            t0 = time.perf_counter()
            engine = InferenceEngine(path, EngineConfig(max_seq_len=1024), device="cuda")
            torch.cuda.synchronize()
            out["numpy_load_s"] = time.perf_counter() - t0
        finally:
            native._NATIVE_TYPES = saved
        del engine
        torch.cuda.empty_cache()
        log(f"  model {label}: InferenceEngine load with the numpy codecs forced {out['numpy_load_s']:.2f} s")
    return out


def _tool(tools, argv) -> tuple[int, dict | None]:
    """Run `python -m nfai_tpu_torch.tools argv` in process: its exit code
    and the record `validate` prints (None for the other commands)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(argv)
    text = buf.getvalue()
    log("\n".join(f"    {line}" for line in text.splitlines() if line.strip() and line[0] not in " {}"))
    record = json.loads(text[text.index("{"):text.rindex("}") + 1]) if argv[0] == "validate" else None
    return rc, record


def _expect(what, rc, want) -> None:
    log(f"  {what}: exit {rc} (expected {want})")
    if rc != want:
        raise AssertionError(f"{what}: exit {rc}, expected {want}")


def phase_tools(torch, engine, kernels_mod, a_path, tmp) -> tuple[dict, dict]:
    """The tools on model A (see the module doc): `validate` through the
    entry point and on A's loaded engine, a seed-1 2-layer copy (exit 2, its
    card ppl beside the CPU's f32 ppl), that copy requantized to Q8_0,
    inspected and served on K6 ("A q8_0", "A q8_0 server")."""
    import numpy as np

    from nfai_tpu_torch import tools
    from nfai_tpu_torch.eval import perplexity
    from nfai_tpu_torch.gguf import GGUFFile
    from nfai_tpu_torch.models import LlamaConfig, load_params
    from nfai_tpu_torch.testing import make_llama_1b_gguf
    from nfai_tpu_torch.tokenizer import tokenizer_from_gguf

    out, paths = {}, {}
    fx = os.path.join(tmp, "validation_fixtures.json")
    max_seq = engine.max_seq_len  # the CLI's engine holds a cache of A's loaded one
    common = ["--fixtures", fx, "--device", "cuda", "--max-seq", str(max_seq)]
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    rc, record = _tool(tools, ["validate", str(a_path), *common, "--update"])
    out["validate_update_s"] = time.perf_counter() - t0
    _expect(f"validate --update on model A ({out['validate_update_s']:.1f} s with its own engine load)", rc, 0)
    out["record"] = record
    log(f"  model A's record: {json.dumps(record)}")
    key = tools._checkpoint_key(str(a_path))
    t0 = time.perf_counter()
    again = tools.validation_record(engine, key, max_seq)
    out["validate_check_s"] = time.perf_counter() - t0
    _expect(f"validate on model A's loaded engine ({out['validate_check_s']:.1f} s)",
            tools.check_record(again, fx, False, VALIDATE_PPL_TOL), 0)
    with open(fx, encoding="utf-8") as f:
        fixtures = json.load(f)
    fixtures[key]["ppl"] *= 1.01
    with open(fx, "w", encoding="utf-8") as f:
        json.dump(fixtures, f)
    _expect("validate with the fixture's ppl moved by 1%",
            tools.check_record(tools.validation_record(engine, key, max_seq), fx, False, VALIDATE_PPL_TOL), 1)
    x = make_llama_1b_gguf(os.path.join(tmp, "llama1b_2l_seed1.gguf"), kind="q4_k", n_layers=2, seed=1)
    rc, rec_x = _tool(tools, ["validate", str(x), *common])
    _expect("validate on a 2-layer copy of A written with seed 1", rc, 2)
    paths["A validate"] = _check_route(kernels_mod, "A validate", "validate on model A and its 2-layer copy")
    torch.set_num_threads(os.cpu_count() or 8)
    t0 = time.perf_counter()
    with GGUFFile.open(x) as g:
        cfg = LlamaConfig.from_gguf(g)
        ids = np.asarray(tokenizer_from_gguf(g.metadata).encode(tools._VALIDATE_CORPUS), np.int64)
        ppl_cpu = perplexity(load_params(g, cfg, dtype=torch.float32, device="cpu"), cfg, ids,
                             rec_x["ppl_window"], torch.float32)
    out["ppl_seed1"] = dict(card_bf16=rec_x["ppl"], cpu_f32=ppl_cpu, window=rec_x["ppl_window"],
                            cpu_s=time.perf_counter() - t0)
    log(f"  validate ppl of the seed-1 copy ({len(ids)} tokens, windows of {rec_x['ppl_window']}): card bf16 "
        f"{rec_x['ppl']:.4f}, CPU f32 {ppl_cpu:.4f} (rel {abs(rec_x['ppl'] - ppl_cpu) / ppl_cpu:.2e}; "
        f"a number, not a gate; CPU {out['ppl_seed1']['cpu_s']:.1f} s)")
    y = os.path.join(tmp, "llama1b_2l_seed1_q8_0.gguf")
    t0 = time.perf_counter()
    _expect("requantize the copy to q8_0", _tool(tools, ["requantize", str(x), y, "--type", "q8_0"])[0], 0)
    out["requantize_s"] = time.perf_counter() - t0
    _expect("inspect the q8_0 copy", _tool(tools, ["inspect", y])[0], 0)
    os.remove(x)
    out["q8_0"], served = _serve_requantized(torch, kernels_mod, y)
    paths.update(served)
    os.remove(y)
    log(f"  tools: requantize {out['requantize_s']:.1f} s")
    return out, paths


def _serve_requantized(torch, kernels_mod, path) -> tuple[dict, dict]:
    """The Q8_0 copy on the card: every projection and the head a Q8Tensor
    on K6, no K1 or K5 (a decode step launches K6 4 x layers + 1 times);
    prefill and 4 decode steps within TOL of the CPU's plain versions on
    the same file ("A q8_0"); then a paged BatchEngine ("A q8_0 server")."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import decode_step
    from nfai_tpu_torch.ops.qtensor import Q8Tensor
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    kernels_mod.reset_launches()
    engines = {dev: InferenceEngine(path, EngineConfig(max_seq_len=1024), device=dev) for dev in ("cuda", "cpu")}
    e = engines["cuda"]
    lp, n = e.params["layers"], e.model_cfg.n_layers
    mats = {k: type(lp[k]).__name__ for k in ("wqkv", "wo", "w_gate_up", "w_down")}
    if set(mats.values()) != {"Q8Tensor"} or not isinstance(e.params["lm_head"], Q8Tensor) or e.params["fused_mlp"]:
        raise AssertionError(f"the q8_0 copy loaded {mats}, head {type(e.params['lm_head']).__name__}, fused MLP "
                             f"{e.params['fused_mlp']}: not every matmul on K6")
    ids = engines["cpu"].tokenizer.encode("Requantized to Q8_0 by the port's tools, served on the card.")
    out = _parity_run(torch, engines, ids, "q8_0 requantized", False)
    cache = e.new_cache(1)
    _, cache = e.prefill(cache, ids)
    before = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    decode_step(e.params, e.model_cfg, torch.tensor([17], device="cuda"), torch.tensor([len(ids)], device="cuda"),
                cache)
    torch.cuda.synchronize()
    step = {k.name: k.launches - before[k.name] for k in kernels_mod.KERNELS.values()}
    want = {"q8_matmul": 4 * n + 1, "q4_matmul": 0, "fused_mlp": 0, "decode_attention": n, "kv_store": 1}
    got = {k: step[k] for k in want}
    log(f"  q8_0 copy: a decode step launches {got} (the route implies {want})")
    if got != want:
        raise AssertionError(f"the q8_0 copy's decode step launched {got}, not {want}")
    paths = {"A q8_0": _check_route(kernels_mod, "A q8_0", "the requantized q8_0 copy")}
    kernels_mod.reset_launches()
    out["server"] = _paged_server_run(torch, e, "A q8_0")
    paths["A q8_0 server"] = _check_route(kernels_mod, "A q8_0 server", "the q8_0 copy's BatchEngine")
    del engines, e, cache
    torch.cuda.empty_cache()
    return out, paths


def _log_load_times(summary) -> None:
    loads = {k.removeprefix("model "): round(v["load_s"], 2) for k, v in summary.items()
             if k.startswith("model ") and "load_s" in v}
    numpy_loads = {m: round(v["numpy_load_s"], 2) for m, v in summary.get("host_decode", {}).items()
                   if "numpy_load_s" in v}
    log(f"engine load times (InferenceEngine, host clock, synchronised; {os.cpu_count()} host cores): {loads}; "
        f"with the numpy codecs forced: {numpy_loads}")


# ---------------------------------------------------------------------------
# phases: constrained and speculative decoding (on model A's engine)

SMOKE_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
                "required": ["ok", "n"]}
SMOKE_GBNF = 'root ::= ("yes" | "no") " " [0-9]+'
SMOKE_REGEX = r"(ab|cd)+-[0-9]{2}"
# each constraint: SamplingParams fields, and the check its text must pass
CONSTRAINTS = {
    "json": (dict(response_format="json"), lambda t: isinstance(json.loads(t), dict)),
    "json_schema": (dict(response_format="json_schema", json_schema=SMOKE_SCHEMA),
                    lambda t: isinstance(json.loads(t), dict) and {"ok", "n"} <= set(json.loads(t))),
    "gbnf": (dict(grammar=SMOKE_GBNF), lambda t: re.fullmatch(r"(yes|no) [0-9]+", t) is not None),
    "regex": (dict(regex=SMOKE_REGEX), lambda t: re.fullmatch(SMOKE_REGEX, t) is not None),
}
CONSTRAINED_BUDGET = 24  # tokens a constrained request may emit; the closing masks end it within


def _satisfies(name, text) -> bool:
    try:
        return bool(CONSTRAINTS[name][1](text))
    except ValueError:  # json.loads
        return False


def _constrained_generate(torch, engine) -> dict:
    """generate at batch 1, greedy, with each constraint: the text must
    satisfy it; then the host syncs a constrained step, counted with
    torch.cuda.set_sync_debug_mode("warn") over one JSON Schema request
    less its prefill's (one a step: the sampled token's read-back)."""
    import warnings

    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import GenerationMetrics

    ids = engine.tokenizer.encode("Answer in the format you are asked for.")
    t0 = time.perf_counter()
    engine.json_constraint  # the vocabulary-wide index, built once an engine
    out = {"constraint_index_s": time.perf_counter() - t0}
    for name, (fields, _) in CONSTRAINTS.items():
        m = GenerationMetrics()
        _sync(torch)
        t0 = time.perf_counter()
        toks = list(engine.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=CONSTRAINED_BUDGET,
                                                        **fields), metrics=m))
        wall = time.perf_counter() - t0
        text = engine.tokenizer.decode(toks)
        if not _satisfies(name, text):
            raise AssertionError(f"generate with {name}: {text!r} does not satisfy the constraint")
        out[name] = dict(tokens=len(toks), wall_s=wall, ms_per_token=wall * 1e3 / max(len(toks), 1), text=text)
        log(f"  generate {name}: {len(toks)} tokens in {wall:.2f} s ({wall * 1e3 / max(len(toks), 1):.1f} "
            f"ms a token, host masks included): {text!r}")

    def syncs(fn) -> int:  # host syncs while fn runs (torch.cuda.set_sync_debug_mode("warn"))
        _sync(torch)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("called a synchronizing" in str(w.message) for w in caught)

    toks = []
    n_prefill = syncs(lambda: engine.prefill(engine.new_cache(1), ids))
    n_all = syncs(lambda: toks.extend(engine.generate(
        ids, SamplingParams(temperature=0.0, max_new_tokens=CONSTRAINED_BUDGET, **CONSTRAINTS["json_schema"][0]))))
    out["host_syncs_per_step"] = (n_all - n_prefill) / max(len(toks), 1)
    log(f"  host syncs: {n_all} in a {len(toks)}-token JSON Schema request, {n_prefill} of them the prefill's: "
        f"{out['host_syncs_per_step']:.2f} a constrained step (one a step, the token the next mask needs, "
        f"and at most one a request to set up)")
    if not len(toks) <= n_all - n_prefill <= len(toks) + 1:
        raise AssertionError(f"{n_all - n_prefill} host syncs for {len(toks)} constrained steps")
    return out


def _constrained_batch_engine(torch, engine) -> dict:
    """The paged BatchEngine at batch 8: the four constraints beside four
    plain slots (two greedy, two sampled); one-step chunks with a [8, V]
    mask while a constrained slot runs. Every constrained text must
    satisfy its constraint."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState

    rng = torch.Generator().manual_seed(21)
    prompts = [torch.randint(300, 5000, (n,), generator=rng).tolist() for n in (20, 60, 110, 170, 40, 90, 140, 230)]
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=CONSTRAINED_BUDGET, **f)
                for f, _ in CONSTRAINTS.values()]
    sampling += [SamplingParams(temperature=0.0, max_new_tokens=32)] * 2 + [
        SamplingParams(temperature=0.8, top_k=40, max_new_tokens=32, seed=i) for i in range(2)]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    _sync(torch)
    t0 = time.perf_counter()
    reqs = [be.submit(p, s) for p, s in zip(prompts, sampling)]
    _drive(be, reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    for name, r in zip(CONSTRAINTS, reqs):
        text = engine.tokenizer.decode(r.output_ids)
        if r.state != RequestState.FINISHED or not _satisfies(name, text):
            raise AssertionError(f"BatchEngine {name} slot ({r.state}): {text!r} does not satisfy it")
    if any(not 0 < len(r.output_ids) <= 32 for r in reqs[4:]):
        raise AssertionError(f"plain slots: {[len(r.output_ids) for r in reqs[4:]]} tokens")
    texts = [engine.tokenizer.decode(r.output_ids) for r in reqs[:4]]
    log(f"  BatchEngine (paged, batch 8: 4 constrained, 4 plain): {sum(len(r.output_ids) for r in reqs)} tokens "
        f"in {wall:.2f} s; constrained texts {texts}")
    return dict(wall_s=wall, tokens=sum(len(r.output_ids) for r in reqs), texts=texts)


def phase_constrained(torch, engine, kernels_mod) -> tuple[dict, dict]:
    """Constrained decoding on model A's engine: "A constrained" (generate
    with JSON, a JSON Schema, a GBNF grammar and a regex; the host syncs a
    constrained step), "A constrained server" (the paged BatchEngine at
    batch 8 mixing constrained and plain slots). Returns (results,
    launches by path)."""
    out, paths = {}, {}
    kernels_mod.reset_launches()
    out["generate"] = _constrained_generate(torch, engine)
    paths["A constrained"] = _check_route(kernels_mod, "A constrained", "model A's constrained generate")
    kernels_mod.reset_launches()
    out["batch_engine"] = _constrained_batch_engine(torch, engine)
    paths["A constrained server"] = _check_route(kernels_mod, "A constrained server",
                                                 "model A's constrained BatchEngine")
    return out, paths


SPEC_PROMPT = "Repeat after me: one two three four, one two three four, one two three four, one two"
SPEC_NEW = 128  # tokens a batch-1 speculative request emits
# model A's bf16 routes on the card (the verify forward at T = 9, decode
# steps, one prefill chunk) against each other: max|a - b| in a row within
# PATH_TOL of the row's max|logit|. Set from an H100's readings (PERF.md §6,
# PR 20): 4.3-6.0e-2 between any two of them.
PATH_TOL = 8e-2
# each route against the CPU's f32 forward of the same model, its weights
# dequantized exactly at load (the same H100's readings: 5.8-7.1e-2 on
# model A's 16 layers, 2.1-2.6e-2 on the 2-layer copy) ...
EXACT_TOL = {16: 9e-2, 2: 3.5e-2}  # by depth
# ... and the verify no farther from it than the decode steps, within a
# quarter (read: 0.94-1.07 times)
EXACT_RATIO = 1.25


def _with_config(engine, **changes):
    """The engine with other EngineConfig fields, sharing its loaded weights
    (a shallow copy: speculative decoding reads only the config)."""
    import copy

    e = copy.copy(engine)
    e.config = dataclasses.replace(engine.config, **changes)
    e._draft_engine = None
    return e


class _VerifyProbe:
    """While installed, records each verify forward the speculative rounds
    run (`models.llama._verify_forward`, which `spec_decode_rounds` and
    `draft_spec_rounds` look up every round): its [B, T] and the kernel
    launches it made, from the launch counters before and after (host
    integers: no sync). It computes nothing itself."""

    def __init__(self, kernels_mod):
        self.kernels = kernels_mod.KERNELS
        self.calls = []

    def _counts(self) -> dict:
        return {k.name: k.launches for k in self.kernels.values()}

    def __enter__(self):
        from nfai_tpu_torch.models import llama

        inner = self._inner = llama._verify_forward

        def probe(params, cfg, tin, *args):
            before = self._counts()
            out = inner(params, cfg, tin, *args)
            self.calls.append((tuple(tin.shape), {k: v - before[k] for k, v in self._counts().items()
                                                   if v != before[k]}))
            return out

        llama._verify_forward = probe
        return self

    def __exit__(self, *exc):
        from nfai_tpu_torch.models import llama

        llama._verify_forward = self._inner

    def check(self, what, n_layers, t, store, min_calls) -> dict:
        """Every verify forward ran T = t tokens a lane and launched K4,
        K5 and the store (`store`, chunk mode) once a layer and K1
        2 n_layers + 1 times (wqkv and wo a layer, the head), nothing
        else; at least `min_calls` of them (the drafted tokens over gamma
        and the lanes)."""
        want = {"prefill_attention": n_layers, "fused_mlp": n_layers, store: n_layers,
                "q4_matmul": 2 * n_layers + 1}
        bad = [(shape, d) for shape, d in self.calls if shape[1] != t or d != want]
        batches = sorted({shape[0] for shape, _ in self.calls})
        log(f"  {what}: {len(self.calls)} verify forwards at T = {t} (B {batches}; at least {min_calls} from "
            f"the drafted tokens), each launching {want}")
        if bad or len(self.calls) < min_calls:
            raise AssertionError(f"{what}: {len(self.calls)} verify forwards (at least {min_calls}); these "
                                 f"differ from [B, {t}] and {want}: {bad[:3]}")
        return dict(verify_forwards=len(self.calls), per_verify=want, batches=batches)


def _prefill_k4(kernels_mod, engine, ids) -> int:
    """K4 launches of one prefill of `ids` (a window of its own)."""
    kernels_mod.reset_launches()
    engine.prefill(engine.new_cache(1), ids)
    return kernels_mod.KERNELS["prefill_attention"].launches


def _gaps(entries) -> list:
    """The top-two logit gap of each step of a plain stream, from its
    logprob entries (top 2)."""
    return [e["top"][0][1] - e["top"][1][1] for e in entries]


def _tie_prefix(name, got, plain, gaps, margin) -> tuple[int, float]:
    """`got` against the plain greedy stream `plain` (`gaps`: its top-two
    logit gap at each step): they may part only at a step where that gap is
    below `margin` (the verify's and the decode step's matmuls run at other
    M and may round a near-tie apart). Returns (the step where they part,
    or their length, and the gap there); logs it beside the plain stream's
    first step under the margin."""
    first_tie = next((i for i, g in enumerate(gaps) if g < margin), len(plain))
    part = next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b), min(len(got), len(plain)))
    if part < min(len(got), len(plain)) and not gaps[part] < margin:
        raise AssertionError(f"{name}: token {part} is {got[part]}, plain greedy's {plain[part]}, where the plain "
                             f"stream's top-two gap is {gaps[part]:.4f} >= {margin:.4f}")
    if part == min(len(got), len(plain)) and len(got) != len(plain):
        raise AssertionError(f"{name}: {len(got)} tokens against plain greedy's {len(plain)}")
    gap = gaps[part] if part < len(gaps) else float("nan")
    log(f"  {name}: equals plain greedy for {part} of {len(plain)} tokens"
        + (f", parting at a near-tie (gap {gap:.4f} < {margin:.4f})" if part < len(plain) else "")
        + f"; the plain stream's first gap under the margin is at step {first_tie}")
    return part, gap


def _teacher_force(torch, engine, name, prompt, got) -> dict:
    """Every token of the greedy stream `got` against one prefill chunk of
    prompt + got (`verify_step`: the logits at every position): its logit
    must lie within 2 PATH_TOL x the row's max|logit| of the row's top (the
    stream's own logits came from other routes, each within PATH_TOL of
    this one, so its argmax lies at most twice that below). Returns the
    deepest a token lies below the top, relative to the row's scale, and
    how many tokens are not the row's argmax."""
    from nfai_tpu_torch.models.llama import verify_step

    ids = list(prompt) + list(got)
    dev = engine.device
    logits, _ = verify_step(engine.params, engine.model_cfg, torch.tensor([ids], device=dev),
                            torch.arange(len(ids), device=dev)[None], engine.new_cache(1))
    rows = logits[0, len(prompt) - 1:len(ids) - 1]  # row i predicts got[i]
    chosen = rows.gather(1, torch.tensor(got, device=dev)[:, None])[:, 0]
    depth = ((rows.amax(1) - chosen) / rows.abs().amax(1)).cpu()
    res = dict(worst_depth=float(depth.max()), not_argmax=int((depth > 0).sum()), tokens=len(got))
    del logits, rows
    log(f"  {name}: all {len(got)} tokens teacher-forced through one {len(ids)}-token prefill chunk: "
        f"{res['not_argmax']} are not its argmax, the deepest {res['worst_depth']:.4f} x the row's scale below "
        f"the top (limit {2 * PATH_TOL:g})")
    if not res["worst_depth"] <= 2 * PATH_TOL:
        raise AssertionError(f"{name}: a token lies {res['worst_depth']:.4f} x the row's scale below the "
                             f"teacher-forced top, past {2 * PATH_TOL:g}")
    return res


def _rotations(engine) -> list:
    """8 prompts of one loop: rotations of SPEC_PROMPT's ids by 3."""
    base = engine.tokenizer.encode(SPEC_PROMPT)
    return [base[i:] + base[:i] for i in range(0, 8 * 3, 3)]


def _seeded_rounds(torch, engine, kernels_mod) -> dict:
    """`spec_decode_rounds` at batch 8 on model A's dense cache, lane 7
    frozen: its accepted-draft branch (the multi-token commit, the history
    scatter, positions moving by more than one) at full width. Prompt
    lookup accepts nothing on a random-weight model, which repeats nothing
    and does not reproduce its own output after prompt + output + prompt
    (PERF.md §6, PR 20), so each lane's lookup history is seeded: its
    prompt's last two tokens and its own plain greedy continuation G
    (`decode_loop` on the same prompts) ahead of the prompt, the lookup
    then drafts G. Calls of spec_rounds rounds, read back once each, until
    every live lane has SPEC_NEW tokens: drafts must be accepted, each
    live lane's stream equal G up to a near-tie and hold under teacher
    forcing, the frozen lane's K/V rows stay as they were, and each verify
    forward launches what `_VerifyProbe.check` names."""
    from nfai_tpu_torch.models import decode_loop, prefill_step
    from nfai_tpu_torch.models.llama import spec_decode_rounds

    cfg, params, dev = engine.model_cfg, engine.params, engine.device
    gamma, rounds, ngram = engine.config.spec_tokens, engine.config.spec_rounds, engine.config.spec_ngram
    prompts = _rotations(engine)
    b, n, s_max = len(prompts), len(prompts[0]), engine.max_seq_len

    def prefilled():
        return prefill_step(params, cfg, torch.tensor(prompts, device=dev),
                            torch.arange(n, device=dev)[None].expand(b, n), torch.full((b,), n - 1, device=dev),
                            engine.new_cache(b))

    logits, cache = prefilled()
    first = logits.argmax(-1)
    top0 = logits.topk(2, dim=-1).values
    scale = float(logits.abs().max())
    plain, _, cache, _, _, _, top_lps = decode_loop(params, cfg, first, torch.full((b,), n, device=dev), cache,
                                                   None, SPEC_NEW, temperature=0.0, n_logprobs=2)
    gaps = torch.cat([top0[:, :1] - top0[:, 1:], top_lps[:, :-1, 0] - top_lps[:, :-1, 1]], 1).tolist()
    plain = plain.tolist()
    del cache
    _, cache = prefilled()
    frozen = (cache.k[:, -1].clone(), cache.v[:, -1].clone())
    hist = torch.zeros(b, s_max, dtype=torch.int64)
    hlen = torch.zeros(b, dtype=torch.int64)
    for lane, (p, g) in enumerate(zip(prompts, plain)):
        row = p[-2:] + g + p + g[:1]  # ends with the pending token, as the engine's history does
        hist[lane, :len(row)] = torch.tensor(row)
        hlen[lane] = len(row)
    tok, pos, hist, hlen = first, torch.full((b,), n, device=dev), hist.to(dev), hlen.to(dev)
    active = torch.arange(b, device=dev) < b - 1
    streams, drafted, accepted, calls = [[] for _ in range(b)], 0, 0, 0
    with _VerifyProbe(kernels_mod) as probe:
        while min(len(x) for x in streams[:-1]) < SPEC_NEW and calls < 2 * SPEC_NEW:
            outs, ocnt, tok, pos, cache, hist, hlen, active, dr, ac = spec_decode_rounds(
                params, cfg, tok, pos, cache, hist, hlen, engine._eos_tensor(), active, rounds, gamma, ngram)
            host = torch.cat([outs, torch.stack([ocnt, active.long(), dr, ac], 1)], 1).tolist()  # one read-back
            calls += 1
            for lane, row in enumerate(host):
                streams[lane] += row[:row[-4]]
                drafted, accepted = drafted + row[-2], accepted + row[-1]
            if not any(row[-3] for row in host):
                break
    verifies = probe.check("seeded spec_decode_rounds", cfg.n_layers, gamma + 1, "kv_store",
                           -(-drafted // (gamma * (b - 1))))
    if not (torch.equal(cache.k[:, -1], frozen[0]) and torch.equal(cache.v[:, -1], frozen[1])):
        raise AssertionError("seeded spec_decode_rounds: the frozen lane's K/V rows changed")
    out = dict(drafted=drafted, accepted=accepted, acceptance=accepted / max(drafted, 1), calls=calls,
               tokens_per_verify=(accepted + drafted / gamma) / max(drafted / gamma, 1), verify_launches=verifies)
    log(f"  seeded spec_decode_rounds, batch 8 (lane 7 frozen): {drafted} drafted, {accepted} accepted "
        f"({out['acceptance']:.3f}), {out['tokens_per_verify']:.2f} tokens a lane's verify, {calls} read-backs; "
        f"the frozen lane's K/V rows unchanged")
    if accepted <= 0 or any(len(x) < SPEC_NEW for x in streams[:-1]) or streams[-1]:
        raise AssertionError(f"seeded spec_decode_rounds: {accepted} accepted, streams of "
                             f"{[len(x) for x in streams]} tokens")
    out["equal_prefix"] = [_tie_prefix(f"seeded lane {lane}", streams[lane][:SPEC_NEW], plain[lane], gaps[lane],
                                       TOL * scale) for lane in range(b - 1)]
    out["teacher_forced"] = [_teacher_force(torch, engine, f"seeded lane {lane}", prompts[lane],
                                            streams[lane][:SPEC_NEW]) for lane in range(b - 1)]
    return out


def _spec_generate(torch, engine, kernels_mod, draft_path, ids) -> tuple[dict, dict]:
    """Batch 1, greedy, on the prompt `ids`: plain greedy
    (the reference, and timed), then speculative="ngram", "draft" (the
    2-layer copy of model A's widths and vocabulary at `draft_path`) and
    "draft" with model A as its own draft (the acceptance machinery's upper
    bound: a random-weight model agrees with no other), then a sampled
    ngram request (temperature 0.8). Each greedy stream may part from plain
    greedy only at a near-tie (gap < TOL x the logit scale), and every one
    of its tokens holds under teacher forcing (`_teacher_force`). The
    launch counts are zeroed just before the timed
    speculative requests and read just after (the plain runs, the draft's
    load and the warm-ups stay outside): each verify forward's own launches
    (`_VerifyProbe`), and K4's in all equal n_layers a verify plus the
    prefills'. Returns (results, the window's launches)."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import GenerationMetrics

    greedy = SamplingParams(temperature=0.0, max_new_tokens=SPEC_NEW)
    sampled = SamplingParams(temperature=0.8, top_k=40, seed=3, max_new_tokens=64)
    m = GenerationMetrics()
    plain = list(engine.generate(ids, dataclasses.replace(greedy, logprobs=2), metrics=m))
    entries = m.logprobs
    scale = float(engine.prefill(engine.new_cache(1), ids)[0].abs().max())
    margin = TOL * scale
    walls = []
    for _ in range(2):  # the second is timed
        pm = GenerationMetrics()
        _sync(torch)
        t0 = time.perf_counter()
        list(engine.generate(ids, greedy, metrics=pm))
        _sync(torch)
        walls.append(time.perf_counter() - t0)
    out = {"prompt_tokens": len(ids), "plain": dict(tokens=pm.new_tokens, wall_s=walls[-1],
                                                     tok_s=pm.new_tokens / walls[-1],
                                                     decode_tok_s=pm.decode_tokens_per_s),
           "logit_scale": scale, "tie_margin": margin}
    log(f"  plain greedy, batch 1, {len(ids)}-token prompt: {pm.new_tokens} tokens in {walls[-1]:.3f} s = "
        f"{pm.new_tokens / walls[-1]:.1f} tok/s (decode {pm.decode_tokens_per_s:.1f})")
    gamma, n_layers = engine.config.spec_tokens, engine.model_cfg.n_layers
    engines = {"ngram": _with_config(engine, speculative="ngram"),
               "draft": _with_config(engine, speculative="draft", draft_gguf=str(draft_path)),
               "draft (self)": _with_config(engine, speculative="draft", draft_gguf=str(draft_path))}
    t0 = time.perf_counter()
    draft = engines["draft"].draft_engine  # loaded on first use
    out["draft_load_s"] = time.perf_counter() - t0
    engines["draft (self)"]._draft_engine = engine  # model A drafts for itself
    k4_prefill = {"A": _prefill_k4(kernels_mod, engine, ids), "draft": _prefill_k4(kernels_mod, draft, ids)}
    runs = [(label, greedy) for label in engines] + [("ngram", sampled)]
    for label, sp in runs:  # warm-ups, outside the window
        list(engines[label].generate(ids, sp))
    got, metrics, walls, k4_want = {}, {}, {}, 0
    kernels_mod.reset_launches()
    with _VerifyProbe(kernels_mod) as probe:
        for label, sp in runs:
            key = label if sp is greedy else "ngram_sampled"
            metrics[key] = GenerationMetrics()
            _sync(torch)
            t0 = time.perf_counter()
            got[key] = list(engines[label].generate(ids, sp, metrics=metrics[key]))
            _sync(torch)
            walls[key] = time.perf_counter() - t0
            k4_want += k4_prefill["A"] + (k4_prefill["draft"] if label == "draft" else 0) + (
                k4_prefill["A"] if label == "draft (self)" else 0)
    window = _check_route(kernels_mod, "A spec", "model A's speculative generate (timed runs)")
    drafted = sum(mm.spec_drafted for mm in metrics.values())
    out["verify_launches"] = probe.check("A spec", n_layers, gamma + 1, "kv_store", -(-drafted // gamma))
    k4_want += n_layers * len(probe.calls)
    if window["prefill_attention"] != k4_want:
        raise AssertionError(f"A spec: K4 launched {window['prefill_attention']} times, not {k4_want} "
                             f"({n_layers} a verify forward and the prefills' {k4_prefill})")
    log(f"  A spec: K4 launched {window['prefill_attention']} times = {n_layers} x {len(probe.calls)} verify "
        f"forwards + the prefills' ({k4_prefill} a prefill)")
    for label in engines:
        sm, toks, wall = metrics[label], got[label], walls[label]
        tie, gap = _tie_prefix(f"speculative={label!r} greedy", toks, plain, _gaps(entries), margin)
        forced = _teacher_force(torch, engine, f"speculative={label!r} greedy", ids, toks)
        verifies = sm.spec_drafted / gamma
        res = dict(tokens=len(toks), wall_s=wall, tok_s=len(toks) / wall, drafted=sm.spec_drafted,
                   accepted=sm.spec_accepted, acceptance=sm.spec_accepted / max(sm.spec_drafted, 1),
                   verify_forwards=verifies, tokens_per_verify=(sm.spec_accepted + verifies) / max(verifies, 1),
                   equal_prefix=tie, tie_gap=gap, teacher_forced=forced,
                   speedup=(len(toks) / wall) / out["plain"]["tok_s"])
        out[label] = res
        log(f"  speculative={label!r}, batch 1: {len(toks)} tokens in {wall:.3f} s = {res['tok_s']:.1f} tok/s "
            f"(x{res['speedup']:.2f} plain); {sm.spec_drafted} drafted, {sm.spec_accepted} accepted "
            f"({res['acceptance']:.3f}); {verifies:.0f} verify forwards, {res['tokens_per_verify']:.2f} "
            f"tokens a verify")
        if sm.spec_drafted <= 0:
            raise AssertionError(f"speculative={label!r} drafted nothing")
    sm = metrics["ngram_sampled"]
    if not got["ngram_sampled"] or sm.spec_drafted <= 0:
        raise AssertionError(f"sampled speculation: {len(got['ngram_sampled'])} tokens, {sm.spec_drafted} drafted")
    out["ngram_sampled"] = dict(tokens=len(got["ngram_sampled"]), drafted=sm.spec_drafted,
                                accepted=sm.spec_accepted)
    log(f"  speculative='ngram' at temperature 0.8: {len(got['ngram_sampled'])} tokens, {sm.spec_drafted} "
        f"drafted, {sm.spec_accepted} accepted (rejection sampling)")
    return out, window


def _verify_case(torch, engine, b, t, dev, seed):
    """A batch-b cache after 128-token prompts on `dev`, and a verify of t
    tokens a row at ragged positions (at b > 1 the last lane frozen):
    (prompts, cache, tin, pos, act), made from one seed on every device."""
    from nfai_tpu_torch.models import prefill_step

    gen = torch.Generator().manual_seed(seed)
    prompts = torch.randint(300, 5000, (b, 128), generator=gen).to(dev)
    cache = engine.new_cache(b)
    _, cache = prefill_step(engine.params, engine.model_cfg, prompts,
                            torch.arange(128, device=dev)[None].expand(b, 128),
                            torch.full((b,), 127, device=dev), cache)
    tin = torch.randint(300, 5000, (b, t), generator=gen).to(dev)
    pos = torch.tensor([128 - 5 * (i % 4) for i in range(b)], device=dev)
    act = torch.ones(b, dtype=torch.bool, device=dev)
    act[-1] = b == 1
    return prompts, cache, tin, pos, act


def _held(name, rel, tol) -> float:
    log(f"  {name}: rel err {rel:.3e} (worst row; limit {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"{name}: rel err {rel:.3e} exceeds {tol:g}")
    return rel


def _verify_shapes(torch, engine, a_path, copy_path) -> dict:
    """The verify forward (`_verify_forward`, T = spec_tokens + 1) at batch
    1 and 8 after 128-token prompts, ragged positions, at batch 8 one lane
    frozen: no host sync, the frozen lane's cache rows unchanged, finite
    logits, its device ms against one decode step's (the profiler's
    tally). Its logits against three other computations of the same rows
    (worst row of max|a - b| / max|b|): on model A at batch 1, the card's
    decode steps (the same tokens one step at a time) and one prefill chunk
    of prompt + tokens, each within PATH_TOL of the others, and the CPU's
    f32 forward with the weights dequantized exactly at load, each route
    within EXACT_TOL of it and the verify within EXACT_RATIO of the decode
    steps' distance (the witness of where the card's routes part: each
    rounds in bf16, and that grows over the layers); at batch 8 the decode
    steps within PATH_TOL; on the 2-layer copy at `copy_path` the verify
    and the decode steps against the CPU's f32 plain versions, the same
    way."""
    from torch.profiler import ProfilerActivity, profile

    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models import decode_step
    from nfai_tpu_torch.models.llama import _verify_forward, verify_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    t = engine.config.spec_tokens + 1
    torch.set_num_threads(os.cpu_count() or 8)
    t0 = time.perf_counter()
    cpu = {"A": InferenceEngine(a_path, EngineConfig(max_seq_len=1024, dtype="float32", param_dtype="float32"),
                                device="cpu"),
           "2-layer copy": InferenceEngine(copy_path, EngineConfig(max_seq_len=1024, dtype="float32"),
                                           device="cpu")}
    out = {"cpu_load_s": time.perf_counter() - t0}
    copy_card = InferenceEngine(copy_path, EngineConfig(max_seq_len=1024), device="cuda")
    for b in (1, 8):
        for name, e in (("A", engine), ("2-layer copy", copy_card)):
            cfg = e.model_cfg
            prompts, cache, tin, pos, act = _verify_case(torch, e, b, t, "cuda", seed=b)
            frozen = cache.k[:, -1].clone()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits = _verify_forward(e.params, cfg, tin, pos, act, cache, None)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if b > 1 and not torch.equal(cache.k[:, -1], frozen):
                raise AssertionError(f"{name}: the verify forward wrote K/V rows of a frozen lane")
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{name}: the verify forward's logits are not finite")
            live = slice(0, b if b == 1 else b - 1)
            steps = []
            for j in range(t):  # the same tokens, one decode step each (the frozen lane past the cache)
                p = torch.where(act, pos + j, torch.full_like(pos, cache.max_seq))
                steps.append(decode_step(e.params, cfg, tin[:, j], p, cache)[0])
            routes = {"verify": logits[live], "decode steps": torch.stack(steps, 1)[live]}
            res = out.setdefault(f"{name} B={b}", {})
            tag = f"{name} B={b} T={t}"
            if name == "A" and b == 1:  # one prefill chunk of prompt + tokens: its last t rows
                whole = torch.cat([prompts, tin], 1)
                routes["prefill chunk"] = verify_step(e.params, cfg, whole, torch.arange(whole.shape[1],
                                                      device="cuda")[None], e.new_cache(1))[0][:, -t:]
            pairs = [(a, c) for i, a in enumerate(routes) for c in list(routes)[i + 1:]]
            for a, c in pairs if name == "A" else ():
                res[f"{a} vs {c}"] = _held(f"{tag} {a} against {c}", errors(routes[a], routes[c], 2)[1],
                                           PATH_TOL)
            if b == 1 or name != "A":  # the CPU's f32 forward of the same case
                ce = cpu[name]
                _, ccache, ctin, cpos, cact = _verify_case(torch, ce, b, t, "cpu", seed=b)
                want = _verify_forward(ce.params, ce.model_cfg, ctin, cpos, cact, ccache, None)[live]
                for r, got in routes.items():
                    res[f"{r} vs cpu f32"] = _held(f"{tag} {r} against the CPU's f32", errors(got, want, 2)[1],
                                                   EXACT_TOL[cfg.n_layers])
                ratio = res["verify vs cpu f32"] / res["decode steps vs cpu f32"]
                log(f"  {tag}: the verify {ratio:.3f} times as far from the CPU's f32 as the decode steps "
                    f"(limit {EXACT_RATIO:g})")
                if not ratio <= EXACT_RATIO:
                    raise AssertionError(f"{tag}: the verify is {ratio:.3f} times as far from the CPU's f32 "
                                         f"forward as the decode steps")
                del ccache, want
            if name != "A":
                continue
            walls, ms = {}, {}
            for kind, fn in (("verify", lambda: _verify_forward(e.params, cfg, tin, pos, act, cache, None)),  # noqa: B023
                             ("decode", lambda: decode_step(e.params, cfg, tin[:, 0], pos, cache))):  # noqa: B023
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(3):
                        fn()
                    torch.cuda.synchronize()
                    walls[kind] = (time.perf_counter() - t0) * 1e3 / 3
                ms[kind] = sum(v for v, _ in _kernel_table(prof).values()) / 3
                if ms[kind] <= 0:
                    raise AssertionError("the profiler saw no device time")
            res.update(verify_device_ms=ms["verify"], decode_device_ms=ms["decode"], verify_wall_ms=walls["verify"],
                       decode_wall_ms=walls["decode"], verify_over_decode=ms["verify"] / ms["decode"])
            log(f"  verify forward B={b} T={t}: device {ms['verify']:.3f} ms (wall {walls['verify']:.2f}) against one "
                f"decode step {ms['decode']:.3f} ms (wall {walls['decode']:.2f}): x{ms['verify'] / ms['decode']:.2f} "
                f"for {t} tokens a row")
            del cache, routes
    del cpu, copy_card
    return out


def _spec_batch_engine(torch, engine, kernels_mod, prompts) -> tuple[dict, dict]:
    """The paged BatchEngine at batch 8 with speculative="ngram" on
    `prompts`: four greedy slots and four sampled at temperature 0.8
    speculate together. The
    launch counts are zeroed just before and read just after, with each
    verify forward's own (`_VerifyProbe`). Then, outside that window, each
    greedy slot against plain greedy generate (parting only at a near-tie)
    and under teacher forcing. Returns (results, the window's launches)."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import GenerationMetrics
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState

    sampling = [SamplingParams(temperature=0.0, max_new_tokens=64)] * 4 + [
        SamplingParams(temperature=0.8, top_k=40, max_new_tokens=64, seed=i) for i in range(4)]
    be = BatchEngine(_with_config(engine, speculative="ngram"), max_batch=8, decode_chunk=8, paged=True)
    kernels_mod.reset_launches()
    with _VerifyProbe(kernels_mod) as probe:
        _sync(torch)
        t0 = time.perf_counter()
        reqs = [be.submit(p, s) for p, s in zip(prompts, sampling)]
        _drive(be, reqs)
        _sync(torch)
        wall = time.perf_counter() - t0
    window = _check_route(kernels_mod, "A spec server", "model A's speculative BatchEngine")
    if any(r.state != RequestState.FINISHED or not r.output_ids for r in reqs) or be.spec_drafted <= 0:
        raise AssertionError(f"spec BatchEngine: {[(r.state, len(r.output_ids)) for r in reqs]}, "
                             f"{be.spec_drafted} drafted, {be.spec_accepted} accepted")
    gamma = engine.config.spec_tokens
    n_out = sum(len(r.output_ids) for r in reqs)
    out = dict(wall_s=wall, tokens=n_out, tok_s=n_out / wall, drafted=be.spec_drafted, accepted=be.spec_accepted,
               acceptance=be.spec_accepted / be.spec_drafted,
               verify_launches=probe.check("A spec server", engine.model_cfg.n_layers, gamma + 1,
                                           "kv_store_paged", -(-be.spec_drafted // (gamma * 8))))
    log(f"  BatchEngine speculative='ngram' (paged, batch 8: 4 greedy, 4 at temperature 0.8): {n_out} tokens in "
        f"{wall:.2f} s = {n_out / wall:.1f} tok/s; {be.spec_drafted} drafted, {be.spec_accepted} accepted "
        f"({out['acceptance']:.3f})")
    scale = float(engine.prefill(engine.new_cache(1), prompts[0])[0].abs().max())
    ties, forced = [], []
    for i, (p, r) in enumerate(zip(prompts[:4], reqs)):
        m = GenerationMetrics()
        plain = list(engine.generate(p, SamplingParams(temperature=0.0, max_new_tokens=64, logprobs=2), metrics=m))
        ties.append(_tie_prefix(f"BatchEngine speculative slot {i}", r.output_ids, plain, _gaps(m.logprobs),
                                TOL * scale))
        forced.append(_teacher_force(torch, engine, f"BatchEngine speculative slot {i}", p, r.output_ids))
    out.update(greedy_equal_prefix=ties, teacher_forced=forced)
    return out, window


def phase_spec(torch, engine, kernels_mod, a_path) -> tuple[dict, dict]:
    """Speculative decoding on model A's engine (GGUF at `a_path`): "A
    spec" (generate with speculative="ngram" and "draft" at batch 1 against
    plain greedy, a sampled request; its window holds the timed speculative
    requests only), "A spec server" (the paged BatchEngine at batch 8 with
    greedy and sampled slots speculating together), then outside every
    window `spec_decode_rounds` with seeded lookup histories (its accepted
    drafts at full width) and the verify forward's shapes against other
    routes and the CPU (`_verify_shapes`). The draft is
    `make_llama_1b_gguf(kind="q4_k", n_layers=2)`: model A's widths and
    vocabulary, 2 layers. Returns (results, launches by path)."""
    from nfai_tpu_torch.testing import make_llama_1b_gguf

    out, paths = {}, {}
    t0 = time.perf_counter()
    draft = make_llama_1b_gguf(os.path.join(os.path.dirname(a_path), "llama1b_2l_draft.gguf"), kind="q4_k",
                               n_layers=2)
    out["draft_write_s"] = time.perf_counter() - t0
    prompts = _rotations(engine)
    out["generate"], paths["A spec"] = _spec_generate(torch, engine, kernels_mod, draft, prompts[0])
    out["batch_engine"], paths["A spec server"] = _spec_batch_engine(torch, engine, kernels_mod, prompts)
    out["seeded_rounds"] = _seeded_rounds(torch, engine, kernels_mod)
    out["verify"] = _verify_shapes(torch, engine, a_path, draft)
    os.remove(draft)
    return out, paths


# ---------------------------------------------------------------------------


# kernels each main path must launch, and those its route must not
INT8 = {"decode_attention_i8", "prefill_attention_i8", "paged_attention_i8"}
# K3 and K10 in their own contracts: off every route, the store writes the rows
OLD_WRITES = {"kv_write", "kv_write_t"}
# the q8v3 and head-major kernels, off every route but model E's: K12 and K4's
# head-major entry points
Q8V3_HM = {"q8v3_matmul", "prefill_attention_hm", "prefill_attention_hm_i8"}
ROUTES = {
    "A": ({"q4_matmul", "decode_attention", "kv_store", "prefill_attention", "fused_mlp"},
          {"q8_matmul", "paged_attention", "grouped_q4", "grouped_q8", "kv_store_paged"} | INT8),
    "A8": ({"q4_matmul", "fused_mlp", "decode_attention_i8", "kv_store", "prefill_attention_i8"},
           {"decode_attention", "prefill_attention", "paged_attention", "paged_attention_i8",
            "q8_matmul", "grouped_q4", "grouped_q8", "kv_store_paged"}),
    # model A's 512-token eval windows: the prefill path on a bf16 and an
    # int8 cache (K4 and K4-i8), the head at M = 512 on K1's tiles; no decode
    "A eval": ({"q4_matmul", "fused_mlp", "kv_store", "prefill_attention", "prefill_attention_i8"},
               {"decode_attention", "decode_attention_i8", "paged_attention", "paged_attention_i8",
                "q8_matmul", "grouped_q4", "grouped_q8", "kv_store_paged"}),
    "B": ({"q4_matmul", "decode_attention", "kv_store", "prefill_attention", "q8_matmul"},
          {"fused_mlp", "paged_attention", "grouped_q4", "grouped_q8", "kv_store_paged"} | INT8),
    "server": ({"q4_matmul", "paged_attention", "prefill_attention", "fused_mlp", "kv_store_paged"},
               {"decode_attention", "kv_store", "q8_matmul", "grouped_q4", "grouped_q8"} | INT8),
    "A8 server": ({"q4_matmul", "fused_mlp", "paged_attention_i8", "prefill_attention", "kv_store_paged"},
                  {"decode_attention", "decode_attention_i8", "kv_store", "prefill_attention_i8",
                   "paged_attention", "q8_matmul", "grouped_q4", "grouped_q8"}),
    "C": ({"q4_matmul", "q8_matmul", "decode_attention", "kv_store", "prefill_attention",
           "grouped_q4", "grouped_q8"}, {"fused_mlp", "paged_attention", "kv_store_paged"} | INT8),
    "C server": ({"q4_matmul", "q8_matmul", "paged_attention", "prefill_attention", "kv_store_paged",
                  "grouped_q4", "grouped_q8"}, {"decode_attention", "kv_store", "fused_mlp"} | INT8),
    # model G: K1 for Q4_K, K6 for the Q6_K attn_v / ffn_down and the tied head;
    # no K5 (K = 2304 is not a multiple of 1024, and down mixes kinds)
    "G": ({"q4_matmul", "q8_matmul", "decode_attention", "kv_store", "prefill_attention"},
          {"fused_mlp", "paged_attention", "grouped_q4", "grouped_q8", "kv_store_paged"} | INT8),
    "G server": ({"q4_matmul", "q8_matmul", "paged_attention", "prefill_attention", "kv_store_paged"},
                 {"decode_attention", "kv_store", "fused_mlp", "grouped_q4", "grouped_q8"} | INT8),
    # model D: every matmul weight dense (K11), the tied head torch.matmul
    "D": ({"dense_matmul", "decode_attention", "kv_store", "prefill_attention"},
          {"q4_matmul", "q8_matmul", "fused_mlp", "paged_attention", "grouped_q4", "grouped_q8",
           "kv_store_paged"} | INT8),
    "D server": ({"dense_matmul", "paged_attention", "prefill_attention", "kv_store_paged"},
                 {"decode_attention", "kv_store", "q4_matmul", "q8_matmul", "fused_mlp",
                  "grouped_q4", "grouped_q8"} | INT8),
    # model E under NFAI_Q8V3=1: K12 for every projection and the head; K4-hm
    # for prefill ("headmajor"), never K4 "full"
    "E": ({"q8v3_matmul", "decode_attention", "kv_store", "prefill_attention_hm"},
          {"q4_matmul", "q8_matmul", "fused_mlp", "dense_matmul", "prefill_attention",
           "paged_attention", "grouped_q4", "grouped_q8", "prefill_attention_hm_i8",
           "kv_store_paged"} | INT8),
    # E8: model E's GGUF on an int8 cache: K4-hm's int8 entry point, K2-i8, the int8 store
    "E8": ({"q8v3_matmul", "decode_attention_i8", "kv_store", "prefill_attention_hm_i8"},
           {"q4_matmul", "q8_matmul", "fused_mlp", "dense_matmul", "decode_attention",
            "prefill_attention", "prefill_attention_i8", "prefill_attention_hm",
            "paged_attention", "paged_attention_i8", "grouped_q4", "grouped_q8", "kv_store_paged"}),
    # E server ("merged"): K7 at decode, K4's merged-lane instance on the gathered pages
    "E server": ({"q8v3_matmul", "paged_attention", "prefill_attention", "kv_store_paged"},
                 {"decode_attention", "kv_store", "q4_matmul", "q8_matmul", "fused_mlp",
                  "dense_matmul", "prefill_attention_hm", "prefill_attention_hm_i8",
                  "grouped_q4", "grouped_q8"} | INT8),
    # model Q (qwen2 at Qwen2.5-1.5B's widths, Q4_K_M): K1 for the Q4_K parts, K6 for the
    # tied Q6_K head and the Q6_K attn_v / ffn_down layers; K2/K4 at r = 6, D = 128; no K5
    # (down mixes kinds); the q/k/v biases are plain adds
    "Q": ({"q4_matmul", "q8_matmul", "decode_attention", "kv_store", "prefill_attention"},
          {"fused_mlp", "dense_matmul", "paged_attention", "grouped_q4", "grouped_q8", "kv_store_paged"}
          | INT8),
    "Q8": ({"q4_matmul", "q8_matmul", "decode_attention_i8", "kv_store", "prefill_attention_i8"},
           {"decode_attention", "prefill_attention", "paged_attention", "paged_attention_i8", "fused_mlp",
            "dense_matmul", "grouped_q4", "grouped_q8", "kv_store_paged"}),
    # model P (phi3 at Phi-3-mini's widths): K6 for the Q5_K attn_qkv and the Q6_K down
    # layers, K1 for wo, the Q4_K gate_up and down layers; the dense head (N = 32064) is
    # torch.matmul; K2/K4/K7 and the store at D = 96
    "P": ({"q4_matmul", "q8_matmul", "decode_attention", "kv_store", "prefill_attention"},
          {"fused_mlp", "dense_matmul", "paged_attention", "grouped_q4", "grouped_q8", "kv_store_paged"}
          | INT8),
    # model M (mistral at Mistral-7B-v0.3's widths, plain Q4_K): K1 and K5, no K6
    "M": ({"q4_matmul", "fused_mlp", "decode_attention", "kv_store", "prefill_attention"},
          {"q8_matmul", "dense_matmul", "paged_attention", "grouped_q4", "grouped_q8", "kv_store_paged"}
          | INT8),
    # their server paths: the paged BatchEngine and HTTP requests (K7 at decode, K4 on the
    # gathered pages, the paged store)
    "Q server": ({"q4_matmul", "q8_matmul", "paged_attention", "prefill_attention", "kv_store_paged"},
                 {"decode_attention", "kv_store", "fused_mlp", "dense_matmul", "grouped_q4", "grouped_q8"}
                 | INT8),
    "P server": ({"q4_matmul", "q8_matmul", "paged_attention", "prefill_attention", "kv_store_paged"},
                 {"decode_attention", "kv_store", "fused_mlp", "dense_matmul", "grouped_q4", "grouped_q8"}
                 | INT8),
    "M server": ({"q4_matmul", "fused_mlp", "paged_attention", "prefill_attention", "kv_store_paged"},
                 {"decode_attention", "kv_store", "q8_matmul", "dense_matmul", "grouped_q4", "grouped_q8"}
                 | INT8),
}
# the tools phase: validate runs A's route on A's dense cache (the CLI's engine, A's
# loaded one, the 2-layer copy's); the Q8_0 copy requantized from that copy runs every
# projection and the head on K6 (no K1 or K5), then a paged BatchEngine
ROUTES.update({
    "A validate": ROUTES["A"],
    "A q8_0": ({"q8_matmul", "decode_attention", "kv_store", "prefill_attention"},
               {"q4_matmul", "fused_mlp", "dense_matmul", "paged_attention", "grouped_q4", "grouped_q8",
                "kv_store_paged"} | INT8),
    "A q8_0 server": ({"q8_matmul", "paged_attention", "prefill_attention", "kv_store_paged"},
                      {"q4_matmul", "fused_mlp", "dense_matmul", "decode_attention", "kv_store", "grouped_q4",
                       "grouped_q8"} | INT8),
})
# the OpenAI options and sessions run the routes of the engines they use:
# generate and ChatSession on A's and A8's dense caches, the BatchEngine and
# the HTTP server on A's page pool
ROUTES.update({"A options": ROUTES["A"], "A8 options": ROUTES["A8"], "A options server": ROUTES["server"]})
# constrained and speculative decoding run A's routes too: generate, the
# draft model's decode steps and the verify forwards (the store's chunk mode
# and K4 at T = spec_tokens + 1) on the dense cache; the BatchEngine's
# one-step constrained chunks on the page pool (K7), its speculative steps
# through the paged store and K4 on the gathered pages (a step that only
# speculates runs no K7)
ROUTES.update({"A constrained": ROUTES["A"], "A constrained server": ROUTES["server"], "A spec": ROUTES["A"],
               "A spec server": ({"q4_matmul", "prefill_attention", "fused_mlp", "kv_store_paged"},
                                 {"decode_attention", "kv_store", "q8_matmul", "grouped_q4", "grouped_q8"} | INT8)})
for _path, (_must, _must_not) in ROUTES.items():
    _must_not |= OLD_WRITES
    if not _path.startswith("E"):
        _must_not |= Q8V3_HM


# attention variants a path must launch (`Kernel.variants`): model G's layers
# alternate local (window 4096) and global, both softcapped, at head_dim 256
GEMMA2_VARIANTS = ("D=256 softcap window", "D=256 softcap")
# and the store's mode a path must launch it in (bf16 or int8, head width)
VARIANTS = {
    "A": {"kv_store": ("bf16 D=64",)},
    "A8": {"kv_store": ("int8 D=64",)},
    "server": {"kv_store_paged": ("bf16 D=64",)},
    "A8 server": {"kv_store_paged": ("int8 D=64",)},
    "A options": {"kv_store": ("bf16 D=64",)},
    "A8 options": {"kv_store": ("int8 D=64",)},
    "A options server": {"kv_store_paged": ("bf16 D=64",)},
    "A constrained": {"kv_store": ("bf16 D=64",)},
    "A constrained server": {"kv_store_paged": ("bf16 D=64",)},
    "A spec": {"kv_store": ("bf16 D=64",)},
    "A spec server": {"kv_store_paged": ("bf16 D=64",)},
    "A eval": {"kv_store": ("bf16 D=64", "int8 D=64")},
    "A validate": {"kv_store": ("bf16 D=64",)},
    "A q8_0": {"kv_store": ("bf16 D=64",)},
    "A q8_0 server": {"kv_store_paged": ("bf16 D=64",)},
    "G": {"decode_attention": GEMMA2_VARIANTS, "prefill_attention": GEMMA2_VARIANTS,
          "kv_store": ("bf16 D=256",)},
    "G server": {"paged_attention": GEMMA2_VARIANTS, "prefill_attention": GEMMA2_VARIANTS,
                 "kv_store_paged": ("bf16 D=256",)},
    "E": {"prefill_attention_hm": ("D=128",)},
    "E8": {"prefill_attention_hm_i8": ("D=128",), "kv_store": ("int8 D=128",)},
    "E server": {"prefill_attention": ("merged D=128",)},
    "Q": {"decode_attention": ("D=128",), "kv_store": ("bf16 D=128",)},
    "Q8": {"decode_attention_i8": ("D=128",), "prefill_attention_i8": ("D=128",), "kv_store": ("int8 D=128",)},
    "Q server": {"paged_attention": ("D=128",), "kv_store_paged": ("bf16 D=128",)},
    "P": {"decode_attention": ("D=96",), "prefill_attention": ("D=96",), "kv_store": ("bf16 D=96",)},
    "P server": {"paged_attention": ("D=96",), "prefill_attention": ("D=96",), "kv_store_paged": ("bf16 D=96",)},
    "M": {"decode_attention": ("D=128",), "kv_store": ("bf16 D=128",)},
    "M server": {"paged_attention": ("D=128",), "kv_store_paged": ("bf16 D=128",)},
}


PATH_VARIANTS: dict[str, dict] = {}  # main path -> its attention launches by variant


def _check_route(kernels_mod, path, what) -> dict:
    """The launch counts since the last reset against ROUTES[path] (and the
    variants VARIANTS[path] names, kept in PATH_VARIANTS); returns the
    counts."""
    launches = {k.name: k.launches for k in kernels_mod.KERNELS.values()}
    variants = {k.name: dict(k.variants) for k in kernels_mod.KERNELS.values() if k.variants}
    PATH_VARIANTS[path] = variants
    log(f"  {what} main-path launches: {launches}; attention variants {variants}")
    must, must_not = ROUTES[path]
    if any(launches[name] <= 0 for name in must) or any(launches[n] != 0 for n in must_not):
        raise AssertionError(f"{what} did not take its route: {launches}")
    for name, want in VARIANTS.get(path, {}).items():
        if any(variants.get(name, {}).get(v, 0) <= 0 for v in want):
            raise AssertionError(f"{what}: {name} launched {variants.get(name)}, not all of {want}")
    return launches


def _q4_downs(engine) -> int:
    """Model C's layers whose expert down stack is 4-bit (K8; the others
    are Q6_K, K9)."""
    from nfai_tpu_torch.ops.qtensor import Q4Tensor

    down = engine.params["layers"]["w_down_exps"]
    return sum(isinstance(down.layer(i), Q4Tensor) for i in range(engine.model_cfg.n_layers))


def _check_moe_step(engine, per_step) -> None:
    """Model C's decode step launches what its route implies: per layer K8
    for gate and up and for a 4-bit down, K9 for a Q6_K down."""
    cfg, q4_down = engine.model_cfg, _q4_downs(engine)
    want = {"grouped_q4": 2 * cfg.n_layers + q4_down, "grouped_q8": cfg.n_layers - q4_down,
            "fused_mlp": 0}
    got = {k: per_step[k] for k in want}
    log(f"  model C per-step grouped launches {got}, route implies {want}")
    if got != want or not 0 < q4_down < cfg.n_layers:
        raise AssertionError(f"model C: grouped launches per step {got}, route implies {want}")


def _check_e_step(engine, batch, quant=False) -> None:
    """Model E's decode step launches 4 K12 a layer (wqkv, wo, gate_up, down)
    and one for the head, K2 a layer and the store once, and no other
    matmul kernel, with no host sync; a prefill chunk K4-hm and the store
    once a layer and no K4 "full". On the int8 cache (E8): K2-i8 a layer,
    the int8 store once, K4-hm-i8 once a layer a chunk."""
    from nfai_tpu_torch.ops.qtensor import Q8V3Tensor

    n = engine.model_cfg.n_layers
    if not isinstance(engine.params["lm_head"], Q8V3Tensor) or not all(
            isinstance(engine.params["layers"][k], Q8V3Tensor)
            for k in ("wqkv", "wo", "w_gate_up", "w_down")):
        raise AssertionError("model E did not load its q8v3 containers")
    step, chunk = batch["launches_per_step"], batch["launches_per_prefill_chunk"]
    i8 = "_i8" if quant else ""
    want = {"q8v3_matmul": 4 * n + 1, f"decode_attention{i8}": n, "kv_store": 1, "q4_matmul": 0,
            "q8_matmul": 0, "fused_mlp": 0, "dense_matmul": 0}
    got = {k: step[k] for k in want}
    want_chunk = {f"prefill_attention_hm{i8}": n, f"prefill_attention{i8}": 0,
                  "q8v3_matmul": 4 * n + 1, "kv_store": n}
    got_chunk = {k: chunk[k] for k in want_chunk}
    log(f"  model E{'8' if quant else ''} per decode step {got}, per prefill chunk {got_chunk}")
    if got != want or got_chunk != want_chunk or batch["host_syncs_per_step"] != 0:
        raise AssertionError(f"model E: per decode step {got}, per prefill chunk {got_chunk} and "
                             f"{batch['host_syncs_per_step']} host syncs; the route implies {want}, "
                             f"{want_chunk} and none")


def _expected_matmuls(engine) -> dict[str, int]:
    """The dequant-matmul and fused-MLP launches a decode step implies from
    the containers loaded: per layer one launch a projection stack (K1 for
    a 4-bit layer, K6 for an 8-bit one; a LayerList by each layer's kind),
    K5 once a layer in place of gate_up and down where the pair is fused,
    and the head's (none for a dense head: torch.matmul)."""
    from nfai_tpu_torch.ops.qtensor import LayerList, Q4Tensor, Q8Tensor

    lp, n = engine.params["layers"], engine.model_cfg.n_layers
    fused = engine.params["fused_mlp"]
    want = {"q4_matmul": 0, "q8_matmul": 0, "fused_mlp": n if fused else 0}

    def tally(w, times=1):
        if isinstance(w, Q4Tensor):
            want["q4_matmul"] += times
        elif isinstance(w, Q8Tensor):
            want["q8_matmul"] += times

    for key, w in lp.items():
        if key.endswith(("norm", "bias")) or (fused and key in ("w_gate_up", "w_down")):
            continue
        if isinstance(w, LayerList):
            for it in w.items:
                tally(it)
        else:
            tally(w, n)
    tally(engine.params["lm_head"])
    return want


def _check_family_step(engine, label, batch) -> None:
    """Models Q (and Q8 on its int8 cache), P and M: a decode step launches
    K2 (K2-i8) once a layer, the store once and the matmuls its containers
    imply (`_expected_matmuls`), no K11 and no host sync; and each loaded
    what its file holds: Q its q/k/v split on every layer (attn_v mixes
    Q4_K and Q6_K) with the three biases, r = 6 at D = 128; P its Q5_K
    attn_qkv on K6, a dense head, D = 96; M the fused MLP (K5)."""
    import torch

    from nfai_tpu_torch.ops.qtensor import Q8Tensor

    cfg, lp, n = engine.model_cfg, engine.params["layers"], engine.model_cfg.n_layers
    step = batch["launches_per_step"]
    i8 = "_i8" if label == "Q8" else ""
    want = {f"decode_attention{i8}": n, "kv_store": 1, "dense_matmul": 0, **_expected_matmuls(engine)}
    got = {k: step[k] for k in want}
    log(f"  model {label} per decode step {got}; the route implies {want}")
    if got != want or batch["host_syncs_per_step"] != 0:
        raise AssertionError(f"model {label}: per decode step {got} and {batch['host_syncs_per_step']} host "
                             f"syncs; the route implies {want} and none")
    if label in ("Q", "Q8"):
        ok = ("wqkv" not in lp and {"wq_bias", "wk_bias", "wv_bias"} <= set(lp)
              and (cfg.n_heads // cfg.n_kv_heads, cfg.head_dim) == (6, 128))
    elif label == "P":
        ok = (isinstance(lp["wqkv"], Q8Tensor) and isinstance(engine.params["lm_head"], torch.Tensor)
              and cfg.head_dim == 96 and "w_gate_up" in lp)
    else:
        ok = engine.params["fused_mlp"] and cfg.head_dim == 128 and not cfg.rope_neox
    if not ok:
        raise AssertionError(f"model {label} did not load what its file holds: {sorted(lp)}")


def _bias_cost(torch, engine, state, with_biases) -> dict:
    """Model Q's q/k/v biases (plain adds after the projections): the same
    8 profiled decode steps again with the bias stacks taken out of the
    params (put back after); the kernels and device ms a step they add."""
    lp = engine.params["layers"]
    saved = {k: lp.pop(k) for k in list(lp) if k.endswith("_bias")}
    try:
        without = phase_profile(torch, engine, state)
    finally:
        lp.update(saved)
    out = dict(kernels_per_step=with_biases["kernels_per_step"] - without["kernels_per_step"],
               device_ms_per_step=with_biases["device_ms_per_step"] - without["device_ms_per_step"],
               wall_ms_per_step=with_biases["wall_ms_per_step"] - without["wall_ms_per_step"],
               bias_stacks=sorted(saved))
    log(f"  model Q biases ({', '.join(sorted(saved))}): +{out['kernels_per_step']:.1f} kernels a step, "
        f"+{out['device_ms_per_step']:.4f} device ms, +{out['wall_ms_per_step']:.3f} wall ms")
    return out


def _paged_server_run(torch, engine, label) -> dict:
    """A paged BatchEngine on model C or G: 8 requests of 30-600 tokens, 32
    new tokens each, half greedy and half at temperature 0.8 with top_k 20
    or 40."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    rng = torch.Generator().manual_seed(8)
    lens = (30, 95, 160, 240, 330, 420, 510, 600)
    vocab = engine.model_cfg.vocab_size
    prompts = [torch.randint(300, vocab, (n,), generator=rng).tolist() for n in lens]
    sampling = [SamplingParams(temperature=0.0, max_new_tokens=32) if i % 2 == 0 else
                SamplingParams(temperature=0.8, top_k=(20, 40)[i // 2 % 2], top_p=0.95,
                               max_new_tokens=32) for i in range(len(prompts))]
    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    _sync(torch)
    t0 = time.perf_counter()
    reqs = [be.submit(p, sp) for p, sp in zip(prompts, sampling)]
    _drive(be, reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    n_out = sum(len(r.output_ids) for r in reqs)
    ttft = _pcts([r.ttft_s * 1e3 for r in reqs])
    out = dict(requests=len(reqs), prompt_tokens=sum(lens), new_tokens=n_out, wall_s=wall,
               tok_s=n_out / wall, ttft_ms=ttft, pool_mb=be.cache.nbytes / 1e6,
               output_lengths=[len(r.output_ids) for r in reqs])
    log(f"  model {label} BatchEngine: {len(reqs)} requests, {sum(lens)} prompt tokens, {n_out} new in "
        f"{wall:.2f} s = {n_out / wall:.1f} tok/s aggregate; TTFT p50 {ttft['p50']:.1f} / max "
        f"{ttft['max']:.1f} ms; pool {out['pool_mb']:.1f} MB; outputs {out['output_lengths']}")
    if any(not 0 < n <= 32 for n in out["output_lengths"]):
        raise AssertionError(f"output lengths {out['output_lengths']}")
    del be
    return out


# ---------------------------------------------------------------------------
# phase: parallel (the mesh and Megatron tensor parallelism, nfai_tpu_torch.parallel)

PAR_TIMEOUT_S = 180  # a world's children must end within this, or the phase fails
PAR_GROUP_TIMEOUT_S = 120  # each child's process group (a dead rank raises within it)
PAR_PROMPT = ("Tensor parallelism splits every layer of the model across ranks: the attention "
              "heads and the columns of the feed-forward network. " * 3)
PAR_STEPS = 8  # teacher-forced decode steps held against the single-device engine
# model A's 16 random layers amplify any change of rounding: tp = 2 is one
# more of A's bf16 routes (its partial sums are rounded to bf16 before the
# f32 sum, as the JAX psums round them), so A at full depth is held to
# PATH_TOL, the rule for A's routes against each other (set from their
# 4.3-6.0e-2, PERF.md §6); the run prints beside it the single-device engine's
# own spread between a prefill in chunks of 256 and of PAR_CHUNK. A's
# 2-layer copy and the Q copy, at the depth the JAX rule was set for, are
# held to TOL itself
PAR_CHUNK = 32
PAR_TOKENS = 16  # greedy tokens of the NCCL world-size-1 check
# the launch routes of the parallel phase's paths: A's dense and paged routes on
# each rank's shard, the Q copy's (K1 and K6: its tied Q6_K head, vocab-split)
ROUTES.update({"parallel nccl A": ROUTES["A"], "parallel tp2 A": ROUTES["A"], "parallel tp2 A2": ROUTES["A"],
               "parallel tp2 A server": ROUTES["server"], "parallel tp2 Q": ROUTES["Q"]})
# the rest of the mesh: the draft model under tp = 2 (A's route: its verify forward is
# a prefill), the dense BatchEngine split over dp, an axis no split names (A's
# 2-layer copy), model D's 2-layer copy at tp = 2 (K11 only) and model E's
# under NFAI_Q8V3=1 at tp = 2, whose split 8-bit weights all keep K6's
# container: K6 for every projection and the head, no K12
ROUTES.update({"parallel tp2 A draft": ROUTES["A"], "parallel dp2 A": ROUTES["A"], "parallel x2 A2": ROUTES["A"],
               "parallel tp2 D2": ROUTES["D"],
               "parallel tp2 E2 q8v3": ({"q8_matmul", "decode_attention", "kv_store", "prefill_attention"},
                                        {"q4_matmul", "fused_mlp", "dense_matmul", "paged_attention",
                                         "grouped_q4", "grouped_q8", "kv_store_paged"} | INT8 | OLD_WRITES
                                        | Q8V3_HM)})


def _param_bytes(params) -> int:
    """Bytes of every tensor a params tree holds (containers' leaves, dense
    weights, norms, the rope tables)."""
    import torch

    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:  # a dense tied table is the head and the embedding
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif dataclasses.is_dataclass(x):  # the containers, a LayerList's items
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk({k: v for k, v in params.items() if k != "comm"})
    return total


def _launches(kernels_mod) -> dict[str, int]:
    return {k.name: k.launches for k in kernels_mod.KERNELS.values()}


def _teacher_forced(torch, engine, ids, tokens):
    """Prefill logits [1, V] of `ids`, then the logits of decode steps fed
    `tokens` one at a time: [1 + len(tokens), V] f32 on the host."""
    from nfai_tpu_torch.models.llama import decode_step

    logits, cache = engine.prefill(engine.new_cache(1), ids)
    rows = [logits]
    pos = len(ids)
    for t in tokens:
        lg, cache = decode_step(engine.params, engine.model_cfg, torch.tensor([t], device=engine.device),
                                torch.tensor([pos], device=engine.device), cache)
        rows.append(lg)
        pos += 1
    return torch.cat(rows).float().cpu()


def _par_nccl(torch, kernels_mod, conf) -> dict:
    """World size 1 under NCCL: model A at full width and depth as a {"tp": 1}
    mesh beside the single-device engine in this process: prefill logits and
    PAR_TOKENS greedy tokens bit-equal. Also writes the single-device
    references the tp = 2 world is held to (A and its dense BatchEngine, and
    the 2-layer copies: A2, Q, D2, E2 under NFAI_Q8V3=1 and on K6)."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    one = InferenceEngine(conf["A"], EngineConfig(max_seq_len=1024), device="cuda")
    tp1 = InferenceEngine(conf["A"], EngineConfig(max_seq_len=1024, mesh_shape={"tp": 1}), device="cuda")
    ids = one.tokenizer.encode(PAR_PROMPT)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=PAR_TOKENS)
    want, ref_toks = one.prefill(one.new_cache(1), ids)[0], list(one.generate(ids, greedy))
    torch.cuda.synchronize()
    kernels_mod.reset_launches()  # the tp=1 engine's path alone
    got = tp1.prefill(tp1.new_cache(1), ids)[0]
    toks = list(tp1.generate(ids, greedy))
    torch.cuda.synchronize()
    launches = _launches(kernels_mod)
    logits = _teacher_forced(torch, one, ids, ref_toks[:PAR_STEPS])
    chunked = _teacher_forced(torch, _with_config(one, prefill_chunk=PAR_CHUNK), ids, ref_toks[:PAR_STEPS])
    out = dict(prefill_bit_equal=bool(torch.equal(got, want)), tokens=toks, ref_tokens=ref_toks,
               launches=launches, collectives=dict(tp1.comm.counts), weight_bytes=_param_bytes(one.params),
               backend=tp1.comm.backend, device=str(tp1.device),
               route_spread=errors(chunked, logits, row_dims=1)[1])
    refs = {"A": {"ids": ids, "tokens": ref_toks[:PAR_STEPS], "logits": logits}}
    # the dp check's reference: A's dense BatchEngine on one device
    refs["A dense batch"] = out["dense_batch"] = _dense_batch(torch, kernels_mod, one, True)
    # the logit scale of the greedy streams' tie margin (TOL x it, `_tie_prefix`'s rule)
    out["dense_batch"]["scale"] = float(one.prefill(one.new_cache(1), _dp_requests(torch)[0][0])[0].abs().max())
    del one, tp1
    for name in ("A2", "Q", "D2", "E2"):  # the 2-layer copies (E's under NFAI_Q8V3=1, as its tp = 2 ranks)
        with _Switches(q8v3=name == "E2"):
            e = InferenceEngine(conf[name], EngineConfig(max_seq_len=1024), device="cuda")
        e_ids = e.tokenizer.encode(PAR_PROMPT)
        e_toks = list(e.generate(e_ids, SamplingParams(temperature=0.0, max_new_tokens=PAR_STEPS)))
        refs[name] = {"ids": e_ids, "tokens": e_toks, "logits": _teacher_forced(torch, e, e_ids, e_toks),
                      "weight_bytes": _param_bytes(e.params)}
        del e
        torch.cuda.empty_cache()
    # E's copy without the switch: one device on K6, the containers a tp = 2 rank keeps under it
    e = InferenceEngine(conf["E2"], EngineConfig(max_seq_len=1024), device="cuda")
    refs["E2"]["k6_logits"] = _teacher_forced(torch, e, refs["E2"]["ids"], refs["E2"]["tokens"])
    out["e2_route_spread"] = errors(refs["E2"]["k6_logits"], refs["E2"]["logits"], row_dims=1)[1]
    del e
    torch.cuda.empty_cache()
    torch.save(refs, conf["refs"])
    return out


def _par_batch(torch, engine, root) -> dict:
    """8 requests on a paged BatchEngine (4 share a 300-token prefix; greedy
    and sampled): rank 0 submits and steps, the other rank follows."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    be = BatchEngine(engine, max_batch=8, decode_chunk=8, paged=True)
    if not root:
        be.follow()
        return dict(preemptions=be.preemptions, prefix_hits=be.alloc.hits)
    rng = torch.Generator().manual_seed(7)
    ids = lambda n: torch.randint(0, 1000, (n,), generator=rng).tolist()  # noqa: E731
    prefix = ids(300)
    prompts = [prefix + ids(t) for t in (20, 60, 100, 140)] + [ids(n) for n in (40, 120, 250, 400)]
    sampling = [SamplingParams(temperature=0.0 if i % 2 == 0 else 0.8, max_new_tokens=32)
                for i in range(len(prompts))]
    t0 = time.perf_counter()
    reqs = [be.submit(prompts[0], sampling[0])]
    while not reqs[0].output_ids:  # its prefill publishes the prefix before the sharers arrive
        be.step()
    reqs += [be.submit(p, s) for p, s in zip(prompts[1:], sampling[1:])]
    _drive(be, reqs)
    wall = time.perf_counter() - t0
    be.close()
    return dict(requests=len(reqs), new_tokens=sum(len(r.output_ids) for r in reqs), wall_s=wall,
                preemptions=be.preemptions, prefix_hits=be.alloc.hits)


def _par_tp2(torch, kernels_mod, conf, rank) -> dict:
    """One rank of tp = 2 over gloo, both ranks on the one card: model A at
    full width and depth, then the A and Q copies (see `ParallelPhase`)."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.models.llama import decode_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine
    from nfai_tpu_torch.runtime.scheduler import BatchEngine

    root = rank == 0
    refs = torch.load(conf["refs"])
    mesh = {"tp": 2}
    out, launches = {}, {}
    eng = InferenceEngine(conf["A"], EngineConfig(max_seq_len=1024, mesh_shape=mesh), device="cuda")
    comm = eng.comm
    out.update(backend=comm.backend, device=str(eng.device), weight_bytes=_param_bytes(eng.params),
               n_layers=eng.model_cfg.n_layers,
               local=[eng.model_cfg.n_heads, eng.model_cfg.n_kv_heads, eng.model_cfg.ffn_dim],
               cache_mb=eng.new_cache(1).nbytes / 2**20)
    # the dense path: the teacher-forced logits, one decode step counted alone, generate
    ref = refs["A"]
    kernels_mod.reset_launches()
    got = _teacher_forced(torch, eng, ref["ids"], ref["tokens"])
    out["logit_rel_err"] = errors(got, ref["logits"], row_dims=1)[1]
    cache = eng.prefill(eng.new_cache(1), ref["ids"])[1]
    torch.cuda.synchronize()
    before = _launches(kernels_mod)
    comm.reset()
    decode_step(eng.params, eng.model_cfg, torch.tensor([5], device=eng.device),
                torch.tensor([len(ref["ids"])], device=eng.device), cache)
    torch.cuda.synchronize()
    out["step_launches"] = {k: n - before[k] for k, n in _launches(kernels_mod).items()}
    out["step_expected"] = _expected_matmuls(eng)
    out["step_collectives"], out["step_staged"] = dict(comm.counts), dict(comm.staged)
    t0 = time.perf_counter()
    out["greedy"] = list(eng.generate(ref["ids"], SamplingParams(temperature=0.0, max_new_tokens=PAR_TOKENS)))
    torch.cuda.synchronize()
    out["greedy_wall_s"] = time.perf_counter() - t0
    out["sampled"] = list(eng.generate(ref["ids"], SamplingParams(temperature=0.8, seed=11, max_new_tokens=16)))
    out["sampled_unseeded"] = list(eng.generate(ref["ids"], SamplingParams(temperature=0.8, max_new_tokens=16)))
    torch.cuda.synchronize()
    launches["A"] = _launches(kernels_mod)
    # the paged path: the BatchEngine, then the HTTP server (rank 0 serves, rank 1 follows)
    kernels_mod.reset_launches()
    out["batch"] = _par_batch(torch, eng, root)
    if root:
        out["http"] = _http_run(torch, eng, 2)
    else:
        BatchEngine(eng, max_batch=8, decode_chunk=8).follow()
    torch.cuda.synchronize()
    launches["A server"] = _launches(kernels_mod)
    out["collectives"], out["staged"] = dict(comm.counts), dict(comm.staged)
    out["draft"] = _par_draft(torch, kernels_mod, eng, conf, refs["A"]["ids"], launches)
    del eng, cache
    torch.cuda.empty_cache()
    # A's 2-layer copy, then the Q copy: biases, 6 / 1 heads a rank, the
    # vocab-split tied Q6_K head on K6 and the vocab-parallel embedding
    for name in ("A2", "Q"):
        e = InferenceEngine(conf[name], EngineConfig(max_seq_len=1024, mesh_shape=mesh), device="cuda")
        ref = refs[name]
        kernels_mod.reset_launches()
        got = _teacher_forced(torch, e, ref["ids"], ref["tokens"])
        torch.cuda.synchronize()
        launches[name] = _launches(kernels_mod)
        out[name] = dict(logit_rel_err=errors(got, ref["logits"], row_dims=1)[1], collectives=dict(e.comm.counts),
                         weight_bytes=_param_bytes(e.params), single_weight_bytes=ref["weight_bytes"],
                         local=[e.model_cfg.n_heads, e.model_cfg.n_kv_heads, e.model_cfg.ffn_dim],
                         head=[type(e.params["lm_head"]).__name__, e.params["lm_head"].n],
                         embed_tied=e.params["embed"] is None)
        del e
    out.update(_par_meshes(torch, kernels_mod, conf, rank, refs, launches))
    out["launches"] = launches
    return out


# the rest of the mesh, in the tp = 2 world (a world holds several meshes)
DP_BATCH = 8  # the dense BatchEngine's lanes: 4 a rank at dp = 2
DP_NEW = 48  # tokens a request emits
DP_LENGTHS = (40, 120, 250, 400, 60, 90, 300, 30)  # the prompts' lengths (random ids)
SPEC_GAMMA = 4  # the draft check's drafts a round
EXTRA_AXIS = {"tp": 1, "x": 2}  # an axis no split names: the ranks replicate


def _dp_requests(torch):
    """DP_BATCH prompts of random ids and their sampling: even ones greedy,
    odd ones sampled at 0.8; each with its top-2 logprobs (the greedy
    streams' margins, read where two streams part)."""
    from nfai_tpu_torch.config import SamplingParams

    rng = torch.Generator().manual_seed(25)
    prompts = [torch.randint(0, 1000, (n,), generator=rng).tolist() for n in DP_LENGTHS]
    sampling = [SamplingParams(temperature=0.0 if i % 2 == 0 else 0.8, max_new_tokens=DP_NEW, logprobs=2)
                for i in range(DP_BATCH)]
    return prompts, sampling


def _dense_batch(torch, kernels_mod, engine, root) -> dict:
    """Model A's dense BatchEngine (paged=False, DP_BATCH lanes, chunks of 8,
    every prefilling slot a chunk a step): rank 0 submits `_dp_requests` and
    steps, the other ranks of a mesh follow. The first chunk in which every
    lane decodes runs alone between two syncs: its decode steps, launches
    and dp collectives. Returns those, the cache bytes and lanes, the wall
    and, on rank 0, each request's tokens and logprob entries."""
    from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState

    be = BatchEngine(engine, max_batch=DP_BATCH, decode_chunk=8, paged=False, prefill_ticks_per_step=DP_BATCH)
    dp = be.dp_comm
    reqs = [be.submit(p, s) for p, s in zip(*_dp_requests(torch))] if root else []
    measured, t0 = None, time.perf_counter()
    if dp is not None:
        dp.reset()
    while not (root and all(r.state in (RequestState.FINISHED, RequestState.FAILED) for r in reqs)):
        if be._sync():  # rank 0's close (a follower); no-op on one device
            break
        if measured is None and all(sl.request is not None and not sl.prefilling for sl in be.slots):
            steps = min(be.decode_chunk, min(engine.max_seq_len - sl.pos for sl in be.slots))
            torch.cuda.synchronize()
            before = _launches(kernels_mod)
            counts, staged = (dict(dp.counts), dict(dp.staged)) if dp else ({}, {})
            be._step()
            torch.cuda.synchronize()
            measured = dict(steps=steps, launches={k: n - before[k] for k, n in _launches(kernels_mod).items()},
                            dp={k: n - counts.get(k, 0) for k, n in dp.counts.items() if n > counts.get(k, 0)}
                            if dp else {},
                            staged={k: n - staged.get(k, 0) for k, n in dp.staged.items() if n > staged.get(k, 0)}
                            if dp else {})
        else:
            be._step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if root:
        be.close()
    if measured is None:
        raise AssertionError("the dense BatchEngine never decoded every lane at once")
    out = dict(cache_bytes=be.cache.nbytes, lanes=[be.lanes.start, len(be.lanes)], measured=measured, wall_s=wall,
               dp_all=dict(dp.counts) if dp else {})
    if root:
        bad = [r.id for r in reqs if r.state != RequestState.FINISHED]
        if bad:
            raise AssertionError(f"dense BatchEngine: requests {bad} did not finish")
        out.update(tokens=[list(r.output_ids) for r in reqs], logprobs=[r.logprob_data for r in reqs],
                   new_tokens=sum(len(r.output_ids) for r in reqs))
    return out


def _par_draft(torch, kernels_mod, eng, conf, ids, launches) -> dict:
    """speculative="draft" on the tp = 2 target A (this rank's engine, its
    weights shared), A's 2-layer copy as the draft: the draft engine takes
    the target's Mesh and loads its own shard. PAR_TOKENS greedy tokens
    of `ids` against the target's plain greedy, with its top-two gaps and
    the tie margin of `_tie_prefix` (TOL x the prefill's largest logit: the verify
    forward runs the matmuls at gamma + 1 rows, the decode step at one, so
    a near-tie may round apart), acceptance counted."""
    from nfai_tpu_torch.config import SamplingParams
    from nfai_tpu_torch.runtime.engine import GenerationMetrics

    m0 = GenerationMetrics()
    plain = list(eng.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=PAR_TOKENS, logprobs=2),
                              metrics=m0))
    scale = float(eng.prefill(eng.new_cache(1), ids)[0].abs().max())
    spec = _with_config(eng, speculative="draft", draft_gguf=conf["A2"], spec_tokens=SPEC_GAMMA, spec_rounds=2)
    de = spec.draft_engine  # loaded here, outside the counted run
    torch.cuda.synchronize()
    kernels_mod.reset_launches()
    de.comm.reset()
    m = GenerationMetrics()
    t0 = time.perf_counter()
    toks = list(spec.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=PAR_TOKENS), metrics=m))
    torch.cuda.synchronize()
    launches["A draft"] = _launches(kernels_mod)
    out = dict(tokens=toks, plain=plain, gaps=_gaps(m0.logprobs), margin=TOL * scale,
               drafted=m.spec_drafted, accepted=m.spec_accepted,
               wall_s=time.perf_counter() - t0, mesh_shared=de.mesh is eng.mesh, own_comm=de.comm is not eng.comm,
               draft_local=[de.model_cfg.n_heads, de.model_cfg.n_kv_heads, de.model_cfg.ffn_dim],
               draft_collectives=dict(de.comm.counts))
    del spec, de
    return out


def _par_meshes(torch, kernels_mod, conf, rank, refs, launches) -> dict:
    """The other meshes of the tp = 2 world: {"dp": 2, "tp": 1} on model A's
    dense BatchEngine (each rank 4 of its 8 lanes); EXTRA_AXIS on A's 2-layer
    copy (bit for bit one device's); model D's 2-layer copy (F16: K11) and
    model E's (Q8_0 under NFAI_Q8V3=1, set around its load alone) at tp = 2:
    weight bytes, one decode step's launches, the teacher-forced logits
    against one device's (`_par_nccl`'s references)."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.models.llama import decode_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    root, out = rank == 0, {}
    eng = InferenceEngine(conf["A"], EngineConfig(max_seq_len=1024, mesh_shape={"dp": 2, "tp": 1}), device="cuda")
    kernels_mod.reset_launches()
    out["dp2"] = _dense_batch(torch, kernels_mod, eng, root)
    torch.cuda.synchronize()
    launches["A dp2"] = _launches(kernels_mod)
    out["dp2"].update(weight_bytes=_param_bytes(eng.params), dp_rank=eng.mesh.dp_rank, backend=eng.dp_comm.backend)
    del eng
    torch.cuda.empty_cache()
    e = InferenceEngine(conf["A2"], EngineConfig(max_seq_len=1024, mesh_shape=EXTRA_AXIS), device="cuda")
    ref = refs["A2"]
    kernels_mod.reset_launches()
    got = _teacher_forced(torch, e, ref["ids"], ref["tokens"])
    toks = list(e.generate(ref["ids"], SamplingParams(temperature=0.0, max_new_tokens=PAR_STEPS)))
    torch.cuda.synchronize()
    launches["A2 x2"] = _launches(kernels_mod)
    out["x2"] = dict(dims=e.mesh.dims, groups={a: e.mesh.ranks(a) for a in e.mesh.dims},
                     logits_bit_equal=bool(torch.equal(got, ref["logits"])), tokens=toks, ref_tokens=ref["tokens"],
                     params_comm="comm" in e.params)
    del e
    mesh = {"tp": 2}
    for name in ("D2", "E2"):
        with _Switches(q8v3=name == "E2"):
            e = InferenceEngine(conf[name], EngineConfig(max_seq_len=1024, mesh_shape=mesh), device="cuda")
        ref = refs[name]
        kernels_mod.reset_launches()
        got = _teacher_forced(torch, e, ref["ids"], ref["tokens"])
        torch.cuda.synchronize()
        launches[name] = _launches(kernels_mod)
        cache = e.prefill(e.new_cache(1), ref["ids"])[1]
        torch.cuda.synchronize()
        before = _launches(kernels_mod)
        e.comm.reset()
        decode_step(e.params, e.model_cfg, torch.tensor([5], device=e.device),
                    torch.tensor([len(ref["ids"])], device=e.device), cache)
        torch.cuda.synchronize()
        lp = e.params["layers"]
        out[name] = dict(logit_rel_err=errors(got, ref["logits"], row_dims=1)[1], weight_bytes=_param_bytes(e.params),
                         k6_rel_err=errors(got, ref["k6_logits"], row_dims=1)[1] if "k6_logits" in ref else None,
                         single_weight_bytes=ref["weight_bytes"],
                         step_launches={k: n - before[k] for k, n in _launches(kernels_mod).items()},
                         step_collectives=dict(e.comm.counts), n_layers=e.model_cfg.n_layers,
                         kinds={k: type(w).__name__ for k, w in [*lp.items(), ("lm_head", e.params["lm_head"])]
                                if not k.endswith("norm")},
                         shapes={k: [w.n, w.k] if hasattr(w, "k") else list(w.shape[-2:])
                                 for k, w in [*lp.items(), ("lm_head", e.params["lm_head"])]
                                 if not k.endswith("norm")})
        del e, cache
        torch.cuda.empty_cache()
    return out


# sequence parallelism: model A's long-context case, the 3500-token prompt of
# the long-context phase in 4096 slots, one 2048-slot slice a rank
SP_SLOTS = 4096
SP_PROMPT = 3500
SP_TOKENS = 16
MOE_PROMPT = 192  # model C's teacher-forced prompt: random ids, every row's logits compared
# a rank may pick other experts than one device for a row whose router gap
# is below NEAR_TIE at some layer, and a rank's bf16 partials move some
# picks past it: both kinds of row are left out, which at C's 8 layers
# leaves about one row in six; at least this many must remain
MOE_MIN_ROWS = 16
EXPERT_KEYS = ("w_gate_exps", "w_up_exps", "w_down_exps")
# the SP path: attention is PyTorch ops over each rank's slice (local_flash and
# the merge: the JAX package's jnp inside shard_map, no Pallas kernel), so no
# K2, K4 or K7; every layer's K/V through the store's chunk mode, then K1 / K5
SP_ROUTE = ({"q4_matmul", "fused_mlp", "kv_store"},
            {"decode_attention", "prefill_attention", "paged_attention", "q8_matmul", "grouped_q4", "grouped_q8",
             "kv_store_paged", "dense_matmul"} | INT8)
ROUTES.update({"parallel sp2 A": SP_ROUTE, "parallel sp2 A2": SP_ROUTE, "parallel sp2 A8 copy": SP_ROUTE,
               "parallel ep2 C": ROUTES["C"], "parallel ep2 C2": ROUTES["C"],
               "parallel ep2 C server": ROUTES["C server"], "parallel ffn2 C": ROUTES["C"],
               "parallel ffn2 C2": ROUTES["C"], "parallel ffn2 C server": ROUTES["C server"],
               "pipeline A": ROUTES["A"]})
for _path in ("parallel sp2 A", "parallel sp2 A2", "parallel sp2 A8 copy", "parallel ep2 C", "parallel ep2 C2",
              "parallel ep2 C server", "parallel ffn2 C", "parallel ffn2 C2", "parallel ffn2 C server", "pipeline A"):
    ROUTES[_path][1].update(OLD_WRITES | Q8V3_HM)


def _sp_ids(torch) -> list[int]:
    return torch.randint(0, 1000, (SP_PROMPT,), generator=torch.Generator().manual_seed(5)).tolist()


def _moe_ids(torch) -> list[int]:
    return torch.randint(0, 1000, (MOE_PROMPT,), generator=torch.Generator().manual_seed(6)).tolist()


def _expert_bytes(params) -> int:
    return _param_bytes({"layers": {k: params["layers"][k] for k in EXPERT_KEYS}})


class _RouterMargins:
    """Records, while active, the router's k-th vs (k+1)-th logit gap and the
    experts picked of every row at every layer (`models.llama.moe_route`
    wrapped, as the parity phase does): the rows where a rank's slightly
    different input may rightly pick other experts."""

    def __init__(self, torch):
        from nfai_tpu_torch.models import llama as tllama

        self.torch, self.mod, self.route, self.calls = torch, tllama, tllama.moe_route, []

    def __enter__(self):
        def recording(xx, router, n_used, norm_topk):
            vals, idx = self.route(xx, router, n_used, norm_topk)
            top = self.torch.topk(xx.float() @ router.float(), n_used + 1, dim=-1).values
            self.calls.append(((top[:, n_used - 1] - top[:, n_used]).cpu(), idx.sort(-1).values.cpu()))
            return vals, idx

        self.mod.moe_route = recording
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.route

    def near(self, row: int) -> bool:
        """Whether row `row` of the forwards since the last `calls.clear()`
        had a gap below NEAR_TIE at any layer."""
        return min(float(gap[row]) for gap, _ in self.calls) < NEAR_TIE

    def picks(self, row: int) -> list:
        """Row `row`'s experts at every layer since the last `calls.clear()`."""
        return [idx[row].tolist() for _, idx in self.calls]


def _teacher_forced_moe(torch, engine, ids, tokens):
    """The f32 logits on the host of every prompt row (one forward over the
    prompt) and of decode steps fed `tokens` one at a time: [len(ids) +
    len(tokens), V]; and each row's router near-tie flag and experts at
    every layer (_RouterMargins)."""
    from nfai_tpu_torch.models.llama import decode_step, forward, logits_for

    dev, cfg = engine.device, engine.model_cfg
    with _RouterMargins(torch) as margins, torch.inference_mode():
        h, cache = forward(engine.params, cfg, torch.tensor([ids], device=dev),
                           torch.arange(len(ids), device=dev)[None], engine.new_cache(1))
        rows = [logits_for(engine.params, h[0], cfg).float().cpu()]
        near = [margins.near(i) for i in range(len(ids))]
        picks = [margins.picks(i) for i in range(len(ids))]
        pos = len(ids)
        for t in tokens:
            margins.calls.clear()
            lg, cache = decode_step(engine.params, cfg, torch.tensor([t], device=dev),
                                    torch.tensor([pos], device=dev), cache)
            near.append(margins.near(0))
            picks.append(margins.picks(0))
            rows.append(lg.float().cpu())
            pos += 1
    return torch.cat(rows), near, picks


def _par_refs(torch, kernels_mod, conf) -> dict:
    """The single-device references of the sp2, ep2 and ffn2 worlds (a child
    of its own, world size 1): model A and its 2-layer copy (bf16 and int8
    caches) at SP_SLOTS on the SP_PROMPT-token prompt, SP_TOKENS greedy
    tokens teacher-forced; model C and its 2-layer copy on MOE_PROMPT random
    ids (every prompt row), PAR_STEPS greedy tokens teacher-forced, with each
    row's router near-tie flag; the cache and expert bytes on one device."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    refs, out = {}, {}
    ids = _sp_ids(torch)
    for name, path, kv in (("A", conf["A"], "auto"), ("A2", conf["A2"], "auto"), ("A8 copy", conf["A2"], "int8")):
        e = InferenceEngine(path, EngineConfig(max_seq_len=SP_SLOTS, kv_dtype=kv), device="cuda")
        toks = list(e.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=SP_TOKENS)))
        refs[name] = {"tokens": toks, "logits": _teacher_forced(torch, e, ids, toks)}
        out[f"{name} cache_bytes"], out[f"{name} tokens"] = e.new_cache(1).nbytes, toks
        del e
        torch.cuda.empty_cache()
    mids = _moe_ids(torch)
    for name in ("C", "C2"):
        e = InferenceEngine(conf[name], EngineConfig(max_seq_len=1024), device="cuda")
        toks = list(e.generate(mids, SamplingParams(temperature=0.0, max_new_tokens=PAR_STEPS)))
        logits, near, picks = _teacher_forced_moe(torch, e, mids, toks)
        refs[name] = {"tokens": toks, "logits": logits, "near": near, "picks": picks}
        out[f"{name} expert_bytes"] = _expert_bytes(e.params)
        out[f"{name} near_ties"] = sum(near)
        del e
        torch.cuda.empty_cache()
    torch.save(refs, conf["refs2"])
    return out


def _par_sp2(torch, kernels_mod, conf, rank) -> dict:
    """One rank of {"sp": 2} with seq_parallel over gloo, both ranks on the
    one card: model A at full width and depth on the SP_PROMPT-token prompt
    in SP_SLOTS slots (each rank 2048 slots of every layer's cache), then its
    2-layer copy on a bf16 and an int8 cache, against `_par_refs`."""
    from nfai_tpu_torch.config import EngineConfig, SamplingParams
    from nfai_tpu_torch.models.llama import decode_step
    from nfai_tpu_torch.parallel import sp_decode_attention_merged
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    refs = torch.load(conf["refs2"])
    ids = _sp_ids(torch)
    mesh = {"sp": 2}
    out, launches = {}, {}
    eng = InferenceEngine(conf["A"], EngineConfig(max_seq_len=SP_SLOTS, mesh_shape=mesh, seq_parallel=True),
                          device="cuda")
    sp = eng.sp_comm
    cache = eng.new_cache(1)
    out.update(backend=sp.backend, device=str(eng.device), n_layers=eng.model_cfg.n_layers,
               cache=[list(cache.k.shape), cache.offset, cache.max_seq], cache_bytes=cache.nbytes)
    del cache
    ref = refs["A"]
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    got = _teacher_forced(torch, eng, ids, ref["tokens"])
    torch.cuda.synchronize()
    out["teacher_forced_s"] = time.perf_counter() - t0
    out["logit_rel_err"] = errors(got, ref["logits"], row_dims=1)[1]
    out["prefill_rel_err"] = errors(got[:1], ref["logits"][:1], row_dims=1)[1]
    # one decode step counted alone, on the prompt's cache
    cache = eng.prefill(eng.new_cache(1), ids)[1]
    torch.cuda.synchronize()
    before = _launches(kernels_mod)
    sp.reset()
    decode_step(eng.params, eng.model_cfg, torch.tensor([5], device=eng.device),
                torch.tensor([len(ids)], device=eng.device), cache)
    torch.cuda.synchronize()
    out["step_launches"] = {k: n - before[k] for k, n in _launches(kernels_mod).items()}
    out["step_collectives"], out["step_staged"] = dict(sp.counts), dict(sp.staged)
    # the ring against the stats merge on layer 0's slice, for a random query
    q = torch.randn(1, eng.model_cfg.n_heads, eng.model_cfg.head_dim, device=eng.device,
                    generator=torch.Generator(device=eng.device).manual_seed(9)).to(torch.bfloat16)
    lengths = torch.tensor([len(ids)], device=eng.device)
    sp.reset()
    pair = (cache.k[0], cache.v[0])
    stats = sp_decode_attention_merged(q, pair, lengths, eng.model_cfg.n_kv_heads, sp)
    ring = sp_decode_attention_merged(q, pair, lengths, eng.model_cfg.n_kv_heads, sp, ring=True)
    out["ring_vs_stats"] = errors(ring, stats)[1]
    out["ring_collectives"], out["ring_staged"] = dict(sp.counts), dict(sp.staged)
    del cache
    t0 = time.perf_counter()
    out["greedy"] = list(eng.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=SP_TOKENS)))
    torch.cuda.synchronize()
    out["greedy_wall_s"] = time.perf_counter() - t0
    launches["A"] = _launches(kernels_mod)
    del eng
    torch.cuda.empty_cache()
    for name, kv in (("A2", "auto"), ("A8 copy", "int8")):
        e = InferenceEngine(conf["A2"], EngineConfig(max_seq_len=SP_SLOTS, kv_dtype=kv, mesh_shape=mesh,
                                                     seq_parallel=True), device="cuda")
        kernels_mod.reset_launches()
        got = _teacher_forced(torch, e, ids, refs[name]["tokens"])
        torch.cuda.synchronize()
        launches[name] = _launches(kernels_mod)
        out[name] = dict(logit_rel_err=errors(got, refs[name]["logits"], row_dims=1)[1],
                         cache_bytes=e.new_cache(1).nbytes, variants=dict(kernels_mod.KERNELS["kv_store"].variants))
        del e
    out["launches"] = launches
    return out


def _par_moe(torch, kernels_mod, conf, rank, ep) -> dict:
    """One rank of {"tp": 2} over gloo, both ranks on the one card, on model
    C (qwen3moe at Qwen3-30B-A3B's widths) with its experts split over the
    expert axis (`ep`: expert_parallel, 64 whole experts a rank) or over
    their ffn columns (384 of each expert's 768, down's K range): the
    teacher-forced logits of C and of its 2-layer copy against `_par_refs`
    (router near-ties left out), one decode step's launches and
    collectives, the expert bytes, then 8 requests on a paged BatchEngine
    (rank 0 submits, rank 1 follows)."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models.llama import decode_step
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    root = rank == 0
    refs = torch.load(conf["refs2"])
    mids = _moe_ids(torch)
    mesh = {"tp": 2}
    out, launches = {}, {}
    eng = InferenceEngine(conf["C"], EngineConfig(max_seq_len=1024, mesh_shape=mesh, expert_parallel=ep),
                          device="cuda")
    comm = eng.comm
    shapes = {k: list(eng.params["layers"][k].layer(0).qs.shape) for k in EXPERT_KEYS}
    out.update(backend=comm.backend, device=str(eng.device), n_layers=eng.model_cfg.n_layers,
               expert_bytes=_expert_bytes(eng.params), weight_bytes=_param_bytes(eng.params), shapes=shapes,
               expert_parallel=bool(eng.params.get("expert_parallel")))
    for name, e in (("C", eng), ("C2", None)):
        if e is None:
            e = InferenceEngine(conf["C2"], EngineConfig(max_seq_len=1024, mesh_shape=mesh, expert_parallel=ep),
                                device="cuda")
        ref = refs[name]
        kernels_mod.reset_launches()
        got, _, picks = _teacher_forced_moe(torch, e, mids, ref["tokens"])
        torch.cuda.synchronize()
        moved = [p != q for p, q in zip(picks, ref["picks"])]  # the rank picked other experts somewhere
        keep = [i for i, (near, m) in enumerate(zip(ref["near"], moved)) if not (near or m)]
        if len(keep) < MOE_MIN_ROWS:
            raise AssertionError(f"{name}: {len(keep)} rows without a router near-tie, too few to compare")
        res = dict(rows=len(ref["near"]), near_ties=sum(ref["near"]), moved=sum(moved),
                   compared=len(keep), logit_rel_err=errors(got[keep], ref["logits"][keep], row_dims=1)[1],
                   expert_bytes=_expert_bytes(e.params))
        if name == "C":  # one decode step counted alone
            cache = e.prefill(e.new_cache(1), mids)[1]
            torch.cuda.synchronize()
            before = _launches(kernels_mod)
            comm.reset()
            decode_step(e.params, e.model_cfg, torch.tensor([5], device=e.device),
                        torch.tensor([len(mids)], device=e.device), cache)
            torch.cuda.synchronize()
            res["step_launches"] = {k: n - before[k] for k, n in _launches(kernels_mod).items()}
            res["step_expected"] = {"grouped_q4": 2 * e.model_cfg.n_layers + _q4_downs(e),
                                    "grouped_q8": e.model_cfg.n_layers - _q4_downs(e)}
            res["step_collectives"], res["step_staged"] = dict(comm.counts), dict(comm.staged)
            res["tied"] = e.params["embed"] is None
            del cache
        launches[name] = _launches(kernels_mod)
        out[name] = res
        if name == "C2":
            del e
    # the paged BatchEngine on C's engine: rank 0 submits and steps, rank 1 follows
    kernels_mod.reset_launches()
    out["batch"] = _par_batch(torch, eng, root)
    torch.cuda.synchronize()
    launches["C server"] = _launches(kernels_mod)
    out["launches"] = launches
    return out


def _parallel_rank(world, rank, size, coord, backend, conf) -> None:
    """A child process: one rank of `world` (see `ParallelPhase`); writes
    its result to conf["out"] % rank and exits 1 on any failure."""
    import traceback

    # a spawned child takes the parent's environment as it stands at its
    # start, and the parent's main thread may then hold `_Switches(q8v3=True)`
    # around a parity copy: no world runs NFAI_Q8V3 (a 2(c) option under tp)
    os.environ.pop("NFAI_Q8V3", None)
    import torch
    import torch.distributed as dist

    from nfai_tpu_torch import kernels as kernels_mod
    from nfai_tpu_torch.parallel import init_distributed

    t0 = time.perf_counter()
    res = {"rank": rank, "world": world}
    try:
        init_distributed(coord, size, rank, backend=backend, timeout_s=PAR_GROUP_TIMEOUT_S)
        fns = {"nccl": lambda: _par_nccl(torch, kernels_mod, conf),
               "refs": lambda: _par_refs(torch, kernels_mod, conf),
               "tp2": lambda: _par_tp2(torch, kernels_mod, conf, rank),
               "sp2": lambda: _par_sp2(torch, kernels_mod, conf, rank),
               "ep2": lambda: _par_moe(torch, kernels_mod, conf, rank, True),
               "ffn2": lambda: _par_moe(torch, kernels_mod, conf, rank, False)}
        res.update(fns[world]())
        res["ok"] = True
    except BaseException:  # noqa: BLE001 - the parent reads it and fails the phase
        res["ok"] = False
        res["error"] = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    with open(conf["out"] % rank, "w") as f:
        json.dump(res, f)
    sys.exit(0 if res["ok"] else 1)


def _run_world(world, size, backend, conf, tmp) -> list[dict]:
    """Start `size` child ranks of `world`, wait PAR_TIMEOUT_S at most (then
    kill them), and return their results; a rank that fails, hangs or exits
    non-zero raises."""
    import multiprocessing as mp

    conf = dict(conf, out=os.path.join(tmp, f"par_{world}_%d.json"))
    coord = f"file://{os.path.join(tmp, f'rdv_{world}_{time.time_ns()}')}"
    ctx = mp.get_context("spawn")
    # daemons: a parent that stops on another phase's failure takes them with it
    procs = [ctx.Process(target=_parallel_rank, args=(world, r, size, coord, backend, conf), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results = []
    for r, p in enumerate(procs):
        path = conf["out"] % r
        res = json.load(open(path)) if os.path.exists(path) else {"ok": False, "error": "no result"}
        results.append(res)
        if not res["ok"] or p.exitcode != 0 or r in hung:
            raise AssertionError(f"parallel {world} rank {r}: exit {p.exitcode}"
                                 f"{' (killed: hung past the deadline)' if r in hung else ''}\n"
                                 f"{res.get('error', '')}")
    return results


def _child_route(path, launches, what) -> dict:
    """`_check_route` for launch counts read in a child process."""
    must, must_not = ROUTES[path]
    log(f"  {what} launches: { {k: v for k, v in launches.items() if v} }")
    if any(launches[n] <= 0 for n in must) or any(launches[n] != 0 for n in must_not):
        raise AssertionError(f"{what} did not take its route: {launches}")
    return launches


class ParallelPhase(threading.Thread):
    """The mesh on the one card (see the module doc): NCCL at world size 1,
    then tp = 2 over gloo with both ranks on the card. NCCL refuses two
    ranks of one communicator on one device, so two ranks share the card
    through gloo: the run proves the process-group plumbing, every kernel
    on each rank's shard shapes and the logits' parity with one device; it
    measures nothing of TP's speed (both ranks time-share one card and gloo
    stages through the host). The worlds run in child processes, waited on
    by this thread while the parent runs the parity copies, which time
    nothing; `finish` joins them and makes the checks."""

    def __init__(self, tmp, a_path=None, c_path=None):
        super().__init__(daemon=True)
        self.tmp, self.a_path, self.c_path = tmp, a_path, c_path
        self.results, self.error, self.seconds, self.conf = {}, None, 0.0, {}

    def run(self):
        from nfai_tpu_torch.testing import make_llama_1b_gguf, make_qwen2_1_5b_gguf, make_qwen3moe_gguf

        t0 = time.perf_counter()
        try:
            tmp = self.tmp
            conf = {"A": str(self.a_path or make_llama_1b_gguf(os.path.join(tmp, "llama1b_q4_k.gguf"),
                                                               kind="q4_k")),
                    "A2": str(make_llama_1b_gguf(os.path.join(tmp, "llama1b_2l_par.gguf"), kind="q4_k",
                                                 n_layers=2)),
                    "Q": str(make_qwen2_1_5b_gguf(os.path.join(tmp, "qwen2_2l_par.gguf"), n_layers=2)),
                    # 2-layer full-width copies of D (F16) and E (Q8_0) for tp = 2
                    "D2": str(make_llama_1b_gguf(os.path.join(tmp, "llama1b_2l_f16_par.gguf"), kind="f16",
                                                 n_layers=2)),
                    "E2": str(make_llama_1b_gguf(os.path.join(tmp, "llama8b_2l_par.gguf"), kind="llama_8b_q8_0",
                                                 n_layers=2)),
                    "C": str(self.c_path or make_qwen3moe_gguf(os.path.join(tmp, "qwen3moe_par.gguf"),
                                                               n_layers=C_LAYERS)),
                    "C2": str(make_qwen3moe_gguf(os.path.join(tmp, "qwen3moe_2l_par.gguf"), n_layers=2)),
                    "refs": os.path.join(tmp, "par_refs.pt"), "refs2": os.path.join(tmp, "par_refs2.pt")}
            self.conf = conf
            self.results["gguf_s"] = time.perf_counter() - t0
            for world, size, backend in (("nccl", 1, "nccl"), ("tp2", 2, "gloo"), ("refs", 1, "gloo"),
                                         ("sp2", 2, "gloo"), ("ep2", 2, "gloo"), ("ffn2", 2, "gloo")):
                t1 = time.perf_counter()
                ranks = _run_world(world, size, backend, conf, tmp)
                self.results[world] = ranks[0] if size == 1 else ranks
                self.results[f"{world}_s"] = time.perf_counter() - t1
        except BaseException as e:  # noqa: BLE001 - raised again by finish()
            self.error = e
        self.seconds = time.perf_counter() - t0

    def finish(self) -> tuple[dict, dict]:
        self.join()
        if self.error is not None:
            raise self.error
        return _parallel_checks(self.results, self.seconds)


def _parallel_checks(worlds: dict, seconds: float) -> tuple[dict, dict]:
    """The parallel phase's checks and lines, from its worlds' results."""
    n1, ranks = worlds["nccl"], worlds["tp2"]
    by_path = {}
    log(f"  parallel: GGUFs ready in {worlds['gguf_s']:.1f}s")
    log(f"  [backend {n1['backend']}, world 1, {n1['device']}] model A as a tp=1 mesh beside the single-device "
        f"engine: prefill logits bit-equal {n1['prefill_bit_equal']}; {PAR_TOKENS} greedy tokens equal "
        f"{n1['tokens'] == n1['ref_tokens']}; collectives {n1['collectives']}; the single-device engine's own "
        f"spread (prefill chunks of 256 against {PAR_CHUNK}, then the same {PAR_STEPS} steps) "
        f"{n1['route_spread']:.3e} per row; {n1['seconds']:.1f}s in the child")
    if not n1["prefill_bit_equal"] or n1["tokens"] != n1["ref_tokens"]:
        raise AssertionError("NCCL world size 1: the tp=1 mesh engine is not bit-equal to the single-device one")
    by_path["parallel nccl A"] = _child_route("parallel nccl A", n1["launches"], "NCCL tp=1 model A")
    for res in ranks:
        n_layers = res["n_layers"]
        r, b = res["rank"], f"[backend {res['backend']}, tp=2, rank {res['rank']} on {res['device']}]"
        log(f"  {b} local heads / kv-heads / ffn {res['local']}; weights {res['weight_bytes'] / 2**20:.1f} MiB "
            f"against {n1['weight_bytes'] / 2**20:.1f} MiB on one device; cache {res['cache_mb']:.1f} MiB at "
            f"1024 slots")
        log(f"  {b} model A prefill + {PAR_STEPS} teacher-forced steps: worst per-row rel err "
            f"{res['logit_rel_err']:.3e} against the single-device engine (tol {PATH_TOL:g}, A's routes "
            f"against each other at 16 layers; the single-device engine's own spread {n1['route_spread']:.3e})")
        if not res["logit_rel_err"] < PATH_TOL:
            raise AssertionError(f"tp=2 rank {r}: model A logits rel err {res['logit_rel_err']:.3e}")
        want = {"all_reduce": 2 * n_layers, "gather_vocab": 1}
        log(f"  {b} a decode step: collectives {res['step_collectives']} (staged through the host: "
            f"{res['step_staged']}), launches { {k: v for k, v in res['step_launches'].items() if v} }")
        if res["step_collectives"] != want:
            raise AssertionError(f"tp=2 rank {r}: a decode step made {res['step_collectives']}, not {want}")
        step = res["step_launches"]
        exp = dict(res["step_expected"], decode_attention=n_layers, kv_store=1)
        if {k: step[k] for k in exp} != exp:
            raise AssertionError(f"tp=2 rank {r}: decode step launches {step}, the route implies {exp}")
        by_path[f"parallel tp2 A r{r}"] = _child_route("parallel tp2 A", res["launches"]["A"], f"tp=2 rank {r} model A")
        by_path[f"parallel tp2 A server r{r}"] = _child_route("parallel tp2 A server", res["launches"]["A server"],
                                                             f"tp=2 rank {r} BatchEngine + server")
        for name in ("A2", "Q"):
            by_path[f"parallel tp2 {name} r{r}"] = _child_route(f"parallel tp2 {name}", res["launches"][name],
                                                               f"tp=2 rank {r} {name} copy")
            c = res[name]
            log(f"  {b} {name} copy (2 layers): local {c['local']}, head {c['head']}, tied table under the "
                f"head {c['embed_tied']}; weights {c['weight_bytes'] / 2**20:.1f} MiB against "
                f"{c['single_weight_bytes'] / 2**20:.1f} MiB; collectives {c['collectives']}; prefill + "
                f"{PAR_STEPS} steps worst per-row rel err {c['logit_rel_err']:.3e} (tol {TOL:g})")
            if not c["logit_rel_err"] < TOL:
                raise AssertionError(f"tp=2 rank {r}: the {name} copy's logits rel err {c['logit_rel_err']:.3e}")
        if not res["Q"]["collectives"].get("embed_reduce"):
            raise AssertionError(f"tp=2 rank {r}: the Q copy made no vocab-parallel embedding")
        log(f"  {b} BatchEngine {res['batch']}; all collectives {res['collectives']}, staged {res['staged']}; "
            f"{res['seconds']:.1f}s in the child")
    a, b = ranks
    for key in ("greedy", "sampled", "sampled_unseeded"):
        if a[key] != b[key]:
            raise AssertionError(f"tp=2: the ranks' {key} tokens differ: {a[key]} / {b[key]}")
    log(f"  tp=2: both ranks' greedy, seeded and unseeded sampled tokens agree; greedy {PAR_TOKENS} tokens "
        f"{a['greedy_wall_s'] * 1e3:.0f} ms on one shared card over gloo (two ranks time-sharing one H100: "
        f"says nothing of TP's speed)")
    if a["batch"]["requests"] != 8 or a["batch"]["prefix_hits"] <= 0:
        raise AssertionError(f"tp=2 BatchEngine: {a['batch']}")
    by_path.update(_mesh_checks(worlds))
    by_path.update(_sp_checks(worlds))
    by_path.update(_moe_checks(worlds))
    log(f"  parallel phase: {seconds:.1f}s beside the parity copies (the GGUFs {worlds['gguf_s']:.1f}s, NCCL "
        f"world {worlds['nccl_s']:.1f}s, tp=2 world {worlds['tp2_s']:.1f}s, references {worlds['refs_s']:.1f}s, "
        f"sp=2 world {worlds['sp2_s']:.1f}s, expert-parallel world {worlds['ep2_s']:.1f}s, ffn-split world "
        f"{worlds['ffn2_s']:.1f}s)")
    return dict(worlds, seconds=seconds), by_path


def _mesh_checks(worlds: dict) -> dict:
    """The other meshes' checks and lines, from the tp = 2 world's ranks and the NCCL
    child's one-device references: the draft model under tp = 2, the dp
    split of A's dense BatchEngine, the extra axis, D's and E's copies."""
    ref, by_path = worlds["nccl"]["dense_batch"], {}
    ranks = worlds["tp2"]
    for res in ranks:
        r = res["rank"]
        b = f"[backend {res['backend']}, rank {r} on {res['device']}]"
        d = res["draft"]
        log(f"  {b} tp=2, speculative='draft' (A's 2-layer copy drafting for A, {SPEC_GAMMA} a round): "
            f"accepted {d['accepted']} of {d['drafted']} drafts; the draft engine shares the target's Mesh "
            f"{d['mesh_shared']}, has its own Comm {d['own_comm']}, local heads / kv-heads / ffn "
            f"{d['draft_local']}, collectives {d['draft_collectives']}; {d['wall_s'] * 1e3:.0f} ms")
        d["equal_prefix"], d["tie_gap"] = _tie_prefix(f"tp=2 rank {r} speculative='draft' greedy", d["tokens"],
                                                      d["plain"], d["gaps"], d["margin"])
        if not (d["mesh_shared"] and d["own_comm"]) or not d["drafted"]:
            raise AssertionError(f"tp=2 rank {r}: the draft model: {d}")
        by_path[f"parallel tp2 A draft r{r}"] = _child_route("parallel tp2 A draft", res["launches"]["A draft"],
                                                             f"tp=2 rank {r} draft")
        dp = res["dp2"]
        m, n = dp["measured"], dp["measured"]["steps"]
        step = {k: v / n for k, v in m["launches"].items() if v}
        b = f"[backend {dp['backend']}, dp=2, rank {r} (dp rank {dp['dp_rank']})]"
        log(f"  {b} model A's dense BatchEngine, {DP_BATCH} lanes: the rank's lanes {dp['lanes']}, cache "
            f"{dp['cache_bytes'] / 2**20:.1f} MiB against {ref['cache_bytes'] / 2**20:.1f} MiB on one device; "
            f"weights {dp['weight_bytes'] / 2**20:.1f} MiB (replicated); a chunk of {n} decode steps with every "
            f"lane decoding: launches a step {step} (one device's: "
            f"{ {k: v / ref['measured']['steps'] for k, v in ref['measured']['launches'].items() if v} }), dp "
            f"collectives a chunk {m['dp']} (staged through the host {m['staged']}); the whole run "
            f"{dp['wall_s']:.1f}s, dp collectives {dp['dp_all']}")
        want = {"q4_matmul": 33, "fused_mlp": 16, "decode_attention": 16, "kv_store": 1}
        if (2 * dp["cache_bytes"] != ref["cache_bytes"] or dp["lanes"] != [4 * r, 4]
                or {k: step.get(k) for k in want} != want or m["dp"] != {"gather_lanes": 1}):
            raise AssertionError(f"dp=2 rank {r}: {dp}")
        by_path[f"parallel dp2 A r{r}"] = _child_route("parallel dp2 A", res["launches"]["A dp2"],
                                                       f"dp=2 rank {r} dense BatchEngine")
        x = res["x2"]
        log(f"  [rank {r}] mesh {x['dims']} on A's 2-layer copy: groups {x['groups']}, split params "
            f"{x['params_comm']}; prefill + {PAR_STEPS} teacher-forced steps bit-equal to one device "
            f"{x['logits_bit_equal']}; greedy tokens equal {x['tokens'] == x['ref_tokens']}")
        if (not x["logits_bit_equal"] or x["tokens"] != x["ref_tokens"] or x["params_comm"]
                or x["groups"] != {"dp": [r], "tp": [r], "x": [0, 1]}):
            raise AssertionError(f"rank {r}: the extra axis: {x}")
        by_path[f"parallel x2 A2 r{r}"] = _child_route("parallel x2 A2", res["launches"]["A2 x2"],
                                                       f"{EXTRA_AXIS} rank {r} A2")
        for name, kernel, what in (("D2", "dense_matmul", "F16, K11"), ("E2", "q8_matmul", "Q8_0, NFAI_Q8V3=1")):
            c = res[name]
            nl = c["n_layers"]
            st = {k: v for k, v in c["step_launches"].items() if v}
            # E's rank keeps K6's containers, one device under the switch runs K12: other routes, so
            # PATH_TOL against it, and TOL against one device on K6 (the same containers)
            err = (f"{c['logit_rel_err']:.3e} (tol {TOL:g})" if name == "D2" else
                   f"{c['logit_rel_err']:.3e} against one device under the switch (K12; tol {PATH_TOL:g}, one "
                   f"device's own K12-against-K6 spread {worlds['nccl']['e2_route_spread']:.3e}), "
                   f"{c['k6_rel_err']:.3e} against one device on K6 (tol {TOL:g})")
            log(f"  [rank {r}] tp=2, {name} ({what}, 2 layers at full width): weights "
                f"{c['weight_bytes'] / 2**20:.1f} MiB against {c['single_weight_bytes'] / 2**20:.1f} MiB on one "
                f"device; containers {c['kinds']} at {c['shapes']}; a decode step's launches {st}, collectives "
                f"{c['step_collectives']}; prefill + {PAR_STEPS} teacher-forced steps worst per-row rel err {err}")
            want = 4 * nl + (1 if name == "E2" else 0)  # E's untied 8-bit head on K6; D's tied dense head on matmul
            ok = c["logit_rel_err"] < TOL if name == "D2" else c["logit_rel_err"] < PATH_TOL and c["k6_rel_err"] < TOL
            if not ok or c["step_launches"][kernel] != want or c["step_launches"]["q8v3_matmul"] != 0:
                raise AssertionError(f"tp=2 rank {r}: {name}: {c}")
            by_path[f"parallel tp2 {name} r{r}"] = _child_route(
                "parallel tp2 D2" if name == "D2" else "parallel tp2 E2 q8v3", res["launches"][name],
                f"tp=2 rank {r} {name}")
    # rank 0's tokens against one device's dense BatchEngine: a greedy stream
    # may part from it only at a near-tie (TOL x the logit scale, `_tie_prefix`:
    # a rank's K2 splits 4 rows' keys over other blocks than 8 rows', so its
    # merge rounds apart); a sampled one takes the same draws
    dp = ranks[0]["dp2"]
    parts = []
    for i, (got, want, entries) in enumerate(zip(dp["tokens"], ref["tokens"], ref["logprobs"])):
        if i % 2 == 0:
            parts.append(_tie_prefix(f"dp=2 dense BatchEngine, greedy request {i}", got, want, _gaps(entries),
                                     TOL * ref["scale"])[0])
        else:
            part = next((j for j, (a, c) in enumerate(zip(got, want)) if a != c), min(len(got), len(want)))
            parts.append(part)
            log(f"  dp=2 dense BatchEngine, sampled request {i}: equals one device's for {part} of {len(want)} "
                f"tokens")
            if part == 0:
                raise AssertionError(f"dp=2 sampled request {i}: its first token (the same prefill) differs")
    log(f"  dp=2: {dp['new_tokens']} tokens in {dp['wall_s']:.1f}s (one device {ref['new_tokens']} in "
        f"{ref['wall_s']:.1f}s; two ranks time-share one card over gloo: says nothing of dp's speed); "
        f"streams equal for {parts} of {DP_NEW} tokens")
    return by_path


def _sp_checks(worlds: dict) -> dict:
    """The sp=2 world's checks and lines."""
    refs, by_path = worlds["refs"], {}
    ranks = worlds["sp2"]
    for res in ranks:
        r, n = res["rank"], res["n_layers"]
        b = f"[backend {res['backend']}, sp=2, rank {r} on {res['device']}]"
        shape, offset, span = res["cache"]
        log(f"  {b} model A, {SP_PROMPT}-token prompt in {SP_SLOTS} slots: the rank's cache {shape} from slot "
            f"{offset} of {span}, {res['cache_bytes'] / 2**20:.1f} MiB against {refs['A cache_bytes'] / 2**20:.1f} "
            f"MiB on one device; prefill + {SP_TOKENS} teacher-forced steps worst per-row rel err "
            f"{res['logit_rel_err']:.3e} (prefill {res['prefill_rel_err']:.3e}; tol {PATH_TOL:g}) in "
            f"{res['teacher_forced_s']:.1f}s")
        if not res["logit_rel_err"] < PATH_TOL or offset != r * span // 2 or shape[2] * 2 != span:
            raise AssertionError(f"sp=2 rank {r}: model A rel err {res['logit_rel_err']:.3e}, cache {res['cache']}")
        want = {"all_max": n, "all_reduce": 2 * n}
        step = res["step_launches"]
        log(f"  {b} a decode step: sp collectives {res['step_collectives']} (staged {res['step_staged']}), "
            f"launches { {k: v for k, v in step.items() if v} }")
        if res["step_collectives"] != want or step["kv_store"] != n or step["decode_attention"]:
            raise AssertionError(f"sp=2 rank {r}: a decode step made {res['step_collectives']} and {step}")
        log(f"  {b} layer 0's slices, one random query: the ring against the stats merge rel err "
            f"{res['ring_vs_stats']:.3e} (ring + merge collectives {res['ring_collectives']}, staged "
            f"{res['ring_staged']})")
        if not res["ring_vs_stats"] < 1e-3 or res["ring_collectives"].get("ring") != 1:
            raise AssertionError(f"sp=2 rank {r}: ring against stats merge {res['ring_vs_stats']:.3e}")
        by_path[f"parallel sp2 A r{r}"] = _child_route("parallel sp2 A", res["launches"]["A"], f"sp=2 rank {r} model A")
        for name in ("A2", "A8 copy"):
            c = res[name]
            log(f"  {b} {name} (2 layers, {'int8' if name == 'A8 copy' else 'bf16'} cache): teacher-forced worst "
                f"per-row rel err {c['logit_rel_err']:.3e} (tol {TOL:g}); cache {c['cache_bytes'] / 2**20:.2f} MiB "
                f"against {refs[f'{name} cache_bytes'] / 2**20:.2f}; store variants {c['variants']}")
            if not c["logit_rel_err"] < TOL:
                raise AssertionError(f"sp=2 rank {r}: {name} rel err {c['logit_rel_err']:.3e}")
            by_path[f"parallel sp2 {name} r{r}"] = _child_route(f"parallel sp2 {name}", res["launches"][name],
                                                               f"sp=2 rank {r} {name}")
    a, b = ranks
    if a["greedy"] != b["greedy"]:
        raise AssertionError(f"sp=2: the ranks' greedy tokens differ: {a['greedy']} / {b['greedy']}")
    same = sum(x == y for x, y in zip(a["greedy"], refs["A tokens"]))
    log(f"  sp=2: both ranks' {SP_TOKENS} greedy tokens agree; {same} of them equal the single-device engine's; "
        f"{a['greedy_wall_s'] * 1e3:.0f} ms on one shared card over gloo (says nothing of SP's speed)")
    return by_path


def _moe_checks(worlds: dict) -> dict:
    """The expert-parallel and ffn-split worlds' checks and lines."""
    refs, by_path = worlds["refs"], {}
    for world, what in (("ep2", "expert parallelism"), ("ffn2", "the ffn split")):
        ranks = worlds[world]
        for res in ranks:
            r, n = res["rank"], res["n_layers"]
            b = f"[backend {res['backend']}, tp=2 {what}, rank {r} on {res['device']}]"
            log(f"  {b} model C: expert stacks (layer 0) {res['shapes']}, expert bytes "
                f"{res['expert_bytes'] / 2**20:.1f} MiB against {refs['C expert_bytes'] / 2**20:.1f} MiB on one "
                f"device; all weights {res['weight_bytes'] / 2**20:.1f} MiB")
            if res["expert_parallel"] != (world == "ep2") or 2 * res["expert_bytes"] != refs["C expert_bytes"]:
                raise AssertionError(f"{world} rank {r}: expert bytes {res['expert_bytes']}")
            for name, tol in (("C", PATH_TOL), ("C2", TOL)):
                c = res[name]
                log(f"  {b} {name} ({n if name == 'C' else 2} layers) {MOE_PROMPT} prompt rows + {PAR_STEPS} "
                    f"teacher-forced steps: worst per-row rel err {c['logit_rel_err']:.3e} over {c['compared']} "
                    f"rows (left out: {c['near_ties']} router near-ties on one device, {c['moved']} rows whose "
                    f"experts moved at some layer; tol {tol:g})")
                if not c["logit_rel_err"] < tol or 2 * c["expert_bytes"] != refs[f"{name} expert_bytes"]:
                    raise AssertionError(f"{world} rank {r}: {name} rel err {c['logit_rel_err']:.3e}")
                by_path[f"parallel {world} {name} r{r}"] = _child_route(
                    f"parallel {world} {name}", res["launches"][name], f"{world} rank {r} {name}")
            c = res["C"]
            step = c["step_launches"]
            want = {"all_reduce": 2 * n, "gather_vocab": 1, **({"embed_reduce": 1} if c["tied"] else {})}
            log(f"  {b} a decode step: collectives {c['step_collectives']} (staged {c['step_staged']}); grouped "
                f"launches K8 {step['grouped_q4']}, K9 {step['grouped_q8']} (route implies {c['step_expected']})")
            if c["step_collectives"] != want or {k: step[k] for k in c["step_expected"]} != c["step_expected"]:
                raise AssertionError(f"{world} rank {r}: a decode step made {c['step_collectives']}, {step}")
            by_path[f"parallel {world} C server r{r}"] = _child_route(
                f"parallel {world} C server", res["launches"]["C server"], f"{world} rank {r} BatchEngine")
            log(f"  {b} BatchEngine {res['batch']}; {res['seconds']:.1f}s in the child")
        if ranks[0]["batch"]["requests"] != 8:
            raise AssertionError(f"{world} BatchEngine: {ranks[0]['batch']}")
    return by_path


PP_STAGES = 2


def phase_pipeline(torch, kernels_mod, a_path) -> tuple[dict, dict]:
    """The pipeline stage split in this process (parallel.pipeline_parallel):
    model A in PP_STAGES stages, both on cuda:0, against its one-stage
    forward: a prefill of the parallel phase's prompt, then PAR_STEPS decode
    steps fed the one-stage greedy tokens; the launches of the pipelined run
    alone, checked against A's route."""
    from nfai_tpu_torch.config import EngineConfig
    from nfai_tpu_torch.models.llama import forward, logits_for
    from nfai_tpu_torch.parallel import pp_forward, split_cache, split_stages
    from nfai_tpu_torch.runtime.engine import InferenceEngine

    e = InferenceEngine(a_path, EngineConfig(max_seq_len=1024), device="cuda")
    cfg, dev = e.model_cfg, e.device
    ids = e.tokenizer.encode(PAR_PROMPT)
    stages = split_stages(e.params, PP_STAGES, cfg)

    def one(t, p, cache):
        with torch.inference_mode():
            return forward(e.params, cfg, t, p, cache)

    def piped(t, p, caches):
        return pp_forward(stages, t, p, caches, devices=[dev] * PP_STAGES)

    def rollout(step, state, head, toks=None):
        """Prefill, then PAR_STEPS steps fed `toks` (or the greedy tokens);
        returns (f32 logits [1 + PAR_STEPS, V] on the host, the tokens)."""
        h, state = step(torch.tensor([ids], device=dev), torch.arange(len(ids), device=dev)[None], state)
        rows, fed = [logits_for(head, h[:, -1], cfg)], []
        for j in range(PAR_STEPS):
            fed.append(int(torch.argmax(rows[-1], -1)) if toks is None else toks[j])
            h, state = step(torch.tensor([[fed[-1]]], device=dev), torch.tensor([[len(ids) + j]], device=dev), state)
            rows.append(logits_for(head, h[:, -1], cfg))
        return torch.cat(rows).float().cpu(), fed

    want, toks = rollout(one, e.new_cache(1), e.params)
    torch.cuda.synchronize()
    kernels_mod.reset_launches()
    got, _ = rollout(piped, split_cache(e.new_cache(1), PP_STAGES), stages[-1][0], toks)
    torch.cuda.synchronize()
    launches = _check_route(kernels_mod, "pipeline A", f"pipeline ({PP_STAGES} stages on {dev}) model A")
    err = check(f"pipeline: model A in {PP_STAGES} stages, prefill of {len(ids)} tokens + {PAR_STEPS} teacher-forced "
                f"decode steps against the one-stage forward", got, want, TOL, row_dims=1)
    per_stage = [sorted(k for k in ("embed", "lm_head", "final_norm") if st.get(k) is not None) for st, _ in stages]
    same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    log(f"  pipeline: bit-equal {bool(torch.equal(got, want))}; argmax equal {same_argmax}; stage layers "
        f"{[c.n_layers for _, c in stages]}, each stage's own entries {per_stage}")
    if not same_argmax or per_stage[-1] != ["final_norm", "lm_head"] or "lm_head" in per_stage[0]:
        raise AssertionError(f"pipeline: argmax equal {same_argmax}, stage entries {per_stage}")
    del e
    return dict(max_abs_err=err, bit_equal=bool(torch.equal(got, want))), {"pipeline A": launches}


KEPT_GGUF: dict[str, str] = {}  # model -> a GGUF main_path left for a later phase


def main_path(torch, kernels_mod, label, kind, tmp, only, summary, phase_s) -> dict:
    """Write the model's GGUF and drive it (`_drive_model`); model A's file
    then also serves A8, a second engine with the int8 KV cache. Returns
    the launch counts of each path."""
    from nfai_tpu_torch import testing
    from nfai_tpu_torch.testing import make_gemma2_2b_gguf, make_llama_1b_gguf, make_qwen3moe_gguf

    t0 = time.perf_counter()
    if kind in FAMILY_BUILDERS:
        builder, depth = FAMILY_BUILDERS[kind]
        path = getattr(testing, builder)(os.path.join(tmp, f"{kind}.gguf"), n_layers=depth)
    elif kind == "qwen3moe":
        path = make_qwen3moe_gguf(os.path.join(tmp, "qwen3moe.gguf"), n_layers=C_LAYERS)
    elif kind == "gemma2_2b":
        path = make_gemma2_2b_gguf(os.path.join(tmp, "gemma2_2b.gguf"), n_layers=G_LAYERS)
    elif kind == "llama_8b_q8_0":
        path = make_llama_1b_gguf(os.path.join(tmp, "llama8b_q8_0.gguf"), kind=kind, n_layers=E_LAYERS)
    else:
        path = make_llama_1b_gguf(os.path.join(tmp, f"llama1b_{kind}.gguf"), kind=kind,
                                  n_layers={"B": B_LAYERS, "D": D_LAYERS}.get(label))
    log(f"model {label} ({kind}): wrote {path.stat().st_size / 2**30:.2f} GiB GGUF "
        f"in {time.perf_counter() - t0:.1f}s")
    if "tools" in only and label in HOST_DECODE:
        t0 = time.perf_counter()
        summary.setdefault("host_decode", {})[label] = _host_decode(torch, label, path)
        phase_s[f"tools host {label}"] = time.perf_counter() - t0
    if not ({"serve", "batch"} & set(only) or label == "A"):  # --only tools: C, Q and D for their decodes
        os.remove(path)
        return {}
    by_path = _drive_model(torch, kernels_mod, label, path, only, summary, phase_s)
    if label in ("A", "E", "Q"):
        if {"serve", "batch", "profile", "server", "options"} & set(only):  # not for constrained/spec alone
            log(f"model {label}8 ({kind}, kv_dtype int8): a second engine on model {label}'s GGUF")
            by_path.update(_drive_model(torch, kernels_mod, f"{label}8", path, only, summary, phase_s,
                                        "int8"))
    if label in ("A", "C") and "parallel" in only:  # the parallel phase serves A's and C's files again
        KEPT_GGUF[label] = path
    else:
        os.remove(path)
    return by_path


def _drive_model(torch, kernels_mod, label, path, only, summary, phase_s, kv_dtype="auto") -> dict:
    """Serve (and batch, long context, profile) one engine with the launch
    counts zeroed just before; the counts read just after are checked
    against the model's route. Model A's engine (and A8's) then runs the
    server phase, models C's and G's their paged BatchEngine."""
    with _Switches(layout=E_LAYOUTS.get(label)):
        return _drive_engine(torch, kernels_mod, label, path, only, summary, phase_s, kv_dtype)


def _drive_engine(torch, kernels_mod, label, path, only, summary, phase_s, kv_dtype) -> dict:
    out = {}
    kernels_mod.reset_launches()
    t0 = time.perf_counter()
    served = phase_serve(torch, path, kv_dtype, q8v3=label in ("E", "E8"))
    engine = served["engine"]
    out["requests"], out["load_s"] = served["requests"], served["load_s"]
    phase_s[f"serve {label}"] = time.perf_counter() - t0
    if "batch" in only:
        t0 = time.perf_counter()
        batch = phase_batch(torch, engine, kernels_mod)
        state = batch.pop("state")
        out["batch"] = batch
        if label in ("A", "A8"):  # the long-context decode users of the int8 cache run it for
            out["long_context"] = phase_long_context(torch, engine)
        phase_s[f"batch {label}"] = time.perf_counter() - t0
        if "profile" in only:
            t0 = time.perf_counter()
            out["profile"] = phase_profile(torch, engine, state)
            if label in PREFILL_PROFILED:
                expect = PREFILL_PROFILED[label](engine, engine.model_cfg.n_layers)
                prof = out["prefill_profile"] = phase_profile_prefill(torch, engine, expect)
                ms = prof["device_ms_by_function"]
                log(f"  model {label} prefill 8x128: {out['batch']['prefill_ms']:.1f} ms (host clock, "
                    f"synchronised, batch phase; median of five {prof['median_wall_ms']:.1f}); device "
                    f"{prof['device_ms']:.2f} ms: "
                    + ", ".join(f"{f} {ms[f]:.4f} in {n} launches" for f, n in expect.items()))
            if label == "Q":  # what the q/k/v biases add to a decode step
                out["bias_cost"] = _bias_cost(torch, engine, state, out["profile"])
            if label == "A":  # K5 at M = 1024 (a layer's MLP), K1's tiles for wqkv and wo
                n_layers = engine.model_cfg.n_layers
                prof = out["prefill_profile"] = phase_profile_prefill(
                    torch, engine, {"q4_wgmma": 2 * n_layers, "q4_gemv": 1, "fused_mlp": n_layers,
                                    "prefill_attn": n_layers})
                ms = prof["device_ms_by_function"]
                log(f"  model A prefill 8x128: {out['batch']['prefill_ms']:.1f} ms (host clock, "
                    f"synchronised, batch phase; median of five {prof['median_wall_ms']:.1f}); device "
                    f"{prof['device_ms']:.2f} ms: K5 {ms['fused_mlp']:.2f} in {n_layers} launches, K1's "
                    f"tiles {ms['q4_wgmma']:.2f} in {2 * n_layers}, K4 {ms['prefill_attn']:.4f}")
            phase_s[f"profile {label}"] = time.perf_counter() - t0
        del state
    launches = _check_route(kernels_mod, label, f"model {label}")
    if "batch" in out:
        per_step = out["batch"]["launches_per_step"]
        n_layers = engine.model_cfg.n_layers
        stores = {"per step": per_step["kv_store"],
                  "per prefill chunk": out["batch"]["launches_per_prefill_chunk"]["kv_store"]}
        if stores != {"per step": 1, "per prefill chunk": n_layers}:
            raise AssertionError(f"model {label}: store launches {stores}; the route implies one a decode "
                                 f"step and one a layer ({n_layers}) a prefill chunk")
        if label in ("A", "A8") and per_step["fused_mlp"] != n_layers:
            raise AssertionError(f"model {label}: {per_step['fused_mlp']} K5 launches per step, "
                                 f"not one per layer ({n_layers})")
        if label == "A8":
            want = {"decode_attention_i8": n_layers, "kv_store": 1, "decode_attention": 0}
            got = {k: per_step[k] for k in want}
            if got != want or out["batch"]["host_syncs_per_step"] != 0:
                raise AssertionError(f"model A8: per decode step {got} and "
                                     f"{out['batch']['host_syncs_per_step']} host syncs; the route implies "
                                     f"{want} and none")
            a = summary["model A"]["batch"]
            log(f"  cache at batch 8, S 1024: int8 {out['batch']['cache_mb']:.1f} MB (codes and scales) "
                f"against bf16 {a['cache_mb']:.1f} MB (model A)")
        if label == "B" and not per_step["q8_matmul"] > 0:
            raise AssertionError("model B: no K6 launch in a decode step")
        if label == "C":
            _check_moe_step(engine, per_step)
        if label in ("E", "E8"):  # K12 for wqkv, wo, gate_up, down and the head; K4-hm once a layer a chunk
            _check_e_step(engine, out["batch"], quant=label == "E8")
        if label in ("Q", "Q8", "P", "M"):
            _check_family_step(engine, label, out["batch"])
        if label == "D":  # K11 for wqkv, wo, gate_up and down on every layer, nothing else
            want = {"dense_matmul": 4 * n_layers, "q4_matmul": 0, "q8_matmul": 0, "fused_mlp": 0}
            got = {k: per_step[k] for k in want}
            if got != want or out["batch"]["host_syncs_per_step"] != 0:
                raise AssertionError(f"model D: per decode step {got} and "
                                     f"{out['batch']['host_syncs_per_step']} host syncs; the route "
                                     f"implies {want} and none")
    summary[f"model {label}"] = out
    by_path = {label: launches}
    if label in ("A", "A8") and "server" in only:  # on the engine already loaded
        t0 = time.perf_counter()
        name = "server" if label == "A" else "A8 server"
        summary[name], by_path[name] = phase_server(torch, engine, kernels_mod, route=name,
                                                    n_http=8 if label == "A" else 4)
        if label == "A8":
            bf16 = summary["server"]["batch_engine"]["pool_mb"]
            log(f"  BatchEngine pool: int8 {summary[name]['batch_engine']['pool_mb']:.1f} MB (codes and "
                f"scales) against bf16 {bf16:.1f} MB (server)")
        phase_s[name] = time.perf_counter() - t0
    if label in ("A", "A8") and "options" in only:  # on the engine already loaded
        t0 = time.perf_counter()
        summary[f"options {label}"], paths = phase_options(torch, engine, kernels_mod, label,
                                                           os.path.dirname(path))
        by_path.update(paths)
        phase_s[f"options {label}"] = time.perf_counter() - t0
    if label == "A" and "eval" in only:
        t0 = time.perf_counter()
        summary["eval"], by_path["A eval"] = phase_eval(torch, engine, kernels_mod, os.path.dirname(path))
        phase_s["eval"] = time.perf_counter() - t0
    if label == "A" and "tools" in only:  # on the engine already loaded
        t0 = time.perf_counter()
        summary["tools"], paths = phase_tools(torch, engine, kernels_mod, path, os.path.dirname(path))
        by_path.update(paths)
        phase_s["tools"] = time.perf_counter() - t0
    if label == "A" and "constrained" in only:  # on the engine already loaded
        t0 = time.perf_counter()
        summary["constrained"], paths = phase_constrained(torch, engine, kernels_mod)
        by_path.update(paths)
        phase_s["constrained"] = time.perf_counter() - t0
    if label == "A" and "spec" in only:
        t0 = time.perf_counter()
        summary["spec"], paths = phase_spec(torch, engine, kernels_mod, path)
        by_path.update(paths)
        phase_s["spec"] = time.perf_counter() - t0
    if label in ("C", "G", "D", "E", "Q", "P", "M") and "server" in only:
        t0 = time.perf_counter()
        kernels_mod.reset_launches()
        with _Switches(layout=E_LAYOUTS.get(f"{label} server")):
            summary[f"server {label}"] = _paged_server_run(torch, engine, label)
            if label in ("Q", "P", "M"):  # and the HTTP server: one SSE chat, one completion
                summary[f"server {label}"]["http"] = _http_run(torch, engine, 2)
        by_path[f"{label} server"] = _check_route(kernels_mod, f"{label} server", f"model {label}'s server path")
        if label == "E":  # every K4 launch of the path on the merged-lane instance
            k4 = PATH_VARIANTS["E server"].get("prefill_attention", {})
            if not k4 or any(not v.startswith("merged") for v in k4):
                raise AssertionError(f"E server: K4 launched {k4}, not only its merged variant")
        phase_s[f"server {label}"] = time.perf_counter() - t0
    del served, engine
    torch.cuda.empty_cache()
    return by_path


def _sum_variants(name) -> dict:
    """A kernel's main-path launches by variant (head width, softcap,
    window), summed over the paths."""
    total: dict[str, int] = {}
    for variants in PATH_VARIANTS.values():
        for v, n in variants.get(name, {}).items():
            total[v] = total.get(v, 0) + n
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--kernels", default=None,
                    help=f"kernels phase: only these kernels, of {sorted(KERNEL_PHASES)}")
    ap.add_argument("--models", default=None,
                    help=f"serve/batch/profile/server: only these models, of {sorted(MODELS)}")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    if bad := set(only) - set(PHASES):
        ap.error(f"unknown phases {sorted(bad)}")
    subset = None if args.kernels is None else [k for k in args.kernels.split(",") if k]
    if subset is not None and (bad := set(subset) - set(KERNEL_PHASES)):
        ap.error(f"unknown kernels {sorted(bad)}")
    models = MODELS
    if args.models is not None:
        names = [m for m in args.models.split(",") if m]
        if bad := set(names) - set(MODELS):
            ap.error(f"unknown models {sorted(bad)}")
        models = {m: MODELS[m] for m in names}
    whole = set(only) == set(PHASES) and subset is None and models is MODELS

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from nfai_tpu_torch import kernels as kernels_mod
    from nfai_tpu_torch import testing
    from nfai_tpu_torch.testing import (
        GEMMA3_1B_KINDS, make_gemma3_1b_gguf, make_llama_1b_gguf, make_qwen3moe_gguf,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    phase_s = {}
    summary: dict = {}
    tmp = tempfile.mkdtemp(prefix="nfai_smoke_")
    try:
        t0 = time.perf_counter()
        summary.update(phase_build(torch, kernels_mod))
        phase_s["build"] = time.perf_counter() - t0
        timer = Timer(torch)
        kern = {}
        if "kernels" in only:
            t0 = time.perf_counter()
            kern = phase_kernels(torch, timer, subset)
            phase_s["kernels"] = time.perf_counter() - t0
        launches = None
        by_path = {}
        # they run on A's (and A8's) engines; tools also decodes C's, Q's and D's files on the host
        engine_phases = {"options", "eval", "constrained", "spec", "tools"}
        if not {"serve", "batch"} & set(only) and engine_phases & set(only):
            keep = {"A"} | (set(HOST_DECODE) if "tools" in only else set())
            models = {m: k for m, k in models.items() if m in keep}
        if {"serve", "batch"} & set(only) or engine_phases & set(only):
            for label, kind in models.items():
                by_path.update(main_path(torch, kernels_mod, label, kind, tmp, only, summary, phase_s))
            if "tools" in only:
                _log_load_times(summary)
        parallel = None
        if "parallel" in only:  # in child processes, beside the parity copies: A's and the copies' paths
            a_path = KEPT_GGUF.pop("A", None)
            parallel = ParallelPhase(tmp, a_path, KEPT_GGUF.pop("C", None))
            parallel.start()
        if "parity" in only:
            t0 = time.perf_counter()
            summary["parity"] = {}
            timed = lambda name, t: phase_s.__setitem__(f"parity {name}", time.perf_counter() - t)  # noqa: E731
            # --models naming only the families' models: only their parity copies
            families_only = set(models) <= set(FAMILY_MODELS)
            for kind in () if families_only else PARITY_KINDS:
                t1 = time.perf_counter()
                path2 = make_llama_1b_gguf(os.path.join(tmp, f"llama1b_2l_{kind}.gguf"),
                                           kind=kind, n_layers=2)
                # the Q4_K copy also with an int8 cache on both sides
                summary["parity"].update(phase_parity(
                    torch, path2, kind, ("auto", "int8") if kind == "q4_k" else ("auto",)))
                if kind in PARITY_PARAM_DTYPE:
                    summary["parity"].update(phase_parity(
                        torch, path2, kind, param_dtype=PARITY_PARAM_DTYPE[kind]))
                if kind == "q4_k_m":  # model B's mix under NFAI_Q8V3=1
                    summary["parity"].update(phase_parity(torch, path2, kind, q8v3=True))
                os.remove(path2)
                timed(kind, t1)
            if not families_only:
                t1 = time.perf_counter()
                path2 = make_llama_1b_gguf(os.path.join(tmp, "llama8b_2l_q8_0.gguf"),
                                           kind="llama_8b_q8_0", n_layers=2)
                summary["parity"].update(phase_parity_e(torch, kernels_mod, path2))
                os.remove(path2)
                timed("E", t1)
                t1 = time.perf_counter()
                path2 = make_qwen3moe_gguf(os.path.join(tmp, "qwen3moe_2l.gguf"), n_layers=2)
                summary["parity"].update(phase_parity_moe(torch, path2, ("auto", "int8")))
                summary["parity"].update(phase_parity_moe(torch, path2, param_dtype="bfloat16"))
                os.remove(path2)
                timed("qwen3moe", t1)
            for kind in () if families_only else GEMMA3_1B_KINDS:
                t1 = time.perf_counter()
                path2 = make_gemma3_1b_gguf(os.path.join(tmp, f"gemma3_1b_2l_{kind}.gguf"),
                                            n_layers=2, kind=kind)
                summary["parity"].update(phase_parity_gemma3(torch, kernels_mod, path2, kind))
                os.remove(path2)
                timed(f"gemma3 {kind}", t1)
            for label, kind in FAMILY_MODELS.items():
                if label not in models:
                    continue
                t1 = time.perf_counter()
                path2 = getattr(testing, FAMILY_BUILDERS[kind][0])(os.path.join(tmp, f"{kind}_2l.gguf"),
                                                                   n_layers=2)
                summary["parity"].update(phase_parity(torch, path2, kind,
                                                      ("auto", "int8") if label == "Q" else ("auto",)))
                os.remove(path2)
                timed(f"{label} ({kind})", t1)
            phase_s["parity"] = time.perf_counter() - t0
        if parallel is not None:
            t0 = time.perf_counter()
            summary["parallel"], paths = parallel.finish()
            by_path.update(paths)
            phase_s["parallel"] = parallel.seconds
            phase_s["parallel after parity"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            summary["pipeline"], paths = phase_pipeline(torch, kernels_mod, parallel.conf["A"])
            by_path.update(paths)
            phase_s["pipeline"] = time.perf_counter() - t0
        if by_path:
            launches = {name: sum(m[name] for m in by_path.values()) for name in kernels_mod.KERNELS}
            summary["launches_by_path"] = by_path
        log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}, "
            f"total {time.perf_counter() - t_all:.1f}")
        if len(summary) > 1:
            log("summary: " + json.dumps({k: v for k, v in summary.items() if k != "smi"}))
        if kern:
            rows = []
            for name, r in kern.items():
                h = r["headline"]
                rows.append(dict(
                    name=name, route=r["route"], source=r["source"], replaces=r["replaces"],
                    also_replaces=r["also_replaces"],
                    launches=None if launches is None else launches[name],
                    launches_by_variant=_sum_variants(name),
                    max_abs_err=h["max_abs_err"], ms=h["ms"], plain_ms=h["plain_ms"],
                    bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                    library_ms=h["library_ms"], shape=h["shape"],
                    **{key: h[key] for key in ("bound_gguf_ms", "replaced_route_ms", "library", "bmm_dequantized_ms",
                                               "k2_same_shape_ms", "k6_same_codes_ms") if key in h},
                    **({"merged": r["merged_cases"][0]} if r.get("merged_cases") else {}),
                ))
            log(json.dumps({"kernels": rows}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": whole, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
