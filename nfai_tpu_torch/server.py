"""HTTP inference server (OpenAI-style API) over the continuous-batching
engine.

Counterpart of nfai_tpu/server.py:

- ``POST /v1/chat/completions`` — messages in, completion out; with
  ``"stream": true`` the reply is SSE chunks (OpenAI wire format)
- ``POST /v1/completions`` — raw prompt in, text out
- ``GET  /healthz`` — liveness and model info
- ``GET  /v1/models`` — model listing

Stdlib only (ThreadingHTTPServer); concurrency comes from the BatchEngine's
continuous batching, not from a model per thread. The OpenAI sampling
options are read as the JAX server reads them: `logit_bias` ({"id": bias},
clamped to [-100, 100]), `presence_penalty`, `frequency_penalty`, and
logprobs (chat's `"logprobs": true` with `top_logprobs`, the legacy
completions' `"logprobs": N`, 0 <= N <= 20), returned in the chat or the
legacy layout, per SSE chunk or whole. Structured output as the JAX
server takes it: `response_format` {"type": "json_object"} (or "json"),
{"type": "json_schema", "json_schema": {"schema": {...}}}, and the llama.cpp
body fields `grammar` (GBNF) and `regex` (full match), at most one of
grammar, regex and schema; `BatchEngine.submit` compiles each when the
request arrives, so a bad one gets a 400 naming it before anything is
queued. A malformed body gets a 400; a full queue a 503.

Usage:
    python -m nfai_tpu_torch.server --gguf model.gguf [--port 8000] [--device cpu]
    python -m nfai_tpu_torch.server --gguf model.gguf --mesh tp=2   # tensor parallel, one host

Runs on the GPU by default and raises if none is visible; `--device cpu`
runs the plain PyTorch versions of the kernels.

With `--mesh` the engine is one rank of a mesh (parallel/; the CLI's
launch rules: one host spawns its own ranks, NFAI_COORD joins a launch the
user started). Rank 0 listens on HTTP and runs the BatchEngine's thread;
the other ranks `follow` it until it closes. `--seq-parallel` (with an sp
axis) and `--expert-parallel` (with a tp axis) are the CLI's: the engine's
`seq_parallel` and `expert_parallel`. The BatchEngine's page pool is whole
on every sp rank (the JAX scheduler's layout), so a paged server under an
sp mesh runs its requests on every sp rank alike; the dense cache of
`BatchEngine(paged=False)` and of `InferenceEngine.generate` is split. The
pool is not split over dp either (the JAX pool is sharded over tp only):
the dense BatchEngine's lanes are (runtime.scheduler). Any other axis
name replicates.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .cli import parse_mesh
from .config import EngineConfig, SamplingParams
from .parallel.distributed import join_local, start_world
from .runtime.engine import InferenceEngine
from .runtime.scheduler import BatchEngine, QueueFull
from .tokenizer import Message, StreamDetokenizer, TextStopper

log = logging.getLogger(__name__)


class ServerState:
    def __init__(self, engine: InferenceEngine, batch: BatchEngine):
        self.engine = engine
        self.batch = batch
        self.started_at = time.time()
        self.requests_served = 0
        self.lock = threading.Lock()


def _sampling_from_body(body: dict) -> SamplingParams:
    stop = body.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    # OpenAI logit_bias comes as {"token_id": bias}, clamped to [-100, 100]
    bias = body.get("logit_bias") or {}
    logit_bias = tuple((int(k), max(-100.0, min(100.0, float(v)))) for k, v in bias.items())
    # OpenAI response_format: {"type": "json_object"} constrains to JSON,
    # {"type": "json_schema", "json_schema": {"schema": {...}}} to a schema
    rf = body.get("response_format") or {}
    rf_type = rf.get("type") if isinstance(rf, dict) else str(rf)
    json_schema = None
    if rf_type in (None, "text"):
        response_format = None
    elif rf_type in ("json_object", "json"):
        response_format = "json"
    elif rf_type == "json_schema":
        wrapper = rf.get("json_schema") if isinstance(rf, dict) else None
        if not isinstance(wrapper, dict):
            raise ValueError('response_format json_schema needs a "json_schema" object')
        json_schema = wrapper.get("schema", wrapper)
        if not isinstance(json_schema, (dict, bool)):
            raise ValueError("json_schema.schema must be an object")
        response_format = "json_schema"
    else:
        raise ValueError(f"unsupported response_format type {rf_type!r}")
    # OpenAI logprobs: chat sends "logprobs": true and "top_logprobs": N; the
    # legacy completions endpoint sends "logprobs": N
    lp_raw = body.get("logprobs")
    logprobs = None
    if isinstance(lp_raw, bool):
        if lp_raw:
            logprobs = int(body.get("top_logprobs") or 0)
    elif lp_raw is not None:
        logprobs = int(lp_raw)
    if logprobs is not None and not 0 <= logprobs <= 20:
        raise ValueError("logprobs/top_logprobs must be in [0, 20]")
    grammar, regex = body.get("grammar"), body.get("regex")
    if sum(x is not None for x in (grammar, regex, json_schema)) > 1:
        raise ValueError("at most one of grammar/regex/json_schema")
    return SamplingParams(
        temperature=float(body.get("temperature", 0.5)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        logit_bias=logit_bias,
        seed=body.get("seed"),
        max_new_tokens=int(body.get("max_tokens") or body.get("max_completion_tokens") or 512),
        stop=tuple(str(s) for s in stop),
        response_format=response_format,
        grammar=None if grammar is None else str(grammar),
        regex=None if regex is None else str(regex),
        json_schema=json_schema,
        logprobs=logprobs,
    )


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to our logger
            log.debug("%s " + fmt, self.address_string(), *args)

        # -- helpers -------------------------------------------------------
        def _json(self, code: int, obj: dict):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _error(self, code: int, message: str):
            self._json(code, {"error": {"message": message, "code": code}})

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                raise ValueError("empty request body")
            body = json.loads(self.rfile.read(length))
            if not isinstance(body, dict):
                raise ValueError("the body must be a JSON object")
            return body

        # -- routes --------------------------------------------------------
        def do_GET(self):
            if self.path == "/healthz":
                eng = state.engine
                self._json(200, {
                    "status": "ok",
                    "model": eng.model_name,
                    "uptime_s": round(time.time() - state.started_at, 1),
                    "requests_served": state.requests_served,
                    "max_batch": state.batch.max_batch,
                    "max_seq_len": eng.max_seq_len,
                })
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": state.engine.model_name, "object": "model",
                     "owned_by": "nfai_tpu_torch"},
                ]})
            else:
                self._error(404, f"no route {self.path}")

        def do_POST(self):
            try:
                if self.path == "/v1/chat/completions":
                    self._chat()
                elif self.path == "/v1/completions":
                    self._completions()
                else:
                    self._error(404, f"no route {self.path}")
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._error(400, f"bad request: {e}")
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as e:  # noqa: BLE001 - report, don't kill the server
                log.exception("request failed")
                try:
                    self._error(500, str(e))
                except OSError:
                    pass

        # -- endpoints -----------------------------------------------------
        def _chat(self):
            body = self._body()
            messages = [Message(str(m["role"]), str(m["content"]))
                        for m in body.get("messages", [])]
            if not messages:
                raise ValueError("messages must be a non-empty list")
            eng = state.engine
            prompt = eng.chat_template.render(messages, add_generation_prompt=True)
            self._generate(body, eng.tokenizer.encode(prompt, add_bos=False), chat=True)

        def _completions(self):
            body = self._body()
            prompt = body.get("prompt")
            if not isinstance(prompt, str):
                raise ValueError("prompt must be a string")
            self._generate(body, state.engine.tokenizer.encode(prompt), chat=False)

        def _generate(self, body: dict, prompt_ids: list[int], chat: bool):
            sampling = _sampling_from_body(body)
            n = int(body.get("n") or 1)
            if not 1 <= n <= 8:
                raise ValueError("n must be between 1 and 8")
            if n > 1 and body.get("stream"):
                raise ValueError("streaming with n > 1 is not supported")
            reqs = []
            try:
                for _ in range(n):
                    reqs.append(state.batch.submit(prompt_ids, sampling))
            except QueueFull as e:  # bounded queue: shed load
                for r in reqs:
                    r.cancel()
                self._error(503, str(e))
                return
            with state.lock:
                state.requests_served += n
            try:
                if n == 1:
                    self._respond(body, reqs[0], chat)
                else:
                    self._respond_multi(reqs, chat)
            except (BrokenPipeError, ConnectionResetError):
                # the client went away mid-stream: stop generating
                for r in reqs:
                    r.cancel()
                raise

        def _chunk(self, rid, created, chat, payload, finish=None, logprobs=None):
            obj = "chat.completion.chunk" if chat else "text_completion"
            delta = {"delta": payload} if chat else {"text": payload.get("content", "")}
            choice = {"index": 0, **delta, "finish_reason": finish}
            if logprobs is not None:
                choice["logprobs"] = logprobs
            self._sse({"id": rid, "object": obj, "created": created,
                       "model": state.engine.model_name, "choices": [choice]})

        def _tok_repr(self, token_id: int) -> tuple[str, list[int]]:
            """A token's text and bytes (an unknown id: none; a malformed
            byte piece: none)."""
            try:
                bs = state.engine.tokenizer.decode_token_bytes(token_id)
            except ValueError:
                bs = b""
            return bs.decode("utf-8", errors="replace"), list(bs)

        def _logprobs_block(self, entries: list[dict], chat: bool) -> dict:
            """OpenAI logprobs payload: chat uses the structured `content`
            list, legacy completions parallel arrays."""
            if chat:
                def item(token_id, lp):
                    text, bs = self._tok_repr(token_id)
                    return {"token": text, "logprob": lp, "bytes": bs}

                return {"content": [dict(item(e["id"], e["logprob"]),
                                         top_logprobs=[item(i, lp) for i, lp in e["top"]])
                                    for e in entries]}
            toks, lps, tops, offs = [], [], [], []
            off = 0
            for e in entries:
                s, _ = self._tok_repr(e["id"])
                toks.append(s)
                lps.append(e["logprob"])
                tops.append({self._tok_repr(i)[0]: lp for i, lp in e["top"]})
                offs.append(off)
                off += len(s)
            return {"tokens": toks, "token_logprobs": lps, "top_logprobs": tops, "text_offset": offs}

        def _respond(self, body: dict, req, chat: bool):
            eng = state.engine
            sampling = req.sampling
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:16]}"
            created = int(time.time())
            want_lp = sampling.logprobs is not None
            if not body.get("stream"):
                tokens = list(req.stream(timeout=600))
                text = _cut_at_stop(eng.tokenizer.decode(tokens, skip_special=True), sampling.stop)
                content = ({"message": {"role": "assistant", "content": text}} if chat
                           else {"text": text})
                choice = {"index": 0, **content, "finish_reason": "stop"}
                if want_lp:
                    choice["logprobs"] = self._logprobs_block(req.logprob_data[: len(tokens)], chat)
                self._json(200, {
                    "id": rid, "object": "chat.completion" if chat else "text_completion",
                    "created": created, "model": eng.model_name,
                    "choices": [choice],
                    "usage": {"prompt_tokens": len(req.prompt_ids),
                              "completion_tokens": len(tokens),
                              "total_tokens": len(req.prompt_ids) + len(tokens)},
                })
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # the SSE body is delimited by connection close (no chunked framing)
            self.send_header("Connection", "close")
            self.close_connection = True
            self.end_headers()
            detok = StreamDetokenizer(eng.tokenizer)
            stopper = TextStopper(sampling.stop)
            lp_cursor = 0
            for tok in req.stream(timeout=600):
                raw = detok.push(tok)
                if not raw:
                    continue
                piece, stopped = stopper.feed(raw)
                if piece:
                    lps = None
                    if want_lp:
                        # the entries of every token consumed since the last
                        # piece (the detokenizer may buffer several)
                        lps = self._logprobs_block(req.logprob_data[lp_cursor:], chat)
                        lp_cursor = len(req.logprob_data)
                    self._chunk(rid, created, chat, {"content": piece}, logprobs=lps)
                if stopped:
                    break
            if stopper.done:
                req.cancel()  # stop string hit: free the slot now
            tail = "" if stopper.done else detok.flush() + stopper.flush()
            # the entries of tokens whose text only the final flush gives out
            # (the JAX server drops them)
            rest = None
            if want_lp and not stopper.done and len(req.logprob_data) > lp_cursor:
                rest = self._logprobs_block(req.logprob_data[lp_cursor:], chat)
            if tail:
                self._chunk(rid, created, chat, {"content": tail}, logprobs=rest)
            self._chunk(rid, created, chat, {}, finish="stop", logprobs=None if tail else rest)
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        def _respond_multi(self, reqs, chat: bool):
            """OpenAI `n` > 1: one choice per request (blocking only)."""
            eng = state.engine
            choices = []
            total_completion = 0
            for idx, req in enumerate(reqs):
                tokens = list(req.stream(timeout=600))
                total_completion += len(tokens)
                text = _cut_at_stop(eng.tokenizer.decode(tokens, skip_special=True),
                                    req.sampling.stop)
                content = ({"message": {"role": "assistant", "content": text}} if chat
                           else {"text": text})
                choice = {"index": idx, **content, "finish_reason": "stop"}
                if req.sampling.logprobs is not None:
                    choice["logprobs"] = self._logprobs_block(req.logprob_data[: len(tokens)], chat)
                choices.append(choice)
            n_prompt = len(reqs[0].prompt_ids)
            self._json(200, {
                "id": f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:16]}",
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()), "model": eng.model_name, "choices": choices,
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": total_completion,
                          "total_tokens": n_prompt + total_completion},
            })

        def _sse(self, obj: dict):
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

    return Handler


def _cut_at_stop(text: str, stops) -> str:
    for s in stops:
        idx = text.find(s)
        if idx != -1:
            text = text[:idx]
    return text


def serve(
    gguf: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    engine_config: EngineConfig | None = None,
    max_batch: int = 8,
    device: str = "cuda",
) -> ThreadingHTTPServer:
    """Load the model on `device` (the card unless the caller asks for the
    CPU; raises without one), start the BatchEngine's thread and bind the
    server (call its serve_forever). On a rank other than 0 of a mesh the
    BatchEngine follows rank 0 instead, and None is returned once rank 0
    closes."""
    engine = InferenceEngine(gguf, engine_config or EngineConfig(gguf_path=gguf), device=device)
    batch = BatchEngine(engine, max_batch=max_batch)
    if engine.comm is not None and not engine.comm.is_root:
        batch.follow()
        return None
    batch.start()
    state = ServerState(engine, batch)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.state = state
    log.info("serving %s on http://%s:%d", engine.model_name, host, httpd.server_address[1])
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nfai_tpu_torch.server")
    p.add_argument("--gguf", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-seq", type=int, default=512)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="activation dtype (the CUDA kernels take bfloat16)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mesh", default="",
                   help="device mesh, e.g. 'tp=2', 'dp=2,tp=2' or 'tp=2,x=2' (an axis no split names "
                        "replicates; empty = single device)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="split the KV cache over its S axis on the mesh's sp axis (e.g. --mesh sp=2)")
    p.add_argument("--expert-parallel", action="store_true",
                   help="split a MoE model's experts over the mesh's tp axis (e.g. --mesh tp=2)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    procs = start_world(mesh, "nfai_tpu_torch.server:main", argv, args.device)
    try:
        httpd = serve(
            args.gguf, args.host, args.port,
            EngineConfig(gguf_path=args.gguf, max_seq_len=args.max_seq, dtype=args.dtype,
                         mesh_shape=mesh, seq_parallel=args.seq_parallel,
                         expert_parallel=args.expert_parallel),
            args.max_batch, device=args.device,
        )
        if httpd is not None:
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.state.batch.close()
                httpd.server_close()
    finally:
        codes = join_local(procs) if procs else []
    return 1 if any(c != 0 for c in codes) else 0


if __name__ == "__main__":
    sys.exit(main())
