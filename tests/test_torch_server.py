"""The port's HTTP server (stdlib ThreadingHTTPServer over the BatchEngine)
on the CPU: the cases of the JAX package's server tests (health, models,
blocking and SSE chat, completions, error paths, concurrency, stop strings,
n choices, grammar and JSON modes), plus: a greedy blocking chat returns
exactly the port engine's greedy text for the rendered prompt, the SSE
pieces join to that text, the structured-output options (grammar, regex,
JSON and JSON Schema response formats) answer text that satisfies them
while a malformed one gets a 400 naming it, a full queue gets a 503, and
serve/main refuse to start without a card unless given the CPU. The OpenAI
sampling options (logprobs in both wire forms, logit_bias, presence and
frequency penalties) answer 200 in the JAX server's response shape for the
same body (the JAX server runs beside the port's on the same GGUF),
blocking and streamed, and their logprobs are those of the port engine's
own greedy run.
"""
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from nfai_tpu import server as jsrv
from nfai_tpu.config import EngineConfig as JEngineConfig
from nfai_tpu_torch import server as srv
from nfai_tpu_torch.config import EngineConfig, SamplingParams
from nfai_tpu_torch.gguf import GGMLType
from nfai_tpu_torch.runtime.engine import GenerationMetrics
from nfai_tpu_torch.runtime.scheduler import BatchEngine, RequestState
from nfai_tpu_torch.testing import make_tiny_llama_gguf
from nfai_tpu_torch.tokenizer import Message

TINY = dict(hidden=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
            quant=GGMLType.Q4_K, tied=False, context_length=512)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny ops gain nothing from intra-op threads, and beside the
    suite's other workers those threads oversubscribe the cores (the module
    ran 20x slower under 6 workers); restored for the next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("srv") / "tiny_q4k.gguf", **TINY)


@pytest.fixture(scope="module")
def server(gguf_path):
    httpd = srv.serve(str(gguf_path), host="127.0.0.1", port=0,
                      engine_config=EngineConfig(max_seq_len=256, dtype="float32", prefill_chunk=64),
                      max_batch=2, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", httpd.state
    httpd.shutdown()
    httpd.server_close()
    httpd.state.batch.close()
    thread.join(timeout=10)


def _post(base, path, body, timeout=120):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse_events(resp):
    return [line.decode().strip()[6:] for line in resp if line.decode().startswith("data: ")]


CHAT = {"messages": [{"role": "user", "content": "hi"}], "temperature": 0, "max_tokens": 8}


def _greedy_text(state, content, max_new):
    eng = state.engine
    prompt = eng.chat_template.render([Message("user", content)], add_generation_prompt=True)
    ids = eng.tokenizer.encode(prompt, add_bos=False)
    toks = list(eng.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=max_new)))
    return eng.tokenizer.decode(toks, skip_special=True), len(toks)


def test_healthz(server):
    base, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["model"] == "tiny-llama-test"
    assert body["max_batch"] == 2 and body["max_seq_len"] == 256


def test_models(server):
    base, _ = server
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
        body = json.loads(r.read())
    assert body["data"][0]["id"] == "tiny-llama-test"


def test_chat_completion_blocking_is_the_greedy_text(server):
    base, state = server
    with _post(base, "/v1/chat/completions", CHAT) as r:
        body = json.loads(r.read())
    assert body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant"
    text, n = _greedy_text(state, "hi", 8)
    assert msg["content"] == text
    assert body["usage"]["completion_tokens"] == n and body["usage"]["prompt_tokens"] > 0


def test_chat_completion_streaming_joins_to_the_blocking_text(server):
    base, state = server
    with _post(base, "/v1/chat/completions", dict(CHAT, stream=True)) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events = _sse_events(r)
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    assert parsed[-1]["choices"][0]["finish_reason"] == "stop"
    assert all(p["object"] == "chat.completion.chunk" for p in parsed)
    text = "".join(p["choices"][0]["delta"].get("content", "") for p in parsed)
    assert text == _greedy_text(state, "hi", 8)[0]


def test_completions_endpoint(server):
    base, _ = server
    with _post(base, "/v1/completions", {"prompt": "abc", "temperature": 0, "max_tokens": 4}) as r:
        body = json.loads(r.read())
    assert body["object"] == "text_completion" and "text" in body["choices"][0]
    with _post(base, "/v1/completions", {"prompt": "abc", "temperature": 0, "max_tokens": 4,
                                         "stream": True}) as r:
        events = _sse_events(r)
    text = "".join(json.loads(e)["choices"][0]["text"] for e in events[:-1])
    assert events[-1] == "[DONE]" and text == body["choices"][0]["text"]


@pytest.mark.parametrize("path,data,code", [
    ("/v1/chat/completions", json.dumps({"messages": []}).encode(), 400),
    ("/v1/chat/completions", b"{not json", 400),
    ("/v1/chat/completions", b"[1, 2]", 400),
    ("/v1/completions", json.dumps({"prompt": 3}).encode(), 400),
    ("/v1/chat/completions", json.dumps(dict(CHAT, n=9)).encode(), 400),
    ("/v1/chat/completions", json.dumps(dict(CHAT, response_format={"type": "xml"})).encode(), 400),
    ("/v1/nope", b"{}", 404),
])
def test_error_paths(server, path, data, code):
    base, _ = server
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == code
    assert json.loads(e.value.read())["error"]["code"] == code


def test_concurrent_requests(server):
    base, _ = server
    results = {}

    def hit(i):
        with _post(base, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": f"msg {i}"}], "temperature": 0,
                "max_tokens": 4}) as r:
            results[i] = json.loads(r.read())

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 3
    assert all(b["choices"][0]["finish_reason"] == "stop" for b in results.values())


def test_stop_sequences(server):
    base, state = server
    full, _ = _greedy_text(state, "hi", 8)
    stop = full[2:4] if len(full) >= 4 else "\n"
    with _post(base, "/v1/chat/completions", dict(CHAT, stop=stop)) as r:
        text = json.loads(r.read())["choices"][0]["message"]["content"]
    assert stop not in text and full.startswith(text)
    with _post(base, "/v1/chat/completions", dict(CHAT, stop=[stop], stream=True)) as r:
        events = _sse_events(r)
    streamed = "".join(json.loads(e)["choices"][0]["delta"].get("content", "") for e in events[:-1])
    assert streamed == text and events[-1] == "[DONE]"


def test_n_choices(server):
    base, _ = server
    with _post(base, "/v1/chat/completions", dict(CHAT, temperature=0.9, seed=3, n=3)) as r:
        body = json.loads(r.read())
    assert [c["index"] for c in body["choices"]] == [0, 1, 2]
    assert all(isinstance(c["message"]["content"], str) for c in body["choices"])


def test_n_stream_rejected(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/chat/completions", dict(CHAT, n=2, stream=True))
    assert e.value.code == 400


SCHEMA = {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "boolean"}},
          "required": ["a", "b"]}


def _json_dict(text) -> bool:
    return isinstance(json.loads(text), dict)


# each structured-output option: a body that asks for it, a check of the
# text it answers, and a malformed body of the same option (a 400 naming it)
STRUCTURED = [
    ({"grammar": 'root ::= "ok:" [0-9]+'}, lambda t: re.fullmatch("ok:[0-9]+", t),
     {"grammar": 'root ::= "unterminated'}),
    ({"regex": "(yes|no)"}, lambda t: t in ("yes", "no"), {"regex": "(yes|no"}),
    ({"response_format": {"type": "json_object"}}, _json_dict,
     {"response_format": {"type": "json_objekt"}}),
    ({"response_format": {"type": "json_schema", "json_schema": {"name": "t", "schema": SCHEMA}}},
     lambda t: _json_dict(t) and {"a", "b"} <= set(json.loads(t)), {"response_format": {"type": "json_schema"}}),
]


@pytest.mark.parametrize("extra,name", [
    (STRUCTURED[0], "grammar"),
    (STRUCTURED[1], "regex"),
    (STRUCTURED[2], "response_format 'json_object'"),
    (STRUCTURED[3], "response_format 'json_schema'"),
])
def test_unported_options_get_a_named_error_and_the_server_keeps_serving(server, extra, name):
    """The structured-output options answer 200, blocking and streamed,
    with text that satisfies the constraint; a malformed one is a 400
    whose message names the option, and the server keeps answering."""
    base, _ = server
    body, ok, bad = extra
    for stream in (False, True):
        req = dict(CHAT, stream=stream, temperature=0.8, seed=4, max_tokens=48, **body)
        with _post(base, "/v1/chat/completions", req) as r:
            assert r.status == 200
            if stream:
                chunks = [json.loads(e) for e in _sse_events(r)[:-1]]
                text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
            else:
                text = json.loads(r.read())["choices"][0]["message"]["content"]
        assert ok(text), (name, stream, text)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/v1/chat/completions", dict(CHAT, stream=stream, **bad))
        assert e.value.code == 400
        assert name.split()[0] in json.loads(e.value.read())["error"]["message"]
    with _post(base, "/v1/chat/completions", CHAT) as r:  # still answering
        assert r.status == 200


@pytest.fixture(scope="module")
def jax_server(gguf_path):
    """The JAX package's server on the same GGUF and settings."""
    httpd = jsrv.serve(str(gguf_path), host="127.0.0.1", port=0,
                       engine_config=JEngineConfig(max_seq_len=256, dtype="float32", prefill_chunk=64),
                       max_batch=2)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    httpd.state.batch.close()
    thread.join(timeout=10)


def _shape(obj):
    """A response's structure: dict keys, list element shapes, leaf types
    (None and numbers as one kind: finish_reason and logprobs values)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return sorted({json.dumps(_shape(v), sort_keys=True) for v in obj})
    return "str" if isinstance(obj, str) else "scalar"


@pytest.mark.parametrize("extra", [
    {"logprobs": True, "top_logprobs": 2},
    {"logprobs": 3},
    {"logit_bias": {"5": 10}},
    {"presence_penalty": 0.5},
    {"frequency_penalty": 0.5},
], ids=["logprobs-top", "logprobs-legacy", "logit_bias", "presence_penalty", "frequency_penalty"])
def test_sampling_options_answer_in_the_jax_servers_shape(server, jax_server, extra):
    base, state = server
    for path, body in (("/v1/chat/completions", dict(CHAT, **extra)),
                       ("/v1/completions", {"prompt": "abc", "temperature": 0, "max_tokens": 6, **extra})):
        with _post(base, path, body) as r, _post(jax_server, path, body) as jr:
            assert r.status == jr.status == 200
            got, want = json.loads(r.read()), json.loads(jr.read())
        assert _shape(got) == _shape(want)
        with _post(base, path, dict(body, stream=True)) as r, _post(jax_server, path, dict(body, stream=True)) as jr:
            events, jevents = _sse_events(r), _sse_events(jr)
        assert events[-1] == jevents[-1] == "[DONE]"
        chunks, jchunks = [json.loads(e) for e in events[:-1]], [json.loads(e) for e in jevents[:-1]]
        assert _shape(chunks[0]) == _shape(jchunks[0]) and _shape(chunks[-1]) == _shape(jchunks[-1])
        if "logprobs" not in extra:
            assert "logprobs" not in got["choices"][0]
            continue
        # the blocking answer's logprobs are the engine's for its greedy run
        # (this prompt has no near-tie on the port: the tokens are equal)
        chat = path == "/v1/chat/completions"
        eng = state.engine
        ids = (eng.tokenizer.encode(eng.chat_template.render([Message("user", "hi")],
                                                             add_generation_prompt=True), add_bos=False)
               if chat else eng.tokenizer.encode("abc"))
        m = GenerationMetrics()
        k = 2 if extra["logprobs"] is True else extra["logprobs"]
        toks = list(eng.generate(ids, SamplingParams(temperature=0.0, max_new_tokens=body["max_tokens"],
                                                     logprobs=k), metrics=m))
        lp = got["choices"][0]["logprobs"]
        vals = [e["logprob"] for e in lp["content"]] if chat else lp["token_logprobs"]
        tops = ([[t["logprob"] for t in e["top_logprobs"]] for e in lp["content"]] if chat
                else [sorted(t.values(), reverse=True) for t in lp["top_logprobs"]])
        assert len(vals) == len(toks) == got["usage"]["completion_tokens"]
        # within 2e-2: the BatchEngine's batched rows and generate's single row
        # may round one logit (near 3, a bf16 step of 2^-6) differently
        np.testing.assert_allclose(vals, [e["logprob"] for e in m.logprobs], rtol=0, atol=2e-2)
        # (the legacy layout keys its top entries by text: ids that decode alike share one)
        assert all(len(t) == k if chat else 0 < len(t) <= k for t in tops)
        if chat:
            assert [t["token"] for t in lp["content"][0]["top_logprobs"]][0] == lp["content"][0]["token"]
        # the streamed chunks carry every token's entry once
        streamed = [e for c in chunks for e in ((c["choices"][0].get("logprobs") or {}).get(
            "content" if chat else "token_logprobs") or [])]
        assert len(streamed) == len(toks)


def test_streamed_logprobs_reach_the_client_when_the_text_comes_at_the_end(server, monkeypatch):
    """A stream whose text the detokenizer holds back to its final flush
    (byte-level pieces that complete no character): every token's entry
    still reaches the client, on the tail chunk (the JAX server drops
    them)."""
    base, _ = server

    class Holding(srv.StreamDetokenizer):
        def push(self, token_id):
            self._held = getattr(self, "_held", []) + [token_id]
            return ""

        def flush(self):
            return self.tok.decode(getattr(self, "_held", []), skip_special=True)

    monkeypatch.setattr(srv, "StreamDetokenizer", Holding)
    body = dict(CHAT, stream=True, logprobs=True, top_logprobs=1)
    with _post(base, "/v1/chat/completions", body) as r:
        chunks = [json.loads(e) for e in _sse_events(r)[:-1]]
    entries = [e for c in chunks for e in (c["choices"][0].get("logprobs") or {}).get("content", [])]
    assert len(chunks) == 2 and chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert len(entries) == 8 and all(len(e["top_logprobs"]) == 1 for e in entries)


@pytest.mark.parametrize("body,why", [
    ({"logprobs": 21}, "logprobs"), ({"logprobs": True, "top_logprobs": -1}, "logprobs"),
    ({"logit_bias": {"x": 1}}, "invalid literal"), ({"logit_bias": {"100000": 1}}, "outside the vocabulary"),
], ids=["logprobs-21", "top_logprobs-negative", "bias-key", "bias-id"])
def test_bad_option_values_get_a_400(server, body, why):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/v1/chat/completions", dict(CHAT, **body))
    assert e.value.code == 400
    assert why in json.loads(e.value.read())["error"]["message"]


def test_neutral_option_values_are_accepted(server):
    base, _ = server
    body = dict(CHAT, logprobs=False, logit_bias={}, presence_penalty=0, frequency_penalty=0.0,
                response_format={"type": "text"})
    with _post(base, "/v1/chat/completions", body) as r:
        assert r.status == 200


def test_full_queue_gets_503(server):
    """A handler whose BatchEngine is not running and holds one request:
    asking for n = 2 overflows it, the first is cancelled, the client gets a
    503."""
    _, state = server
    batch = BatchEngine(state.engine, max_batch=1, queue_cap=1)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(srv.ServerState(state.engine, batch)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{httpd.server_address[1]}", "/v1/chat/completions",
                  dict(CHAT, n=2))
        assert e.value.code == 503
        assert batch.queue.get_nowait().cancelled
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_serve_and_main_default_to_the_card(gguf_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.serve(str(gguf_path), port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.main(["--gguf", str(gguf_path), "--port", "0"])


def test_client_disconnect_cancels_the_request(server):
    """An SSE client that goes away: the handler's next write fails and it
    cancels the request, which the scheduler then drops long before its 200
    tokens. The BatchEngine is stepped by the test, so nothing races."""
    _, state = server
    batch = BatchEngine(state.engine, max_batch=1, decode_chunk=8)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(srv.ServerState(state.engine, batch)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps(dict(CHAT, max_tokens=200, stream=True)).encode()
        sock = socket.create_connection(("127.0.0.1", httpd.server_address[1]), timeout=30)
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: test\r\n"
                     b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        deadline = time.monotonic() + 30
        while batch.queue.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        req = batch.queue.queue[0]
        sock.close()  # the client goes away before reading anything
        while not req.cancelled and time.monotonic() < deadline:
            batch.step()  # tokens reach the handler, whose writes now fail
            time.sleep(0.05)
        batch.step()
        assert req.cancelled and req.state == RequestState.CANCELLED
        assert len(req.output_ids) < 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
