"""The port's tokenizer copy against the JAX package's: encode/decode on the
tiny byte vocab and on a vocab with merges, the llama-bpe pre-tokenizer split
on mixed ASCII / non-ASCII / digit / whitespace strings, the stream
detokenizer, stop strings and the chat template (exact equality)."""
import pytest

from nfai_tpu.models.testing import tiny_tokenizer_metadata as jax_tiny_md
from nfai_tpu.tokenizer import ChatTemplate as JChatTemplate
from nfai_tpu.tokenizer import Message as JMessage
from nfai_tpu.tokenizer import StreamDetokenizer as JDetok
from nfai_tpu.tokenizer import TextStopper as JStopper
from nfai_tpu.tokenizer import tokenizer_from_gguf as jax_tokenizer
from nfai_tpu_torch.testing import tiny_tokenizer_metadata
from nfai_tpu_torch.tokenizer import (
    ChatTemplate, Message, SPMTokenizer, StreamDetokenizer, TextStopper, tokenizer_from_gguf,
)

TEXTS = [
    "Hello, world! It's 2026-10-16.",
    "naïve café — 東京タワー 12345678 ünïcödé",
    "  leading spaces\n\n\ttabs and\r\nnewlines   ",
    "emoji 🙂🚀 mixed123abc 4.5e-3 'll 've",
    "<|begin_of_text|>special<|eot_id|> tokens inline",
]


def _merges_md():
    md = dict(tiny_tokenizer_metadata())
    toks = list(md["tokenizer.ggml.tokens"])
    types = list(md["tokenizer.ggml.token_type"])
    merges = ["Ġ t", "h e", "Ġt he", "i n", "in g", "Ġ w", "o r", "Ġw or", "1 2", "12 3"]
    for m in merges:
        toks.append(m.replace(" ", ""))
        types.append(1)
    md["tokenizer.ggml.tokens"] = toks
    md["tokenizer.ggml.token_type"] = types
    md["tokenizer.ggml.merges"] = merges
    return md


@pytest.mark.parametrize("md_fn", [tiny_tokenizer_metadata, _merges_md])
def test_encode_decode_vs_jax(md_fn):
    md = md_fn()
    tok, jtok = tokenizer_from_gguf(md), jax_tokenizer(md)
    for text in TEXTS + ["the world is turning 123 ing"]:
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert tok.encode(text, add_bos=False, parse_special=False) == jtok.encode(
            text, add_bos=False, parse_special=False)
        assert tok.decode(ids) == jtok.decode(ids)
        assert tok.decode(ids, skip_special=True) == jtok.decode(ids, skip_special=True)
        assert tok.eos_ids == jtok.eos_ids


def test_pretokenizer_split_vs_jax():
    tok, jtok = tokenizer_from_gguf(tiny_tokenizer_metadata()), jax_tokenizer(jax_tiny_md())
    for text in TEXTS:
        assert tok._pretok_re.findall(text) == jtok._pretok_re.findall(text)


def test_stream_detokenizer_and_stopper_vs_jax():
    tok, jtok = tokenizer_from_gguf(tiny_tokenizer_metadata()), jax_tokenizer(jax_tiny_md())
    ids = tok.encode(TEXTS[1] + TEXTS[3], add_bos=False)
    d, jd = StreamDetokenizer(tok), JDetok(jtok)
    pieces = [d.push(i) for i in ids] + [d.flush()]
    assert pieces == [jd.push(i) for i in ids] + [jd.flush()]
    s, js = TextStopper(("café", "🚀")), JStopper(("café", "🚀"))
    assert [s.feed(p) for p in pieces] == [js.feed(p) for p in pieces]
    assert s.flush() == js.flush()


def test_chat_template_vs_jax():
    msgs = [("system", "You are terse."), ("user", "hi  "), ("assistant", "hello"),
            ("user", "naïve question?")]
    t = ChatTemplate(None, bos_token="<|begin_of_text|>", eos_token="<|eot_id|>")
    jt = JChatTemplate(None, bos_token="<|begin_of_text|>", eos_token="<|eot_id|>")
    for gen in (True, False):
        assert t.render([Message(*m) for m in msgs], add_generation_prompt=gen) == jt.render(
            [JMessage(*m) for m in msgs], add_generation_prompt=gen)
    custom = "{% for m in messages %}[{{ m['role'] }}]{{ m['content'] | tojson }}{% endfor %}"
    assert ChatTemplate(custom).render([{"role": "user", "content": "x\"y"}]) == JChatTemplate(
        custom).render([{"role": "user", "content": "x\"y"}])


def test_spm_vocab_raises():
    """An SPM ("llama") vocabulary now builds the port's SPM tokenizer
    (tests/test_torch_spm.py holds it against JAX); one without a token
    list still raises."""
    md = {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": ["a"]}
    tok = tokenizer_from_gguf(md)
    assert isinstance(tok, SPMTokenizer)
    assert tok.encode("a b") == jax_tokenizer(md).encode("a b")  # "▁" falls back to <unk>
    with pytest.raises(KeyError):
        tokenizer_from_gguf({"tokenizer.ggml.model": "llama"})
