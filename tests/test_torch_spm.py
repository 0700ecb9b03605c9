"""The port's SPM tokenizer (tokenizer/spm.py, its own copy) against the JAX
package's on the same vocabulary: a scored piece vocabulary with merges
("▁hello" beats "▁he" + "llo"), byte pieces for fallback, control pieces
(Gemma's <start_of_turn>/<end_of_turn>, <bos>/<eos>); encode ids, decode
text, round trips, byte fallback, the leading-space prefix on and off,
special-token parsing, stop ids and streaming detokenization."""
import pytest

from nfai_tpu.tokenizer import StreamDetokenizer as JDetok
from nfai_tpu.tokenizer import tokenizer_from_gguf as jax_tokenizer
from nfai_tpu_torch.gguf.constants import Keys
from nfai_tpu_torch.testing import gemma_spm_tokenizer_metadata
from nfai_tpu_torch.tokenizer import SPMTokenizer, StreamDetokenizer, TokenType, tokenizer_from_gguf

WORDS = ["▁", "h", "e", "l", "o", "w", "r", "d", "▁h", "he", "ll", "llo", "▁he", "▁hello",
         "▁w", "or", "ld", "▁wor", "▁world", "é", "▁caf", "café", "▁café", "▁the", "▁t", "th",
         "\n", "▁\n", "12", "▁1"]
TEXTS = [
    "hello world",
    " leading space and  two",
    "the world\nnew line",
    "naïve café — 東京タワー",
    "emoji 🙂🚀 mixed123",
    "<start_of_turn>user\nhello<end_of_turn>\n<start_of_turn>model\n",
    "x",
]


def _metadata(add_space_prefix: bool) -> dict:
    pieces = ["<pad>", "<eos>", "<bos>", "<unk>", "<start_of_turn>", "<end_of_turn>"]
    types = [TokenType.CONTROL] * 3 + [TokenType.UNKNOWN] + [TokenType.CONTROL] * 2
    for b in range(256):
        pieces.append(f"<0x{b:02X}>")
        types.append(TokenType.BYTE)
    pieces += WORDS
    types += [TokenType.NORMAL] * len(WORDS)
    # longer pieces score higher; ties broken by position, as in a trained vocab
    scores = [0.0] * (len(pieces) - len(WORDS)) + [len(w) - i * 1e-3 for i, w in enumerate(WORDS)]
    return {
        Keys.TOKENIZER_MODEL: "llama", Keys.TOKENIZER_TOKENS: pieces,
        "tokenizer.ggml.scores": scores, Keys.TOKENIZER_TOKEN_TYPE: types,
        Keys.TOKENIZER_BOS: 2, Keys.TOKENIZER_EOS: 1, "tokenizer.ggml.unknown_token_id": 3,
        "tokenizer.ggml.add_space_prefix": add_space_prefix,
    }


@pytest.mark.parametrize("prefix", [True, False], ids=["space_prefix", "no_prefix"])
@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_encode_decode_equal_jax(text, prefix):
    md = _metadata(prefix)
    tok, jtok = tokenizer_from_gguf(md), jax_tokenizer(md)
    assert isinstance(tok, SPMTokenizer)
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert ids[0] == 2  # <bos>
    assert tok.encode(text, add_bos=False, parse_special=False) == jtok.encode(
        text, add_bos=False, parse_special=False)
    for skip in (False, True):
        assert tok.decode(ids, skip_special=skip) == jtok.decode(ids, skip_special=skip)
    # every character is a piece or falls back to bytes: plain text comes
    # back (after a leading special the space prefix stays, as in JAX)
    if "<" not in text:
        assert tok.decode(ids[1:]) == text
    pieces = [tok.decode_token_bytes(i) for i in ids]
    assert pieces == [jtok.decode_token_bytes(i) for i in ids]


def test_merges_byte_fallback_and_leading_space():
    tok = tokenizer_from_gguf(_metadata(True))
    v = tok.vocab
    assert tok.encode("hello world", add_bos=False) == [v["▁hello"], v["▁world"]]
    assert tok.encode("hello", add_bos=False) != tokenizer_from_gguf(_metadata(False)).encode(
        "hello", add_bos=False)  # "▁hello" against "he" + "llo"
    # "東" is not a piece: its three UTF-8 bytes
    assert tok.encode("東", add_bos=False) == [v["▁"]] + [v[f"<0x{b:02X}>"] for b in "東".encode()]
    assert tok.decode(tok.encode("東", add_bos=False)) == "東"


def test_stop_ids_and_stream_detokenizer():
    md = gemma_spm_tokenizer_metadata(400)
    tok, jtok = tokenizer_from_gguf(md), jax_tokenizer(md)
    assert tok.eos_ids == jtok.eos_ids == {1, 5}  # <eos>, <end_of_turn>
    assert tok.is_eos(5) and not tok.is_eos(4)
    ids = tok.encode("<start_of_turn>model\nnaïve 東京 🙂<end_of_turn>") + list(range(262, 300))
    got, want = StreamDetokenizer(tok), JDetok(jtok)
    assert "".join(got.push(i) for i in ids) + got.flush() == "".join(
        want.push(i) for i in ids) + want.flush()
