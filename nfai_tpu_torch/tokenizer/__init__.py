"""Tokenization: byte-level BPE, SentencePiece-style SPM, chat templates."""
from .bpe import (  # noqa: F401
    BPETokenizer,
    StreamDetokenizer,
    TokenType,
    bytes_to_unicode,
    unicode_to_bytes,
)
from .chat_template import (  # noqa: F401
    DEFAULT_SYSTEM_PROMPT,
    LLAMA3_FALLBACK_TEMPLATE,
    ChatTemplate,
    Message,
)
from .spm import SPMTokenizer  # noqa: F401


def tokenizer_from_gguf(metadata: dict):
    """Dispatch on ``tokenizer.ggml.model``: "gpt2" → byte-level BPE
    (llama-3, qwen), "llama" → SPM (llama-2, gemma, mistral-v0.1)."""
    from ..gguf.constants import Keys

    model = str(metadata.get(Keys.TOKENIZER_MODEL, "gpt2"))
    if model == "llama":
        return SPMTokenizer.from_gguf_metadata(metadata)
    return BPETokenizer.from_gguf_metadata(metadata)


class TextStopper:
    """Incremental stop-string matcher for streamed text.

    Holds back the longest possible stop-prefix so a stop sequence split
    across two pieces is still caught; `feed` returns (emit_now, done).
    """

    def __init__(self, stop_strings):
        self.stops = [s for s in stop_strings if s]
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self._buf = ""
        self.done = False

    def feed(self, piece: str) -> tuple[str, bool]:
        if self.done:
            return "", True
        if not self.stops:
            return piece, False
        self._buf += piece
        for s in self.stops:
            idx = self._buf.find(s)
            if idx != -1:
                self.done = True
                return self._buf[:idx], True
        if self.hold and len(self._buf) > self.hold:
            emit, self._buf = self._buf[: -self.hold], self._buf[-self.hold :]
            return emit, False
        if not self.hold:
            emit, self._buf = self._buf, ""
            return emit, False
        return "", False

    def flush(self) -> str:
        if self.done:
            return ""
        out, self._buf = self._buf, ""
        return out
