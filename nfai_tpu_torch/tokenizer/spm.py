"""SentencePiece-style (SPM) tokenizer from GGUF metadata.

Llama-2, Gemma, and v0.1 Mistral checkpoints carry ``tokenizer.ggml.model =
"llama"``: a piece vocabulary with per-piece scores (no merge table). Encoding
follows llama.cpp's ``llm_tokenizer_spm``: within each whitespace-delimited
chunk, repeatedly merge the adjacent symbol pair whose concatenation is a
vocab piece with the highest score; unknown characters fall back to ``<0xXX>``
byte pieces. Spaces are rewritten to ``▁`` (U+2581) with an optional leading
space prefix.

The port's own copy of nfai_tpu/tokenizer/spm.py (the same ids for the same
text and vocabulary); it imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

from ..gguf.constants import Keys
from .bpe import TokenType

SPACE_PIECE = "▁"  # ▁


@dataclass
class SPMTokenizer:
    pieces: dict[str, int]  # piece → id
    scores: list[float]
    token_types: list[int]
    bos_id: int | None = None
    eos_id: int | None = None
    pad_id: int | None = None
    unk_id: int = 0
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    eos_ids: set[int] = field(default_factory=set)

    def __post_init__(self):
        self.id_to_piece = {i: p for p, i in self.pieces.items()}
        self.id_to_token = self.id_to_piece  # engine-facing alias
        self.vocab = self.pieces  # engine-facing alias
        self._special = {
            p: i
            for p, i in self.pieces.items()
            if 0 <= i < len(self.token_types)
            and self.token_types[i] in (TokenType.CONTROL, TokenType.USER_DEFINED)
        }
        if self._special:
            import regex

            pattern = "|".join(
                regex.escape(t) for t in sorted(self._special, key=len, reverse=True)
            )
            self._special_re = regex.compile(f"({pattern})")
        else:
            self._special_re = None
        if self.eos_id is not None:
            self.eos_ids.add(self.eos_id)
        for name in ("</s>", "<end_of_turn>", "<|im_end|>"):
            if name in self.pieces:
                self.eos_ids.add(self.pieces[name])

    # -- construction ------------------------------------------------------
    @classmethod
    def from_gguf_metadata(cls, md: dict[str, Any]) -> "SPMTokenizer":
        tokens: list[str] = md[Keys.TOKENIZER_TOKENS]
        scores = md.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
        types = md.get(Keys.TOKENIZER_TOKEN_TYPE) or [TokenType.NORMAL] * len(tokens)
        unk = md.get("tokenizer.ggml.unknown_token_id", 0)
        return cls(
            pieces={t: i for i, t in enumerate(tokens)},
            scores=[float(s) for s in scores],
            token_types=[int(t) for t in types],
            bos_id=md.get(Keys.TOKENIZER_BOS),
            eos_id=md.get(Keys.TOKENIZER_EOS),
            pad_id=md.get(Keys.TOKENIZER_PAD),
            unk_id=int(unk) if unk is not None else 0,
            add_bos=bool(md.get(Keys.TOKENIZER_ADD_BOS, True)),
            add_eos=bool(md.get(Keys.TOKENIZER_ADD_EOS, False)),
            add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", True)),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # -- encoding ----------------------------------------------------------
    def _encode_chunk(self, text: str) -> list[int]:
        """Score-greedy adjacent merge over one special-free chunk."""
        if not text:
            return []
        symbols: list[str] = list(text)
        while len(symbols) > 1:
            best_score = -1e30
            best_i = -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                tid = self.pieces.get(merged)
                if tid is not None and self.scores[tid] > best_score:
                    best_score = self.scores[tid]
                    best_i = i
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids: list[int] = []
        for sym in symbols:
            tid = self.pieces.get(sym)
            if tid is not None:
                ids.append(tid)
                continue
            # byte fallback (<0xXX> pieces), else unk
            fell_back = True
            for b in sym.encode("utf-8"):
                byte_piece = f"<0x{b:02X}>"
                bid = self.pieces.get(byte_piece)
                if bid is None:
                    fell_back = False
                    break
                ids.append(bid)
            if not fell_back:
                ids.append(self.unk_id)
        return ids

    def encode(
        self,
        text: str,
        add_bos: bool | None = None,
        add_eos: bool | None = None,
        parse_special: bool = True,
    ) -> list[int]:
        ids: list[int] = []
        if (add_bos if add_bos is not None else self.add_bos) and self.bos_id is not None:
            ids.append(self.bos_id)

        def encode_plain(t: str):
            if not t:
                return
            t = t.replace(" ", SPACE_PIECE)
            ids.extend(self._encode_chunk(t))

        first_plain = True

        def maybe_prefix(t: str) -> str:
            nonlocal first_plain
            if first_plain and self.add_space_prefix and t:
                first_plain = False
                return SPACE_PIECE + t
            if t:
                first_plain = False
            return t

        if parse_special and self._special_re is not None:
            pos = 0
            for m in self._special_re.finditer(text):
                encode_plain(maybe_prefix(text[pos : m.start()]))
                ids.append(self._special[m.group()])
                pos = m.end()
            encode_plain(maybe_prefix(text[pos:]))
        else:
            encode_plain(maybe_prefix(text))
        if (add_eos if add_eos is not None else self.add_eos) and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    # -- decoding ----------------------------------------------------------
    def decode_token_bytes(self, token_id: int) -> bytes:
        piece = self.id_to_piece.get(token_id)
        if piece is None:
            return b""
        ttype = (
            self.token_types[token_id]
            if 0 <= token_id < len(self.token_types)
            else TokenType.NORMAL
        )
        if ttype == TokenType.BYTE and piece.startswith("<0x") and piece.endswith(">"):
            return bytes([int(piece[3:-1], 16)])
        if ttype in (TokenType.CONTROL, TokenType.UNKNOWN):
            return piece.encode("utf-8")
        return piece.replace(SPACE_PIECE, " ").encode("utf-8")

    def decode(self, ids: Iterable[int], skip_special: bool = False) -> str:
        out = bytearray()
        for i in ids:
            if skip_special and (
                0 <= i < len(self.token_types)
                and self.token_types[i] == TokenType.CONTROL
            ):
                continue
            out += self.decode_token_bytes(i)
        text = out.decode("utf-8", errors="replace")
        # SPM convention: a leading space was introduced by add_space_prefix
        return text[1:] if text.startswith(" ") and self.add_space_prefix else text

    def is_eos(self, token_id: int) -> bool:
        return token_id in self.eos_ids
