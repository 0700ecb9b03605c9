"""Grammar-constrained decoding: JSON mode.

The port's copy of nfai_tpu/constrained.py (numpy only; nothing is
trimmed). OpenAI-style ``response_format={"type": "json_object"}``: a
byte-level pushdown automaton for JSON runs on the host; before every
sampled token the engine asks :class:`TokenConstraint` for the set of
vocabulary tokens whose full byte expansion keeps the automaton in a legal
state, and masks everything else to ``-inf``. The tokenizer is the port's
(`nfai_tpu_torch.tokenizer`): `constraint_for` reads its
``decode_token_bytes`` and ``is_eos``.

Design notes:
- the mask is a host-computed ``bool[V]`` uploaded per step; sampling itself
  stays on the device. Constrained requests run one token a step (the mask
  depends on every accepted token), so they pay a host round trip a token
  instead of running the multi-token decode chunks.
- mask computation is made cheap by two precomputed indexes over the vocab:
  * ``string_safe``: tokens that can never leave a JSON string (no ``"``,
    ``\\`` or control bytes) — inside a string the mask starts from this set
    and only the small "unsafe" remainder is walked byte-by-byte;
  * ``first_byte``: token ids grouped by first byte — outside strings only
    tokens whose first byte is legal for the current state are walked.
  Masks are cached per automaton signature (state + stack), which recur
  heavily during generation.
- ``closing_string`` gives the canonical shortest completion; the engine
  switches to "closing" masks when the token budget approaches that length,
  so JSON mode terminates with *valid* JSON instead of truncating.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# --- automaton states -------------------------------------------------------
VALUE = 0  # expecting the start of a value
IN_STRING = 1
STR_ESCAPE = 2  # after backslash
STR_UNICODE = 3  # inside \uXXXX (hex_left counts down)
NUM_MINUS = 4  # seen '-'
NUM_ZERO = 5  # seen leading '0' (no more int digits allowed)
NUM_INT = 6  # in 1-9 integer digits
NUM_DOT = 7  # seen '.', need a digit
NUM_FRAC = 8  # in fraction digits
NUM_EXP = 9  # seen e/E, need sign or digit
NUM_EXP_SIGN = 10  # seen exponent sign, need digit
NUM_EXP_DIGITS = 11
LITERAL = 12  # inside true/false/null (lit_rest holds the remainder)
AFTER_VALUE = 13  # a value just completed; delimiters depend on the stack
OBJ_KEY_OR_END = 14  # after '{': '"' or '}'
OBJ_KEY = 15  # after ',' in an object: '"' only
OBJ_COLON = 16  # after a key string: ':'
ARR_VALUE_OR_END = 17  # after '[': value or ']'

_WS = frozenset(b" \t\n\r")
_DIGITS = frozenset(b"0123456789")
_HEX = frozenset(b"0123456789abcdefABCDEF")
# number states where the number is already a complete value if a delimiter
# (or end of input) follows
_NUM_COMPLETE = (NUM_ZERO, NUM_INT, NUM_FRAC, NUM_EXP_DIGITS)
_LITERALS = {b"t": b"rue", b"f": b"alse", b"n": b"ull"}


@dataclasses.dataclass
class JsonMachine:
    """Byte-level JSON pushdown automaton.

    ``stack`` entries: ``b'o'`` = inside an object, ``b'a'`` = inside an
    array, ``b'k'`` = the string being read is an object KEY (sits above the
    ``b'o'``). ``require_object`` restricts the top-level value to an object
    (OpenAI ``json_object`` semantics).
    """

    require_object: bool = True
    state: int = VALUE
    stack: tuple = ()
    lit_rest: bytes = b""
    hex_left: int = 0
    started: bool = False

    def copy(self) -> "JsonMachine":
        return dataclasses.replace(self)

    # -- helpers -------------------------------------------------------------
    def _push(self, c: str):
        self.stack = self.stack + (c,)

    def _pop(self):
        self.stack = self.stack[:-1]

    def _end_value(self):
        """A value just finished: where do we go?"""
        self.state = AFTER_VALUE

    def _start_value(self, b: int) -> bool:
        if b == 0x7B:  # {
            self._push("o")
            self.state = OBJ_KEY_OR_END
        elif b == 0x5B:  # [
            self._push("a")
            self.state = ARR_VALUE_OR_END
        elif b == 0x22:  # "
            self.state = IN_STRING
        elif b == 0x2D:  # -
            self.state = NUM_MINUS
        elif b == 0x30:  # 0
            self.state = NUM_ZERO
        elif b in _DIGITS:
            self.state = NUM_INT
        elif bytes([b]) in _LITERALS:
            self.lit_rest = _LITERALS[bytes([b])]
            self.state = LITERAL
        else:
            return False
        return True

    @property
    def complete(self) -> bool:
        """True when the input so far is one complete top-level value."""
        if self.stack:
            return False
        if self.state == AFTER_VALUE:
            return True
        return self.started and self.state in _NUM_COMPLETE

    def advance(self, b: int) -> bool:
        """Consume one byte; returns False (machine unchanged on the outside
        — callers use copies) if the byte is illegal here."""
        s = self.state
        if s == IN_STRING:
            if b == 0x22:  # closing quote
                if self.stack and self.stack[-1] == "k":
                    self._pop()
                    self.state = OBJ_COLON
                else:
                    self._end_value()
            elif b == 0x5C:  # backslash
                self.state = STR_ESCAPE
            elif b < 0x20:
                return False  # control chars must be escaped
            return True
        if s == STR_ESCAPE:
            if b in b'"\\/bfnrt':
                self.state = IN_STRING
                return True
            if b == 0x75:  # u
                self.state = STR_UNICODE
                self.hex_left = 4
                return True
            return False
        if s == STR_UNICODE:
            if b not in _HEX:
                return False
            self.hex_left -= 1
            if self.hex_left == 0:
                self.state = IN_STRING
            return True
        if s == LITERAL:
            if self.lit_rest and b == self.lit_rest[0]:
                self.lit_rest = self.lit_rest[1:]
                if not self.lit_rest:
                    self._end_value()
                return True
            return False

        # number states: a delimiter byte ends the number and is then
        # re-dispatched through AFTER_VALUE handling
        if s in (NUM_MINUS, NUM_ZERO, NUM_INT, NUM_DOT, NUM_FRAC, NUM_EXP,
                 NUM_EXP_SIGN, NUM_EXP_DIGITS):
            if s == NUM_MINUS:
                if b == 0x30:
                    self.state = NUM_ZERO
                elif b in _DIGITS:
                    self.state = NUM_INT
                else:
                    return False
                return True
            if s == NUM_DOT:
                if b in _DIGITS:
                    self.state = NUM_FRAC
                    return True
                return False
            if s in (NUM_EXP, NUM_EXP_SIGN):
                if s == NUM_EXP and b in b"+-":
                    self.state = NUM_EXP_SIGN
                    return True
                if b in _DIGITS:
                    self.state = NUM_EXP_DIGITS
                    return True
                return False
            # NUM_ZERO / NUM_INT / NUM_FRAC / NUM_EXP_DIGITS
            if b in _DIGITS:
                if s == NUM_ZERO:
                    return False  # no leading zeros
                return True
            if b == 0x2E and s in (NUM_ZERO, NUM_INT):  # .
                self.state = NUM_DOT
                return True
            if b in b"eE" and s in (NUM_ZERO, NUM_INT, NUM_FRAC):
                self.state = NUM_EXP
                return True
            # delimiter: number is complete -> treat as AFTER_VALUE input
            self._end_value()
            return self.advance(b)

        if s == VALUE:
            if b in _WS:
                return True
            if self.require_object and not self.started:
                if b != 0x7B:
                    return False
                self.started = True
                return self._start_value(b)
            self.started = True
            return self._start_value(b)
        if s == AFTER_VALUE:
            if b in _WS:
                return True
            if not self.stack:
                return False  # nothing may follow the top-level value
            top = self.stack[-1]
            if top == "o":
                if b == 0x2C:  # ,
                    self.state = OBJ_KEY
                    return True
                if b == 0x7D:  # }
                    self._pop()
                    self._end_value()
                    return True
                return False
            if top == "a":
                if b == 0x2C:
                    self.state = VALUE
                    return True
                if b == 0x5D:  # ]
                    self._pop()
                    self._end_value()
                    return True
                return False
            return False
        if s == OBJ_KEY_OR_END:
            if b in _WS:
                return True
            if b == 0x7D:
                self._pop()
                self._end_value()
                return True
            if b == 0x22:
                self._push("k")
                self.state = IN_STRING
                return True
            return False
        if s == OBJ_KEY:
            if b in _WS:
                return True
            if b == 0x22:
                self._push("k")
                self.state = IN_STRING
                return True
            return False
        if s == OBJ_COLON:
            if b in _WS:
                return True
            if b == 0x3A:  # :
                self.state = VALUE
                return True
            return False
        if s == ARR_VALUE_OR_END:
            if b in _WS:
                return True
            if b == 0x5D:
                self._pop()
                self._end_value()
                return True
            self.state = VALUE
            return self.advance(b)
        raise AssertionError(f"unknown state {s}")

    def advance_bytes(self, bs: bytes) -> bool:
        for b in bs:
            if not self.advance(b):
                return False
        return True

    def closing_string(self) -> bytes:
        """Canonical shortest byte string that completes the JSON."""
        m = self.copy()
        out = bytearray()

        def emit(bs: bytes):
            ok = m.advance_bytes(bs)
            assert ok, (bytes(out), bs, m)
            out.extend(bs)

        guard = 0
        while not m.complete:
            guard += 1
            if guard > 4096:
                raise AssertionError("closing_string did not converge")
            s = m.state
            if s == IN_STRING:
                emit(b'"')
            elif s == STR_ESCAPE:
                emit(b'n"')
            elif s == STR_UNICODE:
                emit(b"0" * m.hex_left + b'"')
            elif s == LITERAL:
                emit(m.lit_rest)
            elif s in (NUM_MINUS, NUM_DOT, NUM_EXP, NUM_EXP_SIGN):
                emit(b"0")
            elif s == VALUE:
                emit(b"{" if (m.require_object and not m.started) else b"0")
            elif s == OBJ_COLON:
                emit(b":0")
            elif s == OBJ_KEY:
                emit(b'"":0')
            elif s in (OBJ_KEY_OR_END, ARR_VALUE_OR_END):
                emit(b"}" if s == OBJ_KEY_OR_END else b"]")
            elif s == AFTER_VALUE or s in _NUM_COMPLETE:
                top = m.stack[-1]
                if top == "o":
                    emit(b"}")
                elif top == "a":
                    emit(b"]")
                else:  # pragma: no cover - 'k' never coexists with AFTER_VALUE
                    raise AssertionError(top)
            else:  # pragma: no cover
                raise AssertionError(s)
        return bytes(out)

    def signature(self) -> tuple:
        return (self.state, self.stack, self.lit_rest, self.hex_left,
                self.started)


class TokenConstraint:
    """Vocabulary-level mask builder for a :class:`JsonMachine`.

    ``token_bytes[i]`` is the byte expansion of vocab id ``i`` (empty for
    special/control tokens, which are never allowed; EOS is allowed exactly
    when the machine reports ``complete``).
    """

    def __init__(self, token_bytes: list[bytes], eos_ids: set[int]):
        self.token_bytes = token_bytes
        self.eos_ids = set(eos_ids)
        v = len(token_bytes)
        self._cache: dict[tuple, np.ndarray] = {}
        self._stable_cache: dict[tuple, np.ndarray] = {}
        self._cp_vals = None  # lazy codepoint index (grammar fast path)
        # string-safe: every byte stays inside IN_STRING
        safe = np.zeros(v, bool)
        unsafe_ids = []
        by_first: dict[int, list[int]] = {}
        for i, tb in enumerate(token_bytes):
            if not tb or i in self.eos_ids:
                continue
            by_first.setdefault(tb[0], []).append(i)
            if all(b >= 0x20 and b not in (0x22, 0x5C) for b in tb):
                safe[i] = True
            else:
                unsafe_ids.append(i)
        self.string_safe = safe
        self.string_unsafe_ids = np.asarray(unsafe_ids, np.int32)
        self.first_byte = {b: np.asarray(ids, np.int32)
                           for b, ids in by_first.items()}

    def _ensure_cp_index(self):
        """Per-token codepoint arrays for the vectorized stable-ranges fast
        path (grammar machines). Tokens whose bytes are not valid complete
        UTF-8 (byte-level BPE can split codepoints) stay on the slow walk."""
        if self._cp_vals is not None:
            return
        vals, owner = [], []
        decodable = np.zeros(len(self.token_bytes), bool)
        for i, tb in enumerate(self.token_bytes):
            if not tb or i in self.eos_ids:
                continue
            try:
                s = tb.decode("utf-8")
            except UnicodeDecodeError:
                continue
            decodable[i] = True
            for ch in s:
                vals.append(ord(ch))
                owner.append(i)
        self._cp_vals = np.asarray(vals, np.int64)
        self._cp_owner = np.asarray(owner, np.int64)
        self._cp_decodable = decodable

    def _stable_token_mask(self, ranges: tuple) -> np.ndarray:
        """bool[V]: tokens decodable to codepoints that ALL lie in `ranges`
        (sorted, disjoint). Such tokens provably keep the machine in the
        same state, so they are legal without a byte walk."""
        m = self._stable_cache.get(ranges)
        if m is None:
            self._ensure_cp_index()
            starts = np.asarray([lo for lo, _ in ranges], np.int64)
            ends = np.asarray([hi for _, hi in ranges], np.int64)
            idx = np.searchsorted(starts, self._cp_vals, side="right") - 1
            in_r = (idx >= 0) & (
                self._cp_vals <= ends[np.clip(idx, 0, len(ends) - 1)]
            )
            m = self._cp_decodable.copy()
            m[np.unique(self._cp_owner[~in_r])] = False
            self._stable_cache[ranges] = m
        return m

    def _walk(self, machine, ids) -> np.ndarray:
        out = []
        tb = self.token_bytes
        for i in ids:
            m = machine.copy()
            if m.advance_bytes(tb[i]):
                out.append(i)
        return np.asarray(out, np.int32)

    def allowed(self, machine) -> np.ndarray:
        """bool[V] — tokens whose whole byte string is a legal continuation.
        EOS ids are allowed iff the machine is already complete. `machine`
        is any object with the JsonMachine protocol (grammar.GrammarMachine
        included); machines exposing `stable_ranges()` get a vectorized
        fast path for self-loop states."""
        key = machine.signature()
        mask = self._cache.get(key)
        if mask is None:
            v = len(self.token_bytes)
            mask = np.zeros(v, bool)
            if isinstance(machine, JsonMachine) and machine.state == IN_STRING:
                mask |= self.string_safe
                ok = self._walk(machine, self.string_unsafe_ids)
                mask[ok] = True
            else:
                stable = getattr(machine, "stable_ranges", None)
                ranges = stable() if stable is not None else ()
                if ranges:
                    mask |= self._stable_token_mask(tuple(ranges))
                # walk the rest, restricted to tokens whose FIRST byte is a
                # legal continuation
                first_ok = [b for b in self.first_byte
                            if machine.copy().advance(b)]
                for b in first_ok:
                    ids = self.first_byte[b]
                    if ranges:
                        ids = ids[~mask[ids]]
                    ok = self._walk(machine, ids)
                    mask[ok] = True
            self._cache[key] = mask
        mask = mask.copy()
        if machine.complete:
            for e in self.eos_ids:
                mask[e] = True
        return mask

    def closing_allowed(self, machine: JsonMachine) -> np.ndarray:
        """Like :meth:`allowed` but restricted to tokens that strictly
        shrink the canonical completion (used when the budget nears
        ``len(closing_string())`` so generation ends with valid JSON).
        Falls back to the full mask if no token shrinks it (then the
        machine is mid-construct and any legal byte makes progress)."""
        key = ("closing",) + machine.signature()
        mask = self._cache.get(key)
        if mask is None:
            base = self.allowed(machine)
            dist = len(machine.closing_string())
            mask = np.zeros_like(base)
            tb = self.token_bytes
            for i in np.nonzero(base)[0]:
                if int(i) in self.eos_ids:
                    mask[i] = True
                    continue
                m = machine.copy()
                if not m.advance_bytes(tb[i]):
                    continue
                if m.complete or len(m.closing_string()) < dist:
                    mask[i] = True
            if not mask.any():
                mask = base
            self._cache[key] = mask
        mask = mask.copy()
        if machine.complete:
            for e in self.eos_ids:
                mask[e] = True
        return mask


def constraint_for(tokenizer, mode: str = "json") -> TokenConstraint:
    """Build a TokenConstraint over a BPE/SPM tokenizer's vocabulary."""
    if mode not in ("json", "json_object"):
        raise ValueError(f"unsupported response_format {mode!r}")
    n = tokenizer.vocab_size
    toks = []
    for i in range(n):
        try:
            toks.append(tokenizer.decode_token_bytes(i))
        except Exception:  # special / malformed entries are never allowed
            toks.append(b"")
    eos = {i for i in range(n) if tokenizer.is_eos(i)}
    return TokenConstraint(toks, eos)
