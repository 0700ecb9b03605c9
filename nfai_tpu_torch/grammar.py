"""GBNF grammars, regex, and JSON-schema constrained decoding.

The port's copy of nfai_tpu/grammar.py (standard library only; nothing is
trimmed), with one repair: `GrammarMachine._interval_ok` skips a finished
parse before reading its top element, where the JAX copy raises IndexError
on the first UTF-8 lead byte it meets in a state where a parse has finished
(a grammar that matches the empty string, at its first token). Extends the JSON-only constrained decoding in
:mod:`nfai_tpu_torch.constrained` to arbitrary context-free grammars.
Three front-ends compile to one IR:

- :func:`parse_gbnf` — llama.cpp's GBNF grammar format (``root ::= ...``,
  literals, char classes, ``| ( ) * + ? {m,n}`` and rule references);
- :func:`regex_to_grammar` — a practical regex subset (full-match);
- :func:`json_schema_to_grammar` — JSON Schema (types, properties/required,
  enum/const, items/min/maxItems, anyOf/oneOf, $defs/$ref).

The IR is a :class:`Grammar`: rules -> alternates -> elements, where an
element is either a codepoint-class ``("char", ranges, negated)`` or a rule
reference ``("ref", name)``. Repetition operators are desugared into
synthetic rules at build time (``e*`` -> ``R ::= e R | ε``), so the runtime
machine only ever sees chars and refs.

:class:`GrammarMachine` implements the same protocol as
``constrained.JsonMachine`` (``copy / advance / advance_bytes / complete /
closing_string / signature``) so ``constrained.TokenConstraint`` masks work
unchanged. It keeps a SET of parse stacks (frames ``(rule, alt, pos)``),
advancing all of them per codepoint and dropping dead ones — the standard
Earley-style PDA-set construction llama.cpp's grammar sampler also uses.
Bytes arrive one at a time (BPE tokens can split UTF-8 codepoints); a
partial multibyte sequence is accepted iff its reachable codepoint interval
intersects some stack's accept-set.

``stable_ranges()`` reports codepoint ranges on which the machine provably
returns to the *same* signature (e.g. the body of ``[^"]*``): the
TokenConstraint fast path accepts every token made only of such codepoints
without walking it byte-by-byte, which is what makes 128k-vocab masking
cheap for string/identifier-heavy grammars.

The reference has no grammar support at all (SamplingUtils.cs is plain
top-k/top-p); this follows the llama.cpp GBNF *format* for ecosystem
compatibility but is an independent implementation.
"""
from __future__ import annotations

import json

# element kinds
CHAR = "char"  # ("char", ((lo, hi), ...), negated)
REF = "ref"  # ("ref", rule_name)

MAX_CODEPOINT = 0x10FFFF
MAX_STACK_DEPTH = 256
MAX_STACKS = 512


class GrammarError(ValueError):
    pass


def _char(*ranges, neg=False):
    return (CHAR, tuple((lo, hi) for lo, hi in ranges), bool(neg))


def _lit_elems(s: str):
    return [_char((ord(c), ord(c))) for c in s]


class Grammar:
    """rules: name -> tuple of alternates; alternate: tuple of elements."""

    def __init__(self, rules: dict, root: str = "root"):
        if root not in rules:
            raise GrammarError(f"no '{root}' rule")
        for name, alts in rules.items():
            for alt in alts:
                for el in alt:
                    if el[0] == REF and el[1] not in rules:
                        raise GrammarError(
                            f"rule {name!r} references undefined {el[1]!r}"
                        )
        self.rules = {k: tuple(tuple(a) for a in v) for k, v in rules.items()}
        self.root = root
        self._minlen = self._compute_minlens()
        if self._minlen.get(root) is None:
            raise GrammarError(f"rule {root!r} cannot derive any string")

    def _compute_minlens(self) -> dict:
        """Fixpoint: minimum number of codepoints each rule can derive
        (None while/if underivable). Used by closing_string()."""
        ml: dict = {name: None for name in self.rules}
        changed = True
        while changed:
            changed = False
            for name, alts in self.rules.items():
                best = ml[name]
                for alt in alts:
                    total = 0
                    for el in alt:
                        if el[0] == CHAR:
                            total += 1
                        else:
                            sub = ml[el[1]]
                            if sub is None:
                                total = None
                                break
                            total += sub
                    if total is not None and (best is None or total < best):
                        best = total
                if best != ml[name]:
                    ml[name] = best
                    changed = True
        return ml

    def alt_tail_cost(self, rule: str, alt: int, pos: int):
        """Min codepoints to finish alternate `alt` of `rule` from `pos`
        (None if it cannot terminate)."""
        total = 0
        for el in self.rules[rule][alt][pos:]:
            if el[0] == CHAR:
                total += 1
            else:
                sub = self._minlen[el[1]]
                if sub is None:
                    return None
                total += sub
        return total


def _ranges_match(ranges, neg, c: int) -> bool:
    hit = any(lo <= c <= hi for lo, hi in ranges)
    return hit != neg


def _ranges_intersect_interval(ranges, neg, a: int, b: int) -> bool:
    """Does the element's accept-set intersect codepoint interval [a, b]?"""
    if not neg:
        return any(max(lo, a) <= min(hi, b) for lo, hi in ranges)
    # negated: intersects unless `ranges` covers [a, b] entirely
    covered = 0
    pieces = sorted(
        (max(lo, a), min(hi, b)) for lo, hi in ranges if max(lo, a) <= min(hi, b)
    )
    pos = a
    for lo, hi in pieces:
        if lo > pos:
            return True
        pos = max(pos, hi + 1)
        if pos > b:
            break
    return pos <= b


def _representative(ranges, neg) -> int:
    """A canonical codepoint accepted by the element (prefer printable
    ASCII) — used when emitting the shortest closing string."""
    if not neg:
        best = None
        for lo, hi in ranges:
            for cand in (0x20, 0x30, 0x61):
                if lo <= cand <= hi:
                    return cand
            if best is None or lo < best:
                best = lo
        if best is None:
            raise GrammarError("empty character class")
        return best
    for cand in (0x20, 0x30, 0x61, 0x41, 0x5F):
        if _ranges_match(ranges, neg, cand):
            return cand
    c = 0x20
    while c <= MAX_CODEPOINT:
        if 0xD800 <= c <= 0xDFFF:
            c = 0xE000
            continue
        if _ranges_match(ranges, neg, c):
            return c
        c += 1
    raise GrammarError("negated class accepts nothing")


# ---------------------------------------------------------------------------
# the machine


def _utf8_len(lead: int):
    if lead < 0x80:
        return 1
    if 0xC2 <= lead <= 0xDF:
        return 2
    if 0xE0 <= lead <= 0xEF:
        return 3
    if 0xF0 <= lead <= 0xF4:
        return 4
    return None  # bare continuation / overlong lead / >U+10FFFF lead


def _partial_interval(pend: bytes):
    """Reachable codepoint interval [lo, hi] for a structurally valid
    UTF-8 prefix (None if the prefix is invalid)."""
    need = _utf8_len(pend[0])
    if need is None or need == 1:
        return None
    v = pend[0] & (0x7F >> need)
    for b in pend[1:]:
        if not 0x80 <= b <= 0xBF:
            return None
        v = (v << 6) | (b & 0x3F)
    rem = need - len(pend)
    lo = v << (6 * rem)
    hi = (v << (6 * rem)) | ((1 << (6 * rem)) - 1)
    # clamp to the valid range for the sequence length (rejects overlong
    # encodings, surrogates-only intervals and > U+10FFFF)
    floor = (0x80, 0x800, 0x10000)[need - 2]
    lo, hi = max(lo, floor), min(hi, MAX_CODEPOINT)
    if lo > hi:
        return None
    if lo >= 0xD800 and hi <= 0xDFFF:
        return None
    return lo, hi


class GrammarMachine:
    """Byte-level matcher for a :class:`Grammar` (protocol-compatible with
    ``constrained.JsonMachine``; callers mutate copies)."""

    def __init__(self, grammar: Grammar, _key=None):
        self.g = grammar
        self.key = _key if _key is not None else id(grammar)
        self.pending = b""
        root_alts = range(len(grammar.rules[grammar.root]))
        self.stacks = self._normalize(
            frozenset(((grammar.root, a, 0),) for a in root_alts)
        )

    def copy(self) -> "GrammarMachine":
        m = object.__new__(GrammarMachine)
        m.g, m.key, m.pending, m.stacks = self.g, self.key, self.pending, self.stacks
        return m

    # -- stack mechanics -----------------------------------------------------
    def _top_elem(self, stack):
        rule, alt, pos = stack[-1]
        a = self.g.rules[rule][alt]
        return a[pos] if pos < len(a) else None

    def _normalize(self, stacks) -> frozenset:
        """Expand refs / pop finished alternates until every stack is empty
        (complete) or tops at a char element."""
        out = set()
        seen = set()
        work = list(stacks)
        while work:
            st = work.pop()
            if st in seen:
                continue
            seen.add(st)
            if not st:
                out.add(st)
                continue
            el = self._top_elem(st)
            if el is None:  # alternate finished -> pop frame
                work.append(st[:-1])
                continue
            if el[0] == CHAR:
                out.add(st)
                continue
            # ref: advance the calling frame past it, push callee alternates
            if len(st) >= MAX_STACK_DEPTH:
                continue  # prune runaway recursion (left-recursive grammars)
            rule, alt, pos = st[-1]
            if pos + 1 == len(self.g.rules[rule][alt]):
                # tail call: nothing left in this frame — drop it so
                # right-recursive loops (star/plus desugaring) run at
                # constant stack depth and their signatures repeat (cache
                # hits + stable_ranges both depend on this)
                base = st[:-1]
            else:
                base = st[:-1] + ((rule, alt, pos + 1),)
            for a in range(len(self.g.rules[el[1]])):
                work.append(base + ((el[1], a, 0),))
        if len(out) > MAX_STACKS:
            # keep the shallowest stacks — deep ones are runaway recursion
            out = set(sorted(out, key=len)[:MAX_STACKS])
        return frozenset(out)

    def _advance_cp(self, c: int) -> bool:
        nxt = set()
        for st in self.stacks:
            if not st:
                continue
            el = self._top_elem(st)
            if _ranges_match(el[1], el[2], c):
                rule, alt, pos = st[-1]
                nxt.add(st[:-1] + ((rule, alt, pos + 1),))
        if not nxt:
            return False
        self.stacks = self._normalize(nxt)
        return True

    def _interval_ok(self, a: int, b: int) -> bool:
        # a finished parse (the empty stack) has no element to take the
        # bytes: it is skipped before its top is read (the JAX copy reads it
        # first and raises IndexError, e.g. for a grammar that matches "")
        return any(
            _ranges_intersect_interval(el[1], el[2], a, b)
            for st in self.stacks if st
            for el in (self._top_elem(st),)
        )

    # -- protocol ------------------------------------------------------------
    @property
    def complete(self) -> bool:
        return not self.pending and () in self.stacks

    def advance(self, b: int) -> bool:
        pend = self.pending + bytes([b])
        need = _utf8_len(pend[0])
        if need is None:
            return False
        if len(pend) < need:
            iv = _partial_interval(pend)
            if iv is None or not self._interval_ok(*iv):
                return False
            self.pending = pend
            return True
        if need == 1:
            cp = pend[0]
        else:
            iv = _partial_interval(pend[:-1]) if len(pend) > 1 else None
            try:
                cp = ord(pend.decode("utf-8"))
            except (UnicodeDecodeError, TypeError):
                return False
        self.pending = b""
        return self._advance_cp(cp)

    def advance_bytes(self, bs: bytes) -> bool:
        for b in bs:
            if not self.advance(b):
                return False
        return True

    def signature(self) -> tuple:
        return (self.key, self.stacks, self.pending)

    def _stack_cost(self, st):
        total = 0
        for rule, alt, pos in st:
            c = self.g.alt_tail_cost(rule, alt, pos)
            if c is None:
                return None
            total += c
        return total

    def closing_string(self) -> bytes:
        """Shortest (greedy) byte string completing the match."""
        m = self.copy()
        out = bytearray()
        if m.pending:
            # finish the pending codepoint: smallest reachable accepted cp
            iv = _partial_interval(m.pending)
            assert iv is not None
            cp = None
            for st in m.stacks:
                if not st:
                    continue
                el = m._top_elem(st)
                for c in range(iv[0], min(iv[1], iv[0] + 4096) + 1):
                    if _ranges_match(el[1], el[2], c):
                        cp = c if cp is None else min(cp, c)
                        break
            assert cp is not None, "pending bytes have no completion"
            tail = cp.to_bytes(4, "big").lstrip(b"\x00")
            enc = chr(cp).encode("utf-8")
            rest = enc[len(m.pending):]
            ok = m.advance_bytes(rest)
            assert ok
            out.extend(rest)
        guard = 0
        while not m.complete:
            guard += 1
            if guard > 65536:
                raise GrammarError("closing_string did not converge")
            best = None
            for st in m.stacks:
                if not st:
                    continue
                cost = m._stack_cost(st)
                if cost is not None and (best is None or cost < best[0]):
                    best = (cost, st)
            assert best is not None, "no terminating continuation"
            el = m._top_elem(best[1])
            cp = _representative(el[1], el[2])
            bs = chr(cp).encode("utf-8")
            ok = m.advance_bytes(bs)
            assert ok
            out.extend(bs)
        return bytes(out)

    def stable_ranges(self):
        """Codepoint ranges on which `advance` provably maps this signature
        to itself (self-loop states like ``[^"]*`` bodies). Decompose the
        union of top-element boundaries into uniform pieces (every cp in a
        piece matches the same element set -> same successor), then keep
        pieces whose successor signature equals this one."""
        if self.pending:
            return ()
        bounds = set()
        for st in self.stacks:
            if not st:
                continue
            el = self._top_elem(st)
            for lo, hi in el[1]:
                bounds.add(lo)
                bounds.add(hi + 1)
            if el[2]:  # negated classes accept outside their ranges too
                bounds.add(0x20)
                bounds.add(MAX_CODEPOINT + 1)
        bounds.add(0)
        bounds.add(MAX_CODEPOINT + 1)
        edges = sorted(b for b in bounds if 0 <= b <= MAX_CODEPOINT + 1)
        sig = self.signature()
        out = []
        for a, b in zip(edges[:-1], edges[1:]):
            hi = b - 1
            rep = a if not (0xD800 <= a <= 0xDFFF) else 0xE000
            if rep > hi or (0xD800 <= rep <= 0xDFFF):
                continue
            m = self.copy()
            if m._advance_cp(rep) and m.signature() == sig:
                out.append((a, hi))
        # merge adjacent
        merged = []
        for lo, hi in out:
            if merged and merged[-1][1] + 1 == lo:
                merged[-1] = (merged[-1][0], hi)
            else:
                merged.append((lo, hi))
        return tuple(merged)


# ---------------------------------------------------------------------------
# GBNF parser (llama.cpp grammar format)


class _GbnfParser:
    def __init__(self, text: str):
        self.text = text
        self.i = 0
        self.rules: dict = {}
        self.counter = 0

    def error(self, msg):
        line = self.text.count("\n", 0, self.i) + 1
        raise GrammarError(f"GBNF parse error line {line}: {msg}")

    def _ws(self, newlines=True):
        while self.i < len(self.text):
            c = self.text[self.i]
            if c == "#":
                while self.i < len(self.text) and self.text[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r" or (newlines and c == "\n"):
                self.i += 1
            else:
                break

    def _peek(self):
        return self.text[self.i] if self.i < len(self.text) else ""

    def _name(self):
        j = self.i
        while j < len(self.text) and (
            self.text[j].isalnum() or self.text[j] in "-_"
        ):
            j += 1
        if j == self.i:
            self.error("expected rule name")
        name, self.i = self.text[self.i:j], j
        return name

    def _fresh(self, base):
        self.counter += 1
        return f"{base}-{self.counter}"

    def _escape(self, in_class: bool) -> int:
        c = self.text[self.i]
        self.i += 1
        if c != "\\":
            return ord(c)
        if self.i >= len(self.text):
            self.error("dangling escape")
        e = self.text[self.i]
        self.i += 1
        simple = {"n": 10, "t": 9, "r": 13, '"': 34, "\\": 92, "/": 47,
                  "]": 93, "[": 91, "-": 45, "^": 94}
        if e in simple:
            return simple[e]
        if e in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[e]
            h = self.text[self.i:self.i + n]
            if len(h) != n:
                self.error(f"\\{e} needs {n} hex digits")
            self.i += n
            return int(h, 16)
        self.error(f"unknown escape \\{e}")

    def _char_class(self):
        assert self.text[self.i] == "["
        self.i += 1
        neg = self._peek() == "^"
        if neg:
            self.i += 1
        ranges = []
        while self._peek() and self._peek() != "]":
            lo = self._escape(True)
            hi = lo
            if self._peek() == "-" and self.text[self.i + 1:self.i + 2] != "]":
                self.i += 1
                hi = self._escape(True)
            if hi < lo:
                self.error("inverted range")
            ranges.append((lo, hi))
        if self._peek() != "]":
            self.error("unterminated character class")
        self.i += 1
        if not ranges and not neg:
            self.error("empty character class")
        return _char(*ranges, neg=neg) if ranges else _char(
            (0xD800, 0xDFFF)
        )  # [^] == any char; encode as "not surrogates"

    def _literal(self):
        assert self.text[self.i] == '"'
        self.i += 1
        elems = []
        while self._peek() and self._peek() != '"':
            elems.append(_char((lambda c: (c, c))(self._escape(False))))
        if self._peek() != '"':
            self.error("unterminated literal")
        self.i += 1
        return elems

    def _repeat(self, elems, base, lo, hi):
        """elems{lo,hi} (hi=None -> unbounded) as a synthetic-rule sequence."""
        seq = []
        for _ in range(lo):
            seq.extend(elems)
        if hi is None:
            star = self._fresh(base)
            self.rules[star] = [list(elems) + [(REF, star)], []]
            seq.append((REF, star))
        else:
            for _ in range(hi - lo):
                opt = self._fresh(base)
                self.rules[opt] = [list(elems), []]
                seq.append((REF, opt))
        return seq

    def _sequence(self, rule_name):
        """One alternate: a sequence of (possibly repeated) items."""
        elems = []
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == '"':
                item = self._literal()
            elif c == "[":
                item = [self._char_class()]
            elif c == "(":
                self.i += 1
                sub = self._fresh(rule_name)
                self.rules[sub] = self._alternates(sub, ")")
                if self._peek() != ")":
                    self.error("unterminated group")
                self.i += 1
                item = [(REF, sub)]
            elif c and (c.isalnum() or c in "-_"):
                save = self.i
                name = self._name()
                self._ws(newlines=False)
                if self.text[self.i:self.i + 3] == "::=":
                    self.i = save  # next rule definition — stop
                    break
                item = [(REF, name)]
            else:
                break
            # postfix operators
            self._ws(newlines=False)
            op = self._peek()
            if op == "*":
                self.i += 1
                item = self._repeat(item, rule_name, 0, None)
            elif op == "+":
                self.i += 1
                item = self._repeat(item, rule_name, 1, None)
            elif op == "?":
                self.i += 1
                item = self._repeat(item, rule_name, 0, 1)
            elif op == "{":
                self.i += 1
                j = self.text.find("}", self.i)
                if j < 0:
                    self.error("unterminated {m,n}")
                spec = self.text[self.i:j].strip()
                self.i = j + 1
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
                if hi is not None and hi < lo:
                    self.error("{m,n} with n < m")
                item = self._repeat(item, rule_name, lo, hi)
            elems.extend(item)
        return elems

    def _alternates(self, rule_name, closer=None):
        alts = [self._sequence(rule_name)]
        while True:
            self._ws(newlines=closer is not None)
            if self._peek() == "|":
                self.i += 1
                alts.append(self._sequence(rule_name))
            else:
                break
        return alts

    def parse(self) -> Grammar:
        while True:
            self._ws()
            if self.i >= len(self.text):
                break
            name = self._name()
            self._ws(newlines=False)
            if self.text[self.i:self.i + 3] != "::=":
                self.error(f"expected '::=' after rule name {name!r}")
            self.i += 3
            alts = self._alternates(name)
            if name in self.rules:
                self.error(f"duplicate rule {name!r}")
            self.rules[name] = alts
        if not self.rules:
            raise GrammarError("empty grammar")
        return Grammar(self.rules, root="root")


def parse_gbnf(text: str) -> Grammar:
    return _GbnfParser(text).parse()


# ---------------------------------------------------------------------------
# regex -> Grammar (full-match, practical subset)


class _RegexParser:
    r"""Supported: literals, ``.``, ``[classes]`` (ranges, negation,
    ``\d \w \s`` inside), groups ``( )`` (capturing = non-capturing),
    ``(?:...)``, ``|``, ``* + ? {m} {m,n} {m,}``, escapes
    ``\d \D \w \W \s \S \n \t \r \. \\ ...``. Anchors ``^ $`` are implied
    (the whole output must match) and permitted (ignored) at the ends."""

    D = (((0x30, 0x39),), False)
    W = (((0x30, 0x39), (0x41, 0x5A), (0x5F, 0x5F), (0x61, 0x7A)), False)
    S = (((0x09, 0x0D), (0x20, 0x20)), False)

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.rules: dict = {}
        self.counter = 0

    def error(self, msg):
        raise GrammarError(f"regex error at {self.i}: {msg} in {self.p!r}")

    def _fresh(self):
        self.counter += 1
        return f"re-{self.counter}"

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else ""

    def _class_escape(self):
        """One escape inside/outside a class -> ('set', ranges, neg) or
        ('char', cp)."""
        assert self.p[self.i] == "\\"
        self.i += 1
        if self.i >= len(self.p):
            self.error("dangling backslash")
        e = self.p[self.i]
        self.i += 1
        table = {"d": (self.D, False), "D": (self.D, True),
                 "w": (self.W, False), "W": (self.W, True),
                 "s": (self.S, False), "S": (self.S, True)}
        if e in table:
            (ranges, base_neg), flip = table[e]
            return ("set", ranges, base_neg != flip)
        simple = {"n": 10, "t": 9, "r": 13, "f": 12, "v": 11, "0": 0}
        if e in simple:
            return ("char", simple[e])
        if e == "x":
            h = self.p[self.i:self.i + 2]
            if len(h) != 2:
                self.error("\\x needs 2 hex digits")
            self.i += 2
            return ("char", int(h, 16))
        if e == "u":
            if self._peek() == "{":
                j = self.p.find("}", self.i)
                if j < 0:
                    self.error("unterminated \\u{...}")
                cp = int(self.p[self.i + 1:j], 16)
                self.i = j + 1
                return ("char", cp)
            h = self.p[self.i:self.i + 4]
            if len(h) != 4:
                self.error("\\u needs 4 hex digits")
            self.i += 4
            return ("char", int(h, 16))
        if e.isalnum():
            self.error(f"unsupported escape \\{e}")
        return ("char", ord(e))  # escaped metachar

    def _char_class(self):
        assert self.p[self.i] == "["
        self.i += 1
        neg = self._peek() == "^"
        if neg:
            self.i += 1
        ranges = []
        sub_negs = []  # \D etc. inside a class
        first = True
        while self._peek() and (self._peek() != "]" or first):
            first = False
            if self._peek() == "\\":
                kind, *rest = self._class_escape()
                if kind == "set":
                    sr, sn = rest
                    if sn:
                        sub_negs.append(sr)
                    else:
                        ranges.extend(sr)
                    continue
                lo = rest[0]
            else:
                lo = ord(self.p[self.i])
                self.i += 1
            hi = lo
            if self._peek() == "-" and self.p[self.i + 1:self.i + 2] not in ("", "]"):
                self.i += 1
                if self._peek() == "\\":
                    kind, *rest = self._class_escape()
                    if kind == "set":
                        self.error("class set in range")
                    hi = rest[0]
                else:
                    hi = ord(self.p[self.i])
                    self.i += 1
            if hi < lo:
                self.error("inverted range")
            ranges.append((lo, hi))
        if self._peek() != "]":
            self.error("unterminated class")
        self.i += 1
        if sub_negs:
            if ranges or neg or len(sub_negs) > 1:
                self.error("unsupported mixed negated-class combination")
            return _char(*sub_negs[0], neg=True)
        if not ranges:
            self.error("empty class")
        return _char(*ranges, neg=neg)

    def _atom(self):
        c = self._peek()
        if c == "(":
            self.i += 1
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            elif self._peek() == "?":
                self.error("unsupported (?...) group")
            sub = self._fresh()
            self.rules[sub] = self._alternates()
            if self._peek() != ")":
                self.error("unterminated group")
            self.i += 1
            return [(REF, sub)]
        if c == "[":
            return [self._char_class()]
        if c == ".":
            self.i += 1
            return [_char((0xD800, 0xDFFF), (0x0A, 0x0A), neg=True)]
        if c == "\\":
            kind, *rest = self._class_escape()
            if kind == "set":
                return [_char(*rest[0], neg=rest[1])]
            return [_char((rest[0], rest[0]))]
        if c in ")|":
            return None
        if c in "*+?{":
            self.error(f"nothing to repeat before {c!r}")
        self.i += 1
        return [_char((ord(c), ord(c)))]

    def _repeat(self, item, lo, hi):
        seq = []
        for _ in range(lo):
            seq.extend(item)
        if hi is None:
            star = self._fresh()
            self.rules[star] = [list(item) + [(REF, star)], []]
            seq.append((REF, star))
        else:
            for _ in range(hi - lo):
                opt = self._fresh()
                self.rules[opt] = [list(item), []]
                seq.append((REF, opt))
        return seq

    def _sequence(self):
        elems = []
        while True:
            c = self._peek()
            if not c or c in ")|":
                break
            if c == "^" and not elems and self.i <= 1:
                self.i += 1
                continue
            if c == "$" and (self.i + 1 == len(self.p)
                             or self.p[self.i + 1] in ")|"):
                self.i += 1
                continue
            item = self._atom()
            if item is None:
                break
            op = self._peek()
            if op == "*":
                self.i += 1
                item = self._repeat(item, 0, None)
            elif op == "+":
                self.i += 1
                item = self._repeat(item, 1, None)
            elif op == "?":
                self.i += 1
                item = self._repeat(item, 0, 1)
            elif op == "{":
                j = self.p.find("}", self.i)
                if j < 0:
                    self.error("unterminated {m,n}")
                spec = self.p[self.i + 1:j]
                self.i = j + 1
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s.strip() else None
                else:
                    lo = hi = int(spec)
                if hi is not None and hi < lo:
                    self.error("{m,n} with n < m")
                item = self._repeat(item, lo, hi)
            nxt = self._peek()
            if nxt and nxt in "*+?" and self.p[self.i - 1] in "*+?}":
                self.error("nested quantifier")
            elems.extend(item)
        return elems

    def _alternates(self):
        alts = [self._sequence()]
        while self._peek() == "|":
            self.i += 1
            alts.append(self._sequence())
        return alts

    def parse(self) -> Grammar:
        self.rules["root"] = self._alternates()
        if self.i != len(self.p):
            self.error("unbalanced ')'")
        return Grammar(self.rules, root="root")


def regex_to_grammar(pattern: str) -> Grammar:
    return _RegexParser(pattern).parse()


# ---------------------------------------------------------------------------
# JSON Schema -> Grammar


class _SchemaBuilder:
    """Compiles a JSON-Schema subset to grammar rules. Follows llama.cpp's
    json-schema-to-grammar semantics: objects emit properties in schema
    order, required properties always, optional ones in order when chosen;
    unknown/empty schemas admit any JSON value."""

    def __init__(self, schema):
        self.schema = schema
        self.rules: dict = {}
        self.counter = 0
        self.refs: dict = {}
        self._add_primitives()

    def _fresh(self, base):
        self.counter += 1
        return f"{base}-{self.counter}"

    def _add_primitives(self):
        r = self.rules
        # whitespace and digit runs are BOUNDED (llama.cpp does the same in
        # its schema converter): an unconstrained model may otherwise spin
        # on legal-but-useless whitespace/digits until the budget closes
        # (observed: a 17-digit exponent parsing to float inf)
        sp = _char((0x20, 0x20), (0x09, 0x09), (0x0A, 0x0A))
        r["ws"] = [[], [sp], [sp, _char((0x20, 0x20), (0x09, 0x09))]]
        r["j-digit"] = [[_char((0x30, 0x39))]]
        r["j-dig-0"] = [[]]
        for i in range(1, 16):
            r[f"j-dig-{i}"] = [[], [(REF, "j-digit"), (REF, f"j-dig-{i-1}")]]
        r["j-digits"] = [[(REF, "j-digit"), (REF, "j-dig-15")]]
        r["j-int"] = [
            [_char((0x30, 0x30))],
            [_char((0x31, 0x39)), (REF, "j-dig-15")],
        ]
        r["j-frac"] = [[], _lit_elems(".") + [(REF, "j-digits")]]
        r["j-exp"] = [
            [],
            [_char((0x65, 0x65), (0x45, 0x45)), (REF, "j-sign"),
             (REF, "j-digit"), (REF, "j-dig-3")],
        ]
        r["j-sign"] = [[], [_char((0x2B, 0x2B), (0x2D, 0x2D))]]
        r["j-minus"] = [[], _lit_elems("-")]
        r["j-number"] = [[(REF, "j-minus"), (REF, "j-int"), (REF, "j-frac"),
                          (REF, "j-exp")]]
        r["j-integer"] = [[(REF, "j-minus"), (REF, "j-int")]]
        r["j-hex"] = [[_char((0x30, 0x39), (0x61, 0x66), (0x41, 0x46))]]
        r["j-schar"] = [
            [_char((0x00, 0x1F), (0x22, 0x22), (0x5C, 0x5C),
                   (0xD800, 0xDFFF), neg=True)],
            _lit_elems("\\") + [_char(*[(ord(x), ord(x)) for x in '"\\/bfnrt'])],
            _lit_elems("\\u") + [(REF, "j-hex")] * 4,
        ]
        r["j-schars"] = [[], [(REF, "j-schar"), (REF, "j-schars")]]
        r["j-string"] = [_lit_elems('"') + [(REF, "j-schars")]
                         + _lit_elems('"')]
        r["j-bool"] = [_lit_elems("true"), _lit_elems("false")]
        r["j-null"] = [_lit_elems("null")]
        # generic value (for unconstrained subschemas)
        r["j-value"] = [
            [(REF, "j-string")], [(REF, "j-number")], [(REF, "j-bool")],
            [(REF, "j-null")], [(REF, "j-object")], [(REF, "j-array")],
        ]
        r["j-object"] = (
            [_lit_elems("{") + [(REF, "ws")] + _lit_elems("}"),
             _lit_elems("{") + [(REF, "ws"), (REF, "j-members"), (REF, "ws")]
             + _lit_elems("}")]
        )
        r["j-members"] = [
            [(REF, "j-member")],
            [(REF, "j-member"), (REF, "ws")] + _lit_elems(",")
            + [(REF, "ws"), (REF, "j-members")],
        ]
        r["j-member"] = [[(REF, "j-string"), (REF, "ws")] + _lit_elems(":")
                         + [(REF, "ws"), (REF, "j-value")]]
        r["j-array"] = [
            _lit_elems("[") + [(REF, "ws")] + _lit_elems("]"),
            _lit_elems("[") + [(REF, "ws"), (REF, "j-items"), (REF, "ws")]
            + _lit_elems("]"),
        ]
        r["j-items"] = [
            [(REF, "j-value")],
            [(REF, "j-value"), (REF, "ws")] + _lit_elems(",")
            + [(REF, "ws"), (REF, "j-items")],
        ]

    def _resolve_ref(self, ref: str):
        if not ref.startswith("#/"):
            raise GrammarError(f"unsupported $ref {ref!r} (only #/ paths)")
        node = self.schema
        for part in ref[2:].split("/"):
            part = part.replace("~1", "/").replace("~0", "~")
            if isinstance(node, list):
                node = node[int(part)]
            else:
                node = node[part]
        return node

    def _json_literal(self, value) -> list:
        return _lit_elems(
            json.dumps(value, separators=(",", ":"), ensure_ascii=True)
        )

    def compile(self, schema, name: str) -> str:
        """Returns the rule name matching `schema`."""
        if schema is True or schema == {}:
            return "j-value"
        if schema is False:
            raise GrammarError("schema `false` admits nothing")
        if "$ref" in schema:
            ref = schema["$ref"]
            if ref in self.refs:
                return self.refs[ref]
            rule = self._fresh("ref")
            self.refs[ref] = rule
            self.rules[rule] = [[]]  # placeholder (allows recursive schemas)
            target = self.compile(self._resolve_ref(ref), rule)
            self.rules[rule] = [[(REF, target)]]
            return rule
        if "const" in schema:
            rule = self._fresh(name)
            self.rules[rule] = [self._json_literal(schema["const"])]
            return rule
        if "enum" in schema:
            rule = self._fresh(name)
            self.rules[rule] = [self._json_literal(v) for v in schema["enum"]]
            return rule
        for key in ("anyOf", "oneOf"):
            if key in schema:
                rule = self._fresh(name)
                self.rules[rule] = [
                    [(REF, self.compile(sub, f"{name}-{i}"))]
                    for i, sub in enumerate(schema[key])
                ]
                return rule
        t = schema.get("type")
        if isinstance(t, list):
            rule = self._fresh(name)
            self.rules[rule] = [
                [(REF, self.compile({**schema, "type": ti}, f"{name}-{ti}"))]
                for ti in t
            ]
            return rule
        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, name)
        if t == "array":
            return self._array(schema, name)
        if t == "string":
            if "pattern" in schema:
                pat = schema["pattern"].lstrip("^").rstrip("$")
                sub = _RegexParser(pat)
                body = sub._alternates()
                if sub.i != len(sub.p):
                    raise GrammarError("bad string pattern")
                prefix = self._fresh(name)
                for rn, alts in sub.rules.items():
                    self.rules[f"{prefix}-{rn}"] = [
                        [
                            (REF, f"{prefix}-{el[1]}") if el[0] == REF else el
                            for el in alt
                        ]
                        for alt in alts
                    ]
                rule = self._fresh(name)
                self.rules[rule] = [
                    _lit_elems('"')
                    + [
                        (REF, f"{prefix}-{el[1]}") if el[0] == REF else el
                        for el in alt
                    ]
                    + _lit_elems('"')
                    for alt in body
                ]
                return rule
            return "j-string"
        if t == "number":
            return "j-number"
        if t == "integer":
            return "j-integer"
        if t == "boolean":
            return "j-bool"
        if t == "null":
            return "j-null"
        if t is None:
            return "j-value"
        raise GrammarError(f"unsupported schema type {t!r}")

    def _object(self, schema, name):
        props = list((schema.get("properties") or {}).items())
        required = set(schema.get("required") or ())
        addl = schema.get("additionalProperties", False)
        rule = self._fresh(name)
        if not props:
            if addl:
                self.rules[rule] = [[(REF, "j-object")]]
            else:
                self.rules[rule] = [_lit_elems("{") + [(REF, "ws")]
                                    + _lit_elems("}")]
            return rule
        if addl:
            raise GrammarError(
                "additionalProperties with fixed properties is unsupported"
            )
        kv_rules = []
        for pname, pschema in props:
            vr = self.compile(pschema, f"{name}-{pname}")
            kv = self._fresh(f"{name}-kv")
            self.rules[kv] = [
                self._json_literal(pname) + [(REF, "ws")] + _lit_elems(":")
                + [(REF, "ws"), (REF, vr)]
            ]
            kv_rules.append((pname in required, kv))
        # tail(i): the members from position i on, given at least one member
        # was already emitted (so each starts with ", "): required members
        # must appear; optional ones may be skipped.
        n = len(kv_rules)
        tails: dict[int, str] = {}

        def tail(i: int) -> str:
            if i in tails:
                return tails[i]
            rn = self._fresh(f"{name}-tail")
            tails[i] = rn
            if i == n:
                self.rules[rn] = [[]]
                return rn
            req, kv = kv_rules[i]
            with_me = (
                [(REF, "ws")] + _lit_elems(",")
                + [(REF, "ws"), (REF, kv), (REF, tail(i + 1))]
            )
            self.rules[rn] = [with_me] if req else [with_me,
                                                    [(REF, tail(i + 1))]]
            return rn

        # head: choose the FIRST emitted member (no leading comma), which is
        # the first required member or any optional one before it.
        alts = []
        for i, (req, kv) in enumerate(kv_rules):
            alts.append([(REF, kv), (REF, tail(i + 1))])
            if req:
                break
        else:
            alts.append([])  # all optional: empty object allowed
        body = self._fresh(f"{name}-body")
        self.rules[body] = alts
        self.rules[rule] = [
            _lit_elems("{") + [(REF, "ws"), (REF, body), (REF, "ws")]
            + _lit_elems("}")
        ]
        return rule

    def _array(self, schema, name):
        items = schema.get("items")
        if isinstance(items, list):  # tuple validation
            parts: list = _lit_elems("[") + [(REF, "ws")]
            for i, sub in enumerate(items):
                if i:
                    parts += _lit_elems(",") + [(REF, "ws")]
                parts += [(REF, self.compile(sub, f"{name}-{i}")), (REF, "ws")]
            rule = self._fresh(name)
            self.rules[rule] = [parts + _lit_elems("]")]
            return rule
        item_rule = self.compile(items if items is not None else {},
                                 f"{name}-item")
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        rule = self._fresh(name)
        sep: list = [(REF, "ws")] + _lit_elems(",") + [(REF, "ws")]
        one = [(REF, item_rule)]
        if hi is not None:
            hi = int(hi)
            alts = []
            for count in range(lo, hi + 1):
                seq: list = _lit_elems("[") + [(REF, "ws")]
                for i in range(count):
                    if i:
                        seq += sep
                    seq += one
                seq += [(REF, "ws")] + _lit_elems("]")
                alts.append(seq)
            if not alts:
                alts = [_lit_elems("[") + [(REF, "ws")] + _lit_elems("]")]
            self.rules[rule] = alts
            return rule
        more = self._fresh(f"{name}-more")
        self.rules[more] = [[], sep + one + [(REF, more)]]
        seq = _lit_elems("[") + [(REF, "ws")]
        if lo == 0:
            body = self._fresh(f"{name}-body")
            self.rules[body] = [[], one + [(REF, more)]]
            seq += [(REF, body)]
        else:
            for i in range(lo):
                if i:
                    seq += sep
                seq += one
            seq += [(REF, more)]
        seq += [(REF, "ws")] + _lit_elems("]")
        self.rules[rule] = [seq]
        return rule


def json_schema_to_grammar(schema) -> Grammar:
    """Compile a JSON-Schema (dict or JSON string) to a Grammar whose root
    matches exactly the conforming JSON documents."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    b = _SchemaBuilder(schema)
    top = b.compile(schema, "root")
    b.rules["root"] = [[(REF, top)]]
    return Grammar(b.rules, root="root")


def machine_for(sampling) -> "GrammarMachine | None":
    """Build the constraint machine for a SamplingParams (None if the
    request is unconstrained or plain JSON mode, which keeps the dedicated
    JsonMachine fast path)."""
    if getattr(sampling, "grammar", None):
        g = parse_gbnf(sampling.grammar)
        return GrammarMachine(g, _key=("gbnf", sampling.grammar))
    if getattr(sampling, "regex", None):
        g = regex_to_grammar(sampling.regex)
        return GrammarMachine(g, _key=("regex", sampling.regex))
    if getattr(sampling, "json_schema", None) is not None:
        blob = json.dumps(sampling.json_schema, sort_keys=True)
        g = json_schema_to_grammar(sampling.json_schema)
        return GrammarMachine(g, _key=("schema", blob))
    return None
