"""Byte-level regex → DFA compiler for constrained decoding.

Self-contained regex engine (the environment has no `interegular`/
`outlines`): parses a practical regex subset into an NFA (Thompson
construction) and determinizes it into a dense DFA transition table
``trans[n_states, 256]`` over BYTES, which is what the token-level mask
machinery (tokenmap.py) consumes. State 0 is the dead state (absorbing),
state 1 is the start state.

Supported syntax: literals (UTF-8, matched byte-wise), ``.`` (any byte of
a UTF-8 char except newline), char classes ``[a-z^]`` with ranges and
negation, escapes ``\\d \\w \\s \\D \\W \\S \\n \\r \\t \\\\ \\. ...``,
groups ``(...)`` (non-capturing — no backrefs), alternation ``|``,
quantifiers ``* + ? {m} {m,} {m,n}`` (greedy/lazy are equivalent for
recognition). Anchors are implicit: the whole string must match.

A copy of scalellm_tpu/constrained/fsm.py (vLLM/outlines-style guided
generation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Set, Tuple

import numpy as np

DEAD = 0
START = 1


# --------------------------------------------------------------- NFA pieces


class _Nfa:
    """NFA under construction: states are ints; transitions are byte-set
    labelled edges plus epsilon edges."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[np.ndarray, int]]] = []  # (byteset[256] bool, dst)

    def new_state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def add_edge(self, src: int, byteset: np.ndarray, dst: int) -> None:
        self.edges[src].append((byteset, dst))

    def add_eps(self, src: int, dst: int) -> None:
        self.eps[src].add(dst)


@dataclass
class _Frag:
    start: int
    end: int  # single accept state per fragment


class _Parser:
    """Recursive-descent regex parser building NFA fragments."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def _peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def _eat(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # alternation := concat ('|' concat)*
    def parse_alternation(self) -> _Frag:
        frags = [self.parse_concat()]
        while self._peek() == "|":
            self._eat()
            frags.append(self.parse_concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.new_state(), self.nfa.new_state()
        for f in frags:
            self.nfa.add_eps(s, f.start)
            self.nfa.add_eps(f.end, e)
        return _Frag(s, e)

    def parse_concat(self) -> _Frag:
        frags: List[_Frag] = []
        while self._peek() not in ("", "|", ")"):
            frags.append(self.parse_quantified())
        if not frags:
            s = self.nfa.new_state()
            return _Frag(s, s)
        for a, b in zip(frags, frags[1:]):
            self.nfa.add_eps(a.end, b.start)
        return _Frag(frags[0].start, frags[-1].end)

    def parse_quantified(self) -> _Frag:
        atom_start = self.i
        frag = self.parse_atom()
        c = self._peek()
        if c == "*":
            self._eat()
            self._skip_lazy()
            return self._star(frag)
        if c == "+":
            self._eat()
            self._skip_lazy()
            second = self._copy_atom(atom_start)
            rep = self._star(second)
            self.nfa.add_eps(frag.end, rep.start)
            return _Frag(frag.start, rep.end)
        if c == "?":
            self._eat()
            self._skip_lazy()
            self.nfa.add_eps(frag.start, frag.end)
            return frag
        if c == "{":
            save = self.i
            self._eat()
            digits = ""
            while self._peek().isdigit():
                digits += self._eat()
            if self._peek() == "}" and digits:
                self._eat()
                return self._repeat(atom_start, frag, int(digits), int(digits))
            if self._peek() == ",":
                self._eat()
                digits2 = ""
                while self._peek().isdigit():
                    digits2 += self._eat()
                if self._peek() == "}" and digits:
                    self._eat()
                    self._skip_lazy()
                    hi = int(digits2) if digits2 else None
                    return self._repeat(atom_start, frag, int(digits), hi)
            # not a quantifier — treat '{' as literal (already consumed atom)
            self.i = save
        return frag

    def _skip_lazy(self) -> None:
        if self._peek() == "?":  # lazy quantifier: same language
            self._eat()

    def _copy_atom(self, atom_start: int) -> _Frag:
        """Re-parse the atom at `atom_start` to get a fresh fragment."""
        save = self.i
        self.i = atom_start
        frag = self.parse_atom()
        self.i = save
        return frag

    def _star(self, frag: _Frag) -> _Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_eps(s, frag.start)
        self.nfa.add_eps(s, e)
        self.nfa.add_eps(frag.end, frag.start)
        self.nfa.add_eps(frag.end, e)
        return _Frag(s, e)

    def _repeat(self, atom_start: int, first: _Frag, lo: int, hi) -> _Frag:
        """{lo,hi} by unrolling (hi=None → lo copies + star)."""
        s = self.nfa.new_state()
        cur = s
        # mandatory copies
        copies = [first] + [self._copy_atom(atom_start) for _ in range(max(lo - 1, 0))]
        if lo == 0:
            copies = []
        for f in copies:
            self.nfa.add_eps(cur, f.start)
            cur = f.end
        e = self.nfa.new_state()
        if hi is None:
            star = self._star(self._copy_atom(atom_start))
            self.nfa.add_eps(cur, star.start)
            self.nfa.add_eps(star.end, e)
        else:
            if hi < lo:
                raise ValueError(f"bad repeat {{{lo},{hi}}}")
            self.nfa.add_eps(cur, e)  # may stop after lo
            for _ in range(hi - lo):
                f = self._copy_atom(atom_start)
                self.nfa.add_eps(cur, f.start)
                cur = f.end
                self.nfa.add_eps(cur, e)
        return _Frag(s, e)

    def parse_atom(self) -> _Frag:
        c = self._eat()
        if c == "(":
            if self._peek() == "?":  # (?: non-capturing / flags — skip
                self._eat()
                if self._peek() == ":":
                    self._eat()
                else:
                    raise ValueError("unsupported (?...) group")
            frag = self.parse_alternation()
            if self._peek() != ")":
                raise ValueError("unbalanced parenthesis")
            self._eat()
            return frag
        if c == "[":
            return self._byteset_frag(self._parse_class())
        if c == ".":
            bs = np.ones(256, dtype=bool)
            bs[ord("\n")] = False
            return self._byteset_frag(bs)
        if c == "\\":
            return self._escape_frag(self._eat())
        if c in ")|":
            raise ValueError(f"unexpected {c!r}")
        return self._literal_frag(c)

    # ---- helpers building fragments

    def _byteset_frag(self, byteset: np.ndarray) -> _Frag:
        s, e = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.add_edge(s, byteset, e)
        return _Frag(s, e)

    def _literal_frag(self, ch: str) -> _Frag:
        bts = ch.encode("utf-8")
        s = self.nfa.new_state()
        cur = s
        for b in bts:
            nxt = self.nfa.new_state()
            bs = np.zeros(256, dtype=bool)
            bs[b] = True
            self.nfa.add_edge(cur, bs, nxt)
            cur = nxt
        return _Frag(s, cur)

    def _escape_frag(self, c: str) -> _Frag:
        bs = _escape_set(c)
        if bs is not None:
            return self._byteset_frag(bs)
        if c == "x":
            return self._literal_frag(chr(self._hex2()))
        return self._literal_frag(_escape_char(c))

    def _hex2(self) -> int:
        h = self._eat() + self._eat()
        return int(h, 16)

    def _parse_class(self) -> np.ndarray:
        negate = False
        if self._peek() == "^":
            self._eat()
            negate = True
        bs = np.zeros(256, dtype=bool)
        first = True
        while True:
            c = self._peek()
            if c == "":
                raise ValueError("unterminated character class")
            if c == "]" and not first:
                self._eat()
                break
            first = False
            self._eat()
            if c == "\\":
                e = self._eat()
                es = _escape_set(e)
                if es is not None:
                    bs |= es
                    continue
                c = chr(self._hex2()) if e == "x" else _escape_char(e)
            if self._peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self._eat()
                hi = self._eat()
                if hi == "\\":
                    h = self._eat()
                    hi = chr(self._hex2()) if h == "x" else _escape_char(h)
                lo_b, hi_b = c.encode("utf-8"), hi.encode("utf-8")
                if len(lo_b) == 1 and len(hi_b) == 1:
                    bs[lo_b[0] : hi_b[0] + 1] = True
                else:
                    raise ValueError("non-ASCII class ranges unsupported")
            else:
                cb = c.encode("utf-8")
                if len(cb) == 1:
                    bs[cb[0]] = True
                else:
                    # multi-byte literal in a class: allow its bytes as a set
                    # (approximation: accepts byte permutations — acceptable
                    # for masks, conservative users should use alternation)
                    for b in cb:
                        bs[b] = True
        if negate:
            bs = ~bs
        return bs


def _escape_set(c: str):
    if c == "d":
        bs = np.zeros(256, dtype=bool)
        bs[ord("0") : ord("9") + 1] = True
        return bs
    if c == "D":
        return ~_escape_set("d")
    if c == "w":
        bs = np.zeros(256, dtype=bool)
        bs[ord("a") : ord("z") + 1] = True
        bs[ord("A") : ord("Z") + 1] = True
        bs[ord("0") : ord("9") + 1] = True
        bs[ord("_")] = True
        return bs
    if c == "W":
        return ~_escape_set("w")
    if c == "s":
        bs = np.zeros(256, dtype=bool)
        for ch in " \t\n\r\f\v":
            bs[ord(ch)] = True
        return bs
    if c == "S":
        return ~_escape_set("s")
    return None


def _escape_char(c: str) -> str:
    return {"n": "\n", "r": "\r", "t": "\t", "f": "\f", "v": "\v", "0": "\0"}.get(c, c)


# --------------------------------------------------------------------- DFA


@dataclass
class Dfa:
    """Dense byte-level DFA. trans[s, b] -> next state (0 = dead, absorbing);
    accepting[s] -> bool. Start state = 1."""

    trans: np.ndarray  # [n_states, 256] int32
    accepting: np.ndarray  # [n_states] bool

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def walk(self, s: int, data: bytes) -> int:
        for b in data:
            s = int(self.trans[s, b])
            if s == DEAD:
                return DEAD
        return s


def compile_regex(pattern: str, max_states: int = 50_000) -> Dfa:
    """Compile a regex (full-match semantics) to a dense byte DFA."""
    nfa = _Nfa()
    parser = _Parser(pattern, nfa)
    frag = parser.parse_alternation()
    if parser.i != len(pattern):
        raise ValueError(f"trailing regex input at {parser.i}: {pattern!r}")

    # epsilon-closure via iterative DFS, cached per state set
    n = len(nfa.eps)
    eps_clo: List[FrozenSet[int]] = []
    for s in range(n):
        seen = {s}
        stack = [s]
        while stack:
            u = stack.pop()
            for v in nfa.eps[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        eps_clo.append(frozenset(seen))

    def closure(states) -> FrozenSet[int]:
        out: Set[int] = set()
        for s in states:
            out |= eps_clo[s]
        return frozenset(out)

    start = closure({frag.start})
    accept_nfa = frag.end

    # subset construction
    state_ids: Dict[FrozenSet[int], int] = {frozenset(): DEAD, start: START}
    order: List[FrozenSet[int]] = [frozenset(), start]
    trans_rows: List[np.ndarray] = [np.zeros(256, dtype=np.int32)]  # dead row
    i = 1
    while i < len(order):
        cur = order[i]
        row = np.zeros(256, dtype=np.int32)
        # gather outgoing edges: for each byte, union of dsts
        # vectorized: stack bytesets of all edges from cur's members
        edges = [(bs, dst) for s in cur for (bs, dst) in nfa.edges[s]]
        if edges:
            bsets = np.stack([bs for bs, _ in edges])  # [E, 256]
            dsts = [dst for _, dst in edges]
            # group identical destination-sets per byte
            for b in range(256):
                active = np.nonzero(bsets[:, b])[0]
                if active.size == 0:
                    continue
                tgt = closure({dsts[k] for k in active})
                sid = state_ids.get(tgt)
                if sid is None:
                    sid = len(order)
                    if sid > max_states:
                        raise ValueError("regex too large (DFA state explosion)")
                    state_ids[tgt] = sid
                    order.append(tgt)
                row[b] = sid
        trans_rows.append(row)
        i += 1

    trans = np.stack(trans_rows)
    accepting = np.zeros(len(order), dtype=bool)
    for sset, sid in state_ids.items():
        if accept_nfa in sset:
            accepting[sid] = True
    return _trim(Dfa(trans=trans, accepting=accepting))


def _trim(dfa: Dfa) -> Dfa:
    """Redirect transitions into non-co-accessible states (no path to any
    accepting state) to DEAD, so a masked generation can never paint itself
    into a corner: every live state always has a continuation that accepts."""
    n = dfa.n_states
    # reverse reachability from accepting states
    live = dfa.accepting.copy()
    live[DEAD] = False
    changed = True
    while changed:
        # state s is live if any transition goes to a live state
        succ_live = live[dfa.trans].any(axis=1)  # [n]
        new_live = live | succ_live
        new_live[DEAD] = False
        changed = bool((new_live != live).any())
        live = new_live
    if not live[START] and not dfa.accepting[START]:
        raise ValueError("regex matches nothing")
    trans = np.where(live[dfa.trans], dfa.trans, DEAD).astype(np.int32)
    return Dfa(trans=trans, accepting=dfa.accepting)


def choice_dfa(choices: List[str]) -> Dfa:
    """DFA accepting exactly the given strings (no regex metachars)."""
    import re as _re

    pattern = "|".join(
        "(?:" + _re.escape(c) + ")" for c in choices
    )
    # our parser doesn't know most re.escape outputs differ; re.escape only
    # backslash-escapes metachars, which _escape_frag handles as literals.
    return compile_regex(pattern)
