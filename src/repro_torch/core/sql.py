"""Minimal SQL subset parser for the AQP query templates (§3, §5.1).

    SELECT F(col | *) FROM table [WHERE expr] [GROUP BY col] [;]

with F in {COUNT, SUM, AVG, MIN, MAX, MEDIAN, VAR}, expr a boolean tree of
``col OP literal`` conditions combined with AND/OR (AND binds tighter) and
parentheses; OP in {=, !=, <>, <, <=, >, >=}; literals are numbers or
single/double-quoted strings.

The parser is domain-agnostic: literals stay raw here; GreedyGD
pre-processing of literals (§5.1) happens in the engine planner where column
metadata lives.
"""
from __future__ import annotations

import dataclasses
import re

AGG_FUNCS = ("COUNT", "SUM", "AVG", "MIN", "MAX", "MEDIAN", "VAR")

_TOKEN_RE = re.compile(
    r"""
        (?P<num>-?\d+\.?\d*(?:[eE][+-]?\d+)?)
      | (?P<str>'[^']*'|"[^"]*")
      | (?P<op><=|>=|!=|<>|=|<|>)
      | (?P<punc>[(),;*])
      | (?P<word>[A-Za-z_][A-Za-z_0-9.]*)
    """,
    re.VERBOSE,
)

_WHITESPACE = " \t\n\r\f\v"


@dataclasses.dataclass
class RawCond:
    col: str
    op: str
    value: object  # float or str


@dataclasses.dataclass
class RawNode:
    kind: str          # "and" | "or"
    children: list


@dataclasses.dataclass
class ParsedQuery:
    func: str          # aggregation function
    agg_col: str       # column name or "*"
    table: str
    where: object      # RawCond | RawNode | None
    group_by: str | None


class SQLError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Literal-stripped shape of a query plus its extracted literal vector.

    ``shape`` is a canonical token string with every literal replaced by
    ``?``; two queries with equal shapes parse to structurally identical
    trees and differ only in the literal values, so a compiled
    ``PlanTemplate`` for one binds the other's literals bit-for-bit.
    ``literals`` holds the stripped values in token order, exactly as the
    parser would have produced them (numbers as float, strings unquoted).
    """

    shape: str
    literals: tuple


def fingerprint_sql(text: str) -> Fingerprint:
    """Tokenize ``text`` into a shape key + literal vector, without parsing.

    Canonicalization is deliberately conservative: whitespace is dropped by
    the tokenizer, a trailing ``;`` is ignored, and the two legal clause
    orders (``WHERE ... GROUP BY c`` vs ``GROUP BY c WHERE ...``) map to
    one shape. Word tokens are kept verbatim (no case folding) — case
    variants get separate templates rather than risking a collision with
    an identifier that shadows a keyword.
    """
    tokens = _tokenize(text)
    if tokens and tokens[-1] == ("punc", ";"):
        tokens = tokens[:-1]
    # Grammar fixes tokens 0..6 as: SELECT f ( col ) FROM table.  When a
    # GROUP BY clause precedes WHERE, swap them so both orders share a
    # shape.  (Malformed inputs just keep their literal token order — they
    # fail identically at parse time either way.)
    if (len(tokens) > 10
            and tokens[7][0] == "word" and tokens[7][1].upper() == "GROUP"
            and tokens[8][0] == "word" and tokens[8][1].upper() == "BY"
            and tokens[9][0] == "word"
            and tokens[10][0] == "word" and tokens[10][1].upper() == "WHERE"):
        tokens = tokens[:7] + tokens[10:] + tokens[7:10]
    parts, literals = [], []
    for kind, val in tokens:
        if kind in ("num", "str"):
            parts.append("?")
            literals.append(val)
        else:
            parts.append(str(val))
    return Fingerprint(" ".join(parts), tuple(literals))


_PARSE_CALLS = 0


def parse_calls() -> int:
    """Total ``parse_sql`` invocations (process-wide, monotonic).

    The ``--plan-smoke`` lane asserts this counter does not move across a
    template-hit burst — the zero-parse guarantee, checked by counting
    rather than timing.
    """
    return _PARSE_CALLS


def _tokenize(text: str):
    # Hot path: fingerprint_sql runs this per submitted query, so the loop
    # avoids per-token remainder slices and groupdict scans — whitespace is
    # skipped char-wise and the matched alternative read off ``lastgroup``
    # (every named group is top-level, so it is always the one that fired).
    tokens, pos, n = [], 0, len(text)
    append = tokens.append
    while pos < n:
        if text[pos] in _WHITESPACE:
            pos += 1
            continue
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SQLError(f"cannot tokenize at: {text[pos:pos+25]!r}")
        pos = m.end()
        kind = m.lastgroup
        val = m.group(m.lastindex)
        if kind == "num":
            append(("num", float(val)))
        elif kind == "str":
            append(("str", val[1:-1]))
        else:
            append((kind, val))
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect_word(self, *words):
        kind, val = self.next()
        if kind != "word" or val.upper() not in words:
            raise SQLError(f"expected {'/'.join(words)}, got {val!r}")
        return val.upper()

    def expect_punc(self, ch):
        kind, val = self.next()
        if kind != "punc" or val != ch:
            raise SQLError(f"expected {ch!r}, got {val!r}")

    # expr := term (OR term)*
    def expr(self):
        children = [self.term()]
        while True:
            kind, val = self.peek()
            if kind == "word" and val.upper() == "OR":
                self.next()
                children.append(self.term())
            else:
                break
        return children[0] if len(children) == 1 else RawNode("or", children)

    # term := factor (AND factor)*
    def term(self):
        children = [self.factor()]
        while True:
            kind, val = self.peek()
            if kind == "word" and val.upper() == "AND":
                self.next()
                children.append(self.factor())
            else:
                break
        return children[0] if len(children) == 1 else RawNode("and", children)

    def factor(self):
        kind, val = self.peek()
        if kind == "punc" and val == "(":
            self.next()
            node = self.expr()
            self.expect_punc(")")
            return node
        if kind != "word":
            raise SQLError(f"expected column name, got {val!r}")
        self.next()
        col = val
        okind, op = self.next()
        if okind != "op":
            raise SQLError(f"expected operator after {col!r}, got {op!r}")
        vkind, lit = self.next()
        if vkind not in ("num", "str"):
            raise SQLError(f"expected literal, got {lit!r}")
        return RawCond(col, "!=" if op == "<>" else op, lit)


def parse_sql(text: str) -> ParsedQuery:
    global _PARSE_CALLS
    _PARSE_CALLS += 1
    p = _Parser(_tokenize(text))
    p.expect_word("SELECT")
    kind, func = p.next()
    if kind != "word" or func.upper() not in AGG_FUNCS:
        raise SQLError(f"expected aggregation function, got {func!r}")
    p.expect_punc("(")
    kind, col = p.next()
    if kind == "punc" and col == "*":
        agg_col = "*"
    elif kind == "word":
        agg_col = col
    else:
        raise SQLError(f"expected column or *, got {col!r}")
    p.expect_punc(")")
    p.expect_word("FROM")
    kind, table = p.next()
    if kind != "word":
        raise SQLError(f"expected table name, got {table!r}")

    where = None
    group_by = None
    while True:
        kind, val = p.peek()
        if kind is None or (kind == "punc" and val == ";"):
            break
        if kind == "word" and val.upper() == "WHERE":
            p.next()
            where = p.expr()
        elif kind == "word" and val.upper() == "GROUP":
            p.next()
            p.expect_word("BY")
            gkind, gcol = p.next()
            if gkind != "word":
                raise SQLError(f"expected GROUP BY column, got {gcol!r}")
            group_by = gcol
        else:
            raise SQLError(f"unexpected token {val!r}")
    if agg_col == "*" and func.upper() != "COUNT":
        raise SQLError(f"{func}(*) is only valid for COUNT")
    return ParsedQuery(func.upper(), agg_col, table, where, group_by)
