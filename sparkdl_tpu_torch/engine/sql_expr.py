"""selectExpr / where / sql() expression language: tokenizer + parser.

The port's own copy of ``sparkdl_tpu.engine.sql_expr`` (the port imports
nothing of that package, not even its JAX-free modules); the grammar,
the evaluator and SQL null semantics are the reference's unchanged.

The engine analog of the reference's model-as-SQL-UDF serving surface
(``spark.sql("SELECT my_udf(image) FROM ...")``, SURVEY.md §3.4). Grammar:

    query       := 'SELECT' select_expr (',' select_expr)*
                   'FROM' IDENT ('WHERE' bool_expr)?   -- sql() over a view
    select_expr := '*' | expr ('as' IDENT)?
    expr        := IDENT '(' [expr (',' expr)*] ')'   -- registered UDF call
                 | IDENT                              -- column reference
                 | NUMBER | STRING                    -- literal
    bool_expr   := and_expr ('OR' and_expr)*          -- where()/WHERE
    and_expr    := not_expr ('AND' not_expr)*
    not_expr    := 'NOT' not_expr | '(' bool_expr ')' | cmp
    cmp         := expr (('='|'=='|'!='|'<>'|'<'|'<='|'>'|'>=') expr
                         | 'IS' ('NOT')? 'NULL')

UDF calls nest (``clip(featurize(image))``) and take multiple arguments
(arity-checked against the registration); literals project as constant
columns. Comparisons follow SQL null semantics: any comparison against
NULL is not-true, so the row is filtered out (``IS [NOT] NULL`` tests
nulls explicitly). Deliberately NOT supported (use the DataFrame API):
arithmetic, CASE/CAST, joins, subqueries, UDF calls inside WHERE — the
reference's serving path invoked registered model UDFs over columns with
simple row filters, which this covers.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<number>-?\d+(?:\.\d+)?)
    | (?P<string>'[^']*')
    | (?P<ident>[A-Za-z_]\w*)
    | (?P<op><=|>=|==|!=|<>|=|<|>)
    | (?P<punct>[(),*])
    )""", re.VERBOSE)


@dataclass(frozen=True)
class Column:
    name: str


@dataclass(frozen=True)
class Literal:
    value: Any


@dataclass(frozen=True)
class Call:
    fn: str
    args: Tuple[Any, ...]


@dataclass(frozen=True)
class Star:
    pass


@dataclass(frozen=True)
class Compare:
    op: str
    left: Any
    right: Any


@dataclass(frozen=True)
class BoolOp:
    kind: str  # "and" | "or"
    parts: Tuple[Any, ...]


@dataclass(frozen=True)
class Not:
    node: Any


@dataclass(frozen=True)
class IsNull:
    node: Any
    negated: bool


def _token_spans(text: str) -> List[Tuple[str, str, int, int]]:
    """(kind, value, start, end) tokens — spans let sql() slice the
    original text back out of a parsed query."""
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == m.start():
            rest = text[pos:].strip()
            if not rest:
                break
            raise ValueError(f"Cannot tokenize {text!r} at {rest[:20]!r}")
        pos = m.end()
        for kind in ("number", "string", "ident", "op", "punct"):
            val = m.group(kind)
            if val is not None:
                tokens.append((kind, val, m.start(kind), m.end(kind)))
                break
    return tokens


def tokenize(text: str) -> List[Tuple[str, str]]:
    return [(kind, val) for kind, val, _, _ in _token_spans(text)]


class _Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        self.tokens = tokenize(text)
        self.pos = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise ValueError(f"Unexpected end of expression in {self.text!r}")
        self.pos += 1
        return tok

    def expect(self, value: str) -> None:
        tok = self.next()
        if tok[1] != value:
            raise ValueError(
                f"Expected {value!r}, got {tok[1]!r} in {self.text!r}")

    def parse_select(self) -> Tuple[Union[Column, Literal, Call, Star],
                                    Optional[str]]:
        tok = self.peek()
        if tok == ("punct", "*"):
            self.next()
            self._expect_end()
            return Star(), None
        node = self.parse_expr()
        alias = None
        tok = self.peek()
        if tok is not None and tok[0] == "ident" and tok[1].lower() == "as":
            self.next()
            kind, alias = self.next()
            if kind != "ident":
                raise ValueError(f"Bad alias {alias!r} in {self.text!r}")
        self._expect_end()
        return node, alias

    def _expect_end(self) -> None:
        if self.peek() is not None:
            raise ValueError(
                f"Trailing tokens {self.tokens[self.pos:]} in {self.text!r}")

    def parse_expr(self):
        kind, val = self.next()
        if kind == "number":
            return Literal(float(val) if "." in val else int(val))
        if kind == "string":
            return Literal(val[1:-1])
        if kind == "ident":
            if self.peek() == ("punct", "("):
                self.next()
                args = []
                if self.peek() != ("punct", ")"):
                    args.append(self.parse_expr())
                    while self.peek() == ("punct", ","):
                        self.next()
                        args.append(self.parse_expr())
                self.expect(")")
                return Call(val, tuple(args))
            return Column(val)
        raise ValueError(f"Unexpected token {val!r} in {self.text!r}")

    # -- boolean expressions (where/WHERE) -----------------------------------

    def _peek_kw(self, word: str) -> bool:
        tok = self.peek()
        return (tok is not None and tok[0] == "ident"
                and tok[1].lower() == word)

    def parse_bool(self):
        parts = [self.parse_and()]
        while self._peek_kw("or"):
            self.next()
            parts.append(self.parse_and())
        return parts[0] if len(parts) == 1 else BoolOp("or", tuple(parts))

    def parse_and(self):
        parts = [self.parse_not()]
        while self._peek_kw("and"):
            self.next()
            parts.append(self.parse_not())
        return parts[0] if len(parts) == 1 else BoolOp("and", tuple(parts))

    def parse_not(self):
        if self._peek_kw("not"):
            self.next()
            return Not(self.parse_not())
        if self.peek() == ("punct", "("):
            # grouped boolean — a UDF call's '(' is consumed by parse_expr
            # inside parse_cmp, so a leading '(' here is always a group
            self.next()
            node = self.parse_bool()
            self.expect(")")
            return node
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_expr()
        if isinstance(left, Call):
            raise ValueError(
                f"UDF calls are not supported in WHERE ({self.text!r}); "
                "materialize the column with selectExpr first")
        if self._peek_kw("is"):
            self.next()
            negated = False
            if self._peek_kw("not"):
                self.next()
                negated = True
            tok = self.next()
            if tok[0] != "ident" or tok[1].lower() != "null":
                raise ValueError(f"Expected NULL after IS in {self.text!r}")
            return IsNull(left, negated)
        tok = self.peek()
        if tok is None or tok[0] != "op":
            raise ValueError(
                f"Expected a comparison operator in {self.text!r}, got "
                f"{tok!r}")
        op = self.next()[1]
        right = self.parse_expr()
        if isinstance(right, Call):
            raise ValueError(
                f"UDF calls are not supported in WHERE ({self.text!r}); "
                "materialize the column with selectExpr first")
        return Compare({"==": "=", "<>": "!="}.get(op, op), left, right)


def parse(text: str):
    """Parse one select expression → (node, alias-or-None)."""
    return _Parser(text).parse_select()


def parse_bool(text: str):
    """Parse a where/WHERE boolean expression → AST node."""
    parser = _Parser(text)
    node = parser.parse_bool()
    parser._expect_end()
    return node


def bool_columns(node) -> List[str]:
    """Column names referenced by a boolean AST (sorted, unique)."""
    out = set()

    def walk(n):
        if isinstance(n, Column):
            out.add(n.name)
        elif isinstance(n, Compare):
            walk(n.left)
            walk(n.right)
        elif isinstance(n, BoolOp):
            for p in n.parts:
                walk(p)
        elif isinstance(n, Not):
            walk(n.node)
        elif isinstance(n, IsNull):
            walk(n.node)

    walk(node)
    return sorted(out)


_CMP = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def eval_bool(node, env: Dict[str, Any]) -> Optional[bool]:
    """Evaluate a boolean AST over one row's {column: value}.

    SQL three-valued logic on comparisons: NULL operands make the
    comparison None (not-true). AND/OR short-circuit treating None like
    SQL UNKNOWN (None AND False = False, None OR True = True, else None).
    """
    if isinstance(node, IsNull):
        value = _eval_value(node.node, env)
        return (value is not None) if node.negated else (value is None)
    if isinstance(node, Not):
        inner = eval_bool(node.node, env)
        return None if inner is None else not inner
    if isinstance(node, BoolOp):
        # Genuinely short-circuit: stop at the first deciding operand
        # (False for AND, True for OR) without evaluating the rest — SQL
        # UNKNOWN (None) cannot flip a decided AND/OR, so skipping the
        # remaining operands is semantics-preserving and a per-row win.
        saw_unknown = False
        if node.kind == "and":
            for p in node.parts:
                v = eval_bool(p, env)
                if v is False:
                    return False
                if v is None:
                    saw_unknown = True
            return None if saw_unknown else True
        for p in node.parts:
            v = eval_bool(p, env)
            if v is True:
                return True
            if v is None:
                saw_unknown = True
        return None if saw_unknown else False
    if isinstance(node, Compare):
        left = _eval_value(node.left, env)
        right = _eval_value(node.right, env)
        if left is None or right is None:
            return None
        return bool(_CMP[node.op](left, right))
    raise ValueError(f"Cannot evaluate {node!r} as a boolean")


def _eval_value(node, env: Dict[str, Any]):
    if isinstance(node, Column):
        return env[node.name]
    if isinstance(node, Literal):
        return node.value
    raise ValueError(f"Cannot evaluate {node!r} in WHERE")


def split_query(text: str) -> Dict[str, Any]:
    """Split ``SELECT ... FROM view [WHERE ...]`` into its parts.

    Returns {"select": [expr_text, ...], "view": name,
    "where": text-or-None}; expression texts slice out of the original
    query (spans), so selectExpr/parse_bool re-parse them unchanged.
    Keywords match case-insensitively at paren depth 0 only — a UDF
    named ``from_x(...)`` or a quoted 'where' never splits the query.
    """
    toks = _token_spans(text)
    if not toks or toks[0][0] != "ident" or toks[0][1].lower() != "select":
        raise ValueError(f"sql() query must start with SELECT: {text!r}")
    depth = 0
    from_i = where_i = None
    commas: List[int] = []
    for i, (kind, val, _s, _e) in enumerate(toks):
        if kind == "punct" and val == "(":
            depth += 1
        elif kind == "punct" and val == ")":
            depth -= 1
        elif depth == 0 and kind == "ident":
            word = val.lower()
            if word == "from" and from_i is None:
                from_i = i
            elif word == "where" and from_i is not None and where_i is None:
                where_i = i
        elif depth == 0 and kind == "punct" and val == "," and from_i is None:
            commas.append(i)
    if from_i is None:
        raise ValueError(f"sql() query needs FROM <view>: {text!r}")
    view_at = from_i + 1
    if view_at >= len(toks) or toks[view_at][0] != "ident":
        raise ValueError(f"FROM must name a view in {text!r}")
    view = toks[view_at][1]
    after_view = view_at + 1
    expected_next = where_i if where_i is not None else len(toks)
    if after_view != expected_next:
        raise ValueError(
            f"Unexpected tokens after FROM {view} in {text!r} (joins/"
            "aliases are not supported)")
    # select list: token spans between SELECT and FROM, split on commas
    bounds = [toks[0][3]] + [toks[i][2] for i in commas] \
        + [toks[from_i][2]]
    starts = [toks[0][3]] + [toks[i][3] for i in commas]
    select = [text[s:e].strip() for s, e in zip(starts, bounds[1:])]
    if not all(select):
        raise ValueError(f"Empty select expression in {text!r}")
    where = None
    if where_i is not None:
        if where_i + 1 >= len(toks):
            raise ValueError(f"WHERE needs a condition in {text!r}")
        where = text[toks[where_i][3]:].strip()
    return {"select": select, "view": view, "where": where}


def default_name(text: str) -> str:
    """Output column name for an unaliased expression: the trimmed text
    (Spark's convention for expression columns)."""
    return " ".join(text.split())
