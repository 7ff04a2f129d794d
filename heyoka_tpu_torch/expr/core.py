"""Expression AST core (a copy of ``heyoka_tpu.expr.core``; pure Python, so
the port runs where JAX is not installed — tests/test_torch_frontend.py holds
the two against each other).

Reference parity: heyoka ``expression`` = variant<number, variable, func, param>
(``include/heyoka/expression.hpp:73-117``), ``make_vars``
(``expression.hpp:540-549``), operator overloads with constant folding and
normalization into n-ary sums/products (``src/expression_ops.cpp``), traversal
utilities with pointer-identity caches for shared subtrees
(``src/detail/ex_traversal.cpp``).

Design notes (TPU-first, not a translation):

- Nodes are immutable Python objects with a structural hash cached per node.
  Equality short-circuits on object identity, so hash-consed/shared DAGs
  compare fast.
- ``+``/``*`` normalize into flat n-ary ``sum``/``prod`` nodes with numeric
  folding; ``-`` and ``/`` lower to ``sum``/``prod``+``neg``/``div``.  The
  decomposition layer (see ``decompose.py``) consumes these directly — an
  n-ary sum is a single tape op (XLA has no arity-8 constraint, unlike
  heyoka's compact-mode codegen which splits sums, ``expression.hpp:593-597``).
- All traversals are iterative (explicit stacks) with ``id()``-keyed memo
  tables, mirroring the reference's ``void_ptr_map`` discipline so that big
  shared DAGs stay linear-time and never hit Python's recursion limit.
"""

from __future__ import annotations

import math as _pymath
from typing import Callable, Iterable, Mapping


class Expr:
    """Base class of all expression nodes."""

    __slots__ = ("_hash", "__weakref__")

    # -- arithmetic operator overloads (constant folding in _sum/_prod) ------
    def __add__(self, other):
        return _sum2(self, _coerce(other))

    def __radd__(self, other):
        return _sum2(_coerce(other), self)

    def __sub__(self, other):
        return _sum2(self, -_coerce(other))

    def __rsub__(self, other):
        return _sum2(_coerce(other), -self)

    def __mul__(self, other):
        return _prod2(self, _coerce(other))

    def __rmul__(self, other):
        return _prod2(_coerce(other), self)

    def __truediv__(self, other):
        return _div(self, _coerce(other))

    def __rtruediv__(self, other):
        return _div(_coerce(other), self)

    def __pow__(self, other):
        return _pow(self, _coerce(other))

    def __rpow__(self, other):
        return _pow(_coerce(other), self)

    def __neg__(self):
        return _neg(self)

    def __pos__(self):
        return self

    def __hash__(self):
        h = self._hash
        if h is None:
            h = _compute_hash(self)
        return h

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Expr):
            return NotImplemented
        return _structural_eq(self, other)

    def __ne__(self, other):
        r = self.__eq__(other)
        if r is NotImplemented:
            return r
        return not r

    # children; leaf nodes override with ()
    @property
    def args(self) -> tuple:
        return ()

    def __repr__(self):
        return to_string(self)


class Number(Expr):
    """A numeric literal (IEEE binary64 payload).

    Reference: heyoka ``number`` (``include/heyoka/number.hpp:46``).  The
    reference supports float/double/long double/real128/real literals; on TPU
    the working precisions are f32/f64 (+ double-double downstream), so a
    float64 payload is exact for every supported working dtype.
    """

    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = float(value)
        self._hash = None

    def _key(self):
        # distinguish -0.0 / 0.0 and NaNs deterministically
        v = self.value
        return ("num", _pymath.copysign(1.0, v), v if v == v else "nan")


class Variable(Expr):
    """A named state variable (heyoka ``variable``, ``src/variable.cpp``)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        if not isinstance(name, str) or not name:
            raise ValueError("variable name must be a non-empty string")
        self.name = name
        self._hash = None

    def _key(self):
        return ("var", self.name)


class Param(Expr):
    """A runtime parameter placeholder ``par[i]``.

    Reference: heyoka ``param`` (``include/heyoka/param.hpp``,
    ``expression.hpp:571-579``).  Parameters are bound at evaluation time from
    a flat parameter array.
    """

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        idx = int(idx)
        if idx < 0:
            raise ValueError("param index must be non-negative")
        self.idx = idx
        self._hash = None

    def _key(self):
        return ("par", self.idx)


class TimeExpr(Expr):
    """The independent variable t (heyoka ``heyoka::time``, ``src/math/time.cpp``)."""

    __slots__ = ()

    def __init__(self):
        self._hash = None

    def _key(self):
        return ("time",)


class Func(Expr):
    """An n-ary function node.

    Reference: heyoka ``func`` (``include/heyoka/func.hpp:314-394``).  Instead
    of type-erased C++ objects, ops are identified by name and resolved in the
    op registry (``registry.py``), which supplies numeric evaluation, symbolic
    gradient, and Taylor-recurrence rules — the UDF extension protocol of
    ``func.hpp:116-284`` as a rule table.
    """

    __slots__ = ("op", "fargs")

    def __init__(self, op: str, fargs: tuple):
        self.op = op
        self.fargs = tuple(fargs)
        self._hash = None
        assert all(isinstance(a, Expr) for a in self.fargs)

    @property
    def args(self) -> tuple:
        return self.fargs

    def _key(self):
        return ("func", self.op, len(self.fargs))


_TIME_SINGLETON = TimeExpr()

ZERO = Number(0.0)
ONE = Number(1.0)
MINUS_ONE = Number(-1.0)


# ---------------------------------------------------------------------------
# iterative traversal helpers
# ---------------------------------------------------------------------------

def postorder(e: Expr):
    """Iterative post-order traversal over the DAG, visiting each distinct
    node (by identity) exactly once."""
    seen = set()
    stack = [(e, False)]
    while stack:
        node, expanded = stack.pop()
        nid = id(node)
        if expanded:
            yield node
            continue
        if nid in seen:
            continue
        seen.add(nid)
        stack.append((node, True))
        for c in node.args:
            if id(c) not in seen:
                stack.append((c, False))


def _compute_hash(e: Expr) -> int:
    """Compute (and cache) structural hashes bottom-up, iteratively.

    The JAX package's values (``hash((key, child hashes))``), but the walk
    stops at a node whose hash is cached: a node built over hashed
    children (every node ``subs`` and ``diff`` make) costs its own hash,
    not a walk of its whole subtree."""
    stack = [(e, False)]
    while stack:
        node, expanded = stack.pop()
        if node._hash is not None:
            continue
        if expanded:
            node._hash = hash((node._key(),
                               tuple(c._hash for c in node.args)))
            continue
        stack.append((node, True))
        stack.extend((c, False) for c in node.args if c._hash is None)
    return e._hash


def _structural_eq(a: Expr, b: Expr) -> bool:
    """Iterative structural equality with identity short-circuit."""
    if hash(a) != hash(b):
        return False
    stack = [(a, b)]
    # identity-pair memo avoids exponential blowup on shared DAGs
    done: set[tuple[int, int]] = set()
    while stack:
        x, y = stack.pop()
        if x is y:
            continue
        pid = (id(x), id(y))
        if pid in done:
            continue
        done.add(pid)
        if x._key() != y._key():
            return False
        xa, ya = x.args, y.args
        if len(xa) != len(ya):
            return False
        stack.extend(zip(xa, ya))
    return True


def map_expr(e: Expr, fn: Callable[[Expr, tuple], Expr | None]) -> Expr:
    """Rebuild an expression bottom-up.

    ``fn(node, new_args)`` returns a replacement node or ``None`` to rebuild
    the node with ``new_args`` (reusing the original object when unchanged).
    Shared subtrees are transformed once (id-keyed cache), preserving DAG
    sharing — the analog of the reference's traversal caches
    (``src/detail/ex_traversal.cpp``).
    """
    memo: dict[int, Expr] = {}
    for node in postorder(e):
        new_args = tuple(memo[id(c)] for c in node.args)
        out = fn(node, new_args)
        if out is None:
            if new_args == node.args:
                out = node
            else:
                assert isinstance(node, Func)
                out = Func(node.op, new_args)
        memo[id(node)] = out
    return memo[id(e)]


# ---------------------------------------------------------------------------
# public constructors / queries
# ---------------------------------------------------------------------------

def _coerce(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Number(float(x))
    # numpy scalars
    try:
        return Number(float(x))
    except (TypeError, ValueError):
        return NotImplemented  # type: ignore[return-value]


def expr(x) -> Expr:
    """Coerce a Python scalar or Expr into an Expr."""
    e = _coerce(x)
    if e is NotImplemented:
        raise TypeError(f"cannot coerce {type(x)!r} to Expr")
    return e


def make_vars(*names: str):
    """Create symbolic variables (heyoka ``make_vars``, ``expression.hpp:540-549``)."""
    if len(names) == 0:
        raise ValueError("make_vars requires at least one name")
    vs = tuple(Variable(n) for n in names)
    return vs[0] if len(vs) == 1 else vs


class _ParFactory:
    """``par[i]`` sugar (heyoka ``heyoka::par``, ``expression.hpp:571-579``)."""

    def __getitem__(self, idx: int) -> Param:
        return Param(idx)


par = _ParFactory()
time = _TIME_SINGLETON


def get_variables(e: Expr | Iterable[Expr]) -> list[str]:
    """Sorted list of variable names (heyoka ``get_variables``, ``expression.hpp:369``)."""
    out: set[str] = set()
    for ex in _as_iter(e):
        for node in postorder(ex):
            if isinstance(node, Variable):
                out.add(node.name)
    return sorted(out)


def get_params(e: Expr | Iterable[Expr]) -> list[int]:
    """Sorted list of param indices appearing in e (heyoka ``get_params``)."""
    out: set[int] = set()
    for ex in _as_iter(e):
        for node in postorder(ex):
            if isinstance(node, Param):
                out.add(node.idx)
    return sorted(out)


def is_time_dependent(e: Expr | Iterable[Expr]) -> bool:
    """Whether e contains the independent variable (heyoka ``is_time_dependent``)."""
    for ex in _as_iter(e):
        for node in postorder(ex):
            if isinstance(node, TimeExpr):
                return True
    return False


def _as_iter(e):
    if isinstance(e, Expr):
        return (e,)
    return e


def subs(e: Expr, smap: Mapping) -> Expr:
    """Substitute subexpressions (heyoka ``subs``, ``expression.hpp:211-224``).

    Keys may be Variables, variable-name strings, Params, or arbitrary Exprs;
    matching is structural.
    """
    norm: dict[Expr, Expr] = {}
    for k, v in smap.items():
        if isinstance(k, str):
            k = Variable(k)
        norm[k] = expr(v)

    def visit(node: Expr, new_args: tuple) -> Expr | None:
        if new_args == node.args:
            cand = node
        elif isinstance(node, Func):
            cand = Func(node.op, new_args)
        else:  # pragma: no cover - leaves have no args
            cand = node
        hit = norm.get(cand)
        return hit if hit is not None else cand

    return map_expr(e, visit)


def rename_variables(e: Expr, rmap: Mapping[str, str]) -> Expr:
    """Rename variables (heyoka ``rename_variables``, ``expression.hpp:374``)."""
    return subs(e, {k: Variable(v) for k, v in rmap.items()})


# ---------------------------------------------------------------------------
# operator normalization (constant folding; flat n-ary sum/prod)
# Reference behavior: src/expression_ops.cpp
# ---------------------------------------------------------------------------

def sum_expr(terms: Iterable) -> Expr:
    """n-ary sum with flattening + numeric folding (heyoka ``sum()``,
    ``src/math/sum.cpp``)."""
    flat: list[Expr] = []
    const = 0.0
    for t in terms:
        t = expr(t)
        if isinstance(t, Number):
            const += t.value
        elif isinstance(t, Func) and t.op == "sum":
            for s in t.fargs:
                if isinstance(s, Number):
                    const += s.value
                else:
                    flat.append(s)
        else:
            flat.append(t)
    if const != 0.0 or not flat:
        flat.append(Number(const))
    if len(flat) == 1:
        return flat[0]
    return Func("sum", tuple(flat))


def prod_expr(factors: Iterable) -> Expr:
    """n-ary product with flattening + numeric folding (heyoka ``prod()``,
    ``src/math/prod.cpp``)."""
    flat: list[Expr] = []
    const = 1.0
    for f in factors:
        f = expr(f)
        if isinstance(f, Number):
            const *= f.value
        elif isinstance(f, Func) and f.op == "prod":
            for s in f.fargs:
                if isinstance(s, Number):
                    const *= s.value
                else:
                    flat.append(s)
        else:
            flat.append(f)
    if const == 0.0:
        # NOTE: folds 0 * x -> 0 like the reference's operator* const folding.
        return Number(const)
    if const != 1.0 or not flat:
        flat.insert(0, Number(const))
    if len(flat) == 1:
        return flat[0]
    return Func("prod", tuple(flat))


def _sum2(a, b) -> Expr:
    if a is NotImplemented or b is NotImplemented:
        return NotImplemented  # type: ignore[return-value]
    return sum_expr((a, b))


def _prod2(a, b) -> Expr:
    if a is NotImplemented or b is NotImplemented:
        return NotImplemented  # type: ignore[return-value]
    return prod_expr((a, b))


def _neg(a: Expr) -> Expr:
    if isinstance(a, Number):
        return Number(-a.value)
    return prod_expr((MINUS_ONE, a))


def _div(a, b) -> Expr:
    if a is NotImplemented or b is NotImplemented:
        return NotImplemented  # type: ignore[return-value]
    if isinstance(a, Number) and isinstance(b, Number):
        return Number(a.value / b.value)
    if isinstance(b, Number):
        if b.value == 1.0:
            return a
        return prod_expr((Number(1.0 / b.value), a))
    # keep a dedicated binary div node: it has a cheap direct Taylor
    # recurrence (better than prod(a, pow(b,-1)) numerically and in op count)
    if isinstance(a, Number) and a.value == 1.0:
        return Func("div", (ONE, b))
    return Func("div", (a, b))


def _pow(a, b) -> Expr:
    if a is NotImplemented or b is NotImplemented:
        return NotImplemented  # type: ignore[return-value]
    if isinstance(b, Number):
        ev = b.value
        if isinstance(a, Number):
            # fold only when the result is real: a negative base with a
            # non-integer exponent evaluates to nan numerically (a real power),
            # and the fold must agree with that rather than go complex
            try:
                folded = a.value ** ev
            except (OverflowError, ZeroDivisionError):
                folded = _pymath.nan
            if isinstance(folded, complex):
                folded = _pymath.nan
            return Number(folded)
        if ev == 0.0:
            return ONE
        if ev == 1.0:
            return a
        if ev == 2.0:
            # square: a single binary-product tape op beats the pow recurrence
            return prod_expr((a, a))
        return Func("pow", (a, b))
    # non-constant exponent: a**b = exp(b*log(a))  (heyoka rewrites general
    # pow via exp/log as well, taylor_01.cpp:806 / expression pow impl)
    return Func("exp", (prod_expr((b, Func("log", (a,)))),))


# ---------------------------------------------------------------------------
# pretty printing
# ---------------------------------------------------------------------------

def to_string(e: Expr) -> str:
    parts: dict[int, str] = {}
    for node in postorder(e):
        if isinstance(node, Number):
            v = node.value
            s = repr(v) if v >= 0 or v != v else f"({v!r})"
        elif isinstance(node, Variable):
            s = node.name
        elif isinstance(node, Param):
            s = f"par[{node.idx}]"
        elif isinstance(node, TimeExpr):
            s = "t"
        else:
            assert isinstance(node, Func)
            argl = [parts[id(c)] for c in node.fargs]
            if node.op == "sum":
                s = "(" + " + ".join(argl) + ")"
            elif node.op == "prod":
                s = "(" + " * ".join(argl) + ")"
            elif node.op == "div":
                s = f"({argl[0]} / {argl[1]})"
            elif node.op == "pow":
                s = f"({argl[0]}**{argl[1]})"
            else:
                s = f"{node.op}({', '.join(argl)})"
        parts[id(node)] = s
    return parts[id(e)]
