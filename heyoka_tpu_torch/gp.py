"""Genetic-programming support: random expression generation + mutation /
crossover operators, copied from ``heyoka_tpu.gp``.

Reference parity: ``expression_generator`` / ``count_nodes`` /
``fetch_from_node_id`` / ``mutate`` / ``crossover``
(``include/heyoka/gp.hpp:24-66``).  Since our expressions are immutable,
the mutation/crossover operators return new expressions instead of mutating
in place (the only delta; semantics otherwise match).
"""

from __future__ import annotations

import numpy as np

from .expr import math as hm
from .expr.core import Expr, Func, Number, Variable, expr

__all__ = [
    "ExpressionGenerator",
    "count_nodes",
    "fetch_from_node_id",
    "mutate",
    "crossover",
]


def _bo_add(a, b):
    return a + b


def _bo_sub(a, b):
    return a - b


def _bo_mul(a, b):
    return a * b


def _bo_div(a, b):
    return a / b


class ExpressionGenerator:
    """Random expression generator over a set of variables.

    Node types and default weights follow the reference: numbers, variables,
    binary operators (+ - * /), unary functions (sin, cos, log, exp) and
    binary functions (pow).
    """

    def __init__(self, vars, rng=None):
        self._vars = [v if isinstance(v, str) else v.name for v in vars]
        self._rng = np.random.default_rng(rng)
        self._u_funcs = [hm.sin, hm.cos, hm.log, hm.exp]
        self._b_funcs = [lambda a, b: expr(a) ** expr(b)]
        self._bos = [_bo_add, _bo_sub, _bo_mul, _bo_div]
        # weights: [num, var, bo, u_fun, b_fun]
        self._weights = [1.0, 1.0, 1.0, 1.0, 1.0]
        self._range_dbl = 10.0

    # -- getters / setters (gp.hpp:42-54) -------------------------------------

    @property
    def vars(self):
        return list(self._vars)

    @vars.setter
    def vars(self, v):
        self._vars = [x if isinstance(x, str) else x.name for x in v]

    @property
    def u_funcs(self):
        return list(self._u_funcs)

    @u_funcs.setter
    def u_funcs(self, fs):
        self._u_funcs = list(fs)

    @property
    def b_funcs(self):
        return list(self._b_funcs)

    @b_funcs.setter
    def b_funcs(self, fs):
        self._b_funcs = list(fs)

    @property
    def weights(self):
        return list(self._weights)

    @weights.setter
    def weights(self, w):
        if len(w) != 5:
            raise ValueError("weights must have 5 entries (num/var/bo/u/b)")
        self._weights = [float(x) for x in w]

    @property
    def range_dbl(self) -> float:
        return self._range_dbl

    @range_dbl.setter
    def range_dbl(self, r):
        self._range_dbl = float(r)

    # -- generation -----------------------------------------------------------

    def __call__(self, min_depth: int, max_depth: int, depth: int = 0) -> Expr:
        """Generate a random expression with depth in [min_depth, max_depth]."""
        w = np.array(self._weights, dtype=float)
        if depth < min_depth:
            # no leaves above the minimum depth
            w = w.copy()
            w[0] = 0.0 if self._vars else w[0]
            w[1] = w[1] if self._vars else 0.0
            w[0] = 0.0
            if not self._vars:
                w[1] = 0.0
        if depth >= max_depth:
            # leaves only
            w = w.copy()
            w[2] = w[3] = w[4] = 0.0
        if not self._u_funcs:
            w[3] = 0.0
        if not self._b_funcs:
            w[4] = 0.0
        total = w.sum()
        if total <= 0:
            kind = 0
        else:
            kind = int(self._rng.choice(5, p=w / total))
        if kind == 0 or (kind == 1 and not self._vars):
            return Number(float(self._rng.uniform(-self._range_dbl, self._range_dbl)))
        if kind == 1:
            return Variable(str(self._rng.choice(self._vars)))
        if kind == 2:
            bo = self._bos[int(self._rng.integers(len(self._bos)))]
            return bo(
                self(min_depth, max_depth, depth + 1),
                self(min_depth, max_depth, depth + 1),
            )
        if kind == 3:
            f = self._u_funcs[int(self._rng.integers(len(self._u_funcs)))]
            return f(self(min_depth, max_depth, depth + 1))
        f = self._b_funcs[int(self._rng.integers(len(self._b_funcs)))]
        return f(
            self(min_depth, max_depth, depth + 1),
            self(min_depth, max_depth, depth + 1),
        )


def count_nodes(e: Expr) -> int:
    """Total node count, counting shared subtrees once per occurrence
    (heyoka ``count_nodes``)."""
    e = expr(e)
    n = 1
    for a in e.args:
        n += count_nodes(a)
    return n


def fetch_from_node_id(e: Expr, node_id: int) -> Expr | None:
    """Node at pre-order position ``node_id`` (heyoka ``fetch_from_node_id``)."""

    def walk(node, i):
        if i == 0:
            return node, -1
        i -= 1
        for a in node.args:
            r, i = walk(a, i)
            if r is not None:
                return r, -1
        return None, i

    r, _ = walk(expr(e), int(node_id))
    return r


def _replace_node(e: Expr, node_id: int, new: Expr) -> Expr:
    def walk(node, i):
        if i == 0:
            return new, -1
        i -= 1
        if not isinstance(node, Func):
            return node, i
        new_args = []
        changed = False
        for a in node.args:
            r, i = walk(a, i)
            if r is not a:
                changed = True
            new_args.append(r)
        return (Func(node.op, tuple(new_args)) if changed else node), i

    r, _ = walk(expr(e), int(node_id))
    return r


def mutate(e: Expr, gen: ExpressionGenerator, node_id=None, *, rng=None,
           min_depth: int = 1, max_depth: int = 3) -> Expr:
    """Replace a (random or given) node with a freshly generated subtree."""
    e = expr(e)
    n = count_nodes(e)
    if node_id is None:
        node_id = int(np.random.default_rng(rng).integers(n))
    return _replace_node(e, node_id, gen(min_depth, max_depth))


def crossover(a: Expr, b: Expr, node_a=None, node_b=None, *, rng=None):
    """Swap random (or given) subtrees between two expressions; returns the
    new pair."""
    a, b = expr(a), expr(b)
    r = np.random.default_rng(rng)
    if node_a is None:
        node_a = int(r.integers(count_nodes(a)))
    if node_b is None:
        node_b = int(r.integers(count_nodes(b)))
    sub_a = fetch_from_node_id(a, node_a)
    sub_b = fetch_from_node_id(b, node_b)
    return _replace_node(a, node_a, sub_b), _replace_node(b, node_b, sub_a)
