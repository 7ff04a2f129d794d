"""Op registry: the op names, arities and constant-folding rules that
``math`` and ``decompose`` need.

The counterpart of ``heyoka_tpu.expr.registry`` without its jax.numpy
evaluators: their f64 torch counterparts, the numeric rules the Taylor
jets need at order 0, are in the sibling module :mod:`.numeric`.
"""

from __future__ import annotations

import math as _pymath
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True)
class OpDef:
    name: str
    nargs: int | None  # None = variadic
    # constant folding rule over Python floats (None = never fold)
    fold: Optional[Callable] = None


_REGISTRY: dict[str, OpDef] = {}


def register(op: OpDef):
    assert op.name not in _REGISTRY, op.name
    _REGISTRY[op.name] = op


def opdef(name: str) -> OpDef:
    od = _REGISTRY.get(name)
    if od is None:
        raise KeyError(f"unknown op {name!r}")
    return od


def have_op(name: str) -> bool:
    return name in _REGISTRY


# -- elementary arithmetic ---------------------------------------------------

register(OpDef("sum", None, fold=lambda *xs: sum(xs)))
register(OpDef("prod", None, fold=lambda *xs: _pymath.prod(xs)))
register(OpDef("div", 2, fold=lambda a, b: a / b))
register(OpDef("pow", 2, fold=lambda a, b: a**b))

# -- transcendentals ----------------------------------------------------------

for _name, _n, _fold in (
    ("sin", 1, _pymath.sin),
    ("cos", 1, _pymath.cos),
    ("tan", 1, _pymath.tan),
    ("asin", 1, _pymath.asin),
    ("acos", 1, _pymath.acos),
    ("atan", 1, _pymath.atan),
    ("atan2", 2, _pymath.atan2),
    ("sinh", 1, _pymath.sinh),
    ("cosh", 1, _pymath.cosh),
    ("tanh", 1, _pymath.tanh),
    ("asinh", 1, _pymath.asinh),
    ("acosh", 1, _pymath.acosh),
    ("atanh", 1, _pymath.atanh),
    ("exp", 1, _pymath.exp),
    ("log", 1, _pymath.log),
    ("sqrt", 1, _pymath.sqrt),
    ("erf", 1, _pymath.erf),
):
    register(OpDef(_name, _n, fold=_fold))

register(OpDef("sigmoid", 1, fold=lambda x: 1.0 / (1.0 + _pymath.exp(-x))))
register(OpDef("relu", 1, fold=lambda x: max(x, 0.0)))
register(OpDef("relup", 1, fold=lambda x: 1.0 if x > 0.0 else 0.0))

# -- relational / logical / select -------------------------------------------

register(OpDef("lt", 2, fold=lambda a, b: float(a < b)))
register(OpDef("le", 2, fold=lambda a, b: float(a <= b)))
register(OpDef("gt", 2, fold=lambda a, b: float(a > b)))
register(OpDef("ge", 2, fold=lambda a, b: float(a >= b)))
register(OpDef("eq", 2, fold=lambda a, b: float(a == b)))
register(OpDef("ne", 2, fold=lambda a, b: float(a != b)))
register(OpDef("logical_and", None,
               fold=lambda *xs: float(all(x != 0 for x in xs))))
register(OpDef("logical_or", None,
               fold=lambda *xs: float(any(x != 0 for x in xs))))
register(OpDef("logical_not", 1, fold=lambda x: float(x == 0)))
register(OpDef("select", 3, fold=lambda c, a, b: a if c != 0 else b))

# -- Kepler solvers (never folded) ---------------------------------------------

register(OpDef("kepE", 2))
register(OpDef("kepF", 3))
register(OpDef("kepDE", 3))
