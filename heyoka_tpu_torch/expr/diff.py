"""Symbolic differentiation (a copy of ``heyoka_tpu.expr.diff``; pure
Python, held against the original by tests/test_torch_var.py).

Reference parity: heyoka ``diff()`` (``expression.hpp:394-407``,
``src/expression_diff.cpp``) — first-order symbolic derivatives wrt a variable
or a param.  Gradient rules mirror each op's ``gradient()`` UDF hook
(``src/math/*.cpp``).  Works bottom-up over the DAG with an id-keyed memo so
shared subtrees are differentiated once (the reference's reverse-pass
``void_ptr_map`` discipline, ``expression_diff.cpp``).
"""

from __future__ import annotations

from typing import Callable

from .core import (
    Expr,
    Func,
    Number,
    Param,
    TimeExpr,
    Variable,
    ZERO,
    ONE,
    expr,
    postorder,
    prod_expr,
    sum_expr,
)
from . import math as hm


# gradient rule: args -> tuple of d(op)/d(arg_i) expressions
_GRAD: dict[str, Callable] = {}


def grad_rule(name):
    def deco(fn):
        _GRAD[name] = fn
        return fn

    return deco


@grad_rule("sum")
def _g_sum(*args):
    return tuple(ONE for _ in args)


@grad_rule("prod")
def _g_prod(*args):
    outs = []
    for i in range(len(args)):
        outs.append(prod_expr(args[:i] + args[i + 1 :]))
    return tuple(outs)


@grad_rule("div")
def _g_div(a, b):
    return (1.0 / b, -a / (b * b))


@grad_rule("pow")
def _g_pow(a, n):
    assert isinstance(n, Number)
    return (Number(n.value) * a ** (n.value - 1.0), ZERO)


@grad_rule("sin")
def _g_sin(x):
    return (hm.cos(x),)


@grad_rule("cos")
def _g_cos(x):
    return (-hm.sin(x),)


@grad_rule("tan")
def _g_tan(x):
    t = hm.tan(x)
    return (1.0 + t * t,)


@grad_rule("asin")
def _g_asin(x):
    return (1.0 / hm.sqrt(1.0 - x * x),)


@grad_rule("acos")
def _g_acos(x):
    return (-1.0 / hm.sqrt(1.0 - x * x),)


@grad_rule("atan")
def _g_atan(x):
    return (1.0 / (1.0 + x * x),)


@grad_rule("atan2")
def _g_atan2(y, x):
    d = x * x + y * y
    return (x / d, -y / d)


@grad_rule("sinh")
def _g_sinh(x):
    return (hm.cosh(x),)


@grad_rule("cosh")
def _g_cosh(x):
    return (hm.sinh(x),)


@grad_rule("tanh")
def _g_tanh(x):
    t = hm.tanh(x)
    return (1.0 - t * t,)


@grad_rule("asinh")
def _g_asinh(x):
    return (1.0 / hm.sqrt(1.0 + x * x),)


@grad_rule("acosh")
def _g_acosh(x):
    return (1.0 / hm.sqrt(x * x - 1.0),)


@grad_rule("atanh")
def _g_atanh(x):
    return (1.0 / (1.0 - x * x),)


@grad_rule("exp")
def _g_exp(x):
    return (hm.exp(x),)


@grad_rule("log")
def _g_log(x):
    return (1.0 / x,)


@grad_rule("sqrt")
def _g_sqrt(x):
    return (0.5 / hm.sqrt(x),)


@grad_rule("erf")
def _g_erf(x):
    import math as pm

    return (Number(2.0 / pm.sqrt(pm.pi)) * hm.exp(-(x * x)),)


@grad_rule("sigmoid")
def _g_sigmoid(x):
    s = hm.sigmoid(x)
    return (s * (1.0 - s),)


@grad_rule("relu")
def _g_relu(x):
    return (hm.relup(x),)


@grad_rule("relup")
def _g_relup(x):
    return (ZERO,)


@grad_rule("select")
def _g_select(c, a, b):
    return (ZERO, hm.select(c, ONE, ZERO), hm.select(c, ZERO, ONE))


for _name in ("lt", "le", "gt", "ge", "eq", "ne"):
    _GRAD[_name] = lambda a, b: (ZERO, ZERO)
_GRAD["logical_not"] = lambda x: (ZERO,)
_GRAD["logical_and"] = lambda *xs: tuple(ZERO for _ in xs)
_GRAD["logical_or"] = lambda *xs: tuple(ZERO for _ in xs)


@grad_rule("kepE")
def _g_kepE(e, M):
    # E(e, M): E - e sin E = M  =>  dE = (sinE dE_num...)  (kepE.cpp gradient())
    E = hm.kepE(e, M)
    d = 1.0 - e * hm.cos(E)
    return (hm.sin(E) / d, 1.0 / d)


@grad_rule("kepF")
def _g_kepF(h, k, lam):
    F = hm.kepF(h, k, lam)
    d = 1.0 - h * hm.sin(F) - k * hm.cos(F)
    return (-hm.cos(F) / d, hm.sin(F) / d, 1.0 / d)


@grad_rule("kepDE")
def _g_kepDE(s0, c0, DM):
    DE = hm.kepDE(s0, c0, DM)
    d = 1.0 + s0 * hm.sin(DE) - c0 * hm.cos(DE)
    return (-(1.0 - hm.cos(DE)) / d, hm.sin(DE) / d, 1.0 / d)


def diff(e: Expr, x) -> Expr:
    """Derivative of ``e`` wrt variable/param ``x`` (or the *explicit* time
    dependence when ``x`` is the time expression).

    ``x`` may be a Variable, a variable-name string, a Param, or TimeExpr
    (heyoka ``diff``, ``expression.hpp:394-407``).
    """
    e = expr(e)
    if isinstance(x, str):
        x = Variable(x)
    if not isinstance(x, (Variable, Param, TimeExpr)):
        raise TypeError("can only differentiate wrt a variable, a param, or time")

    deriv: dict[int, Expr] = {}
    for node in postorder(e):
        if isinstance(node, Number):
            d = ZERO
        elif isinstance(node, TimeExpr):
            d = ONE if isinstance(x, TimeExpr) else ZERO
        elif isinstance(node, Variable):
            d = ONE if (isinstance(x, Variable) and node.name == x.name) else ZERO
        elif isinstance(node, Param):
            d = ONE if (isinstance(x, Param) and node.idx == x.idx) else ZERO
        else:
            assert isinstance(node, Func)
            rule = _GRAD.get(node.op)
            if rule is None:
                raise NotImplementedError(f"no gradient rule for op {node.op!r}")
            grads = rule(*node.fargs)
            terms = []
            for g, a in zip(grads, node.fargs):
                da = deriv[id(a)]
                if isinstance(da, Number) and da.value == 0.0:
                    continue
                if isinstance(g, Number) and g.value == 0.0:
                    continue
                terms.append(prod_expr((g, da)))
            d = sum_expr(terms) if terms else ZERO
        deriv[id(node)] = d
    return deriv[id(e)]
