"""Numeric rules of the tape ops in torch, in their operands' dtype (f64,
or f32 for the float32 integrators and cfuncs): the values the Taylor jet
needs at order 0.

The counterpart of the ``evaluate`` rules of ``heyoka_tpu/expr/registry.py``
(:70-290), which are jax.numpy functions; the names and arities are those
of the port's :mod:`.registry`.  ``EVAL_ARITY`` is ``heyoka_tpu/taylor/
compact.py:113`` ``_EVAL_ARITY``: the inverse trig ops, erf and atan2
carry an auxiliary operand for their recurrence that order 0 does not
read.  Relational and logical ops give 0/1 in the working dtype.

The Kepler solvers run Newton's method from the JAX package's start values
with its 1e-15 stop and 50-iteration cap (in f32 the stop is never met
and every lane runs the 50 iterations).  The JAX loop iterates every lane
until all have converged; here a converged lane is frozen with
``torch.where`` and the loop always runs to the cap (a test of
convergence would be a host sync per iteration on a CUDA tensor), so a
lane's last bit no longer depends on its batch-mates.

The port's compiled functions (``cfunc.tape_eval``) evaluate their tapes
with the same rules.  A dense trig-series op (``trigseries%<key>``,
``series.py``) resolves through its store: kernel S1 at order 0 on a CUDA
tensor, its twin on a CPU one.  A dataset interpolant or its slope
(``<qty>%<key>``, ``<qty>_p%<key>``) resolves through ``eop_sw.evaluate``
(a ``searchsorted`` and the linear interpolation on tables on the
tensor's device), ``dayfrac`` through ``models.dayfrac.ev_dayfrac``.
Their tables are f64: an f32 operand gets its value rounded to f32.
"""

from __future__ import annotations

import math as _pymath

import torch

#: number of operands the order-0 rule reads, where it is not the group's
#: operand count
EVAL_ARITY = {
    "asin": 1, "acos": 1, "atan": 1, "asinh": 1, "acosh": 1, "atanh": 1,
    "erf": 1, "atan2": 2,
}

_TWOPI = 2.0 * _pymath.pi
_NEWTON_TOL = 1e-15
_NEWTON_MAX_ITER = 50


def _sum(*xs):
    r = xs[0]
    for x in xs[1:]:
        r = r + x
    return r


def _boolish(fn):
    def ev(*xs):
        return fn(*xs).to(xs[0].dtype)
    return ev


def _and(*xs):
    r = xs[0] != 0
    for x in xs[1:]:
        r = r & (x != 0)
    return r


def _or(*xs):
    r = xs[0] != 0
    for x in xs[1:]:
        r = r | (x != 0)
    return r


def _newton(x0, fdf):
    """Newton's method from ``x0`` on all lanes; a lane stops once its
    last correction is at most 1e-15 in magnitude, and every lane after 50
    iterations."""
    x = x0
    dx_prev = torch.ones_like(x0)
    for _ in range(_NEWTON_MAX_ITER):
        act = dx_prev.abs() > _NEWTON_TOL
        f, fp = fdf(x)
        dx = f / fp
        x = torch.where(act, x - dx, x)
        dx_prev = torch.where(act, dx, dx_prev)
    return x


def _reduce(a):
    """``a`` reduced to [0, 2 pi), as the JAX solvers reduce it."""
    return a - _TWOPI * torch.floor(a / _TWOPI)


def kepE(ecc, M):
    """E - e sin E = M (``registry.py`` ``_ev_kepE``); Danby's start
    E0 = M + 0.85 e sign(sin M)."""
    Mr = _reduce(M)
    E0 = Mr + 0.85 * ecc * torch.sign(torch.sin(Mr))
    E0, Mr = torch.broadcast_tensors(E0 * torch.ones_like(ecc),
                                     Mr * torch.ones_like(ecc))

    def fdf(E):
        sE, cE = torch.sin(E), torch.cos(E)
        return E - ecc * sE - Mr, 1.0 - ecc * cE

    return _newton(E0, fdf) + (M - Mr)


def kepF(h, k, lam):
    """F + h cos F - k sin F = lam (``registry.py`` ``_ev_kepF``); start
    F0 = lam reduced."""
    lr = _reduce(lam)
    F0 = lr * torch.ones_like(h) * torch.ones_like(k)

    def fdf(F):
        sF, cF = torch.sin(F), torch.cos(F)
        return F + h * cF - k * sF - lr, 1.0 - h * sF - k * cF

    return _newton(F0, fdf) + (lam - lr)


def kepDE(s0, c0, DM):
    """DE + s0 (1 - cos DE) - c0 sin DE = DM (``registry.py``
    ``_ev_kepDE``); start DE0 = DM reduced."""
    Dr = _reduce(DM)
    D0 = Dr * torch.ones_like(s0) * torch.ones_like(c0)

    def fdf(DE):
        sD, cD = torch.sin(DE), torch.cos(DE)
        return (DE + s0 * (1.0 - cD) - c0 * sD - Dr,
                1.0 + s0 * sD - c0 * cD)

    return _newton(D0, fdf) + (DM - Dr)


#: op name -> torch rule over the operands' values
EVALUATE = {
    "sum": _sum,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "atan2": torch.atan2,
    "erf": torch.erf,
    "sigmoid": torch.sigmoid,
    "relu": lambda x: torch.maximum(x, torch.zeros_like(x)),
    "relup": _boolish(lambda x: x > 0.0),
    "lt": _boolish(lambda a, b: a < b),
    "le": _boolish(lambda a, b: a <= b),
    "gt": _boolish(lambda a, b: a > b),
    "ge": _boolish(lambda a, b: a >= b),
    "eq": _boolish(lambda a, b: a == b),
    "ne": _boolish(lambda a, b: a != b),
    "logical_and": _boolish(_and),
    "logical_or": _boolish(_or),
    "logical_not": _boolish(lambda x: x == 0),
    "select": lambda c, a, b: torch.where(c != 0, a, b),
    "kepE": kepE,
    "kepF": kepF,
    "kepDE": kepDE,
}


def evaluate(name: str, *args):
    """The value of op ``name`` on tensors ``args`` of one dtype, which it
    keeps (pow has its own rule with the exponent,
    ``taylor.jet_kernels._pow0_plain``); a dense series op
    (``trigseries%<key>``) goes to ``series_jet.series_value``, a dataset
    op to ``eop_sw.evaluate``, ``dayfrac`` to
    ``models.dayfrac.ev_dayfrac``, each computed in f64 and rounded to the
    operand's dtype."""
    if name not in EVALUATE:
        from .series import is_series

        if is_series(name):
            from ..taylor.series_jet import series_value

            return series_value(name, args[0]).to(args[0].dtype)
        from .. import eop_sw

        if eop_sw.is_interp(name):
            return eop_sw.evaluate(name, args[0]).to(args[0].dtype)
        if name == "dayfrac":
            from ..models.dayfrac import ev_dayfrac

            return ev_dayfrac(args[0]).to(args[0].dtype)
    return EVALUATE[name](*args[:EVAL_ARITY.get(name, len(args))])
