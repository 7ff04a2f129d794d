"""Dense trigonometric-series op: a whole Poisson/trig series

    f(u) = sum_i  A_i(u) * sin(P_i(u))

(per-term polynomial amplitudes ``A_i`` and phase polynomials ``P_i``;
cosine terms fold in as a +pi/2 phase shift) as ONE tape op carrying its
coefficient tables as dense ``(n_terms, deg+1)`` arrays.

The counterpart of ``heyoka_tpu/expr/series.py``: the same store, the
same sha1 keys (so a tape's op names match the JAX tape's), the same
gradient rule and the same affine-in-time test.  The numbers live in
:mod:`..taylor.series_jet`: the tables on the device, the Taylor jet of
an affine input ``u = u0 + u1 t`` (kernel S1 on a CUDA tensor, its plain
twin on a CPU one) and the order-0 value (``series_value``), which
``expr.numeric.evaluate`` and the compiled functions reach.  A series op
lives in this process's store: after unpickling elsewhere, rebuild the
model expression (the JAX package's caveat) or the plan arrays, which
carry the tables (``convert.plan_from_arrays``).

Not ported, being TPU workarounds: the head/tail amplitude split with its
f32 tail and two-f32 phases (``_FAST``, ``_SPLIT``, ``_BLK``,
``_TAIL_MIN``, ``_split_store``, ``_dd_*``, ``_shift32``,
``_tail_eval32``, ``_tail_jet32``), the per-lane power-of-two step scale
``lam_e`` that keeps emulated f64 in the f32 exponent range (plain f64
holds ELP2000's largest order-19 coefficient, about 82,591^19 / 19! ~
1e75), ``mp_order_cap`` and the ``HEYOKA_SERIES_*`` environment knobs.
"""

from __future__ import annotations

import hashlib
import math as _pymath

import numpy as np

from . import registry as _reg
from .core import Expr, Func, expr
from . import diff as _diff

#: series data store: key -> dict(amp (n, q+1), ph (n, d+1)) f64 numpy
_STORE: dict = {}

PREFIX = "trigseries%"


def _key_for(amp: np.ndarray, ph: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(amp.tobytes())
    h.update(ph.tobytes())
    h.update(str(amp.shape).encode())
    h.update(str(ph.shape).encode())
    return h.hexdigest()[:16]


def _op_name(key: str) -> str:
    return f"{PREFIX}{key}"


def is_series(name: str) -> bool:
    """Whether ``name`` is a series op's name."""
    return name.startswith(PREFIX)


def key_of(name: str) -> str:
    """The store key of series op ``name``."""
    return name[len(PREFIX):]


def tables(name: str) -> tuple[np.ndarray, np.ndarray]:
    """``(amp, ph)`` of series op ``name``; KeyError where the store does
    not hold it."""
    d = _STORE[key_of(name)]
    return d["amp"], d["ph"]


def add(amp, ph) -> str:
    """Store the tables (f64, 2-D) and register their op; returns its
    name."""
    amp = np.atleast_2d(np.asarray(amp, np.float64))
    ph = np.atleast_2d(np.asarray(ph, np.float64))
    if amp.shape[0] != ph.shape[0]:
        raise ValueError(
            f"amp/ph term counts differ: {amp.shape[0]} vs {ph.shape[0]}")
    key = _key_for(amp, ph)
    if key not in _STORE:
        _STORE[key] = {"amp": amp, "ph": ph}
        _register(key)
    return _op_name(key)


def trig_series(u, amp, ph) -> Expr:
    """Expression ``sum_i amp_i(u) * sin(ph_i(u))`` as one dense tape op.

    ``amp``: (n_terms, q+1) ascending amplitude-polynomial coefficients;
    ``ph``: (n_terms, d+1) ascending phase-polynomial coefficients.
    ``u`` must be affine in time for Taylor integration (checked when an
    integrator is built, not here: a cfunc has no restriction).
    """
    return Func(add(amp, ph), (expr(u),))


def _grad(key: str):
    """d/du sum A(u) sin(P(u)) = sum [A' sin(P) + A P' cos(P)]: two
    derived series (cos via a +pi/2 phase)."""

    def g(t):
        d = _STORE[key]
        amp, ph = d["amp"], d["ph"]
        n, q1 = amp.shape
        _n, d1 = ph.shape
        parts = []
        if q1 > 1:
            damp = amp[:, 1:] * np.arange(1, q1)[None, :]
            parts.append(trig_series(t, damp, ph))
        # A * P' * cos(P): P' has degree d-1; the product A*P' is a
        # polynomial amplitude of degree (q1-1)+(d1-2)
        if d1 > 1:
            dph = ph[:, 1:] * np.arange(1, d1)[None, :]
            qa = q1 - 1
            qb = d1 - 2
            prod = np.zeros((n, qa + qb + 1))
            for i in range(qa + 1):
                for j in range(qb + 1):
                    prod[:, i + j] += amp[:, i] * dph[:, j]
            ph_shift = ph.copy()
            ph_shift[:, 0] += _pymath.pi / 2.0
            parts.append(trig_series(t, prod, ph_shift))
        if not parts:
            from .core import ZERO

            return (ZERO,)
        out = parts[0]
        for pp in parts[1:]:
            out = out + pp
        return (out,)

    return g


def affine_in_time(e) -> bool:
    """True when ``e`` is (symbolically) c0 + c1*t with c0/c1 free of time
    and state variables: the condition for the Taylor rule's closed form."""
    d = _time_degree(expr(e))
    return d is not None and d <= 1


def _time_degree(e):
    from .core import Number, Param, TimeExpr, Variable

    if isinstance(e, (Number, Param)):
        return 0
    if isinstance(e, TimeExpr):
        return 1
    if isinstance(e, Variable):
        return None
    if isinstance(e, Func):
        degs = [_time_degree(a) for a in e.fargs]
        if e.op == "sum":
            return None if any(d is None for d in degs) else max(degs)
        if e.op in ("mul", "prod"):
            return None if any(d is None for d in degs) else sum(degs)
        if all(d == 0 for d in degs):
            return 0  # time-free subtree
        return None
    return None


def _register(key: str):
    name = _op_name(key)
    if _reg.have_op(name):
        return
    _reg.register(_reg.OpDef(name, 1))
    _diff._GRAD[name] = _grad(key)

