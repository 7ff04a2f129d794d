"""IAU2006/2000A precession-nutation: the CIP coordinates X, Y and the CIO
locator s as expressions of TT time (the port's copy of
``heyoka_tpu/models/iau2006.py``, numpy and the port's expression layer
only).

Reference parity: ``model::iau2006`` (``include/heyoka/model/iau2006.hpp``,
``src/model/iau2006.cpp``, series data ``src/detail/iau2006/{X,Y,s}.cpp``).
The underlying datasets are the public IERS Conventions tables tab5.2a/b/d
(shipped as ``heyoka_tpu_torch/data/iau2006.npz``, a byte-identical copy
of the JAX package's): Poisson series whose terms are
``C_s sin(arg) + C_c cos(arg)`` with ``arg`` an integer combination of the 14
standard lunisolar/planetary fundamental arguments, grouped by powers of t.

Like the reference, the trigonometric evaluations are shared: every
``sin/cos`` of a fundamental argument is computed once and integer multiples
are produced by cached complex multiplication, so the expression DAG
contains exactly 14 sin/cos pairs regardless of the number of series terms
(an expanded expression, with no series op).

``thresh`` drops terms with total amplitude below the threshold (arcsec),
default 1e-6 (``iau2006_default_thresh``).
"""

from __future__ import annotations

import math
from functools import lru_cache
import numpy as np

from ..data import data_path
from ..expr.core import ONE, ZERO, expr, time as _time_expr
from ..expr.math import cos, sin, sum_ as _sum

__all__ = ["iau2006"]

_ARCSEC = math.pi / (180.0 * 3600.0)
_UAS = _ARCSEC / 1e6

# Polynomial coefficients of the 14 fundamental arguments (IERS Conventions
# 2010, chapter 5; lunisolar in arcsec, planetary in rad).
_LUNISOLAR = [
    # l, l', F, D, Om
    [485868.24903600005, 1717915923.2178, 31.8792, 0.051635, -0.00024470],
    [1287104.793048, 129596581.0481, -0.5532, 0.000136, -0.00001149],
    [335779.526232, 1739527262.8478, -12.7512, -0.001037, 0.00000417],
    [1072260.7036920001, 1602961601.2090, -6.3706, 0.006593, -0.00003169],
    [450160.39803599997, -6962890.5431, 7.4722, 0.007702, -0.00005939],
]
_PLANETARY = [
    # mean longitudes of Mercury..Neptune + general precession p_A
    [4.402608842, 2608.7903141574],
    [3.176146697, 1021.3285546211],
    [1.753470314, 628.3075849991],
    [6.203480913, 334.0612426700],
    [0.599546497, 52.9690962641],
    [0.874016757, 21.3299104960],
    [5.481293872, 7.4781598567],
    [5.311886287, 3.8133035638],
    [0.0, 0.02438175, 0.00000538691],
]

# Polynomial parts of X/Y (arcsec) and s (microarcsec).
_POLY_X = [-0.016617, 2004.191898, -0.4297829, -0.19861834, 0.000007578, 0.0000059285]
_POLY_Y = [-0.006951, -0.025896, -22.4072747, 0.00190059, 0.001112526, 0.0000001358]
_POLY_S = [94.0, 3808.65, -122.68, -72574.11, 27.98, 15.62]


@lru_cache(maxsize=1)
def _series_data():
    with np.load(data_path("iau2006.npz")) as d:
        return {k: d[k] for k in d.files}


def _horner(coeffs, t):
    res = expr(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        res = res * t + c
    return res


class _TrigCache:
    """cos/sin of integer multiples of the fundamental arguments, built by
    cached complex multiplication (one sin/cos pair per argument)."""

    def __init__(self, args):
        self._args = args
        self._cache = [dict() for _ in args]

    def get(self, j: int, p: int):
        c = self._cache[j]
        if p in c:
            return c[p]
        if p == 0:
            v = (ONE, ZERO)
        elif p == 1:
            v = (cos(self._args[j]), sin(self._args[j]))
        elif p == -1:
            c1, s1 = self.get(j, 1)
            v = (c1, -s1)
        elif p > 1:
            v = _cmul(self.get(j, p - 1), self.get(j, 1))
        else:
            v = _cmul(self.get(j, p + 1), self.get(j, -1))
        c[p] = v
        return v


def _cmul(a, b):
    ca, sa = a
    cb, sb = b
    return (ca * cb - sa * sb, sa * cb + ca * sb)


def iau2006(*, time_expr=None, thresh: float = 1e-6):
    """[X, Y, s] of the IAU2006/2000A precession-nutation theory as
    expressions of ``time_expr`` (TT Julian centuries since J2000.0; default
    heyoka time).  Angles in radians."""
    if not (math.isfinite(thresh) and thresh >= 0.0):
        raise ValueError(
            f"invalid iau2006 threshold {thresh}: must be finite and non-negative"
        )
    tm = _time_expr if time_expr is None else expr(time_expr)
    d = _series_data()

    # fundamental arguments
    args = [_horner(c, tm) * _ARCSEC for c in _LUNISOLAR] + [
        _horner(c, tm) for c in _PLANETARY
    ]
    trig = _TrigCache(args)

    def series(q: str):
        pows = []
        for p in range(5):
            idxs = d[f"{q}_idxs_{p}"]
            cfs = d[f"{q}_cfs_{p}"]
            terms = []
            for i in range(idxs.shape[0]):
                s_cf, c_cf = cfs[i, 0] / 1e6, cfs[i, 1] / 1e6  # -> arcsec
                if math.hypot(s_cf, c_cf) < thresh:
                    continue
                cp = (ONE, ZERO)
                for j in range(14):
                    if idxs[i, j]:
                        cp = _cmul(cp, trig.get(j, int(idxs[i, j])))
                terms.append(c_cf * _ARCSEC * cp[0])
                terms.append(s_cf * _ARCSEC * cp[1])
            pows.append(_sum(terms) if terms else ZERO)
        # multiply by powers of t (Horner over the 5 groups)
        res = pows[-1]
        for g in reversed(pows[:-1]):
            res = res * tm + g if g is not ZERO else res * tm
        return res

    X = _horner(_POLY_X, tm) * _ARCSEC + series("X")
    Y = _horner(_POLY_Y, tm) * _ARCSEC + series("Y")
    s_trig = series("s")
    s = _horner(_POLY_S, tm) * _UAS + s_trig - 0.5 * (X * Y)
    # NOTE: the tabulated s series is for s + XY/2, hence the subtraction —
    # using the *full* X, Y here mirrors the reference, which applies the
    # identical correction with its series X/Y (sans EOP dX/dY corrections,
    # which are handled at the frame-rotation level).
    return [X, Y, s]
