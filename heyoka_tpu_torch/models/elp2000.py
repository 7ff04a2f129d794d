"""ELP2000-82B semi-analytic lunar ephemeris as expressions (the port's
copy of ``heyoka_tpu/models/elp2000.py``, numpy and the port's expression
layer only).

Reference parity: ``model::elp2000_spherical/cartesian[_e2000/_fk5]`` and
``get_elp2000_mus`` (``include/heyoka/model/elp2000.hpp``,
``src/model/elp2000.cpp``, series data ``src/detail/elp2000/``).  The
underlying datasets are the public Chapront-Touze & Chapront ELP2000-82B
series (36 files, shipped as ``heyoka_tpu_torch/data/elp2000.npz``, a
byte-identical copy of the JAX package's).

Input time: Julian centuries of TDB since J2000.0.  Output: geocentric
position of the Moon — spherical ``[r (km), U latitude, V longitude]`` in
the mean ecliptic/equinox of date; Cartesian variants rotate to the inertial
mean ecliptic of J2000 (Laskar precession series) and to FK5 at J2000.
``thresh`` prunes series terms by amplitude (radians for angles, relative to
``a0`` for the distance), default 1e-6 like the reference.
"""

from __future__ import annotations

import math
from functools import lru_cache
import numpy as np

from ..data import data_path
from ..expr.core import ONE, ZERO, expr, time as _time_expr
from ..expr.math import cos, sin, sqrt, sum_ as _sum

__all__ = [
    "elp2000_spherical",
    "elp2000_cartesian",
    "elp2000_cartesian_e2000",
    "elp2000_cartesian_fk5",
    "get_elp2000_mus",
]

# Mean-argument polynomials (radians, Julian centuries TDB since J2000);
# values from the published ELP2000-82B constants.
_W1 = [3.8103444305883079, 8399.6847317739157, -2.8547283984772807e-05,
       3.2017095500473753e-08, -1.5363745554361197e-10]
_ZETA = [_W1[0], _W1[1] + 0.024381748353014515]
_D = [5.1984667410274437, 7771.3771468120494, -2.8449351621188683e-05,
      3.1973462269173901e-08, -1.5436467606527627e-10]
_LP = [6.2400601269714615, 628.30195516800313, -2.680534842854624e-06,
       7.1267611123101784e-10]
_L = [2.3555558982657985, 8328.6914269553617, 0.00015702775761561094,
      2.5041111442988642e-07, -1.1863390776750345e-09]
_F = [1.6279052333714679, 8433.4661581308319, -5.9392100004323707e-05,
      -4.9499476841283623e-09, 2.021673050226765e-11]
_ME = [4.4026088424029615, 2608.7903141574106]
_V = [3.1761466969075944, 1021.3285546211089]
_MA = [6.2034809133999449, 334.06124314922965]
_J = [0.59954649738867349, 52.969096509472053]
_S = [0.87401675651848076, 21.329909543800007]
_U = [5.4812938716049908, 7.4781598567143535]
_N = [5.3118862867834666, 3.8133035637584562]
_T = [1.753470343150658, 628.30758496215537]

# Physical constants of the theory (used for the A-coefficient corrections).
_A0 = 384747.980674
_NU = 1732559343.18
_NP = 129597742.34
_M = _NP / _NU
_DNU = 0.55604
_DNP = -0.0642
_ALPHA = (_M * _M * 3.040423956e-6) ** (1.0 / 3.0)
_ALPHA2_M3 = (2 * _ALPHA) / (3 * _M)
_B15_FAC = (_DNP - (_M * _DNU)) / _NU
_B2_FAC = -0.08066 / 206264.81
_B3_FAC = 0.01789 / 206264.81
_B4_FAC = -0.12879 / 206264.81
_ARCSEC = 4.8481368110953598e-06

# Laskar's precession series (mean ecliptic of date -> inertial J2000).
_LASKAR_P = [0.0, 0.10180391e-4, 0.47020439e-6, -0.5417367e-9,
             -0.2507948e-11, 0.463486e-14]
_LASKAR_Q = [0.0, -0.113469002e-3, 0.12372674e-6, 0.12654170e-8,
             -0.1371808e-11, -0.320334e-14]

# Per-series wiring: coordinate (V/U/r), t-power bucket, argument set, and
# whether the main-problem (A+B-correction) format applies (series 1-3).
# Argument sets: "main" = [D, lp, l, F] (full polynomials);
# "zdllf" = [zeta, D, lp, l, F] (linear parts);
# "plan1" = 8 planets + [D, l, F] linear; "plan2" = 7 planets + [D, lp, l, F] linear.
_SERIES = {
    1: ("V", 0, "main"), 2: ("U", 0, "main"), 3: ("r", 0, "main"),
    4: ("V", 0, "zdllf"), 5: ("U", 0, "zdllf"), 6: ("r", 0, "zdllf"),
    7: ("V", 1, "zdllf"), 8: ("U", 1, "zdllf"), 9: ("r", 1, "zdllf"),
    10: ("V", 0, "plan1"), 11: ("U", 0, "plan1"), 12: ("r", 0, "plan1"),
    13: ("V", 1, "plan1"), 14: ("U", 1, "plan1"), 15: ("r", 1, "plan1"),
    16: ("V", 0, "plan2"), 17: ("U", 0, "plan2"), 18: ("r", 0, "plan2"),
    19: ("V", 1, "plan2"), 20: ("U", 1, "plan2"), 21: ("r", 1, "plan2"),
    22: ("V", 0, "zdllf"), 23: ("U", 0, "zdllf"), 24: ("r", 0, "zdllf"),
    25: ("V", 1, "zdllf"), 26: ("U", 1, "zdllf"), 27: ("r", 1, "zdllf"),
    28: ("V", 0, "zdllf"), 29: ("U", 0, "zdllf"), 30: ("r", 0, "zdllf"),
    31: ("V", 0, "zdllf"), 32: ("U", 0, "zdllf"), 33: ("r", 0, "zdllf"),
    34: ("V", 2, "zdllf"), 35: ("U", 2, "zdllf"), 36: ("r", 2, "zdllf"),
}


@lru_cache(maxsize=1)
def _series_data():
    with np.load(data_path("elp2000.npz")) as d:
        return {k: d[k] for k in d.files}


def _horner(coeffs, t):
    res = expr(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        res = res * t + c
    return res


class _TrigCache:
    """(cos, sin) of integer multiples of a set of arguments via cached
    complex multiplication (shared with the IAU2006 builder pattern)."""

    def __init__(self):
        self._cache = {}

    def get(self, key, arg, p: int):
        c = self._cache.setdefault(key, {})
        if p in c:
            return c[p]
        if p == 0:
            v = (ONE, ZERO)
        elif p == 1:
            v = (cos(arg), sin(arg))
        elif p == -1:
            c1, s1 = self.get(key, arg, 1)
            v = (c1, -s1)
        elif p > 1:
            v = _cmul(self.get(key, arg, p - 1), self.get(key, arg, 1))
        else:
            v = _cmul(self.get(key, arg, p + 1), self.get(key, arg, -1))
        c[p] = v
        return v


def _cmul(a, b):
    ca, sa = a
    cb, sb = b
    return (ca * cb - sa * sb, sa * cb + ca * sb)


def elp2000_spherical(*, time_expr=None, thresh: float = 1e-6,
                      series_op: bool = False):
    """``[r (km), U, V]`` geocentric spherical coordinates of the Moon in
    the mean ecliptic/equinox of date.

    ``series_op=True`` packs each coordinate's trigonometric series into a
    single dense :func:`heyoka_tpu_torch.expr.series.trig_series` tape op
    (requires ``time_expr`` affine in time): the tape stays O(10) u-vars
    instead of 10^3-10^5, and each series' jet is one launch of kernel
    S1 on the card (see expr/series.py, taylor/series_jet.py).
    """
    if not (math.isfinite(thresh) and thresh >= 0.0):
        raise ValueError(f"invalid elp2000 threshold {thresh}")
    tm = _time_expr if time_expr is None else expr(time_expr)
    if series_op:
        from ..expr.series import affine_in_time

        if not affine_in_time(tm):
            raise ValueError(
                "series_op=True requires a time_expr affine in time "
                "(the closed-form Taylor rule folds the argument "
                "polynomials into per-term tables)"
            )
        return _elp2000_spherical_series(tm, thresh)
    d = _series_data()

    args_full = {
        "W1": _horner(_W1, tm),
        "zeta": _horner(_ZETA, tm),
        "D": _horner(_D, tm), "Dl": _horner(_D[:2], tm),
        "lp": _horner(_LP, tm), "lpl": _horner(_LP[:2], tm),
        "l": _horner(_L, tm), "ll": _horner(_L[:2], tm),
        "F": _horner(_F, tm), "Fl": _horner(_F[:2], tm),
        "Me": _horner(_ME, tm), "V": _horner(_V, tm),
        "T": _horner(_T, tm), "Ma": _horner(_MA, tm),
        "J": _horner(_J, tm), "S": _horner(_S, tm),
        "U": _horner(_U, tm), "N": _horner(_N, tm),
    }
    argsets = {
        "main": ["D", "lp", "l", "F"],
        "zdllf": ["zeta", "Dl", "lpl", "ll", "Fl"],
        "plan1": ["Me", "V", "T", "Ma", "J", "S", "U", "N", "Dl", "ll", "Fl"],
        "plan2": ["Me", "V", "T", "Ma", "J", "S", "U", "Dl", "lpl", "ll", "Fl"],
    }
    trig = _TrigCache()

    # accumulation buckets: coord -> [t^0 terms, t^1 terms, t^2 terms]
    buckets = {"V": [[], [], []], "U": [[], [], []], "r": [[], [], []]}
    buckets["V"][0].append(args_full["W1"])

    for k in range(1, 37):
        coord, tpow, aset = _SERIES[k]
        names = argsets[aset]
        idxs = d[f"idx_{k}"]
        main_fmt = aset == "main"
        tab = d[f"AB_{k}"] if main_fmt else d[f"phiA_{k}"]
        for i in range(idxs.shape[0]):
            if main_fmt:
                A = tab[i, 0]
                keep = abs(A / _A0 if coord == "r" else A) > thresh
            else:
                phi, A = tab[i]
                keep = abs(A / _A0 if coord == "r" else A) > thresh
            if not keep:
                continue
            cp = (ONE, ZERO)
            for j, nm in enumerate(names):
                if idxs[i, j]:
                    cp = _cmul(cp, trig.get(nm, args_full[nm], int(idxs[i, j])))
            if main_fmt:
                B1, B2, B3, B4, B5 = tab[i, 1:6]
                corr = (
                    (B1 + B5 * _ALPHA2_M3) * _B15_FAC
                    + _B2_FAC * B2 + _B3_FAC * B3 + _B4_FAC * B4
                ) * _ARCSEC
                amp = A + corr
                # the main-problem distance series is a cosine series
                term = amp * (cp[0] if coord == "r" else cp[1])
            else:
                if phi != 0.0:
                    cp = _cmul(cp, (expr(math.cos(phi)), expr(math.sin(phi))))
                term = A * cp[1]
            buckets[coord][tpow].append(term)

    def assemble(coord):
        parts = [_sum(b) if b else ZERO for b in buckets[coord]]
        res = parts[2]
        for g in (parts[1], parts[0]):
            res = res * tm + g
        return res

    return [assemble("r"), assemble("U"), assemble("V")]


def _elp2000_spherical_series(tm, thresh: float):
    """Numeric-table variant of the spherical series (one dense
    ``trig_series`` op per coordinate; same kept-term selection as the
    symbolic path)."""
    from ..expr.series import trig_series

    d = _series_data()
    argpoly = {
        "W1": _W1, "zeta": _ZETA,
        "D": _D, "Dl": _D[:2],
        "lp": _LP, "lpl": _LP[:2],
        "l": _L, "ll": _L[:2],
        "F": _F, "Fl": _F[:2],
        "Me": _ME, "V": _V, "T": _T, "Ma": _MA,
        "J": _J, "S": _S, "U": _U, "N": _N,
    }
    argsets = {
        "main": ["D", "lp", "l", "F"],
        "zdllf": ["zeta", "Dl", "lpl", "ll", "Fl"],
        "plan1": ["Me", "V", "T", "Ma", "J", "S", "U", "N", "Dl", "ll",
                  "Fl"],
        "plan2": ["Me", "V", "T", "Ma", "J", "S", "U", "Dl", "lpl", "ll",
                  "Fl"],
    }
    DEG = 4  # max argument-polynomial degree
    amps = {"V": [], "U": [], "r": []}
    phs = {"V": [], "U": [], "r": []}

    for k in range(1, 37):
        coord, tpow, aset = _SERIES[k]
        names = argsets[aset]
        idxs = np.asarray(d[f"idx_{k}"], float)  # (n, n_args)
        main_fmt = aset == "main"
        tab = d[f"AB_{k}"] if main_fmt else d[f"phiA_{k}"]
        # argument polynomials stacked: (n_args, DEG+1)
        AP = np.zeros((len(names), DEG + 1))
        for j, nm in enumerate(names):
            pj = np.asarray(argpoly[nm], float)
            AP[j, : pj.size] = pj
        if main_fmt:
            A = tab[:, 0]
            keep = np.abs(A / _A0 if coord == "r" else A) > thresh
            B = tab[keep, 1:6]
            corr = (
                (B[:, 0] + B[:, 4] * _ALPHA2_M3) * _B15_FAC
                + _B2_FAC * B[:, 1] + _B3_FAC * B[:, 2]
                + _B4_FAC * B[:, 3]
            ) * _ARCSEC
            amp = A[keep] + corr
            arg = idxs[keep] @ AP  # (kept, DEG+1)
            if coord == "r":
                arg[:, 0] += 0.5 * math.pi  # cosine series
        else:
            phi, A = tab[:, 0], tab[:, 1]
            keep = np.abs(A / _A0 if coord == "r" else A) > thresh
            amp = A[keep]
            arg = idxs[keep] @ AP
            arg[:, 0] += phi[keep]
        if not amp.size:
            continue
        amps[coord].append((tpow, amp))
        phs[coord].append(arg)

    out = {}
    for coord in ("r", "U", "V"):
        # one CONSTANT-amplitude op per t-power bucket (see vsop2013.py:
        # folding t^p into polynomial amplitudes widens the op's per-order
        # window; composing the powers outside keeps it minimal)
        buckets_a = {0: [], 1: [], 2: []}
        buckets_p = {0: [], 1: [], 2: []}
        for (tpow, amp), arg in zip(amps[coord], phs[coord]):
            buckets_a[tpow].append(amp)
            buckets_p[tpow].append(arg)
        parts = []
        for tpow in (2, 1, 0):
            if buckets_a[tpow]:
                parts.append(trig_series(
                    tm, np.concatenate(buckets_a[tpow])[:, None],
                    np.concatenate(buckets_p[tpow]),
                ))
            else:
                parts.append(ZERO)
        e = parts[0]
        for g in parts[1:]:
            e = e * tm + g
        out[coord] = e
    # the longitude carries the mean-longitude polynomial W1
    out["V"] = _horner(_W1, tm) + out["V"]
    return [out["r"], out["U"], out["V"]]


def elp2000_cartesian(*, time_expr=None, thresh: float = 1e-6,
                      series_op: bool = False):
    """Geocentric Cartesian Moon position [km], mean ecliptic/equinox of
    date."""
    r, U, V = elp2000_spherical(time_expr=time_expr, thresh=thresh,
                                series_op=series_op)
    cU, sU = cos(U), sin(U)
    cV, sV = cos(V), sin(V)
    rcU = r * cU
    return [rcU * cV, rcU * sV, r * sU]


def elp2000_cartesian_e2000(*, time_expr=None, thresh: float = 1e-6,
                            series_op: bool = False):
    """Cartesian Moon position [km] in the inertial mean ecliptic of J2000
    (Laskar precession rotation)."""
    tm = _time_expr if time_expr is None else expr(time_expr)
    x, y, z = elp2000_cartesian(time_expr=tm, thresh=thresh,
                                series_op=series_op)
    P = _horner(_LASKAR_P, tm)
    Q = _horner(_LASKAR_Q, tm)
    P2, Q2, PQ = P * P, Q * Q, P * Q
    w = sqrt(1.0 - P2 - Q2)
    return [
        _sum([(1.0 - 2.0 * P2) * x, 2.0 * PQ * y, 2.0 * P * w * z]),
        _sum([2.0 * PQ * x, (1.0 - 2.0 * Q2) * y, -2.0 * Q * w * z]),
        _sum([-2.0 * P * w * x, 2.0 * Q * w * y, (1.0 - 2.0 * P2 - 2.0 * Q2) * z]),
    ]


def elp2000_cartesian_fk5(*, time_expr=None, thresh: float = 1e-6,
                          series_op: bool = False):
    """Cartesian Moon position [km] in the FK5 (mean equator/equinox of
    J2000) frame."""
    x, y, z = elp2000_cartesian_e2000(time_expr=time_expr, thresh=thresh,
                                      series_op=series_op)
    return [
        _sum([x, 0.000000437913 * y, -0.000000189859 * z]),
        _sum([-0.000000477299 * x, 0.917482137607 * y, -0.397776981701 * z]),
        _sum([0.397776981701 * y, 0.917482137607 * z]),
    ]


def get_elp2000_mus():
    """(mu_Earth, mu_Moon) of the theory, in m^3/s^2."""
    return (3.986005e14, 4902794214578.239)
