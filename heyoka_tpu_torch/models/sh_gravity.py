"""Spherical-harmonics gravity as symbolic expressions, copied from
``heyoka_tpu.models.sh_gravity``.

Reference parity: ``model::sh_gravity_pot/acc`` and ``model::egm2008_*``
(``include/heyoka/model/sh_gravity.hpp``, ``egm2008.hpp``,
``src/model/sh_gravity.cpp``, ``src/detail/egm2008.cpp``).

The potential/acceleration are assembled from the normalized Cunningham V/W
recursion (Montenbruck & Gill §3.2.4-3.2.5 adapted to fully-normalized C/S
coefficients): every V_nm/W_nm is an expression in the body-fixed Cartesian
coordinates, shared across the summation through the expression DAG, so the
decomposition CSE recovers the recursion structure and the tape holds the
minimal op set.

The EGM2008 coefficients ship as packaged data, the port's byte-identical
copy ``heyoka_tpu_torch/data/egm2008.npz`` (fully-normalized values up to
degree/order 150, mu = 3986004.415e8 m^3/s^2, a = 6378136.3 m).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..data import data_path
from ..expr.core import expr
from ..expr.math import sqrt as _sqrt, sum_ as _sum

__all__ = [
    "sh_gravity_pot",
    "sh_gravity_acc",
    "egm2008_pot",
    "egm2008_acc",
    "get_egm2008_mu",
    "get_egm2008_a",
    "get_egm2008_CS",
]


def _kd(a: int, b: int) -> float:
    return 1.0 if a == b else 0.0


def _vw_table(max_n: int, x, y, z, a):
    """Normalized V/W auxiliary expressions up to degree ``max_n``.

    Seeds V00 = a/r and climbs diagonally (sectorial seed) then vertically,
    with the normalization factors folded into double constants — same
    numerical scheme as the reference (``sh_gravity_impl_make_rec_map``,
    ``src/model/sh_gravity.cpp:217``).
    """
    r2 = x * x + y * y + z * z
    a_r2 = a / r2
    xa, ya, za = x * a_r2, y * a_r2, z * a_r2
    a2_r2 = a * a_r2
    a_r = a / _sqrt(r2)

    zero = expr(0.0)
    vw = {(0, 0): (a_r, zero)}
    for m in range(max_n):
        for n in range(m + 1, max_n + 1):
            Vp, Wp = vw[(n - 1, m)]
            f1 = math.sqrt((2.0 * n + 1) * (2.0 * n - 1) / ((n - m) * (n + m)))
            V = f1 * za * Vp
            W = f1 * za * Wp
            if n != m + 1:
                Vq, Wq = vw[(n - 2, m)]
                f2 = math.sqrt(
                    (2.0 * n + 1) * (n - m - 1.0) * (n + m - 1.0)
                    / ((n - m) * (n + m) * (2.0 * n - 3))
                )
                V = V - f2 * a2_r2 * Vq
                W = W - f2 * a2_r2 * Wq
            vw[(n, m)] = (V, W)
        # diagonal seed V/W_(m+1, m+1)
        Vm, Wm = vw[(m, m)]
        mp = m + 1
        f = math.sqrt(
            (2.0 - _kd(0, mp)) * (2.0 * mp + 1) / (2.0 * mp * (2.0 - _kd(0, m)))
        )
        vw[(mp, mp)] = (
            f * (xa * Vm - ya * Wm),
            f * (xa * Wm + ya * Vm),
        )
    return vw


def _check_nm(n: int, m: int):
    if m > n:
        raise ValueError(
            f"spherical harmonics order {m} is greater than the degree {n}"
        )


def _cs_entry(CS, i, j):
    c, s = CS(i, j) if callable(CS) else CS[(i, j)]
    return expr(c), expr(s)


def sh_gravity_pot(xyz, n: int, m: int | None = None, *, mu, a, CS):
    """Gravitational potential of a normalized spherical-harmonics field up
    to degree ``n`` and order ``m`` (reference ``sh_gravity_pot``).

    ``CS``: mapping or callable ``(deg, ord) -> (Cbar, Sbar)`` of fully
    normalized coefficients, consulted for every 0 <= ord <= min(m, deg),
    0 <= deg <= n (so C00 = 1 for the central term).
    """
    m = n if m is None else m
    _check_nm(n, m)
    x, y, z = (expr(c) for c in xyz)
    mu, a = expr(mu), expr(a)
    vw = _vw_table(n, x, y, z, a)

    terms = []
    for i in range(n + 1):
        for j in range(min(m, i) + 1):
            C, S = _cs_entry(CS, i, j)
            V, W = vw[(i, j)]
            terms.append(C * V + S * W)
    return (mu / a) * _sum(terms)


def sh_gravity_acc(xyz, n: int, m: int | None = None, *, mu, a, CS):
    """Cartesian acceleration of the normalized spherical-harmonics field
    (reference ``sh_gravity_acc``; Montenbruck & Gill §3.2.5 normalized)."""
    m = n if m is None else m
    _check_nm(n, m)
    x, y, z = (expr(c) for c in xyz)
    mu, a = expr(mu), expr(a)
    vw = _vw_table(n + 1, x, y, z, a)

    xs, ys, zs = [], [], []
    for i in range(n + 1):
        for j in range(min(m, i) + 1):
            C, S = _cs_entry(CS, i, j)

            cxy0 = math.sqrt(
                (2.0 - _kd(0, j)) * (2.0 * i + 1) * (2.0 + i + j) * (1.0 + i + j)
                / ((2.0 - _kd(0, j + 1)) * (2.0 * i + 3))
            )
            cz = (1.0 + i - j) * math.sqrt(
                (1.0 + i + j) * (2.0 * i + 1) / ((2.0 * i + 3) * (1.0 + i - j))
            )

            if j == 0:
                V, W = vw[(i + 1, 1)]
                xs.append(-C * cxy0 * V)
                ys.append(-C * cxy0 * W)
            else:
                cxy0 *= 0.5
                cxy1 = (
                    0.5 * (2.0 + i - j) * (1.0 + i - j)
                    * math.sqrt(
                        (2.0 - _kd(0, j)) * (2.0 * i + 1)
                        / ((2.0 - _kd(0, j - 1)) * (2.0 * i + 3)
                           * (2.0 + i - j) * (1.0 + i - j))
                    )
                )
                Vp, Wp = vw[(i + 1, j + 1)]
                Vm, Wm = vw[(i + 1, j - 1)]
                xs += [-C * cxy0 * Vp, -S * cxy0 * Wp, C * cxy1 * Vm, S * cxy1 * Wm]
                ys += [-C * cxy0 * Wp, S * cxy0 * Vp, -C * cxy1 * Wm, S * cxy1 * Vm]

            V, W = vw[(i + 1, j)]
            zs += [-C * cz * V, -S * cz * W]

    mu_a2 = mu / (a * a)
    return [mu_a2 * _sum(xs), mu_a2 * _sum(ys), mu_a2 * _sum(zs)]


# -- EGM2008 ------------------------------------------------------------------

@lru_cache(maxsize=1)
def _egm2008_data():
    with np.load(data_path("egm2008.npz")) as d:
        return {
            "CS": d["CS"],
            "mu": float(d["mu"]),
            "a": float(d["a"]),
            "n_min": int(d["n_min"]),
            "n_max": int(d["n_max"]),
        }


def get_egm2008_mu() -> float:
    return _egm2008_data()["mu"]


def get_egm2008_a() -> float:
    return _egm2008_data()["a"]


def get_egm2008_CS() -> np.ndarray:
    """The (11473, 2) fully-normalized (Cbar, Sbar) table, degree-major over
    degrees 2..150, order inner."""
    return _egm2008_data()["CS"]


def _egm2008_cs(i: int, j: int):
    """(Cbar, Sbar) of the EGM2008 model; degree 0 returns the central term,
    degree 1 vanishes (geocentric frame)."""
    if i == 0:
        return (1.0, 0.0) if j == 0 else (0.0, 0.0)
    if i == 1:
        return (0.0, 0.0)
    d = _egm2008_data()
    if i > d["n_max"]:
        raise ValueError(f"EGM2008 data available only up to degree {d['n_max']}")
    # flat offset of (i, j) with degree-major layout starting at degree 2
    off = (i - 2) * (i + 3) // 2 + j  # sum_{k=2}^{i-1}(k+1) = (i-2)(i+3)/2
    c, s = d["CS"][off]
    return (float(c), float(s))


def egm2008_pot(xyz, n: int, m: int | None = None, *, mu=None, a=None):
    """EGM2008 geopotential up to degree ``n``/order ``m`` (reference
    ``egm2008_pot``; SI units, geocentric ITRS coordinates)."""
    return sh_gravity_pot(
        xyz, n, m,
        mu=get_egm2008_mu() if mu is None else mu,
        a=get_egm2008_a() if a is None else a,
        CS=_egm2008_cs,
    )


def egm2008_acc(xyz, n: int, m: int | None = None, *, mu=None, a=None):
    """EGM2008 gravitational acceleration (reference ``egm2008_acc``)."""
    return sh_gravity_acc(
        xyz, n, m,
        mu=get_egm2008_mu() if mu is None else mu,
        a=get_egm2008_a() if a is None else a,
        CS=_egm2008_cs,
    )
