"""Geodetic <-> Cartesian coordinate conversions as expressions, copied
from ``heyoka_tpu.models.cart2geo``.

Reference parity: ``model::cart2geo`` / ``model::geo2cart``
(``include/heyoka/model/cart2geo.hpp``, ``src/model/cart2geo.cpp``):
fixed-iteration geodetic latitude/height recovery over an oblate spheroid
(WGS84 defaults), returned as ``[h, phi, lon]``.
"""

from __future__ import annotations

import math

from ..expr.core import expr
from ..expr.math import atan, atan2, cos, sin, sqrt

__all__ = ["cart2geo", "geo2cart", "A_EARTH", "B_EARTH"]

#: WGS84 equatorial / polar radii [m]
A_EARTH = 6378137.0
B_EARTH = 6356752.314245
_ECC2_WGS84 = 1.0 - (B_EARTH * B_EARTH) / (A_EARTH * A_EARTH)


def _checks(ecc2, R_eq, n_iters):
    if not (math.isfinite(ecc2) and ecc2 >= 0.0):
        raise ValueError("ecc2 must be finite and non-negative")
    if not (math.isfinite(R_eq) and R_eq > 0.0):
        raise ValueError("R_eq must be finite and positive")
    if n_iters < 1:
        raise ValueError("n_iters must be strictly positive")


def cart2geo(xyz, *, ecc2: float = _ECC2_WGS84, R_eq: float = A_EARTH,
             n_iters: int = 4):
    """``[h, phi, lon]`` geodetic coordinates of the Cartesian (body-fixed)
    position ``xyz``; ``n_iters`` fixed-point refinements of the latitude."""
    _checks(ecc2, R_eq, int(n_iters))
    x, y, z = (expr(c) for c in xyz)
    lon = atan2(y, x)
    p = sqrt(x * x + y * y)
    phi = atan(z / (p * (1.0 - ecc2)))
    h = N = None
    for _ in range(int(n_iters)):
        N = R_eq / sqrt(1.0 - ecc2 * sin(phi) * sin(phi))
        h = p / cos(phi) - N
        phi = atan(z / (p * (1.0 - ecc2 * N / (N + h))))
    return [h, phi, lon]


def geo2cart(geo, *, ecc2: float = _ECC2_WGS84, R_eq: float = A_EARTH):
    """Cartesian position of the geodetic coordinates ``[h, phi, lon]``."""
    _checks(ecc2, R_eq, 1)
    h, phi, lon = (expr(c) for c in geo)
    cphi, sphi = cos(phi), sin(phi)
    N = R_eq / sqrt(1.0 - ecc2 * sphi * sphi)
    rho = (N + h) * cphi
    return [rho * cos(lon), rho * sin(lon), ((1.0 - ecc2) * N + h) * sphi]
