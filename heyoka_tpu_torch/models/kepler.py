"""Keplerian helpers and the analytic Lagrange propagator, copied from
``heyoka_tpu.models.kepler`` (reference: ``src/model/lagrange_prop.cpp``; numeric element conversions used
throughout the reference's tests/tutorials)."""

from __future__ import annotations

import math

import numpy as np

from ..expr.core import Variable, expr, make_vars
from ..expr.math import kepDE, sqrt, sin, cos


def lagrange_prop(*, pos_0=None, vel_0=None, mu=1.0, tof=None):
    """Analytic two-body propagation via Lagrange f/g coefficients.

    Returns the 6 expressions [x, y, z, vx, vy, vz] at time-of-flight ``tof``
    from initial conditions ``pos_0``/``vel_0`` (default: the variables
    ``x0 y0 z0 vx0 vy0 vz0``), for elliptic motion — the universal-anomaly
    difference is obtained with ``kepDE`` like the reference
    (``src/model/lagrange_prop.cpp``).  ``tof`` defaults to ``heyoka.time``.
    """
    from ..expr.core import time as _time

    if pos_0 is None:
        pos_0 = make_vars("x0", "y0", "z0")
    if vel_0 is None:
        vel_0 = make_vars("vx0", "vy0", "vz0")
    if tof is None:
        tof = _time
    x0, y0, z0 = (expr(c) for c in pos_0)
    vx0, vy0, vz0 = (expr(c) for c in vel_0)
    mu_e = expr(mu)
    tof = expr(tof)

    r0 = sqrt(x0 * x0 + y0 * y0 + z0 * z0)
    v02 = vx0 * vx0 + vy0 * vy0 + vz0 * vz0
    # semi-major axis from vis-viva (elliptic orbits)
    ainv = 2.0 / r0 - v02 / mu_e
    a = 1.0 / ainv
    n = sqrt(mu_e * ainv * ainv * ainv)  # mean motion = sqrt(mu/a^3)
    sigma0 = (x0 * vx0 + y0 * vy0 + z0 * vz0) / sqrt(mu_e)
    sqrt_a = sqrt(a)

    s0 = sigma0 / sqrt_a
    c0 = 1.0 - r0 * ainv
    DM = n * tof
    DE = kepDE(s0, c0, DM)
    cDE = cos(DE)
    sDE = sin(DE)

    r = a + (r0 - a) * cDE + sigma0 * sqrt_a * sDE

    F = 1.0 - (a / r0) * (1.0 - cDE)
    G = tof + (sDE - DE) / n
    Ft = -(sqrt(mu_e * a) / (r * r0)) * sDE
    Gt = 1.0 - (a / r) * (1.0 - cDE)

    return [
        F * x0 + G * vx0,
        F * y0 + G * vy0,
        F * z0 + G * vz0,
        Ft * x0 + Gt * vx0,
        Ft * y0 + Gt * vy0,
        Ft * z0 + Gt * vz0,
    ]


# -- numeric element conversions (host-side helpers, numpy) -------------------

def kepler_to_cartesian(a, e, i, om, Om, nu, mu=1.0):
    """Classical orbital elements -> cartesian state (numpy floats)."""
    p = a * (1.0 - e * e)
    r = p / (1.0 + e * math.cos(nu))
    # perifocal
    xp = r * math.cos(nu)
    yp = r * math.sin(nu)
    vxp = -math.sqrt(mu / p) * math.sin(nu)
    vyp = math.sqrt(mu / p) * (e + math.cos(nu))
    cO, sO = math.cos(Om), math.sin(Om)
    co, so = math.cos(om), math.sin(om)
    ci, si = math.cos(i), math.sin(i)
    R = np.array(
        [
            [cO * co - sO * so * ci, -cO * so - sO * co * ci, sO * si],
            [sO * co + cO * so * ci, -sO * so + cO * co * ci, -cO * si],
            [so * si, co * si, ci],
        ]
    )
    rv = R @ np.array([xp, yp, 0.0])
    vv = R @ np.array([vxp, vyp, 0.0])
    return np.concatenate([rv, vv])


def cartesian_to_kepler(state, mu=1.0):
    """Cartesian state -> (a, e, i, om, Om, nu) (numpy floats)."""
    r = np.asarray(state[:3], dtype=float)
    v = np.asarray(state[3:6], dtype=float)
    rn = np.linalg.norm(r)
    vn2 = v @ v
    h = np.cross(r, v)
    hn = np.linalg.norm(h)
    nvec = np.cross([0.0, 0.0, 1.0], h)
    nn = np.linalg.norm(nvec)
    evec = ((vn2 - mu / rn) * r - (r @ v) * v) / mu
    e = np.linalg.norm(evec)
    a = 1.0 / (2.0 / rn - vn2 / mu)
    i = math.acos(np.clip(h[2] / hn, -1, 1))
    if nn > 0:
        Om = math.acos(np.clip(nvec[0] / nn, -1, 1))
        if nvec[1] < 0:
            Om = 2 * math.pi - Om
    else:
        Om = 0.0
    if nn > 0 and e > 1e-14:
        om = math.acos(np.clip(nvec @ evec / (nn * e), -1, 1))
        if evec[2] < 0:
            om = 2 * math.pi - om
    else:
        om = 0.0
    if e > 1e-14:
        nu = math.acos(np.clip(evec @ r / (e * rn), -1, 1))
        if r @ v < 0:
            nu = 2 * math.pi - nu
    else:
        nu = math.atan2((r / rn)[1], (r / rn)[0])
    return a, e, i, om, Om, nu
