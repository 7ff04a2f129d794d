"""Fixed-centres model, copied from ``heyoka_tpu.models.fixed_centres``
(reference: ``src/model/fixed_centres.cpp``)."""

from __future__ import annotations

import numpy as np

from ..expr.core import make_vars, expr, sum_expr
from ..expr.math import sqrt


def _check(masses, positions):
    positions = np.asarray(positions, dtype=object).reshape(-1)
    if len(positions) % 3:
        raise ValueError("positions must be a flat (3*n) sequence")
    if len(positions) // 3 != len(masses):
        raise ValueError("number of masses != number of position vectors")
    return list(positions)


def fixed_centres(*, Gconst=1.0, masses=(), positions=()):
    """Test particle in the field of fixed point masses
    (``fixed_centres_impl``, ``src/model/fixed_centres.cpp:52-95``)."""
    positions = _check(masses, positions)
    G = expr(Gconst)
    x, y, z, vx, vy, vz = make_vars("x", "y", "z", "vx", "vy", "vz")
    ax, ay, az = [], [], []
    for i, m in enumerate(masses):
        dx = expr(positions[3 * i]) - x
        dy = expr(positions[3 * i + 1]) - y
        dz = expr(positions[3 * i + 2]) - z
        d2 = dx * dx + dy * dy + dz * dz
        Mrm3 = expr(m) * d2 ** (-1.5)
        ax.append(dx * Mrm3)
        ay.append(dy * Mrm3)
        az.append(dz * Mrm3)
    return [
        (x, vx),
        (y, vy),
        (z, vz),
        (vx, G * sum_expr(ax)),
        (vy, G * sum_expr(ay)),
        (vz, G * sum_expr(az)),
    ]


def fixed_centres_potential(*, Gconst=1.0, masses=(), positions=()):
    positions = _check(masses, positions)
    G = expr(Gconst)
    x, y, z = make_vars("x", "y", "z")
    pot = []
    for i, m in enumerate(masses):
        dx = expr(positions[3 * i]) - x
        dy = expr(positions[3 * i + 1]) - y
        dz = expr(positions[3 * i + 2]) - z
        pot.append(expr(m) / sqrt(dx * dx + dy * dy + dz * dz))
    return -G * sum_expr(pot)


def fixed_centres_energy(*, Gconst=1.0, masses=(), positions=()):
    vx, vy, vz = make_vars("vx", "vy", "vz")
    kin = 0.5 * (vx * vx + vy * vy + vz * vz)
    return kin + fixed_centres_potential(
        Gconst=Gconst, masses=masses, positions=positions
    )
