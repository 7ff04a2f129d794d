"""Pendulum model (a copy of ``heyoka_tpu.models.pendulum``; reference:
``src/model/pendulum.cpp``)."""

from __future__ import annotations

from ..expr.core import make_vars, expr
from ..expr.math import sin, cos


def pendulum(*, gconst=9.8, length=1.0, mass=1.0):
    """ODE system of the simple pendulum: x' = v, v' = -g/l sin(x)
    (``pendulum_impl``, ``src/model/pendulum.cpp:26-28``)."""
    x, v = make_vars("x", "v")
    return [(x, v), (v, -expr(gconst) / expr(length) * sin(x))]


def pendulum_energy(*, gconst=9.8, length=1.0, mass=1.0):
    """Total energy E = 1/2 m l^2 v^2 + m g l (1 - cos x)."""
    x, v = make_vars("x", "v")
    m, g, l = expr(mass), expr(gconst), expr(length)
    return 0.5 * m * l * l * v * v + m * g * l * (1.0 - cos(x))
