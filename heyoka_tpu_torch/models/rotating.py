"""Dynamics in a uniformly rotating reference frame, copied from
``heyoka_tpu.models.rotating`` (reference: ``src/model/rotating.cpp``)."""

from __future__ import annotations

from ..expr.core import make_vars, expr, sum_expr


def _omega(omega):
    omega = [expr(w) for w in omega]
    if omega and len(omega) != 3:
        raise ValueError("omega must be a 3-vector (or empty)")
    return omega


def rotating(*, omega=()):
    """Free motion in a rotating frame: centripetal + Coriolis accelerations
    (``rotating_impl``, ``src/model/rotating.cpp:44-100``)."""
    omega = _omega(omega)
    x, y, z, vx, vy, vz = make_vars("x", "y", "z", "vx", "vy", "vz")
    ax, ay, az = [], [], []
    if omega:
        pe, qe, re = omega
        # -(w x (w x r)) centripetal
        ax += [qe * (qe * x), re * (re * x), -(pe * (qe * y)), -(pe * (re * z))]
        ay += [pe * pe * y, re * re * y, -(pe * (qe * x)), -(qe * (re * z))]
        az += [pe * pe * z, qe * qe * z, -(pe * (re * x)), -(re * (qe * y))]
        # -2 (w x v) Coriolis
        ax.append(-2.0 * (qe * vz - re * vy))
        ay.append(-2.0 * (re * vx - pe * vz))
        az.append(-2.0 * (pe * vy - qe * vx))
    return [
        (x, vx),
        (y, vy),
        (z, vz),
        (vx, sum_expr(ax)),
        (vy, sum_expr(ay)),
        (vz, sum_expr(az)),
    ]


def rotating_potential(*, omega=()):
    """Centrifugal potential 0.5*((w.r)^2 - w^2 r^2)
    (``rotating_potential_impl``)."""
    omega = _omega(omega)
    x, y, z = make_vars("x", "y", "z")
    if not omega:
        return expr(0.0)
    pe, qe, re = omega
    wr = sum_expr([pe * x, qe * y, re * z])
    w2 = pe * pe + qe * qe + re * re
    r2 = x * x + y * y + z * z
    return 0.5 * (wr * wr - w2 * r2)


def rotating_energy(*, omega=()):
    x, y, z, vx, vy, vz = make_vars("x", "y", "z", "vx", "vy", "vz")
    kin = 0.5 * (vx * vx + vy * vy + vz * vz)
    return kin + rotating_potential(omega=omega)
