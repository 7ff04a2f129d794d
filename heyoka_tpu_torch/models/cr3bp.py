"""Circular restricted three-body problem, copied from
``heyoka_tpu.models.cr3bp`` (reference: ``src/model/cr3bp.cpp``).

Rotating (synodic) frame, canonical Hamiltonian formulation with momenta
px, py, pz; ``mu`` is the mass parameter.  Primary of mass (1-mu) at
(mu, 0, 0); secondary of mass mu at (mu-1, 0, 0) — identical conventions to
the reference (``cr3bp_impl``, ``src/model/cr3bp.cpp:51-83``).
"""

from __future__ import annotations

from ..expr.core import make_vars, expr


def cr3bp(*, mu=1e-3):
    mu_ = expr(mu)
    px, py, pz, x, y, z = make_vars("px", "py", "pz", "x", "y", "z")

    x_m_mu = x - mu_
    x_m_mu_p1 = x_m_mu + 1.0
    y_p_z_2 = y * y + z * z
    rp1_2 = x_m_mu * x_m_mu + y_p_z_2
    rp2_2 = x_m_mu_p1 * x_m_mu_p1 + y_p_z_2
    g1 = (1.0 - mu_) * rp1_2 ** (-1.5)
    g2 = mu_ * rp2_2 ** (-1.5)
    g1_g2 = g1 + g2

    return [
        (x, px + y),
        (y, py - x),
        (z, pz),
        (px, py - g1 * x_m_mu - g2 * x_m_mu_p1),
        (py, -px - g1_g2 * y),
        (pz, -g1_g2 * z),
    ]


def cr3bp_jacobi(*, mu=1e-3):
    """The Jacobi constant / Hamiltonian (``cr3bp_jacobi_impl``)."""
    from ..expr.math import sqrt

    mu_ = expr(mu)
    px, py, pz, x, y, z = make_vars("px", "py", "pz", "x", "y", "z")
    x_m_mu = x - mu_
    x_m_mu_p1 = x_m_mu + 1.0
    y_p_z_2 = y * y + z * z
    rp1_2 = x_m_mu * x_m_mu + y_p_z_2
    rp2_2 = x_m_mu_p1 * x_m_mu_p1 + y_p_z_2
    g1 = (1.0 - mu_) / sqrt(rp1_2)
    g2 = mu_ / sqrt(rp2_2)
    kin = 0.5 * (px * px + py * py + pz * pz)
    return kin + y * px - x * py - g1 - g2


def pcr3bp(*, mu=1e-3):
    """Planar CR3BP (the z/pz-free reduction; used by the reference's
    variational-equation tests, ``test/taylor_adaptive_var.cpp``)."""
    mu_ = expr(mu)
    px, py, x, y = make_vars("px", "py", "x", "y")
    x_m_mu = x - mu_
    x_m_mu_p1 = x_m_mu + 1.0
    rp1_2 = x_m_mu * x_m_mu + y * y
    rp2_2 = x_m_mu_p1 * x_m_mu_p1 + y * y
    g1 = (1.0 - mu_) * rp1_2 ** (-1.5)
    g2 = mu_ * rp2_2 ** (-1.5)
    g1_g2 = g1 + g2
    return [
        (x, px + y),
        (y, py - x),
        (px, py - g1 * x_m_mu - g2 * x_m_mu_p1),
        (py, -px - g1_g2 * y),
    ]
