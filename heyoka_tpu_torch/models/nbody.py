"""Newtonian N-body models, copied from ``heyoka_tpu.models.nbody``
(reference: ``src/model/nbody.cpp``): the inertial ``nbody`` and the
heliocentric ``np1body``.

Variables: ``x_i y_i z_i vx_i vy_i vz_i`` per body.  ``masses`` may be
shorter than ``n``: trailing bodies are massless test particles (they feel
but do not exert gravity).
"""

from __future__ import annotations

from ..expr.core import Variable, expr, sum_expr
from ..expr.math import sqrt


def _vars(n):
    xs = [Variable(f"x_{i}") for i in range(n)]
    ys = [Variable(f"y_{i}") for i in range(n)]
    zs = [Variable(f"z_{i}") for i in range(n)]
    vxs = [Variable(f"vx_{i}") for i in range(n)]
    vys = [Variable(f"vy_{i}") for i in range(n)]
    vzs = [Variable(f"vz_{i}") for i in range(n)]
    return xs, ys, zs, vxs, vys, vzs


def _norm_masses(n, masses):
    if masses is None:
        masses = [1.0] * n
    ms = [expr(m) for m in masses]
    if len(ms) > n:
        raise ValueError("more masses than bodies")
    return ms


def nbody(n: int, *, Gconst=1.0, masses=None):
    """Full N-body problem in an inertial frame (``nbody_impl``)."""
    n = int(n)
    if n < 2:
        raise ValueError("at least 2 bodies are needed")
    G = expr(Gconst)
    ms = _norm_masses(n, masses)
    n_massive = len(ms)

    xs, ys, zs, vxs, vys, vzs = _vars(n)

    acc = [[[] for _ in range(n)] for _ in range(3)]  # acc[axis][body] -> terms

    for i in range(n):
        for j in range(i + 1, n):
            dx = xs[j] - xs[i]
            dy = ys[j] - ys[i]
            dz = zs[j] - zs[i]
            r2 = dx * dx + dy * dy + dz * dz
            r_m3 = r2 ** (-1.5)
            # acceleration on i due to j (if j massive), and on j due to i
            if j < n_massive:
                fac_j = G * ms[j] * r_m3
                acc[0][i].append(dx * fac_j)
                acc[1][i].append(dy * fac_j)
                acc[2][i].append(dz * fac_j)
            if i < n_massive:
                fac_i = G * ms[i] * r_m3
                acc[0][j].append(-(dx * fac_i))
                acc[1][j].append(-(dy * fac_i))
                acc[2][j].append(-(dz * fac_i))

    sys = []
    for i in range(n):
        sys.append((xs[i], vxs[i]))
        sys.append((ys[i], vys[i]))
        sys.append((zs[i], vzs[i]))
        sys.append((vxs[i], sum_expr(acc[0][i])))
        sys.append((vys[i], sum_expr(acc[1][i])))
        sys.append((vzs[i], sum_expr(acc[2][i])))
    return sys


def nbody_potential(n: int, *, Gconst=1.0, masses=None):
    """Potential energy -G sum_{i<j} m_i m_j / r_ij (``nbody_potential_impl``)."""
    n = int(n)
    G = expr(Gconst)
    ms = _norm_masses(n, masses)
    n_massive = len(ms)
    xs, ys, zs, _, _, _ = _vars(n)
    terms = []
    for i in range(n_massive):
        for j in range(i + 1, n_massive):
            dx = xs[j] - xs[i]
            dy = ys[j] - ys[i]
            dz = zs[j] - zs[i]
            r = sqrt(dx * dx + dy * dy + dz * dz)
            terms.append(ms[i] * ms[j] / r)
    if not terms:
        return expr(0.0)
    return -G * sum_expr(terms)


def nbody_energy(n: int, *, Gconst=1.0, masses=None):
    """Total mechanical energy (``nbody_energy_impl``)."""
    n = int(n)
    ms = _norm_masses(n, masses)
    _, _, _, vxs, vys, vzs = _vars(n)
    kin_terms = [
        0.5 * ms[i] * (vxs[i] * vxs[i] + vys[i] * vys[i] + vzs[i] * vzs[i])
        for i in range(len(ms))
    ]
    return sum_expr(kin_terms) + nbody_potential(n, Gconst=Gconst, masses=masses)


def np1body(n: int, *, Gconst=1.0, masses=None):
    """(N+1)-body problem in the heliocentric frame of body 0
    (``np1body_impl``): state variables are the relative coordinates of
    bodies 1..n wrt body 0; ``masses`` holds n+1 entries (body 0 first)."""
    n = int(n)
    if n < 1:
        raise ValueError("at least 1 orbiting body is needed")
    G = expr(Gconst)
    if masses is None:
        masses = [1.0] * (n + 1)
    ms = [expr(m) for m in masses]
    if len(ms) != n + 1:
        raise ValueError("np1body requires n+1 masses (central body first)")

    xs = [Variable(f"x_{i}") for i in range(1, n + 1)]
    ys = [Variable(f"y_{i}") for i in range(1, n + 1)]
    zs = [Variable(f"z_{i}") for i in range(1, n + 1)]
    vxs = [Variable(f"vx_{i}") for i in range(1, n + 1)]
    vys = [Variable(f"vy_{i}") for i in range(1, n + 1)]
    vzs = [Variable(f"vz_{i}") for i in range(1, n + 1)]

    m0 = ms[0]
    sys = []
    for i in range(n):
        mu_i = G * (m0 + ms[i + 1])
        ri2 = xs[i] * xs[i] + ys[i] * ys[i] + zs[i] * zs[i]
        ri_m3 = ri2 ** (-1.5)
        ax = [-(mu_i * ri_m3) * xs[i]]
        ay = [-(mu_i * ri_m3) * ys[i]]
        az = [-(mu_i * ri_m3) * zs[i]]
        for j in range(n):
            if j == i:
                continue
            dx = xs[j] - xs[i]
            dy = ys[j] - ys[i]
            dz = zs[j] - zs[i]
            dij2 = dx * dx + dy * dy + dz * dz
            dij_m3 = dij2 ** (-1.5)
            rj2 = xs[j] * xs[j] + ys[j] * ys[j] + zs[j] * zs[j]
            rj_m3 = rj2 ** (-1.5)
            Gmj = G * ms[j + 1]
            ax.append(Gmj * (dx * dij_m3 - xs[j] * rj_m3))
            ay.append(Gmj * (dy * dij_m3 - ys[j] * rj_m3))
            az.append(Gmj * (dz * dij_m3 - zs[j] * rj_m3))
        sys.append((xs[i], vxs[i]))
        sys.append((ys[i], vys[i]))
        sys.append((zs[i], vzs[i]))
        sys.append((vxs[i], sum_expr(ax)))
        sys.append((vys[i], sum_expr(ay)))
        sys.append((vzs[i], sum_expr(az)))
    return sys


def np1body_potential(n: int, *, Gconst=1.0, masses=None):
    """Potential energy in heliocentric coordinates (``np1body_potential_impl``)."""
    n = int(n)
    G = expr(Gconst)
    if masses is None:
        masses = [1.0] * (n + 1)
    ms = [expr(m) for m in masses]
    xs = [Variable(f"x_{i}") for i in range(1, n + 1)]
    ys = [Variable(f"y_{i}") for i in range(1, n + 1)]
    zs = [Variable(f"z_{i}") for i in range(1, n + 1)]
    terms = []
    for i in range(n):
        ri = sqrt(xs[i] * xs[i] + ys[i] * ys[i] + zs[i] * zs[i])
        terms.append(ms[0] * ms[i + 1] / ri)
        for j in range(i + 1, n):
            dx = xs[j] - xs[i]
            dy = ys[j] - ys[i]
            dz = zs[j] - zs[i]
            dij = sqrt(dx * dx + dy * dy + dz * dz)
            terms.append(ms[i + 1] * ms[j + 1] / dij)
    return -G * sum_expr(terms)


def np1body_energy(n: int, *, Gconst=1.0, masses=None):
    """Total energy in the heliocentric formulation (``np1body_energy_impl``):
    barycentric kinetic energy expressed through relative velocities."""
    n = int(n)
    if masses is None:
        masses = [1.0] * (n + 1)
    ms = [expr(m) for m in masses]
    vxs = [Variable(f"vx_{i}") for i in range(1, n + 1)]
    vys = [Variable(f"vy_{i}") for i in range(1, n + 1)]
    vzs = [Variable(f"vz_{i}") for i in range(1, n + 1)]
    mtot = sum_expr(ms)
    # kinetic energy: T = 1/2 sum_i m_i |v0 + u_i|^2 with sum_i m_i u_i +
    # m_tot v0 = 0 (barycentric frame), u_i the heliocentric velocities:
    # T = 1/2 sum m_i |u_i|^2 - |sum m_i u_i|^2 / (2 m_tot)
    px = sum_expr([ms[i + 1] * vxs[i] for i in range(n)])
    py = sum_expr([ms[i + 1] * vys[i] for i in range(n)])
    pz = sum_expr([ms[i + 1] * vzs[i] for i in range(n)])
    T = sum_expr(
        [
            0.5 * ms[i + 1] * (vxs[i] * vxs[i] + vys[i] * vys[i] + vzs[i] * vzs[i])
            for i in range(n)
        ]
    ) - (px * px + py * py + pz * pz) / (2.0 * mtot)
    return T + np1body_potential(n, Gconst=Gconst, masses=[m for m in ms])
