"""Equations of motion from Lagrangians and Hamiltonians (a copy of
``heyoka_tpu.lagham``).

Reference parity: heyoka ``lagrangian()`` / ``hamiltonian()``
(``include/heyoka/lagrangian.hpp:21-24``, ``src/lagrangian.cpp``,
``src/hamiltonian.cpp``): symbolic Euler-Lagrange / Hamilton equations from a
user-supplied L(q, qdot, t) or H(q, p, t), with optional Rayleigh dissipation.
"""

from __future__ import annotations

from typing import Sequence

from .expr.core import Expr, Variable, expr, subs
from .expr.diff import diff


def _check_vars(vs, what):
    out = []
    for v in vs:
        if isinstance(v, str):
            v = Variable(v)
        if not isinstance(v, Variable):
            raise TypeError(f"{what} entries must be variables")
        out.append(v)
    if len({v.name for v in out}) != len(out):
        raise ValueError(f"duplicate {what}")
    return out


def lagrangian(L, qs: Sequence, qdots: Sequence, D=None) -> list:
    """Euler-Lagrange equations of motion.

    Returns the first-order ODE system ``[(q_i, qdot_i), (qdot_i, accel_i)]``.
    ``D`` is an optional Rayleigh dissipation function of the qdots
    (reference: ``src/lagrangian.cpp``).

    The E-L equations ``d/dt(dL/dqdot_i) = dL/dq_i - dD/dqdot_i`` are solved
    for the accelerations symbolically through the linear system given by the
    Hessian of L in the qdots; like the reference, this requires L to be
    non-degenerate in the velocities.  For the common mechanical form
    (Hessian diagonal and velocity-independent) the solve is exact and cheap.
    """
    L = expr(L)
    qs = _check_vars(qs, "qs")
    qdots = _check_vars(qdots, "qdots")
    if len(qs) != len(qdots):
        raise ValueError("qs and qdots must have equal length")
    n = len(qs)
    if D is not None:
        D = expr(D)

    # d/dt (dL/dqdot_i) = sum_j d2L/dqdot_i dq_j * qdot_j
    #                   + sum_j d2L/dqdot_i dqdot_j * qddot_j + d2L/dqdot_i dt
    # Solve M qddot = rhs with M_ij = d2L/dqdot_i dqdot_j.
    from .expr.core import TimeExpr

    dL_dq = [diff(L, q) for q in qs]
    dL_dqd = [diff(L, qd) for qd in qdots]

    M = [[diff(dL_dqd[i], qdots[j]) for j in range(n)] for i in range(n)]
    # velocity-and-time explicit part of d/dt(dL/dqdot_i)
    conv = []
    for i in range(n):
        c = sum(
            (diff(dL_dqd[i], qs[j]) * qdots[j] for j in range(n)),
            start=expr(0.0),
        )
        c = c + diff(dL_dqd[i], TimeExpr())
        conv.append(c)

    rhs = []
    for i in range(n):
        r = dL_dq[i] - conv[i]
        if D is not None:
            r = r - diff(D, qdots[i])
        rhs.append(r)

    accels = _solve_linear(M, rhs)

    sys = []
    for q, qd in zip(qs, qdots):
        sys.append((q, qd))
    for qd, a in zip(qdots, accels):
        sys.append((qd, a))
    return sys


def hamiltonian(H, qs: Sequence, ps: Sequence) -> list:
    """Hamilton's equations ``q_i' = dH/dp_i, p_i' = -dH/dq_i``
    (reference: ``src/hamiltonian.cpp``)."""
    H = expr(H)
    qs = _check_vars(qs, "qs")
    ps = _check_vars(ps, "ps")
    if len(qs) != len(ps):
        raise ValueError("qs and ps must have equal length")
    sys = []
    for q, p in zip(qs, ps):
        sys.append((q, diff(H, p)))
    for q, p in zip(qs, ps):
        sys.append((p, -diff(H, q)))
    return sys


def _solve_linear(M, rhs):
    """Symbolic Gaussian elimination (exact, with zero-literal pruning).

    Mass matrices from physical Lagrangians are small (n = #dof), and very
    often diagonal — both paths stay compact after constant folding.
    """
    from .expr.core import Number

    n = len(rhs)
    # fast path: diagonal M
    def is_zero(e):
        return isinstance(e, Number) and e.value == 0.0

    if all(is_zero(M[i][j]) for i in range(n) for j in range(n) if i != j):
        return [rhs[i] / M[i][i] for i in range(n)]

    # general symbolic elimination
    A = [[M[i][j] for j in range(n)] + [rhs[i]] for i in range(n)]
    for col in range(n):
        piv = None
        for r in range(col, n):
            if not is_zero(A[r][col]):
                piv = r
                break
        if piv is None:
            raise ValueError(
                "degenerate Lagrangian: velocity Hessian is symbolically singular"
            )
        A[col], A[piv] = A[piv], A[col]
        pd = A[col][col]
        for r in range(n):
            if r == col:
                continue
            f = A[r][col] / pd
            if is_zero(A[r][col]):
                continue
            for c in range(col, n + 1):
                A[r][c] = A[r][c] - f * A[col][c]
    return [A[i][n] / A[i][i] for i in range(n)]
