"""VSOP2013 semi-analytic planetary ephemeris as expressions (the port's
copy of ``heyoka_tpu/models/vsop2013.py``, numpy and the port's expression
layer only).

Reference parity: ``model::vsop2013_elliptic/cartesian[_icrf]`` and
``get_vsop2013_mus`` (``include/heyoka/model/vsop2013.hpp``,
``src/model/vsop2013.cpp``, series data ``src/detail/vsop2013/``).

The theory gives, per planet (1=Mercury .. 9=Pluto), Poisson series for the
six elliptic variables (a [AU], lambda, k, h, q, p): terms
``t^alpha * (S sin(phi) + C cos(phi))`` with ``phi`` an integer combination
of 17 secular arguments linear in time.  Input time: Julian *millenia* of
TDB since J2000.0.  ``vsop2013_cartesian`` converts to heliocentric
Cartesian state (AU, AU/d-free units: velocities in AU/millenium? no —
AU and AU/day-scaled by the theory's mu; see below) via Broucke's
equinoctial relations with :func:`heyoka_tpu_torch.kepF`;
``vsop2013_cartesian_icrf`` rotates from the dynamical J2000 frame to ICRS.

Data availability: the reference snapshot vendors only the planet-9 q/p
series; they ship in ``heyoka_tpu_torch/data/vsop2013_p9.npz`` (a
byte-identical copy of the JAX package's).  Additional planets are loaded
from ``$HEYOKA_TPU_VSOP2013_DATA/vsop2013_p{N}.npz`` — use
``tools/vsop2013_to_npz.py`` to convert the original IMCCE
``VSOP2013p{N}`` ASCII files; nothing is fetched.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
import numpy as np

from ..data import data_path
from ..expr.core import expr, time as _time_expr
from ..expr.math import cos, kepF, sin, sqrt, sum_ as _sum

__all__ = [
    "vsop2013_elliptic",
    "vsop2013_cartesian",
    "vsop2013_cartesian_icrf",
    "get_vsop2013_mus",
]

#: lambda_l secular arguments: (constant, linear) coefficients [rad, rad/mil]
_LAM = [
    (4.402608631669, 26087.90314068555),
    (3.176134461576, 10213.28554743445),
    (1.753470369433, 6283.075850353215),
    (6.203500014141, 3340.612434145457),
    (4.091360003050, 1731.170452721855),
    (1.713740719173, 1704.450855027201),
    (5.598641292287, 1428.948917844273),
    (2.805136360408, 1364.756513629990),
    (2.326989734620, 1361.923207632842),
    (0.599546107035, 529.6909615623250),
    (0.874018510107, 213.2990861084880),
    (5.481225395663, 74.78165903077800),
    (5.311897933164, 38.13297222612500),
    (0.0, 0.3595362285049309),
    (5.198466400630, 77713.7714481804),
    (1.627905136020, 84334.6615717837),
    (2.355555638750, 83286.9142477147),
]

#: G*m of the planets and the Sun in the theory's units (AU^3/day^2)
_GM_PL = [
    4.9125474514508118699e-11, 7.2434524861627027000e-10,
    8.9970116036316091182e-10, 9.5495351057792580598e-11,
    2.8253458420837780000e-07, 8.4597151856806587398e-08,
    1.2920249167819693900e-08, 1.5243589007842762800e-08,
    2.1886997654259696800e-12,
]
_GM_SUN = 2.9591220836841438269e-04


def get_vsop2013_mus():
    """[mu_Sun, mu_Mercury, ..., mu_Pluto] in AU^3/day^2."""
    return [_GM_SUN] + list(_GM_PL)


@lru_cache(maxsize=None)
def _planet_data(pl_idx: int):
    name = f"vsop2013_p{pl_idx}.npz"
    # packaged data first, then the external data directory
    try:
        with np.load(data_path(name)) as d:
            return {k: d[k] for k in d.files}
    except FileNotFoundError:
        pass
    ext = os.environ.get("HEYOKA_TPU_VSOP2013_DATA")
    if ext:
        p = os.path.join(ext, name)
        if os.path.exists(p):
            d = np.load(p)
            return {k: d[k] for k in d.files}
    return None


def vsop2013_elliptic(pl_idx: int, var_idx: int, *, time_expr=None,
                      thresh: float = 1e-9, series_op: bool = False):
    """Elliptic variable ``var_idx`` (1=a .. 6=p) of planet ``pl_idx`` as an
    expression of time (Julian TDB millenia since J2000).

    ``series_op=True`` packs the whole Poisson series into one dense
    :func:`heyoka_tpu_torch.expr.series.trig_series` tape op (requires
    ``time_expr`` affine in time): the tape stays a few dozen u-vars, the
    series' jet is kernel S1 on the card; see expr/series.py.
    """
    if not 1 <= pl_idx <= 9:
        raise ValueError(f"invalid planet index {pl_idx}: must be in [1, 9]")
    if not 1 <= var_idx <= 6:
        raise ValueError(f"invalid variable index {var_idx}: must be in [1, 6]")
    if not (math.isfinite(thresh) and thresh >= 0.0):
        raise ValueError(f"invalid vsop2013 threshold {thresh}")
    d = _planet_data(pl_idx)
    if d is None or f"v{var_idx}_a0_S" not in d:
        raise ValueError(
            f"VSOP2013 series data for planet {pl_idx}, variable {var_idx} "
            f"is not available: the reference snapshot ships only the "
            f"planet-9 q/p series; convert the IMCCE VSOP2013 files with "
            f"tools/vsop2013_to_npz.py and set HEYOKA_TPU_VSOP2013_DATA"
        )
    tm = _time_expr if time_expr is None else expr(time_expr)

    n_alpha = 0
    while f"v{var_idx}_a{n_alpha}_S" in d:
        n_alpha += 1

    if series_op:
        from ..expr.series import affine_in_time, trig_series

        if not affine_in_time(tm):
            raise ValueError(
                "series_op=True requires a time_expr affine in time"
            )
        lam0 = np.array([c0 for (c0, _c1) in _LAM])
        lam1 = np.array([c1 for (_c0, c1) in _LAM])
        # one CONSTANT-amplitude series op per t-power: the op's internal
        # window size is the max of amp/phase degrees, so folding t^alpha
        # inside would widen every per-order convolution to n_alpha rows
        # (mostly zeros); the Horner composition outside keeps the dense
        # work at the 2-row linear-argument minimum
        parts = []
        for alpha in range(n_alpha):
            idx = np.asarray(d[f"v{var_idx}_a{alpha}_idx"], float)
            S = d[f"v{var_idx}_a{alpha}_S"]
            C = d[f"v{var_idx}_a{alpha}_C"]
            keep = np.hypot(S, C) >= thresh
            if not keep.any():
                parts.append(expr(0.0))
                continue
            idx = idx[keep]
            Sk, Ck = S[keep], C[keep]
            # S sin(phi) + C cos(phi) = A sin(phi + delta)
            A = np.hypot(Sk, Ck)
            delta = np.arctan2(Ck, Sk)
            ph = np.stack([idx @ lam0 + delta, idx @ lam1], axis=1)
            # pure-constant rows (no argument): sin(pi/2) = 1
            const = ~idx.any(axis=1)
            ph[const, 0] = 0.5 * math.pi
            ph[const, 1] = 0.0
            amp = A.copy()
            amp[const] = Ck[const]
            parts.append(trig_series(tm, amp[:, None], ph))
        res = parts[-1]
        for g in reversed(parts[:-1]):
            res = res * tm + g
        return res

    lams = [c0 + tm * c1 for (c0, c1) in _LAM]

    parts = []
    for alpha in range(n_alpha):
        idx = d[f"v{var_idx}_a{alpha}_idx"]
        S = d[f"v{var_idx}_a{alpha}_S"]
        C = d[f"v{var_idx}_a{alpha}_C"]
        terms = []
        for i in range(idx.shape[0]):
            if math.hypot(S[i], C[i]) < thresh:
                continue
            comps = [
                lams[j] * float(idx[i, j]) for j in range(17) if idx[i, j]
            ]
            if comps:
                phi = _sum(comps)
                terms.append(float(S[i]) * sin(phi) + float(C[i]) * cos(phi))
            else:
                terms.append(expr(float(C[i])))
        parts.append(_sum(terms) if terms else expr(0.0))

    res = parts[-1]
    for g in reversed(parts[:-1]):
        res = res * tm + g
    return res


def vsop2013_cartesian(pl_idx: int, *, time_expr=None, thresh: float = 1e-9):
    """Heliocentric Cartesian state ``[x, y, z, vx, vy, vz]`` (AU, AU/day)
    of the planet in the dynamical frame of J2000, via Broucke's equinoctial
    relations (the reference follows the same 1972CeMec...5..303B route)."""
    a = vsop2013_elliptic(pl_idx, 1, time_expr=time_expr, thresh=thresh)
    lam = vsop2013_elliptic(pl_idx, 2, time_expr=time_expr, thresh=thresh)
    k = vsop2013_elliptic(pl_idx, 3, time_expr=time_expr, thresh=thresh)
    h = vsop2013_elliptic(pl_idx, 4, time_expr=time_expr, thresh=thresh)
    q_ = vsop2013_elliptic(pl_idx, 5, time_expr=time_expr, thresh=thresh)
    p_ = vsop2013_elliptic(pl_idx, 6, time_expr=time_expr, thresh=thresh)

    mu = _GM_SUN + _GM_PL[pl_idx - 1]

    # VSOP2013's (q, p) are sin(i/2)-based; convert to Broucke's tan(i/2)
    si22 = q_ * q_ + p_ * p_
    ci2 = sqrt(1.0 - si22)
    q = q_ / ci2
    p = p_ / ci2

    e2 = h * h + k * k
    e_quot = 1.0 + sqrt(1.0 - e2)
    F = kepF(h, k, lam)
    cF, sF = cos(F), sin(F)
    lam_F = (h * cF - k * sF) / e_quot
    X1 = a * (cF - k - h * lam_F)
    Y1 = a * (sF - h + k * lam_F)

    p2, q2 = p * p, q * q
    p2_m_q2 = p2 - q2
    p2_p_q2 = p2 + q2
    two_p, two_q = p + p, q + q
    two_pq = two_p * q

    x = (1.0 - p2_m_q2) * X1 + two_pq * Y1
    y = two_pq * X1 + (1.0 + p2_m_q2) * Y1
    z = two_q * Y1 - two_p * X1

    n = sqrt(mu / (a * a * a))
    Fp = n / (1.0 - h * sF - k * cF)
    n_Fp_equot = (n - Fp) / e_quot
    VX1 = a * (-sF * Fp - h * n_Fp_equot)
    VY1 = a * (cF * Fp + k * n_Fp_equot)
    vx = (1.0 - p2_m_q2) * VX1 + two_pq * VY1
    vy = two_pq * VX1 + (1.0 + p2_m_q2) * VY1
    vz = two_q * VY1 - two_p * VX1

    quot = 1.0 + p2_p_q2
    return [x / quot, y / quot, z / quot, vx / quot, vy / quot, vz / quot]


#: Dynamical J2000 -> ICRF rotation angles (VSOP2013 documentation)
_EPS_ICRF = 0.4090926265865962
_PHI_ICRF = -2.5152133775962285e-07


def vsop2013_cartesian_icrf(pl_idx: int, *, time_expr=None, thresh: float = 1e-9):
    """Heliocentric Cartesian state rotated into the ICRS frame."""
    c = vsop2013_cartesian(pl_idx, time_expr=time_expr, thresh=thresh)
    ce, se = math.cos(_EPS_ICRF), math.sin(_EPS_ICRF)
    cp, sp = math.cos(_PHI_ICRF), math.sin(_PHI_ICRF)

    def rot(x, y, z):
        return [
            cp * x - sp * ce * y + sp * se * z,
            sp * x + cp * ce * y - cp * se * z,
            se * y + ce * z,
        ]

    return rot(c[0], c[1], c[2]) + rot(c[3], c[4], c[5])
