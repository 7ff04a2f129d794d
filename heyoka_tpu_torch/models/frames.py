"""Reference-frame transformations as expressions (the port's copy of
``heyoka_tpu/models/frames.py``, over the port's ``iau2006`` and EOP
interpolants).

Reference parity: ``model::rot_fk5j2000_icrs/rot_icrs_fk5j2000``,
``rot_itrs_icrs``/``rot_icrs_itrs`` (IAU2006 CIO-based chain through
TIRS/CIRS), ``rot_itrs_teme``/``rot_teme_itrs`` (GMST82-based), and the RSW
helpers ``state_to_rsw[_inertial]`` / ``state_from_rsw[_inertial]``
(``include/heyoka/model/frame_transformations.hpp``,
``src/model/frame_transformations.cpp``, ``frame_transformations_rsw.cpp``).

All time expressions are TT Julian centuries since J2000.0.
"""

from __future__ import annotations

import math

import numpy as np

from ..eop_sw import EOPData
from ..expr.core import expr
from ..expr.math import cos, sin, sqrt, sum_ as _sum
from .eop import dX as _dX, dY as _dY, era as _era, gmst82 as _gmst82
from .eop import pm_x as _pm_x, pm_y as _pm_y
from .iau2006 import iau2006

__all__ = [
    "rot_fk5j2000_icrs",
    "rot_icrs_fk5j2000",
    "rot_itrs_icrs",
    "rot_icrs_itrs",
    "rot_itrs_teme",
    "rot_teme_itrs",
    "state_to_rsw",
    "state_to_rsw_inertial",
    "state_from_rsw",
    "state_from_rsw_inertial",
]

_ARCSEC = math.pi / (180.0 * 3600.0)


def _fk5_icrs_matrix() -> np.ndarray:
    """FK5(J2000) -> ICRS rotation from the published FK5-ICRS orientation
    (Mignard & Froeschle / IERS): pole offsets eta0 = -19.9 mas,
    xi0 = +9.1 mas and right-ascension offset dalpha0 = -22.9 mas."""
    mas = _ARCSEC / 1000.0
    eta0 = -19.9 * mas
    xi0 = 9.1 * mas
    da0 = -22.9 * mas

    def rx(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])

    def ry(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])

    def rz(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])

    return rz(-da0) @ ry(-xi0) @ rx(eta0)


_FK5_ICRS = _fk5_icrs_matrix()


def _matvec(R, xyz):
    return [
        _sum([R[i][0] * xyz[0], R[i][1] * xyz[1], R[i][2] * xyz[2]])
        for i in range(3)
    ]


def _matvec_T(R, xyz):
    return [
        _sum([R[0][i] * xyz[0], R[1][i] * xyz[1], R[2][i] * xyz[2]])
        for i in range(3)
    ]


def rot_fk5j2000_icrs(xyz):
    """Rotate a vector from FK5 at J2000.0 into ICRS (constant frame bias)."""
    xyz = [expr(c) for c in xyz]
    return _matvec(_FK5_ICRS.tolist(), xyz)


def rot_icrs_fk5j2000(xyz):
    xyz = [expr(c) for c in xyz]
    return _matvec_T(_FK5_ICRS.tolist(), xyz)


def _polar_motion_matrix(time_expr, data):
    """ITRS -> TIRS rotation W^T: R3(-s') R2(x_p) R1(y_p) applied inversely
    (IERS Conventions 5.4.1)."""
    x_p = _pm_x(time_expr=time_expr, eop_data=data)
    y_p = _pm_y(time_expr=time_expr, eop_data=data)
    sp = -0.000047 * _ARCSEC  # s' (TIO locator), linear model folded constant
    cxp, sxp = cos(x_p), sin(x_p)
    cyp, syp = cos(y_p), sin(y_p)
    csp, ssp = math.cos(sp), math.sin(sp)
    return [
        [cxp * csp, -cyp * ssp + syp * sxp * csp, -syp * ssp - cyp * sxp * csp],
        [cxp * ssp, cyp * csp + syp * sxp * ssp, syp * csp - cyp * sxp * ssp],
        [sxp, -syp * cxp, cyp * cxp],
    ]


def _pn_matrix(time_expr, thresh, data):
    """CIRS -> ICRS precession-nutation matrix (IERS Conventions 5.4.4) and
    the EOP-corrected CIO locator s."""
    X_pn, Y_pn, s_pn = iau2006(time_expr=time_expr, thresh=thresh)
    DX = _dX(time_expr=time_expr, eop_data=data)
    DY = _dY(time_expr=time_expr, eop_data=data)
    X = X_pn + DX
    Y = Y_pn + DY
    # s + XY/2 is invariant under the (dX, dY) correction
    s = s_pn - 0.5 * _sum([X_pn * DY, Y_pn * DX, DX * DY])
    X2, Y2 = X * X, Y * Y
    X2_p_Y2 = X2 + Y2
    a = 0.5 + 0.125 * X2_p_Y2
    R = [
        [1.0 - a * X2, -a * (X * Y), X],
        [-a * (X * Y), 1.0 - a * Y2, Y],
        [-expr(X), -expr(Y), 1.0 - a * X2_p_Y2],
    ]
    return R, s


def rot_itrs_icrs(xyz, *, time_expr=None, thresh: float = 1e-6, eop_data=None):
    """Rotate a vector from ITRS to ICRS via the IAU2006 CIO chain
    ITRS -> TIRS (polar motion) -> CIRS (ERA) -> ICRS (X, Y, s)."""
    data = EOPData() if eop_data is None else eop_data
    xyz = [expr(c) for c in xyz]
    # ITRS -> TIRS
    xyz = _matvec(_polar_motion_matrix(time_expr, data), xyz)
    # TIRS -> CIRS: R3(-era)
    alpha = -_era(time_expr=time_expr, eop_data=data)
    ca, sa = cos(alpha), sin(alpha)
    xyz = [ca * xyz[0] + sa * xyz[1], ca * xyz[1] - sa * xyz[0], xyz[2]]
    # CIRS -> ICRS: R3(s) then the PN matrix
    R, s = _pn_matrix(time_expr, thresh, data)
    cs, ss = cos(s), sin(s)
    xyz = [cs * xyz[0] + ss * xyz[1], cs * xyz[1] - ss * xyz[0], xyz[2]]
    return _matvec(R, xyz)


def rot_icrs_itrs(xyz, *, time_expr=None, thresh: float = 1e-6, eop_data=None):
    """Inverse of :func:`rot_itrs_icrs`."""
    data = EOPData() if eop_data is None else eop_data
    xyz = [expr(c) for c in xyz]
    R, s = _pn_matrix(time_expr, thresh, data)
    xyz = _matvec_T(R, xyz)
    cs, ss = cos(s), sin(s)
    xyz = [cs * xyz[0] - ss * xyz[1], ss * xyz[0] + cs * xyz[1], xyz[2]]
    alpha = -_era(time_expr=time_expr, eop_data=data)
    ca, sa = cos(alpha), sin(alpha)
    xyz = [ca * xyz[0] - sa * xyz[1], sa * xyz[0] + ca * xyz[1], xyz[2]]
    return _matvec_T(_polar_motion_matrix(time_expr, data), xyz)


def _teme_matrix(time_expr, data):
    """ITRS -> TEME rotation: polar motion with R3 over GMST82 instead of
    the TIO locator (the classical TEME convention)."""
    x_p = _pm_x(time_expr=time_expr, eop_data=data)
    y_p = _pm_y(time_expr=time_expr, eop_data=data)
    g = _gmst82(time_expr=time_expr, eop_data=data)
    cxp, sxp = cos(x_p), sin(x_p)
    cyp, syp = cos(y_p), sin(y_p)
    cg, sg = cos(g), sin(g)
    return [
        [cxp * cg, -cyp * sg + syp * sxp * cg, -syp * sg - cyp * sxp * cg],
        [cxp * sg, cyp * cg + syp * sxp * sg, syp * cg - cyp * sxp * sg],
        [sxp, -syp * cxp, cyp * cxp],
    ]


def rot_itrs_teme(xyz, *, time_expr=None, eop_data=None):
    data = EOPData() if eop_data is None else eop_data
    return _matvec(_teme_matrix(time_expr, data), [expr(c) for c in xyz])


def rot_teme_itrs(xyz, *, time_expr=None, eop_data=None):
    data = EOPData() if eop_data is None else eop_data
    return _matvec_T(_teme_matrix(time_expr, data), [expr(c) for c in xyz])


# ---------------------------------------------------------------------------
# RSW (radial / along-track / cross-track) helpers
# ---------------------------------------------------------------------------

def _cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _norm(v):
    return sqrt(_sum([v[0] * v[0], v[1] * v[1], v[2] * v[2]]))


def _rsw_basis(r, v):
    rn = _norm(r)
    u_r = [c / rn for c in r]
    rxv = _cross(r, v)
    wn = _norm(rxv)
    u_w = [c / wn for c in rxv]
    u_s = _cross(u_w, u_r)
    return [u_r, u_s, u_w]


def _kepler_omega_rsw(r, v):
    """Keplerian angular velocity in the RSW basis: along W, |r x v| / r^2."""
    rxv = _cross(r, v)
    wn = _norm(rxv)
    r2 = _sum([r[0] * r[0], r[1] * r[1], r[2] * r[2]])
    return [expr(0.0), expr(0.0), wn / r2]


def _prep(pos, vel, r, v):
    return ([expr(c) for c in pos], [expr(c) for c in vel],
            [expr(c) for c in r], [expr(c) for c in v])


def state_to_rsw(pos, vel, r, v):
    """Express (pos, vel) relative to the osculating state (r, v) in the
    co-rotating RSW frame (includes the Keplerian transport term)."""
    pos, vel, r, v = _prep(pos, vel, r, v)
    R = _rsw_basis(r, v)
    omega = _kepler_omega_rsw(r, v)
    dp = [pos[i] - r[i] for i in range(3)]
    dv = [vel[i] - v[i] for i in range(3)]
    p_r = _matvec(R, dp)
    v_r = _matvec(R, dv)
    wx = _cross(omega, p_r)
    return [p_r, [v_r[i] - wx[i] for i in range(3)]]


def state_to_rsw_inertial(pos, vel, r, v):
    """As :func:`state_to_rsw` but treating the RSW axes as inertial: the
    position is taken relative to ``r`` while the velocity is the rotated
    *absolute* velocity (no transport term)."""
    pos, vel, r, v = _prep(pos, vel, r, v)
    R = _rsw_basis(r, v)
    dp = [pos[i] - r[i] for i in range(3)]
    return [_matvec(R, dp), _matvec(R, vel)]


def state_from_rsw(pos, vel, r, v):
    """Inverse of :func:`state_to_rsw`."""
    pos, vel, r, v = _prep(pos, vel, r, v)
    R = _rsw_basis(r, v)
    omega = _kepler_omega_rsw(r, v)
    p_abs = [_sum([R[0][i] * pos[0], R[1][i] * pos[1], R[2][i] * pos[2], r[i]]) for i in range(3)]
    wv = _cross(omega, pos)
    t = [vel[i] + wv[i] for i in range(3)]
    v_abs = [
        _sum([R[0][i] * t[0], R[1][i] * t[1], R[2][i] * t[2]]) + v[i]
        for i in range(3)
    ]
    return [p_abs, v_abs]


def state_from_rsw_inertial(pos, vel, r, v):
    """Inverse of :func:`state_to_rsw_inertial`."""
    pos, vel, r, v = _prep(pos, vel, r, v)
    R = _rsw_basis(r, v)
    p_abs = [_sum([R[0][i] * pos[0], R[1][i] * pos[1], R[2][i] * pos[2], r[i]]) for i in range(3)]
    v_abs = [_matvec_T(R, vel)[i] for i in range(3)]
    return [p_abs, v_abs]
