"""High-fidelity Earth-orbit dynamics factory (the port's copy of
``heyoka_tpu/models/eo_dynamics.py``).

Reference parity: ``model::eo_dynamics``
(``include/heyoka/model/eo_dynamics.hpp``, ``src/model/eo_dynamics.cpp``):
Cartesian GCRS dynamics of an Earth satellite with

- EGM2008 geopotential up to ``max_geo_degree``/``max_geo_order`` (evaluated
  in the ITRS through the IAU2006 rotation chain; Keplerian monopole when
  degree = order = 0),
- optional NRLMSISE00-thermoNET atmospheric drag (kwarg ``Cb`` = ballistic
  coefficient in m^2/kg; space-weather indices from ``sw_data``, co-rotating
  atmosphere velocity obtained by differentiating the ITRS->GCRS rotation in
  time),
- optional Sun/Moon third-body perturbations (``elp2000_thresh`` +
  ``vsop2013_thresh``; Moon from ELP2000, Earth-Sun geometry from the
  VSOP2013 EMB series — requires the planet-3 dataset, which neither
  package ships, so the branch raises, see :mod:`.vsop2013`).

Units: km, km/s, seconds of TT since J2000 as the time coordinate.
"""

from __future__ import annotations

from ..eop_sw import EOPData, SWData
from ..expr.core import Variable, expr, make_vars, subs, time as _time_expr
from ..expr.diff import diff
from ..expr.math import sqrt, sum_ as _sum
from .cart2geo import A_EARTH, cart2geo
from .dayfrac import dayfrac
from .elp2000 import elp2000_cartesian_fk5
from .fixed_centres import fixed_centres
from .frames import rot_fk5j2000_icrs, rot_icrs_itrs, rot_itrs_icrs
from .sh_gravity import egm2008_acc, get_egm2008_a, get_egm2008_mu
from .sw import Ap_avg, f107, f107a_center81
from .thermonets import nrlmsise00_tn
from .vsop2013 import vsop2013_cartesian_icrf

__all__ = ["eo_dynamics"]

_SECS_IN_DAY = 86400.0
_SECS_IN_CY = _SECS_IN_DAY * 365.25 * 100
_SECS_IN_MIL = _SECS_IN_CY * 10
_AU_KM = 149597870.7
_SUN_MU = 1.32712440041e20 / 1e9  # km^3/s^2
_MOON_MU = 4.902800145e12 / 1e9

#: drag rotations never need a PN threshold below this (see the reference's
#: empirical stress test, eo_dynamics.cpp:131-139)
_MIN_DRAG_IAU2006_THRESH = 1e-2


def _third_body_acc(xyz, elp2000_thresh, vsop2013_thresh):
    x, y, z = xyz
    earth_mu = get_egm2008_mu() / 1e9
    mu_star = earth_mu / _MOON_MU

    emb = vsop2013_cartesian_icrf(
        3, time_expr=_time_expr / _SECS_IN_MIL, thresh=vsop2013_thresh
    )
    x0EMB, y0EMB, z0EMB = (c * _AU_KM for c in emb[:3])

    moon_fk5 = elp2000_cartesian_fk5(
        time_expr=_time_expr / _SECS_IN_CY, thresh=elp2000_thresh
    )
    moon_gcrs = rot_fk5j2000_icrs(moon_fk5)
    # Moon-centric position of the Earth
    x1E, y1E, z1E = (-c for c in moon_gcrs)
    # heliocentric position of the Earth from the EMB + Moon geometry
    x0E = x0EMB + x1E / (1.0 + mu_star)
    y0E = y0EMB + y1E / (1.0 + mu_star)
    z0E = z0EMB + z1E / (1.0 + mu_star)

    def inv_r3(a, b, c):
        return _sum([a * a, b * b, c * c]) ** -1.5

    x0P, y0P, z0P = x0E + x, y0E + y, z0E + z
    r0P_m3 = inv_r3(x0P, y0P, z0P)
    r0E_m3 = inv_r3(x0E, y0E, z0E)
    x1P, y1P, z1P = x1E + x, y1E + y, z1E + z
    r1P_m3 = inv_r3(x1P, y1P, z1P)
    r1E_m3 = inv_r3(x1E, y1E, z1E)

    def tb(aP, a_m3P, aE, a_m3E, bP, bE):
        # direct - indirect along one axis
        return -(_SUN_MU * aP * a_m3P + _MOON_MU * bP * r1P_m3) - (
            -(_SUN_MU * aE * a_m3E + _MOON_MU * bE * r1E_m3)
        )

    return [
        tb(x0P, r0P_m3, x0E, r0E_m3, x1P, x1E),
        tb(y0P, r0P_m3, y0E, r0E_m3, y1P, y1E),
        tb(z0P, r0P_m3, z0E, r0E_m3, z1P, z1E),
    ]


def _drag_acc(state, iau2006_thresh, edata, sdata, Cb):
    x, y, z, vx, vy, vz = state
    tm = Variable("__eo_tm")
    tm_jcy = tm / _SECS_IN_CY
    thresh = max(iau2006_thresh, _MIN_DRAG_IAU2006_THRESH)

    # spacecraft position in the ITRS + geodetic coordinates (km)
    x_itrs, y_itrs, z_itrs = rot_icrs_itrs(
        [x, y, z], thresh=thresh, time_expr=tm_jcy, eop_data=edata
    )
    h, lat, lon = cart2geo([x_itrs, y_itrs, z_itrs], R_eq=A_EARTH / 1e3)

    # velocity of the co-rotating atmosphere: d/dt of the GCRS position of a
    # fixed ITRS point, evaluated at the spacecraft's ITRS position
    x0, y0, z0 = make_vars("__eo_x0", "__eo_y0", "__eo_z0")
    p_gcrs = rot_itrs_icrs(
        [x0, y0, z0], thresh=thresh, time_expr=tm_jcy, eop_data=edata
    )
    v_atm = [
        subs(diff(c, tm), {x0: x_itrs, y0: y_itrs, z0: z_itrs})
        for c in p_gcrs
    ]
    vrel = [vx - v_atm[0], vy - v_atm[1], vz - v_atm[2]]

    # atmospheric density at the spacecraft
    tm_atm = dayfrac(time_expr=tm / _SECS_IN_DAY)
    f107_e = f107(time_expr=(tm - _SECS_IN_DAY) / _SECS_IN_CY, sw_data=sdata)
    f107a_e = f107a_center81(time_expr=tm / _SECS_IN_CY, sw_data=sdata)
    ap_e = Ap_avg(time_expr=tm / _SECS_IN_CY, sw_data=sdata)
    rho = nrlmsise00_tn(
        geodetic=[h, lat, lon], f107=f107_e, f107a=f107a_e, ap=ap_e,
        time_expr=tm_atm,
    ) * 1e9  # kg/m^3 -> kg/km^3

    # |vrel| with an epsilon regularization against the 0/0 AD singularity
    veps = 1e-8
    vn = sqrt(_sum([c * c for c in vrel] + [expr(veps * veps)]))
    # Cb is in m^2/kg; lengths here are km
    factor = -0.5 * rho * vn * expr(Cb) * 1e-6
    acc = [factor * c for c in vrel]
    return [subs(a, {tm: _time_expr}) for a in acc]


def eo_dynamics(
    *,
    max_geo_degree: int = 0,
    max_geo_order: int = 0,
    iau2006_thresh: float = 1e-4,
    eop_data: EOPData | None = None,
    sw_data: SWData | None = None,
    Cb=None,
    elp2000_thresh: float | None = None,
    vsop2013_thresh: float | None = None,
):
    """ODE system [(x, vx), ..., (vz, acc_z)] for Earth-orbit dynamics."""
    if (elp2000_thresh is None) != (vsop2013_thresh is None):
        raise ValueError(
            "the 'vsop2013_thresh' and 'elp2000_thresh' arguments must both "
            "be either present or absent"
        )
    edata = EOPData() if eop_data is None else eop_data
    sdata = SWData() if sw_data is None else sw_data

    x, y, z, vx, vy, vz = make_vars("x", "y", "z", "vx", "vy", "vz")
    earth_mu = get_egm2008_mu() / 1e9

    if max_geo_degree == 0 and max_geo_order == 0:
        dyn = fixed_centres(Gconst=earth_mu, positions=[0.0, 0.0, 0.0], masses=[1.0])
    else:
        earth_a = get_egm2008_a() / 1e3
        tm_jcy = _time_expr / _SECS_IN_CY
        itrs = rot_icrs_itrs(
            [x, y, z], thresh=iau2006_thresh, time_expr=tm_jcy, eop_data=edata
        )
        acc_itrs = egm2008_acc(itrs, max_geo_degree, max_geo_order,
                               mu=earth_mu, a=earth_a)
        acc_gcrs = rot_itrs_icrs(
            acc_itrs, thresh=iau2006_thresh, time_expr=tm_jcy, eop_data=edata
        )
        dyn = [
            (x, expr(vx)), (y, expr(vy)), (z, expr(vz)),
            (vx, acc_gcrs[0]), (vy, acc_gcrs[1]), (vz, acc_gcrs[2]),
        ]

    dyn = [list(p) for p in dyn]
    if Cb is not None:
        drag = _drag_acc([x, y, z, vx, vy, vz], iau2006_thresh, edata, sdata, Cb)
        for i in range(3):
            dyn[3 + i][1] = dyn[3 + i][1] + drag[i]
    if elp2000_thresh is not None:
        tb = _third_body_acc([x, y, z], elp2000_thresh, vsop2013_thresh)
        for i in range(3):
            dyn[3 + i][1] = dyn[3 + i][1] + tb[i]
    return [tuple(p) for p in dyn]
