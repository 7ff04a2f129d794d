"""dayfrac(): TT days elapsed since January 1st 00:00 UTC of the current
year (the port's copy of ``heyoka_tpu/models/dayfrac.py``).

Reference parity: ``model::dayfrac`` (``include/heyoka/model/dayfrac.hpp``,
``src/model/dayfrac.cpp``): input is TT days since J2000.0; the output is the
number of TT days since Jan 1 00:00 UTC of the input's calendar year —
the "day of year" input of the NRLMSISE00/JB08 thermosphere models.

The calendar computation (Julian day to Gregorian year, leap seconds from
a table on the input's device) is branch-free f64 and int64 torch, the
JAX package's ``jnp`` operations in their order (integer floor division
as ``jnp``'s); it is the op's order-0 rule (``expr.numeric.evaluate``).
Pre-1972 epochs use the 1972 TAI-UTC offset (the drift regime is
irrelevant for thermosphere work).

Derivative: d dayfrac / dt == 1 almost everywhere (jumps at year
boundaries are invisible to the Taylor recurrence, like the EOP kinks):
above order 0 the jet copies its input, ``a_k = u_k`` (kernel B4's
``dayfrac`` rule).
"""

from __future__ import annotations

import numpy as np
import torch

from ..expr import registry as _reg
from ..expr import diff as _diff
from ..expr.core import Func, ONE, expr, time as _time_expr
from ..utils.timeconv import _LEAP_TABLE, cal_to_jd

__all__ = ["dayfrac"]

#: leap-second table as (utc_mjd_of_change, TAI-UTC) arrays
_LEAP_MJD = np.array(
    [float(cal_to_jd(y, m, 1)) - 2400000.5 for (y, m, _) in _LEAP_TABLE]
)
_LEAP_DAT = np.array([d for (_, _, d) in _LEAP_TABLE])
#: device -> the two arrays as f64 tensors there
_ON: dict = {}


def _leap_on(dev):
    if str(dev) not in _ON:
        _ON[str(dev)] = (torch.as_tensor(_LEAP_MJD, device=dev),
                         torch.as_tensor(_LEAP_DAT, device=dev))
    return _ON[str(dev)]


def _dat_of_mjd(mjd):
    leap_mjd, leap_dat = _leap_on(mjd.device)
    idx = torch.searchsorted(leap_mjd, mjd.contiguous(), right=True) - 1
    idx = torch.clamp(idx, 0, _LEAP_DAT.size - 1)
    return leap_dat[idx]


def _year_of_jd(jd):
    """Gregorian year of a Julian date (Fliegel-Van Flandern, int64)."""
    jdn = torch.floor(jd + 0.5).to(torch.int64)
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    return 100 * b + d - 4800 + m // 10


def _jd_of_jan1(year):
    """UTC JD at 0h of Jan 1 of ``year`` (returns x.5)."""
    yy = year + 4799  # m=1 -> a=1, yy=y+4800-1, mm=10
    jdn = 1 + (153 * 10 + 2) // 5 + 365 * yy + yy // 4 - yy // 100 + yy // 400 - 32045
    return jdn.to(torch.float64) - 0.5


def ev_dayfrac(t):
    """The op's value at ``t`` (f64 tensor, TT days since J2000.0)."""
    tt_frac = t  # TT days since J2000.0 (JD 2451545.0)
    # TT -> TAI -> UTC; iterate the leap lookup once to settle the date
    tai_frac = tt_frac - 32.184 / 86400.0
    utc_mjd_guess = tai_frac + (2451545.0 - 2400000.5)
    dat = _dat_of_mjd(utc_mjd_guess)
    utc_mjd = utc_mjd_guess - dat / 86400.0
    dat = _dat_of_mjd(utc_mjd)
    utc_jd_frac = tai_frac - dat / 86400.0  # UTC days since J2000.0

    year = _year_of_jd(2451545.0 + utc_jd_frac)
    yjd = _jd_of_jan1(year)
    ymjd = yjd - 2400000.5
    ydat = _dat_of_mjd(ymjd)
    # year start in TT, as days since J2000: (yjd - 2451545) is exact
    ytt_frac = (yjd - 2451545.0) + (ydat + 32.184) / 86400.0
    ret = tt_frac - ytt_frac
    return torch.maximum(ret, torch.zeros_like(ret))


_reg.register(_reg.OpDef("dayfrac", 1))
_diff._GRAD["dayfrac"] = lambda t: (ONE,)


def dayfrac(*, time_expr=None):
    """Expression: days since Jan 1 00:00 UTC of the input's year; input is
    TT days since J2000.0 (default: heyoka time)."""
    te = _time_expr if time_expr is None else expr(time_expr)
    return Func("dayfrac", (te,))
