"""Time-scale conversions (UTC / TAI / TT) on double-length Julian dates,
copied from ``heyoka_tpu.utils.timeconv`` (numpy only).

Reference parity: heyoka vendors ERFA and calls ``eraUtctai`` / ``eraTaitt``
etc. host-side (``src/detail/erfa/``, used e.g. by ``model::jd_utc_to_tai``,
``src/model/sgp4.cpp:1136``).  Here the needed subset is reimplemented from
the published IAU SOFA algorithms and the IERS leap-second tables: pure
Python/NumPy, vectorized, operating on (hi, lo) double-length Julian dates
exactly like the reference.

TT - TAI is the defined constant 32.184 s.  TAI - UTC comes from the IERS
table: integer leap seconds from 1972, and the published drift formulas for
1960-1972.
"""

from __future__ import annotations

import numpy as np

#: TT - TAI in seconds (defining constant).
TT_MINUS_TAI = 32.184

DAYSEC = 86400.0
DJM0 = 2400000.5  # MJD zero point as JD

# IERS leap-second table: (year, month, TAI-UTC at 0h of the 1st of month).
# Source: IERS Bulletin C (public data).
_LEAP_TABLE = [
    (1972, 1, 10.0), (1972, 7, 11.0), (1973, 1, 12.0), (1974, 1, 13.0),
    (1975, 1, 14.0), (1976, 1, 15.0), (1977, 1, 16.0), (1978, 1, 17.0),
    (1979, 1, 18.0), (1980, 1, 19.0), (1981, 7, 20.0), (1982, 7, 21.0),
    (1983, 7, 22.0), (1985, 7, 23.0), (1988, 1, 24.0), (1990, 1, 25.0),
    (1991, 1, 26.0), (1992, 7, 27.0), (1993, 7, 28.0), (1994, 7, 29.0),
    (1996, 1, 30.0), (1997, 7, 31.0), (1999, 1, 32.0), (2006, 1, 33.0),
    (2009, 1, 34.0), (2012, 7, 35.0), (2015, 7, 36.0), (2017, 1, 37.0),
]

# 1960-1972 TAI-UTC drift model: (year, month, offset_s, mjd_ref, rate_s_per_day).
# Source: the published IERS/USNO relationship table (same data ERFA's dat.c uses).
_DRIFT_TABLE = [
    (1960, 1, 1.4178180, 37300.0, 0.001296),
    (1961, 1, 1.4228180, 37300.0, 0.001296),
    (1961, 8, 1.3728180, 37300.0, 0.001296),
    (1962, 1, 1.8458580, 37665.0, 0.0011232),
    (1963, 11, 1.9458580, 37665.0, 0.0011232),
    (1964, 1, 3.2401300, 38761.0, 0.001296),
    (1964, 4, 3.3401300, 38761.0, 0.001296),
    (1964, 9, 3.4401300, 38761.0, 0.001296),
    (1965, 1, 3.5401300, 38761.0, 0.001296),
    (1965, 3, 3.6401300, 38761.0, 0.001296),
    (1965, 7, 3.7401300, 38761.0, 0.001296),
    (1965, 9, 3.8401300, 38761.0, 0.001296),
    (1966, 1, 4.3131700, 39126.0, 0.002592),
    (1968, 2, 4.2131700, 39126.0, 0.002592),
]


def cal_to_jd(y, m, d):
    """Gregorian calendar date -> Julian day number at 0h (returned as a
    JD with .5 fraction, i.e. ``cal_to_jd(2000, 1, 1) == 2451544.5``).

    Fliegel-Van Flandern algorithm; vectorized over numpy ints.
    """
    y = np.asarray(y, dtype=np.int64)
    m = np.asarray(m, dtype=np.int64)
    d = np.asarray(d, dtype=np.int64)
    a = (14 - m) // 12
    yy = y + 4800 - a
    mm = m + 12 * a - 3
    jdn = d + (153 * mm + 2) // 5 + 365 * yy + yy // 4 - yy // 100 + yy // 400 - 32045
    return jdn.astype(np.float64) - 0.5


def jd_to_cal(jd1, jd2=0.0):
    """Double-length JD -> (year, month, day, frac_of_day)."""
    jd1 = np.asarray(jd1, dtype=np.float64)
    jd2 = np.asarray(jd2, dtype=np.float64)
    j = jd1 + jd2 + 0.5
    jdn = np.floor(j).astype(np.int64)
    fd = j - jdn
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    dd = (4 * c + 3) // 1461
    e = c - 1461 * dd // 4
    mm = (5 * e + 2) // 153
    day = e - (153 * mm + 2) // 5 + 1
    month = mm + 3 - 12 * (mm // 10)
    year = 100 * b + dd - 4800 + mm // 10
    return year, month, day, fd


def _dat_cal(y, m, d, fd):
    """TAI - UTC in seconds at the given UTC calendar date (vectorized)."""
    y = np.asarray(y)
    m = np.asarray(m)
    key = y * 100 + m
    out = np.zeros(np.broadcast(y, m).shape, dtype=np.float64)

    # pre-1972 drift regimes
    mjd = cal_to_jd(y, m, d) - DJM0 + np.asarray(fd, dtype=np.float64)
    for yy, mm_, off, mref, rate in _DRIFT_TABLE:
        sel = key >= yy * 100 + mm_
        out = np.where(sel, off + (mjd - mref) * rate, out)
    # integer leap-second era
    for yy, mm_, dat in _LEAP_TABLE:
        sel = key >= yy * 100 + mm_
        out = np.where(sel, dat, out)
    return out


def tai_minus_utc(jd1, jd2=0.0):
    """TAI - UTC in seconds at the given UTC Julian date."""
    y, m, d, fd = jd_to_cal(jd1, jd2)
    return _dat_cal(y, m, d, fd)


def jd_utc_to_tai(utc1, utc2=0.0):
    """UTC -> TAI double-length Julian date (``model::jd_utc_to_tai``,
    ``src/model/sgp4.cpp:1136``; algorithm of the published ``utctai``).

    Handles the leap-second day correctly: on a day with a leap second the
    UTC "quasi-JD" day is rescaled to its true 86401-s length.
    """
    utc1 = np.asarray(utc1, dtype=np.float64)
    utc2 = np.asarray(utc2, dtype=np.float64)
    big = np.abs(utc1) >= np.abs(utc2)
    u1 = np.where(big, utc1, utc2)
    u2 = np.where(big, utc2, utc1)

    y, m, d, fd = jd_to_cal(u1, u2)
    dat0 = _dat_cal(y, m, d, 0.0)
    dat12 = _dat_cal(y, m, d, 0.5)
    y2, m2, d2, _ = jd_to_cal(u1 + (u2 - fd) + 1.5)
    dat24 = _dat_cal(y2, m2, d2, 0.0)

    # pre-1972 intra-day drift and any leap-second jump at end of this day
    dlod = 2.0 * (dat12 - dat0)
    dleap = dat24 - (dat0 + dlod)

    # seconds to add: offset at 0h plus the fraction of the day's excess
    # length already elapsed (a leap-second day has 86400+dleap SI seconds)
    extra = dat0 + fd * (dleap + dlod)
    return u1, u2 + extra / DAYSEC


def jd_tai_to_utc(tai1, tai2=0.0):
    """TAI -> UTC double-length Julian date (iterative inverse)."""
    tai1 = np.asarray(tai1, dtype=np.float64)
    tai2 = np.asarray(tai2, dtype=np.float64)
    u1, u2 = tai1, tai2
    for _ in range(3):
        g1, g2 = jd_utc_to_tai(u1, u2)
        u2 = u2 - (g1 - tai1) - (g2 - tai2)
    return u1, u2


def jd_tai_to_tt(tai1, tai2=0.0):
    return np.asarray(tai1, np.float64), np.asarray(tai2, np.float64) + TT_MINUS_TAI / DAYSEC


def jd_tt_to_tai(tt1, tt2=0.0):
    return np.asarray(tt1, np.float64), np.asarray(tt2, np.float64) - TT_MINUS_TAI / DAYSEC


def jd_utc_to_tt(utc1, utc2=0.0):
    t1, t2 = jd_utc_to_tai(utc1, utc2)
    return jd_tai_to_tt(t1, t2)
