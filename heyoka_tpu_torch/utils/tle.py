"""TLE / GPE parsing for the SGP4 propagator, copied from
``heyoka_tpu.utils.tle``.

Produces the 9-row GPE layout expected by
:class:`heyoka_tpu_torch.models.sgp4.SGP4Propagator` (reference:
``sgp4_propagator`` ctor docs, ``include/heyoka/model/sgp4.hpp:152-166``):

row 0  n0      mean motion [rad/min]
row 1  e0      eccentricity
row 2  i0      inclination [rad]
row 3  node0   RAAN [rad]
row 4  omega0  argument of perigee [rad]
row 5  m0      mean anomaly [rad]
row 6  bstar   BSTAR drag term [1/earth radii]
row 7  epoch   epoch as UTC Julian date (integral-ish part)
row 8  frac    fractional correction to the epoch [days]
"""

from __future__ import annotations

import math

import numpy as np

from .timeconv import cal_to_jd

_DEG = math.pi / 180.0
_REV_PER_DAY = 2.0 * math.pi / 1440.0  # rev/day -> rad/min


def _impl_decimal(field: str) -> float:
    """Parse TLE implied-decimal fields like ' 13844-3' -> 0.13844e-3."""
    field = field.strip()
    if not field or field in ("+", "-"):
        return 0.0
    sign = -1.0 if field[0] == "-" else 1.0
    if field[0] in "+-":
        field = field[1:]
    mant, esign, expo = field[:-2], field[-2], field[-1]
    if esign not in "+-":
        # some TLEs write e.g. "00000 0"
        mant, esign, expo = field[:-1], "+", field[-1]
    m = float("0." + mant.strip() or "0")
    return sign * m * 10.0 ** (int(esign + expo))


def _tle_epoch_to_jd(epoch_field: str) -> tuple[float, float]:
    """TLE epoch YYDDD.DDDDDDDD -> (jd, frac) UTC Julian date."""
    s = epoch_field.strip()
    yy = int(s[:2])
    year = 2000 + yy if yy < 57 else 1900 + yy
    doy = float(s[2:])
    day_int = int(doy)
    frac = doy - day_int
    jd0 = cal_to_jd(year, 1, 1) + (day_int - 1)
    return float(jd0), float(frac)


def parse_tle(line1: str, line2: str) -> np.ndarray:
    """Parse one TLE (lines 1 and 2) into a (9,) GPE vector."""
    if len(line1) < 68 or len(line2) < 68:
        raise ValueError("TLE lines too short")
    if line1[0] != "1" or line2[0] != "2":
        raise ValueError("malformed TLE: bad line numbers")

    bstar = _impl_decimal(line1[53:61])
    jd, frac = _tle_epoch_to_jd(line1[18:32])

    i0 = float(line2[8:16]) * _DEG
    node0 = float(line2[17:25]) * _DEG
    e0 = float("0." + line2[26:33].strip())
    omega0 = float(line2[34:42]) * _DEG
    m0 = float(line2[43:51]) * _DEG
    n0 = float(line2[52:63]) * _REV_PER_DAY

    return np.array([n0, e0, i0, node0, omega0, m0, bstar, jd, frac])


def parse_tle_file(text: str) -> np.ndarray:
    """Parse a multi-TLE text block (2- or 3-line format) into a (9, n)
    satellite array (the propagator's ctor layout)."""
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    sats = []
    i = 0
    while i < len(lines):
        if lines[i].startswith("1 ") and i + 1 < len(lines) and lines[i + 1].startswith("2 "):
            sats.append(parse_tle(lines[i], lines[i + 1]))
            i += 2
        else:
            i += 1  # name line
    if not sats:
        raise ValueError("no TLEs found")
    return np.stack(sats, axis=1)
