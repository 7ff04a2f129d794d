"""Time-scale conversion expressions, copied from
``heyoka_tpu.models.time_conversions``.

Reference parity: ``model::delta_tt_tai`` / ``model::delta_tdb_tt``
(``include/heyoka/model/time_conversions.hpp``,
``src/model/time_conversions.cpp``): the constant TT-TAI offset and the
standard sinusoidal TDB-TT model (Fairhead & Bretagnon leading term).
"""

from __future__ import annotations

from ..expr.core import Number, expr, time as _time_expr
from ..expr.math import sin

__all__ = ["delta_tt_tai", "delta_tdb_tt"]

#: TT - TAI in seconds (exact by definition)
delta_tt_tai = Number(32.184)


def delta_tdb_tt(time_expr=None):
    """TDB - TT in seconds as an expression of ``time_expr`` (TT seconds
    since J2000, like the reference's default heyoka time usage)."""
    t = _time_expr if time_expr is None else expr(time_expr)
    M = 6.239996 + 1.99096871e-7 * t
    E = M + 1.671e-2 * sin(M)
    return 1.657e-3 * sin(E)
