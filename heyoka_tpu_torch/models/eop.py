"""EOP model functions: era/gmst82/pm_x/pm_y/dX/dY (+ derivatives), the
port's copy of ``heyoka_tpu/models/eop.py``.

Reference parity: ``model::era/erap/gmst82/gmst82p/pm_x/pm_xp/pm_y/pm_yp/
dX/dXp/dY/dYp`` (``include/heyoka/model/eop.hpp:95-100``,
``src/model/eop.cpp``): expressions interpolating Earth-orientation
quantities at a time expression measured in **TT Julian centuries since
J2000.0**.  Outputs: era/gmst82 in radians reduced to [0, 2pi); pm_x/pm_y in
radians (converted from arcsec); dX/dY in radians (from milliarcsec).
"""

from __future__ import annotations

from ..eop_sw import EOPData, make_quantity_expr

__all__ = [
    "era", "erap", "gmst82", "gmst82p",
    "pm_x", "pm_xp", "pm_y", "pm_yp",
    "dX", "dXp", "dY", "dYp",
]


def _factory(qty: str, deriv: bool):
    def f(*, time_expr=None, eop_data: EOPData | None = None):
        data = EOPData() if eop_data is None else eop_data
        return make_quantity_expr(data, qty, time_expr, deriv)

    f.__name__ = qty + ("p" if deriv else "")
    f.__qualname__ = f.__name__
    f.__doc__ = (
        f"{'First derivative of ' if deriv else ''}the {qty} EOP quantity as "
        f"an expression of ``time_expr`` (TT Julian centuries since J2000.0; "
        f"default: heyoka time).  ``eop_data`` defaults to the builtin IERS "
        f"rapid snapshot."
    )
    return f


era = _factory("era", False)
erap = _factory("era", True)
gmst82 = _factory("gmst82", False)
gmst82p = _factory("gmst82", True)
pm_x = _factory("pm_x", False)
pm_xp = _factory("pm_x", True)
pm_y = _factory("pm_y", False)
pm_yp = _factory("pm_y", True)
dX = _factory("dX", False)
dXp = _factory("dX", True)
dY = _factory("dY", False)
dYp = _factory("dY", True)
