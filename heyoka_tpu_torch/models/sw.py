"""Space-weather model functions: Ap_avg / f107 / f107a_center81, the
port's copy of ``heyoka_tpu/models/sw.py``.

Reference parity: ``model::Ap_avg/f107/f107a_center81`` (+ ``*p``
derivatives) (``include/heyoka/model/sw.hpp:67-69``, ``src/model/sw.cpp``):
expressions interpolating space-weather indices at a time expression in TT
Julian centuries since J2000.0.
"""

from __future__ import annotations

from ..eop_sw import SWData, make_quantity_expr

__all__ = ["Ap_avg", "Ap_avgp", "f107", "f107p", "f107a_center81", "f107a_center81p"]


def _factory(qty: str, deriv: bool):
    def f(*, time_expr=None, sw_data: SWData | None = None):
        data = SWData() if sw_data is None else sw_data
        return make_quantity_expr(data, qty, time_expr, deriv)

    f.__name__ = qty + ("p" if deriv else "")
    f.__qualname__ = f.__name__
    f.__doc__ = (
        f"{'First derivative of ' if deriv else ''}the {qty} space-weather "
        f"index as an expression of ``time_expr`` (TT Julian centuries since "
        f"J2000.0); ``sw_data`` defaults to the builtin Celestrak snapshot."
    )
    return f


Ap_avg = _factory("Ap_avg", False)
Ap_avgp = _factory("Ap_avg", True)
f107 = _factory("f107", False)
f107p = _factory("f107", True)
f107a_center81 = _factory("f107a_center81", False)
f107a_center81p = _factory("f107a_center81", True)
