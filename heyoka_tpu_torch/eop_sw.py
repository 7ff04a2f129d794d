"""Earth-orientation (EOP) and space-weather (SW) data: the port's copy of
``heyoka_tpu/eop_sw.py`` (numpy, torch and the port's expression layer).

Reference parity: heyoka ``eop_data`` / ``sw_data``
(``include/heyoka/eop_data.hpp``, ``sw_data.hpp``, ``src/eop_data*.cpp``,
``src/sw_data*.cpp``, ``src/detail/eop_sw_helpers.cpp``): immutable shared
tables of IERS Earth-orientation parameters / Celestrak space-weather
indices, with builtin snapshots, remote fetchers, and piecewise-linear
interpolating functions in the expression system.

Each dataset registers a family of data-driven ops, one per quantity and
per kind (the value ``<qty>%<key>`` and its slope ``<qty>_p%<key>``), with
the JAX package's names letter for letter, so that the tapes are equal.
Angular quantities (ERA, GMST82) are precomputed at the table dates in
50-digit decimal arithmetic, stored as double-double (reduced mod 2pi at
the nodes), and interpolated so the final reduction happens on
O(2pi)-magnitude values (``src/eop_data.cpp:241-312``).

The numbers: :func:`interp0` is the order-0 rule of both kinds in f64
torch, on tables that live on the input's device (:func:`tables_on`), the
operations of the JAX ``_interp_rule`` in its order; out-of-range dates
yield NaN.  Above order 0 the Taylor jet runs the reference's recurrences
(``_linear_interp_recurrence``, ``_const_interp_recurrence``): ``a_k =
slope(u_0) u_k`` and ``0`` (``taylor/jet_phase.py``, kernel B4's
``interp`` and ``interp_p`` rules).

The input time of every interpolating function is **TT Julian centuries
since J2000.0** (``eop_sw_helpers.cpp:158-200``).  The builtin snapshots
are byte-identical copies of the JAX package's (``data/eop_builtin.npz``,
``data/sw_builtin.npz``).  The fetchers download (``_http_get``); nothing
in the port's tests or smoke run calls them.
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext
from functools import lru_cache

import numpy as np
import torch

from .data import data_path
from .expr import diff as _diff
from .expr import registry as _reg
from .expr.core import Func, ZERO, expr, time as _time_expr

__all__ = ["EOPData", "SWData", "eop_data", "sw_data"]

#: the precision of every decimal computation (the JAX module sets it on
#: the global context; here each computation takes a local one)
_PREC = 50

_TWOPI_DEC = Decimal(
    "6.2831853071795864769252867665590057683943387987502116419498891846"
)
with localcontext() as _ctx:
    _ctx.prec = _PREC
    #: seconds of time -> radians
    _DS2R_DEC = _TWOPI_DEC / Decimal(86400)

_ARCSEC = math.pi / (180.0 * 3600.0)
_MAS = _ARCSEC / 1000.0

#: quantities of each dataset kind: name -> (column, unit factor, angular)
_EOP_QUANTITIES = {
    "pm_x": (2, _ARCSEC, False),
    "pm_y": (3, _ARCSEC, False),
    "dX": (4, _MAS, False),
    "dY": (5, _MAS, False),
    "era": (None, 1.0, True),
    "gmst82": (None, 1.0, True),
}
_SW_QUANTITIES = {
    "Ap_avg": (1, 1.0, False),
    "f107": (2, 1.0, False),
    "f107a_center81": (3, 1.0, False),
}


def _date_tt_cy(mjd: np.ndarray) -> np.ndarray:
    """UTC MJD -> TT Julian centuries since J2000.0 (f64, dd-accumulated)."""
    from .utils.timeconv import jd_utc_to_tai, jd_tai_to_tt

    t1, t2 = jd_utc_to_tai(np.full_like(mjd, 2400000.5), mjd)
    t1, t2 = jd_tai_to_tt(t1, t2)
    # (t1 - 2451545.0) is exact: both have magnitude ~2.4e6 with .5 fractions
    return ((t1 - 2451545.0) + t2) / 36525.0


def _era_series(mjd: np.ndarray, dut1: np.ndarray):
    """Unreduced ERA at the table dates, as Decimals (IAU 2000 ERA model,
    era = 2pi*(0.7790572732640 + 1.00273781191135448 * tU))."""
    c0 = Decimal("0.7790572732640")
    c1 = Decimal("1.00273781191135448")
    out = []
    with localcontext() as ctx:
        ctx.prec = _PREC
        for m, d in zip(mjd, dut1):
            tU = Decimal(float(m)) - Decimal("51544.5") \
                + Decimal(float(d)) / 86400
            out.append(_TWOPI_DEC * (c0 + c1 * tU))
    return out


def _gmst82_series(mjd: np.ndarray, dut1: np.ndarray):
    """Unreduced GMST (IAU 1982 model) at the table dates, as Decimals."""
    # the classical constant 24110.54841 s anchors GMST at 0h UT1; since
    # the rotation term below measures from J2000.0 (12h), half a day
    # (43200 s) is subtracted (the published gmst82 routine's A constant)
    out = []
    with localcontext() as ctx:
        ctx.prec = _PREC
        A = Decimal("24110.54841") - 43200
        B = Decimal("8640184.812866")
        C = Decimal("0.093104")
        D = Decimal("-6.2e-6")
        for m, d in zip(mjd, dut1):
            tU = Decimal(float(m)) - Decimal("51544.5") \
                + Decimal(float(d)) / 86400
            t = tU / 36525
            poly = A + (B + (C + D * t) * t) * t
            out.append(_DS2R_DEC * poly + _TWOPI_DEC * tU)
    return out


def _dd_from_decimal(vals) -> tuple[np.ndarray, np.ndarray]:
    with localcontext() as ctx:
        ctx.prec = _PREC
        hi = np.array([float(v) for v in vals])
        lo = np.array([float(v - Decimal(h)) for v, h in zip(vals, hi)])
    return hi, lo


class _DataBase:
    """Common behaviour of :class:`EOPData` / :class:`SWData`."""

    _KIND = ""  # "eop" / "sw"

    def __init__(self, table: np.ndarray, timestamp: str, identifier: str):
        table = np.ascontiguousarray(np.asarray(table, dtype=np.float64))
        self._validate(table)
        self._table = table
        self._table.setflags(write=False)
        self._timestamp = str(timestamp)
        self._identifier = str(identifier)

    @property
    def table(self) -> np.ndarray:
        return self._table

    @property
    def timestamp(self) -> str:
        return self._timestamp

    @property
    def identifier(self) -> str:
        return self._identifier

    @property
    def data_key(self) -> str:
        """Unique dataset key (the analog of the reference's
        timestamp+identifier mangled LLVM global names)."""
        return f"{self._KIND}:{self._identifier}@{self._timestamp}"

    @staticmethod
    def _validate_common(table, ncols, name):
        if table.ndim != 2 or table.shape[1] != ncols or table.shape[0] < 2:
            raise ValueError(f"invalid {name} table shape {table.shape}")
        if not np.all(np.isfinite(table)):
            raise ValueError(f"non-finite values in {name} table")
        if not np.all(np.diff(table[:, 0]) > 0):
            raise ValueError(f"{name} table dates are not strictly increasing")

    def __eq__(self, other):
        return type(self) is type(other) and self.data_key == other.data_key

    def __hash__(self):
        return hash(self.data_key)

    def __repr__(self):
        return (
            f"{type(self).__name__}(rows={self._table.shape[0]}, "
            f"identifier={self._identifier!r}, timestamp={self._timestamp!r})"
        )


class EOPData(_DataBase):
    """Earth-orientation parameter table (heyoka ``eop_data``).

    Rows: (UTC MJD, UT1-UTC [s], pm_x [arcsec], pm_y [arcsec], dX [mas],
    dY [mas]).  The default constructor loads the builtin IERS rapid
    finals2000A snapshot shipped with the package.
    """

    _KIND = "eop"

    def __init__(self, table=None, *, timestamp=None, identifier=None):
        if table is None:
            b = _builtin_eop()
            table, ts, ident = b["table"], str(b["timestamp"]), str(b["identifier"])
            timestamp = ts if timestamp is None else timestamp
            identifier = ident if identifier is None else identifier
        super().__init__(table, timestamp or "custom", identifier or "custom")

    @classmethod
    def _validate(cls, table):
        cls._validate_common(table, 6, "EOP")

    # -- remote fetchers (reference: eop_data_iers_rapid.cpp etc.) ----------

    @classmethod
    def fetch_latest_iers_rapid(cls, center="usno", filename="finals2000A.all"):
        url = f"https://datacenter.iers.org/products/eop/rapid/standard/{filename}"
        if center == "maia":
            url = f"https://maia.usno.navy.mil/ser7/{filename}"
        text = _http_get(url)
        return cls(
            parse_eop_finals2000A(text),
            timestamp=_now_ts(),
            identifier=f"iers_rapid_{center}_{filename.replace('.', '_')}",
        )

    @classmethod
    def fetch_latest_iers_long_term(cls):
        url = "https://datacenter.iers.org/data/csv/finals2000A.all.csv"
        text = _http_get(url)
        return cls(
            parse_eop_iers_csv(text),
            timestamp=_now_ts(),
            identifier="iers_long_term",
        )

    @classmethod
    def fetch_latest_celestrak(cls, long_term=False):
        name = "EOP-All.csv" if long_term else "EOP-Last5Years.csv"
        text = _http_get(f"https://celestrak.org/SpaceData/{name}")
        return cls(
            parse_eop_celestrak_csv(text),
            timestamp=_now_ts(),
            identifier=f"celestrak_{'all' if long_term else 'last5'}",
        )


class SWData(_DataBase):
    """Space-weather index table (heyoka ``sw_data``).

    Rows: (UTC MJD, Ap_avg, F10.7 [sfu], F10.7 81-day centered average).
    Default constructor loads the builtin Celestrak long-term snapshot.
    """

    _KIND = "sw"

    def __init__(self, table=None, *, timestamp=None, identifier=None):
        if table is None:
            b = _builtin_sw()
            table, ts, ident = b["table"], str(b["timestamp"]), str(b["identifier"])
            timestamp = ts if timestamp is None else timestamp
            identifier = ident if identifier is None else identifier
        super().__init__(table, timestamp or "custom", identifier or "custom")

    @classmethod
    def _validate(cls, table):
        cls._validate_common(table, 4, "SW")

    @classmethod
    def fetch_latest_celestrak(cls, long_term=True):
        name = "SW-All.csv" if long_term else "SW-Last5Years.csv"
        text = _http_get(f"https://celestrak.org/SpaceData/{name}")
        return cls(
            parse_sw_celestrak_csv(text),
            timestamp=_now_ts(),
            identifier=f"celestrak_{'long_term' if long_term else 'last5'}",
        )


def eop_data(*a, **kw) -> EOPData:
    return EOPData(*a, **kw)


def sw_data(*a, **kw) -> SWData:
    return SWData(*a, **kw)


# ---------------------------------------------------------------------------
# builtin snapshots
# ---------------------------------------------------------------------------

def _load(name: str) -> dict:
    with np.load(data_path(name)) as d:
        return {k: d[k] for k in d.files}


@lru_cache(maxsize=1)
def _builtin_eop():
    return _load("eop_builtin.npz")


@lru_cache(maxsize=1)
def _builtin_sw():
    return _load("sw_builtin.npz")


# ---------------------------------------------------------------------------
# remote download / parsers
# ---------------------------------------------------------------------------

def _http_get(url: str) -> str:
    """Download a data product (reference: ``src/detail/http_download.cpp``
    via Boost.Beast/OpenSSL; here stdlib urllib)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:  # noqa: S310
        return r.read().decode()


def _now_ts() -> str:
    import datetime

    return datetime.datetime.now(datetime.UTC).strftime("%Y_%m_%d_%H_%M_%S")


def parse_eop_finals2000A(text: str) -> np.ndarray:
    """Parse the IERS rapid-service ``finals2000A.all`` fixed-width format
    into the (n, 6) EOP layout (bulletin-A values)."""
    rows = []
    for ln in text.splitlines():
        if len(ln) < 68:
            continue
        try:
            mjd = float(ln[7:15])
            pm_x = float(ln[18:27])
            pm_y = float(ln[37:46])
            dut1 = float(ln[58:68])
        except ValueError:
            continue
        try:
            dX = float(ln[97:106])
            dY = float(ln[116:125])
        except (ValueError, IndexError):
            dX = dY = 0.0
        rows.append([mjd, dut1, pm_x, pm_y, dX, dY])
    if not rows:
        raise ValueError("no parsable rows in finals2000A data")
    return np.asarray(rows)


def parse_eop_iers_csv(text: str) -> np.ndarray:
    """Parse the IERS long-term csv (semicolon-separated finals2000A)."""
    import csv
    import io

    rd = csv.DictReader(io.StringIO(text), delimiter=";")
    rows = []
    for rec in rd:
        try:
            rows.append([
                float(rec["MJD"]),
                float(rec["UT1-UTC"]),
                float(rec["x_pole"]),
                float(rec["y_pole"]),
                float(rec.get("dX", "") or 0.0),
                float(rec.get("dY", "") or 0.0),
            ])
        except (ValueError, KeyError):
            continue
    if not rows:
        raise ValueError("no parsable rows in IERS csv data")
    return np.asarray(rows)


def parse_eop_celestrak_csv(text: str) -> np.ndarray:
    import csv
    import io

    rd = csv.DictReader(io.StringIO(text))
    rows = []
    for rec in rd:
        try:
            rows.append([
                float(rec["MJD"]),
                float(rec["UT1-UTC"]),
                float(rec["X"]),
                float(rec["Y"]),
                float(rec.get("DX", "") or 0.0) / 1.0,
                float(rec.get("DY", "") or 0.0) / 1.0,
            ])
        except (ValueError, KeyError):
            continue
    if not rows:
        raise ValueError("no parsable rows in Celestrak EOP data")
    return np.asarray(rows)


def parse_sw_celestrak_csv(text: str) -> np.ndarray:
    import csv
    import io

    rd = csv.DictReader(io.StringIO(text))
    rows = []
    for rec in rd:
        try:
            mjd = float(rec["MJD"]) if "MJD" in rec else _date_to_mjd(rec["DATE"])
            rows.append([
                mjd,
                float(rec["AP_AVG"]),
                float(rec["F10.7_OBS"]),
                float(rec["F10.7_OBS_CENTER81"]),
            ])
        except (ValueError, KeyError):
            continue
    if not rows:
        raise ValueError("no parsable rows in Celestrak SW data")
    return np.asarray(rows)


def _date_to_mjd(s: str) -> float:
    from .utils.timeconv import cal_to_jd

    y, m, d = (int(p) for p in s.split("-"))
    return float(cal_to_jd(y, m, d)) - 2400000.5


# ---------------------------------------------------------------------------
# data-driven interpolation ops
# ---------------------------------------------------------------------------

#: dataset key -> its interpolation arrays (numpy), as the JAX ``_STORE``
_STORE: dict[str, dict] = {}
#: (dataset key, device) -> the same arrays as f64 tensors on that device
_ON: dict[tuple, dict] = {}


def _prepare(data: _DataBase) -> dict:
    """Precompute the interpolation arrays of a dataset (cached by key)."""
    key = data.data_key
    if key in _STORE:
        return _STORE[key]

    tab = data.table
    mjd = tab[:, 0]
    date = _date_tt_cy(mjd)
    arrs: dict = {"date": date}

    quantities = _EOP_QUANTITIES if data._KIND == "eop" else _SW_QUANTITIES
    dcy = np.diff(date)
    for qty, (col, fac, angular) in quantities.items():
        if angular:
            series = (_era_series if qty == "era" else _gmst82_series)(
                mjd, tab[:, 1]
            )
            # node values reduced mod 2pi in decimal, stored double-double
            with localcontext() as ctx:
                ctx.prec = _PREC
                red = [v % _TWOPI_DEC for v in series]
                diffs = [float((series[i + 1] - series[i]))
                         for i in range(len(series) - 1)]
            hi, lo = _dd_from_decimal(red)
            slope = np.array(diffs) / dcy
            arrs[qty] = {"hi": hi, "lo": lo, "slope": slope, "angular": True}
        else:
            v = tab[:, col] * fac
            arrs[qty] = {
                "v": v,
                "slope": np.diff(v) / dcy,
                "angular": False,
            }
    _STORE[key] = arrs
    _register_ops(data._KIND, key, list(quantities))
    return arrs


def _register_ops(kind: str, key: str, quantities):
    for qty in quantities:
        for deriv in (False, True):
            name = _op_name(key, qty, deriv)
            if _reg.have_op(name):
                continue
            _reg.register(_reg.OpDef(name, 1))
            if deriv:
                # the slope is piecewise constant: derivative == 0
                _diff._GRAD[name] = lambda t: (ZERO,)
            else:
                _diff._GRAD[name] = _qty_grad(key, qty)


def _op_name(key: str, qty: str, deriv: bool) -> str:
    return f"{qty}{'_p' if deriv else ''}%{key}"


def _qty_grad(key: str, qty: str):
    def g(t):
        return (Func(_op_name(key, qty, True), (t,)),)

    return g


def parse_op(name: str):
    """``(key, qty, deriv)`` of a dataset op's name (``pm_x%eop:...`` or
    its slope ``pm_x_p%eop:...``), None for any other op."""
    if "%" not in name:
        return None
    head, key = name.split("%", 1)
    kind = key.split(":", 1)[0]
    quantities = {"eop": _EOP_QUANTITIES, "sw": _SW_QUANTITIES}.get(kind)
    if quantities is None:
        return None
    if head in quantities:
        return key, head, False
    if head.endswith("_p") and head[:-2] in quantities:
        return key, head[:-2], True
    return None


def is_interp(name: str) -> bool:
    """Whether ``name`` is a dataset op's name (value or slope)."""
    return parse_op(name) is not None


def _resolve_op(name: str) -> None:
    """Registry resolver: re-register a dataset op after unpickling.

    Builtin datasets rehydrate automatically from the packaged snapshots;
    custom datasets must be re-created (their :func:`make_quantity_expr`
    call re-registers the ops).
    """
    if "%" in name:
        _resolve_key(name.split("%", 1)[1])


def _resolve_key(key: str) -> None:
    """Register the ops of dataset ``key``, preparing it first where it is
    a builtin one missing from the store."""
    if key in _STORE:
        # arrays exist; only the op table entries are missing (fresh process)
        kind = key.split(":", 1)[0]
        quantities = _EOP_QUANTITIES if kind == "eop" else _SW_QUANTITIES
        _register_ops(kind, key, list(quantities))
        return
    for cls in (EOPData, SWData):
        b = cls()
        if b.data_key == key:
            _prepare(b)
            return


_reg.register_resolver(_resolve_op)


def make_quantity_expr(data: _DataBase, qty: str, time_expr=None, deriv=False):
    """Expression node interpolating ``qty`` of ``data`` at ``time_expr``
    (default: heyoka time), in TT Julian centuries since J2000.0."""
    _prepare(data)
    te = _time_expr if time_expr is None else expr(time_expr)
    return Func(_op_name(data.data_key, qty, deriv), (te,))


# ---------------------------------------------------------------------------
# the numbers in torch
# ---------------------------------------------------------------------------

def prepared(key: str) -> dict:
    """The interpolation arrays of dataset ``key`` (numpy), its ops
    registered.  A builtin dataset missing from the store (a plan rebuilt
    in a fresh process) is prepared; a custom one raises KeyError:
    rebuild its expressions first."""
    _resolve_key(key)
    if key not in _STORE:
        raise KeyError(
            f"dataset {key!r} is not in the port's store: build its "
            "expressions (make_quantity_expr) first")
    return _STORE[key]


def tables_on(key: str, device) -> dict:
    """The interpolation arrays of dataset ``key`` as f64 tensors on
    ``device`` (made once a device; :func:`prepared`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ck = (key, str(dev))
    if ck not in _ON:
        arrs = prepared(key)

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        _ON[ck] = {q: ({k: f64(v) for k, v in d.items() if k != "angular"}
                       | {"angular": d["angular"]})
                   if isinstance(d, dict) else f64(d)
                   for q, d in arrs.items()}
    return _ON[ck]


def interp0(name: str, u):
    """``(value, slope)`` of dataset op ``name``'s quantity at ``u`` (f64
    tensor, TT centuries), each NaN where ``u`` lies outside the table:
    the JAX ``_interp_rule`` with ``deriv`` False and True, one lookup for
    both.  ``value`` is what the op gives, ``slope`` the lane's ``S`` of
    the recurrence ``a_k = S u_k``."""
    key, qty, _ = parse_op(name)
    a = tables_on(key, u.device)
    q = a[qty]
    dates = a["date"]
    n = dates.shape[0]
    idx = torch.clamp(torch.searchsorted(dates, u.contiguous(), right=True)
                      - 1, 0, n - 2)
    valid = (u >= dates[0]) & (u <= dates[-1])
    slope = q["slope"][idx]
    du = u - dates[idx]
    if q["angular"]:
        v = q["hi"][idx] + (q["lo"][idx] + slope * du)
        twopi = 2.0 * math.pi
        v = v - twopi * torch.floor(v / twopi)
    else:
        v = q["v"][idx] + slope * du
    nan = torch.full_like(v, math.nan)
    return torch.where(valid, v, nan), torch.where(valid, slope, nan)


def evaluate(name: str, u):
    """Order 0 of dataset op ``name`` at ``u``: the interpolated value, or
    the slope for a ``_p`` op."""
    v, s = interp0(name, u)
    return s if parse_op(name)[2] else v
