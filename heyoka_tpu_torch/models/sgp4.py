"""SGP4 analytic satellite propagation, copied from
``heyoka_tpu.models.sgp4`` with the propagator in f64 torch.

Reference parity: ``model::sgp4()`` / ``model::sgp4_propagator``
(``include/heyoka/model/sgp4.hpp``, ``src/model/sgp4.cpp``).  The underlying
theory is the public near-Earth SGP4 model (Spacetrack Report #3 with the
Vallado updates; WGS72 constants), built as a symbolic expression graph
over :mod:`heyoka_tpu_torch.expr` (the same graph as the JAX package's), so
that

- the propagator evaluates one decomposed tape over every (satellite,
  time) point at once with the port's compiled functions
  (``cfunc.tape_eval``: one f64 torch op a tape row on the device), where
  the JAX package jits a ``vmap`` of the same tape;
- derivatives of the Cartesian state w.r.t. the GPEs (reference kwarg
  ``diff_order``) come from nested ``torch.func.jacfwd`` over that tape
  under ``torch.func.vmap``, the JAX package's design (nested
  ``jax.jacfwd``).

The Kepler solve (``kepF``) runs the port's masked Newton loop
(``expr/numeric.py``: every lane 50 iterations, a converged lane frozen),
where the JAX loop stops once all lanes have converged: the two agree to
the last bits of the solve.

Deep-space orbits (period >= 225 min) are outside the SGP4 theory and are
rejected, exactly like the reference (``gpe_is_deep_space``,
``src/model/sgp4.cpp:678``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cfunc import make_cfunc, tape_eval
from ..convert import check_dtype, numpy_dtype
from ..expr.core import expr, make_vars
from ..expr.math import (
    sin, cos, sqrt, atan2, kepF, select, gt, lt, eq, logical_or, pi,
    ge as gte, le as lte,
)

__all__ = ["sgp4", "gpe_is_deep_space", "SGP4Propagator", "sgp4_propagator"]

# WGS72 gravity model constants, as used by the official SGP4 distribution
# and the reference (``src/model/sgp4.cpp:95-108``).
KMPER = 6378.135  # Earth radius [km]
KE = 0.07436691613317342  # sqrt(GM) in (earth radii)^1.5 / min
J2 = 1.082616e-3
J3 = -0.253881e-5
J4 = -0.00000165597
CK2 = 0.5 * J2
CK4 = -0.375 * J4
A3OVK2 = -J3 / CK2
S0 = 20.0 / KMPER
S1 = 78.0 / KMPER
Q0 = 120.0 / KMPER
SIMPHT = 220.0 / KMPER  # below this perigee height the simplified model is used
TOTHRD = 2.0 / 3.0

#: Names of the per-satellite constants produced by the init stage, in order.
IQ_NAMES = (
    "MDOT", "OMGDOT", "N0DOT", "NODCF", "C4", "C1", "T2COF", "MCOF", "ETA",
    "DELM0", "OMGCOF", "PERIGE", "C5", "SINM0", "D2", "D3", "D4", "T3COF",
    "T4COF", "T5COF", "A0DP", "AYCOF", "LCOF", "N0DP", "X3THM1", "X1MTH2",
    "X7THM1", "COSI0", "SINI0",
)


def _abs(x):
    return select(gte(x, 0.0), x, -expr(x))


def _max(a, b):
    return select(gt(a, b), a, b)


def _min(a, b):
    return select(lt(a, b), a, b)


def _actan(y, x):
    """atan2 shifted into [0, 2*pi] (the original theory's ACTAN)."""
    r = atan2(y, x)
    return select(gte(r, 0.0), r, 2.0 * pi + r)


def _unkozai(n0, e0, i0):
    """Recover the Brouwer ("un-Kozai'd") mean motion and the derived
    semi-major axis from the TLE mean elements (Vallado's updated recovery)."""
    a1 = (KE / n0) ** TOTHRD
    cosi0 = cos(i0)
    theta2 = cosi0 * cosi0
    x3thm1 = 3.0 * theta2 - 1.0
    beta02 = 1.0 - e0 * e0
    beta0 = sqrt(beta02)
    dela2 = 1.5 * CK2 * x3thm1 / (beta0 * beta02)
    del1 = dela2 / (a1 * a1)
    a0 = a1 * (1.0 - del1 * (1.0 / 3.0 + del1 * (1.0 + 134.0 / 81.0 * del1)))
    del0 = dela2 / (a0 * a0)
    n0dp = n0 / (1.0 + del0)
    return n0dp, cosi0, theta2, x3thm1, beta02, beta0


def _sgp4_init(n0, e0, i0, node0, omega0, m0, bstar) -> dict:
    """Time-independent stage: per-satellite secular/drag constants.

    Returns a dict keyed by :data:`IQ_NAMES`.  Matches the behaviour of the
    reference's init half (``sgp4_init``, ``src/model/sgp4.cpp:113``),
    including the Vallado low-eccentricity and i ~ 180 deg guards.
    """
    n0dp, cosi0, theta2, x3thm1, beta02, beta0 = _unkozai(n0, e0, i0)

    a0dp = (KE / n0dp) ** TOTHRD
    perige = a0dp * (1.0 - e0) - 1.0  # perigee height in earth radii

    s = _min(_max(S0, perige - S1), S1)
    s4 = 1.0 + s
    pinvsq = 1.0 / (a0dp * beta02) ** 2.0
    xi = 1.0 / (a0dp - s4)
    eta = a0dp * xi * e0
    etasq = eta * eta
    eeta = e0 * eta
    psisq = _abs(1.0 - etasq)
    coef = ((Q0 - s) * xi) ** 4.0
    coef1 = coef / (sqrt(psisq) * psisq ** 3.0)
    c1 = bstar * coef1 * n0dp * (
        a0dp * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
        + 0.75 * CK2 * xi / psisq * x3thm1 * (8.0 + 3.0 * etasq * (8.0 + etasq))
    )
    sini0 = sin(i0)
    # low-eccentricity guard on the e0-division (Vallado fix)
    c3 = select(gt(e0, 1.0e-4), coef * xi * A3OVK2 * n0dp * sini0 / e0, 0.0)
    x1mth2 = 1.0 - theta2
    c4 = 2.0 * n0dp * coef1 * a0dp * beta02 * (
        eta * (2.0 + 0.5 * etasq)
        + e0 * (0.5 + 2.0 * etasq)
        - 2.0 * CK2 * xi / (a0dp * psisq) * (
            -3.0 * x3thm1 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
            + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq)) * cos(2.0 * omega0)
        )
    )
    c5 = 2.0 * coef1 * a0dp * beta02 * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq)
    theta4 = theta2 * theta2
    temp1 = 3.0 * CK2 * pinvsq * n0dp
    temp2 = temp1 * CK2 * pinvsq
    temp3 = 1.25 * CK4 * pinvsq * pinvsq * n0dp
    mdot = (
        n0dp
        + 0.5 * temp1 * beta0 * x3thm1
        + 0.0625 * temp2 * beta0 * (13.0 - 78.0 * theta2 + 137.0 * theta4)
    )
    omgdot = (
        -0.5 * temp1 * (1.0 - 5.0 * theta2)
        + 0.0625 * temp2 * (7.0 - 114.0 * theta2 + 395.0 * theta4)
        + temp3 * (3.0 - 36.0 * theta2 + 49.0 * theta4)
    )
    hdot1 = -temp1 * cosi0
    n0dot = hdot1 + (0.5 * temp2 * (4.0 - 19.0 * theta2) + 2.0 * temp3 * (3.0 - 7.0 * theta2)) * cosi0
    omgcof = bstar * c3 * cos(omega0)
    mcof = select(gt(e0, 1.0e-4), -TOTHRD * coef * bstar / eeta, 0.0)
    nodcf = 3.5 * beta02 * hdot1 * c1
    t2cof = 1.5 * c1
    # i ~ 180 deg guard on the 1/(1+cos i) division (Vallado fix)
    lcof = (
        0.125 * A3OVK2 * sini0 * (3.0 + 5.0 * cosi0)
        / select(gt(_abs(1.0 + cosi0), 1.5e-12), 1.0 + cosi0, 1.5e-12)
    )
    aycof = 0.25 * A3OVK2 * sini0
    delm0 = (1.0 + eta * cos(m0)) ** 3.0
    sinm0 = sin(m0)
    x7thm1 = 7.0 * theta2 - 1.0

    # low-perigee truncation coefficients (quadratic mean-anomaly variation)
    c1sq = c1 * c1
    d2 = 4.0 * a0dp * xi * c1sq
    temp0 = d2 * xi * c1 / 3.0
    d3 = (17.0 * a0dp + s4) * temp0
    d4 = 0.5 * temp0 * a0dp * xi * (221.0 * a0dp + 31.0 * s4) * c1
    t3cof = d2 + 2.0 * c1sq
    t4cof = 0.25 * (3.0 * d3 + c1 * (12.0 * d2 + 10.0 * c1sq))
    t5cof = 0.2 * (3.0 * d4 + 12.0 * c1 * d3 + 6.0 * d2 * d2 + 15.0 * c1sq * (2.0 * d2 + c1sq))

    vals = (
        mdot, omgdot, n0dot, nodcf, c4, c1, t2cof, mcof, eta, delm0, omgcof,
        perige, c5, sinm0, d2, d3, d4, t3cof, t4cof, t5cof, a0dp, aycof,
        lcof, n0dp, x3thm1, x1mth2, x7thm1, cosi0, sini0,
    )
    return dict(zip(IQ_NAMES, vals))


def _sgp4_tprop(e0, i0, node0, omega0, m0, bstar, tsince, iq: dict) -> list:
    """Time propagation stage: secular + periodic updates, Kepler solve,
    short-period corrections, Cartesian state assembly.

    Returns ``[x, y, z, vx, vy, vz, error_code]`` in km / km/s, mirroring the
    reference output convention (``sgp4_time_prop``, ``src/model/sgp4.cpp:228``).
    Error codes: 0 ok, 2 non-positive recovered mean motion, 1 eccentricity
    out of range, 4 negative semilatus rectum, 6 decayed (r < 1 earth radius).
    """
    q = iq
    simp = gte(q["PERIGE"], SIMPHT)  # 1.0 when the full (non-truncated) model applies

    errcode = select(lte(q["N0DP"], 0.0), 2.0, 0.0)

    # secular gravity + drag
    mp = m0 + q["MDOT"] * tsince
    omega = omega0 + q["OMGDOT"] * tsince
    node = node0 + (q["N0DOT"] + q["NODCF"] * tsince) * tsince
    tempe = q["C4"] * tsince
    tempa = 1.0 - q["C1"] * tsince
    templ = expr(q["T2COF"])
    tempf = q["MCOF"] * ((1.0 + q["ETA"] * cos(mp)) ** 3.0 - q["DELM0"]) + q["OMGCOF"] * tsince

    mp = mp + select(simp, tempf, 0.0)
    omega = omega - select(simp, tempf, 0.0)
    tempe = tempe + select(simp, q["C5"] * (sin(mp) - q["SINM0"]), 0.0)
    tempa = tempa - select(
        simp, (q["D2"] + (q["D3"] + q["D4"] * tsince) * tsince) * tsince * tsince, 0.0
    )
    templ = templ + select(
        simp, (q["T3COF"] + (q["T4COF"] + q["T5COF"] * tsince) * tsince) * tsince, 0.0
    )

    a = q["A0DP"] * tempa * tempa
    n = KE / a ** 1.5
    e = e0 - tempe * bstar
    errcode = select(eq(errcode, 0.0), select(logical_or(gte(e, 1.0), lt(e, -0.001)), 1.0, 0.0), errcode)
    e = select(lt(e, 1e-6), 1e-6, e)
    templ = templ * tsince * tsince

    # long-period periodics
    axn = e * cos(omega)
    ab = a * (1.0 - e * e)
    ayn = q["AYCOF"] / ab + e * sin(omega)

    # Kepler solve for the eccentric longitude analog E + omega: it satisfies
    # the kepF equation with h = e sin(omega), k = e cos(omega) (see the
    # reference's note on Broucke's eccentric longitude, sgp4.cpp:289-300)
    capu = q["LCOF"] * axn / ab + mp + omega + q["N0DP"] * templ
    epw = kepF(ayn, axn, capu)
    sinepw = sin(epw)
    cosepw = cos(epw)
    esine = axn * sinepw - ayn * cosepw
    ecose = axn * cosepw + ayn * sinepw

    # short-period preliminaries
    elsq = axn * axn + ayn * ayn
    temps = 1.0 - elsq
    pl = a * temps
    errcode = select(eq(errcode, 0.0), select(lt(pl, 0.0), 4.0, 0.0), errcode)

    r = a * (1.0 - ecose)
    rdot = KE * sqrt(a) * esine / r
    rfdot = KE * sqrt(pl) / r
    betal = sqrt(temps)
    t3 = esine / (1.0 + betal)
    cosu = (cosepw - axn + ayn * t3) * a / r
    sinu = (sinepw - ayn - axn * t3) * a / r
    u = _actan(sinu, cosu)
    sin2u = 2.0 * sinu * cosu
    cos2u = 2.0 * cosu * cosu - 1.0
    temp1 = CK2 / pl
    temp2 = temp1 / pl

    # short-period corrections
    rk = r * (1.0 - 1.5 * temp2 * betal * q["X3THM1"]) + 0.5 * temp1 * q["X1MTH2"] * cos2u
    uk = u - 0.25 * temp2 * q["X7THM1"] * sin2u
    nodek = node + 1.5 * temp2 * q["COSI0"] * sin2u
    ik = i0 + 1.5 * temp2 * q["COSI0"] * q["SINI0"] * cos2u
    rdotk = rdot - n * temp1 * q["X1MTH2"] * sin2u
    rfdotk = rfdot + n * temp1 * (q["X1MTH2"] * cos2u + 1.5 * q["X3THM1"])

    # orientation vectors
    sinuk, cosuk = sin(uk), cos(uk)
    sinik, cosik = sin(ik), cos(ik)
    sinnok, cosnok = sin(nodek), cos(nodek)
    mx = -sinnok * cosik
    my = cosnok * cosik
    ux = mx * sinuk + cosnok * cosuk
    uy = my * sinuk + sinnok * cosuk
    uz = sinik * sinuk
    vx = mx * cosuk - cosnok * sinuk
    vy = my * cosuk - sinnok * sinuk
    vz = sinik * cosuk

    errcode = select(eq(errcode, 0.0), select(lt(rk, 1.0), 6.0, 0.0), errcode)

    velf = KMPER / 60.0
    return [
        rk * ux * KMPER,
        rk * uy * KMPER,
        rk * uz * KMPER,
        (rdotk * ux + rfdotk * vx) * velf,
        (rdotk * uy + rfdotk * vy) * velf,
        (rdotk * uz + rfdotk * vz) * velf,
        errcode,
    ]


def sgp4(inputs=None) -> list:
    """Full symbolic SGP4: Cartesian TEME state + error code as expressions
    of ``[n0, e0, i0, node0, omega0, m0, bstar, tsince]``.

    With ``inputs=None``, variables with those names are used (reference:
    ``model::sgp4()``, ``src/model/sgp4.cpp:401``).
    """
    if inputs is None:
        inputs = make_vars("n0", "e0", "i0", "node0", "omega0", "m0", "bstar", "tsince")
    inputs = [expr(x) for x in inputs]
    if len(inputs) != 8:
        raise ValueError(f"sgp4() expects 8 inputs, got {len(inputs)}")
    n0, e0, i0, node0, omega0, m0, bstar, tsince = inputs
    iq = _sgp4_init(n0, e0, i0, node0, omega0, m0, bstar)
    return _sgp4_tprop(e0, i0, node0, omega0, m0, bstar, tsince, iq)


def gpe_is_deep_space(n0, e0, i0):
    """True when the GPE describes a deep-space (period >= 225 min) orbit,
    which SGP4 cannot propagate (reference ``src/model/sgp4.cpp:678``)."""
    n0 = np.asarray(n0, dtype=np.float64)
    e0 = np.asarray(e0, dtype=np.float64)
    i0 = np.asarray(i0, dtype=np.float64)
    cosio = np.cos(i0)
    omeosq = 1.0 - e0 * e0
    d1 = 0.75 * J2 * (3.0 * cosio * cosio - 1.0) / (np.sqrt(omeosq) * omeosq)
    ak = (KE / n0) ** (2.0 / 3.0)
    dl = d1 / (ak * ak)
    adel = ak * (1.0 - dl * dl - dl * (1.0 / 3.0 + 134.0 * dl * dl / 81.0))
    dl = d1 / (adel * adel)
    no_unkozai = n0 / (1.0 + dl)
    return 2.0 * np.pi / no_unkozai >= 225.0


def _order_multisets(n_args: int, order: int):
    """Multisets of ``order`` argument indices in the dtens colex order
    (sorted by reversed per-arg count tuple — matches
    ``dtens.get_derivatives``)."""
    import itertools

    def counts_of(comb):
        c = [0] * n_args
        for j in comb:
            c[j] += 1
        return tuple(c)

    combs = list(itertools.combinations_with_replacement(range(n_args), order))
    combs.sort(key=lambda cb: counts_of(cb)[::-1])
    return combs


def _dtens_flat_indices(n_args: int, n_outs: int, order: int):
    """Flat [(component, counts), ...] in dtens ordering: graded by total
    order, then component, then colex multi-index."""
    out = []
    for o in range(order + 1):
        combs = _order_multisets(n_args, o)
        for comp in range(n_outs):
            for comb in combs:
                c = [0] * n_args
                for j in comb:
                    c[j] += 1
                out.append((comp, tuple(c)))
    return out


class SGP4Propagator:
    """Batch SGP4 propagator over a satellite constellation.

    Reference parity: ``sgp4_propagator<T>`` (``model/sgp4.hpp:63-245``).
    ``sat_data`` is the (9, n_sats) GPE layout documented there (and in
    :mod:`heyoka_tpu_torch.utils.tle`).  One compiled function of the
    symbolic SGP4 (:func:`sgp4`) on ``device`` (CUDA unless the caller
    asks for the CPU) is evaluated over the flattened (n_evals x n_sats)
    points at once; results are tensors of ``dtype`` (float64 or float32,
    the JAX class's two) on that device, as the port's ``cfunc`` returns
    them.

    ``diff_order > 0`` adds derivatives of the Cartesian state w.r.t.
    ``[n0, e0, i0, node0, omega0, m0, bstar]``: ``diff_order`` nested
    ``torch.func.jacfwd`` over the tape under ``torch.func.vmap`` over the
    points.  Outputs are then ordered like the reference's dtens
    (``get_dslice`` / ``get_mindex`` give the layout).
    """

    _VARS = ("n0", "e0", "i0", "node0", "omega0", "m0", "bstar")

    def __init__(self, sat_data, *, diff_order: int = 0, dtype=np.float64,
                 device="cuda"):
        self._dtype = numpy_dtype(check_dtype(dtype))
        self._diff_order = int(diff_order)
        self._cf = make_cfunc(sgp4(), vars=list(self._VARS) + ["tsince"],
                              device=device, dtype=self._dtype)
        self.replace_sat_data(sat_data)
        self._mindex = _dtens_flat_indices(7, 7, self._diff_order)
        self._nouts = len(self._mindex)
        # per order o >= 1: the flat positions, in a (7, 7**o) view of the
        # jacfwd tensor, of the outputs in the dtens order
        self._dsel = [
            torch.tensor([c * 7 ** o + int(np.ravel_multi_index(cb, (7,) * o))
                          for c in range(7)
                          for cb in _order_multisets(7, o)],
                         device=self.device)
            for o in range(1, self._diff_order + 1)]
        self._eval_d = None

    @property
    def device(self) -> torch.device:
        return self._cf.device

    # -- satellite data -------------------------------------------------------

    def replace_sat_data(self, sat_data):
        sat_data = np.asarray(sat_data, dtype=np.float64)
        if sat_data.ndim != 2 or sat_data.shape[0] != 9 or sat_data.shape[1] == 0:
            raise ValueError("sat_data must have shape (9, n_sats) with n_sats > 0")
        deep = gpe_is_deep_space(sat_data[0], sat_data[1], sat_data[2])
        if np.any(deep):
            bad = np.nonzero(deep)[0]
            raise ValueError(
                f"deep-space GPEs (period >= 225 min) at satellite indices "
                f"{bad.tolist()}: not propagatable with SGP4"
            )
        self._sat_data = sat_data
        self._els = torch.as_tensor(sat_data[:7].T.astype(self._dtype),
                                    device=self.device)  # (n_sats, 7)
        self._epoch_jd = sat_data[7]
        self._epoch_frac = sat_data[8]

    def get_sat_data(self) -> np.ndarray:
        return self._sat_data

    @property
    def nsats(self) -> int:
        return self._sat_data.shape[1]

    @property
    def nouts(self) -> int:
        return self._nouts

    @property
    def diff_order(self) -> int:
        return self._diff_order

    @property
    def diff_args(self):
        return list(make_vars(*self._VARS))

    def get_dslice(self, order: int, component: int | None = None):
        """Flat output range [begin, end) of the derivatives at a given total
        order (optionally of one Cartesian component)."""
        idxs = [
            i
            for i, (comp, counts) in enumerate(self._mindex)
            if sum(counts) == order and (component is None or comp == component)
        ]
        if not idxs:
            raise ValueError(f"no derivatives at order {order}")
        return idxs[0], idxs[-1] + 1

    def get_mindex(self, i: int):
        """(component, counts) multi-index of flat output position ``i``."""
        return self._mindex[i]

    # -- evaluation -----------------------------------------------------------

    def _tsince_from_dates(self, jd, frac):
        """UTC (jd, frac) pairs -> minutes since each satellite's epoch,
        via TAI to propagate correctly across leap seconds
        (``sgp4.hpp:268-270``)."""
        from ..utils.timeconv import jd_utc_to_tai

        p_hi, p_lo = jd_utc_to_tai(jd, frac)
        e_hi, e_lo = jd_utc_to_tai(self._epoch_jd, self._epoch_frac)
        return ((p_hi - e_hi) + (p_lo - e_lo)) * 1440.0

    def __call__(self, times=None, *, jd=None, frac=None):
        """Propagate every satellite.

        ``times``: minutes since each satellite's epoch, shape ``(n_sats,)``
        for one evaluation per satellite -> out ``(n_sats, nouts)``, or
        ``(n_evals, n_sats)`` -> out ``(n_evals, n_sats, nouts)``.
        Alternatively pass UTC Julian dates via ``jd``/``frac`` arrays of the
        same shapes (converted on the host).  A tensor on another device
        than the propagator's raises.
        """
        if times is None:
            if jd is None:
                raise ValueError("provide either times or jd[/frac]")
            jd = np.asarray(jd, dtype=np.float64)
            frac = np.zeros_like(jd) if frac is None else np.asarray(frac, np.float64)
            times = self._tsince_from_dates(jd, frac)
        times = self._cf._tensor(times, "times")
        if times.ndim not in (1, 2):
            raise ValueError("times must be 1-D or 2-D")
        if times.shape[-1] != self.nsats:
            raise ValueError("times must have shape (n_sats,) or "
                             "(n_evals, n_sats)")
        lead = times.shape
        els = self._els.expand(*lead, 7).reshape(-1, 7)
        t = times.reshape(-1)
        if self._diff_order == 0:
            out = self._cf(torch.cat([els, t[:, None]], 1))
        else:
            out = self._derivatives(els, t)
        return out.reshape(*lead, self._nouts)

    def _derivatives(self, els, t):
        """The values and derivatives up to ``diff_order`` at the points
        ``els`` (N, 7), ``t`` (N,): (N, nouts) in the dtens order."""
        if self._eval_d is None:
            from torch.func import jacfwd, vmap

            tape = self._cf.tape
            korder, dsel = self._diff_order, self._dsel

            def base(el, tt):
                inp = torch.cat([el, tt[None]])
                zero = inp.new_zeros(())
                return torch.stack(tape_eval(tape, inp, inp.new_zeros(0),
                                             zero))

            def one(el, tt):
                blocks = [base(el, tt)]
                d = lambda e: base(e, tt)  # noqa: E731
                for o in range(1, korder + 1):
                    d = jacfwd(d)
                    blocks.append(d(el).reshape(-1)[dsel[o - 1]])
                return torch.cat(blocks)

            self._eval_d = vmap(one)
        return self._eval_d(els, t)

    def __getstate__(self):
        return {
            "sat_data": self._sat_data,
            "diff_order": self._diff_order,
            "dtype": self._dtype.name,
            "device": str(self.device),
        }

    def __setstate__(self, st):
        """Rebuild on the pickled device (raises where it is absent)."""
        self.__init__(
            st["sat_data"], diff_order=st["diff_order"], dtype=st["dtype"],
            device=st["device"],
        )

    def __repr__(self):
        return (
            f"SGP4Propagator(nsats={self.nsats}, nouts={self.nouts}, "
            f"diff_order={self._diff_order}, dtype={self._dtype.name}, "
            f"device={self.device})"
        )


def sgp4_propagator(sat_data, **kw) -> SGP4Propagator:
    """Factory mirroring the reference's ``sgp4_propagator<T>`` ctor."""
    return SGP4Propagator(sat_data, **kw)
