"""ThermoNET thermospheric density models: NRLMSISE00 and JB08 surrogates,
copied from ``heyoka_tpu.models.thermonets``.

Reference parity: ``model::nrlmsise00_tn`` / ``model::jb08_tn``
(``include/heyoka/model/nrlmsise00_tn.hpp``, ``jb08_tn.hpp``,
``src/model/nrlmsise00_tn.cpp``, ``jb08_tn.cpp``): the published thermoNET
neural surrogates (Izzo et al.) of the NRLMSISE-00 and JB08 empirical
thermosphere models, expressed as a 32x32-tanh FFNN over normalized
geodetic/space-weather inputs whose 12 outputs modulate a 4-term
exponential-altitude density profile.  Trained weights ship as packaged data,
the port's byte-identical copies (``heyoka_tpu_torch/data/*_tn.npz``).

Inputs: ``geodetic = [h, lat, lon]`` with h in km; ``time_expr`` is the
fractional number of days since Jan 1 00:00:00 UTC (``models.dayfrac``);
space-weather indices as expressions (the ``models.sw`` interpolants, as
``models.eo_dynamics`` gives them, or parameters).  Output: density in
kg/m^3.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..data import data_path
from ..expr.core import expr
from ..expr.math import cos, exp, sin, sum_ as _sum, tanh
from .ffnn import ffnn

__all__ = ["nrlmsise00_tn", "jb08_tn"]

_TWO_PI = 2.0 * math.pi


@lru_cache(maxsize=2)
def _weights(name: str):
    with np.load(data_path(f"{name}.npz")) as d:
        return d["best_global_fit"], d["flattened_nw"]


def _norm(x, lo: float, hi: float):
    return 2.0 * (expr(x) - lo) / (hi - lo) - 1.0


def _rho_profile(h, params):
    """4-term exponential altitude profile: sum_i a_i exp(-(h - h_i) b_i)."""
    return _sum(
        [params[i] * exp(-(expr(h) - params[i + 8]) * params[i + 4]) for i in range(4)]
    )


def _common_inputs(geodetic, time_expr):
    if len(geodetic) != 3:
        raise ValueError("geodetic must be [h, lat, lon]")
    h, lat, lon = (expr(c) for c in geodetic)
    te = expr(time_expr)
    sid = te * _TWO_PI  # Earth rotations since Jan 1 (rad)
    doy = te * (_TWO_PI / 365.25)  # orbit fraction since Jan 1 (rad)
    base = [
        sin(lon),
        cos(lon),
        _norm(lat, -0.5 * math.pi, 0.5 * math.pi),
        sin(sid),
        cos(sid),
        sin(doy),
        cos(doy),
    ]
    return h, base


def nrlmsise00_tn(*, geodetic, f107, f107a, ap, time_expr):
    """NRLMSISE-00 thermoNET density [kg/m^3].

    ``f107``: F10.7 of the *previous* day; ``f107a``: 81-day centered
    average; ``ap``: daily average Ap.
    """
    h, inputs = _common_inputs(geodetic, time_expr)
    inputs += [
        _norm(f107, 60.0, 266.0),
        _norm(f107a, 60.0, 170.0),
        _norm(ap, 0.0, 110.0),
    ]
    bgf, nw = _weights("nrlmsise00_tn")
    delta = ffnn(inputs, [32, 32], 12, [tanh, tanh, tanh], nn_wb=nw)
    # the gamma (inverse-scale-height) outputs were trained with a 5x range
    # extension
    for i in range(8, 12):
        delta[i] = delta[i] * 5.0
    params = [float(bgf[i]) * (1.0 + delta[i]) for i in range(12)]
    return _rho_profile(h, params)


def jb08_tn(*, geodetic, f107, f107a, s107, s107a, m107, m107a, y107, y107a,
            dDstdT, time_expr):
    """JB08 thermoNET density [kg/m^3] (solar indices S10.7/M10.7/Y10.7 and
    the dDst/dT storm driver, as in the JB2008 model)."""
    h, inputs = _common_inputs(geodetic, time_expr)
    inputs += [
        _norm(f107, 60.0, 266.0),
        _norm(f107a, 60.0, 170.0),
        _norm(s107, 50.0, 190.0),
        _norm(s107a, 50.0, 170.0),
        _norm(m107, 50.0, 190.0),
        _norm(m107a, 50.0, 160.0),
        _norm(y107, 50.0, 180.0),
        _norm(y107a, 50.0, 170.0),
        _norm(dDstdT, 0.0, 390.0),
    ]
    bgf, nw = _weights("jb08_tn")
    delta = ffnn(inputs, [32, 32], 12, [tanh, tanh, tanh], nn_wb=nw)
    params = [float(bgf[i]) * (1.0 + delta[i]) for i in range(12)]
    return _rho_profile(h, params)
