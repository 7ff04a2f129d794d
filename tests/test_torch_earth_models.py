"""The port's Earth-orbit model library against the JAX package's: the
expressions of ``np1body*``, the Kepler helpers, ``sh_gravity_*`` and
``egm2008_*``, ``cart2geo``/``geo2cart``, the time conversions and the
thermoNET densities equal the JAX ones' (``repr``) on the same
arguments; the port's CPU ``cfunc`` of each agrees with the JAX ``cfunc``
at seeded points to 1e-14 of the largest magnitude of each output (XLA's
CPU ``sin``/``cos``/``atan``/``tanh``/``exp`` and torch's differ in the
last bits, ROADMAP's "Last bits of the CPU libraries"); the JAX tests' own
oracles (``tests/test_sh_gravity.py``, ``test_models.py``,
``test_frames_geo.py``, ``test_ephemeris.py``, ``test_s11n_gp_callback.py``)
run on the port; ``utils`` and ``gp`` are the JAX package's; the data
copies are byte-identical."""

import filecmp
import logging as std_logging
import math
from math import factorial, sqrt
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import lpmv

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.data import data_path
from heyoka_tpu_torch.models.sh_gravity import _egm2008_cs

RTOL = 1e-14
#: the Kepler solve of ``lagrange_prop`` (``kepDE``): the port freezes a
#: converged lane, the JAX loop iterates it until every lane has converged
#: (``expr/numeric.py``), and the angle's last bits scale with |DE| (up to
#: ~6 rad here)
NEWTON_RTOL = 1e-13
#: the thermoNET densities ``sum_i a_i exp(-(h - h_i) b_i)``: the last bits
#: of XLA's and torch's tanh (three layers of them) reach the exponent's
#: argument, tens in magnitude, where an ulp is ~1e-14 of the density
THERMO_RTOL = 5e-14
PT = np.array([5034231.0, -3214555.0, 2301444.7])  # test_sh_gravity.py
R = np.linalg.norm(PT)
P_ITRS = np.array([6524834.0, 1327012.0, -95321.5])  # test_frames_geo.py
REPO = Path(__file__).resolve().parents[1]


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(b).max(axis=0), 1e-300)
    np.testing.assert_array_less(np.abs(a - b).max(axis=0), rtol * scale
                                 + 1e-300)


def _cs(seed=3, n=4):
    """A dict of (deg, ord) -> (C, S) coefficients up to degree ``n``."""
    rng = np.random.default_rng(seed)
    cs = {(i, j): (float(rng.uniform(-1e-3, 1e-3)),
                   0.0 if j == 0 else float(rng.uniform(-1e-3, 1e-3)))
          for i in range(n + 1) for j in range(i + 1)}
    cs[(0, 0)] = (1.0, 0.0)
    return cs


def _xyz(pkg):
    return list(pkg.make_vars("x", "y", "z"))


#: name -> (build(pkg) -> list of expressions, input names, points (n,
#: inputs), per-point parameters or None)
def _pts(seed, n, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, (64, n))


def _leo(seed):
    """64 points 6,600-7,500 km from the centre, in m."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((64, 3))
    return d / np.linalg.norm(d, axis=1)[:, None] * rng.uniform(
        6.6e6, 7.5e6, (64, 1))


def _geodetic(pkg):
    h, lat, lon = pkg.make_vars("h", "lat", "lon")
    return [h, lat, lon]


_SW = np.random.default_rng(11)
CASES = {
    "sh_gravity_pot": (
        lambda p: [p.models.sh_gravity_pot(_xyz(p), 4, mu=1.0, a=1.0,
                                           CS=_cs())],
        "x y z", _pts(1, 3, 1.1, 2.0), None),
    "sh_gravity_acc": (
        lambda p: p.models.sh_gravity_acc(_xyz(p), 4, 3, mu=1.5, a=0.9,
                                          CS=_cs()),
        "x y z", _pts(2, 3, 1.1, 2.0), None),
    "egm2008_pot": (lambda p: [p.models.egm2008_pot(_xyz(p), 4)], "x y z",
                    _leo(3), None),
    "egm2008_acc": (lambda p: p.models.egm2008_acc(_xyz(p), 4, 4),
                    "x y z", _leo(4), None),
    "egm2008_acc_km_10_6": (
        lambda p: p.models.egm2008_acc(
            _xyz(p), 10, 6, mu=p.models.get_egm2008_mu() / 1e9,
            a=p.models.get_egm2008_a() / 1e3),
        "x y z", _leo(5) / 1e3, None),
    "np1body": (lambda p: [r for _, r in p.models.np1body(
        3, Gconst=1.1, masses=[1.0, 1e-3, 2e-3, 3e-3])],
        " ".join(f"{c}_{i}" for i in (1, 2, 3)
                 for c in ("x", "y", "z", "vx", "vy", "vz")),
        _pts(6, 18, -2.0, 2.0), None),
    "np1body_energy": (
        lambda p: [p.models.np1body_energy(3, masses=[1.0, 0.1, 0.2, 0.3]),
                   p.models.np1body_potential(3, Gconst=2.0)],
        " ".join(f"{c}_{i}" for i in (1, 2, 3)
                 for c in ("x", "y", "z", "vx", "vy", "vz")),
        _pts(7, 18, -2.0, 2.0), None),
    "lagrange_prop": (
        lambda p: p.models.lagrange_prop(mu=1.3), "x0 y0 z0 vx0 vy0 vz0",
        np.concatenate([_pts(8, 3, 0.8, 1.2), _pts(9, 3, 0.2, 0.5)], 1),
        None),
    "lagrange_prop_tof": (
        lambda p: p.models.lagrange_prop(
            pos_0=[1.0, 0.1, 0.0], vel_0=p.make_vars("u", "v", "w"),
            mu=p.par[0], tof=p.make_vars("tof")),
        "u v w tof", np.concatenate([_pts(10, 3, 0.2, 0.5),
                                     _pts(11, 1, -5.0, 5.0)], 1),
        _pts(12, 1, 0.9, 1.1)),
    "cart2geo": (lambda p: p.models.cart2geo(_xyz(p)), "x y z",
                 _leo(13), None),
    "cart2geo_km": (lambda p: p.models.cart2geo(
        _xyz(p), R_eq=6378.137, n_iters=6), "x y z", _leo(14) / 1e3, None),
    "geo2cart": (lambda p: p.models.geo2cart(_geodetic(p)), "h lat lon",
                 np.stack([_SW.uniform(2e5, 9e5, 64),
                           _SW.uniform(-1.5, 1.5, 64),
                           _SW.uniform(-3.1, 3.1, 64)], 1), None),
    "time_conversions": (
        lambda p: [p.models.delta_tdb_tt(), p.models.delta_tdb_tt(
            p.make_vars("t") * 2.0), p.models.delta_tt_tai + 0.0 *
            p.make_vars("t")],
        "t", _pts(15, 1, -3e9, 3e9), None),
    "nrlmsise00_tn": (
        lambda p: [p.models.nrlmsise00_tn(
            geodetic=_geodetic(p), f107=p.par[0], f107a=p.par[1],
            ap=p.par[2], time_expr=p.make_vars("t"))],
        "h lat lon t",
        np.stack([_SW.uniform(180.0, 1000.0, 64), _SW.uniform(-1.5, 1.5, 64),
                  _SW.uniform(-3.1, 3.1, 64), _SW.uniform(0.0, 365.0, 64)],
                 1),
        np.stack([_SW.uniform(70, 250, 64), _SW.uniform(70, 200, 64),
                  _SW.uniform(0, 50, 64)], 1)),
    "jb08_tn": (
        lambda p: [p.models.jb08_tn(
            geodetic=_geodetic(p), f107=p.par[0], f107a=p.par[1],
            s107=p.par[2], s107a=p.par[3], m107=p.par[4], m107a=p.par[5],
            y107=p.par[6], y107a=p.par[7], dDstdT=p.par[8],
            time_expr=p.make_vars("t"))],
        "h lat lon t",
        np.stack([_SW.uniform(180.0, 1000.0, 64), _SW.uniform(-1.5, 1.5, 64),
                  _SW.uniform(-3.1, 3.1, 64), _SW.uniform(0.0, 365.0, 64)],
                 1),
        np.concatenate([_SW.uniform(60, 250, (64, 8)),
                        _SW.uniform(0, 300, (64, 1))], 1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_expressions_are_jax_s(name):
    build = CASES[name][0]
    ej, ep = build(hy), build(ht)
    assert len(ej) == len(ep)
    for a, b in zip(ep, ej):
        assert repr(a) == repr(b)


@pytest.mark.parametrize("name", list(CASES))
def test_cfunc_agrees_with_jax(name):
    build, names, pts, pars = CASES[name]
    rtol = (NEWTON_RTOL if name.startswith("lagrange_prop") else
            THERMO_RTOL if name.endswith("_tn") else RTOL)
    vars_ = names.split()
    cj = hy.make_cfunc(build(hy), vars=vars_)
    cp = ht.make_cfunc(build(ht), vars=vars_, device="cpu")
    kw = {} if pars is None else {"pars": pars}
    out = cp(pts, **kw)
    assert out.shape == (64, cp.n_outs) and bool(torch.isfinite(out).all())
    _close(out.numpy(), cj(pts, **kw), rtol)


@pytest.mark.parametrize("name", ["egm2008.npz", "nrlmsise00_tn.npz",
                                  "jb08_tn.npz"])
def test_data_copies_are_byte_identical(name):
    assert filecmp.cmp(data_path(name), REPO / "heyoka_tpu" / "data" / name,
                       shallow=False)


def test_egm2008_getters_are_jax_s():
    m = ht.models
    assert m.get_egm2008_mu() == hy.models.get_egm2008_mu()
    assert m.get_egm2008_a() == hy.models.get_egm2008_a()
    np.testing.assert_array_equal(m.get_egm2008_CS(),
                                  hy.models.get_egm2008_CS())
    # a file the port does not ship (vsop2013_p9.npz ships since the
    # series slice)
    with pytest.raises(FileNotFoundError):
        data_path("no_such_table.npz")


# -- tests/test_sh_gravity.py's oracles on the port ---------------------------


def _cf(fns, vars_="x y z"):
    return ht.make_cfunc(fns, vars=vars_.split(), device="cpu")


def test_degree0_is_central():
    cf = _cf([ht.models.egm2008_pot(_xyz(ht), 0)])
    assert float(cf(PT)[0]) == pytest.approx(ht.models.get_egm2008_mu() / R,
                                             rel=1e-15)


def test_j2_closed_form():
    mu, a = ht.models.get_egm2008_mu(), ht.models.get_egm2008_a()
    cf = _cf([ht.models.egm2008_pot(_xyz(ht), 2, 0)])
    C20 = _egm2008_cs(2, 0)[0]
    sin_phi = PT[2] / R
    want = mu / R * (1 + sqrt(5.0) * C20 * (a / R) ** 2 * 0.5
                     * (3 * sin_phi ** 2 - 1))
    assert float(cf(PT)[0]) == pytest.approx(want, rel=1e-15)


def test_acc_is_gradient_of_pot():
    x, y, z = _xyz(ht)
    pot = ht.models.egm2008_pot([x, y, z], 6, 6)
    acc = ht.models.egm2008_acc([x, y, z], 6, 6)
    vals = _cf(acc + [ht.diff(pot, v) for v in (x, y, z)])(PT).numpy()
    np.testing.assert_allclose(vals[:3], vals[3:], rtol=0, atol=1e-13)


def test_against_scipy_legendre_oracle():
    mu, a = ht.models.get_egm2008_mu(), ht.models.get_egm2008_a()
    nmax = 10
    got = float(_cf([ht.models.egm2008_pot(_xyz(ht), nmax)])(PT)[0])
    lon = np.arctan2(PT[1], PT[0])
    lat = np.arcsin(PT[2] / R)
    tot = 0.0
    for i in range(nmax + 1):
        for j in range(i + 1):
            C, S = _egm2008_cs(i, j)
            Nf = sqrt((2 - (j == 0)) * (2 * i + 1) * factorial(i - j)
                      / factorial(i + j))
            # lpmv includes the Condon-Shortley phase; geodesy does not
            Pn = lpmv(j, i, np.sin(lat)) * (-1) ** j * Nf
            tot += (a / R) ** i * Pn * (C * np.cos(j * lon)
                                        + S * np.sin(j * lon))
    assert got == pytest.approx(mu / R * tot, rel=1e-14)


def test_custom_cs_order_clamp_and_degree_limit():
    CS = {(0, 0): (1.0, 0.0), (1, 0): (0.0, 0.0), (1, 1): (0.0, 0.0),
          (2, 0): (-1e-3, 0.0), (2, 1): (0.0, 0.0), (2, 2): (0.0, 0.0)}
    pot = ht.models.sh_gravity_pot(_xyz(ht), 2, mu=1.0, a=1.0, CS=CS)
    p = np.array([0.3, -0.2, 1.1])
    r = np.linalg.norm(p)
    want = 1.0 / r * (1 + sqrt(5.0) * -1e-3 * (1.0 / r) ** 2 * 0.5
                      * (3 * (p[2] / r) ** 2 - 1))
    assert float(_cf([pot])(p)[0]) == pytest.approx(want, rel=1e-14)
    with pytest.raises(ValueError, match="order"):
        ht.models.sh_gravity_pot(_xyz(ht), 2, 3, mu=1.0, a=1.0, CS=CS)
    with pytest.raises(ValueError, match="degree"):
        ht.models.egm2008_pot(_xyz(ht), 151)


# -- tests/test_models.py's oracles on the port -------------------------------


def test_np1body_matches_nbody():
    masses = [1.0, 1e-3, 2e-3]
    r1, v1 = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.1])
    r2, v2 = np.array([0.0, 1.5, 0.0]), np.array([-0.8, 0.0, 0.0])
    ta_h = ht.taylor_adaptive(ht.models.np1body(2, masses=masses),
                              np.concatenate([r1, v1, r2, v2]), tol=1e-11,
                              device="cpu")
    ta_h.propagate_until(3.0)
    ta_f = ht.taylor_adaptive(
        ht.models.nbody(3, masses=masses),
        np.concatenate([np.zeros(6), r1, v1, r2, v2]), tol=1e-11,
        device="cpu")
    ta_f.propagate_until(3.0)
    s = ta_f.state
    want = np.concatenate([s[6:9] - s[0:3], s[9:12] - s[3:6],
                           s[12:15] - s[0:3], s[15:18] - s[3:6]])
    np.testing.assert_allclose(ta_h.state, want, atol=1e-8)


def test_lagrange_prop_circular():
    cf = _cf(ht.models.lagrange_prop(mu=1.0), "x0 y0 z0 vx0 vy0 vz0")
    t = 1.3
    out = cf(np.array([1.0, 0, 0, 0, 1.0, 0]), time=t).numpy()
    want = [math.cos(t), math.sin(t), 0.0, -math.sin(t), math.cos(t), 0.0]
    np.testing.assert_allclose(out, want, atol=1e-12)


def test_kepler_roundtrip_and_jax_s():
    el = (1.3, 0.25, 0.4, 1.1, 2.2, 0.7)
    st = ht.models.kepler_to_cartesian(*el, mu=1.7)
    np.testing.assert_allclose(ht.models.cartesian_to_kepler(st, mu=1.7), el,
                               atol=1e-12)
    np.testing.assert_array_equal(st, hy.models.kepler_to_cartesian(
        *el, mu=1.7))
    assert ht.models.cartesian_to_kepler(st, mu=1.7) == \
        hy.models.cartesian_to_kepler(st, mu=1.7)


# -- tests/test_frames_geo.py's and tests/test_ephemeris.py's on the port ----


def test_cart2geo_roundtrip():
    g = _cf(ht.models.cart2geo(_xyz(ht)))(P_ITRS).numpy()
    assert -1e5 < g[0] < 1e6 and abs(g[1]) < math.pi / 2
    cfc = _cf(ht.models.geo2cart(_geodetic(ht)), "h lat lon")
    np.testing.assert_allclose(cfc(g).numpy(), P_ITRS, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="n_iters"):
        ht.models.cart2geo(_xyz(ht), n_iters=0)


def test_delta_tt_tai_and_tdb():
    assert float(ht.models.delta_tt_tai.value) == 32.184
    t = ht.make_vars("t")
    cf = _cf([ht.models.delta_tdb_tt(t)], "t")
    vals = cf(np.linspace(0, 3.2e7, 50).reshape(-1, 1)).numpy()[:, 0]
    assert np.max(np.abs(vals)) <= 1.657e-3 + 1e-12
    assert np.max(vals) > 1.0e-3


def test_thermonets_density_ranges():
    m = ht.models

    def rho(fn, h, **kw):
        return float(_cf([fn(geodetic=[h, 0.4, 1.0], time_expr=180.0, **kw)],
                         "")(np.zeros(0))[0])

    nrl = dict(f107=150.0, f107a=140.0, ap=12.0)
    v400 = rho(m.nrlmsise00_tn, 400.0, **nrl)
    assert 1e-13 < v400 < 1e-11
    assert rho(m.nrlmsise00_tn, 300.0, **nrl) > 3 * v400
    vj = rho(m.jb08_tn, 400.0, f107=150.0, f107a=140.0, s107=140.0,
             s107a=135.0, m107=140.0, m107a=135.0, y107=140.0, y107a=135.0,
             dDstdT=50.0)
    assert 1e-13 < vj < 1e-11 and 0.2 < vj / v400 < 5.0


# -- utils, gp and logging ---------------------------------------------------


def test_utils_are_jax_s():
    from heyoka_tpu import utils as ju

    jd = np.array([2441317.5, 2444239.5, 2451545.0, 2457753.5, 2457754.5,
                   2460000.25, 2437300.5])
    fr = np.array([0.0, 0.25, 0.5, 0.999, 0.0, 0.125, 0.3])
    for f in ("jd_utc_to_tai", "jd_tai_to_utc", "jd_tai_to_tt",
              "jd_tt_to_tai", "jd_utc_to_tt", "jd_to_cal"):
        for a, b in zip(getattr(ht.utils, f)(jd, fr), getattr(ju, f)(jd, fr)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ht.utils.tai_minus_utc(jd, fr),
                                  ju.tai_minus_utc(jd, fr))
    np.testing.assert_array_equal(ht.utils.cal_to_jd(2016, 12, [30, 31]),
                                  ju.cal_to_jd(2016, 12, [30, 31]))


def test_gp_generator_and_operators():
    gen = ht.gp.ExpressionGenerator(["x", "y"], rng=42)
    e = gen(2, 4)
    assert repr(e) == repr(hy.gp.ExpressionGenerator(["x", "y"], rng=42)(2, 4))
    n = ht.gp.count_nodes(e)
    assert n >= 3 and ht.gp.fetch_from_node_id(e, 0) is e
    assert ht.gp.fetch_from_node_id(e, n - 1) is not None
    e2 = ht.gp.mutate(e, gen, rng=1)
    assert ht.gp.count_nodes(e2) >= 1
    a, b = ht.gp.crossover(e, e2, rng=2)
    assert ht.gp.count_nodes(a) >= 1 and ht.gp.count_nodes(b) >= 1
    vs = sorted(ht.get_variables(e)) or ["x"]
    out = ht.make_cfunc([e], vars=vs, device="cpu")(np.full((len(vs),), 0.37))
    assert out.shape == (1,)


def test_logging_levels_and_timer():
    ht.set_logger_level_trace()
    with ht.logging.SimpleTimer("unit-test") as t:
        pass
    assert t.elapsed >= 0.0
    ht.set_logger_level_warn()
    assert ht.logging.logger.level == std_logging.WARNING == 30
    ht.set_logger_level_err()
    assert ht.logging.logger.level == std_logging.ERROR
    ht.set_logger_level_warn()
    with ht.logging.trace_ctx("region") as r:
        assert r is None
