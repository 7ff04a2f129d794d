"""The phase route's test tapes and lanes, shared by ``chip_smoke.py``
(phases 10-12), the tests and :mod:`.same_bits`, the small cases of the
batch integrator's three routes (the tests), BASELINE config 5's systems
(phase 23), the ephemeris tapes and random series (phase 24) and the
Earth-orientation systems (phase 25).

The module imports numpy only and takes the package that builds the
systems as an argument (this port, or the JAX package in the tests), so
that ``same_bits.py`` can load it from its own directory and give any
checkout of the port the same inputs.
"""

from __future__ import annotations

import numpy as np


def phase_cases(pkg):
    """The tapes of phase 10, built with ``pkg`` (this port; the tests
    also pass the JAX package): name -> (ODE system, state (2,), pars).
    The pendulum, the mixed systems of ``tests/test_compact.py``, two
    for the hyperbolic, division and logical ops, and one per op of
    ``tests/test_pallas_ops.py``; every state is away from the switch
    points of relu, select and the relational ops."""
    m = pkg.math
    x, y = pkg.make_vars("x", "y")
    par, tm = pkg.par, pkg.time_
    cases = {
        "pendulum": (pkg.models.pendulum(), [0.05, 0.025], []),
        "trig": ([(x, m.sin(x) * m.cos(y) + m.tan(0.3 * x)),
                  (y, m.exp(-y) + m.atan2(x, y) + x ** -1.5)],
                 [0.7, 1.3], []),
        "kepE": ([(x, m.kepE(0.3, y)),
                  (y, m.sqrt(x) + m.log(y) + m.erf(x))], [1.2, 0.8], []),
        "kepFDE": ([(x, m.kepF(0.1, 0.2, y)),
                    (y, m.kepDE(0.1, 0.2, x) + m.asin(0.3 * x) + m.tanh(y)
                     + m.sigmoid(x))], [0.9, 0.7], []),
        "select": ([(x, m.select(m.gt(x, 0.0), x * x, -x) + m.relu(y)),
                    (y, m.sigmoid(x) + m.atan(y) + m.acos(0.2 * x)
                     + m.sinh(y))], [0.5, -0.3], []),
        "par_time": ([(x, par[0] * m.sin(tm) + par[1] * x), (y, tm * y)],
                     [0.4, 0.6], [1.1, -0.2]),
        "hyper": ([(x, m.atanh(0.3 * x) + m.asinh(y) / (2.0 + y * y)),
                   (y, m.acosh(1.5 + 0.1 * x * x) - m.cosh(0.2 * y))],
                  [0.4, 0.3], []),
        "logic": ([(x, m.select(m.logical_and(m.lt(x, 2.0), m.ge(y, -3.0)),
                                y, -y) + 0.1 * m.relup(x)),
                   (y, m.select(m.logical_or(m.le(x, -5.0), m.ne(y, 7.0)),
                                -x, x)
                    + 0.01 * m.logical_not(m.eq(x, 5.0)))],
                  [0.5, 0.4], []),
    }
    per_op = {
        "tan": -m.tan(x * 0.3), "tanh": -m.tanh(x),
        "sigmoid": -m.sigmoid(x) + 0.5, "asin": -m.asin(x * 0.5),
        "acos": m.acos(x * 0.5) - np.pi / 2, "atan": -m.atan(x),
        "erf": -m.erf(x), "atan2": -m.atan2(x, 2.0 + y * 0.1),
        "kepE": -m.sin(m.kepE(0.1, x)), "kepF": -m.sin(m.kepF(0.05, 0.05, x)),
        "kepDE": -m.sin(m.kepDE(0.05, 0.3, x)),
    }
    for name, rhs in per_op.items():
        cases[f"op_{name}"] = ([(x, y), (y, rhs)], [0.25, 0.0], [])
    return cases


def phase_lanes(st0, pars, B, seed):
    """``B`` lanes near a case's state: the state plus 0.01 N(0, 1) per
    coordinate, its parameters, times in [0, 2); numpy arrays (B, n),
    (B, n_pars), (B,)."""
    rng = np.random.default_rng(seed)
    st0 = np.asarray(st0, float)
    st = st0[None] + 0.01 * rng.standard_normal((B, st0.size))
    return (st, np.tile(np.asarray(pars, float), (B, 1)).reshape(B, -1),
            rng.uniform(0.0, 2.0, B))


def pendulum_lanes(B, seed):
    """Librating pendulum lanes: x0 = +-U(0.5, 2.0) rad with a random
    sign, v0 = U(-1, 1); energies 1.2 to 14.4, below the separatrix's
    19.6."""
    rng = np.random.default_rng(seed)
    x0 = rng.choice([-1.0, 1.0], B) * rng.uniform(0.5, 2.0, B)
    return np.stack([x0, rng.uniform(-1.0, 1.0, B)], 1)


#: the three routes of the batch integrator in the tests, by the jet each
#: runs: kernel B2 (the 3-body problem), B3 (12 mascons in the unit ball,
#: taken by the rolled route once ``taylor.batch.ROLLED_MIN_WIDTH`` is
#: lowered to ``ROLLED_TEST_WIDTH``, above the 3-body tape's 98 columns and
#: below the mascons' 237) and B4 (the pendulum)
ROUTES = ("b2", "b3", "b4")
ROLLED_TEST_WIDTH = 128


def route_case(pkg, route, B, seed):
    """``(ODE system, state (B, n))`` of a route's small test case, built
    with ``pkg``: the 3-body lanes near a hierarchical triple, bound r = 2
    orbits about the 12 mascons (``tests/test_pallas_rolled.py``'s body,
    spinning at 0.3), librating pendulum lanes."""
    rng = np.random.default_rng(seed)
    if route == "b2":
        base = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                         0, 1.5, 0, -0.8, 0, 0], float)
        return (pkg.models.nbody(3, masses=[1.0, 1e-3, 2e-3]),
                base[None] + 0.01 * rng.standard_normal((B, 18)))
    if route == "b3":
        body = np.random.default_rng(7)
        pts = body.uniform(-1.0, 1.0, (48, 3))
        pts = pts[np.linalg.norm(pts, axis=1) <= 1.0][:12]
        masses = body.uniform(0.5, 1.0, 12)
        sys_ = pkg.models.mascon(Gconst=1.0,
                                 masses=(masses / masses.sum()).tolist(),
                                 positions=pts.tolist(),
                                 omega=(0.0, 0.0, 0.3))
        ang = rng.uniform(0, 2 * np.pi, B)
        st = np.zeros((B, 6))
        st[:, 0], st[:, 1] = 2.0 * np.cos(ang), 2.0 * np.sin(ang)
        st[:, 3], st[:, 4] = -0.7 * np.sin(ang), 0.7 * np.cos(ang)
        return sys_, st
    if route == "b4":
        return pkg.models.pendulum(), pendulum_lanes(B, seed)
    raise ValueError(f"unknown route {route!r}")


#: BASELINE config 5's geopotential initial condition in km and km/s
#: (``benchmarks/geopot_bench.py:40-41``, heyoka's ``benchmark/geopot.cpp``)
GEOPOT_IC = np.array([6740.440, 0.0, 0.0, 0.0, 6.725973853066024,
                      3.8832537950295855])
#: the drag lanes' parameters: f107, f107a, ap and Cb [m^2/kg] drawn
#: uniformly in these ranges
DRAG_PAR_RANGES = ((70.0, 250.0), (70.0, 200.0), (0.0, 50.0), (0.005, 0.02))


def geopot_sys(pkg, deg):
    """The geopotential ODE of ``geopot_bench.py``, built with ``pkg``:
    ``egm2008_acc`` to degree and order ``deg`` in km and km/s, in the
    body-fixed frame (autonomous)."""
    m = pkg.models
    x, y, z, vx, vy, vz = pkg.make_vars("x", "y", "z", "vx", "vy", "vz")
    acc = m.egm2008_acc([x, y, z], deg, deg, mu=m.get_egm2008_mu() / 1e9,
                        a=m.get_egm2008_a() / 1e3)
    return [(x, vx), (y, vy), (z, vz), *zip((vx, vy, vz), acc)]


def geopot_energy(pkg, deg):
    """The conserved energy ``0.5 |v|^2 - U`` of :func:`geopot_sys` and
    its variables in state order."""
    m = pkg.models
    x, y, z, vx, vy, vz = vs = pkg.make_vars("x", "y", "z", "vx", "vy", "vz")
    U = m.egm2008_pot([x, y, z], deg, deg, mu=m.get_egm2008_mu() / 1e9,
                      a=m.get_egm2008_a() / 1e3)
    return 0.5 * (vx * vx + vy * vy + vz * vz) - U, list(vs)


def geopot_lanes(B, seed=0):
    """``geopot_bench.py``'s lanes: ``GEOPOT_IC`` perturbed by ``|ic| *
    U(-1, 1) * 1e-6`` per coordinate (numpy rng ``seed``), (B, 6)."""
    rng = np.random.default_rng(seed)
    return GEOPOT_IC[None] + np.abs(GEOPOT_IC)[None] * rng.uniform(
        -1, 1, (B, 6)) * 1e-6


def drag_sys(pkg, deg=4):
    """:func:`geopot_sys` plus thermoNET drag as the JAX package's
    ``models/eo_dynamics.py`` ``_drag_acc`` (:98-139) writes it, without
    the EOP/SW rotations: the atmosphere rests in the body-fixed frame
    (``vrel = v``, with its ``veps`` regularisation), the geodetic
    coordinates are ``cart2geo`` of the position with ``R_eq = A_EARTH /
    1e3``, the density ``nrlmsise00_tn`` with ``f107 = par[0]``, ``f107a
    = par[1]``, ``ap = par[2]`` and ``time / 86400`` days since Jan 1,
    times 1e9 (kg/km^3); ``Cb = par[3]`` in m^2/kg.  :func:`eo_sys` is
    the uncut model."""
    m, par = pkg.models, pkg.par
    sys_ = geopot_sys(pkg, deg)
    (x, _), (y, _), (z, _) = sys_[:3]
    v = [lhs for lhs, _ in sys_[3:]]
    a_earth = 6378137.0  # models/cart2geo.py A_EARTH [m]
    h, lat, lon = m.cart2geo([x, y, z], R_eq=a_earth / 1e3)
    rho = m.nrlmsise00_tn(geodetic=[h, lat, lon], f107=par[0], f107a=par[1],
                          ap=par[2], time_expr=pkg.time / 86400.0) * 1e9
    veps = 1e-8
    vn = pkg.sqrt(pkg.sum_([c * c for c in v] + [pkg.Number(veps * veps)]))
    factor = -0.5 * rho * vn * par[3] * 1e-6
    return sys_[:3] + [(lhs, rhs + factor * c)
                       for (lhs, rhs), c in zip(sys_[3:], v)]


def drag_pars(B, seed=1):
    """(B, 4) drag parameters, each uniform in ``DRAG_PAR_RANGES`` (numpy
    rng ``seed``)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo, hi, B) for lo, hi in DRAG_PAR_RANGES], 1)


def sgp4_population(N, seed=0):
    """``benchmarks/sgp4_bench.py``'s (9, N) GPEs: LEO satellites about
    the ISS elements (numpy rng ``seed``); epoch rows 7-8 zero."""
    rng = np.random.default_rng(seed)
    base = dict(n0=0.0487 * 1440 / (2 * np.pi), e0=0.0001647, i0=51.6416,
                node0=247.4627, omega0=130.5360, m0=325.0288, bstar=2.2e-5)
    g = np.zeros((9, N))
    g[0] = base["n0"] * 2 * np.pi / 1440 * (1 + 1e-3 * rng.standard_normal(N))
    g[1] = np.abs(base["e0"] * (1 + 0.1 * rng.standard_normal(N)))
    g[2] = np.deg2rad(base["i0"] + 0.01 * rng.standard_normal(N))
    g[3] = np.deg2rad(base["node0"] + rng.uniform(0, 360, N))
    g[4] = np.deg2rad(base["omega0"] + rng.uniform(0, 360, N))
    g[5] = np.deg2rad(base["m0"] + rng.uniform(0, 360, N))
    g[6] = base["bstar"] * (1 + 0.1 * rng.standard_normal(N))
    return g


#: the Spacetrack Report #3 test case (satellite 88888) and its published
#: ephemeris in km and km/s: tsince [min], x, y, z, vx, vy, vz
#: (``tests/test_sgp4.py``; the Vallado update moves positions by ~10 m)
SGP4_TLE = (
    "1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8",
    "2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
REPORT3 = np.array([
    [0.0, 2328.97048951, -5995.22076416, 1719.97067261,
     2.91207230, -0.98341546, -7.09081703],
    [360.0, 2456.10705566, -6071.93853760, 1222.89727783,
     2.67938992, -0.44829041, -7.22879231],
    [720.0, 2567.56195068, -6112.50384522, 713.96397400,
     2.44024599, 0.09810869, -7.31995916],
])


# -- the ephemeris tapes (ROADMAP A.14) -----------------------------------------

def elp_sys(pkg, thresh=0.0, series_op=True):
    """``benchmarks/vsop2013_cartesian.py``'s lunar ODE: ``x' = c_x 1e-10``
    and likewise y and z, ``c`` the ELP2000 Moon position in the mean
    ecliptic of J2000 (``elp2000_cartesian_e2000``), time in Julian
    centuries; at ``thresh = 0`` with ``series_op`` the complete theory,
    37,863 terms in 9 series ops."""
    x, y, z = pkg.make_vars("x", "y", "z")
    c = pkg.models.elp2000_cartesian_e2000(thresh=thresh,
                                           series_op=series_op)
    return [(x, c[0] * 1e-10), (y, c[1] * 1e-10), (z, c[2] * 1e-10)]


def p9_sys(pkg, thresh=1e-9, series_op=True):
    """The same benchmark's planet-9 system: ``x' = q``, ``y' = p``, the
    VSOP2013 Pluto inclination variables (the series the data ships);
    at ``thresh = 1e-9`` with ``series_op`` 15 series ops, 4,479 terms."""
    x, y = pkg.make_vars("x", "y")
    el = pkg.models.vsop2013_elliptic
    return [(x, el(9, 5, thresh=thresh, series_op=series_op)),
            (y, el(9, 6, thresh=thresh, series_op=series_op))]


def series_times(B, seed=0, half=0.5):
    """``B`` start times drawn from U(-half, half) (Julian centuries for
    ELP2000, millennia for VSOP2013) with ``seed``."""
    return np.random.default_rng(seed).uniform(-half, half, B)


def random_series(rng, n, q, d):
    """Tables of a random series (``tests/test_series_op.py``'s shape):
    amplitudes ~1 with small higher coefficients, phases 0..6 with rates
    0.5..3 and small higher coefficients; ``amp (n, q+1)``, ``ph (n,
    d+1)``."""
    amp = np.zeros((n, q + 1))
    amp[:, 0] = rng.uniform(0.5, 2.0, n)
    for j in range(1, q + 1):
        amp[:, j] = rng.uniform(-0.1, 0.1, n) / 10 ** (j - 1)
    ph = np.zeros((n, d + 1))
    ph[:, 0] = rng.uniform(0.0, 6.0, n)
    if d:
        ph[:, 1] = rng.uniform(0.5, 3.0, n)
    for j in range(2, d + 1):
        ph[:, j] = rng.uniform(-0.2, 0.2, n) / 10 ** (j - 2)
    return amp, ph


# -- the Earth-orientation systems (ROADMAP A.15, data part) --------------------

def eo_epoch(pkg):
    """Phase 25's start, 2015-06-10 00:00 UTC, in TT seconds since J2000
    (``tests/test_ephemeris.py:97-100``), with ``pkg``'s time scales."""
    t1, t2 = pkg.utils.jd_utc_to_tt(pkg.utils.cal_to_jd(2015, 6, 10), 0.0)
    return float(((t1 - 2451545.0) + t2) * 86400.0)


def eo_sys(pkg, deg=10, drag=True, thresh=1e-4):
    """Phase 25's system, built with ``pkg``: ``eo_dynamics`` with the
    EGM2008 geopotential to degree and order ``deg`` in the ITRS through
    the IAU2006 chain at ``iau2006_thresh = thresh`` (the default 1e-4)
    and, with ``drag``, NRLMSISE-00 thermoNET drag with ``Cb = par[0]``
    [m^2/kg]; the builtin EOP and SW tables, km, km/s, TT seconds since
    J2000."""
    return pkg.models.eo_dynamics(
        max_geo_degree=deg, max_geo_order=deg, iau2006_thresh=thresh,
        Cb=pkg.par[0] if drag else None)


def eo_lanes(pkg, B):
    """``B`` lanes of :func:`eo_sys` at :func:`eo_epoch`: ``(state (B,
    6), pars (B, 1), t0 (B,))``, the states ``geopot_lanes(B, 0)`` and
    ``Cb`` the fourth column of ``drag_pars(B, 1)`` (uniform in
    ``DRAG_PAR_RANGES[3]``), so that the first 1,024 lanes are phase 23
    (c)'s in state and ballistic coefficient."""
    return (geopot_lanes(B, 0), drag_pars(B, 1)[:, 3:4],
            np.full(B, eo_epoch(pkg)))


def eop_ode_sys(pkg):
    """A small ODE over every kind of data-driven op, time in days since
    J2000 (TT): ``x' = 1e6 pm_x + 1e-3 sin(era) + 1e-3 pm_xp`` and ``y' =
    1e-3 f107 + 1e-2 dayfrac - 0.1 y``, the interpolants at ``t / 36525``
    centuries (the builtin tables)."""
    m = pkg.models
    x, y = pkg.make_vars("x", "y")
    tcy = pkg.time / 36525.0
    return [(x, m.pm_x(time_expr=tcy) * 1e6
             + pkg.sin(m.era(time_expr=tcy)) * 1e-3
             + m.pm_xp(time_expr=tcy) * 1e-3),
            (y, m.f107(time_expr=tcy) * 1e-3 + m.dayfrac() * 1e-2 - 0.1 * y)]
