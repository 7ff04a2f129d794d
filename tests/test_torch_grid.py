"""The port's ``propagate_grid`` (``compact_flat.make_propagate_grid_flat``
over the route's jet) against the JAX package's flat-engine
``propagate_grid`` (``compact_mode="flat"``), on the CPU in f64, on the
three routes: kernel B2's twin (the 3-body problem), B3's (12 mascons,
``ROLLED_MIN_WIDTH`` lowered) and B4's (the pendulum).  The kernels
themselves run the same calls in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.taylor import compact_flat as pcf
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH, ROUTES, route_case

B, SEED, TOL, NGRID = 6, 3, 1e-12, 11
#: each route's horizon: ~15 steps of the 3-body lanes and the mascon
#: orbits, ~30 of the pendulum
HORIZON = {"b2": 5.0, "b3": 5.0, "b4": 3.0}
JETS = {"b2": "jet_plain", "b3": "jet_rolled_plain", "b4": "phase_plain"}
#: grids as fractions of the horizon: from the start time, from after it,
#: and backward
GRIDS = {"from_start": (0.0, 1.0), "after_start": (1.0 / 7.0, 1.0),
         "backward": (0.0, -1.0)}


def _main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (see test_torch_prop)."""
    return np.asarray(ns) - (np.abs(last_h) < 4 * np.spacing(np.abs(t)))


@pytest.fixture(scope="module")
def jax_batch():
    """One JAX integrator per route for the module (its compiled drivers
    are kept per instance), reset to the route's lanes at t = 0."""
    cache = {}

    def get(route):
        sys_, st = route_case(hy, route, B, SEED)
        if route not in cache:
            cache[route] = hy.taylor_adaptive_batch(
                sys_, st, compact_mode="flat", tol=TOL, high_accuracy=True)
        j = cache[route]
        j.state = st
        j.set_time(0.0)
        return j

    return get


def _port(route, monkeypatch):
    if route == "b3":
        monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, B, SEED)
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, high_accuracy=True,
                                 device="cpu")
    assert p.engine_report()["jet"] == JETS[route]
    return p


def _rows_close(rp, rj):
    # 1e-11 of the largest magnitude: the engines' step sizes differ in the
    # last bits only (tests/test_torch_prop.py)
    scale = np.abs(rj).max()
    np.testing.assert_allclose(rp, rj, rtol=0, atol=1e-11 * scale)


@pytest.mark.parametrize("kind", list(GRIDS))
@pytest.mark.parametrize("route", ROUTES)
def test_grid_matches_jax(jax_batch, monkeypatch, route, kind):
    a, b = GRIDS[kind]
    grid = np.linspace(a, b, NGRID) * HORIZON[route]
    j, p = jax_batch(route), _port(route, monkeypatch)
    rj = j.propagate_grid(grid)
    rp = p.propagate_grid(grid)
    assert rp[0] == rj[0]
    assert all(o == ht.TaylorOutcome.time_limit for o in rp[0])
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], j.last_h, j.time))
    assert rp[4].shape == (B, NGRID, p.dim)
    _rows_close(rp[4], rj[4])
    if kind == "from_start":  # the first point takes the state as it is
        np.testing.assert_array_equal(rp[4][:, 0], route_case(
            ht, route, B, SEED)[1])
    np.testing.assert_allclose(p.time, j.time, rtol=1e-13)
    _rows_close(p.state, j.state)
    np.testing.assert_allclose(rp[2], rj[2], rtol=1e-11)
    assert [r[0] for r in p.get_propagate_res()] == rp[0]


@pytest.mark.parametrize("route", ROUTES)
def test_grid_step_limit_matches_jax(jax_batch, monkeypatch, route):
    grid = np.linspace(0.0, 1.0, NGRID) * HORIZON[route]
    j, p = jax_batch(route), _port(route, monkeypatch)
    rj = j.propagate_grid(grid, max_steps=3)
    rp = p.propagate_grid(grid, max_steps=3)
    assert rp[0] == rj[0]
    assert all(o == ht.TaylorOutcome.step_limit for o in rp[0])
    np.testing.assert_array_equal(rp[3], 3)
    # the rows past each lane's third step stay zero in both
    np.testing.assert_array_equal(rp[4] == 0.0, rj[4] == 0.0)
    _rows_close(rp[4], rj[4])


@pytest.mark.parametrize("route", ROUTES)
def test_grid_lane_times_and_capped_steps(jax_batch, monkeypatch, route):
    # lanes at different times on one grid: at the first point, inside the
    # grid (its earlier points come from its first step), at its second
    # point (not a leading one), and past its end (a backward lane that
    # never reaches a point: the step limit); steps capped by max_delta_t
    T = HORIZON[route]
    grid = np.linspace(0.0, T, NGRID)
    times = np.array([0.0, T / 3, grid[1], 1.5 * T, 0.0, T / 5])
    j, p = jax_batch(route), _port(route, monkeypatch)
    j.set_time(times)
    p.set_time(times)
    kw = dict(max_delta_t=T / 8, max_steps=60)
    rj = j.propagate_grid(grid, **kw)
    rp = p.propagate_grid(grid, **kw)
    assert rp[0] == rj[0]
    assert rp[0][3] == ht.TaylorOutcome.step_limit
    assert (rp[4][3] == 0.0).all()
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], j.last_h, j.time))
    _rows_close(rp[4], rj[4])
    assert rp[2].max() <= T / 8


def test_grid_lane_against_the_grid_needs_a_step_limit():
    # a lane past the end of an ascending grid goes backward and reaches
    # no point: with max_steps it stops at the limit with zero rows (above,
    # as in the JAX driver); without, the port raises where JAX would loop
    sys_, st = route_case(ht, "b4", 2, SEED)
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, device="cpu")
    p.set_time([0.0, 2.0])
    with pytest.raises(ValueError, match="against the grid"):
        p.propagate_grid([0.0, 0.5, 1.0])
    assert (p.time == [0.0, 2.0]).all()
    # a descending grid and two backward lanes, one at its first point
    p.set_time([1.0, 2.0])
    res = p.propagate_grid([1.0, 0.5, 0.0])
    assert res[0] == [ht.TaylorOutcome.time_limit] * 2
    np.testing.assert_array_equal(res[4][0, 0], st[0])
    assert (res[4] != 0.0).all()


@pytest.mark.parametrize("bad", [[], [[0.0, 1.0]], [0.0, 2.0, 1.0],
                                 [0.0, np.nan]])
def test_grid_must_be_monotonic(bad):
    with pytest.raises(ValueError):
        pcf.check_grid(bad)
    np.testing.assert_array_equal(pcf.check_grid([2.0, 2.0, 1.0]),
                                  [2.0, 2.0, 1.0])


def test_grid_callback_is_not_ported():
    # the grid's step callbacks are ported (ROADMAP A.11): a host
    # callback runs after each lockstep step of the host-driven driver,
    # False stops the lanes with cb_stop and the rows they did not reach
    # are NaN, as in the JAX class; the device driver stays "flat"
    sys_, st = route_case(ht, "b4", 2, SEED)
    p = ht.taylor_adaptive_batch(sys_, st, device="cpu")
    calls = []
    oc, _, _, ns, out = p.propagate_grid(
        [0.0, 1.0, 100.0], callback=lambda ta: calls.append(1) or False)
    assert oc == [ht.TaylorOutcome.cb_stop] * 2 and (ns == 1).all()
    assert len(calls) == 1 and np.isnan(out[:, 2]).all()
    np.testing.assert_array_equal(out[:, 0], st)
    assert p.engine_report()["grid_engine"] == "flat"
