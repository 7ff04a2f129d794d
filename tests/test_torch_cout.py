"""The port's dense and continuous output against the JAX package's, on the
CPU in f64, on the three routes (kernel B2's twin: the 3-body problem;
B3's: 12 mascons, ``ROLLED_MIN_WIDTH`` lowered; B4's: the pendulum):
``update_d_output``/``d_output`` after a step, ``propagate_until(...,
c_output=True)`` and its ``ContinuousOutputBatch`` (the JAX recorder runs
on the loop engine, so values are held at a tolerance, not bit for bit),
the port's classes fed the JAX classes' ``__getstate__`` arrays, and the
recorder against the port's own grid and per-step drivers.  The kernels
themselves run the same calls in tests/test_torch_gpu.py."""

import pickle

import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.taylor.continuous import ContinuousOutput as JContinuousOutput

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.taylor import continuous as pc
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH, ROUTES, route_case

B, SEED, TOL = 6, 5, 1e-12
HORIZON = {"b2": 5.0, "b3": 5.0, "b4": 3.0}
#: per-lane targets as fractions of the horizon: lane 2 goes backward
#: (tests/test_continuous_output.py:61-79), lane 5 half as far
TARGETS = np.array([1.0, 1.0, -0.5, 1.0, 1.0, 0.5])
#: query times as fractions of each lane's target: both ends and inside
QUERY = np.array([0.0, 0.1, 0.33, 0.5, 0.77, 0.9, 1.0])


def _main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (see test_torch_prop)."""
    return np.asarray(ns) - (np.abs(last_h) < 4 * np.spacing(np.abs(t)))


def _port(route, monkeypatch, seed=SEED):
    if route == "b3":
        monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, B, seed)
    return ht.taylor_adaptive_batch(sys_, st, tol=TOL, high_accuracy=True,
                                    device="cpu")


def _jax(route, seed=SEED):
    sys_, st = route_case(hy, route, B, seed)
    return hy.taylor_adaptive_batch(sys_, st, compact_mode="flat", tol=TOL,
                                    high_accuracy=True)


@pytest.fixture(scope="module")
def jax_cout():
    """Each route's JAX ``propagate_until(targets, c_output=True)``, run
    once for the module: (result tuple, final state, last_h, time)."""
    cache = {}

    def get(route):
        if route not in cache:
            j = _jax(route)
            res = j.propagate_until(TARGETS * HORIZON[route], c_output=True)
            cache[route] = (res, j.state, j.last_h, j.time)
        return cache[route]

    return get


def _queries(route):
    return QUERY[:, None] * (TARGETS * HORIZON[route])[None, :]


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("rel_time", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_d_output_matches_jax(monkeypatch, route, rel_time):
    j, p = _jax(route), _port(route, monkeypatch)
    assert (p.d_output == 0.0).all() and p.d_output.shape == j.d_output.shape
    j.step()
    p.step()
    h = p.last_h
    t = h / 3 if rel_time else p.time - h / 2
    dj = j.update_d_output(t, rel_time=rel_time)
    dp = p.update_d_output(t, rel_time=rel_time)
    np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-13)
    assert p.d_output is dp and dp.shape == (B, p.dim)
    # at the step's end, the dense output is the new state
    end = p.update_d_output(h, rel_time=True)
    np.testing.assert_allclose(end, p.state, rtol=0, atol=1e-14)
    # a step of the JAX start time (time - last_h) and one relative to it
    np.testing.assert_array_equal(
        p.update_d_output(p.time - h + h / 4),
        p.update_d_output((p.time - h + h / 4) - (p.time - h), rel_time=True))


@pytest.mark.parametrize("route", ROUTES)
def test_c_output_matches_jax(jax_cout, monkeypatch, route):
    rj, st_j, last_h_j, t_j = jax_cout(route)
    p = _port(route, monkeypatch)
    rp = p.propagate_until(TARGETS * HORIZON[route], c_output=True)
    assert len(rp) == 5 and rp[0] == rj[0]
    assert all(o == ht.TaylorOutcome.time_limit for o in rp[0])
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], last_h_j, t_j))
    cp, cj = rp[4], rj[4]
    np.testing.assert_array_equal(cp.n_steps, rp[3])
    assert cp.batch_size == B
    # 1e-11: the JAX recorder's loop engine and the port's jets differ in
    # the last bits of the coefficients and step sizes
    q = _queries(route)
    vp, vj = cp(q), cj(q)
    assert vp.shape == (len(QUERY), B, p.dim)
    _close(vp, vj, 1e-11)
    _close(cp(q[3]), cj(q[3]), 1e-11)
    # the first query is each lane's start: its initial state
    _close(vp[0], route_case(ht, route, B, SEED)[1], 1e-15)
    _close(p.state, st_j, 1e-11)


@pytest.mark.parametrize("route", ROUTES)
def test_c_output_batch_from_jax_state(jax_cout, route):
    # the port's class fed the JAX class's __getstate__ arrays evaluates
    # like the JAX class: the same Horner on the same coefficients
    cj = jax_cout(route)[0][4]
    st = cj.__getstate__()
    cp = pc.ContinuousOutputBatch.__new__(pc.ContinuousOutputBatch)
    cp.__setstate__(dict(st, device="cpu"))
    q = _queries(route)
    _close(cp(q), cj(q), 1e-15)
    np.testing.assert_array_equal(cp.n_steps, cj.n_steps)
    # the JAX class's dict names no device: the port's default, CUDA
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cp.__setstate__(st)


@pytest.mark.parametrize("lane", [0, 2])  # forward, backward
def test_continuous_output_scalar_matches_jax(jax_cout, lane):
    # the scalar class from one lane's records, against the JAX class on
    # the same arrays
    cj = jax_cout("b2")[0][4]
    st = cj.__getstate__()
    n = int(st["n_steps"][lane])
    arrays = (st["times_hi"][lane, :n + 1], st["times_lo"][lane, :n + 1],
              st["tcs"][lane, :n], st["order"], st["dim"],
              bool(st["fwd"][lane]))
    sj = JContinuousOutput(*arrays)
    sp = pc.ContinuousOutput(*arrays, device="cpu")
    assert sp.n_steps == sj.n_steps == n
    np.testing.assert_array_equal(sp.times, sj.times)
    np.testing.assert_array_equal(sp.tcs, sj.tcs)
    assert sp.bounds == sj.bounds
    assert (sp.output == 0.0).all()
    q = QUERY * TARGETS[lane] * HORIZON["b2"]
    _close(sp(q), sj(q), 1e-15)
    _close(sp(q[2]), sj(q[2]), 1e-15)
    assert sp(q[2]).shape == (sp._dim,) and sp.output is sp._output
    sr = pickle.loads(pickle.dumps(sp))
    np.testing.assert_array_equal(sr(q), sp(q))
    sp2 = pc.ContinuousOutput.__new__(pc.ContinuousOutput)
    sp2.__setstate__(dict(sj.__getstate__(), device="cpu"))
    np.testing.assert_array_equal(sp2(q), sp(q))


@pytest.mark.parametrize("route", ROUTES)
def test_c_output_agrees_with_grid_and_propagate(monkeypatch, route):
    # the recorder is the per-step driver: its final state equals
    # propagate_until's on the per-step routes (B3, B4) and the fused
    # route's to 1e-13 (B2); evaluated at a grid's points it equals
    # propagate_grid's rows to 1e-13 (the two drivers differ only in how
    # the last step is capped)
    T = HORIZON[route]
    grid = np.linspace(0.0, T, 9)
    p1, p2, p3 = (_port(route, monkeypatch, seed=7) for _ in range(3))
    r1 = p1.propagate_until(T, c_output=True)
    r2 = p2.propagate_until(T)
    r3 = p3.propagate_grid(grid)
    # tc after propagate_until is the last step's, the fused route's
    # landing step on B2: its dense output at the step's end is the state
    _close(p2.update_d_output(p2.last_h, rel_time=True), p2.state, 1e-14)
    if route == "b2":
        _close(p1.state, p2.state, 1e-13)
    else:
        np.testing.assert_array_equal(p1.state, p2.state)
        np.testing.assert_array_equal(r1[3], r2[3])
    rows = r1[4](np.repeat(grid[:, None], B, 1)).transpose(1, 0, 2)
    _close(rows, r3[4], 1e-13)
    cr = pickle.loads(pickle.dumps(r1[4]))
    q = np.repeat(grid[:, None], B, 1)
    np.testing.assert_array_equal(cr(q), r1[4](q))
    assert p1.engine_report()["c_output_engine"] == "flat"


def test_c_output_non_finite_lane():
    # a lane whose first step is non-finite records nothing and ends at a
    # non-finite time, so it evaluates to NaN, as in the JAX recorder;
    # the others run on
    sys_, st = route_case(ht, "b4", 3, SEED)
    st[1, 0] = np.nan
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, device="cpu")
    oc, _, _, ns, co = p.propagate_until(1.0, c_output=True)
    assert oc[1] == ht.TaylorOutcome.err_nf_state and ns[1] == 1
    assert co.n_steps.tolist() == [ns[0], 0, ns[2]]
    assert oc[0] == oc[2] == ht.TaylorOutcome.time_limit
    v = co(np.array([0.5, 0.5, 0.5]))
    assert np.isfinite(v[[0, 2]]).all() and np.isnan(v[1]).all()


def test_c_output_padding_layout():
    # the JAX layout: zero coefficients past a lane's steps, its final time
    # at row n_steps, +inf pads forward and -inf backward
    sys_, st = route_case(ht, "b4", 2, SEED)
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, device="cpu")
    _, _, _, ns, co = p.propagate_until([1.0, -0.25], c_output=True)
    s = co.__getstate__()
    n0, n1 = ns
    assert n1 < n0 and s["tcs"].shape[1] == n0 and s["device"] == "cpu"
    assert (s["tcs"][1, n1:] == 0.0).all()
    assert s["times_hi"][0, n0] == 1.0 and s["times_hi"][1, n1] == -0.25
    assert (s["times_hi"][1, n1 + 1:] == -np.inf).all()
    assert (s["times_lo"][1, n1 + 1:] == 0.0).all()
    assert s["fwd"].tolist() == [True, False]
    # with a host callback (the host-driven driver) the same layout: one
    # step recorded, the final time after it
    oc, _, _, ns, co = p.propagate_until(2.0, c_output=True,
                                         callback=lambda ta: False)
    s = co.__getstate__()
    assert oc == [ht.TaylorOutcome.cb_stop] * 2 and (ns == 1).all()
    assert s["tcs"].shape[1] == 1 and (co.n_steps == 1).all()
    np.testing.assert_array_equal(s["times_hi"][:, 1], p.dtime[0])
