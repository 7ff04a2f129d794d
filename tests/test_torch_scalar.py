"""The port's scalar integrator (``taylor_adaptive``, a one-lane batch)
against the JAX package's on the CPU in f64: the cases of
``tests/test_integrator.py`` (``test_float32_mode``'s case is in
``tests/test_torch_f32.py``) with the JAX scalar as the reference, scalar events and
step callbacks, pickling and the refused knobs.  States within 1e-12
relative, step counts equal outside a sub-ulp landing step, event times
within 1e-12.  The JAX integrators are built once a module and reset
before each use, their inputs numpy arrays."""

import math
import pickle

import numpy as np
import pytest

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.tools.cases import route_case

IC = np.array([0.05, 0.025])
TOL = 1e-15
EV_TOL = 1e-12
#: the events' lanes: x crosses 0 going down before v first reaches 0
EV_IC = np.array([0.05, -0.3])


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(np.abs(b).max(),
                                                             1e-300))


def _steps(res, ta):
    """The step count without a final sub-ulp landing step
    (``tests/test_torch_prop.py`` ``_main_steps``)."""
    return res[3] - (abs(ta.last_h) < 4 * np.spacing(abs(ta.time)))


@pytest.fixture(scope="module")
def jax_ta():
    """JAX pendulum integrators by their ``high_accuracy``, reset to IC at
    t = 0."""
    cache = {}

    def get(high_accuracy=False):
        if high_accuracy not in cache:
            cache[high_accuracy] = hy.taylor_adaptive(
                hy.models.pendulum(), IC, tol=TOL,
                high_accuracy=high_accuracy)
        j = cache[high_accuracy]
        j.state, j.time = IC, 0.0
        return j

    return get


def _port(**kw):
    return ht.taylor_adaptive(ht.models.pendulum(), IC, tol=TOL,
                              device="cpu", **kw)


def test_order_from_tol():
    for tol in (1e-15, 2.2e-16, 0.9):
        assert ht.taylor_order_from_tol(tol) == hy.taylor_order_from_tol(tol)
    assert _port().order == 19


def test_step_and_outcome(jax_ta):
    j, p = jax_ta(), _port()
    oj, hj = j.step()
    op, hp = p.step()
    assert op == oj == ht.TaylorOutcome.success
    assert hp == pytest.approx(hj, rel=1e-12) and p.time == hp
    _close(p.state, j.state)
    _close(p.tc, j.tc)
    assert p.tc.shape == (p.order + 1, 2)
    oj, hj = j.step(max_delta_t=1e-4)
    op, hp = p.step(max_delta_t=1e-4)
    assert op == oj == ht.TaylorOutcome.time_limit and hp == hj == 1e-4
    assert p.dtime == pytest.approx(j.dtime, rel=1e-15, abs=1e-30)


def test_step_backward(jax_ta):
    j, p = jax_ta(), _port()
    oj, hj = j.step_backward()
    op, hp = p.step_backward()
    assert op == oj == ht.TaylorOutcome.success and hp < 0 and p.time < 0
    assert hp == pytest.approx(hj, rel=1e-12)
    _close(p.state, j.state)


def test_propagate_until_and_for(jax_ta):
    # kernel B4's route (the phase jet) and the per-step driver
    j, p = jax_ta(), _port()
    assert p.engine_report()["jet"] == "phase_plain"
    rj = j.propagate_until(10.0)
    rp = p.propagate_until(10.0)
    assert rp[0] == rj[0] == ht.TaylorOutcome.time_limit
    assert p.time == j.time == 10.0
    assert _steps(rp, p) == _steps(rj, j)
    assert rp[1] == pytest.approx(rj[1], rel=1e-12)
    assert rp[2] == pytest.approx(rj[2], rel=1e-12)
    _close(p.state, j.state)
    rj = j.propagate_for(5.0)
    rp = p.propagate_for(5.0)
    assert p.time == j.time and _steps(rp, p) == _steps(rj, j)
    _close(p.state, j.state)


def test_back_and_forth(jax_ta):
    # reference: test/back_and_forth.cpp, time reversibility
    j, p = jax_ta(), _port()
    for t in (100.0, 0.0):
        j.propagate_until(t)
        p.propagate_until(t)
    assert abs(p.time) < 1e-14
    np.testing.assert_allclose(p.state, IC, rtol=0, atol=1e-11)
    _close(p.state, j.state, 1e-11)


def test_propagate_grid(jax_ta):
    j, p = jax_ta(), _port()
    grid = np.linspace(0.0, 5.0, 23)
    rj = j.propagate_grid(grid)
    rp = p.propagate_grid(grid)
    assert rp[0] == rj[0] == ht.TaylorOutcome.time_limit
    assert rp[4].shape == (23, 2) and rp[4][0, 0] == IC[0]
    assert _steps(rp, p) == _steps(rj, j)
    _close(rp[4], np.asarray(rj[4]))
    with pytest.raises(ValueError, match="strictly monotonic"):
        p.propagate_grid([6.0, 6.0, 7.0])


def test_dense_output_and_c_output(jax_ta):
    j, p = jax_ta(), _port()
    j.step()
    p.step()
    t_half = p.time - p.last_h / 2
    _close(p.update_d_output(t_half), j.update_d_output(t_half))
    _close(p.d_output, j.d_output)
    _close(p.update_d_output(0.25 * p.last_h, rel_time=True),
           j.update_d_output(0.25 * j.last_h, rel_time=True))
    rj = j.propagate_until(4.0, c_output=True)
    rp = p.propagate_until(4.0, c_output=True)
    cj, cp = rj[4], rp[4]
    assert cp.n_steps == cj.n_steps and len(rp) == 5
    assert cp.bounds == pytest.approx(cj.bounds, rel=1e-15)
    ts = np.linspace(p.time - 3.0, 4.0, 7)
    _close(cp(ts), np.asarray(cj(ts)))
    _close(cp(2.5), np.asarray(cj(2.5)))


def test_high_accuracy_mode(jax_ta):
    j, p = jax_ta(True), _port(high_accuracy=True)
    assert p.high_accuracy and p.step()[0] == ht.TaylorOutcome.success
    j.step()
    j.propagate_until(100.0)
    p.propagate_until(100.0)
    _close(p.state, j.state, 1e-11)
    e = [float(0.5 * s[1] ** 2 + 9.8 * (1 - np.cos(s[0])))
         for s in (IC, p.state)]
    assert abs(e[1] - e[0]) / abs(e[0]) < 1e-12


def test_nonfinite_detection():
    # finite-time blow-up of x' = x^2 at t = 1
    def run(pkg, **kw):
        x = pkg.make_vars("x")
        ta = pkg.taylor_adaptive([(x, x * x)], [1.0], tol=1e-9, **kw)
        return ta.propagate_until(2.0, max_steps=10_000)

    rj, rp = run(hy), run(ht, device="cpu")
    assert rp[0] == rj[0] == ht.TaylorOutcome.err_nf_state
    assert rp[3] == rj[3]


def test_step_limit_and_max_delta_t(jax_ta):
    j, p = jax_ta(), _port()
    oc, *_, ns = p.propagate_until(1000.0, max_steps=5)
    assert oc == ht.TaylorOutcome.step_limit and ns == 5
    rj = j.propagate_until(1000.0, max_steps=5)
    _close(p.state, j.state)
    j, p = jax_ta(), _port()
    rj = j.propagate_until(1.0, max_delta_t=0.01)
    rp = p.propagate_until(1.0, max_delta_t=0.01)
    assert rp[2] <= 0.01 + 1e-15 and rp[3] >= 100
    assert _steps(rp, p) == _steps(rj, j)
    _close(p.state, j.state)


def test_time_dependent_rhs_and_pars(jax_ta):
    # x' = cos(t): x(t) = sin(t), the per-step driver (a time column)
    x = ht.make_vars("x")
    ta = ht.taylor_adaptive([(x, ht.cos(ht.time))], [0.0], tol=TOL,
                            device="cpu")
    ta.propagate_until(2.0)
    assert ta.state[0] == pytest.approx(math.sin(2.0), abs=1e-14)
    # runtime parameters: the pendulum with g a parameter equals the JAX
    # pendulum with g = 9.8
    x, v = ht.make_vars("x", "v")
    sys_ = [(x, v), (v, -ht.par[0] * ht.sin(x))]
    tp = ht.taylor_adaptive(sys_, IC, pars=[9.8], tol=TOL, device="cpu")
    np.testing.assert_array_equal(tp.pars, [9.8])
    tp.propagate_until(10.0)
    j = jax_ta()
    j.propagate_until(10.0)
    _close(tp.state, j.state)


def test_outer_ss_fused_route():
    # a tape of sum, mul and pow: B1's twin for the whole steps, B2's for
    # the landing, equal to the batch's lane bit for bit
    sys_, st = route_case(ht, "b2", 2, 3)
    ta = ht.taylor_adaptive(sys_, st[0], tol=1e-12, high_accuracy=True,
                            device="cpu")
    tb = ht.taylor_adaptive_batch(sys_, st, tol=1e-12, high_accuracy=True,
                                  device="cpu")
    ta.assert_engine(propagate_engine="fused", jet="jet_plain")
    res = ta.propagate_until(5.0)
    rb = tb.propagate_until(5.0)
    assert res[0] == rb[0][0] and res[3] == rb[3][0] and ta.time == 5.0
    np.testing.assert_array_equal(ta.state, tb.state[0])


@pytest.fixture(scope="module")
def jax_ev():
    """The JAX pendulum with ``t_event(v)`` and ``nt_event(x)`` at tol
    1e-12; its callbacks set by each test."""
    x, v = hy.make_vars("x", "v")
    return hy.taylor_adaptive(hy.models.pendulum(), IC, tol=EV_TOL,
                              t_events=[hy.t_event(v)],
                              nt_events=[hy.nt_event(x, None)])


class Rec:
    """The scalar events' callbacks: the hits ``(t, d_sgn)`` and the
    terminal stops ``(time, d_sgn)``; ``go(n)`` answers the n-th stop."""

    def __init__(self, go=None):
        self.nt, self.te, self.go = [], [], go

    def on_nt(self, ta, t, d_sgn):
        self.nt.append((float(t), int(d_sgn)))

    def on_te(self, ta, d_sgn):
        self.te.append((ta.time, int(d_sgn)))
        return self.go(len(self.te))


def _ev_pair(jax_ev, go):
    """The JAX and port integrators with the events, their recorders."""
    rj, rp = Rec(go), Rec(go)
    j = jax_ev
    j.state, j.time = EV_IC, 0.0
    j.reset_cooldowns()
    j.t_events[0].callback = None if go is None else rj.on_te
    j.nt_events[0].callback = rj.on_nt
    x, v = ht.make_vars("x", "v")
    p = ht.taylor_adaptive(
        ht.models.pendulum(), EV_IC, tol=EV_TOL, device="cpu",
        t_events=[ht.t_event(v, callback=None if go is None else rp.on_te)],
        nt_events=[ht.nt_event(x, rp.on_nt)])
    return j, p, rj, rp


def _hits_equal(a, b):
    assert [s for _, s in a] == [s for _, s in b]
    np.testing.assert_allclose([t for t, _ in a], [t for t, _ in b],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("go", [None, lambda n: n < 3],
                         ids=["pure_stop", "te_callback"])
def test_events_match_jax(jax_ev, go):
    # pure stop: the first turning point ends the propagation, the x = 0
    # hits before it dispatched afterwards; with a callback going on twice
    # the third turning point stops it
    j, p, rj, rp = _ev_pair(jax_ev, go)
    assert p.with_events
    resj = j.propagate_until(10.0)
    resp = p.propagate_until(10.0)
    assert resp[0] == resj[0] == 0 and resp[3] == resj[3]
    assert p.time == pytest.approx(j.time, rel=1e-12)
    _close(p.state, j.state, 1e-11)
    _hits_equal(rp.nt, rj.nt)
    _hits_equal(rp.te, rj.te)
    assert len(rp.nt) > 0 and len(rp.te) == (0 if go is None else 3)


def test_event_step_and_grid_match_jax(jax_ev):
    # step(): a step that crosses v = 0 ends at the crossing with the
    # event's index; the grid with events fills the rows it reaches
    j, p, rj, rp = _ev_pair(jax_ev, None)
    for _ in range(6):
        oj, hj = j.step()
        op, hp = p.step()
        assert op == oj and hp == pytest.approx(hj, rel=1e-12)
        if op == 0:
            break
    assert op == 0
    _close(p.state, j.state, 1e-11)
    j.state, j.time = EV_IC, 0.0
    j.reset_cooldowns()
    p.state, p.time = EV_IC, 0.0
    p.reset_cooldowns()
    grid = np.linspace(0.0, 2.0, 9)
    gj = j.propagate_grid(grid)
    gp = p.propagate_grid(grid)
    assert gp[0] == gj[0]
    np.testing.assert_array_equal(np.isnan(gp[4]), np.isnan(gj[4]))
    _close(np.nan_to_num(gp[4]), np.nan_to_num(gj[4]), 1e-11)
    _hits_equal(rp.nt, rj.nt)


def test_host_step_callback_matches_jax(jax_ta):
    # cb(ta) -> bool with the scalar integrator: False stops with cb_stop
    seen = {"j": [], "p": []}

    def make(key):
        def cb(ta):
            seen[key].append(ta.time)
            return len(seen[key]) < 4
        return cb

    j, p = jax_ta(), _port()
    rj = j.propagate_until(10.0, callback=make("j"))
    rp = p.propagate_until(10.0, callback=make("p"))
    assert rp[0] == rj[0] == ht.TaylorOutcome.cb_stop and rp[3] == 4
    np.testing.assert_allclose(seen["p"], seen["j"], rtol=1e-12)
    _close(p.state, j.state)


def test_setters_pickling_and_repr():
    p = _port()
    p.propagate_until(3.0)
    p.set_dtime(3.0, 1e-17)
    assert p.dtime == (3.0, 1e-17)
    with pytest.raises(ValueError, match="finite"):
        p.set_dtime(math.inf, 0.0)
    with pytest.raises(ValueError, match="bad state shape"):
        p.state = [1.0, 2.0, 3.0]
    q = pickle.loads(pickle.dumps(p))
    assert q.dtime == p.dtime and q.last_h == p.last_h
    np.testing.assert_array_equal(q.state, p.state)
    np.testing.assert_array_equal(q.tc, p.tc)
    assert q.propagate_until(6.0) == p.propagate_until(6.0)
    np.testing.assert_array_equal(q.state, p.state)
    assert repr(p).startswith("TaylorAdaptive(order=19, tol=1e-15, dim=2")
    assert p.get_n_orig_sv() == 2 and not p.is_variational()
    with pytest.raises(ValueError, match="non-variational"):
        p.get_vargs()
    assert (p.sys[0][0].name, p.dim, p.tol, p.dtype) == (
        "x", 2, TOL, np.float64)


def test_refused_and_accepted_knobs():
    sys_ = ht.models.pendulum()
    # the host runtime (ROADMAP A.22, now ported): a native integrator
    # whatever the device; tests/test_torch_native.py holds it to JAX
    assert ht.taylor_adaptive(sys_, IC, device="cpu",
                              backend="native").backend == "native"
    with pytest.raises(ValueError, match="unknown backend"):
        ht.taylor_adaptive(sys_, IC, device="cpu", backend="xla")
    for backend in ("jax", "auto"):
        ta = ht.taylor_adaptive(sys_, IC, device="cpu", backend=backend,
                                compact_mode=True)
        assert ta.backend == "device" and ta.compact_mode
    with pytest.raises(ValueError, match="state must have shape"):
        ht.taylor_adaptive(sys_, [0.1], device="cpu")

    # a var_ode_sys is accepted (ROADMAP A.20, now ported): the
    # original initial conditions are augmented
    ta = ht.taylor_adaptive(ht.var_ode_sys(sys_), IC, device="cpu")
    assert ta.is_variational() and ta.dim == 6 and ta.get_n_orig_sv() == 2
    np.testing.assert_array_equal(ta.state, [*IC, 1.0, 0.0, 0.0, 1.0])
    if not pbatch.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ht.taylor_adaptive(sys_, IC)
