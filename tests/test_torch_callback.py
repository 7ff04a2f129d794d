"""In-graph step callbacks per lane: the port against the JAX package on
the CPU in f64.  A callback written for the JAX API, ``cb(state, pars,
t_hi, t_lo, h, tc) -> (state, keep)`` with one lane's ``state (n,)``,
runs per lane over the batch (``callback.apply``, ``torch.func.vmap``)
on the per-step driver and on the event drivers; ``AngleReducer`` and
``StepCallbackSet`` are per lane, as the JAX ones are.  Outcomes and step
counts equal, states within 1e-13."""

import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.callback import AngleReducer as JAngleReducer
from heyoka_tpu.callback import StepCallbackSet as JStepCallbackSet

import heyoka_tpu_torch as ht

#: pendulum lanes at rest at x = 0.1, 0.3 and 0.2: the second one's x
#: goes below 0.25 after its first step
LANES = np.array([[0.1, 0.0], [0.3, 0.0], [0.2, 0.0]])
TWO_PI = 2.0 * np.pi


def below(state, pars, t_hi, t_lo, h, tc):
    # one lane: keep going while x < 0.25
    return state, state[0] < 0.25


below.in_graph = True


def _both(n, **ev):
    """The JAX and port pendulum batches of the first ``n`` lanes, with
    ``nt_events`` from ``ev`` (a function of the package)."""
    def make(pkg, **kw):
        x, v = pkg.make_vars("x", "v")
        evs = [pkg.nt_event(v, ev["nt"])] if ev else []
        return pkg.taylor_adaptive_batch(pkg.models.pendulum(), LANES[:n],
                                         nt_events=evs, **kw)
    return make(hy), make(ht, device="cpu")


def _same(rp, rj, p, j):
    assert rp[0] == list(rj[0])
    np.testing.assert_array_equal(rp[3], np.asarray(rj[3]))
    np.testing.assert_allclose(p.state, np.asarray(j.state), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("n", [2, 3])
def test_lane_callback_matches_jax(n):
    # the per-step driver: the lane whose keep is False stops with
    # cb_stop after its first step, the others go on to t = 1
    j, p = _both(n)
    rj = j.propagate_until(1.0, callback=below)
    rp = p.propagate_until(1.0, callback=below)
    _same(rp, rj, p, j)
    C, T = ht.TaylorOutcome.cb_stop, ht.TaylorOutcome.time_limit
    assert rp[0] == [T, C, T][:n] and list(rp[3][:2]) == [6, 1]


def test_lane_callback_on_the_event_driver_matches_jax():
    # with events the callback runs in the host-driven driver, per lane,
    # its keeps reduced with all: every lane stops after the first step
    hits = {"j": [], "p": []}
    j, _ = _both(3, nt=lambda tb, t, d, lane: hits["j"].append((lane, t)))
    _, p = _both(3, nt=lambda tb, t, d, lane: hits["p"].append((lane, t)))
    rj = j.propagate_until(1.0, callback=below)
    rp = p.propagate_until(1.0, callback=below)
    _same(rp, rj, p, j)
    assert all(o == ht.TaylorOutcome.cb_stop for o in rp[0])
    assert len(hits["p"]) == len(hits["j"])


def _rotor(pkg):
    x, v = pkg.make_vars("x", "v")
    return [(x, v), (v, 0.0 * x)]


def test_callback_set_and_angle_reducer_match_jax():
    # a set of the per-lane angle reducer and a lane stop on the rotor: x
    # wraps into [0, 2 pi), the lane with v >= 1.5 stops at its first step
    st = np.array([[0.0, 1.0], [1.0, 2.0], [0.5, -1.2]])

    def fast(pkg):
        def cb(state, pars, t_hi, t_lo, h, tc):
            return state, abs(state[1]) < 1.5
        cb.in_graph = True
        return cb

    def run(pkg, sets, **kw):
        tb = pkg.taylor_adaptive_batch(_rotor(pkg), st, tol=1e-12, **kw)
        red = (JAngleReducer if pkg is hy else ht.AngleReducer)(["x"])
        return tb, tb.propagate_until(30.0, callback=sets(red, fast(pkg)))

    j, rj = run(hy, JStepCallbackSet)
    p, rp = run(ht, ht.StepCallbackSet, device="cpu")
    assert rp[0][1] == ht.TaylorOutcome.cb_stop and rp[3][1] == 1
    assert ((p.state[:, 0] >= 0) & (p.state[:, 0] < TWO_PI)).all()
    _same(rp, rj, p, j)


def test_scalar_angle_reducer_matches_jax():
    # the scalar integrator hands its one lane to the per-lane reducer
    kw = dict(tol=1e-12)
    j = hy.taylor_adaptive(_rotor(hy), [0.5, -1.2], **kw)
    p = ht.taylor_adaptive(_rotor(ht), [0.5, -1.2], device="cpu", **kw)
    rj = j.propagate_until(20.0, callback=JAngleReducer(["x"]))
    rp = p.propagate_until(20.0, callback=ht.angle_reducer(["x"]))
    assert rp[0] == rj[0] and rp[3] == rj[3]
    assert 0.0 <= p.state[0] < TWO_PI
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-12)


def test_branching_callback_raises():
    # Python control flow on a lane's value cannot run under vmap; the
    # error says so instead of running the callback on the whole batch
    p = ht.taylor_adaptive_batch(_rotor(ht), LANES, device="cpu")

    def branchy(state, pars, t_hi, t_lo, h, tc):
        return state, bool(state[0] < 0.25)

    branchy.in_graph = True
    with pytest.raises(RuntimeError, match="per lane"):
        p.propagate_until(1.0, callback=branchy)


def test_lane_callback_sees_one_lane():
    # the callback is handed one lane's tensors, as the JAX package's
    # vmapped callback is: state (n,), pars (p,), tc (K+1, n), scalar times
    p = ht.taylor_adaptive_batch(_rotor(ht), LANES, device="cpu")
    shapes = []

    def look(state, pars, t_hi, t_lo, h, tc):
        shapes.append(tuple(tuple(a.shape) for a in (state, pars, t_hi,
                                                      t_lo, h, tc)))
        return state, state[0] < 0.25

    look.in_graph = True
    res = p.propagate_until(1.0, callback=look)
    assert shapes[0] == ((2,), (0,), (), (), (), (p.order + 1, 2))
    assert res[0][1] == ht.TaylorOutcome.cb_stop
    # the same outcomes and states as the named per-lane callback
    q = ht.taylor_adaptive_batch(_rotor(ht), LANES, device="cpu")
    assert q.propagate_until(1.0, callback=below)[0] == res[0]
    assert torch.equal(q._state, p._state)
