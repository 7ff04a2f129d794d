"""The port's batch integrator with events and step callbacks against the
JAX package's batch (``compact_mode="flat"``), on the CPU in f64, on the
three routes of ``tools/cases.py`` (the twins of B2, B3 and B4): the
cases of ``tests/test_batch_events.py``, ``test_batch_te_callbacks.py``
and ``test_callbacks_prop.py``.  Per-lane hit lists equal in count and
sign, times within 1e-12, states within 1e-11 relative, outcomes equal
(step counts without a sub-ulp landing step)."""

import pickle

import jax.numpy as jnp  # noqa: F401  (the JAX package's backend)
import numpy as np
import pytest

import heyoka_tpu as hy
from heyoka_tpu.callback import AngleReducer as JAngleReducer

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.callback import AngleReducer, StepCallbackSet
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH, ROUTES, route_case

B, SEED, TOL = 4, 5, 1e-10
#: each route's horizon: the 3-body lanes cross x_1 = 0 once and y_1 = 0
#: going down once, the mascon orbits x = 1.5 about twice, the pendulum
#: lanes v = 0 and x = 0 four to ten times
HORIZON = {"b2": 5.0, "b3": 6.0, "b4": 8.0}
JETS = {"b2": "jet_plain", "b3": "jet_rolled_plain", "b4": "phase_plain"}
TWO_PI = 2.0 * np.pi


def _events(pkg, route, sys_):
    """``(t_event, nt_event)`` of a route, built with ``pkg`` (callbacks
    set by each test): b2 body 1 crossing y = 0 going down (terminal) and
    x = 0; b3 an impact on the unit sphere (terminal, never reached) and
    the alias-form x - 1.5; b4 v = 0 (terminal) and x = 0."""
    names = [lhs.name for lhs, _ in sys_]

    def var(i):
        return pkg.make_vars(names[i])

    if route == "b2":
        return (pkg.t_event(var(7), direction=pkg.EventDirection.negative),
                pkg.nt_event(var(6), None))
    if route == "b3":
        x, y, z = var(0), var(1), var(2)
        return (pkg.t_event(x * x + y * y + z * z - 1.0),
                pkg.nt_event(x - 1.5, None))
    return pkg.t_event(var(1)), pkg.nt_event(var(0), None)


class Rec:
    """Records a run's event callbacks per lane; ``te_go(lane, n)`` is the
    terminal callback's answer at the lane's n-th hit."""

    def __init__(self, te_go=lambda lane, n: True):
        self.nt = [[] for _ in range(B)]
        self.te = [[] for _ in range(B)]
        self.te_go = te_go

    def on_nt(self, tb, t, d, lane):
        self.nt[lane].append((float(t), int(d)))

    def on_te(self, tb, d, lane):
        self.te[lane].append((float(np.asarray(tb.time)[lane]), int(d)))
        return self.te_go(lane, len(self.te[lane]))


def _set(tb, rec, te=True, nt=True):
    te_ev, nt_ev = tb.t_events[0], tb.nt_events[0]
    te_ev.callback = rec.on_te if te else None
    nt_ev.callback = rec.on_nt if nt else None


@pytest.fixture(scope="module")
def jax_ev():
    """One JAX integrator per route for the module, reset to the route's
    lanes at t = 0 with zero cooldowns."""
    cache = {}

    def get(route):
        sys_, st = route_case(hy, route, B, SEED)
        if route not in cache:
            te, nt = _events(hy, route, sys_)
            cache[route] = hy.taylor_adaptive_batch(
                sys_, st, compact_mode="flat", tol=TOL, high_accuracy=True,
                t_events=[te], nt_events=[nt])
        j = cache[route]
        j.state = st
        j.set_time(0.0)
        j.reset_cooldowns()
        return j

    return get


def _port(route, monkeypatch):
    if route == "b3":
        monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, B, SEED)
    te, nt = _events(ht, route, sys_)
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, high_accuracy=True,
                                 device="cpu", t_events=[te], nt_events=[nt])
    assert p.engine_report()["jet"] == JETS[route]
    return p


def _main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (test_torch_prop).  A
    last_h of exactly 0 is no landing step: the JAX host-driven drivers
    step a lane that has stopped with dt = 0, which zeroes its last_h."""
    last_h = np.asarray(last_h)
    tiny = (np.abs(last_h) < 4 * np.spacing(np.abs(t))) & (last_h != 0.0)
    return np.asarray(ns) - tiny


def _hits_equal(hp, hj):
    assert [len(h) for h in hp] == [len(h) for h in hj]
    for a, b in zip(hp, hj):
        assert [d for _, d in a] == [d for _, d in b]
        np.testing.assert_allclose([t for t, _ in a], [t for t, _ in b],
                                   rtol=0, atol=1e-12)


def _lanes_close(p, j):
    np.testing.assert_allclose(p.time, j.time, rtol=0, atol=1e-12)
    scale = np.abs(j.state).max()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11 * scale)


def _res_equal(rp, rj, p, j):
    assert [int(o) for o in rp[0]] == [int(o) for o in rj[0]]
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], j.last_h, j.time))
    _lanes_close(p, j)


# -- propagate_until ------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_t_event_stop_and_nt_hits_match_jax(jax_ev, monkeypatch, route):
    # a terminal event without a callback stops its lane (the event's
    # index as the outcome); the nt hits before it are dispatched after
    # the propagation in time order
    j, p = jax_ev(route), _port(route, monkeypatch)
    rj, rpc = Rec(), Rec()
    _set(j, rj, te=False)
    _set(p, rpc, te=False)
    resj = j.propagate_until(HORIZON[route])
    resp = p.propagate_until(HORIZON[route])
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.nt, rj.nt)
    np.testing.assert_allclose(p.te_cooldowns, j.te_cooldowns, rtol=1e-10)
    stopped = [int(o) == 0 for o in resp[0]]
    assert any(stopped) == (route != "b3")
    assert any(rpc.nt) and p.tc.shape == j.tc.shape
    assert [r[0] for r in p.get_propagate_res()] == resp[0]
    assert p.engine_report()["propagate_engine"] == "events"


@pytest.mark.parametrize("route", ROUTES)
def test_te_callback_continue_matches_jax(jax_ev, monkeypatch, route):
    # the resume loop: a callback that returns True (or None) goes on from
    # the event's state; te and nt together
    j, p = jax_ev(route), _port(route, monkeypatch)
    rj, rpc = Rec(lambda lane, n: None if n % 2 else True), Rec(
        lambda lane, n: None if n % 2 else True)
    _set(j, rj)
    _set(p, rpc)
    resj = j.propagate_until(HORIZON[route])
    resp = p.propagate_until(HORIZON[route])
    assert all(o == ht.TaylorOutcome.time_limit for o in resp[0])
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.nt, rj.nt)
    _hits_equal(rpc.te, rj.te)
    np.testing.assert_allclose(resp[2], resj[2], rtol=1e-10)


@pytest.mark.parametrize("decide", ["stop", "mixed"])
def test_te_callback_stop_and_mixed_match_jax(jax_ev, monkeypatch, decide):
    # False stops the lane with the event's index; mixed: each lane stops
    # at its second crossing, lanes 1 and 3 at their third
    j, p = jax_ev("b4"), _port("b4", monkeypatch)

    def go(lane, n):
        return False if decide == "stop" else n < 2 + lane % 2

    rj, rpc = Rec(go), Rec(go)
    _set(j, rj)
    _set(p, rpc)
    resj = j.propagate_until(100.0)
    resp = p.propagate_until(100.0)
    assert all(int(o) == 0 for o in resp[0])
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.te, rj.te)
    _hits_equal(rpc.nt, rj.nt)
    assert (p.time < 100.0).all()


@pytest.mark.parametrize("route", ROUTES)
def test_vectorized_nt_callback_matches_jax(jax_ev, monkeypatch, route):
    # one call per event with the arrays of its hits, sorted by lane and
    # then time
    j, p = jax_ev(route), _port(route, monkeypatch)
    calls = {"j": [], "p": []}

    def make(key):
        def cb(tb, ts, sgn, lanes):
            calls[key].append((np.array(ts), np.array(sgn), np.array(lanes)))
        cb.vectorized = True
        return cb

    for tb, key in ((j, "j"), (p, "p")):
        tb.t_events[0].callback = None
        tb.nt_events[0].callback = make(key)
        tb.propagate_until(HORIZON[route])
    assert len(calls["p"]) == len(calls["j"]) == 1
    (tp, sp, lp), (tj, sj, lj) = calls["p"][0], calls["j"][0]
    np.testing.assert_array_equal(lp, lj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-12)


def test_backward_with_events_matches_jax(jax_ev, monkeypatch):
    # backward in time through the resume loop (the terminal callback goes
    # on): the hits come in decreasing time within a lane, the crossing
    # signs are those in time
    j, p = jax_ev("b4"), _port("b4", monkeypatch)
    rj, rpc = Rec(), Rec()
    _set(j, rj)
    _set(p, rpc)
    resj = j.propagate_until(-HORIZON["b4"])
    resp = p.propagate_until(-HORIZON["b4"])
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.nt, rj.nt)
    _hits_equal(rpc.te, rj.te)
    assert all(len(h) >= 2 and h[0][0] > h[1][0] for h in rpc.nt)


def test_time_and_parameter_events_match_jax(monkeypatch):
    # event equations with the time and a parameter (a time column and a
    # parameter in the tape): lane 0 stops at t = par = 0.5, lane 1 runs
    # on through ~16 roots a unit time of sin(50 t) (hits logged across
    # several flushes of the hit log, every 16 steps here), as
    # tests/test_batch_events.py's overflow case does
    monkeypatch.setattr(ht.taylor.events.HitLog, "FLUSH", 16)
    T = 3.0
    runs = []
    for pkg, kw in ((hy, dict(compact_mode="flat")), (ht, dict(
            device="cpu"))):
        x, v = pkg.make_vars("x", "v")
        hits = [[] for _ in range(2)]
        tb = pkg.taylor_adaptive_batch(
            pkg.models.pendulum(), np.tile([0.05, 0.025], (2, 1)),
            tol=TOL, high_accuracy=True, pars=np.array([[0.5], [1e9]]),
            t_events=[pkg.t_event(pkg.time - pkg.par[0]) if pkg is hy else
                      pkg.t_event(pkg.time_ - pkg.par[0])],
            nt_events=[pkg.nt_event(
                (pkg.sin(50.0 * pkg.time) if pkg is hy else
                 pkg.math.sin(50.0 * pkg.time_)) + 0.0 * x,
                lambda tb, t, d, lane: hits[lane].append((float(t), int(d))))],
            **kw)
        runs.append((tb, tb.propagate_until(T), hits))
    (j, rj, hj), (p, rp, hp) = runs
    assert [int(o) for o in rp[0]] == [int(o) for o in rj[0]] == [0, -3]
    _lanes_close(p, j)
    _hits_equal(hp, hj)
    assert len(hp[1]) == int(np.floor(T * 50.0 / np.pi)) + 1
    assert max(rp[3]) > 2 * ht.taylor.events.HitLog.FLUSH


def test_per_lane_targets_and_step_limit_match_jax(jax_ev, monkeypatch):
    j, p = jax_ev("b4"), _port("b4", monkeypatch)
    rj, rpc = Rec(), Rec()
    _set(j, rj, te=False)
    _set(p, rpc, te=False)
    tgt = np.array([0.5, 3.0, -2.0, 8.0])
    resj = j.propagate_until(tgt, max_steps=25)
    resp = p.propagate_until(tgt, max_steps=25)
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.nt, rj.nt)


# -- the grid and continuous output ---------------------------------------------

@pytest.mark.parametrize("te_cb", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_grid_with_events_matches_jax(jax_ev, monkeypatch, route, te_cb):
    # without a terminal callback a lane stops at its terminal event, the
    # rows past it NaN; with one (continue) the host-driven driver
    grid = np.linspace(0.0, HORIZON[route], 17)
    j, p = jax_ev(route), _port(route, monkeypatch)
    rj, rpc = Rec(), Rec()
    _set(j, rj, te=te_cb)
    _set(p, rpc, te=te_cb)
    resj = j.propagate_grid(grid)
    resp = p.propagate_grid(grid)
    _res_equal(resp, resj, p, j)
    np.testing.assert_array_equal(np.isnan(resp[4]), np.isnan(resj[4]))
    scale = np.nanmax(np.abs(resj[4]))
    np.testing.assert_allclose(resp[4], resj[4], rtol=0, atol=1e-11 * scale)
    _hits_equal(rpc.nt, rj.nt)
    _hits_equal(rpc.te, rj.te)


def test_grid_hits_equal_propagate_until():
    # the grid driver's hits are propagate_until's, and at tol 1e-12 its
    # rows lie within 5e-13 of the event-free grid's to t = 5 (the event
    # rows enter the norms; tests/test_batch_events.py:74-87)
    grid = np.linspace(0.0, 5.0, 21)
    sys_, st = route_case(ht, "b4", B, SEED)
    x, v = ht.make_vars("x", "v")

    def make(rec, events=True):
        kw = dict(nt_events=[ht.nt_event(x, rec.on_nt)]) if events else {}
        return ht.taylor_adaptive_batch(sys_, st, tol=1e-12, device="cpu",
                                        **kw)

    r1, r2 = Rec(), Rec()
    res = make(r1).propagate_grid(grid)
    make(r2).propagate_until(5.0)
    _hits_equal(r1.nt, r2.nt)
    assert all(len(h) >= 2 for h in r1.nt)
    assert all(o == ht.TaylorOutcome.time_limit for o in res[0])
    plain = make(None, events=False).propagate_grid(grid)[4]
    np.testing.assert_allclose(res[4], plain, rtol=0, atol=5e-13)


@pytest.mark.parametrize("route,te_cb", [(r, False) for r in ROUTES]
                         + [("b4", True)])
def test_c_output_with_events_matches_jax(jax_ev, monkeypatch, route,
                                          te_cb):
    # without a terminal callback the device recorder over the event
    # step; with one (stopping each lane at its third crossing) the
    # host-driven driver
    j, p = jax_ev(route), _port(route, monkeypatch)
    rj, rpc = Rec(lambda lane, n: n < 3), Rec(lambda lane, n: n < 3)
    _set(j, rj, te=te_cb)
    _set(p, rpc, te=te_cb)
    T = HORIZON[route]
    resj = j.propagate_until(T, c_output=True)
    resp = p.propagate_until(T, c_output=True)
    _res_equal(resp[:4], resj[:4], p, j)
    _hits_equal(rpc.nt, rj.nt)
    ts = np.linspace(0.0, 1.0, 9)[:, None] * p.time[None, :]
    vj, vp = resj[4](ts), resp[4](ts)
    scale = np.abs(vj).max()
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-11 * scale)
    np.testing.assert_array_equal(
        _main_steps(resp[4].n_steps, p.last_h, p.time),
        _main_steps(resj[4].n_steps, j.last_h, j.time))
    _hits_equal(rpc.te, rj.te)


# -- step() ---------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_step_with_events_matches_jax(jax_ev, monkeypatch, route):
    j, p = jax_ev(route), _port(route, monkeypatch)
    rj, rpc = Rec(lambda lane, n: lane % 2 == 0), Rec(
        lambda lane, n: lane % 2 == 0)
    _set(j, rj)
    _set(p, rpc)
    for _ in range(12):
        j.step()
        p.step()
        assert [int(o) for o, _ in p.get_step_res()] == \
            [int(o) for o, _ in j.get_step_res()]
        np.testing.assert_allclose([h for _, h in p.get_step_res()],
                                   [h for _, h in j.get_step_res()],
                                   rtol=1e-12)
        np.testing.assert_array_equal(p._event_stop, j._event_stop)
        _lanes_close(p, j)
    _hits_equal(rpc.nt, rj.nt)
    _hits_equal(rpc.te, rj.te)
    assert p.tc.shape == j.tc.shape
    np.testing.assert_allclose(p.update_d_output(p.time[0]),
                               j.update_d_output(j.time[0]), rtol=0,
                               atol=1e-11 * np.abs(j.state).max())


def test_reset_cooldowns_matches_jax(jax_ev, monkeypatch):
    j, p = jax_ev("b4"), _port("b4", monkeypatch)
    for tb in (j, p):
        _set(tb, Rec(), te=False)
        tb.propagate_until(HORIZON["b4"])
    np.testing.assert_allclose(p.te_cooldowns, j.te_cooldowns, rtol=1e-10)
    assert (p.te_cooldowns > 0).all()
    for tb in (j, p):
        tb.reset_cooldowns(1)
    assert p.te_cooldowns[1, 0] == 0.0 and (p.te_cooldowns[[0, 2, 3]] > 0
                                            ).all()
    np.testing.assert_allclose(p.te_cooldowns, j.te_cooldowns, rtol=1e-10)
    for tb in (j, p):
        tb.reset_cooldowns()
    assert (p.te_cooldowns == 0).all() and (j.te_cooldowns == 0).all()


def _keep_going(tb, d, lane):
    return True


def _no_op(tb, t, d, lane):
    pass


def test_pickling_with_events_matches_jax(jax_ev, monkeypatch):
    # a module-level callback pickles: the same state, and the copy goes
    # on as the original does; a lambda fails in both packages
    j, p = jax_ev("b4"), _port("b4", monkeypatch)
    for tb in (j, p):
        tb.t_events[0].callback = None
        tb.nt_events[0].callback = _no_op
        tb.propagate_until(1.0)
        tb.t_events[0].callback = _keep_going
    q = pickle.loads(pickle.dumps(p))
    np.testing.assert_array_equal(q.state, p.state)
    np.testing.assert_array_equal(q.te_cooldowns, p.te_cooldowns)
    np.testing.assert_array_equal(q.tc, p.tc)
    assert q.t_events[0].callback is _keep_going
    q.propagate_until(HORIZON["b4"])
    p.propagate_until(HORIZON["b4"])
    np.testing.assert_array_equal(q.state, p.state)
    for tb in (j, p):
        tb.nt_events[0].callback = lambda *a: None
    errs = []
    for tb in (j, p):
        with pytest.raises(Exception) as e:
            pickle.dumps(tb)
        errs.append(type(e.value))
    assert errs[0] is errs[1]


# -- step callbacks -------------------------------------------------------------

def test_host_callback_stop_with_events_matches_jax(jax_ev, monkeypatch):
    j, p = jax_ev("b4"), _port("b4", monkeypatch)
    n = {"j": 0, "p": 0}

    def make(key):
        def cb(tb):
            n[key] += 1
            return n[key] < 5
        return cb

    rj, rpc = Rec(), Rec()
    _set(j, rj)
    _set(p, rpc)
    resj = j.propagate_until(100.0, callback=make("j"))
    resp = p.propagate_until(100.0, callback=make("p"))
    assert all(o == ht.TaylorOutcome.cb_stop for o in resp[0])
    assert n["p"] == n["j"] == 5 and (resp[3] == 5).all()
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.nt, rj.nt)


@pytest.fixture(scope="module")
def jax_plain():
    cache = {}

    def get(name):
        if name not in cache:
            if name == "rotor":
                x, v = hy.make_vars("x", "v")
                sys_ = [(x, v), (v, 0.0 * x)]
                st = np.array([[0.0, 1.0], [1.0, 2.0], [0.5, -1.5],
                               [2.0, 0.3]])
            else:
                sys_, st = route_case(hy, "b4", B, SEED)
            cache[name] = (hy.taylor_adaptive_batch(
                sys_, st, compact_mode="flat", tol=TOL, high_accuracy=True),
                st)
        j, st = cache[name]
        j.state = st
        j.set_time(0.0)
        return j, st

    return get


def _rotor(pkg):
    x, v = pkg.make_vars("x", "v")
    return [(x, v), (v, 0.0 * x)]


def test_angle_reducer_matches_jax(jax_plain):
    # the in-graph callback in the per-step driver (kernel B1 is left)
    j, st = jax_plain("rotor")
    p = ht.taylor_adaptive_batch(_rotor(ht), st, tol=TOL, high_accuracy=True,
                                 device="cpu")
    resj = j.propagate_until(40.0, callback=JAngleReducer(["x"]))
    resp = p.propagate_until(40.0, callback=AngleReducer(["x"]))
    assert all(o == ht.TaylorOutcome.time_limit for o in resp[0])
    xs = p.state[:, 0]
    assert (xs >= 0.0).all() and (xs < TWO_PI).all()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(resp[3], resj[3])


def test_step_callback_set_and_lane_stop():
    # a set of in-graph callbacks, each given one lane (the JAX form); a
    # lane whose keep is False stops with cb_stop, the others go on
    p = ht.taylor_adaptive_batch(
        _rotor(ht), [[0.0, 1.0], [0.0, 2.0]], tol=TOL, device="cpu")

    def stop_fast(state, pars, t_hi, t_lo, h, tc):
        return state, state[1] < 1.5

    stop_fast.in_graph = True
    res = p.propagate_until(30.0, callback=StepCallbackSet(
        AngleReducer([0]), stop_fast))
    assert res[0] == [ht.TaylorOutcome.time_limit, ht.TaylorOutcome.cb_stop]
    assert res[3][1] == 1 and (p.state[:, 0] < TWO_PI).all()


def test_angle_reducer_with_events_matches_jax(jax_ev, monkeypatch):
    # with events the in-graph callback goes through the host-driven
    # driver, adapted (its keep reduced with all)
    j, p = jax_ev("b4"), _port("b4", monkeypatch)
    rj, rpc = Rec(), Rec()
    _set(j, rj)
    _set(p, rpc)
    resj = j.propagate_until(HORIZON["b4"], callback=JAngleReducer(["x"]))
    resp = p.propagate_until(HORIZON["b4"], callback=AngleReducer(["x"]))
    _res_equal(resp, resj, p, j)
    _hits_equal(rpc.nt, rj.nt)
    _hits_equal(rpc.te, rj.te)
    assert ((p.state[:, 0] >= 0) & (p.state[:, 0] < TWO_PI)).all()


@pytest.mark.parametrize("kind", ["until", "grid", "c_output"])
def test_host_callback_without_events_matches_jax(jax_plain, kind):
    j, st = jax_plain("pendulum")
    sys_, _ = route_case(ht, "b4", B, SEED)
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, high_accuracy=True,
                                 device="cpu")
    n = {"j": 0, "p": 0}

    def make(key):
        def cb(tb):
            n[key] += 1
            return n[key] < 4
        return cb

    grid = np.linspace(0.0, 50.0, 26)
    if kind == "grid":
        rj = j.propagate_grid(grid, callback=make("j"))
        rp = p.propagate_grid(grid, callback=make("p"))
        np.testing.assert_array_equal(np.isnan(rp[4]), np.isnan(rj[4]))
        np.testing.assert_allclose(rp[4], rj[4], rtol=0, atol=1e-11)
    else:
        kw = dict(c_output=kind == "c_output")
        rj = j.propagate_until(50.0, callback=make("j"), **kw)
        rp = p.propagate_until(50.0, callback=make("p"), **kw)
        if kw["c_output"]:
            np.testing.assert_array_equal(rp[4].n_steps, rj[4].n_steps)
            ts = 0.5 * p.time
            np.testing.assert_allclose(rp[4](ts), rj[4](ts), rtol=0,
                                       atol=1e-11)
    assert all(o == ht.TaylorOutcome.cb_stop for o in rp[0])
    assert n["p"] == n["j"] == 4
    _res_equal(rp, rj, p, j)
    assert p.engine_report()["propagate_engine"] == "flat"
