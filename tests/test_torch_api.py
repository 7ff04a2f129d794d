"""The plain members of the port's batch integrator against the JAX
package's (``compact_mode="flat"``), on the CPU in f64, on the three
routes (kernel B2's twin: the 3-body problem; B3's: 12 mascons,
``ROLLED_MIN_WIDTH`` lowered; B4's: the pendulum): the properties, the
setters, ``set_dtime``'s normalisation, ``step(write_tc=)``,
``step_backward``, ``assert_engine``, ``warmup``, pickling, and the
default device.  The kernels themselves run pickling and the new drivers
in tests/test_torch_gpu.py."""

import pickle

import numpy as np
import pytest
import torch

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH, ROUTES, route_case

B, SEED, TOL = 5, 11, 1e-12
HORIZON = {"b2": 2.0, "b3": 2.0, "b4": 1.0}
JETS = {"b2": "jet_plain", "b3": "jet_rolled_plain", "b4": "phase_plain"}


def _port(route, monkeypatch, **kw):
    if route == "b3":
        monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, B, SEED)
    return ht.taylor_adaptive_batch(sys_, st, tol=TOL, high_accuracy=True,
                                    device="cpu", **kw)


def _jax(route):
    sys_, st = route_case(hy, route, B, SEED)
    return hy.taylor_adaptive_batch(sys_, st, compact_mode="flat", tol=TOL,
                                    high_accuracy=True)


def _timedep(m):
    # a parameter and the time: the setters of pars reach the jet
    x, y = m.make_vars("x", "y")
    return [(x, y), (y, -x / m.sqrt(1.0 + x * x) + m.par[0] * m.time_)]


def _lanes(p):
    """Everything a continuation reads, as numpy arrays."""
    return (p.state, p.pars, *p.dtime, p.last_h, p.tc)


@pytest.mark.parametrize("route", ROUTES)
def test_properties_match_jax(monkeypatch, route):
    j, p = _jax(route), _port(route, monkeypatch)
    assert p.batch_size == j.batch_size == B
    assert p.tol == j.tol == TOL
    assert p.order == j.order and p.dim == j.dim
    assert p.high_accuracy is j.high_accuracy is True
    assert [(str(a), str(b)) for a, b in p.sys] == \
        [(str(a), str(b)) for a, b in j.sys]
    dp, dj = p.decomposition, j.decomposition
    assert (dp.n_eq, dp.n_pars, len(dp.ops)) == (dj.n_eq, dj.n_pars,
                                                len(dj.ops))
    assert [op.op for op in dp.ops] == [op.op for op in dj.ops]
    assert p.engine_report()["jet"] == JETS[route]
    np.testing.assert_array_equal(p.pars, j.pars)


@pytest.mark.parametrize("route", ROUTES)
def test_state_and_time_setters_match_jax(monkeypatch, route):
    j, p = _jax(route), _port(route, monkeypatch)
    st = route_case(ht, route, B, SEED + 1)[1]
    for x in (j, p):
        x.state = st
        x.set_time(np.linspace(0.5, 1.0, B))
        x.step()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-13)
    np.testing.assert_allclose(p.time, j.time, rtol=1e-15)
    with pytest.raises(ValueError):
        p.state = st[:, :1]
    p.set_time(3.0)
    assert (p.dtime[0] == 3.0).all() and (p.dtime[1] == 0.0).all()


def test_pars_setter_matches_jax():
    rng = np.random.default_rng(SEED)
    st, pars = rng.uniform(-1, 1, (B, 2)), rng.uniform(0.01, 0.05, (B, 1))
    kw = dict(tol=TOL, high_accuracy=True, pars=pars)
    j = hy.taylor_adaptive_batch(_timedep(hy), st, compact_mode="flat", **kw)
    p = ht.taylor_adaptive_batch(_timedep(ht), st, device="cpu", **kw)
    new = pars[::-1] * 3.0
    j.pars = new
    p.pars = new.ravel()  # any shape of B x n_pars values
    np.testing.assert_array_equal(p.pars, new)
    j.propagate_until(2.0)
    p.propagate_until(2.0)
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-12)


def test_set_dtime_normalizes_like_jax():
    j, p = _jax("b4"), _port("b4", None)
    hi = np.array([1.0, 2.0, -3.0, 1e10, 0.0])
    lo = np.array([0.75, 2.0**-60, 1e-3, 0.5, 1e-20])
    j.set_dtime(hi, lo)
    p.set_dtime(hi, lo)
    for a, b in zip(p.dtime, j.dtime):
        np.testing.assert_array_equal(a, b)
    assert p.dtime[0][0] == 1.75 and p.dtime[1][0] == 0.0
    np.testing.assert_array_equal(p.time, j.time)
    p.set_dtime(5.0, 0.0)
    assert (p.time == 5.0).all()
    for x in (j, p):
        with pytest.raises(ValueError):
            x.set_dtime(np.inf, 0.0)


@pytest.mark.parametrize("route", ROUTES)
def test_step_write_tc_and_step_backward(monkeypatch, route):
    j, p, q = _jax(route), _port(route, monkeypatch), \
        _port(route, monkeypatch)
    # write_tc changes nothing: the coefficients are always kept
    p.step(write_tc=True)
    q.step()
    for a, b in zip(_lanes(p), _lanes(q)):
        np.testing.assert_array_equal(a, b)
    j.step(write_tc=True)
    p.step_backward()
    j.step_backward()
    assert (p.last_h < 0).all()
    assert [o for o, _ in p.get_step_res()] == \
        [o for o, _ in j.get_step_res()]
    np.testing.assert_allclose(p.last_h, j.last_h, rtol=1e-13)
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-13)
    np.testing.assert_allclose(p.tc, j.tc, rtol=0, atol=1e-13)


def test_assert_engine():
    p = _port("b2", None)
    assert p.assert_engine(jet="jet_plain", propagate_engine="fused",
                           grid_engine="flat") is p
    with pytest.raises(AssertionError, match="propagate_engine"):
        p.assert_engine(propagate_engine="flat")
    with pytest.raises(AssertionError, match="jet"):
        _port("b4", None).assert_engine(jet="jet_plain")
    j = _jax("b2")
    assert j.assert_engine(propagate_engine="flat") is j
    with pytest.raises(AssertionError):
        j.assert_engine(propagate_engine="fused")


@pytest.mark.parametrize("route", ROUTES)
def test_warmup_keeps_the_state(monkeypatch, route):
    p = _port(route, monkeypatch)
    p.set_time(np.linspace(0.0, 0.5, B))  # the grid warmup: lanes apart
    p.step()
    before = _lanes(p)
    assert p.warmup(("step", "propagate_until", "propagate_grid"),
                    grid_size=4) is p
    for a, b in zip(_lanes(p), before):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown"):
        p.warmup(("stepp",))
    if route == "b4":  # the JAX class: the same contract
        j = _jax(route)
        st = j.state
        assert j.warmup(("step", "propagate_until")) is j
        np.testing.assert_array_equal(j.state, st)


@pytest.mark.parametrize("route", ROUTES)
def test_pickle_round_trip(monkeypatch, route):
    p = _port(route, monkeypatch)
    p.propagate_for(HORIZON[route] / 2)
    q = pickle.loads(pickle.dumps(p))
    assert q.engine_report() == p.engine_report()
    for a, b in zip(_lanes(q), _lanes(p)):
        np.testing.assert_array_equal(a, b)
    # the continuation of either copy, bit for bit
    rp = p.propagate_until(HORIZON[route])
    rq = q.propagate_until(HORIZON[route])
    for a, b in zip(_lanes(q), _lanes(p)):
        np.testing.assert_array_equal(a, b)
    assert rp[0] == rq[0]
    np.testing.assert_array_equal(rp[3], rq[3])
    # the JAX class's keys, without its TPU engine knobs, and the device
    st = p.__getstate__()
    jst = _jax(route).__getstate__()
    assert set(st) - {"device"} <= set(jst) and st["device"] == "cpu"


def test_unpickle_needs_the_device(monkeypatch):
    p = _port("b4", None)
    data = pickle.dumps(p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = p.__getstate__()
    st["device"] = "cuda"
    q = ht.TaylorAdaptiveBatch.__new__(ht.TaylorAdaptiveBatch)
    with pytest.raises(RuntimeError, match="cuda"):
        q.__setstate__(st)
    assert pickle.loads(data).engine_report()["device"] == "cpu"


def test_default_device_is_cuda(monkeypatch):
    # the entry point runs on the card unless the caller asks for the
    # CPU; without a card it raises, it never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys_, st = route_case(ht, "b4", 2, SEED)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ht.taylor_adaptive_batch(sys_, st)
    assert ht.taylor_adaptive_batch(sys_, st, device="cpu").engine_report()[
        "device"] == "cpu"


def test_out_of_scope_members_raise():
    # the variational members (ROADMAP A.20, now ported) raise
    # ValueError on an integrator without a var_ode_sys, as the JAX
    # class's do; callbacks and events (A.11) are ported: a host callback
    # that returns False stops every lane after one step, as in JAX, and
    # an event must be one
    p = _port("b4", None)
    j = _jax("b4")
    rp = p.propagate_for(1.0, callback=lambda ta: False)
    rj = j.propagate_for(1.0, callback=lambda ta: False)
    assert rp[0] == rj[0] == [ht.TaylorOutcome.cb_stop] * B
    assert (rp[3] == 1).all() and (rj[3] == 1).all()
    sys_, st = route_case(ht, "b4", B, SEED)
    with pytest.raises(AttributeError):
        ht.taylor_adaptive_batch(sys_, st, device="cpu", t_events=[object()])
    assert p.is_variational is j.is_variational is False
    assert p.get_n_orig_sv() == j.get_n_orig_sv() == p.dim
    for name in ("get_vargs", "get_vorder", "get_tstate"):
        with pytest.raises(ValueError, match="var_ode_sys"):
            getattr(p, name)()
        with pytest.raises(ValueError, match="var_ode_sys"):
            getattr(j, name)()
