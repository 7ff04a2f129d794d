"""BASELINE config 5's ODEs on the port's CPU batch against the JAX
package: the EGM2008 geopotential of ``benchmarks/geopot_bench.py`` at
degree 4 (270 tape columns) on the B1/B2 twins and, with
``ROLLED_MIN_WIDTH`` lowered to ``tools/cases.py``'s
``ROLLED_TEST_WIDTH``, on the B3 twin, each against the JAX flat batch
(``compact_mode="flat"``, the per-step driver; ROADMAP §C) over 8 steps a
lane; the thermoNET drag ODE (``tools/cases.py`` ``drag_sys``, 2,388
columns, per-lane space weather and ballistic coefficient) on the B4 twin
against the JAX scalar with ``compact_mode=True`` (the JAX flat batch
takes minutes to compile that tape on the CPU): ``tc`` after the first
step, the state after 8.  States within 1e-13 of each component's
largest magnitude (the geopotential's tape holds only sum, mul, div and
sqrt; torch's CPU sqrt is not correctly rounded, ROADMAP §C); the drag's
within 1e-12 (XLA's and torch's tanh/exp/atan last bits).  The ensemble
of a scalar template equals the raw batch on the same lanes bit for
bit."""

import numpy as np
import pytest

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.tools import cases as cs
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH

B = 4
T_END = 3000.0  # 8 steps a lane at tol 1e-15 (steps of ~375 s)
N_STEPS = 8
RTOL = 1e-13
DRAG_RTOL = 1e-12
KW = dict(tol=1e-15, high_accuracy=True)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.abs(b).reshape(-1, b.shape[-1]).max(0)
    err = np.abs(a - b).reshape(-1, b.shape[-1]).max(0)
    assert (err <= rtol * scale).all(), (err / scale).max()


def _energy(st, deg=4):
    e, vs = cs.geopot_energy(ht, deg)
    return ht.make_cfunc([e], vars=vs, device="cpu")(st).numpy()[:, 0]


@pytest.fixture(scope="module")
def jax_deg4():
    """The JAX flat batch's outcomes, steps and state at ``T_END``."""
    tb = hy.taylor_adaptive_batch(cs.geopot_sys(hy, 4), cs.geopot_lanes(B),
                                  compact_mode="flat", **KW)
    oc, _, _, ns = tb.propagate_until(T_END)
    return dict(oc=[int(o) for o in oc], nsteps=np.asarray(ns),
                state=np.array(tb.state))


@pytest.mark.parametrize("route,engine", [
    ("b1b2", dict(jet="jet_plain", propagate_engine="fused",
                  prop="prop_plain")),
    ("b3", dict(jet="jet_rolled_plain", propagate_engine="flat"))])
def test_geopot_batch_against_jax(jax_deg4, monkeypatch, route, engine):
    if route == "b3":
        monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    st = cs.geopot_lanes(B)
    tb = ht.taylor_adaptive_batch(cs.geopot_sys(ht, 4), st, device="cpu",
                                  **KW)
    tb.assert_engine(**engine)
    assert len(tb.decomposition.ops) == 270
    oc, _, _, ns = tb.propagate_until(T_END)
    assert [int(o) for o in oc] == jax_deg4["oc"] \
        == [int(ht.TaylorOutcome.time_limit)] * B
    assert (tb.time == T_END).all()
    np.testing.assert_array_equal(ns, jax_deg4["nsteps"])
    assert (ns == N_STEPS).all()
    _close(tb.state, jax_deg4["state"], RTOL)
    e0, e1 = _energy(st), _energy(tb.state)
    assert np.abs((e1 - e0) / e0).max() <= 1e-13


@pytest.fixture(scope="module")
def jax_drag():
    """The JAX scalar's ``tc`` after one step from lane 0, and its time and
    state after ``N_STEPS``."""
    st, pars = cs.geopot_lanes(2), cs.drag_pars(2)
    ta = hy.taylor_adaptive(cs.drag_sys(hy, 4), st[0], pars=pars[0],
                            compact_mode=True, **KW)
    ta.step()
    tc1 = np.array(ta.tc)
    for _ in range(N_STEPS - 1):
        ta.step()
    return dict(tc1=tc1, time=float(ta.time), state=np.array(ta.state))


def test_drag_batch_against_jax(jax_drag):
    st, pars = cs.geopot_lanes(2), cs.drag_pars(2)
    sys_ = cs.drag_sys(ht, 4)
    tb = ht.taylor_adaptive_batch(sys_, st, pars=pars, device="cpu", **KW)
    tb.assert_engine(jet="phase_plain", propagate_engine="flat")
    assert len(tb.decomposition.ops) == 2388
    assert ht.is_time_dependent([r for _, r in sys_])
    tb.step()
    _close(tb.tc[0], jax_drag["tc1"], DRAG_RTOL)
    for _ in range(N_STEPS - 1):
        tb.step()
    assert tb.time[0] == pytest.approx(jax_drag["time"], rel=1e-13)
    _close(tb.state[0], jax_drag["state"], DRAG_RTOL)
    # drag only takes energy away, on both lanes' own space weather
    e0, e1 = _energy(st), _energy(tb.state)
    assert (e1 < e0).all() and np.isfinite(tb.state).all()


def test_drag_is_the_geopotential_without_atmosphere():
    # Cb = 0 (and ap, f107 in range): the drag ODE's trajectory is the
    # geopotential's, up to the time dependence the density brings
    st = cs.geopot_lanes(2)
    pars = cs.drag_pars(2)
    pars[:, 3] = 0.0
    tb = ht.taylor_adaptive_batch(cs.drag_sys(ht, 4), st, pars=pars,
                                  device="cpu", **KW)
    tg = ht.taylor_adaptive_batch(cs.geopot_sys(ht, 4), st, device="cpu",
                                  **KW)
    tb.propagate_until(1000.0)
    tg.propagate_until(1000.0)
    _close(tb.state, tg.state, RTOL)


def test_ensemble_equals_the_raw_batch():
    st = cs.geopot_lanes(6)
    sys_ = cs.geopot_sys(ht, 4)
    ta = ht.taylor_adaptive(sys_, cs.GEOPOT_IC, device="cpu", **KW)
    res = ht.ensemble_propagate_until(ta, 1000.0, 6, lambda i: {
        "state": st[i]})
    raw = ht.taylor_adaptive_batch(sys_, st, device="cpu", **KW)
    oc, _, _, ns = raw.propagate_until(1000.0)
    np.testing.assert_array_equal(res["state"].numpy(), raw.state)
    np.testing.assert_array_equal(res["nsteps"].numpy(), ns)
    assert (res["time"].numpy() == 1000.0).all()
