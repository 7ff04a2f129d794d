"""The port's multiple-precision integrator (``heyoka_tpu_torch.multiprec``,
mpmath on the host) and the native runtime's tape encoding
(``native.pack_tape``): the cases of ``tests/test_native.py`` for the JAX
package's ``multiprec`` (the f128 comparison, on the port's native
runtime, is in ``tests/test_torch_native.py``), and the oracle case: the port's jet
twins (B2's ``jet_plain``, B3's ``jet_rolled_plain``, B4's
``phase_plain``), in f64 and in f32, against the 40-digit jet at order 20
on the op cases of ``tests/test_engine_matrix.py`` ``_build_sys``.

Tolerances: the mp integrator's own, as the JAX tests state them (the
back-and-forth return to 1e-27 at 30 digits, the Poincare turning times
to 1e-38 at 50 digits, dense output to 1e-36 at 40 digits); the twins per
order relative to the order's largest magnitude over the case's columns,
2e-13 in f64 and 2e-5 in f32 (a few hundred ulps of the working
precision: the recurrences sum up to k+1 products at order k = 20)."""

import mpmath as mp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.expr.decompose import taylor_decompose_sys as hy_decompose
from heyoka_tpu.native import pack_tape as hy_pack_tape

import heyoka_tpu_torch as ht
import test_engine_matrix as em
from heyoka_tpu_torch.native import pack_tape
from heyoka_tpu_torch.expr.decompose import taylor_decompose_sys
from heyoka_tpu_torch.multiprec import MPTaylorIntegrator
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor.compact import build_plan

ORDER = 20
#: per-order bars of the twins against the 40-digit jet
BAR = {torch.float64: 2e-13, torch.float32: 2e-5}
#: the JET_OPS cases of the engine matrix (B2, B3) and the cases of the
#: other ops (B4 takes them all): the sqrt, the two pows, 1/x, x*y and x/y
JET_CASES = ("c1_5", "c1_6", "c1_7", "c1_19", "c2_1", "c2_2")


def test_multiprec_back_and_forth():
    # tests/test_native.py's first case: 5 time units and back at 30
    # digits return to the initial state within 1e-27
    tape = taylor_decompose_sys(ht.models.pendulum())
    m = MPTaylorIntegrator(tape, [0.05, 0.025], dps=30)
    with mp.workdps(30):
        x0, v0 = mp.mpf(0.05), mp.mpf(0.025)
    m.propagate_until(5.0)
    m.propagate_until(0.0)
    with mp.workdps(30):
        err = max(abs(m.state[0] - x0), abs(m.state[1] - v0))
        assert err < mp.mpf(10) ** -27


def test_multiprec_events_poincare():
    # the pendulum's turning points at 50 digits against the closed form
    # T/4 + k T/2, T = 4 K(sin^2(amp/2)), amp = acos(7/8)
    sys_ = ht.models.pendulum(gconst=1.0, length=1.0)
    v = ht.make_vars("v")
    hits = []
    nt = ht.nt_event(v, lambda ta, t, d: hits.append((t, d)))
    m = MPTaylorIntegrator(sys_, [0.0, 0.5], dps=50, nt_events=[nt])
    with mp.workdps(50):
        amp = mp.acos(mp.mpf(7) / 8)
        T = 4 * mp.ellipk(mp.sin(amp / 2) ** 2)
        m.propagate_until(float(1.30 * T))
        assert len(hits) == 3
        for k, (t, d) in enumerate(hits):
            assert abs(t - (2 * k + 1) * T / 4) < mp.mpf(10) ** -38
        assert hits[0][1] == -1 and hits[1][1] == 1
    te = MPTaylorIntegrator(sys_, [0.0, 0.5], dps=50,
                            t_events=[ht.t_event(v)])
    te.propagate_until(100.0)
    with mp.workdps(50):
        assert te.te_triggered == 0
        assert abs(te.time - T / 4) < mp.mpf(10) ** -38
        assert abs(te.state[0] - amp) < mp.mpf(10) ** -38
        te.propagate_until(100.0)  # the cooldown steps past the root
        assert te.te_triggered == 0
        assert abs(te.time - 3 * T / 4) < mp.mpf(10) ** -37


def test_multiprec_dense_output():
    # the grid's states against integrators landed on each point, and the
    # last step's dense output continuous at its end
    sys_ = ht.models.pendulum(gconst=1.0, length=1.0)
    grid = [0.3, 0.9, 1.7, 2.2, 3.0]
    rows = MPTaylorIntegrator(sys_, [0.05, 0.025], dps=40).propagate_grid(
        grid)
    assert len(rows) == len(grid)
    with mp.workdps(40):
        for t, row in zip(grid, rows):
            m2 = MPTaylorIntegrator(sys_, [0.05, 0.025], dps=40)
            m2.propagate_until(t)
            assert abs(m2.time - mp.mpf(t)) < mp.mpf(10) ** -38
            for a, b in zip(row, m2.state):
                assert abs(a - b) < mp.mpf(10) ** -36
    m3 = MPTaylorIntegrator(sys_, [0.05, 0.025], dps=40)
    m3.step()
    with mp.workdps(40):
        mid = m3.update_d_output(m3.time - m3.last_h / 2)
        end = m3.update_d_output(m3.time)
        assert abs(end[0] - m3.state[0]) < mp.mpf(10) ** -38
        assert abs(mid[0]) < 1


def _systems(pkg):
    x, y = pkg.make_vars("x", "y")
    return {
        "pendulum": pkg.models.pendulum(),
        "nbody3": pkg.models.nbody(3, masses=[1.0, 1e-3, 2e-3]),
        "kepler": [(x, pkg.kepE(0.3, y) + pkg.par[0] * pkg.time),
                   (y, pkg.atan2(x, 2.0) - pkg.sigmoid(y))],
    }


@pytest.mark.parametrize("name", ["pendulum", "nbody3", "kepler"])
def test_pack_tape_equals_the_jax_one(name):
    a = pack_tape(taylor_decompose_sys(_systems(ht)[name]))
    b = hy_pack_tape(hy_decompose(_systems(hy)[name]))
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def matrix():
    """The engine matrix's op cases built with the port (its lambdas read
    the module's ``hy``), their initial states, and the 40-digit jet of
    each at order 20: ``{"jet"|"all": (sys, state0, oracle (K+1, n))}``."""
    out = {}
    skip_jet = [c for c in em._build_sys()[2] if c not in JET_CASES]
    saved = em.hy
    em.hy = ht
    try:
        for key, skip in (("jet", skip_jet), ("all", ())):
            sys_, st0, _ = em._build_sys(skip)
            m = MPTaylorIntegrator(sys_, st0, dps=40, order=ORDER)
            with mp.workdps(40):
                m._t = m.time
                cc = m._jet()
            n = len(st0)
            out[key] = (sys_, st0, np.array(
                [[float(cc[k][i]) for i in range(n)]
                 for k in range(ORDER + 1)]))
    finally:
        em.hy = saved
    return out


def _twin(route, sys_, st0, dtype):
    """(K+1, n) jet of the route's twin at t = 0, in ``dtype``."""
    plan = build_plan(taylor_decompose_sys(sys_), ORDER)
    arrays = ht.plan_to_arrays(plan)
    n = len(st0)
    state = torch.tensor(st0, dtype=dtype)[:, None]
    pars = torch.zeros((0, 1), dtype=dtype)
    t = torch.zeros(1, dtype=dtype)
    if route == "b2":
        tc, _ = jk.jet_plain(jk.JetTape(arrays, "cpu"), state, pars, t)
    elif route == "b3":
        tc, _ = jr.jet_rolled_plain(jr.RolledTape(arrays, "cpu"), state,
                                    pars, t)
    else:
        tc, _ = jp.jet_phase(jp.PhaseTape(arrays, "cpu"), state, pars, t)
    assert tc.dtype == dtype
    return tc[:n, :, 0].T.double().numpy()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("route", ["b2", "b3", "b4"])
def test_twins_against_the_mp_oracle(matrix, route, dtype):
    sys_, st0, ref = matrix["all" if route == "b4" else "jet"]
    got = _twin(route, sys_, st0, dtype)
    scale = np.abs(ref).max(1)
    rel = np.abs(got - ref).max(1) / np.where(scale > 0, scale, 1.0)
    assert np.isfinite(got).all()
    assert rel.max() <= BAR[dtype], (route, int(rel.argmax()), rel.max())
