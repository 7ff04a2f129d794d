"""The ephemeris models of the port (``models/vsop2013.py``,
``models/elp2000.py``, ``models/iau2006.py``) and the batch integrator on
their series tapes against the JAX package, on the CPU in f64.

The JAX reference runs in full f64 (``_FAST = False``, the cached splits
dropped; see tests/test_torch_series.py).  Each JAX batch compiles its
flat propagation for ~25-45 s on the CPU."""

import filecmp
import math
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.expr import series as JS

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.expr import series as PS
from heyoka_tpu_torch.tools.cases import elp_sys, p9_sys, series_times

from test_torch_prop import _main_steps

ROOT = Path(__file__).resolve().parent.parent
B, TOL = 3, 1e-15
#: the batch runs: (system builder, threshold, start half-width, span)
RUNS = {"p9": (p9_sys, 1e-7, 0.5, 0.05), "elp": (elp_sys, 1e-4, 0.5, 0.002)}


def _drop_splits():
    for d in JS._STORE.values():
        d.pop("head", None)
        d.pop("tail", None)


@pytest.fixture(scope="module", autouse=True)
def full_f64():
    old = JS._FAST
    JS._FAST = False
    _drop_splits()
    yield
    JS._FAST = old
    _drop_splits()


def _tape_ops(tape):
    return [(op.op, op.inputs) for op in tape.ops]


# -- the data and the expressions ------------------------------------------------

@pytest.mark.parametrize("name", ["vsop2013_p9.npz", "elp2000.npz",
                                  "iau2006.npz"])
def test_data_files_are_byte_identical(name):
    assert filecmp.cmp(ROOT / "heyoka_tpu_torch" / "data" / name,
                       ROOT / "heyoka_tpu" / "data" / name, shallow=False)


@pytest.mark.parametrize("which", [
    "elp_spherical", "elp_cartesian_series", "elp_fk5_series", "vsop_q",
    "vsop_p_series", "vsop_par_shifted", "iau2006"])
def test_model_tapes_match_jax(which):
    # the same expression DAG in both packages: their decompositions are
    # op for op and operand for operand the same (series ops by key)
    def build(pkg):
        m, tm = pkg.models, pkg.time
        return {
            "elp_spherical": lambda: m.elp2000_spherical(thresh=1e-4),
            "elp_cartesian_series": lambda: m.elp2000_cartesian(
                thresh=1e-5, series_op=True),
            "elp_fk5_series": lambda: m.elp2000_cartesian_fk5(
                thresh=1e-4, series_op=True, time_expr=tm + pkg.par[0]),
            "vsop_q": lambda: [m.vsop2013_elliptic(9, 5, thresh=1e-7)],
            "vsop_p_series": lambda: [m.vsop2013_elliptic(
                9, 6, thresh=1e-8, series_op=True)],
            "vsop_par_shifted": lambda: [m.vsop2013_elliptic(
                9, 5, thresh=1e-6, series_op=True,
                time_expr=2.0 * tm + pkg.par[1])],
            "iau2006": lambda: m.iau2006(thresh=1e-4),
        }[which]()
    tp = ht.function_decompose(build(ht), [])
    tj = hy.function_decompose(build(hy), [])
    assert _tape_ops(tp) == _tape_ops(tj)
    assert len(tp.ops) > 10


def test_model_refusals_and_constants_match_jax():
    m, mj = ht.models, hy.models
    assert m.get_vsop2013_mus() == mj.get_vsop2013_mus()
    assert m.get_elp2000_mus() == mj.get_elp2000_mus()
    with pytest.raises(ValueError, match="not available"):
        m.vsop2013_elliptic(3, 1)
    with pytest.raises(ValueError, match="not available"):
        m.vsop2013_cartesian(9)
    with pytest.raises(ValueError, match="planet index"):
        m.vsop2013_elliptic(0, 1)
    with pytest.raises(ValueError, match="threshold"):
        m.iau2006(thresh=-1.0)
    with pytest.raises(ValueError, match="affine in time"):
        m.vsop2013_elliptic(9, 5, time_expr=ht.time * ht.time,
                            series_op=True)


def test_iau2006_cfunc_matches_jax():
    # the expanded X, Y, s at thresh 1e-4 over +-1 century: 1e-15 of each
    # output's magnitude (sums of ~500 terms of the same libm functions)
    times = np.linspace(-1.0, 1.0, 9)
    got = ht.make_cfunc(ht.models.iau2006(thresh=1e-4), vars=[],
                        device="cpu")(np.zeros((9, 0)), time=times).numpy()
    want = np.asarray(hy.make_cfunc(hy.models.iau2006(thresh=1e-4), vars=[])(
        np.zeros((9, 0)), time=times))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("series_op", [False, True])
def test_elp2000_vs_reference_values(series_op):
    # tests/test_ephemeris.py:23-40: the published test vectors
    # (test/elp2000.cpp:41-46 of the reference) within 0.05 km, through
    # the port's cfunc, the series variant through kernel S1's twin
    cf = ht.make_cfunc(ht.models.elp2000_cartesian_e2000(
        thresh=1e-5, series_op=series_op), vars=[], device="cpu")
    ref = np.array([
        (-361605.79234692274, 44981.04302003427, -30693.19198820311,
         2469000.5),
        (-363123.49639910535, 35877.2078378671, -33194.68710267386,
         2449000.5),
        (-371572.8001113177, 75278.04108874535, -32227.390108194537,
         2429000.5),
        (-373885.8585384737, 127397.62026596011, -30039.82215825389,
         2409000.5),
        (-346323.78767959465, 206374.952164921, -28496.523303933904,
         2389000.5)])
    tm = (ref[:, 3] - 2451545.0) / 36525.0
    out = cf(np.zeros((5, 0)), time=tm).numpy()
    np.testing.assert_allclose(out, ref[:, :3], atol=0.05)


def test_vsop2013_pluto_elements():
    # tests/test_ephemeris.py:51-63: Pluto's inclination and node
    for series_op in (False, True):
        q = ht.models.vsop2013_elliptic(9, 5, thresh=1e-7,
                                        series_op=series_op)
        p = ht.models.vsop2013_elliptic(9, 6, thresh=1e-7,
                                        series_op=series_op)
        out = ht.make_cfunc([q, p], vars=[], device="cpu")(
            np.zeros(0), time=0.0).numpy()
        si2 = math.hypot(out[0], out[1])
        assert 2 * math.degrees(math.asin(si2)) == pytest.approx(17.15,
                                                                 abs=0.05)
        om = math.degrees(math.atan2(out[1], out[0])) % 360
        assert om == pytest.approx(110.29, abs=0.05)


# -- the batch on the series tapes ------------------------------------------------

def _lanes(name):
    build, thresh, half, span = RUNS[name]
    return build, thresh, series_times(B, 3, half), span


def _jax_run(name):
    """The JAX flat batch on one tape, propagated once."""
    build, thresh, t0, span = _lanes(name)
    sys_ = build(hy, thresh)
    tb = hy.taylor_adaptive_batch(sys_, np.zeros((B, len(sys_))), tol=TOL,
                                  time=t0, compact_mode="flat")
    res = tb.propagate_for(span)
    return dict(state=np.asarray(tb.state), t_hi=np.asarray(tb.time),
                nsteps=np.asarray(res[3]), last_h=np.asarray(tb.last_h))


def _port_run(name, **kw):
    build, thresh, t0, span = _lanes(name)
    sys_ = build(ht, thresh)
    tb = ht.taylor_adaptive_batch(sys_, np.zeros((B, len(sys_))), tol=TOL,
                                  time=t0, device="cpu", **kw)
    return tb, tb.propagate_for(span), t0 + span


#: the JAX ELP2000 batch compiles for ~26 s on the CPU (planet 9's ~45 s):
#: its integrator is held in the slow tier, its jets and cfunc in the fast
#: one (tests/test_torch_series.py)
@pytest.mark.parametrize("name", [
    "p9", pytest.param("elp", marks=pytest.mark.slow)])
def test_batch_matches_jax(name):
    # planet-9 q/p at thresh 1e-7 and ELP2000 at 1e-4, lanes at different
    # start times: the same step counts but for a sub-ulp landing step,
    # states within 1e-12 relative (the JAX jet's p_0 is a power sum, the
    # port's Horner's rule, an ulp apart at phases of 10^3-10^4 rad)
    tb, res, t_end = _port_run(name)
    assert tb.engine_report()["series"] == "series_jet_plain"
    assert all(o == ht.TaylorOutcome.time_limit for o in res[0])
    np.testing.assert_array_equal(tb.time, t_end)
    j = _jax_run(name)
    mine = dict(nsteps=np.asarray(res[3]), last_h=np.asarray(tb.last_h),
                t_hi=np.asarray(tb.time))
    theirs = dict(nsteps=j["nsteps"], t_hi=j["t_hi"], last_h=j["last_h"])
    np.testing.assert_array_equal(_main_steps(mine), _main_steps(theirs))
    scale = np.abs(j["state"]).max()
    np.testing.assert_allclose(tb.state, j["state"], rtol=0,
                               atol=1e-12 * scale)


def test_grid_and_pickle_on_the_series_tape():
    # propagate_grid walks the same steps as propagate_until: each row
    # equals a run to that time, to 1e-13; a pickled batch goes on alike
    build, thresh, _, span = _lanes("elp")
    sys_ = build(ht, thresh)
    st = np.random.default_rng(8).uniform(-1e-8, 1e-8, (B, 3))
    mk = lambda: ht.taylor_adaptive_batch(  # noqa: E731
        sys_, st, tol=TOL, time=0.1, device="cpu")
    grid = 0.1 + np.linspace(0.0, span, 5)
    tb = mk()
    rows = tb.propagate_grid(grid)[4]
    for i in (2, 4):
        ref = mk()
        ref.propagate_until(grid[i])
        np.testing.assert_allclose(rows[:, i], ref.state, rtol=0,
                                   atol=1e-13 * np.abs(ref.state).max())
    again = pickle.loads(pickle.dumps(tb))
    assert again.engine_report() == tb.engine_report()
    tb.propagate_for(span / 4)
    again.propagate_for(span / 4)
    np.testing.assert_array_equal(again.state, tb.state)


def test_series_tape_needs_the_card_by_default():
    # the default device is CUDA: without a card the constructor raises
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.taylor_adaptive_batch(p9_sys(ht, 1e-6), np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match="cuda"):
        ht.make_cfunc([PS.trig_series(ht.time, [[1.0]], [[0.0, 1.0]])],
                      vars=[])
