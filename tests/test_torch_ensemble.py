"""The port's ensembles against their individual runs and the JAX
package's ensembles, on the CPU in f64: the cases of
``tests/test_ensemble.py``.  An ensemble is one batch (its instances the
lanes), so each instance equals its own scalar run of the port, step
counts and outcomes exactly and states to 5e-14 (the JAX file's bar: on
the CPU the plain twins' torch kernels may round a lane one ulp apart at
another batch width), and every case against the JAX ensemble on the
same numpy inputs (:func:`_vs_jax`): every key of the JAX result, the
states, times, step sizes and hit times within 1e-12 of the largest
reference value, the outcomes, step counts, ``te_idx``, ``te_sgn``,
``nt_idx``, ``nt_sgn`` and ``nt_count`` exactly, and the sequence of the
event callbacks' arguments.

Dropped or changed from the JAX file: the 8-device mesh becomes
``mesh=["cpu", "cpu"]`` (and ``["cpu", "cpu:0"]``, two device names that
load the tape twice), since a mesh of the port is a list of torch
devices; ``test_ensemble_flat_batch_matches_loop``,
``test_ensemble_mesh_fused_production_path``,
``test_ensemble_mesh_flat_ddinterpret_unfused`` and
``test_ensemble_mesh_row_split_kernel`` compare the JAX package's engines
(``compact_mode``, ``pallas_phase``, ``fused_prop``), which the port does
not have (one engine); the overflow-and-replay case keeps its assertions
at t = 10 instead of 100 (the port's hit log has no buffer to overflow,
and 1,592 event steps take minutes on the CPU)."""

import numpy as np
import pytest
import torch

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.expr import decompose as pdecompose
from heyoka_tpu_torch.taylor import batch as pbatch

N_ITER = 8
TOL = 1e-12


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _states(rng, *shape):
    return 0.05 + 0.01 * rng.standard_normal((*shape, 2))


def _template(pkg=ht, **kw):
    if pkg is ht:
        kw.setdefault("device", "cpu")
    return pkg.taylor_adaptive(pkg.models.pendulum(), [0.05, 0.025],
                               tol=TOL, **kw)


def _scalar(state, **kw):
    return ht.taylor_adaptive(ht.models.pendulum(), state, tol=TOL,
                              device="cpu", **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    """One instance's result against its own run: within 5e-14."""
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=5e-14)


#: the results' floating-point keys; the others are compared exactly
FLOATS = ("state", "time", "min_h", "max_h", "out", "nt_times")


def _landed(r):
    """The instances whose smallest step is a sub-ulp landing step: after
    the step that lands on the target the double-length time may sit half
    an ulp short of it, and the instance takes one more step of that size,
    depending on the last bit of the step sizes
    (``tests/test_torch_prop.py`` ``_main_steps``)."""
    return np.abs(_np(r["min_h"])) < 4 * np.spacing(np.abs(_np(r["time"])))


def _vs_jax(res, rj):
    """The port's ensemble result against the JAX ensemble's: every JAX
    key present with its shape, the floats (NaN padding included) within
    1e-12 of the key's largest finite reference value, the rest equal;
    step counts without a sub-ulp landing step, and ``min_h`` where
    neither side took one (:func:`_landed`)."""
    assert set(rj) <= set(res), set(rj) - set(res)
    lp, lj = _landed(res), _landed(rj)
    for k, ref in rj.items():
        ref, mine = np.asarray(ref), _np(res[k])
        assert mine.shape == ref.shape, (k, mine.shape, ref.shape)
        if k == "nsteps":
            np.testing.assert_array_equal(mine - lp, ref - lj, err_msg=k)
            continue
        if k == "min_h":
            mine, ref = mine[~(lp | lj)], ref[~(lp | lj)]
        if k in FLOATS:
            fin = np.abs(ref[np.isfinite(ref)])
            scale = fin.max() if fin.size else 1.0
            np.testing.assert_allclose(mine, ref, rtol=0,
                                       atol=1e-12 * scale, err_msg=k)
        else:
            np.testing.assert_array_equal(mine, ref, err_msg=k)


def _calls_vs_jax(mine, ref):
    """Two sequences of callback arguments ``(..., t, ...)``: the same
    length, the floats within 1e-12, the rest equal, in the same order."""
    assert len(mine) == len(ref) and mine
    for a, b in zip(mine, ref):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert abs(x - y) <= 1e-12, (a, b)
            else:
                assert x == y, (a, b)


def test_ensemble_matches_individual_and_jax(rng):
    ta = _template()
    states = _states(rng, N_ITER)
    times = rng.uniform(0.0, 1.0, N_ITER)

    def gen(i):
        # each instance its own state and start time
        return {"state": states[i], "time": times[i]}

    res = ht.ensemble_propagate_until(ta, 10.0, N_ITER, gen)
    assert res["state"].shape == (N_ITER, 2)
    assert isinstance(res["state"], torch.Tensor)
    assert (_np(res["outcome"]) == int(ht.TaylorOutcome.time_limit)).all()
    np.testing.assert_array_equal(_np(res["time"]), 10.0)
    for i in range(N_ITER):
        tai = _scalar(states[i], time=times[i])
        oc, mn, mx, ns = tai.propagate_until(10.0)
        _same(res["state"][i], tai.state)
        assert int(res["nsteps"][i]) == ns
        assert float(res["min_h"][i]) == pytest.approx(mn, rel=1e-13)
    # the template is left as it was
    np.testing.assert_array_equal(ta.state, [0.05, 0.025])
    assert ta.time == 0.0
    _vs_jax(res, hy.ensemble_propagate_until(_template(hy), 10.0, N_ITER,
                                             gen))


def test_ensemble_for_and_mesh(rng, monkeypatch):
    ta = _template()
    states = _states(rng, N_ITER)
    gen = {"state": states, "time": np.linspace(0.0, 0.7, N_ITER)}
    plain = ht.ensemble_propagate_for(ta, 5.0, N_ITER, gen)
    np.testing.assert_array_equal(_np(plain["time"]), gen["time"] + 5.0)
    _vs_jax(plain, hy.ensemble_propagate_for(_template(hy), 5.0, N_ITER, gen))
    # no call decomposes or packs the tape again; a second device name
    # loads it once and keeps it on the template
    made = []
    real = pbatch.TaylorAdaptiveBatch._build_engine
    monkeypatch.setattr(pdecompose, "taylor_decompose_sys", None)
    monkeypatch.setattr(pbatch, "taylor_decompose_sys", None)
    monkeypatch.setattr(pbatch.TaylorAdaptiveBatch, "_build_engine",
                        lambda self, d: made.append(d) or real(self, d))
    for mesh in (["cpu", "cpu"], ["cpu", "cpu:0"], ["cpu", "cpu:0"]):
        res = ht.ensemble_propagate_for(ta, 5.0, N_ITER, gen, mesh=mesh)
        for k in ("time", "outcome", "nsteps"):
            assert torch.equal(res[k], plain[k]), k
        _same(res["state"], plain["state"])
    assert made == [torch.device("cpu:0")]
    with pytest.raises(ValueError, match="divisible"):
        ht.ensemble_propagate_until(ta, 5.0, N_ITER, gen, mesh=["cpu"] * 3)


def test_ensemble_grid(rng):
    ta = _template()
    states = _states(rng, N_ITER)
    grid = np.linspace(0.0, 3.0, 5)
    res = ht.ensemble_propagate_grid(ta, grid, N_ITER, {"state": states})
    assert res["out"].shape == (N_ITER, 5, 2)
    for i in range(0, N_ITER, 3):
        *_, out = _scalar(states[i]).propagate_grid(grid)
        _same(res["out"][i], out)
    _vs_jax(res, hy.ensemble_propagate_grid(_template(hy), grid, N_ITER,
                                            {"state": states}))


def test_ensemble_batch_variants(rng):
    st0 = _states(rng, 4)
    tab = ht.taylor_adaptive_batch(ht.models.pendulum(), st0, tol=TOL,
                                   device="cpu")
    jtab = hy.taylor_adaptive_batch(hy.models.pendulum(), st0, tol=TOL)
    states = _states(rng, 3, 4)
    gen = {"state": states, "time": np.linspace(0.0, 0.5, 4)}
    res = ht.ensemble_propagate_until_batch(tab, 5.0, 3, {"state": states})
    assert res["state"].shape == (3, 4, 2) and res["nsteps"].shape == (3, 4)
    _vs_jax(res, hy.ensemble_propagate_until_batch(jtab, 5.0, 3,
                                                   {"state": states}))
    ta = _scalar(states[1, 2])
    ta.propagate_until(5.0)
    _same(res["state"][1, 2], ta.state)
    rf = ht.ensemble_propagate_for_batch(tab, 5.0, 3, gen)
    _vs_jax(rf, hy.ensemble_propagate_for_batch(jtab, 5.0, 3, gen))
    grid = np.linspace(0.0, 2.0, 4)
    rg = ht.ensemble_propagate_grid_batch(tab, grid, 3, {"state": states})
    assert rg["out"].shape == (3, 4, 4, 2)
    _vs_jax(rg, hy.ensemble_propagate_grid_batch(jtab, grid, 3,
                                                 {"state": states}))
    *_, out = _scalar(states[2, 1]).propagate_grid(grid)
    _same(rg["out"][2, 1], out)


def _v():
    return ht.make_vars("x", "v")


def test_ensemble_terminal_event_stops_match_scalar(rng):
    # pure-stop terminal events ride the batch's event driver; every
    # instance stops at its own first turning point, equal to the scalar
    x, v = _v()
    states = _states(rng, N_ITER)
    ta = _template(t_events=[ht.t_event(v)])
    res = ht.ensemble_propagate_until(ta, 100.0, N_ITER, {"state": states})
    assert (_np(res["outcome"]) == 0).all() and (_np(res["te_idx"]) == 0)\
        .all()
    jv = hy.make_vars("x", "v")[1]
    _vs_jax(res, hy.ensemble_propagate_until(
        _template(hy, t_events=[hy.t_event(jv)]), 100.0, N_ITER,
        {"state": states}))
    for i in range(N_ITER):
        tai = _scalar(states[i], t_events=[ht.t_event(v)])
        assert tai.propagate_until(100.0)[0] == 0
        assert float(res["time"][i]) == pytest.approx(tai.time, rel=1e-14)
        _same(res["state"][i], tai.state)
        assert int(res["te_sgn"][i]) == (1 if states[i, 1] < 0 else -1)


def test_ensemble_terminal_event_callback_host_fallback(rng):
    # terminal events with callbacks: one working copy per instance, each
    # equal to its own scalar run
    x, v = _v()
    states = _states(rng, 3)
    calls, args = [], {"p": [], "j": [], "s": []}

    def mk(key):
        def cb(ta_, d_sgn):
            calls.append(ta_)
            args[key].append((float(ta_.time), int(d_sgn)))
            return ta_.time < 1.0
        return cb

    ta = _template(t_events=[ht.t_event(v, callback=mk("p"))])
    res = ht.ensemble_propagate_until(ta, 100.0, 3, {"state": states})
    assert (_np(res["outcome"]) == 0).all() and (_np(res["time"]) > 1.0)\
        .all()
    jv = hy.make_vars("x", "v")[1]
    _vs_jax(res, hy.ensemble_propagate_until(
        _template(hy, t_events=[hy.t_event(jv, callback=mk("j"))]), 100.0,
        3, {"state": states}))
    _calls_vs_jax(args["p"], args["j"])
    assert all(c is not ta for c in calls) and ta.time == 0.0
    for i in range(3):
        tai = _scalar(states[i], t_events=[ht.t_event(v, callback=mk("s"))])
        tai.propagate_until(100.0)
        assert float(res["time"][i]) == pytest.approx(tai.time, rel=1e-14)
        _same(res["state"][i], tai.state)


def test_ensemble_grid_with_events(rng):
    # grids over event-carrying templates: the per-instance fallback, the
    # non-terminal callbacks given the working copy
    x, v = _v()
    states = _states(rng, 3)
    hits = {"p": [], "j": []}

    def mk(key):
        return lambda ta_, t, d: hits[key].append((float(t), int(d)))

    ta = _template(nt_events=[ht.nt_event(x, mk("p"))])
    grid = np.linspace(0.0, 5.0, 11)
    res = ht.ensemble_propagate_grid(ta, grid, 3, {"state": states})
    assert res["out"].shape == (3, 11, 2) and len(hits["p"]) > 0
    assert bool(torch.isfinite(res["out"]).all())
    jx = hy.make_vars("x", "v")[0]
    _vs_jax(res, hy.ensemble_propagate_grid(
        _template(hy, nt_events=[hy.nt_event(jx, mk("j"))]), grid, 3,
        {"state": states}))
    _calls_vs_jax(hits["p"], hits["j"])
    for i in range(3):
        *_, out = _scalar(states[i]).propagate_grid(grid)
        np.testing.assert_allclose(_np(res["out"][i]), out, rtol=0,
                                   atol=1e-11)


def test_ensemble_nt_events_recorded_and_sharded(rng):
    x, v = _v()
    states = _states(rng, N_ITER)
    seen, seen_j = [], []
    ta = _template(nt_events=[ht.nt_event(
        x, lambda r, t, d, i: seen.append((i, t, d)))])
    res = ht.ensemble_propagate_until(ta, 10.0, N_ITER, {"state": states})
    jx = hy.make_vars("x", "v")[0]
    _vs_jax(res, hy.ensemble_propagate_until(
        _template(hy, nt_events=[hy.nt_event(
            jx, lambda r, t, d, i: seen_j.append((i, t, d)))]), 10.0, N_ITER,
        {"state": states}))
    _calls_vs_jax(seen, seen_j)
    assert (_np(res["outcome"]) == int(ht.TaylorOutcome.time_limit)).all()
    # the angle crosses zero twice in each ~2.007 s period
    assert (_np(res["nt_count"]) == 10).all()
    assert [i for i, _, _ in seen] == sorted(i for i, _, _ in seen)
    for i in range(N_ITER):
        times, sgns = _np(res["nt_times"][i]), _np(res["nt_sgn"][i])
        assert (np.diff(times) > 0).all()
        assert all(a != b for a, b in zip(sgns, sgns[1:]))
        hits = []
        _scalar(states[i], nt_events=[ht.nt_event(
            x, lambda ta_, t, d: hits.append((t, d)))]).propagate_until(10.0)
        np.testing.assert_allclose(times, [t for t, _ in hits], rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(sgns, [d for _, d in hits])
        assert [(t, d) for j, t, d in seen if j == i] == list(zip(
            times.tolist(), sgns.tolist()))
    res_m = ht.ensemble_propagate_until(ta, 10.0, N_ITER, {"state": states},
                                        mesh=["cpu", "cpu"])
    for k in ("nt_count", "nt_idx", "nt_sgn"):
        assert torch.equal(res_m[k], res[k]), k
    _same(res_m["nt_times"].nan_to_num(), res["nt_times"].nan_to_num())
    _same(res_m["state"], res["state"])


def test_ensemble_event_stops_keep_instances_apart():
    # instance 0 stops at t = 0.5 on its terminal event; instance 1 records
    # every root of sin(50 t) to t = 10 (the JAX case's overflow and replay,
    # at a tenth of its horizon)
    import math

    def template(pkg):
        x = pkg.make_vars("x", "v")[0]
        return _template(pkg, t_events=[pkg.t_event(pkg.time - pkg.par[0])],
                         nt_events=[pkg.nt_event(
                             pkg.sin(50.0 * pkg.time) + 0.0 * x,
                             lambda *a: None)])

    gen = {"state": np.tile([0.05, 0.025], (2, 1)), "pars": [[0.5], [1e9]]}
    res = ht.ensemble_propagate_until(template(ht), 10.0, 2, gen)
    _vs_jax(res, hy.ensemble_propagate_until(template(hy), 10.0, 2, gen))
    oc = _np(res["outcome"])
    assert oc[0] == 0 and oc[1] == int(ht.TaylorOutcome.time_limit)
    assert abs(float(res["time"][0]) - 0.5) < 1e-12
    count = _np(res["nt_count"])
    assert count[1] == math.floor(10.0 * 50.0 / math.pi) + 1
    t1 = _np(res["nt_times"][1, :count[1]])
    assert (np.diff(t1) > 0).all()
    assert (_np(res["nt_times"][0, :count[0]]) <= 0.5 + 1e-12).all()
    assert np.isnan(_np(res["nt_times"][0, count[0]:])).all()


def test_ensemble_batch_with_events(rng):
    # a batch template with a terminal event (its own event step shared),
    # terminal callbacks (the per-instance fallback on the batch) and a
    # grid with non-terminal events: each against the JAX batch ensemble
    # and each instance's lanes equal to a direct run of the batch on them
    states = _states(rng, 2, 3)
    rec = {"p": [], "j": [], "d": []}

    def mk(key):
        def cb(tb, d_sgn, lane):
            rec[key].append((float(np.asarray(tb.time)[lane]), int(d_sgn),
                             lane))
            return True
        return cb

    def batch(pkg, st, te=None, nt=False, key=None):
        x, v = pkg.make_vars("x", "v")
        kw = dict(device="cpu") if pkg is ht else {}
        if te is not None:
            kw["t_events"] = [pkg.t_event(v, callback=mk(key), cooldown=0.3)
                              if te else pkg.t_event(v)]
        if nt:
            kw["nt_events"] = [pkg.nt_event(x, lambda tb, t, d, lane: None)]
        return pkg.taylor_adaptive_batch(pkg.models.pendulum(), st.copy(),
                                         tol=TOL, **kw)

    gen = {"state": states}
    res = ht.ensemble_propagate_until_batch(batch(ht, states[0], te=False),
                                            50.0, 2, gen)
    assert (_np(res["outcome"]) == 0).all()
    _vs_jax(res, hy.ensemble_propagate_until_batch(
        batch(hy, states[0], te=False), 50.0, 2, gen))
    res = ht.ensemble_propagate_until_batch(
        batch(ht, states[0], te=True, key="p"), 5.0, 2, gen)
    np.testing.assert_allclose(_np(res["time"]), 5.0, rtol=0, atol=1e-12)
    _vs_jax(res, hy.ensemble_propagate_until_batch(
        batch(hy, states[0], te=True, key="j"), 5.0, 2, gen))
    _calls_vs_jax(rec["p"], rec["j"])
    grid = np.linspace(0.0, 3.0, 5)
    rg = ht.ensemble_propagate_grid_batch(batch(ht, states[0], nt=True),
                                          grid, 2, gen)
    _vs_jax(rg, hy.ensemble_propagate_grid_batch(
        batch(hy, states[0], nt=True), grid, 2, gen))
    for i in range(2):
        d = batch(ht, states[i], te=True, key="d")
        d.propagate_until(5.0)
        _same(res["state"][i], d.state)
        *_, out = batch(ht, states[i], nt=True).propagate_grid(grid)
        _same(rg["out"][i], out)
    _calls_vs_jax(rec["d"], rec["p"])
