"""float32 in the port (ROADMAP C.4) against the JAX package in float32,
on the CPU: the scalar and batch integrators (kernel B4's f32 twin on
every tape), the jet as unscaled Taylor coefficients, the continuous and
grid outputs, the ensembles, ``cfunc``, SGP4 and the Taylor map, pickling,
and C.4's remainder, which the port once refused: dense series, dataset
interpolants, events and variational systems in f32, each against the
JAX package's f32 run.

Inputs are numpy arrays made from fixed seeds, handed to both packages.
Tolerances: ``test_float32_mode``'s 5e-4 of the f64 run (its own bar);
states within 2e-5 of the JAX f32 run (a few f32 ulps a step over some
60 steps: the two engines sum the recurrences in other orders, and XLA's
f32 sin/cos differ from torch's in the last bit); Taylor coefficients
within 2e-5 of each order's largest magnitude at orders 0-4, and at every
order no farther from the f64 jet than 4x the JAX f32 jet is (f32 loses
~3e-4 at order 9 on the 3-body problem in both); cfunc and SGP4 outputs to
f32 rounding, 1e-5 relative (SGP4's positions 1e-5 of the orbit's
radius, ~0.07 km); an f32 ensemble instance within 1e-6 of its scalar
run (torch's f32 sin/cos round differently on one lane than on four).
C.4's remainder (the f32 jet's bar above): the port's f32 states,
Taylor maps and event times no farther from the JAX f64 run than
``F32_BAR`` = 4 times the JAX f32 run is, outcomes, hit counts and signs
equal; the f32 event grid within ``test_float32_mode``'s 5e-4 of the f64
one."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.models import SGP4Propagator as JaxSGP4

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.models import SGP4Propagator
from heyoka_tpu_torch.tools.cases import eop_ode_sys, p9_sys, sgp4_population

F32 = np.float32
#: the port's f32 states against the JAX package's f32 states
STATE_TOL = 2e-5
#: f32 Taylor coefficients, relative to each order's largest magnitude
TC_TOL = 2e-5
#: f32 evaluations (cfunc, SGP4), relative
EVAL_TOL = 1e-5
MASSES = [1.0, 1e-3, 2e-3]
BASE3 = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                  0, 1.5, 0, -0.8, 0, 0], float)


def _pend_lanes(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.2, 0.2, B)],
                    1)


def _nbody_lanes(B, seed):
    rng = np.random.default_rng(seed)
    return BASE3[None] * (1 + 1e-3 * rng.standard_normal((B, BASE3.size)))


@pytest.fixture(scope="module")
def jax_scalar():
    ta = hy.taylor_adaptive(hy.models.pendulum(), [0.05, 0.025], tol=1e-6,
                            dtype=jnp.float32)
    ta.propagate_until(10.0)
    return ta


def test_float32_mode(jax_scalar):
    # tests/test_integrator.py's case on the port's scalar
    ta = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025], tol=1e-6,
                            dtype=np.float32, device="cpu")
    assert ta.order == ht.taylor_order_from_tol(1e-6) == jax_scalar.order
    ta.propagate_until(10.0)
    ta64 = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025], tol=1e-6,
                              device="cpu")
    ta64.propagate_until(10.0)
    assert ta.state.dtype == np.float32 and ta.dtype == np.float32
    np.testing.assert_allclose(ta.state, ta64.state, rtol=0, atol=5e-4)
    np.testing.assert_allclose(ta.state, jax_scalar.state, rtol=0,
                               atol=STATE_TOL)
    assert ta.time == jax_scalar.time == 10.0
    assert ta.engine_report()["jet"] == "phase_plain"


@pytest.fixture(scope="module")
def batches():
    """(port, JAX) f32 batches, fresh for each name: the pendulum on 6
    lanes at tol 1e-6, and the 3-body problem (sum/mul/pow only: the f64
    port would take B1/B2) on 4 lanes at the f32 epsilon."""
    cache = {}

    def make(name):
        if name == "pendulum":
            st, kw = _pend_lanes(6, 1), dict(tol=1e-6)
            sp, sj = ht.models.pendulum(), hy.models.pendulum()
        else:
            st, kw = _nbody_lanes(4, 2), {}
            sp = ht.models.nbody(3, masses=MASSES)
            sj = hy.models.nbody(3, masses=MASSES)
        if name not in cache:
            cache[name] = hy.taylor_adaptive_batch(sj, st, dtype=jnp.float32,
                                                   **kw)
        jb = cache[name]
        jb.state = st.astype(F32)
        jb.set_time(np.zeros(len(st), F32))
        pb = ht.taylor_adaptive_batch(sp, st, dtype=F32, device="cpu", **kw)
        return pb, jb

    return make


@pytest.mark.parametrize("name,t_end", [("pendulum", 10.0),
                                        ("nbody3", 1.0)])
def test_batch_against_jax(batches, name, t_end):
    pb, jb = batches(name)
    assert pb.order == jb.order and pb.tol == jb.tol
    assert pb.engine_report()["jet"] == "phase_plain"
    assert pb.engine_report()["propagate_engine"] == "flat"
    rp = pb.propagate_until(t_end)
    rj = jb.propagate_until(t_end)
    assert list(rp[0]) == list(rj[0])
    assert np.abs(np.asarray(rp[3]) - np.asarray(rj[3])).max() <= 1
    assert pb.state.dtype == F32 and pb._state.dtype == torch.float32
    assert pb._tc.dtype == pb._t_hi.dtype == pb._last_h.dtype \
        == torch.float32
    hi, lo = pb.dtime
    assert hi.dtype == lo.dtype == F32
    np.testing.assert_array_equal(hi, np.asarray(jb.dtime[0]))
    scale = max(1.0, float(np.abs(jb.state).max()))
    np.testing.assert_allclose(pb.state, jb.state, rtol=0,
                               atol=STATE_TOL * scale)


@pytest.mark.parametrize("name", ["pendulum", "nbody3"])
def test_jet_against_jax(batches, name):
    # one step from the same lanes: the step's unscaled coefficients per
    # order (the JAX class unscales them on the host) against the JAX f32
    # jet, and both against the f64 jet of the same f32 lanes: f32 loses
    # up to ~3e-4 of an order's magnitude at order 9 on the 3-body problem
    # in either package (measured), so the port must be within TC_TOL of
    # JAX at the low orders and no worse than 4x JAX's own f32 error
    pb, jb = batches(name)
    st = pb.state.astype(np.float64)
    p64 = ht.taylor_adaptive_batch(pb.sys, st, tol=pb.tol, device="cpu")
    pb.step()
    jb.step()
    p64.step()
    tp, tj, t64 = pb.tc, np.asarray(jb.tc), p64.tc
    assert tp.dtype == F32 and tp.shape == tj.shape == t64.shape

    def rel(a, b):
        scale = np.abs(b).max(axis=(0, 2))
        return np.abs(a - b).max(axis=(0, 2)) / np.where(scale > 0, scale,
                                                         1)

    assert rel(tp, tj)[:5].max() <= TC_TOL, rel(tp, tj)
    e_port, e_jax = rel(tp, t64), rel(tj, t64)
    assert (e_port <= 4 * e_jax + 1e-6).all(), (e_port, e_jax)
    np.testing.assert_allclose(pb.last_h, np.asarray(jb.last_h), rtol=1e-5)


def test_grid_cout_and_ensemble():
    # propagate_grid, continuous output and an ensemble in f32, held to the
    # f64 runs at test_float32_mode's bar
    st = _pend_lanes(4, 3)
    grid = np.linspace(0.0, 5.0, 11)
    out = {}
    for dt in (np.float64, F32):
        tb = ht.taylor_adaptive_batch(ht.models.pendulum(), st, tol=1e-6,
                                      dtype=dt, device="cpu")
        out[dt] = tb.propagate_grid(grid)[4]
        assert out[dt].dtype == dt
        tb = ht.taylor_adaptive_batch(ht.models.pendulum(), st, tol=1e-6,
                                      dtype=dt, device="cpu")
        co = tb.propagate_until(5.0, c_output=True)[4]
        assert co._tcs.dtype == (torch.float32 if dt == F32
                                 else torch.float64)
        np.testing.assert_allclose(co(np.full(4, 2.5)),
                                   out[dt][:, 5], rtol=0, atol=5e-4)
    np.testing.assert_allclose(out[F32], out[np.float64], rtol=0, atol=5e-4)
    ta = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025], tol=1e-6,
                            dtype=F32, device="cpu")
    res = ht.ensemble_propagate_until(ta, 3.0, 4, dict(state=st))
    assert res["state"].dtype == torch.float32
    for i in range(4):
        one = ht.taylor_adaptive(ht.models.pendulum(), st[i], tol=1e-6,
                                 dtype=F32, device="cpu")
        one.propagate_until(3.0)
        # a few f32 ulps: torch's f32 sin/cos take another code path on one
        # lane than on four
        np.testing.assert_allclose(res["state"][i].numpy(), one.state,
                                   rtol=0, atol=1e-6)


def test_cfunc_against_jax():
    x, y = ht.make_vars("x", "y")
    xj, yj = hy.make_vars("x", "y")
    fp = [ht.sin(x) * ht.exp(-y) + ht.atan2(y, x) + ht.par[0],
          ht.sqrt(x * x + y * y) ** -1.5 * ht.time]
    fj = [hy.sin(xj) * hy.exp(-yj) + hy.atan2(yj, xj) + hy.par[0],
          hy.sqrt(xj * xj + yj * yj) ** -1.5 * hy.time]
    pts = np.random.default_rng(4).uniform(0.1, 2.0, (64, 2))
    cp = ht.make_cfunc(fp, vars=[x, y], device="cpu", dtype=F32)
    cj = hy.make_cfunc(fj, vars=[xj, yj], dtype=jnp.float32)
    op = cp(pts, pars=[0.5], time=1.5)
    oj = np.asarray(cj(pts, pars=np.array([0.5], F32), time=F32(1.5)))
    assert op.dtype == torch.float32 and oj.dtype == F32
    assert cp.dtype == F32
    np.testing.assert_allclose(op.numpy(), oj, rtol=EVAL_TOL, atol=1e-6)


def test_sgp4_against_jax():
    g = sgp4_population(16, 5)
    t = np.linspace(0.0, 1440.0, 3)[:, None] * np.ones((1, 16))
    pp = SGP4Propagator(g, device="cpu", dtype=F32)
    pj = JaxSGP4(g, dtype=jnp.float32)
    op, oj = pp(t), np.asarray(pj(t))
    assert op.dtype == torch.float32 and oj.dtype == F32
    assert repr(pp).endswith("dtype=float32, device=cpu)")
    r = np.linalg.norm(oj[..., :3], axis=-1)[..., None]
    np.testing.assert_allclose(op.numpy()[..., :3], oj[..., :3], rtol=0,
                               atol=EVAL_TOL * float(r.max()))
    np.testing.assert_allclose(op.numpy()[..., 3:6], oj[..., 3:6], rtol=0,
                               atol=EVAL_TOL * 10)
    p64 = SGP4Propagator(g, device="cpu")(t).numpy()
    assert np.abs(op.numpy()[..., :3] - p64[..., :3]).max() < 1.0  # km


def test_taylor_map_in_f32():
    vs = ht.var_ode_sys(ht.models.pendulum(), ht.VarArgs.vars, 2)
    vj = hy.var_ode_sys(hy.models.pendulum(), hy.VarArgs.vars, 2)
    rng = np.random.default_rng(6)
    aug = rng.uniform(-1, 1, len(vs.sys))
    d = np.array([1e-2, -2e-2])
    tp = vs.make_taylor_map(dtype=F32, device="cpu")
    tj = vj.make_taylor_map(dtype=jnp.float32)
    op, oj = tp(d, aug), np.asarray(tj(d, aug))
    assert op.dtype == torch.float32
    np.testing.assert_allclose(op.numpy(), oj, rtol=EVAL_TOL, atol=1e-7)
    o64 = vs.make_taylor_map(device="cpu")(d, aug)
    assert o64.dtype == torch.float64


@pytest.mark.parametrize("kind", ["batch", "scalar"])
def test_pickle_keeps_float32(kind):
    if kind == "batch":
        a = ht.taylor_adaptive_batch(ht.models.pendulum(), _pend_lanes(3, 7),
                                     tol=1e-6, dtype=F32, device="cpu")
    else:
        a = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025],
                               tol=1e-6, dtype=F32, device="cpu")
    a.propagate_until(2.0)
    b = pickle.loads(pickle.dumps(a))
    assert b.dtype == F32 and b.tol == a.tol
    np.testing.assert_array_equal(b.state, a.state)
    np.testing.assert_array_equal(b.tc, a.tc)
    a.propagate_until(4.0)
    b.propagate_until(4.0)
    np.testing.assert_array_equal(b.state, a.state)


#: C.4's remainder (once refused in f32): the bar of each case,
#: the port's f32 result no farther from the JAX f64 run than this many
#: times the JAX f32 run is
F32_BAR = 4.0
#: the start of the EOP/SW ODE: 2015-01-01 00:00 TT, days since J2000, and
#: its span (days), step cap and lanes' offsets (the f64 test's)
EOP_T0, EOP_SPAN, EOP_MDT = 5478.5, 3.0, 0.02


@pytest.fixture(scope="module")
def full_f64_series():
    """The JAX series reference in full f64 (its f32 tail off and the
    cached head/tail splits dropped), as ``tests/test_torch_ephemeris.py``
    runs it; restored after the module."""
    import heyoka_tpu.expr.series as JS

    old = JS._FAST
    JS._FAST = False
    for d in JS._STORE.values():
        d.pop("head", None)
        d.pop("tail", None)
    yield
    JS._FAST = old


def _bar(port32, jax32, jax64):
    """``max |port32 - jax64| <= F32_BAR max |jax32 - jax64|``."""
    p, j, r = (np.asarray(a, np.float64) for a in (port32, jax32, jax64))
    assert np.abs(p - r).max() <= F32_BAR * np.abs(j - r).max(), (
        np.abs(p - r).max(), np.abs(j - r).max())


def _hit_logs():
    """Per-lane hit logs and the port's / JAX's nt callbacks (batch and
    scalar signatures) that fill them."""
    logs = {}

    def batch_cb(tag):
        return lambda tb, t, d, lane: logs.setdefault(
            (tag, lane), []).append((float(t), int(d)))

    def scalar_cb(tag, lane):
        return lambda ta, t, d: logs.setdefault(
            (tag, lane), []).append((float(t), int(d)))

    return logs, batch_cb, scalar_cb


def _remainder_run(case):
    """The case in f32 on the port (batch on 2 lanes, and the scalar on
    lane 0) and on the JAX package in f32 and f64: ``(port batch, port
    scalar, {tag: (state, outcomes, hits)})`` for tags ``p32``, ``s32``,
    ``j32``, ``j64``; hits ``{lane: [(t, d_sgn)]}``."""
    out = {}
    if case in ("series", "interp"):
        if case == "series":
            mk, st, t_end = (lambda p: p9_sys(p, 1e-5)), np.zeros((2, 2)), 0.5
            kw, jkw = {}, dict(compact_mode="flat")
            mdt = None
        else:
            mk, st = eop_ode_sys, np.zeros((2, 2))
            kw = dict(time=np.array([EOP_T0, EOP_T0 + 0.3]))
            t_end, jkw, mdt = EOP_T0 + EOP_SPAN, {}, EOP_MDT
        pb = ht.taylor_adaptive_batch(mk(ht), st, dtype=F32, device="cpu",
                                      **kw)
        rp = pb.propagate_until(t_end, max_delta_t=mdt)
        ps = ht.taylor_adaptive(mk(ht), st[0], dtype=F32, device="cpu",
                                time=float(kw.get("time", [0.0])[0]))
        rs = ps.propagate_until(t_end, max_delta_t=mdt)
        out["p32"] = (pb.state, list(rp[0]), None)
        out["s32"] = (ps.state[None], [rs[0]], None)
        for tag, dt in (("j32", jnp.float32), ("j64", jnp.float64)):
            jb = hy.taylor_adaptive_batch(mk(hy), st, dtype=dt, **kw, **jkw)
            rj = jb.propagate_until(t_end, max_delta_t=mdt)
            out[tag] = (np.asarray(jb.state), list(rj[0]), None)
        return pb, ps, out
    if case == "var_ode_sys":
        st = _pend_lanes(2, 0)
        pb = ht.taylor_adaptive_batch(
            ht.var_ode_sys(ht.models.pendulum(), ht.VarArgs.vars, 1), st,
            dtype=F32, tol=1e-6, device="cpu")
        rp = pb.propagate_until(3.0)
        ps = ht.taylor_adaptive(
            ht.var_ode_sys(ht.models.pendulum(), ht.VarArgs.vars, 1), st[0],
            dtype=F32, tol=1e-6, device="cpu")
        rs = ps.propagate_until(3.0)
        d = np.array([1e-3, -1e-3])
        out["p32"] = (np.concatenate([pb.state, pb.eval_taylor_map(d)], 1),
                      list(rp[0]), None)
        out["s32"] = (np.concatenate([ps.state, ps.eval_taylor_map(d)])[None],
                      [rs[0]], None)
        for tag, dt in (("j32", jnp.float32), ("j64", jnp.float64)):
            jb = hy.taylor_adaptive_batch(
                hy.var_ode_sys(hy.models.pendulum(), hy.VarArgs.vars, 1), st,
                dtype=dt, tol=1e-6, compact_mode="flat")
            rj = jb.propagate_until(3.0)
            out[tag] = (np.concatenate([np.asarray(jb.state),
                                        jb.eval_taylor_map(d)], 1),
                        list(rj[0]), None)
        return pb, ps, out
    # the events: the pendulum's turning points (nt_event(v)) over 10 time
    # units, or the first one stopping it (t_event(v)); the JAX references
    # lane by lane on its scalar (compact mode), the JAX batch's event
    # step compiling for minutes on this host
    st = _pend_lanes(2, 0)
    logs, batch_cb, scalar_cb = _hit_logs()

    def events(pkg, tag, lane=None):
        v = pkg.make_vars("v")
        if case == "t_events":
            return dict(t_events=[pkg.t_event(v)])
        cb = batch_cb(tag) if lane is None else scalar_cb(tag, lane)
        return dict(nt_events=[pkg.nt_event(v, cb)])

    pb = ht.taylor_adaptive_batch(ht.models.pendulum(), st, dtype=F32,
                                  tol=1e-6, device="cpu",
                                  **events(ht, "p32"))
    rp = pb.propagate_until(10.0)
    ps = ht.taylor_adaptive(ht.models.pendulum(), st[0], dtype=F32,
                            tol=1e-6, device="cpu", **events(ht, "s32", 0))
    rs = ps.propagate_until(10.0)
    out["p32"] = (np.concatenate([pb.state, pb.time[:, None]], 1),
                  list(rp[0]), None)
    out["s32"] = (np.concatenate([ps.state, [ps.time]])[None], [rs[0]],
                  None)
    for tag, dt in (("j32", jnp.float32), ("j64", jnp.float64)):
        rows, ocs = [], []
        for lane in range(2):
            ta = hy.taylor_adaptive(hy.models.pendulum(), st[lane], dtype=dt,
                                    tol=1e-6, compact_mode=True,
                                    **events(hy, tag, lane))
            ocs.append(ta.propagate_until(10.0)[0])
            rows.append(np.concatenate([np.asarray(ta.state), [ta.time]]))
        out[tag] = (np.array(rows), ocs, None)
    for tag in out:
        out[tag] = (*out[tag][:2], {lane: logs.get((tag, lane), [])
                                    for lane in range(2)})
    return pb, ps, out


@pytest.mark.parametrize("case", ["series", "interp", "events", "t_events",
                                  "var_ode_sys"])
def test_c4_remainder_is_refused(case, full_f64_series):
    # C.4's remainder, repaired: each case once refused in f32 runs in f32
    # on the batch and on the scalar, on the f32 route (B4-f32's twin), and
    # holds against the JAX package's f32 run: no farther from its f64 run
    # than F32_BAR times the JAX f32 run is, with equal outcomes and, for
    # events, equal hit counts and signs
    pb, ps, out = _remainder_run(case)
    assert pb.dtype == ps.dtype == F32 and pb._state.dtype == torch.float32
    assert pb.engine_report()["jet"] == ps.engine_report()["jet"] \
        == "phase_plain"
    if case in ("events", "t_events"):
        assert pb.engine_report()["propagate_engine"] == "events"
        assert pb._ev is not None and pb._tc.dtype == torch.float32
    for tag in ("p32", "s32"):
        n = len(out[tag][0])
        assert [int(o) for o in out[tag][1]] == \
            [int(o) for o in out["j32"][1][:n]]
        _bar(out[tag][0], out["j32"][0][:n], out["j64"][0][:n])
    if case == "t_events":
        assert [int(o) for o in out["p32"][1]] == [0, 0]
    if case == "events":
        for tag in ("p32", "s32"):
            for lane, hits in out[tag][2].items():
                if tag == "s32" and lane:
                    continue
                ref, f64 = out["j32"][2][lane], out["j64"][2][lane]
                assert len(hits) == len(ref) == len(f64) > 0
                assert [d for _, d in hits] == [d for _, d in ref]
                _bar([t for t, _ in hits], [t for t, _ in ref],
                     [t for t, _ in f64])


def test_f32_event_grid_and_te_callbacks():
    # the f32 event route through the grid driver and the te-callback
    # loop: rows and hits against the port's f64 run at the same tol
    v = ht.make_vars("v")
    st = _pend_lanes(3, 4)
    grid = np.linspace(0.0, 6.0, 13)
    runs = {}
    for dt in (F32, np.float64):
        hits, stops = [], []

        def te_cb(tb, d, lane, stops=stops):
            stops.append((lane, float(tb.time[lane])))
            return len(stops) < 4

        tb = ht.taylor_adaptive_batch(
            ht.models.pendulum(), st, dtype=dt, tol=1e-6, device="cpu",
            nt_events=[ht.nt_event(v, lambda tb, t, d, lane, hits=hits:
                                   hits.append((lane, float(t), d)))])
        out = tb.propagate_grid(grid)[4]
        assert tb.engine_report()["grid_engine"] == "events"
        te = ht.taylor_adaptive_batch(
            ht.models.pendulum(), st, dtype=dt, tol=1e-6, device="cpu",
            t_events=[ht.t_event(v, callback=te_cb)])
        oc = te.propagate_until(10.0)[0]
        runs[dt] = (out, sorted(hits), stops, [int(o) for o in oc],
                    te.state)
    (o32, h32, s32, c32, e32), (o64, h64, s64, c64, e64) = \
        runs[F32], runs[np.float64]
    assert o32.dtype == F32
    np.testing.assert_allclose(o32, o64, rtol=0, atol=5e-4)
    assert [(l, d) for l, _, d in h32] == [(l, d) for l, _, d in h64]
    np.testing.assert_allclose([t for _, t, _ in h32],
                               [t for _, t, _ in h64], rtol=0, atol=5e-4)
    assert [l for l, _ in s32] == [l for l, _ in s64] and c32 == c64
    np.testing.assert_allclose([t for _, t in s32], [t for _, t in s64],
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(e32, e64, rtol=0, atol=5e-4)
