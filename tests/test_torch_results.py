"""A call's per-lane results (``TaylorAdaptiveBatch._finish``): one host
read of the outcome codes, last steps, min_h, max_h and nsteps, the
outcomes by table lookup, and ``get_step_res``/``get_propagate_res``'s
tuples built only when read.  On the fused and flat routes and the event
route, with every outcome kind (``time_limit``, ``step_limit``,
``err_nf_state``, a terminal event's index), the results equal, value
and type, those built the old way from the propagation's tensors (an enum call
a lane, ``tolist`` of each field), and the JAX package's; a later call's
results are its own; a call whose results nobody reads builds no list."""

import numpy as np
import pytest

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.taylor.events import outcome_of, outcomes_of

B, TOL = 6, 1e-12
HH = np.array([0.0, 0.1, 0.35, 0.1])


def hh_sys(m):
    x, y, px, py = m.make_vars("x", "y", "px", "py")
    return [(x, px), (y, py), (px, -x - 2.0 * x * y),
            (py, y * y - x * x - y)]


def lanes(nan_lane=None):
    rng = np.random.default_rng(3)
    st = HH[None] + 1e-3 * rng.standard_normal((B, 4))
    if nan_lane is not None:
        st[nan_lane, 0] = np.nan
    return st


def t_event(m):
    # y = 0.05 going down: most lanes cross it within a few time units
    y = m.make_vars("y")
    return m.t_event(y - 0.05, direction=m.EventDirection.negative)


@pytest.fixture(scope="module")
def jax_batch():
    """One JAX integrator without events and one with the terminal event
    (no callback), reset to ``lanes(nan_lane)`` at t = 0."""
    cache = {}

    def get(events, nan_lane=None):
        st = lanes(nan_lane)
        if events not in cache:
            kw = dict(t_events=[t_event(hy)]) if events else {}
            cache[events] = hy.taylor_adaptive_batch(
                hh_sys(hy), lanes(), compact_mode="flat", tol=TOL,
                high_accuracy=True, **kw)
        j = cache[events]
        j.state = st
        j.set_time(0.0)
        if events:
            j.reset_cooldowns()
        return j

    return get


def port(route, nan_lane=None):
    kw = dict(t_events=[t_event(ht)]) if route == "events" else {}
    p = ht.taylor_adaptive_batch(hh_sys(ht), lanes(nan_lane), tol=TOL,
                                 high_accuracy=True, device="cpu", **kw)
    if route == "flat":
        # the per-step route, which a tape B1 cannot take runs
        p._pu_fn, p._pu_engine = p._flat_pu, "flat"
    assert p.engine_report()["propagate_engine"] == route
    return p


def old_way(res):
    """The results as ``_finish`` built them before: an enum call a lane
    over the outcome's ``tolist``, the last steps' ``tolist``, a host copy
    of each statistic, and the tuples zipped at once."""
    oc = [outcome_of(o) for o in res["outcome"].tolist()]
    step = list(zip(oc, res["last_h"].tolist()))
    mn, mx, ns = (res[k].cpu().numpy() for k in ("min_h", "max_h", "nsteps"))
    prop = list(zip(oc, mn.tolist(), mx.tolist(), ns.tolist()))
    return oc, mn, mx, ns, step, prop


@pytest.fixture
def taken(monkeypatch):
    """The propagation results each ``_finish`` takes, in call order."""
    seen = []
    real = pbatch.TaylorAdaptiveBatch._finish
    monkeypatch.setattr(pbatch.TaylorAdaptiveBatch, "_finish",
                        lambda self, res: seen.append(res) or real(self, res))
    return seen


def same_typed(a, b):
    """Equal lists of equal tuples (or items), each element of the same
    Python type: ``TaylorOutcome``, ``int`` or ``float``."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x) is type(y)
        if isinstance(x, tuple):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                assert type(u) is type(v) and type(u) in (
                    ht.TaylorOutcome, int, float)
                assert u == v or (u != u and v != v)
        else:
            assert type(x) in (ht.TaylorOutcome, int) and x == y


def check_old_way(p, out, res):
    oc, mn, mx, ns, step, prop = old_way(res)
    same_typed(out[0], oc)
    for got, want in zip(out[1:4], (mn, mx, ns)):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert out[3].dtype == np.int64 and out[1].dtype == np.float64
    same_typed(p.get_step_res(), step)
    same_typed(p.get_propagate_res(), prop)


def main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (test_torch_prop)."""
    last_h = np.asarray(last_h)
    tiny = (np.abs(last_h) < 4 * np.spacing(np.abs(t))) & (last_h != 0.0)
    return np.asarray(ns) - tiny


def check_jax(p, j, out, outj, t):
    assert [int(o) for o in out[0]] == [int(o) for o in outj[0]]
    assert out[0] == list(outj[0])
    for a, b in zip(out[1:3], outj[1:3]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10)
    np.testing.assert_array_equal(main_steps(out[3], p.last_h, t),
                                  main_steps(outj[3], j.last_h, t))
    pr, jr = p.get_propagate_res(), j.get_propagate_res()
    assert [r[0] for r in pr] == [r[0] for r in jr]
    np.testing.assert_allclose([r[1:3] for r in pr],
                               np.asarray([r[1:3] for r in jr], float),
                               rtol=1e-10)
    assert [r[0] for r in p.get_step_res()] == \
        [r[0] for r in j.get_step_res()]
    np.testing.assert_allclose([r[1] for r in p.get_step_res()],
                               [float(r[1]) for r in j.get_step_res()],
                               rtol=1e-10)


# each case: its target (per lane), max_steps, the NaN lane, the kinds of
# outcome it must give
CASES = {
    "time_limit": (np.full(B, 3.0), 0, None, {"time_limit"}),
    "mixed": (np.array([2.0, 2.0, 2.0, 300.0, 300.0, 2.0]), 40, 5,
              {"time_limit", "step_limit", "err_nf_state"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", ["fused", "flat"])
def test_results_match_old_way_and_jax(jax_batch, taken, route, case):
    t, max_steps, nan_lane, kinds = CASES[case]
    p, j = port(route, nan_lane), jax_batch(False, nan_lane)
    out = p.propagate_until(t, max_steps=max_steps)
    assert {o.name for o in out[0]} == kinds
    if case == "time_limit":
        assert len({id(o) for o in out[0]}) == 1
    check_old_way(p, out, taken[-1])
    outj = j.propagate_until(t, max_steps=max_steps)
    check_jax(p, j, out, outj, t)


def test_event_index_results_match_old_way_and_jax(jax_batch, taken):
    # a terminal event without a callback stops a lane with its index (an
    # int 0): lanes 0 and 1 reach their short target first, lane 4 is NaN
    t = np.array([0.01, 0.01, 30.0, 30.0, 30.0, 30.0])
    p, j = port("events", 4), jax_batch(True, 4)
    out = p.propagate_until(t)
    kinds = {o if type(o) is int else o.name for o in out[0]}
    assert kinds == {0, "time_limit", "err_nf_state"}
    assert sum(type(o) is int for o in out[0]) >= 2
    check_old_way(p, out, taken[-1])
    outj = j.propagate_until(t)
    check_jax(p, j, out, outj, t)


@pytest.mark.parametrize("route", ["fused", "flat"])
def test_grid_and_c_output_results_match_old_way(taken, route):
    p = port(route, nan_lane=2)
    out = p.propagate_grid(np.linspace(0.0, 2.0, 5), max_steps=30)
    check_old_way(p, out, taken[-1])
    out = p.propagate_until(4.0, c_output=True, max_steps=3)
    assert {o.name for o in out[0]} == {"step_limit", "err_nf_state"}
    check_old_way(p, out, taken[-1])


def test_outcomes_of_table():
    codes = np.array([-1, -2, -3, -4, -5, 0, 3, -3])
    got = outcomes_of(codes)
    same_typed(got, [outcome_of(c) for c in codes.tolist()])
    same_typed(outcomes_of(np.full(4, 2)), [2] * 4)
    same_typed(outcomes_of(np.full(3, -3)), [ht.TaylorOutcome.time_limit] * 3)
    assert outcomes_of(np.zeros(0, np.int64)) == []


def test_later_call_results_are_its_own():
    p = port("fused")
    first = p.propagate_until(50.0, max_steps=5)
    kept = p.get_propagate_res()
    assert all(r[0] == ht.TaylorOutcome.step_limit and r[3] == 5
               for r in kept)
    second = p.propagate_until(1.0)
    res = p.get_propagate_res()
    assert all(r[0] == ht.TaylorOutcome.time_limit for r in res)
    assert [r[3] for r in res] == second[3].tolist() != first[3].tolist()
    # the list read before is a copy: the later call changed nothing in it
    assert all(r[0] == ht.TaylorOutcome.step_limit and r[3] == 5
               for r in kept)
    assert [h for _, h in p.get_step_res()] == p.last_h.tolist()
    # a call whose results were never read is replaced all the same
    p.propagate_until(60.0, max_steps=3)
    p.propagate_until(61.0, max_steps=2)
    assert [r[3] for r in p.get_propagate_res()] == [2] * B
    # step(): its own step results, the propagation's results kept
    p.step()
    step = p.get_step_res()
    assert all(o == ht.TaylorOutcome.success for o, _ in step)
    assert [h for _, h in step] == p.last_h.tolist()
    assert [r[3] for r in p.get_propagate_res()] == [2] * B


def test_scalar_results_keep_their_types():
    ta = ht.taylor_adaptive(hh_sys(ht), HH, tol=TOL, device="cpu")
    oc, mn, mx, ns = ta.propagate_until(5.0)
    assert type(oc) is ht.TaylorOutcome and oc == ht.TaylorOutcome.time_limit
    assert type(mn) is float and type(mx) is float and type(ns) is int
    oc, h = ta.step()
    assert type(oc) is ht.TaylorOutcome and type(h) is float


def test_f32_results_keep_their_dtype():
    st = lanes().astype(np.float32)
    p = ht.taylor_adaptive_batch(hh_sys(ht), st, device="cpu",
                                 dtype=np.float32)
    oc, mn, mx, ns = p.propagate_until(np.float32(1.0))
    assert mn.dtype == mx.dtype == np.float32 and ns.dtype == np.int64
    res = p.get_propagate_res()
    assert [r[1] for r in res] == mn.tolist()
    assert all(type(r[1]) is float and type(r[3]) is int for r in res)

