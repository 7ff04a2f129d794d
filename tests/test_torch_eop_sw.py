"""The port's Earth-orientation and space-weather data (``eop_sw.py``,
``models/{eop,sw,dayfrac}.py``) against the JAX package's, on the CPU in
f64: the data copies, the dataset keys, op names and interpolation
arrays, the order-0 rules of the interpolants, their slopes and
``dayfrac``, the parsers, the plan arrays; then a small ODE over every
kind of data-driven op (``tools/cases.py`` ``eop_ode_sys``) through the
port's batch on kernel B4's twin against the JAX batch, and the twin's
jet against the JAX jet.  Kernel B4 itself is held against its twin on
that tape in tests/test_torch_gpu.py and on the full ``eo_dynamics`` in
chip_smoke.py phase 25."""

import importlib
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu import eop_sw as JE
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.taylor.compact import build_plan as j_build_plan
from heyoka_tpu.taylor.jet import make_jet_fn

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import convert
from heyoka_tpu_torch import eop_sw as PE
from heyoka_tpu_torch.data import data_path
from heyoka_tpu_torch.expr import numeric
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools import roofline as rl
from heyoka_tpu_torch.tools.cases import eop_ode_sys

#: the modules (``models.dayfrac`` is the function of the same name)
j_dayfrac_mod = importlib.import_module("heyoka_tpu.models.dayfrac")
p_dayfrac_mod = importlib.import_module("heyoka_tpu_torch.models.dayfrac")

F64 = torch.float64
#: the order-0 rules: 1e-15 relative, 1e-15 absolute for the angles
RTOL = 1e-15
#: the small ODE through the batches, and the jets
ODE_RTOL = 1e-12
JET_RTOL = 1e-13
K = 12
#: 2015-01-01 in TT days since J2000, and the days the ODE runs
T0_DAYS = 5478.0
SPAN_DAYS = 3.0
MAX_DT = 0.02  # days: tests/test_eop_sw.py's cap, in the ODE's unit


@pytest.fixture(scope="module")
def data():
    """The builtin datasets of both packages, prepared."""
    pe, ps = PE.EOPData(), PE.SWData()
    je, js = JE.EOPData(), JE.SWData()
    for d in (pe, ps):
        PE._prepare(d)
    for d in (je, js):
        JE._prepare(d)
    return dict(eop=(pe, je), sw=(ps, js))


# -- the data and the tables ---------------------------------------------------

@pytest.mark.parametrize("name", ["eop_builtin.npz", "sw_builtin.npz"])
def test_data_copies_are_byte_identical(name):
    from importlib import resources

    ref = resources.files("heyoka_tpu.data").joinpath(name).read_bytes()
    assert data_path(name).read_bytes() == ref


@pytest.mark.parametrize("kind", ["eop", "sw"])
def test_keys_names_and_arrays_match_jax(data, kind):
    p, j = data[kind]
    assert p.data_key == j.data_key and repr(p) == repr(j)
    assert p.identifier == j.identifier and p.timestamp == j.timestamp
    np.testing.assert_array_equal(p.table, j.table)
    ap, aj = PE._STORE[p.data_key], JE._STORE[j.data_key]
    assert ap.keys() == aj.keys()
    assert ap["date"].tobytes() == aj["date"].tobytes()
    for qty in (q for q in ap if q != "date"):
        assert ap[qty].keys() == aj[qty].keys()
        for k, v in ap[qty].items():
            if k == "angular":
                assert v == aj[qty][k]
            else:  # the 50-digit node values and slopes, bit for bit
                assert v.tobytes() == aj[qty][k].tobytes(), (qty, k)
        for deriv in (False, True):
            name = PE._op_name(p.data_key, qty, deriv)
            assert name == JE._op_name(j.data_key, qty, deriv)
            assert PE.parse_op(name) == (p.data_key, qty, deriv)
            assert convert.op_kind(name) == ("interp_p" if deriv
                                             else "interp")
    # a model's expression names the same op
    f = {"eop": "pm_x", "sw": "f107"}[kind]
    assert repr(getattr(ht.models, f)()) == repr(getattr(hy.models, f)())
    with pytest.raises(ValueError, match="increasing"):
        type(p)(np.zeros((3, p.table.shape[1])))


def test_eop_data_equality_and_custom_tables(data):
    p, _ = data["eop"]
    assert ht.eop_data() == p and hash(ht.eop_data()) == hash(p)
    custom = ht.EOPData(p.table[:100], identifier="cut")
    assert custom.data_key == JE.EOPData(p.table[:100],
                                         identifier="cut").data_key
    assert custom != p and PE.parse_op("x%eop:y") is None
    assert PE.parse_op("pm_z%eop:a@b") is None and not PE.is_interp("sin")


# -- the order-0 rules -----------------------------------------------------------

def _epochs(dates, n, seed):
    """``n`` TT-century epochs uniform over a table's range plus 1% on
    each side, with 64 of the nodes and both ends exactly."""
    rng = np.random.default_rng(seed)
    lo, hi = dates[0], dates[-1]
    pad = 0.01 * (hi - lo)
    u = rng.uniform(lo - pad, hi + pad, n - 66)
    return np.concatenate([u, dates[rng.choice(dates.size, 64)],
                           [lo, hi]])


def _close(got, want, angular):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    err = np.abs(got[~nan] - want[~nan])
    lim = RTOL if angular else RTOL * np.abs(want[~nan])
    assert (err <= lim).all(), float((err / np.maximum(lim, 1e-300)).max())


@pytest.mark.parametrize("kind,qty", [
    ("eop", "pm_x"), ("eop", "pm_y"), ("eop", "dX"), ("eop", "dY"),
    ("eop", "era"), ("eop", "gmst82"), ("sw", "Ap_avg"), ("sw", "f107"),
    ("sw", "f107a_center81")])
def test_value_and_slope_match_jax_rule(data, kind, qty):
    p, _ = data[kind]
    key = p.data_key
    u = _epochs(PE._STORE[key]["date"], 4096, sum(map(ord, qty)))
    ut = torch.as_tensor(u)
    v, s = PE.interp0(PE._op_name(key, qty, False), ut)
    angular = PE._STORE[key][qty]["angular"]
    for deriv, got in ((False, v), (True, s)):
        want = np.asarray(JE._interp_rule(key, qty, deriv)(jnp.asarray(u)))
        _close(got.numpy(), want, angular and not deriv)
        # the op's numeric rule is the same function
        name = PE._op_name(key, qty, deriv)
        torch.testing.assert_close(numeric.evaluate(name, ut), got,
                                   rtol=0, atol=0, equal_nan=True)
    if angular:
        ok = ~torch.isnan(v)
        assert bool(((v[ok] >= 0) & (v[ok] < 2 * math.pi)).all())


def test_interp_on_a_scalar_and_a_matrix(data):
    key = data["eop"][0].data_key
    name = PE._op_name(key, "era", False)
    u = torch.tensor([[0.1, 0.15], [0.2, 5.0]], dtype=F64)
    got = PE.evaluate(name, u)
    assert got.shape == (2, 2) and bool(torch.isnan(got[1, 1]))
    assert float(PE.evaluate(name, u[0, 0])) == float(got[0, 0])


def _dayfrac_times():
    """TT days since J2000 about every Jan 1 1973-2030 and about every
    leap-second date of the table (the midnights before the changes), at
    +-1e-3 days, +-1 s, and the midnight itself."""
    from heyoka_tpu_torch.utils.timeconv import _LEAP_TABLE, cal_to_jd

    tt_mjd_j2000 = 51544.5
    marks = [cal_to_jd(y, 1, 1) - 2400000.5 for y in range(1973, 2031)]
    marks += [cal_to_jd(y, m, 1) - 2400000.5 for y, m, _ in _LEAP_TABLE]
    out = []
    for mjd in marks:
        base = mjd - tt_mjd_j2000
        out += [base + d for d in (-1e-3, -1 / 86400, 0.0, 1 / 86400,
                                   1e-3, 0.25, 0.5)]
    rng = np.random.default_rng(3)
    out += list(rng.uniform(-9000, 11000, 256))
    return np.array(out)


def test_dayfrac_matches_jax():
    # year ends and leap-second dates, in TT days since J2000: 1e-12 days
    t = _dayfrac_times()
    got = p_dayfrac_mod.ev_dayfrac(torch.as_tensor(t)).numpy()
    want = np.asarray(j_dayfrac_mod._ev_dayfrac(jnp.asarray(t)))
    assert np.abs(got - want).max() <= 1e-12
    assert (got >= 0).all() and (got < 367).all()
    nan = p_dayfrac_mod.ev_dayfrac(torch.tensor([math.nan], dtype=F64))
    assert bool(torch.isnan(nan).all())
    np.testing.assert_array_equal(p_dayfrac_mod._LEAP_MJD,
                                  j_dayfrac_mod._LEAP_MJD)


def test_cfunc_of_the_models_matches_jax(data):
    # every model function of eop.py and sw.py and dayfrac as cfunc
    # outputs at epochs across both tables, one of them out of range
    names = ("era erap gmst82 gmst82p pm_x pm_xp pm_y pm_yp dX dXp dY dYp "
             "Ap_avg Ap_avgp f107 f107p f107a_center81 "
             "f107a_center81p").split()
    fp = [getattr(ht.models, n)() for n in names] + [
        ht.models.dayfrac(time_expr=ht.time * 36525.0)]
    fj = [getattr(hy.models, n)() for n in names] + [
        hy.models.dayfrac(time_expr=hy.time * 36525.0)]
    times = np.array([-0.25, -0.01, 0.0, 0.1537, 0.21, 0.26, 3.0])
    got = ht.make_cfunc(fp, vars=[], device="cpu")(
        np.zeros((times.size, 0)), time=times).numpy()
    want = np.asarray(hy.make_cfunc(fj, vars=[])(
        np.zeros((times.size, 0)), time=times))
    ang = np.array([n in ("era", "gmst82") for n in names] + [False])
    for c in range(len(fp)):
        _close(got[:, c], want[:, c], ang[c])
    assert np.isnan(got[-1, :-1]).all()


# -- the parsers ------------------------------------------------------------------

def _finals_line(mjd, pmx, pmy, dut1, dx, dy):
    ln = [" "] * 190

    def put(s_, a, b):
        ln[a:b] = list(s_.rjust(b - a))
    put(mjd, 7, 15)
    put(pmx, 18, 27)
    put(pmy, 37, 46)
    put(dut1, 58, 68)
    if dx is not None:
        put(dx, 97, 106)
        put(dy, 116, 125)
    return "".join(ln)


_PARSE_TEXT = {
    "parse_eop_finals2000A": "\n".join([
        _finals_line("55871.00", "0.147495", "0.294028", "-0.3429995",
                     "-85.228", "-8.417"),
        "short line",
        _finals_line("55872.00", "0.145883", "0.293760", "-0.3438441",
                     None, None),
        _finals_line("garbage!", "0.1", "0.2", "0.3", "1", "2")]),
    "parse_eop_iers_csv": (
        "MJD;UT1-UTC;x_pole;y_pole;dX;dY\n"
        "55871;-0.3429995;0.147495;0.294028;-0.085;-0.008\n"
        "55872;-0.3438441;0.145883;0.293760;;\n"
        "bad;row;x;y;;\n"),
    "parse_eop_celestrak_csv": (
        "DATE,MJD,X,Y,UT1-UTC,LOD,DPSI,DEPS,DX,DY,DAT,DATA_TYPE\n"
        "2011-11-08,55873,0.143943,0.293398,-0.3446213,0.0007,-0.1,-0.01,"
        "-0.000128,-0.000012,34,O\n"
        "2011-11-09,55874,0.141811,0.293195,-0.3453127,0.0006,,,,,34,O\n"),
    "parse_sw_celestrak_csv": (
        "DATE,AP_AVG,F10.7_OBS,F10.7_OBS_CENTER81\n"
        "2003-10-29,204,279.1,170.5\n"
        "2003-10-30,191,271.4,171.0\n"
        "2003-10-31,,,\n"),
}


@pytest.mark.parametrize("fn", sorted(_PARSE_TEXT))
def test_parsers_match_jax(fn):
    text = _PARSE_TEXT[fn]
    got = getattr(PE, fn)(text)
    want = getattr(JE, fn)(text)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.shape[0] == 2
    with pytest.raises(ValueError, match="no parsable rows"):
        getattr(PE, fn)("nothing here\n")


def test_sw_parser_takes_mjd_or_date():
    with_mjd = "MJD,AP_AVG,F10.7_OBS,F10.7_OBS_CENTER81\n52941,204,279.1,170.5\n"
    got = PE.parse_sw_celestrak_csv(with_mjd)
    assert got[0, 0] == 52941.0
    assert PE._date_to_mjd("2003-10-29") == JE._date_to_mjd("2003-10-29")


# -- the plan arrays -----------------------------------------------------------------

def test_plan_arrays_carry_the_op_names(data):
    plan = build_plan(ht.taylor_decompose_sys(eop_ode_sys(ht)), 9)
    a = ht.plan_to_arrays(plan)
    names = [str(n) for n in a["itp_names"]]
    qty = sorted(PE.parse_op(n)[1] + ("_p" if PE.parse_op(n)[2] else "")
                 for n in names)
    assert qty == ["era", "f107", "pm_x", "pm_x_p"]
    assert (a["itp"] >= 0).sum() == 4
    ops = [op for op, _ in rl.op_columns(a)]
    assert ops.count("interp") == 3 and ops.count("interp_p") == 1
    assert ops.count("dayfrac") == 1
    # the JAX plan flattens to the same arrays
    ja = ht.plan_to_arrays(j_build_plan(j_decompose(eop_ode_sys(hy)), 9))
    for k in a:
        np.testing.assert_array_equal(ja[k], a[k], err_msg=k)
    # a fresh process: the store lacks the builtin datasets, which
    # plan_from_arrays prepares again under the same key
    saved = dict(PE._STORE)
    PE._STORE.clear()
    try:
        back = ht.plan_from_arrays(a)
        assert set(PE._STORE) == set(saved)
    finally:
        PE._STORE.clear()
        PE._STORE.update(saved)
    again = ht.plan_to_arrays(back)
    for k in a:
        np.testing.assert_array_equal(again[k], a[k], err_msg=k)
    # a custom dataset must be in the store
    custom = ht.EOPData(data["eop"][0].table[:50], identifier="cut")
    cp = ht.plan_to_arrays(build_plan(ht.taylor_decompose_sys(
        [(ht.make_vars("x"), ht.models.pm_x(eop_data=custom))]), 3))
    key = custom.data_key
    kept = PE._STORE.pop(key)
    try:
        with pytest.raises(KeyError, match="not in the port's store"):
            ht.plan_from_arrays(cp)
    finally:
        PE._STORE[key] = kept
    # B1/B2/B3 have no rule for them
    with pytest.raises(convert.UnsupportedKernelOp):
        convert.check_supported(plan)


def test_side_rows_and_the_bound():
    # the slope rows follow the series rows; one multiply an order for an
    # interpolant, none for its slope or dayfrac; B4 reads each slope once
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(eop_ode_sys(ht)), K)), "cpu")
    assert (tape.n_ser, tape.n_slope, tape.n_side) == (0, 3, 3)
    side = jp.side_rows(tape.arrays)
    cop = jp.op_codes(tape.arrays)
    itp = cop == ht.OPCODES.index("interp")
    assert sorted(side[itp]) == [0, 1, 2] and (side[~itp] == -1).all()
    a = tape.arrays
    ops = [op for op, _ in rl.op_columns(a)]
    for op, n in (("interp", 1), ("interp_p", 0), ("dayfrac", 0)):
        assert all(rl._ORDER_K[op](k, 1) == n for k in range(1, K + 1))
    base = {op: ops.count(op) for op in set(ops)}
    W, n_eq = int(a["meta"][0]), int(a["meta"][1])
    n_w = n_eq + len(ops)
    assert rl.phase_bytes(a, 10, 1, 8) == 8 * 10 * (
        W * (K + 1) + n_w * K + base["interp"])
    fl = rl.phase_flops(a, 1)
    without = sum(rl._ORDER_K[op](k, n) for k in range(1, K + 1)
                  for op, n in rl.op_columns(a)
                  if op not in ("interp", "interp_p", "dayfrac"))
    assert fl == n_eq * K + without + 3 * K


# -- the slice: the small ODE through both batches -------------------------------------

@pytest.fixture(scope="module")
def small_runs(data):
    """Both batches on 3 lanes starting 2015-01-01 + 0, 0.3, 0.7 days and a
    fourth one day before the SW table ends (it runs out of range), for 3
    days at tol 1e-15 with ``max_delta_t`` 0.02 days."""
    end = min(data["eop"][0].table[-1, 0], data["sw"][0].table[-1, 0])
    times = np.array([T0_DAYS, T0_DAYS + 0.3, T0_DAYS + 0.7,
                      end - 51544.5 - 1.0])
    st = np.zeros((4, 2))
    tp = ht.taylor_adaptive_batch(eop_ode_sys(ht), st, time=times,
                                  tol=1e-15, device="cpu")
    rp = tp.propagate_for(SPAN_DAYS, max_delta_t=MAX_DT)
    tj = hy.taylor_adaptive_batch(eop_ode_sys(hy), st, time=times,
                                  tol=1e-15)
    rj = tj.propagate_for(SPAN_DAYS, max_delta_t=MAX_DT)
    return tp, rp, tj, rj


def test_small_ode_batch_matches_jax(small_runs):
    tp, rp, tj, rj = small_runs
    tp.assert_engine(jet="phase_plain", propagate_engine="flat")
    assert [int(o) for o in rp[0]] == [int(o) for o in rj[0]]
    assert [o.name for o in rp[0]] == ["time_limit"] * 3 + ["err_nf_state"]
    np.testing.assert_array_equal(np.asarray(rp[3]), np.asarray(rj[3]))
    sp, sj = tp.state[:3], np.asarray(tj.state)[:3]
    assert (np.abs(sp - sj) <= ODE_RTOL * np.abs(sj).max(0)).all()
    assert np.isnan(tp.state[3]).all() and np.isnan(np.asarray(tj.state)[3]).all()
    np.testing.assert_array_equal(tp.time[:3], np.asarray(tj.time)[:3])


def _jax_jet(tape_j, st, t):
    jo = make_jet_fn(tape_j, K)
    return np.stack([np.asarray(jo(jnp.asarray(s), jnp.zeros(0),
                                   jnp.asarray(tt)))
                     for s, tt in zip(st, t)], -1)


@pytest.mark.parametrize("lo", [1, 5])
def test_twin_jet_matches_jax_jet(lo):
    # the twin's interp, interp_p and dayfrac rules at every order, from
    # lo = 1 and from lo = 5 on a buffer whose lower orders came from it
    rng = np.random.default_rng(9)
    st = rng.uniform(-1, 1, (5, 2))
    t = T0_DAYS + rng.uniform(0, 400, 5)
    want = _jax_jet(j_decompose(eop_ode_sys(hy)), st, t)  # (K+1, 2, B)
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(eop_ode_sys(ht)), K)), "cpu")
    from chip_smoke import seeded_buffer

    tc = seeded_buffer(tape, st, np.zeros((5, 0)), t, "cpu")
    side = jp.order0(tape, tc)
    if lo > 1:
        jp.phase_plain(tape, tc, 1, side)
        n_w = tape.n_eq + tape.arrays["arg_ptr"].size - 1
        tc[lo:, :n_w] = math.nan
    jp.phase_plain(tape, tc, lo, side)
    got = tc[:, :2].numpy()
    scale = np.abs(want).max(2, keepdims=True)
    assert (np.abs(got - want) <= JET_RTOL * np.abs(want)
            + 1e-15 * scale).all()
    # a slope row holds S = slope(u_0): an interpolant's order 1 is S u_1
    for name, s, m, cols, _, _, srows in tape.pgroups:
        if convert.op_kind(name) == "interp":
            u = tc[:, cols[0, 0]]
            assert torch.equal(tc[1, s], side[0, srows[0]] * u[1])
            _, slope = PE.interp0(name, u[0])
            assert torch.equal(side[0, srows[0]], slope)


def test_out_of_range_slope_is_nan_in_the_jet():
    # an interpolant's input past the table: its order 0 and S are NaN,
    # so the state's orders from 1 on are NaN too (the JAX outcome
    # err_nf_state follows, test_small_ode_batch_matches_jax)
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(eop_ode_sys(ht)), K)), "cpu")
    from chip_smoke import seeded_buffer

    tc = seeded_buffer(tape, np.zeros((2, 2)), np.zeros((2, 0)),
                       np.array([T0_DAYS, 40_000.0]), "cpu")
    side = jp.order0(tape, tc)
    jp.phase_plain(tape, tc, 1, side)
    assert bool(torch.isfinite(tc[:, :, 0]).all())
    assert float(tc[0, 0, 1]) == 0.0
    assert bool(torch.isnan(tc[1:, 0, 1]).all())


def test_batch_pickles_with_its_ops():
    # a batch on the data-driven ops round-trips through pickle (its plan
    # arrays carry the op names) and steps on equal to the original
    tb = ht.taylor_adaptive_batch(eop_ode_sys(ht), np.zeros((2, 2)),
                                  time=np.array([T0_DAYS, T0_DAYS + 1.0]),
                                  tol=1e-15, device="cpu")
    tb.step()
    tb2 = pickle.loads(pickle.dumps(tb))
    tb.step()
    tb2.step()
    np.testing.assert_array_equal(tb2.state, tb.state)
    np.testing.assert_array_equal(tb2.time, tb.time)
