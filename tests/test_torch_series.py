"""The dense trig-series op of the port (``expr/series.py``; the jet,
kernel S1's plain twin and the affine input of ``taylor/series_jet.py``;
the series rows of the phase route, ``taylor/jet_phase.py``) against the
JAX package's, on the CPU in f64.  Kernel S1 itself is held against its
twin in tests/test_torch_gpu.py and in chip_smoke.py phase 24.

The JAX reference runs in full f64: its head/tail split puts an f32 tail
on every series of 256 terms or more by default, even on the CPU
(``heyoka_tpu/expr/series.py:76-80, 117-149``), so the module sets
``_FAST = False`` and drops the cached splits for its duration, as
tests/test_series_fast.py does for its oracle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.expr import series as JS
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.taylor.jet import make_jet_fn

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import convert
from heyoka_tpu_torch.expr import series as PS
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import series_jet as sj
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools import roofline as rl
from heyoka_tpu_torch.tools.cases import elp_sys, random_series

from chip_smoke import seeded_buffer

K = 12  # tests/test_series_op.py's jet order
F64 = torch.float64


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


def _abs_sum(name, u):
    """The sum of the terms' magnitudes at ``u`` (numpy (N,)): the scale
    an order-0 value is held to."""
    tab = sj.tables_on(name, "cpu")
    u = torch.as_tensor(np.asarray(u, np.float64))
    return sj.series_jet_plain(tab, u, torch.zeros_like(u), 0,
                               with_scale=True)[1][0].numpy()


# -- the op and its store ------------------------------------------------------

@pytest.mark.parametrize("q,d", [(0, 1), (2, 4), (1, 0)])
def test_keys_and_tables_match_jax(q, d):
    amp, ph = random_series(np.random.default_rng(10 * q + d), 7, q, d)
    fj = JS.trig_series(hy.time, amp, ph)
    fp = PS.trig_series(ht.time, amp, ph)
    assert fp.op == fj.op and PS.is_series(fp.op)
    a, p = PS.tables(fp.op)
    jd = JS._STORE[JS._key_for(amp, ph)]
    assert a.tobytes() == jd["amp"].tobytes()
    assert p.tobytes() == jd["ph"].tobytes()
    assert repr(fp) == repr(fj)
    # one entry per table pair: a second build reuses it
    assert PS.trig_series(ht.time, amp, ph).op == fp.op


def test_elp2000_tape_series_match_jax():
    # the complete theory: the same 9 ops, keys and tables as the JAX
    # tape's, 37,863 terms
    tp = ht.taylor_decompose_sys(elp_sys(ht, 0.0))
    tj = j_decompose(elp_sys(hy, 0.0))
    names = [op.op for op in tp.ops if PS.is_series(op.op)]
    assert names == [op.op for op in tj.ops if op.op.startswith(
        "trigseries%")]
    assert [op.inputs for op in tp.ops] == [op.inputs for op in tj.ops]
    assert tp.n_uvars == tj.n_uvars == 105
    n = [PS.tables(nm)[0].shape[0] for nm in names]
    assert n == [19, 1897, 7710, 13, 1036, 6634, 28, 4630, 15896]
    for nm in names:
        a, p = PS.tables(nm)
        assert a.tobytes() == JS._STORE[PS.key_of(nm)]["amp"].tobytes()
        assert p.tobytes() == JS._STORE[PS.key_of(nm)]["ph"].tobytes()


# -- evaluation (cfunc) --------------------------------------------------------

def _numpy_value(name, times):
    """The series at ``times`` in numpy f64: Horner phases, libm sin."""
    a, p = PS.tables(name)
    out = []
    for tv in times:
        ph = p[:, -1].copy()
        for j in range(p.shape[1] - 2, -1, -1):
            ph = ph * tv + p[:, j]
        am = a[:, -1].copy()
        for j in range(a.shape[1] - 2, -1, -1):
            am = am * tv + a[:, j]
        out.append(np.sum(am * np.sin(ph)))
    return np.array(out)


def test_cfunc_matches_jax_on_the_complete_elp2000_series():
    # every series op of the complete ELP2000 tape as a cfunc output, at
    # times across +-0.5 centuries (phases up to 4e4 rad): the port within
    # 1e-14 of the sum of the terms' magnitudes of numpy's f64 sum (the
    # two sum 10^4 terms in other orders), the JAX cfunc within 1e-12 of
    # the port: XLA's CPU sin reduces such phases less exactly (up to
    # 6.7e-13 of that scale from numpy's, measured; the port's 6.5e-16)
    tp = ht.taylor_decompose_sys(elp_sys(ht, 0.0))
    names = [op.op for op in tp.ops if PS.is_series(op.op)]
    fp = [PS.trig_series(ht.time, *PS.tables(nm)) for nm in names]
    fj = [JS.trig_series(hy.time, *PS.tables(nm)) for nm in names]
    times = np.linspace(-0.5, 0.5, 9)
    cp = ht.make_cfunc(fp, vars=[], device="cpu")
    cj = hy.make_cfunc(fj, vars=[])
    got = cp(np.zeros((times.size, 0)), time=times).numpy()
    want = np.asarray(cj(np.zeros((times.size, 0)), time=times))
    scale = np.stack([_abs_sum(nm, times) for nm in names], 1)
    ref = np.stack([_numpy_value(nm, times) for nm in names], 1)
    assert np.all(np.abs(got - ref) <= 1e-14 * scale)
    assert np.all(np.abs(got - want) <= 1e-12 * scale)


def test_cfunc_matches_jax_on_a_poisson_series():
    # polynomial amplitudes and a quartic phase, input t + par[0]
    amp, ph = random_series(np.random.default_rng(3), 300, 2, 4)
    fp = PS.trig_series(ht.time + ht.par[0], amp, ph)
    fj = JS.trig_series(hy.time + hy.par[0], amp, ph)
    rng = np.random.default_rng(4)
    times, pars = rng.uniform(-2, 2, 16), rng.uniform(-1, 1, (16, 1))
    got = ht.make_cfunc([fp], vars=[], device="cpu")(
        np.zeros((16, 0)), pars=pars, time=times).numpy()[:, 0]
    want = np.asarray(hy.make_cfunc([fj], vars=[])(
        np.zeros((16, 0)), pars=pars, time=times))[:, 0]
    scale = _abs_sum(fp.op, times + pars[:, 0])
    assert np.all(np.abs(got - want) <= 1e-13 * scale)


def test_twin_chunks_sum_alike(monkeypatch):
    # the twin walks the terms in chunks (no (B, n_terms) tensor): small
    # chunks give the same orders to 1e-14 of the terms' magnitudes
    amp, ph = random_series(np.random.default_rng(5), 1001, 1, 2)
    tab = sj.tables_on(PS.add(amp, ph), "cpu")
    u0 = torch.linspace(-1, 1, 33, dtype=F64)
    u1 = torch.full((33,), 0.7, dtype=F64)
    ref, scale = sj.series_jet_plain(tab, u0, u1, 9, with_scale=True)
    monkeypatch.setattr(sj, "CHUNK_ELEMS", 33 * 17)
    got = sj.series_jet_plain(tab, u0, u1, 9)
    assert bool(((got - ref).abs() <= 1e-14 * scale).all())
    assert bool((scale >= ref.abs()).all())


# -- the jet -------------------------------------------------------------------

def _jets(q, d, shifted, seed):
    """The port's jet (the phase twin with the series rows of the S1 twin)
    and ``make_jet_fn``'s on ``x' = f(u) + 0 x``, u = t or t + par[0],
    as (K+1,) arrays."""
    amp, ph = random_series(np.random.default_rng(seed), 5, q, d)
    xj, xp = hy.make_vars("x"), ht.make_vars("x")
    uj = hy.time + hy.par[0] if shifted else hy.time
    up = ht.time + ht.par[0] if shifted else ht.time
    fj = JS.trig_series(uj, amp, ph)
    fp = PS.trig_series(up, amp, ph)
    jo = make_jet_fn(j_decompose([(xj, fj + 0.0 * xj)]), K)
    want = np.asarray(jo(jnp.asarray([0.1]), jnp.asarray([0.31 * shifted]),
                         jnp.asarray(0.2)))[:, 0]
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys([(xp, fp + 0.0 * xp)]), K)), "cpu")
    pars = torch.tensor([[0.31]] if shifted else [[]], dtype=F64).reshape(
        tape.n_pars, 1)
    rows, _ = jp.jet_phase(tape, torch.tensor([[0.1]], dtype=F64), pars,
                           torch.tensor([0.2], dtype=F64))
    return rows[0, :, 0].numpy(), want


@pytest.mark.parametrize("q,d,shifted", [
    (0, 1, False), (2, 1, True), (0, 4, False), (2, 4, True)])
def test_twin_jet_matches_jax(q, d, shifted):
    # degree-1 and degree-4 phases, constant and quadratic amplitudes,
    # time and the par-shifted time (tests/test_series_op.py:45-84):
    # 1e-13 relative per order (the phases of p_0 round alike up to the
    # JAX jet's power sums)
    got, want = _jets(q, d, shifted, 7 + q + d)
    rel = np.abs(got - want) / np.abs(want).max()
    assert np.all(np.abs(got - want) <= 1e-13 * np.abs(want) + 1e-15
                  * np.abs(want).max()), rel


@pytest.mark.parametrize("u", ["t", "t+p0", "p1*t+p0", "2.5t-0.3"])
def test_u1_is_order_one_of_the_input_column(u):
    # the rate the series jet is given before B4 runs equals order 1 of
    # the input's column as the twin then computes it, bit for bit
    tm, par = ht.time, ht.par
    inp = {"t": tm, "t+p0": tm + par[0], "p1*t+p0": par[1] * tm + par[0],
           "2.5t-0.3": 2.5 * tm - 0.3}[u]
    amp, ph = random_series(np.random.default_rng(2), 4, 1, 2)
    x = ht.make_vars("x")
    sys_ = [(x, PS.trig_series(inp, amp, ph) - 0.1 * x)]
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(sys_), 9)), "cpu")
    B = 5
    rng = np.random.default_rng(1)
    pars = rng.uniform(0.5, 2.0, (B, tape.n_pars))
    tc = seeded_buffer(tape, rng.uniform(-1, 1, (B, 1)), pars,
                       rng.uniform(-1, 1, B), "cpu")
    ser = jp.order0(tape, tc)
    jp.phase_plain(tape, tc, 1, ser)
    (col, aff, _), = tape.series
    torch.testing.assert_close(aff.u1(tc), tc[1, aff.in_col], rtol=0,
                               atol=0)
    if u == "p1*t+p0":
        torch.testing.assert_close(aff.u1(tc), torch.as_tensor(pars[:, 1]),
                                   rtol=0, atol=0)
    assert torch.equal(tc[:, col], ser[:, 0])


@pytest.mark.parametrize("bad", ["t*t", "sin(t)", "x+t", "t/x"])
def test_an_input_not_affine_in_time_raises(bad):
    x, tm = ht.make_vars("x"), ht.time
    inp = {"t*t": tm * tm, "sin(t)": ht.sin(tm), "x+t": x + tm,
           "t/x": tm / x}[bad]
    amp, ph = random_series(np.random.default_rng(0), 3, 0, 1)
    sys_ = [(x, PS.trig_series(inp, amp, ph))]
    with pytest.raises(ValueError, match="affine in time"):
        ht.taylor_adaptive_batch(sys_, [[0.5]], device="cpu")


def test_diff_closure_matches_jax():
    # d/dt of a series is a sum of derived series (amplitude derivative,
    # cosine via +pi/2): against central differences and the JAX diff
    amp, ph = random_series(np.random.default_rng(6), 4, 2, 2)
    fp = PS.trig_series(ht.time, amp, ph)
    fj = JS.trig_series(hy.time, amp, ph)
    dp, dj = ht.diff(fp, ht.time), hy.diff(fj, hy.time)
    assert repr(dp) == repr(dj)
    cf = ht.make_cfunc([fp, dp], vars=[], device="cpu")
    cj = hy.make_cfunc([dj], vars=[])
    times = np.array([0.3, 1.1, -0.7])
    h = 1e-6
    got = cf(np.zeros((3, 0)), time=times).numpy()
    fd = (cf(np.zeros((3, 0)), time=times + h).numpy()[:, 0]
          - cf(np.zeros((3, 0)), time=times - h).numpy()[:, 0]) / (2 * h)
    np.testing.assert_allclose(got[:, 1], fd, rtol=1e-7)
    np.testing.assert_allclose(got[:, 1], np.asarray(cj(
        np.zeros((3, 0)), time=times))[:, 0], rtol=1e-13)


def test_affine_in_time_check():
    t, x = ht.time, ht.make_vars("x")
    tj, xj = hy.time, hy.make_vars("x")
    cases = [(t, tj, True),
             (2.0 * t + ht.par[0], 2.0 * tj + hy.par[0], True),
             (ht.par[1], hy.par[1], True), (t * t, tj * tj, False),
             (ht.sin(t), hy.sin(tj), False), (x + t, xj + tj, False)]
    for e, ej, want in cases:
        assert PS.affine_in_time(e) is want
        assert JS.affine_in_time(ej) is want
    with pytest.raises(ValueError):
        ht.models.elp2000_spherical(time_expr=t * t, series_op=True)


# -- the plan arrays -------------------------------------------------------------

def test_plan_arrays_carry_the_tables():
    # the arrays hold the series names and tables; plan_from_arrays puts a
    # missing table back into the store, under the same key
    plan = build_plan(ht.taylor_decompose_sys(elp_sys(ht, 1e-4)), 9)
    a = ht.plan_to_arrays(plan)
    assert all(isinstance(v, np.ndarray) for v in a.values())
    assert a["ser_names"].size == 3 and (a["ser"] >= 0).sum() == 3
    starts = a["g_start"] - int(a["meta"][1])
    assert {convert.OPCODES[op] for op, s0 in zip(a["g_op"], starts)
            if a["ser"][s0] >= 0} == {"trigseries"}
    name = str(a["ser_names"][0])
    saved = PS._STORE.pop(PS.key_of(name))
    try:
        back = ht.plan_from_arrays(a)
        got = PS._STORE[PS.key_of(name)]
        assert got["amp"].tobytes() == saved["amp"].tobytes()
        assert got["ph"].tobytes() == saved["ph"].tobytes()
    finally:
        PS._STORE[PS.key_of(name)] = saved
    again = ht.plan_to_arrays(back)
    assert a.keys() == again.keys()
    for k in a:
        np.testing.assert_array_equal(again[k], a[k], err_msg=k)
    # B1/B2/B3 have no series rule
    with pytest.raises(convert.UnsupportedKernelOp):
        convert.check_supported(plan)


# -- the bound of kernel S1 ------------------------------------------------------

def test_series_flops_count():
    # the complete ELP2000 tape at K = 19: about 350 operations a (lane,
    # term) by the recurrence (kernel S1-G's rule and the bound before the
    # class split); by the closed form (kernel S1-L) 4 on the FP64 units
    # and 2 (K+1) on the FP64 tensor cores a term, and the scale a lane
    per = rl.series_flops(37_863, 4, 0, 19) / 37_863
    assert 340 < per < 360
    lin = rl.series_lin_flops(35_228, 19)
    assert lin == {F64: 4 * 35_228 + 3 * 19, rl.TC_F64: 40 * 35_228}
    # the step's two entries: the tensor cores bound class L, the FP64
    # units class G; each bound the longest of its units' times
    b = rl.bound_by_type(lin, 0)
    assert b["bound_by"] == "operations" and b["flops"] == sum(lin.values())
    assert b["bound_ms"] == 1e3 * (40 * 35_228 / rl.PEAK_FLOPS[rl.TC_F64])
    assert rl.bound(7.0, 8.0, F64) == rl.bound_by_type({F64: 7.0}, 8.0)


@pytest.mark.parametrize("n,B,K,lin_items,gen_items", [
    (15_896, 10_240, 19, 7, 2),    # the complete ELP2000's largest op
    (19, 10_240, 19, 1, 1),        # its smallest: one item each
    (15_896, 256, 19, 249, 66),    # few lanes: items fill the card
    (37_863, 262_144, 0, 1, 1)])   # a cfunc's many points at order 0
def test_kernel_launch_shape(n, B, K, lin_items, gen_items):
    # kernel S1's grid: items of term chunks up to TARGET_BLOCKS blocks,
    # at least LIN_MIN_TILES tiles (S1-L) or GEN_MIN_TERMS terms (S1-G)
    # an item; the items cover the terms in order; shared memory within
    # a block's
    rng = np.random.default_rng(n)
    for q, d, want in ((0, 1, lin_items), (2, 4, gen_items)):
        tab = sj.tables_on(PS.add(*random_series(rng, n, q, d)), "cpu")
        work = sj.SeriesWork([tab], K)
        wl = work.items(B)
        items = wl.lin if q == 0 else wl.gen
        assert (wl.lin.shape[0], wl.gen.shape[0]) == (
            (want, 0) if q == 0 else (0, want))
        size = items[:, 2]
        unit = sj.LIN_TERMS if q == 0 else 1
        assert int(size.sum()) * unit >= n > (int(size.sum()) - 1) * unit
        assert np.all(size[:-1] == size[0]) and size[-1] <= size[0]
        assert np.array_equal(items[:, 6 if q else 3], np.arange(want))
    assert sj.lin_smem(sj.lin_row_tiles(K)) <= sj.SMEM_MAX
    assert 8 * (sj.gen_ring(sj.gen_row_doubles(7, 7)) + K + 1) \
        <= sj.SMEM_MAX
    with pytest.raises(ValueError, match="unknown class"):
        work.items(B, "all")
