"""The port's SGP4 (``models/sgp4.py``: the symbolic SGP4, a compiled
function over every (satellite, time) point, nested ``torch.func.jacfwd``
for the derivatives) on the CPU: every case of ``tests/test_sgp4.py``
(the Spacetrack Report #3 vectors, multi-satellite evaluation, deep-space
rejection, dates, finite differences, the dtens layout, TLE parsing and
the time scales), and the propagator against the JAX one on 8 seeded
satellites x 4 epochs at ``diff_order`` 0, 1 and 2: every output of
order 0 or 1 within 5e-14 of its largest magnitude over the points, the
second derivatives within 1e-12.  The bound is the last bits of the CPU
libraries (ROADMAP §C): XLA's and torch's ``pow`` of the un-Kozai 2/3
power differ by an ulp on ~2% of inputs, and an ulp of the mean motion
grows with the ~100 rad a satellite turns in a day, so the outputs differ
by ~1.4e-14 of their magnitude, the first derivatives by ~2.7e-14; the
mixed second derivatives in e0 and bstar cancel, and differ by up to
2.7e-13 of theirs.  The Kepler solve adds its own last bits (the port
freezes a converged lane, the JAX loop iterates it on)."""

import pickle

import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.models import SGP4Propagator as JaxSGP4

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.models import SGP4Propagator, gpe_is_deep_space, sgp4
from heyoka_tpu_torch.tools.cases import REPORT3, SGP4_TLE, sgp4_population
from heyoka_tpu_torch.utils.tle import parse_tle, parse_tle_file
from heyoka_tpu_torch.utils.timeconv import (
    cal_to_jd,
    jd_tai_to_utc,
    jd_to_cal,
    jd_utc_to_tai,
    tai_minus_utc,
)

L1, L2 = SGP4_TLE
#: the bound on the outputs of each derivative order against the JAX ones
JAX_RTOL = (5e-14, 5e-14, 1e-12)


def _prop(gpe, **kw):
    return SGP4Propagator(gpe, device="cpu", **kw)


@pytest.fixture(scope="module")
def prop():
    return _prop(parse_tle(L1, L2).reshape(9, 1))


def test_report3_vectors(prop):
    import test_sgp4
    np.testing.assert_array_equal(REPORT3, test_sgp4.REPORT3)
    assert (L1, L2) == (test_sgp4.L1, test_sgp4.L2)
    for row in REPORT3:
        out = prop(np.array([row[0]]))
        assert isinstance(out, torch.Tensor) and out.shape == (1, 7)
        out = out.numpy()
        np.testing.assert_allclose(out[0, :3], row[1:4], atol=2e-2)  # 20 m
        np.testing.assert_allclose(out[0, 3:6], row[4:7], atol=2e-5)
        assert out[0, 6] == 0.0  # no error


def test_multi_sat_multi_time():
    gpe = parse_tle(L1, L2)
    p = _prop(np.stack([gpe, gpe], axis=1))
    assert p.nsats == 2
    out = p(np.array([[0.0, 360.0], [360.0, 0.0]])).numpy()
    assert out.shape == (2, 2, 7)
    np.testing.assert_allclose(out[0, 0], out[1, 1], rtol=1e-12)
    np.testing.assert_allclose(out[0, 1], out[1, 0], rtol=1e-12)


def test_deep_space_rejected():
    gpe = parse_tle(L1, L2)
    gpe_ds = gpe.copy()
    gpe_ds[0] = 2.0 * np.pi / 1436.0  # geosynchronous: period ~ 1 day
    assert gpe_is_deep_space(gpe_ds[0], gpe_ds[1], gpe_ds[2])
    with pytest.raises(ValueError, match="deep-space"):
        _prop(gpe_ds.reshape(9, 1))
    p = _prop(gpe.reshape(9, 1))
    with pytest.raises(ValueError, match="deep-space"):
        p.replace_sat_data(gpe_ds.reshape(9, 1))


def test_dates_input(prop):
    gpe = parse_tle(L1, L2)
    out_t = prop(np.array([0.0]))
    out_d = prop(jd=np.array([gpe[7]]), frac=np.array([gpe[8]]))
    np.testing.assert_allclose(out_d.numpy(), out_t.numpy(), atol=1e-6)


def test_derivatives_vs_finite_differences():
    gpe = parse_tle(L1, L2)
    p1 = _prop(gpe.reshape(9, 1), diff_order=1)
    assert p1.nouts == 7 * (1 + 7)
    t = np.array([47.0])
    out = p1(t).numpy()
    b, e = p1.get_dslice(1)
    jac = out[0, b:e].reshape(7, 7)
    for j, eps in enumerate([1e-9, 1e-9, 1e-8, 1e-8, 1e-8, 1e-8, 1e-9]):
        gp = gpe.copy()
        gp[j] += eps
        gm = gpe.copy()
        gm[j] -= eps
        fd = (_prop(gp.reshape(9, 1))(t) - _prop(gm.reshape(9, 1))(t)) \
            .numpy() / (2 * eps)
        np.testing.assert_allclose(jac[:, j], fd[0, :7], rtol=2e-4,
                                   atol=1e-4)


def test_dslice_mindex():
    p1 = _prop(parse_tle(L1, L2).reshape(9, 1), diff_order=1)
    assert p1.get_dslice(0) == (0, 7)
    assert p1.get_dslice(1) == (7, 56)
    comp, counts = p1.get_mindex(0)
    assert comp == 0 and sum(counts) == 0
    comp, counts = p1.get_mindex(7)
    assert comp == 0 and sum(counts) == 1


def test_sgp4_symbolic_inputs():
    exprs = sgp4()
    assert len(exprs) == 7
    vs = set()
    for e in exprs:
        vs |= set(ht.get_variables(e))
    assert vs == {"n0", "e0", "i0", "node0", "omega0", "m0", "bstar",
                  "tsince"}
    # the same graph as the JAX package's (its repr, a tree, would take
    # gigabytes): the same decomposition, op by op
    names = sorted(vs)
    tp = ht.function_decompose(exprs, names)
    tj = hy.function_decompose(hy.models.sgp4(), names)
    assert repr(tp.ops) == repr(tj.ops) and len(tp.ops) > 300
    assert repr(tp.outputs) == repr(tj.outputs)


def test_parse_tle_file():
    arr = parse_tle_file(f"SAT 88888\n{L1}\n{L2}\n{L1}\n{L2}\n")
    assert arr.shape == (9, 2)
    np.testing.assert_array_equal(arr[:, 0], arr[:, 1])
    np.testing.assert_array_equal(arr, hy.utils.parse_tle_file(
        f"{L1}\n{L2}\n{L1}\n{L2}\n"))


def test_cal_jd_roundtrip():
    assert cal_to_jd(2000, 1, 1) == 2451544.5
    y, m, d, fd = jd_to_cal(2451545.0)
    assert (y, m, d, fd) == (2000, 1, 1, 0.5)


def test_tai_minus_utc_values():
    assert tai_minus_utc(cal_to_jd(2017, 1, 2)) == 37.0
    assert tai_minus_utc(cal_to_jd(2016, 12, 31)) == 36.0
    assert tai_minus_utc(cal_to_jd(1990, 6, 1)) == 25.0
    assert tai_minus_utc(cal_to_jd(1972, 1, 1)) == 10.0


def test_utc_tai_roundtrip():
    for jd in [2451545.0, 2457754.5, 2444239.5]:
        t1, t2 = jd_utc_to_tai(jd, 0.25)
        u1, u2 = jd_tai_to_utc(t1, t2)
        assert abs((u1 - jd) + (u2 - 0.25)) * 86400 < 1e-6


def test_leap_second_day():
    jd = cal_to_jd(2016, 12, 31)
    t1, t2 = jd_utc_to_tai(jd, 0.0)
    assert abs((t1 - jd + t2) * 86400 - 36.0) < 1e-6
    t1, t2 = jd_utc_to_tai(jd + 1.0, 0.0)
    assert abs((t1 - (jd + 1.0) + t2) * 86400 - 37.0) < 1e-6
    t1, t2 = jd_utc_to_tai(jd, 0.5)
    assert abs((t1 - jd + t2 - 0.5) * 86400 - 36.5) < 1e-6


# -- the port against the JAX propagator -------------------------------------


def _population():
    """8 satellites of ``sgp4_bench.py``'s population with the report's
    epoch, and (4, 8) epochs over a day."""
    g = sgp4_population(8)
    g[7:] = parse_tle(L1, L2)[7:, None]
    t = np.random.default_rng(4).uniform(0.0, 1440.0, (4, 8))
    return g, t


@pytest.mark.parametrize("order", [0, 1, 2])
def test_against_jax(order):
    g, t = _population()
    p = _prop(g, diff_order=order)
    j = JaxSGP4(g, diff_order=order)
    assert p.nouts == j.nouts and repr(p.diff_args) == repr(j.diff_args)
    assert [p.get_mindex(i) for i in range(p.nouts)] == \
        [j.get_mindex(i) for i in range(j.nouts)]
    for o in range(order + 1):
        assert p.get_dslice(o) == j.get_dslice(o)
    out, want = p(t).numpy(), np.asarray(j(t))
    assert out.shape == want.shape == (4, 8, p.nouts)
    scale = np.abs(want).reshape(-1, p.nouts).max(0)
    err = np.abs(out - want).reshape(-1, p.nouts).max(0)
    rtol = np.array([JAX_RTOL[sum(p.get_mindex(i)[1])]
                     for i in range(p.nouts)])
    assert (err <= rtol * scale).all(), (err / np.maximum(scale, 1e-300)).max()
    # one evaluation per satellite, and dates, the same as times
    np.testing.assert_array_equal(p(t[0]).numpy(), out[0])
    if order == 0:
        jd = np.broadcast_to(g[7], t.shape)
        fr = g[8] + t / 1440.0
        np.testing.assert_allclose(p(jd=jd, frac=fr).numpy(), out,
                                   rtol=0, atol=1e-7)


def test_pickle_replace_and_device():
    g, t = _population()
    p = _prop(g, diff_order=1)
    out = p(t)
    q = pickle.loads(pickle.dumps(p))
    assert q.diff_order == 1 and q.device == p.device
    np.testing.assert_array_equal(q.get_sat_data(), g)
    assert torch.equal(q(t), out)
    assert repr(q) == ("SGP4Propagator(nsats=8, nouts=56, diff_order=1, "
                       "dtype=float64, device=cpu)")
    # replacing the satellites keeps the compiled function
    g2 = g[:, ::-1].copy()
    p.replace_sat_data(g2)
    assert torch.equal(p(t[:, ::-1].copy()), out.flip(1))
    with pytest.raises(ValueError, match="shape"):
        p.replace_sat_data(g[:7])
    with pytest.raises(ValueError, match="times"):
        p(np.zeros((4, 3)))
    with pytest.raises(ValueError, match="float64 or float32"):
        _prop(g, dtype=np.float16)
    assert ht.models.sgp4_propagator(g, device="cpu").nsats == 8
