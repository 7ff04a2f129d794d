"""The port's frame rotations (``models/frames.py``) and ``eo_dynamics``
against the JAX package's, on the CPU in f64: the decomposed tapes op by
op and the plans of ``build_plan``, the compiled right-hand side at
seeded states and epochs, the rotations' round trips, and the branches
that raise.  Low IAU2006 thresholds keep the JAX builds cheap (1e-2: a
few terms of each series); the full degree-10 tape with drag is checked
in the port alone (its counts), and run on the card in chip_smoke.py
phase 25."""

from collections import Counter

import numpy as np
import pytest

import heyoka_tpu as hy
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.taylor.compact import build_plan as j_build_plan

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import convert
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools.cases import eo_epoch, eo_lanes, eo_sys

THRESH = 1e-2
CF_RTOL = 1e-13
KW = dict(max_geo_degree=2, max_geo_order=2, Cb=0.02, iau2006_thresh=THRESH)


class _Systems(tuple):
    """The two packages' systems, with a short ``repr``: a failing test's
    long traceback prints its arguments, and the tree print of such a DAG
    takes gigabytes."""

    def __repr__(self):
        return f"eo_dynamics({KW}) in the port and the JAX package"


@pytest.fixture(scope="module")
def eo_small():
    """``eo_dynamics(max_geo_degree=2, max_geo_order=2, Cb=0.02,
    iau2006_thresh=1e-2)`` in both packages."""
    return _Systems((ht.models.eo_dynamics(**KW),
                     hy.models.eo_dynamics(**KW)))


def _same_tape(tp, tj):
    assert tp.n_eq == tj.n_eq and tp.n_uvars == tj.n_uvars
    assert [op.op for op in tp.ops] == [op.op for op in tj.ops]
    assert [op.inputs for op in tp.ops] == [op.inputs for op in tj.ops]
    assert tp.rhs == tj.rhs and tp.outputs == tj.outputs


def _sys_fns(sys_):
    return [rhs for _, rhs in sys_]


@pytest.mark.parametrize("rot", [
    "rot_itrs_icrs", "rot_icrs_itrs", "rot_itrs_teme", "rot_teme_itrs",
    "rot_fk5j2000_icrs", "rot_icrs_fk5j2000"])
def test_rotations_decompose_as_jax(rot):
    kw = {} if "fk5" in rot else dict(time_expr=ht.time)
    kwj = {} if "fk5" in rot else dict(time_expr=hy.time)
    if rot in ("rot_itrs_icrs", "rot_icrs_itrs"):
        kw["thresh"] = kwj["thresh"] = THRESH
    xp, xj = ht.make_vars("x", "y", "z"), hy.make_vars("x", "y", "z")
    fp = getattr(ht.models, rot)(list(xp), **kw)
    fj = getattr(hy.models, rot)(list(xj), **kwj)
    assert [repr(e) for e in fp] == [repr(e) for e in fj]
    _same_tape(ht.function_decompose(fp, ["x", "y", "z"]),
               hy.function_decompose(fj, ["x", "y", "z"]))


@pytest.mark.parametrize("fn", ["state_to_rsw", "state_to_rsw_inertial",
                                "state_from_rsw", "state_from_rsw_inertial"])
def test_rsw_helpers_decompose_as_jax(fn):
    names = ["px", "py", "pz", "wx", "wy", "wz", "rx", "ry", "rz", "vx",
             "vy", "vz"]
    vp, vj = ht.make_vars(*names), hy.make_vars(*names)
    op_ = getattr(ht.models, fn)(vp[0:3], vp[3:6], vp[6:9], vp[9:12])
    oj = getattr(hy.models, fn)(vj[0:3], vj[3:6], vj[6:9], vj[9:12])
    _same_tape(ht.function_decompose(op_[0] + op_[1], names),
               hy.function_decompose(oj[0] + oj[1], names))


def test_rotation_round_trips():
    # ITRS -> ICRS -> ITRS and ITRS -> TEME -> ITRS are the identity
    # (1e-13 of |r|) at epochs across the EOP table, through the port's cfunc
    x = ht.make_vars("x", "y", "z")
    tcy = ht.time
    there = ht.models.rot_itrs_icrs(list(x), time_expr=tcy, thresh=THRESH)
    back = ht.models.rot_icrs_itrs(there, time_expr=tcy, thresh=THRESH)
    teme = ht.models.rot_teme_itrs(ht.models.rot_itrs_teme(
        list(x), time_expr=tcy), time_expr=tcy)
    cf = ht.make_cfunc(back + teme, vars=["x", "y", "z"], device="cpu")
    rng = np.random.default_rng(2)
    r = rng.uniform(-7000, 7000, (16, 3))
    t = rng.uniform(-0.2, 0.25, 16)
    out = cf(r, time=t).numpy()
    for i in (0, 3):
        assert np.abs(out[:, i:i + 3] - r).max() <= 1e-13 * np.abs(r).max()
    # the rotation moves the point (the frames differ by the Earth's spin)
    moved = ht.make_cfunc(there, vars=["x", "y", "z"], device="cpu")(
        r, time=t).numpy()
    assert np.abs(moved - r).max() > 1.0


def test_eo_dynamics_tape_and_plan_match_jax(eo_small):
    sp, sj = eo_small
    assert [repr(v) for v, _ in sp] == [repr(v) for v, _ in sj]
    tp, tj = ht.taylor_decompose_sys(sp), j_decompose(sj)
    _same_tape(tp, tj)
    a = ht.plan_to_arrays(build_plan(tp, 19))
    aj = ht.plan_to_arrays(j_build_plan(tj, 19))
    assert a.keys() == aj.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], aj[k], err_msg=k)
    kinds = Counter(convert.op_kind(op.op) for op in tp.ops)
    assert kinds["interp"] == 8 and kinds["interp_p"] == 5
    assert kinds["dayfrac"] == 1


def test_eo_dynamics_cfunc_matches_jax(eo_small):
    # the right-hand side at 8 seeded states (100 km and 0.1 km/s about
    # the LEO lanes) and epochs within 58 days of 2015-06-10: the
    # velocity and the acceleration within 1e-13 of each lane's |v| and
    # |a| (a component near zero keeps the rotations' last bits)
    sp, sj = eo_small
    names = ["x", "y", "z", "vx", "vy", "vz"]
    cp = ht.make_cfunc(_sys_fns(sp), vars=names, device="cpu")
    cj = hy.make_cfunc(_sys_fns(sj), vars=names)
    rng = np.random.default_rng(5)
    st, _, t0 = eo_lanes(ht, 8)
    st = st + np.array([100.0] * 3 + [0.1] * 3) * rng.uniform(-1, 1,
                                                              st.shape)
    t = t0 + rng.uniform(-5e6, 5e6, 8)
    got = cp(st, time=t).numpy()
    want = np.asarray(cj(st, time=t))
    assert np.isfinite(got).all()
    for c in (slice(0, 3), slice(3, 6)):
        scale = np.linalg.norm(want[:, c], axis=1)[:, None]
        err = np.abs(got[:, c] - want[:, c]) / scale
        assert float(err.max()) <= CF_RTOL, float(err.max())


def test_eo_dynamics_raises_as_jax():
    with pytest.raises(ValueError, match="must both"):
        ht.models.eo_dynamics(elp2000_thresh=1e-6)
    # the third-body branch needs VSOP2013's planet 3, which neither
    # package ships
    with pytest.raises(Exception) as ep:
        ht.models.eo_dynamics(elp2000_thresh=1e-2, vsop2013_thresh=1e-2)
    with pytest.raises(Exception) as ej:
        hy.models.eo_dynamics(elp2000_thresh=1e-2, vsop2013_thresh=1e-2)
    assert type(ep.value) is type(ej.value)
    assert str(ep.value) == str(ej.value)


def test_full_eo_tape_counts():
    # phase 25's system (degree 10, drag, the default IAU2006 threshold):
    # its tape op by op equals the JAX package's (checked once on the
    # CPU; the JAX build takes ~9 s), so the port's counts are the JAX
    # tape's: 5,147 ops, 4,334 of them mul and 645 sum
    tape = ht.taylor_decompose_sys(eo_sys(ht, 10, True))
    c = Counter(convert.op_kind(op.op) for op in tape.ops)
    assert len(tape.ops) == 5147 and tape.n_eq == 6
    assert dict(c) == dict(mul=4334, sum=645, tanh=76, sin=21, cos=21,
                           div=19, sqrt=7, atan=5, exp=4, atan2=1,
                           interp=8, interp_p=5, dayfrac=1)
    # the epoch: 2015-06-10 00:00 UTC in TT seconds since J2000
    assert eo_epoch(ht) == eo_epoch(hy)
    assert abs(eo_epoch(ht) / 86400.0 - 5638.5) < 0.01
