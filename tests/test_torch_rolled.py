"""The huge-tape path of the port — the copied mascon / fixed-centres /
rotating models, the row-class partition, the rolled jet (kernel B3's
plain twin) and the routing that sends a wide tape to it — against the
JAX package, on the CPU in f64.  The kernel itself is held against its
twin in tests/test_torch_gpu.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.taylor import pallas_phase as pp
from heyoka_tpu.taylor.compact import build_plan as j_build_plan
from heyoka_tpu.taylor.compact_flat import jit_flat_step, make_batched_step_flat

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.expr.decompose import taylor_decompose_sys as p_decompose
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.taylor import compact as pcompact
from heyoka_tpu_torch.taylor import compact_flat as pcf
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor import rows
from heyoka_tpu_torch.taylor.compact import build_plan as p_build_plan

NBODY3_BASE = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                        0, 1.5, 0, -0.8, 0, 0], float)


def _mascon_kw(N, seed):
    """``mascon_bench.py``'s body: N mascons in the unit ball, total mass 1
    (``tests/test_pallas_rolled.py`` uses seed 7 at N = 12)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (4 * N, 3))
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0][:N]
    masses = rng.uniform(0.5, 1.0, N)
    masses /= masses.sum()
    return dict(Gconst=1.0, masses=masses.tolist(), positions=pts.tolist())


def _centres_kw():
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1, 1, (10, 3))
    masses = rng.uniform(0.1, 1.0, 10)
    return dict(Gconst=1.0, masses=masses.tolist(), positions=pos.tolist())


def _mascon12(m):
    return m.models.mascon(omega=(0.0, 0.0, 0.3), **_mascon_kw(12, 7))


def _fixed_centres10(m):
    return m.models.fixed_centres(**_centres_kw())


def _nbody3(m):
    return m.models.nbody(3, masses=[1.0, 1e-3, 2e-3])


def _handbuilt(m, mixed=False):
    x, y, z = m.make_vars("x", "y", "z")
    zr = (x * x + z * z + 2.0) ** -1.5 - m.par[1] * z
    if mixed:
        # a second exponent at the level of the ** -1.5: one pow group
        # holding both
        zr = zr + 0.01 * (x * x + y * y + 1.0) ** 2.5
    return [
        (x, m.par[0] * y / (1.0 + x * x) + m.sqrt(1.5 + y * y)),
        (y, -x / m.sqrt(x * x + y * y + 0.3) + 0.1 * m.time_ * z),
        (z, zr),
    ]


CASES = {
    "mascon12": _mascon12,
    "fixed_centres10": _fixed_centres10,
    "nbody3": _nbody3,
    "handbuilt": _handbuilt,
    "handbuilt_mixed": lambda m: _handbuilt(m, mixed=True),
}


def _orbit_states(B, seed=3, r=2.0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, B)
    st = np.zeros((B, 6))
    st[:, 0] = r * np.cos(ang)
    st[:, 1] = r * np.sin(ang)
    st[:, 3] = -0.7 * np.sin(ang) * np.sqrt(2.0 / r)
    st[:, 4] = 0.7 * np.cos(ang) * np.sqrt(2.0 / r)
    return st


def _inputs(name, B, seed=0):
    rng = np.random.default_rng(seed)
    if name == "mascon12":
        return _orbit_states(B, seed), np.zeros((B, 0)), np.zeros(B)
    if name == "fixed_centres10":
        return _orbit_states(B, seed, r=3.0), np.zeros((B, 0)), np.zeros(B)
    if name == "nbody3":
        st = NBODY3_BASE[None] + 0.01 * rng.standard_normal((B, 18))
        return st, np.zeros((B, 0)), np.zeros(B)
    st = rng.uniform(-1.0, 1.0, (B, 3))
    return st, rng.uniform(0.5, 1.5, (B, 2)), rng.uniform(0.0, 2.0, B)


def _p_plan(name, order):
    return p_build_plan(p_decompose(CASES[name](ht)), order)


def _rolled_tape(name, order):
    return jr.RolledTape(ht.plan_to_arrays(_p_plan(name, order)), "cpu")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float64))


def _per_order_rel(a, b, axes=(0, 2)):
    """max |a - b| per order, relative to that order's max |b| (the
    order axis is the one not in ``axes``)."""
    scale = np.abs(b).max(axis=axes)
    return np.abs(a - b).max(axis=axes) / np.where(scale > 0, scale, 1.0)


def _fields(obj):
    """A comparable form of a plan (either package), field by field."""
    if isinstance(obj, np.ndarray):
        return (obj.dtype.kind, obj.tolist())
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fields(v) for v in obj]
    if isinstance(obj, tuple) and len(obj) == 3 and hasattr(obj[0], "op"):
        op, u, cols = obj  # a group's (tape op, out column, in columns)
        return ((op.op, op.inputs, op.meta), u, cols)
    if dataclasses.is_dataclass(obj):
        return [(f.name, _fields(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)]
    return obj


# -- the copied models --------------------------------------------------------

MODELS = {
    "mascon": (lambda m: m.models.mascon,
               lambda m: m.models.mascon_energy,
               lambda m: m.models.mascon_potential,
               dict(omega=(0.0, 0.0, 0.3), **_mascon_kw(12, 7))),
    "fixed_centres": (lambda m: m.models.fixed_centres,
                      lambda m: m.models.fixed_centres_energy,
                      lambda m: m.models.fixed_centres_potential,
                      _centres_kw()),
    "rotating": (lambda m: m.models.rotating,
                 lambda m: m.models.rotating_energy,
                 lambda m: m.models.rotating_potential,
                 dict(omega=(0.1, -0.2, 0.3))),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_model_expressions_match_jax(model):
    *fns, kw = MODELS[model]
    sys_, energy, pot = fns
    assert [(repr(a), repr(b)) for a, b in sys_(ht)(**kw)] == \
        [(repr(a), repr(b)) for a, b in sys_(hy)(**kw)]
    assert repr(energy(ht)(**kw)) == repr(energy(hy)(**kw))
    assert repr(pot(ht)(**kw)) == repr(pot(hy)(**kw))


@pytest.mark.parametrize("name", ["mascon12", "fixed_centres10"])
def test_model_plans_match_jax(name):
    jp = j_build_plan(j_decompose(CASES[name](hy)), 19)
    assert _fields(_p_plan(name, 19)) == _fields(jp)


# -- the row classes ------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_row_classes_match_jax(name):
    jc = pp._row_classes(j_build_plan(j_decompose(CASES[name](hy)), 15))
    pc = rows._row_classes(_p_plan(name, 15))
    np.testing.assert_array_equal(pc[0], jc[0])
    np.testing.assert_array_equal(pc[1], jc[1])
    assert pc[2] == jc[2]


def test_row_classes_mascon512():
    # the tentpole's tape, as benchmarks/mascon_bench.py builds it
    kw = dict(omega=(0.0, 0.0, 2.0 * np.pi / 10.0), **_mascon_kw(512, 42))
    jc = pp._row_classes(j_build_plan(
        j_decompose(hy.models.mascon(**kw)), 19))
    plan = p_build_plan(p_decompose(ht.models.mascon(**kw)), 19)
    pc = rows._row_classes(plan)
    assert plan.width == 9237 and pc[2] == jc[2] == (4105, 3079, 2053)
    np.testing.assert_array_equal(pc[0], jc[0])
    np.testing.assert_array_equal(pc[1], jc[1])


def test_mixed_exponents_share_a_group():
    plan = _p_plan("handbuilt_mixed", 7)
    pows = [g for lv in plan.levels for g in lv if g.name == "pow"]
    assert len(pows) == 1 and sorted(pows[0].alpha) == [-1.5, 2.5]


# -- the rolled jet against the JAX staged engine and the dense twin -------------

@pytest.mark.parametrize("name", list(CASES))
def test_rolled_step_matches_jax_flat(name):
    # the step over jet_rolled_plain against the JAX staged flat engine
    # through jit_flat_step (B = 8, order 15), and the rolled twin against
    # the dense one.  Tolerance 1e-13 per order: f64 everywhere, only the
    # convolutions' summation order differs.
    B, K = 8, 15
    st, pars, t = _inputs(name, B)
    mdt = np.full(B, 1e9)
    jstep = jit_flat_step(make_batched_step_flat(
        j_decompose(CASES[name](hy)), K, layout="3d", unroll=True,
        staged=True, return_tc=True, pallas_phase=False))
    s0, h0, tc0 = (np.asarray(a) for a in jstep(
        jnp.asarray(st), jnp.asarray(pars), jnp.asarray(t), jnp.asarray(mdt)))
    tape = _rolled_tape(name, K)
    pstep = pcf.make_batched_step_flat(tape, jet=jr.jet_rolled)
    s1, h1, tc1 = (a.numpy() for a in pstep(*map(_t, (st, pars, t, mdt))))
    assert tc1.shape == tc0.shape == (B, K + 1, st.shape[1])
    assert _per_order_rel(tc1, tc0).max() <= 1e-13
    np.testing.assert_allclose(h1, h0, rtol=1e-13, atol=0)
    np.testing.assert_allclose(s1, s0, rtol=1e-13, atol=1e-13)

    args = (_t(st.T), _t(pars.T), _t(t))
    tc_r, n_r = jr.jet_rolled_plain(tape, *args)
    tc_d, n_d = jk.jet_plain(jk.JetTape(tape.arrays, "cpu"), *args)
    assert bool(torch.isfinite(tc_r).all())
    assert _per_order_rel(tc_r.numpy(), tc_d.numpy()).max() <= 1e-13
    torch.testing.assert_close(n_r, n_d, rtol=1e-13, atol=0)


def test_twin_shows_an_unsound_partition(monkeypatch):
    # mark the operands of the convolutions current-order only (C): their
    # lower orders are then gone when a later order reads them, and the
    # twin, which reads through the class maps, must go wrong
    B, K = 4, 9
    st, pars, t = _inputs("mascon12", B)
    args = (_t(st.T), _t(pars.T), _t(t))
    arrays = ht.plan_to_arrays(_p_plan("mascon12", K))
    good_tape = jr.RolledTape(arrays, "cpu")
    good = jr.jet_rolled_plain(good_tape, *args)[0]
    monkeypatch.setattr(rows, "_opsets", lambda g: [])
    bad_tape = jr.RolledTape(arrays, "cpu")
    assert bad_tape.sizes[0] < good_tape.sizes[0]
    bad = jr.jet_rolled_plain(bad_tape, *args)[0]
    assert torch.equal(bad[:, 0], good[:, 0])  # order 0 holds
    assert not torch.allclose(bad, good, rtol=1e-6, atol=0)


# -- against the JAX package's own kernel B3 --------------------------------------

@pytest.fixture
def small_groups(monkeypatch):
    # tests/test_pallas_rolled.py's fixture: sort and piece-read groups of
    # 8 and more, so mascon-12 takes the instance-regular code paths; the
    # port's plan is built under the same sort threshold
    monkeypatch.setenv("HEYOKA_PLAN_SORT_MIN", "8")
    monkeypatch.setattr(pp, "_STAGE_SKIP_MIN", 8)
    monkeypatch.setattr(pcompact, "_SORT_MIN", 8)


def test_rolled_matches_jax_b3_interpret(small_groups, monkeypatch):
    B, K = 2, 9
    st = _orbit_states(B)
    jtape = j_decompose(_mascon12(hy))
    plan = p_build_plan(p_decompose(_mascon12(ht)), K)
    assert _fields(plan) == _fields(j_build_plan(jtape, K))
    monkeypatch.setenv("HEYOKA_PALLAS_ROLLED", "1")
    kw = dict(dtype=jnp.float64, high_accuracy=True, mp_order=5,
              layout="3d", unroll=True, staged=True)
    n2, h2 = (np.asarray(a) for a in jit_flat_step(make_batched_step_flat(
        jtape, K, pallas_phase="dd-interpret", **kw))(
        jnp.asarray(st), jnp.zeros((B, 0)), jnp.zeros(B),
        jnp.full(B, 1e9)))
    tape = jr.RolledTape(ht.plan_to_arrays(plan), "cpu")
    n1, h1, _ = pcf.make_batched_step_flat(tape, jet=jr.jet_rolled)(
        _t(st), torch.zeros(B, 0, dtype=torch.float64),
        torch.zeros(B, dtype=torch.float64), _t(np.full(B, 1e9)))
    # the tolerances of tests/test_pallas_rolled.py's rolled-vs-f64 check:
    # the TPU kernel runs two-f32 arithmetic with an f32 tail above order 5
    assert np.max(np.abs(n1.numpy() - n2)) < 1e-8 * np.max(np.abs(n2))
    np.testing.assert_allclose(h1.numpy(), h2, rtol=1e-7)


# -- the batch class routes a wide tape to the rolled jet --------------------------

def _main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (see test_torch_prop)."""
    return np.asarray(ns) - (np.abs(last_h) < 4 * np.spacing(np.abs(t)))


@pytest.fixture
def rolled_only(monkeypatch):
    """Route every tape of 64 columns or more to the rolled jet, and fail
    on any use of the dense twins."""
    monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", 64)

    def no_dense(*a, **k):
        raise AssertionError("the dense jet ran on a rolled tape")

    monkeypatch.setattr(jk, "jet_plain", no_dense)
    monkeypatch.setattr(jk, "prop_plain", no_dense)


def test_batch_routes_wide_tape_to_rolled(rolled_only):
    st = _orbit_states(4, seed=5)
    kw = dict(tol=1e-12, high_accuracy=True)
    p = ht.taylor_adaptive_batch(_mascon12(ht), st, device="cpu", **kw)
    assert p.engine_report() == dict(device="cpu", jet="jet_rolled_plain",
                                     propagate_engine="flat", prop=None,
                                     grid_engine="flat",
                                     c_output_engine="flat",
                                     layout=jr.layout_report(p._jtape))
    assert p.engine_report()["layout"]["layout"] == "smem"
    assert isinstance(p._jtape, jr.RolledTape)
    j = hy.taylor_adaptive_batch(_mascon12(hy), st, compact_mode="flat",
                                 **kw)
    for mdt in (None, 0.05):
        j.step(max_delta_t=mdt)
        p.step(max_delta_t=mdt)
        assert [o for o, _ in p.get_step_res()] == \
            [o for o, _ in j.get_step_res()]
        np.testing.assert_allclose(p.state, j.state, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(p.tc, j.tc, rtol=1e-13, atol=1e-13)


def test_rolled_propagate_until_matches_jax(rolled_only):
    st = _orbit_states(4, seed=6)
    kw = dict(tol=1e-12, high_accuracy=True)
    p = ht.taylor_adaptive_batch(_mascon12(ht), st, device="cpu", **kw)
    j = hy.taylor_adaptive_batch(_mascon12(hy), st, compact_mode="flat",
                                 **kw)
    rj = j.propagate_until(5.0)
    rp = p.propagate_until(5.0)
    assert rp[0] == rj[0] and all(o == ht.TaylorOutcome.time_limit
                                  for o in rp[0])
    assert (p.time == 5.0).all() and (p.dtime[0] == 5.0).all()
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], j.last_h, j.time))
    scale = np.abs(j.state).max()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11 * scale)
    rj = j.propagate_for(-2.0)
    rp = p.propagate_for(-2.0)
    assert rp[0] == rj[0] and (p.time == 3.0).all()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11 * scale)


def test_narrow_tapes_keep_the_dense_jet():
    assert pbatch.ROLLED_MIN_WIDTH > 381  # the outer-Solar-System tape
    p = ht.taylor_adaptive_batch(_mascon12(ht), _orbit_states(2),
                                 device="cpu", tol=1e-9)
    assert p.engine_report()["jet"] == "jet_plain"
    assert p.engine_report()["propagate_engine"] == "fused"


# -- the wrapper and the kernel's tables ---------------------------------------------

def test_jet_rolled_wrapper_on_cpu_is_the_twin():
    B, K = 4, 9
    tape = _rolled_tape("handbuilt_mixed", K)
    st, pars, t = _inputs("handbuilt_mixed", B, seed=2)
    args = (_t(st.T), _t(pars.T), _t(t))
    before = dict(jk.LAUNCHES)
    tc, norms = jr.jet_rolled(tape, *args)
    assert jk.LAUNCHES == before  # no kernel launch on the CPU
    tc_p, norms_p = jr.jet_rolled_plain(tape, *args)
    assert torch.equal(tc, tc_p) and torch.equal(norms, norms_p)
    assert tc.shape == (3, K + 1, B) and norms.shape == (3, B)


@pytest.mark.parametrize("name", ["mascon12", "handbuilt_mixed"])
def test_rolled_tables(name):
    # the int32 table kernel B3 decodes: sizes, the level ranges of its two
    # item lists, and the location words against the class maps
    tape = _rolled_tape(name, 7)
    it = tape.ritab.numpy()
    hdr = dict(zip(jr._RHDR, it[:len(jr._RHDR)].tolist()))
    assert (hdr["n_eq"], hdr["K"]) == (tape.n_eq, tape.order)
    assert (hdr["WH"], hdr["WC"], hdr["WV"], hdr["NA"], hdr["NS"]) \
        == tape.sizes
    a = tape.arrays
    n_ops = a["arg_ptr"].size - 1

    def sub(key, n):
        return it[hdr[key]:hdr[key] + n]

    def decode(loc):
        return loc >> jr.CLS_SHIFT, loc & ((1 << jr.CLS_SHIFT) - 1)

    n_lv = hdr["n_levels"]
    lvl0, lvlk = sub("lvl0", n_lv + 1), sub("lvlk", n_lv + 1)
    assert lvl0[0] == 0 and lvl0[-1] == lvlk[0]
    assert (np.diff(lvl0) > 0).all() and (np.diff(lvlk) >= 0).all()
    # the class maps: H, C and V rows as _row_classes numbers them, with
    # the aliases out of H and the roots renumbered in column order
    cls0, row0, sizes0 = rows._row_classes(ht.plan_from_arrays(a))
    assert tape.sizes[0] + tape.sizes[3] == sizes0[0]
    assert tape.sizes[1:3] == sizes0[1:]
    keep = tape.classv != jr.A
    np.testing.assert_array_equal(tape.classv[keep], cls0[keep])
    assert (cls0[~keep] == 0).all()
    for c in (jr.C, jr.V):
        np.testing.assert_array_equal(tape.rowmap[cls0 == c],
                                      row0[cls0 == c])
    for c in (jr.H, jr.A):
        np.testing.assert_array_equal(
            tape.rowmap[tape.classv == c],
            np.arange(int((tape.classv == c).sum())))
    cls, row = decode(sub("rhs", tape.n_eq))
    np.testing.assert_array_equal(cls, tape.classv[a["rhs_cols"]])
    np.testing.assert_array_equal(row, tape.rowmap[a["rhs_cols"]])
    np.testing.assert_array_equal(
        sub("crows", a["const_cols"].size), tape.rowmap[a["const_cols"]])
    assert hdr["n_levels"] == len(ht.plan_from_arrays(a).levels)
    assert hdr["d_alpha"] == a["const_vals"].size
    if tape.time_col is not None:
        assert hdr["time_row"] == tape.rowmap[tape.time_col]
    d = tape.rdtab.numpy()
    np.testing.assert_array_equal(d[:hdr["d_alpha"]], a["const_vals"])
    pows = a["alpha"][a["alpha"] != 0]
    np.testing.assert_array_equal(d[hdr["d_alpha"]:],
                                  np.concatenate([pows, pows]))
    assert n_ops > 0
