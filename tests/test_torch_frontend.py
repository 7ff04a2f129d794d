"""The port's front end against the JAX package's: the copied expression
layer, the tape planner, the plan's array form, the step rules and the
double-length arithmetic, on the CPU in f64.  Also: the port imports and
runs without JAX."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
import heyoka_tpu.dfloat as jdf
import heyoka_tpu.taylor.stepper as jst
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.models import nbody as j_nbody, nbody_energy as j_energy
from heyoka_tpu.taylor.compact import build_plan as j_build_plan

import heyoka_tpu_torch as ht
import heyoka_tpu_torch.dfloat as pdf
import heyoka_tpu_torch.taylor.stepper as pst
from heyoka_tpu_torch.expr.decompose import taylor_decompose_sys as p_decompose
from heyoka_tpu_torch.models import nbody as p_nbody, nbody_energy as p_energy
from heyoka_tpu_torch.taylor.compact import build_plan as p_build_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OUTER_SS_MASSES = [1.00000597682, 1.0 / 1047.355, 1.0 / 3501.6,
                   1.0 / 22869.0, 1.0 / 19314.0, 7.4074074e-09]
OUTER_SS_G = 0.01720209895**2 * 365 * 365


def _handbuilt(m):
    """div, sqrt, pow, a parameter and the time, through either package."""
    x, y, z = m.make_vars("x", "y", "z")
    return [
        (x, m.par[0] * y / (1.0 + x * x) + m.sqrt(1.5 + y * y)),
        (y, -x / m.sqrt(x * x + y * y + 0.3) + 0.1 * m.time_ * z),
        (z, (x * x + z * z + 2.0) ** -1.5 - m.par[1] * z),
    ]


SYSTEMS = {
    "nbody3": lambda m: m.models.nbody(3, masses=[1.0, 1e-3, 2e-3]),
    "nbody6": lambda m: m.models.nbody(6, masses=OUTER_SS_MASSES,
                                       Gconst=OUTER_SS_G),
    "handbuilt": _handbuilt,
}


def _tape_key(tape):
    return (tape.n_eq, tape.n_pars, tape.var_names, tape.rhs, tape.outputs,
            [(op.op, op.inputs, op.meta) for op in tape.ops])


def _plan_fields(plan, with_ops=True):
    """A comparable tuple of every field of a plan (either package)."""
    out = []
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if f.name == "levels":
            v = [[_group_fields(g, with_ops) for g in lv] for lv in v]
        elif isinstance(v, np.ndarray):
            v = (v.dtype.kind, v.tolist())
        out.append((f.name, v))
    return out


def _group_fields(g, with_ops):
    out = []
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        if f.name == "ops":
            if not with_ops:
                continue
            v = [((op.op, op.inputs, op.meta), u, cols) for op, u, cols in v]
        elif f.name == "aux":
            v = {k: a.tolist() for k, a in v.items()}
        elif isinstance(v, np.ndarray):
            v = (v.dtype.kind, v.tolist())
        out.append((f.name, v))
    return out


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_decompose_matches_jax(name):
    jt = j_decompose(SYSTEMS[name](hy))
    pt = p_decompose(SYSTEMS[name](ht))
    assert _tape_key(pt) == _tape_key(jt)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_build_plan_matches_jax(name):
    order = 19 if name == "nbody6" else 15
    jp = j_build_plan(j_decompose(SYSTEMS[name](hy)), order)
    pp = p_build_plan(p_decompose(SYSTEMS[name](ht)), order)
    assert _plan_fields(pp) == _plan_fields(jp)


def test_outer_ss_plan_shape():
    # the north-star tape: 381 columns, 36 state variables, 12 constants,
    # no parameters or time, 7 levels of sum/mul/pow groups
    plan = p_build_plan(p_decompose(SYSTEMS["nbody6"](ht)), 19)
    assert (plan.width, plan.n_eq, len(plan.const_cols)) == (381, 36, 12)
    assert plan.par_cols == [] and plan.time_col is None
    groups = [[(g.name, g.out_cols.size) for g in lv] for lv in plan.levels]
    assert groups == [[("mul", 15)], [("sum", 45)], [("mul", 135)],
                      [("sum", 15)], [("pow", 15)], [("mul", 90)],
                      [("sum", 18)]]


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plan_arrays_round_trip_jax_plan(name):
    # the reference's own plan, carried across as numpy arrays, rebuilds
    # the port's plan field by field (the tape op objects aside)
    jp = j_build_plan(j_decompose(SYSTEMS[name](hy)), 11)
    pp = p_build_plan(p_decompose(SYSTEMS[name](ht)), 11)
    arrays = ht.plan_to_arrays(jp)
    assert all(isinstance(a, np.ndarray) for a in arrays.values())
    back = ht.plan_from_arrays(arrays)
    assert _plan_fields(back, with_ops=False) == \
        _plan_fields(pp, with_ops=False)
    again = ht.plan_to_arrays(back)
    assert arrays.keys() == again.keys()
    for k in arrays:
        np.testing.assert_array_equal(again[k], arrays[k], err_msg=k)


def test_energy_expression_matches_jax():
    kw = dict(masses=[1.0, 1e-3, 2e-3], Gconst=1.5)
    assert repr(p_energy(3, **kw)) == repr(j_energy(3, **kw))
    assert [(repr(a), repr(b)) for a, b in p_nbody(3, **kw)] == \
        [(repr(a), repr(b)) for a, b in j_nbody(3, **kw)]


@pytest.mark.parametrize("tol", [1e-6, 1e-9, 1e-12, 1e-15, 2.2e-16])
def test_order_from_tol(tol):
    assert pst.taylor_order_from_tol(tol) == jst.taylor_order_from_tol(tol)


@pytest.mark.parametrize("high_accuracy", [False, True])
def test_step_rules_match_jax(high_accuracy):
    # random (K+1, n) jets per lane: the port's lane-last functions against
    # the JAX per-trajectory ones vmapped over lanes
    rng = np.random.default_rng(7)
    K, n, B = 12, 5, 6
    tc = rng.standard_normal((B, K + 1, n)) * (0.5 ** np.arange(K + 1))[
        None, :, None]
    mdt = np.array([np.inf, 0.01, -np.inf, -0.02, 1e9, 0.5])
    hj = np.asarray(jax.vmap(
        lambda c, m: jst.determine_h(c, K, n, m))(jnp.asarray(tc),
                                                  jnp.asarray(mdt)))
    tct = torch.as_tensor(tc.transpose(1, 2, 0).copy())  # (K+1, n, B)
    hp = pst.determine_h(tct, K, n, torch.as_tensor(mdt)).numpy()
    np.testing.assert_allclose(hp, hj, rtol=1e-15, atol=0)
    jfn = jst.ceval_update if high_accuracy else jst.horner_update
    pfn = pst.ceval_update if high_accuracy else pst.horner_update
    sj = np.asarray(jax.vmap(lambda c, h: jfn(c, h, K, n))(
        jnp.asarray(tc), jnp.asarray(hj)))
    sp = pfn(tct, torch.as_tensor(hj.copy()), K, n).numpy().T
    np.testing.assert_allclose(sp, sj, rtol=1e-15, atol=1e-16)


def test_dfloat_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-10, 10, 64)
    al = rng.uniform(-1, 1, 64) * 1e-16
    b = rng.uniform(-1, 1, 64)
    bl = rng.uniform(-1, 1, 64) * 1e-17
    for fj, fp, args in ((jdf.dd_add_d, pdf.dd_add_d, (a, al, b)),
                         (jdf.dd_add_dd, pdf.dd_add_dd, (a, al, b, bl))):
        ref = fj(*args)  # the reference's functions run on numpy as well
        got = fp(*(torch.as_tensor(x) for x in args))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), r)


def test_unsupported_op_raises():
    # a sin tape: kernels B1/B2 (their jet) and the rolled route B3 still
    # refuse it; the batch integrator routes it to the phase jet (B4)
    from heyoka_tpu_torch.taylor import jet_kernels as jk
    from heyoka_tpu_torch.taylor import jet_phase as jp
    from heyoka_tpu_torch.taylor import jet_rolled as jr

    x, y = ht.make_vars("x", "y")
    sys_ = [(x, ht.math.sin(y)), (y, -x)]
    arrays = ht.plan_to_arrays(p_build_plan(p_decompose(sys_), 8))
    st = torch.ones(2, 3, dtype=torch.float64)
    pars = torch.zeros(0, 3, dtype=torch.float64)
    with pytest.raises(ht.UnsupportedKernelOp, match="cos|sin"):
        jk.jet(jp.PhaseTape(arrays, "cpu"), st, pars)
    with pytest.raises(ht.UnsupportedKernelOp, match="cos|sin"):
        jk.JetTape(arrays, "cpu")
    with pytest.raises(ht.UnsupportedKernelOp, match="cos|sin"):
        jr.RolledTape(arrays, "cpu")
    ta = ht.taylor_adaptive_batch(sys_, np.ones((2, 2)), device="cpu")
    assert ta.engine_report() == dict(device="cpu", jet="phase_plain",
                                      propagate_engine="flat", prop=None,
                                      grid_engine="flat",
                                      c_output_engine="flat", layout=None)
    ta.step()
    assert np.isfinite(ta.state).all() and (ta.time > 0).all()


def test_port_runs_without_jax():
    # the port must run where JAX is not installed: hide it (and the JAX
    # package, and mpmath, which only multiprec needs, at first use) and
    # run a 3-body propagation and an f32 pendulum through the port on the
    # CPU, with s11n, multiprec and native imported, and a step of the
    # native host runtime (backend="native")
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["heyoka_tpu"] = None
        sys.modules["mpmath"] = None
        import numpy as np
        import heyoka_tpu_torch as ht
        from heyoka_tpu_torch import multiprec, native, s11n
        tn = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025],
                                backend="native")
        oc, h = tn.step()
        assert tn.backend == "native" and native.native_available()
        assert oc == ht.TaylorOutcome.success and h > 0
        tf = ht.taylor_adaptive_batch(ht.models.pendulum(), [[0.1, 0.0]],
                                      tol=1e-6, dtype=np.float32,
                                      device="cpu")
        tf = s11n.loads(s11n.dumps(tf))
        tf.propagate_until(1.0)
        assert tf.state.dtype == np.float32 and tf.time[0] == 1.0
        from heyoka_tpu_torch.models import nbody
        st = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                       0, 1.5, 0, -0.8, 0, 0], float)
        ta = ht.taylor_adaptive_batch(
            nbody(3, masses=[1.0, 1e-3, 2e-3]), np.tile(st, (2, 1)),
            tol=1e-12, high_accuracy=True, device="cpu")
        oc, mn, mx, ns = ta.propagate_until(2.0)
        assert all(o == ht.TaylorOutcome.time_limit for o in oc), oc
        assert (ta.time == 2.0).all() and (ns > 0).all()
        assert "jax" not in {m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_runs_the_ephemeris_models_without_jax():
    # the same with the series slice: the ELP2000 series tape propagated
    # on the CPU (kernel S1's and B4's twins) and iau2006 through a cfunc,
    # JAX and the JAX package hidden; the new modules load lazily, which
    # the 3-body case above never reaches
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["heyoka_tpu"] = None
        import numpy as np
        import heyoka_tpu_torch as ht
        from heyoka_tpu_torch.models import elp2000_cartesian_e2000, iau2006
        x, y, z = ht.make_vars("x", "y", "z")
        c = elp2000_cartesian_e2000(thresh=1e-4, series_op=True)
        ta = ht.taylor_adaptive_batch(
            [(x, c[0] * 1e-10), (y, c[1] * 1e-10), (z, c[2] * 1e-10)],
            np.zeros((2, 3)), time=np.array([-0.2, 0.3]), tol=1e-15,
            device="cpu")
        assert ta.engine_report()["series"] == "series_jet_plain"
        oc, mn, mx, ns = ta.propagate_for(0.001)
        assert all(o == ht.TaylorOutcome.time_limit for o in oc), oc
        assert np.isfinite(ta.state).all() and (ns > 0).all()
        cf = ht.make_cfunc(iau2006(thresh=1e-4), vars=[], device="cpu")
        v = cf(np.zeros((3, 0)), time=np.array([-1.0, 0.0, 1.0]))
        assert v.shape == (3, 3) and bool(v.isfinite().all())
        mods = {m.split(".")[0] for m in sys.modules
                if sys.modules[m] is not None}
        assert "jax" not in mods and "heyoka_tpu" not in mods
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
