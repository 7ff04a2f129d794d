"""The phase route of the port (kernel B4's plain twin, the order-0 rules,
the aux carrier and the batch integrator over them) against the JAX
package, on the CPU in f64.  The kernel itself is held against its twin
in tests/test_torch_gpu.py and in chip_smoke.py phase 10, whose tapes
(``chip_smoke.phase_cases``) these tests use."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.expr import registry as j_registry
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.taylor.compact import build_plan as j_build_plan
from heyoka_tpu.taylor.compact_flat import jit_flat_step, make_batched_step_flat
from heyoka_tpu.taylor.compact_loop import _pow0_vec_b

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.expr import numeric
from heyoka_tpu_torch.expr.decompose import taylor_decompose_sys as p_decompose
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor.compact import build_plan as p_build_plan

from chip_smoke import phase_cases, phase_lanes, pendulum_lanes, seeded_buffer

B, K = 8, 15  # the sizes of tests/test_compact.py (order 15 ~ tol 1e-13)
J_CASES, P_CASES = phase_cases(hy), phase_cases(ht)
MIXED = [n for n in P_CASES if not n.startswith("op_")]
PER_OP = [n for n in P_CASES if n.startswith("op_")]
#: the one-op tapes merged into ``"per_op"``: all but kepF and kepDE,
#: whose synthetic series make the JAX staged engine's compile slow
#: (~10 s each at order 15 on the CPU, ~45 s for "kepFDE")
MERGED = [n for n in PER_OP if n not in ("op_kepF", "op_kepDE")]
#: the staged-engine comparisons: (tape, order); kepF and kepDE alone at
#: order 8 (~4 s to compile), which still runs every rule, the
#: synthetic rows included; "kepFDE" is held to the kernel on the card
STAGED = [(n, K) for n in MIXED if n != "kepFDE"] + [
    ("per_op", K), ("op_kepF", 8), ("op_kepDE", 8)]


def _per_op_system(pkg):
    """The one-op systems of ``phase_cases`` side by side in one tape
    (variables ``x{i}``, ``y{i}``): one JAX compile covers them all."""
    out = []
    for i, name in enumerate(MERGED):
        sys_ = phase_cases(pkg)[name][0]
        ren = {"x": f"x{i}", "y": f"y{i}"}
        for lhs, rhs in sys_:
            out.append((pkg.make_vars(ren[lhs.name]),
                        pkg.rename_variables(rhs, ren)))
    return out


def _case(pkg, name):
    """(system, state (2n,), pars) of a case; ``"per_op"`` is the merged
    one-op systems."""
    if name == "per_op":
        st0 = np.concatenate([P_CASES[n][1] for n in MERGED])
        return _per_op_system(pkg), st0, []
    return (J_CASES if pkg is hy else P_CASES)[name]


def _phase_tape(name, order=K):
    plan = p_build_plan(p_decompose(_case(ht, name)[0]), order)
    return jp.PhaseTape(ht.plan_to_arrays(plan), "cpu")


def _lanes(st0, pars, seed):
    return phase_lanes(st0, pars, B, seed)


def _seeded(tape, st, pars, t):
    return seeded_buffer(tape, st, pars, t, "cpu")


def _per_order_rel(a, b):
    """max over columns and lanes of |a - b| per order, relative to that
    order's max |b|; arrays (W, K+1, B)."""
    scale = np.abs(b).max(axis=(0, 2))
    return np.abs(a - b).max(axis=(0, 2)) / np.where(scale > 0, scale, 1.0)


# -- order-0 rules -------------------------------------------------------------

def _domain(name, rng, n=64):
    """Operands of op ``name`` inside its domain, away from switch points
    of the discontinuous ops (with exact ties for the relational ones)."""
    u = rng.uniform
    if name in ("log", "sqrt"):
        return [u(0.1, 3.0, n)]
    if name in ("asin", "acos", "atanh"):
        return [u(-0.9, 0.9, n)]
    if name == "acosh":
        return [u(1.1, 3.0, n)]
    if name == "div":
        return [u(-2, 2, n), u(0.5, 2.0, n) * rng.choice([-1, 1], n)]
    if name in ("sum", "logical_and", "logical_or"):
        return [rng.choice([0.0, 1.0, -0.5], n) for _ in range(3)]
    if name in ("mul", "atan2"):
        return [u(-2, 2, n), u(-2, 2, n)]
    if name in ("lt", "le", "gt", "ge", "eq", "ne"):
        a = rng.choice([-0.5, 0.0, 0.5], n)
        return [a, np.where(rng.uniform(size=n) < 0.3, a, u(-1, 1, n))]
    if name == "select":
        return [rng.choice([0.0, 1.0, 0.3], n), u(-2, 2, n), u(-2, 2, n)]
    if name == "kepE":
        return [u(0.0, 0.9, n), u(-10, 10, n)]
    if name in ("kepF", "kepDE"):
        return [u(-0.3, 0.3, n), u(-0.3, 0.3, n), u(-10, 10, n)]
    return [u(-2, 2, n)]


#: wider bounds than 1e-15: XLA's CPU arctanh is up to 129 ulps (1e-14
#: relative) off the correctly rounded value, torch's within 2 (measured
#: against Python's math.atanh); the test also holds atanh to math.atanh
_RTOL0 = {"atanh": 2e-14}


@pytest.mark.parametrize("name", sorted(numeric.EVALUATE))
def test_order0_rule_matches_jax(name):
    # 1e-15 relative: both are f64 library functions (a last-bit
    # difference at most); the Kepler solvers stop lanes one by one here
    # and all together in JAX, which moves a lane's last bit
    args = _domain(name, np.random.default_rng(sorted(numeric.EVALUATE)
                                               .index(name)))
    ar = numeric.EVAL_ARITY.get(name, len(args))
    if name == "mul":
        ref = args[0] * args[1]
    else:
        ref = np.asarray(j_registry.opdef(name).evaluate(
            *(jnp.asarray(a) for a in args[:ar])))
    got = numeric.evaluate(name, *(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref,
                               rtol=_RTOL0.get(name, 1e-15), atol=0)
    if name == "atanh":
        exact = np.array([math.atanh(v) for v in args[0]])
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-15, atol=0)


def test_order0_pow_matches_jax():
    rng = np.random.default_rng(5)
    b = rng.uniform(0.2, 3.0, 64)
    alpha = np.array([-1.5, -1.0, -0.5, 0.5, 1.5, 2.0, -3.0, 0.3] * 8)
    ref = np.asarray(_pow0_vec_b(jnp, jnp.asarray(b[:, None]), alpha))[:, 0]
    got = torch.empty(64, dtype=torch.float64)
    for al in np.unique(alpha):
        sel = alpha == al
        got[torch.as_tensor(sel)] = jk._pow0_plain(
            torch.as_tensor(b[sel]), float(al))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=0)


# -- the plan carrier ------------------------------------------------------------

@pytest.mark.parametrize("name", MIXED + PER_OP)
def test_plan_round_trip_with_aux(name):
    # the JAX package's plan, aux columns included, through the arrays
    # and back; and the port's own plan gives the same arrays
    jplan = j_build_plan(j_decompose(_case(hy, name)[0]), K)
    arrays = ht.plan_to_arrays(jplan)
    back = ht.plan_from_arrays(arrays)
    jg = [g for lv in jplan.levels for g in lv]
    bg = [g for lv in back.levels for g in lv]
    assert [g.name for g in bg] == [g.name for g in jg]
    for a, b in zip(jg, bg):
        np.testing.assert_array_equal(b.out_cols, a.out_cols)
        np.testing.assert_array_equal(b.in_cols, a.in_cols)
        assert set(b.aux) == set(a.aux) == set(ht.convert.AUX_KEYS.get(
            a.name, ()))
        for key in a.aux:
            np.testing.assert_array_equal(b.aux[key], a.aux[key])
        if a.name == "pow":
            np.testing.assert_array_equal(b.alpha, a.alpha)
    again = ht.plan_to_arrays(back)
    own = ht.plan_to_arrays(p_build_plan(p_decompose(_case(ht, name)[0]), K))
    for key, v in arrays.items():
        np.testing.assert_array_equal(again[key], v)
        np.testing.assert_array_equal(own[key], v)


def test_aux_columns_follow_their_op():
    # tan's square and kepE's sin/cos come after their op in the tape:
    # the reason every B4 rule reads them only below the current order
    for name, key in (("trig", "sq"), ("kepE", "sin"), ("kepE", "cos")):
        plan = p_build_plan(p_decompose(P_CASES[name][0]), K)
        op = "tan" if key == "sq" else "kepE"
        g = next(g for lv in plan.levels for g in lv if g.name == op)
        assert (g.aux[key] > g.out_cols).all()


# -- the twin against the JAX staged engine ---------------------------------------

@pytest.mark.parametrize("name,order", STAGED)
def test_phase_plain_matches_jax_staged(name, order):
    # order 0 in torch and orders 1..K in phase_plain, against the dense
    # coefficients of every column from the JAX f64 staged engine (B4's
    # own plain reference, test_compact.py:261-288).  1e-13 relative per
    # order: f64 in both with the same recurrences; the summation order of
    # the convolutions differs
    sys_j, st0, pars = _case(hy, name)
    st, pr, t = _lanes(st0, pars, seed=len(name))
    jstep = jit_flat_step(make_batched_step_flat(
        j_decompose(sys_j), order, layout="3d", unroll=True, staged=True,
        _debug_tc=True))
    tc_j = np.asarray(jstep(jnp.asarray(st), jnp.asarray(pr), jnp.asarray(t),
                            jnp.full(B, 1e9))[0])
    tape = _phase_tape(name, order)
    tc = jp.phase_plain(tape, _seeded(tape, st, pr, t), 1)
    tc_p = tc.permute(1, 0, 2).numpy()
    assert tc_p.shape == tc_j.shape == (tape.width, order + 1, B)
    assert np.isfinite(tc_p).all()
    assert _per_order_rel(tc_p, tc_j).max() <= 1e-13


@pytest.mark.parametrize("name", ["trig", "kepE", "kepFDE", "per_op"])
def test_phase_plain_from_lo9_equals_lo1(name):
    # the JAX route's split (mp_order = 8): orders 9..K from a buffer
    # whose orders 0..8 came from the run from lo = 1 give that run's
    # coefficients bit for bit, the Kepler synthetic rows included
    tape = _phase_tape(name)
    st0, pars = _case(ht, name)[1:]
    tc1 = jp.phase_plain(tape, _seeded(tape, *_lanes(st0, pars, 3)), 1)
    tc9 = tc1.clone()
    n_w = tape.n_eq + tape.arrays["arg_ptr"].size - 1
    tc9[9:, :n_w] = float("nan")
    jp.phase_plain(tape, tc9, 9)
    assert torch.equal(tc9, tc1)


def test_phase_wrapper_on_cpu_is_the_twin():
    tape = _phase_tape("kepFDE", 9)
    tc0 = _seeded(tape, *_lanes(P_CASES["kepFDE"][1], [], 4))
    before = dict(jk.LAUNCHES)
    tc = jp.phase(tape, tc0.clone(), 1)
    assert jk.LAUNCHES == before  # no kernel launch on the CPU
    assert torch.equal(tc, jp.phase_plain(tape, tc0.clone(), 1))
    with pytest.raises(ValueError):
        jp.phase(tape, tc0.clone(), 0)  # order 0 is order0's
    # jet_phase: the contract of jet_kernels.jet
    st = tc0[0, :tape.n_eq].clone()
    out, norms = jp.jet_phase(tape, st, torch.zeros(0, B, dtype=torch.float64))
    assert out.shape == (2, 10, B) and norms.shape == (3, B)
    torch.testing.assert_close(out, tc[:, :2].permute(1, 0, 2), rtol=0,
                               atol=0)
    torch.testing.assert_close(norms, out.abs().amax(0)[[8, 9, 0]], rtol=0,
                               atol=0)


def test_phase_tables():
    # the header fields after jet_kernels._HDR: the aux and synthetic-row
    # tables the kernel decodes
    tape = _phase_tape("kepFDE", 7)
    it = tape.itab.numpy()
    hdr = dict(zip(jp._PHDR, it[:len(jp._PHDR)].tolist()))
    a = tape.arrays
    n_ops = a["arg_ptr"].size - 1
    np.testing.assert_array_equal(
        it[hdr["aux"]:hdr["aux"] + 2 * n_ops], a["aux"].reshape(-1))
    syn = it[hdr["syn"]:hdr["syn"] + n_ops]
    assert hdr["syn"] + n_ops == it.size
    assert hdr["n_syn"] == tape.n_syn == 2  # one kepF and one kepDE row
    kep = [ht.OPCODES[op] in jp.SYNTH for op, m in zip(a["g_op"], a["g_m"])
           for _ in range(m)]
    assert sorted(syn[kep].tolist()) == [0, 1] and (syn[~np.array(kep)]
                                                     == -1).all()


# -- the routes ------------------------------------------------------------------

def _pair(name, seed):
    sys_j, st0, pars = _case(hy, name)
    st, pr, _ = _lanes(st0, pars, seed)
    kw = dict(tol=1e-13, high_accuracy=True, pars=pr if pars else None)
    j = hy.taylor_adaptive_batch(sys_j, st, compact_mode="flat", **kw)
    p = ht.taylor_adaptive_batch(_case(ht, name)[0], st, device="cpu", **kw)
    return j, p


def _main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (see test_torch_prop)."""
    return np.asarray(ns) - (np.abs(last_h) < 4 * np.spacing(np.abs(t)))


@pytest.mark.parametrize("name", ["pendulum", "par_time"])
def test_batch_matches_jax(name):
    j, p = _pair(name, seed=7)
    assert p.order == j.order
    assert p.engine_report() == dict(device="cpu", jet="phase_plain",
                                     propagate_engine="flat", prop=None)
    for mdt in (None, 0.05):
        j.step(max_delta_t=mdt)
        p.step(max_delta_t=mdt)
        np.testing.assert_allclose(p.state, j.state, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(p.time, j.time, rtol=1e-12)
    rj = j.propagate_until(3.0)
    rp = p.propagate_until(3.0)
    assert rp[0] == rj[0] and all(o == ht.TaylorOutcome.time_limit
                                  for o in rp[0])
    assert (p.time == 3.0).all() and (p.dtime[0] == 3.0).all()
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], j.last_h, j.time))
    scale = np.abs(j.state).max()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11 * scale)


def test_pendulum_lanes_librate():
    # chip_smoke's phase-11 lanes: every energy between 1.2 and the
    # separatrix's 2 g = 19.6
    st = pendulum_lanes(4096, 0)
    e = 0.5 * st[:, 1] ** 2 + 9.8 * (1.0 - np.cos(st[:, 0]))
    assert (np.abs(st[:, 0]) >= 0.5).all() and (np.abs(st[:, 0]) <= 2).all()
    assert e.min() >= 1.2 and e.max() < 19.6
    assert (st[:, 0] < 0).any() and (st[:, 0] > 0).any()
    # phase 10's lanes sit near each case's state
    st, pars, t = phase_lanes([0.5, -0.3], [], 32, 1)
    assert np.abs(st - [0.5, -0.3]).max() < 0.1 and pars.shape == (32, 0)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["pendulum", "trig"])
def test_phase_plain_matches_pallas_interpret(name):
    # the TPU kernel itself (make_phase_kernel, interpret mode) from
    # lo = mp_order + 1 on the same f32 buffer: f32 tolerance, as
    # test_compact.py's own slow test holds it
    from heyoka_tpu.taylor.pallas_phase import make_phase_kernel
    import jax

    mp = 6
    tape = _phase_tape(name, 13)
    st0, pars = _case(ht, name)[1:]
    tc = jp.phase_plain(tape, _seeded(tape, *_lanes(st0, pars, 2)), 1)
    jplan = j_build_plan(j_decompose(_case(hy, name)[0]), 13)
    kern = make_phase_kernel(jplan, mp + 1, 13, B, interpret=True)
    seed = tc.permute(1, 0, 2).numpy().copy()
    seed[:tape.n_eq + tape.arrays["arg_ptr"].size - 1, mp + 1:] = 0.0
    out = np.asarray(jax.jit(kern)(jnp.asarray(seed, jnp.float32)),
                     np.float64)
    ref = jp.phase_plain(tape, tc.clone(), mp + 1).permute(1, 0, 2).numpy()
    assert _per_order_rel(out, ref).max() <= 1e-5
