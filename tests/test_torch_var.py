"""The port's symbolic differentiation, derivative tensors, Lagrangian and
Hamiltonian equations and variational systems against the JAX package's
on the CPU in f64.

``diff``, ``diff_tensors``, ``var_ode_sys`` and ``lagrangian``/
``hamiltonian`` build the same expressions: their ``repr``s are equal, as
are the dtens keys, their order, ``initial_state`` (bit for bit, but
for the blocks wrt the initial time: -f(x0, t0) through torch's libm
against XLA's, 1e-15 relative), ``get_vslice`` and ``get_mindex``.  The variational
batch (the JAX side with ``compact_mode="flat"``, the per-step driver) and
scalar (the JAX side with ``compact_mode=True``) on the three routes: b2
the PCR3BP at order 1 (kernels B1/B2's twins), b3 the CR3BP at order 1
with ``ROLLED_MIN_WIDTH`` lowered to ``tools/cases.py``'s
``ROLLED_TEST_WIDTH`` (B3's twin), b4 the pendulum at order 2 and a
2-[4]-2 tanh network wrt its 22 parameters (B4's twin): states, Taylor
maps and ``get_tstate`` within 1e-11 of the JAX results' largest
magnitude (``tests/test_torch_prop.py``'s tolerance).  The variational
ensemble against the JAX ensemble to the same bound, and pickling.  The
JAX integrators are built once a module."""

import pickle

import numpy as np
import pytest

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH

ATOL = 1e-11  # times the reference's largest magnitude
T_END = 2.0
MU = 0.01
PCR3BP_IC = np.array([-0.45, 0.80, -0.80, -0.45])
CR3BP_IC = np.array([-0.45, 0.80, 0.05, -0.80, -0.45, 0.02])


def _close(a, b, atol=ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=atol * max(np.abs(b).max(), 1e-300))


# -- the systems, built with either package ----------------------------------


def _ffnn_sys(pkg):
    x, y = pkg.make_vars("x", "y")
    nn = pkg.models.ffnn([x, y], [4], 2, [pkg.tanh, lambda e: e])
    return list(zip([x, y], nn))


def _time_sys(pkg):
    """A system with parameters and an explicit time dependence."""
    x, y = pkg.make_vars("x", "y")
    m = pkg.math
    return [(x, pkg.par[0] * m.sin(pkg.time) * y + x * x),
            (y, -x + pkg.par[1] * y * m.cos(x))]


SYSTEMS = {
    "pendulum": lambda pkg: pkg.models.pendulum(),
    "pcr3bp": lambda pkg: pkg.models.pcr3bp(mu=MU),
    "cr3bp": lambda pkg: pkg.models.cr3bp(mu=MU),
    "ffnn": _ffnn_sys,
    "time_pars": _time_sys,
}

#: (system, variational arguments, order): the arguments a VarArgs name or
#: a function of the package giving the explicit list
VSYS = {
    "pendulum_o1": ("pendulum", "vars", 1),
    "pendulum_o2": ("pendulum", "vars", 2),
    "pendulum_o3": ("pendulum", "vars", 3),
    "pcr3bp_o1": ("pcr3bp", "vars", 1),
    "pcr3bp_o2": ("pcr3bp", "vars", 2),
    "cr3bp_o1": ("cr3bp", "vars", 1),
    "ffnn_params": ("ffnn", "params", 1),
    "time_pars_all": ("time_pars", "all", 1),
    "time_pars_list": ("time_pars",
                       lambda pkg: ["y", pkg.par[1], pkg.time], 1),
    "time_pars_o2": ("time_pars",
                     lambda pkg: [pkg.make_vars("x"), pkg.par[0]], 2),
}


def _vsys(pkg, name):
    sys_name, args, order = VSYS[name]
    args = getattr(pkg.VarArgs, args) if isinstance(args, str) else args(pkg)
    return pkg.var_ode_sys(SYSTEMS[sys_name](pkg), args, order)


# -- diff and dtens -------------------------------------------------------------

UNARY = ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
         "asinh", "acosh", "atanh", "exp", "log", "sqrt", "erf", "sigmoid",
         "relu", "relup", "cbrt", "logical_not")
BINARY = ("atan2", "kepE", "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
          "logical_or", "add", "sub", "mul", "div", "pow")
TERNARY = ("select", "kepF", "kepDE")


def _random_expr(pkg, seed, depth=4):
    """A seeded random expression over x, y, par[0], time and literals with
    every op that ``diff`` has a rule for; the same seed gives the same
    tree in either package."""
    rng = np.random.default_rng(seed)
    m = pkg.math
    x, y = pkg.make_vars("x", "y")
    leaves = [x, y, pkg.par[0], pkg.time]

    def build(d):
        if d == 0 or rng.uniform() < 0.15:
            k = int(rng.integers(0, len(leaves) + 1))
            return leaves[k] if k < len(leaves) else \
                float(np.round(rng.uniform(-2, 2), 3))
        arity = int(rng.integers(1, 4))
        if arity == 1:
            return getattr(m, UNARY[int(rng.integers(len(UNARY)))])(
                build(d - 1))
        if arity == 2:
            op = BINARY[int(rng.integers(len(BINARY)))]
            a, b = build(d - 1), build(d - 1)
            if op == "add":
                return y + a + b
            if op == "sub":
                return x + a - b
            if op == "mul":
                return y * a * b
            if op == "div":
                return x * a / (y + b)
            if op == "pow":
                return (x + a) ** float(rng.choice([-1.5, -1.0, 0.5, 2.0,
                                                    3.0, 0.3]))
            return getattr(m, op)(a, b)
        op = TERNARY[int(rng.integers(len(TERNARY)))]
        return getattr(m, op)(build(d - 1), build(d - 1), build(d - 1))

    return x + build(depth)


@pytest.mark.parametrize("seed", range(12))
def test_diff_of_random_expressions(seed):
    ej, ep = _random_expr(hy, seed), _random_expr(ht, seed)
    assert repr(ep) == repr(ej)
    for wrt in ("x", "y", "par", "time"):
        aj = {"par": hy.par[0], "time": hy.time}.get(wrt, wrt)
        ap = {"par": ht.par[0], "time": ht.time}.get(wrt, wrt)
        assert repr(ht.diff(ep, ap)) == repr(hy.diff(ej, aj))


def test_diff_refuses_what_jax_refuses():
    x = ht.make_vars("x")
    with pytest.raises(TypeError):
        ht.diff(x * x, 2.0)


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("order", [1, 2])
def test_diff_tensors(name, order):
    sj, sp = SYSTEMS[name](hy), SYSTEMS[name](ht)
    fj, fp = [r for _, r in sj], [r for _, r in sp]
    aj = [v for v, _ in sj] + ([hy.par[0]] if name == "time_pars" else [])
    ap = [v for v, _ in sp] + ([ht.par[0]] if name == "time_pars" else [])
    dj = hy.diff_tensors(fj, aj, diff_order=order)
    dp = ht.diff_tensors(fp, ap, diff_order=order)
    assert (dp.order, dp.nouts, dp.nargs, len(dp)) == \
        (dj.order, dj.nouts, dj.nargs, len(dj))
    assert dp.index_set() == dj.index_set()
    assert [k for k, _ in dp.items()] == [k for k, _ in dj.items()]
    assert [repr(e) for _, e in dp.items()] == [repr(e) for _, e in dj.items()]
    assert dp.get_derivatives_slice(1) == dj.get_derivatives_slice(1)
    assert repr(dp.jacobian()) == repr(dj.jacobian())
    if order == 2:
        assert repr(dp.hessian(0)) == repr(dj.hessian(0))


# -- var_ode_sys ---------------------------------------------------------------


@pytest.mark.parametrize("name", VSYS)
def test_var_ode_sys_is_jax_s(name):
    vj, vp = _vsys(hy, name), _vsys(ht, name)
    assert repr(vp.sys) == repr(vj.sys)
    assert (vp.n_orig, vp.n_vargs, vp.order) == (vj.n_orig, vj.n_vargs,
                                                  vj.order)
    assert repr(vp.vargs) == repr(vj.vargs)
    for i in range(len(vp.sys)):
        assert vp.get_mindex(i) == vj.get_mindex(i)
    for o in range(vp.order + 1):
        assert vp.get_vslice(o) == vj.get_vslice(o)
        for c in range(vp.n_orig):
            assert vp.get_vslice(o, c) == vj.get_vslice(o, c)


@pytest.mark.parametrize("name", ["pendulum_o2", "pcr3bp_o1", "ffnn_params",
                                  "time_pars_all", "time_pars_list"])
def test_initial_state_bit_for_bit(name):
    vj, vp = _vsys(hy, name), _vsys(ht, name)
    rng = np.random.default_rng(3)
    B, n = 5, vp.n_orig
    st = rng.uniform(-1, 1, (B, n))
    n_pars = len(ht.get_params([r for _, r in vp.orig_sys]))
    pars = rng.uniform(-1, 1, (B, n_pars)) if n_pars else None
    t0 = rng.uniform(0, 3, B)
    want = np.stack([vj.initial_state(st[i], pars=None if pars is None
                                      else pars[i], t0=float(t0[i]))
                     for i in range(B)])
    got = vp.initial_state(st, pars=pars, t0=t0)
    np.testing.assert_array_equal(
        vp.initial_state(st[0], pars=None if pars is None else pars[0],
                         t0=float(t0[0])), got[0])
    # the blocks wrt the initial time are -f(x0, t0): torch's sin and cos
    # and XLA's may differ in the last bit, so those hold to 1e-15
    # relative; every other entry bit for bit
    wrt_t = np.array([isinstance(vp.vargs[next(j for j, c in enumerate(k[1])
                                               if c)], ht.TimeExpr)
                      if sum(k[1]) == 1 else False
                      for k, _ in vp.get_dtens().items()])
    np.testing.assert_array_equal(got[:, ~wrt_t], want[:, ~wrt_t])
    np.testing.assert_allclose(got[:, wrt_t], want[:, wrt_t], rtol=1e-15,
                               atol=0)


def test_var_ode_sys_refusals():
    x, v = ht.make_vars("x", "v")
    sys_ = ht.models.pendulum()
    for bad in (dict(order=0), dict(args=[]), dict(args=["z"]),
                dict(args=[x, x])):
        with pytest.raises(ValueError):
            ht.var_ode_sys(sys_, bad.get("args", ht.VarArgs.vars),
                           bad.get("order", 1))
    with pytest.raises(ValueError):
        ht.var_ode_sys([(ht.make_vars("∂x"), v), (v, -x)])
    vs = ht.var_ode_sys(_time_sys(ht), ht.VarArgs.time, 2)
    with pytest.raises(ValueError):
        vs.initial_state([0.1, 0.2])


# -- Lagrangian and Hamiltonian ----------------------------------------------


def _lagham_cases(pkg):
    x, v, p = pkg.make_vars("x", "v", "p")
    q1, q2, v1, v2 = pkg.make_vars("q1", "q2", "v1", "v2")
    return {
        "pendulum": pkg.lagrangian(0.5 * v * v + 9.8 * pkg.cos(x), [x], [v]),
        "dissipation": pkg.lagrangian(0.5 * v * v - 0.5 * 4.0 * x * x, [x],
                                      [v], 0.5 * 0.3 * v * v),
        "hamiltonian": pkg.hamiltonian(0.5 * p * p - 9.8 * pkg.cos(x), [x],
                                       [p]),
        "coupled": pkg.lagrangian(
            0.5 * (v1 * v1 + v2 * v2) + 0.2 * v1 * v2
            - 0.5 * (q1 * q1 + 2.0 * q2 * q2), [q1, q2], [v1, v2]),
        "time": pkg.lagrangian(0.5 * v * v * (1.0 + 0.1 * pkg.sin(pkg.time))
                               - x * x * x, ["x"], ["v"]),
    }


def test_lagrangian_and_hamiltonian_are_jax_s():
    cj, cp = _lagham_cases(hy), _lagham_cases(ht)
    for k in cj:
        assert repr(cp[k]) == repr(cj[k]), k
    # what the JAX functions refuse, the port refuses with the same error:
    # a Lagrangian degenerate in the velocity, repeated coordinates
    for pkg_call in (lambda p, x, v: p.lagrangian(x * v, [x], [v]),
                     lambda p, x, v: p.hamiltonian(x * v, [x, x], [v, v])):
        with pytest.raises(Exception) as ej:
            pkg_call(hy, *hy.make_vars("x", "v"))
        with pytest.raises(ej.type):
            pkg_call(ht, *ht.make_vars("x", "v"))


def test_lagrangian_integrates_as_the_pendulum():
    x, v = ht.make_vars("x", "v")
    sys_ = ht.lagrangian(0.5 * v * v + 9.8 * ht.cos(x), [x], [v])
    ta = ht.taylor_adaptive(sys_, [0.05, 0.025], tol=1e-15, device="cpu")
    ref = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025], tol=1e-15,
                             device="cpu")
    ta.propagate_until(5.0)
    ref.propagate_until(5.0)
    np.testing.assert_allclose(ta.state, ref.state, atol=1e-13)


# -- the variational batch and scalar on the three routes --------------------

#: route -> (variational system of ``VSYS``, the route's jet on the CPU)
ROUTES = {
    "b2": ("pcr3bp_o1", "jet_plain"),
    "b3": ("cr3bp_o1", "jet_rolled_plain"),
    "b4_pendulum": ("pendulum_o2", "phase_plain"),
    "b4_ffnn": ("ffnn_params", "phase_plain"),
}


def _lanes(route, B=3):
    rng = np.random.default_rng(11)
    vs = VSYS[ROUTES[route][0]][0]
    base = {"pcr3bp": PCR3BP_IC, "cr3bp": CR3BP_IC,
            "pendulum": np.array([0.05, 0.025]),
            "ffnn": np.array([0.3, -0.2])}[vs]
    st = base[None] + 1e-3 * rng.standard_normal((B, base.size))
    pars = None
    if vs == "ffnn":
        n = ht.models.ffnn_par_count(2, [4], 2)
        pars = np.tile(0.3 * rng.standard_normal(n), (B, 1))
    return st, pars


@pytest.fixture
def rolled_route(monkeypatch):
    monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)


@pytest.fixture(scope="module")
def jax_batch():
    """Per route: the JAX flat batch's state, Taylor maps (shared and per
    lane deviations) and ``get_tstate`` after ``propagate_until(T_END)``,
    and the deviations used."""
    cache = {}

    def get(route):
        if route not in cache:
            st, pars = _lanes(route)
            vj = _vsys(hy, ROUTES[route][0])
            tb = hy.taylor_adaptive_batch(vj, st, pars=pars, tol=1e-15,
                                          high_accuracy=True,
                                          compact_mode="flat")
            zeros = np.array(tb.get_tstate())
            tb.propagate_until(T_END)
            K = vj.n_vargs
            rng = np.random.default_rng(5)
            d1 = 1e-4 * rng.standard_normal(K)
            dB = 1e-4 * rng.standard_normal((st.shape[0], K))
            cache[route] = dict(
                zeros=zeros, state=np.array(tb.state),
                tm1=np.array(tb.eval_taylor_map(d1)),
                tmB=np.array(tb.eval_taylor_map(dB)),
                tstate=np.array(tb.get_tstate()), d1=d1, dB=dB,
                n_orig=tb.get_n_orig_sv(), vargs=repr(tb.get_vargs()))
        return cache[route]

    return get


@pytest.mark.parametrize("route", ROUTES)
def test_var_batch_against_jax(jax_batch, route, request):
    if route == "b3":
        request.getfixturevalue("rolled_route")
    ref = jax_batch(route)
    st, pars = _lanes(route)
    tb = ht.taylor_adaptive_batch(_vsys(ht, ROUTES[route][0]), st, pars=pars,
                                  tol=1e-15, high_accuracy=True, device="cpu")
    tb.assert_engine(jet=ROUTES[route][1])
    assert tb.is_variational and tb.get_n_orig_sv() == ref["n_orig"]
    assert repr(tb.get_vargs()) == ref["vargs"]
    np.testing.assert_array_equal(tb.get_tstate(), ref["zeros"])
    oc = tb.propagate_until(T_END)[0]
    assert all(o == ht.TaylorOutcome.time_limit for o in oc)
    _close(tb.state, ref["state"])
    _close(tb.eval_taylor_map(ref["d1"]), ref["tm1"])
    _close(tb.eval_taylor_map(ref["dB"]), ref["tmB"])
    _close(tb.get_tstate(), ref["tstate"])
    with pytest.raises(ValueError):
        tb.eval_taylor_map(np.zeros(tb.dim))


def test_var_batch_step_and_getters():
    vs = _vsys(ht, "pcr3bp_o1")
    st, _ = _lanes("b2")
    tb = ht.taylor_adaptive_batch(vs, st, tol=1e-15, device="cpu")
    assert tb.dim == len(vs.sys) == 20 and tb.get_vorder() == 1
    assert tb.sys[4][0].name == vs.sys[4][0].name
    np.testing.assert_array_equal(tb.state[:, tb.get_vslice(1)],
                                  np.tile(np.eye(4).ravel(), (3, 1)))
    tb.step()
    assert tb.get_mindex(4) == vs.get_mindex(4)
    # an integrator without a var_ode_sys has none of it
    plain = ht.taylor_adaptive_batch(ht.models.pcr3bp(mu=MU), st,
                                     device="cpu")
    assert not plain.is_variational and plain.get_n_orig_sv() == 4
    for f, a in ((plain.get_vargs, ()), (plain.get_vorder, ()),
                 (plain.get_vslice, (1,)), (plain.get_mindex, (0,)),
                 (plain.eval_taylor_map, ([0.0] * 4,)),
                 (plain.get_tstate, ())):
        with pytest.raises(ValueError):
            f(*a)


@pytest.fixture(scope="module")
def jax_scalar():
    """Per route: the JAX scalar's (compact_mode=True) state, Taylor map
    and ``get_tstate`` after ``propagate_until(T_END)`` from lane 0."""
    cache = {}

    def get(route):
        if route not in cache:
            st, pars = _lanes(route)
            vj = _vsys(hy, ROUTES[route][0])
            ta = hy.taylor_adaptive(vj, st[0], pars=None if pars is None
                                    else pars[0], tol=1e-15,
                                    high_accuracy=True, compact_mode=True)
            zeros = np.array(ta.get_tstate())
            ta.propagate_until(T_END)
            d = 1e-4 * np.arange(1, vj.n_vargs + 1)
            cache[route] = dict(zeros=zeros, state=np.array(ta.state), d=d,
                                tm=np.array(ta.eval_taylor_map(d)),
                                tstate=np.array(ta.get_tstate()))
        return cache[route]

    return get


@pytest.mark.parametrize("route", ["b2", "b4_pendulum"])
def test_var_scalar_against_jax(jax_scalar, route):
    ref = jax_scalar(route)
    st, pars = _lanes(route)
    vs = _vsys(ht, ROUTES[route][0])
    ta = ht.taylor_adaptive(vs, st[0], tol=1e-15, high_accuracy=True,
                            device="cpu")
    ta.assert_engine(jet=ROUTES[route][1])
    assert ta.is_variational() and ta.get_vorder() == vs.order
    assert ta.get_n_orig_sv() == vs.n_orig and ta.dim == len(vs.sys)
    assert ta.get_vslice(1) == vs.get_vslice(1)
    assert ta.get_mindex(3) == vs.get_mindex(3)
    np.testing.assert_array_equal(ta.get_tstate(), ref["zeros"])
    ta.propagate_until(T_END)
    _close(ta.state, ref["state"])
    _close(ta.eval_taylor_map(ref["d"]), ref["tm"])
    _close(ta.get_tstate(), ref["tstate"])
    with pytest.raises(ValueError):
        ta.eval_taylor_map(ref["d"][:1])
    plain = ht.taylor_adaptive(ht.models.pendulum(), [0.1, 0.0],
                               device="cpu")
    assert not plain.is_variational() and plain.get_n_orig_sv() == 2
    with pytest.raises(ValueError, match="non-variational"):
        plain.get_vargs()


def test_var_scalar_is_a_batch_lane():
    vs = _vsys(ht, "pcr3bp_o1")
    st, _ = _lanes("b2")
    tb = ht.taylor_adaptive_batch(vs, st[:1], tol=1e-15, device="cpu")
    ta = ht.taylor_adaptive(vs, st[0], tol=1e-15, device="cpu")
    full = vs.initial_state(st[0])
    tb.propagate_until(1.0)
    ta.propagate_until(1.0)
    np.testing.assert_array_equal(ta.state, tb.state[0])
    np.testing.assert_array_equal(ta.eval_taylor_map([1e-3, 0, 0, 0]),
                                  tb.eval_taylor_map([1e-3, 0, 0, 0])[0])
    # given the whole augmented state, no augmentation
    tf = ht.taylor_adaptive(vs, full, tol=1e-15, device="cpu")
    np.testing.assert_array_equal(tf.state, full)


def test_var_pickling():
    vs = _vsys(ht, "pendulum_o2")
    st, _ = _lanes("b4_pendulum")
    tb = ht.taylor_adaptive_batch(vs, st, tol=1e-15, device="cpu")
    tb.propagate_until(1.0)
    d = [1e-3, -2e-3]
    mapped = tb.eval_taylor_map(d)
    tb2 = pickle.loads(pickle.dumps(tb))
    assert tb2.is_variational and tb2.get_vorder() == 2
    assert tb2.get_vslice(2) == tb.get_vslice(2)
    np.testing.assert_array_equal(tb2.state, tb.state)
    np.testing.assert_array_equal(tb2.eval_taylor_map(d), mapped)
    ta = ht.taylor_adaptive(vs, st[0], tol=1e-15, device="cpu")
    ta.propagate_until(1.0)
    ta2 = pickle.loads(pickle.dumps(ta))
    assert ta2.is_variational() and ta2.get_mindex(5) == ta.get_mindex(5)
    np.testing.assert_array_equal(ta2.eval_taylor_map(d),
                                  ta.eval_taylor_map(d))
    tb2.propagate_until(2.0)
    tb.propagate_until(2.0)
    np.testing.assert_array_equal(tb2.state, tb.state)


# -- the variational ensemble --------------------------------------------------


def test_var_ensemble_against_jax():
    vj, vp = _vsys(hy, "pcr3bp_o1"), _vsys(ht, "pcr3bp_o1")
    st, _ = _lanes("b2", B=4)
    full = vp.initial_state(st)
    tj = hy.taylor_adaptive_batch(vj, st[:2], tol=1e-15, high_accuracy=True,
                                  compact_mode="flat")
    tp = ht.taylor_adaptive_batch(vp, st[:2], tol=1e-15, high_accuracy=True,
                                  device="cpu")
    gen_b = {"state": full.reshape(2, 2, -1)}
    rj = hy.ensemble_propagate_until_batch(tj, T_END, 2, gen_b)
    rp = ht.ensemble_propagate_until_batch(tp, T_END, 2, gen_b)
    _close(rp["state"].numpy(), np.asarray(rj["state"]))
    sl = tp.get_vslice(1)
    stm = rp["state"].numpy().reshape(4, -1)[:, sl].reshape(4, 4, 4)
    np.testing.assert_allclose(np.linalg.det(stm), 1.0, atol=1e-10)
    # the scalar template, against the JAX scalar template's ensemble and
    # every instance its own scalar run
    ta = ht.taylor_adaptive(vp, st[0], tol=1e-15, high_accuracy=True,
                            device="cpu")
    rs = ht.ensemble_propagate_until(ta, T_END, 4, {"state": full})
    assert ta.is_variational() and ta.get_vslice(1) == sl
    tsj = hy.taylor_adaptive(vj, st[0], tol=1e-15, high_accuracy=True,
                             compact_mode=True)
    rsj = hy.ensemble_propagate_until(tsj, T_END, 4, {"state": full})
    _close(rs["state"].numpy(), np.asarray(rsj["state"]))
    _close(rs["state"].numpy(), rp["state"].numpy().reshape(4, -1))
    for i in (0, 3):
        one = ht.taylor_adaptive(vp, st[i], tol=1e-15, high_accuracy=True,
                                 device="cpu")
        one.propagate_until(T_END)
        _close(rs["state"][i, sl].numpy(), one.state[sl], atol=5e-14)
