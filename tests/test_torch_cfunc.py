"""The port's compiled functions (``cfunc``, ``make_cfunc``: f64 torch on
the CPU here) against the JAX package's (``jax.jit`` of the same tape) on
seeded numpy inputs: the cases of ``tests/test_cfunc.py`` (single and
multi evaluation, parameters and time, per-evaluation parameters and
times, the default variable order, the Kepler ops), every op of the tape
and the models' invariants.  Results within 1e-15 of the JAX results'
largest magnitude, 1e-14 for the Newton-based Kepler ops and for atanh
(XLA's own error; the port's holds to numpy's at 1e-15); the
properties, ``repr`` and pickling; a tensor on another device raises."""

import math
import pickle

import numpy as np
import pytest
import torch

import heyoka_tpu as hy

import heyoka_tpu_torch as ht

RTOL = 1e-15
NEWTON_RTOL = 1e-14


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _pair(build, **kw):
    """The JAX and the port's cfunc of ``build(pkg) -> (fns, vars)``."""
    fj, vj = build(hy)
    fp, vp = build(ht)
    return (hy.make_cfunc(fj, vars=vj, **kw),
            ht.make_cfunc(fp, vars=vp, device="cpu", **kw))


def test_single_eval():
    def build(pkg):
        x, y = pkg.make_vars("x", "y")
        return [x * y + pkg.sin(x), x - y], [x, y]

    cj, cp = _pair(build)
    out = cp(np.array([0.5, 2.0]))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out[0] == 0.5 * 2.0 + math.sin(0.5) and out[1] == -1.5
    _close(out, cj(np.array([0.5, 2.0])))


def test_multi_eval():
    def build(pkg):
        x, y = pkg.make_vars("x", "y")
        return [pkg.exp(x) * y, pkg.atan2(y, x)], [x, y]

    cj, cp = _pair(build)
    pts = np.random.default_rng(0).standard_normal((64, 2)) + 2.0
    out = cp(pts)
    assert out.shape == (64, 2)
    _close(out, cj(pts))
    # a tensor on the cfunc's device goes in as it is
    _close(cp(torch.as_tensor(pts)), cj(pts))


def test_pars_and_time():
    def build(pkg):
        x = pkg.make_vars("x")
        return [pkg.par[0] * x + pkg.time], [x]

    cj, cp = _pair(build)
    assert cp(np.array([2.0]), pars=np.array([3.0]), time=5.0)[0] == 11.0
    _close(cp(np.array([2.0]), pars=[3.0], time=5.0),
           cj(np.array([2.0]), pars=np.array([3.0]), time=5.0))


def test_default_var_order():
    def build(pkg):
        a, b = pkg.make_vars("a", "b")
        return [b - a], None

    cj, cp = _pair(build)
    assert cp.n_vars == cj.n_vars == 2 and cp.vars == cj.vars == ["a", "b"]
    assert cp(np.array([1.0, 5.0]))[0] == 4.0


def test_kepler_ops():
    def build(pkg):
        e, M, h, k = pkg.make_vars("e", "M", "h", "k")
        m = pkg.math
        return [m.kepE(e, M), m.kepF(h, k, M), m.kepDE(h, k, M)], [e, M, h, k]

    cj, cp = _pair(build)
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(0, 0.9, 256), rng.uniform(-10, 10, 256),
                    rng.uniform(-0.4, 0.4, 256), rng.uniform(-0.4, 0.4, 256)],
                   1)
    out = cp(pts)
    _close(out, cj(pts), NEWTON_RTOL)
    E = out[:, 0].numpy()
    np.testing.assert_allclose(E - pts[:, 0] * np.sin(E), pts[:, 1],
                               rtol=0, atol=1e-12)


def test_batch_pars():
    def build(pkg):
        x = pkg.make_vars("x")
        return [pkg.par[0] * x], [x]

    cj, cp = _pair(build)
    xs, ps = np.array([[1.0], [2.0]]), np.array([[10.0], [20.0]])
    np.testing.assert_array_equal(cp(xs, pars=ps)[:, 0], [10.0, 40.0])
    _close(cp(xs, pars=ps), cj(xs, pars=ps))


def test_multi_eval_time_array():
    def build(pkg):
        x = pkg.make_vars("x")
        return [x * pkg.time + pkg.sin(pkg.time) + pkg.par[0]], ["x"]

    cj, cp = _pair(build)
    rng = np.random.default_rng(2)
    X, T = rng.standard_normal((33, 1)), rng.uniform(0, 3, 33)
    P = rng.standard_normal((33, 1))
    _close(cp(X, time=T)[:, 0], X[:, 0] * T + np.sin(T))
    _close(cp(X, time=T), cj(X, time=T))
    # per-evaluation parameters and times together, and shared parameters
    _close(cp(X, pars=P, time=T), cj(X, pars=P, time=T))
    _close(cp(X, pars=P[0], time=T), cj(X, pars=P[0], time=T))
    with pytest.raises(ValueError):
        cp(X, time=T[:5])


#: every op of the tape's rule set with inputs in its domain: name ->
#: (expression of x, y in [0.1, 0.9]) over the package's math module
OPS = {
    "sin": lambda m, x, y: m.sin(x * 3.0), "cos": lambda m, x, y: m.cos(x),
    "tan": lambda m, x, y: m.tan(x), "asin": lambda m, x, y: m.asin(x),
    "acos": lambda m, x, y: m.acos(x), "atan": lambda m, x, y: m.atan(x),
    "atan2": lambda m, x, y: m.atan2(y - 0.5, x - 0.5),
    "sinh": lambda m, x, y: m.sinh(x), "cosh": lambda m, x, y: m.cosh(x),
    "tanh": lambda m, x, y: m.tanh(x * 2.0 - 1.0),
    "asinh": lambda m, x, y: m.asinh(x), "acosh": lambda m, x, y: m.acosh(
        1.0 + x), "atanh": lambda m, x, y: m.atanh(x - 0.5),
    "exp": lambda m, x, y: m.exp(x), "log": lambda m, x, y: m.log(x),
    "sqrt": lambda m, x, y: m.sqrt(x), "cbrt": lambda m, x, y: m.cbrt(x),
    "erf": lambda m, x, y: m.erf(x), "sigmoid": lambda m, x, y: m.sigmoid(x),
    "relu": lambda m, x, y: m.relu(x - 0.5),
    "relup": lambda m, x, y: m.relup(x - 0.5),
    "select": lambda m, x, y: m.select(m.gt(x, y), x, y * y),
    "relational": lambda m, x, y: m.lt(x, y) + m.le(x, y) + m.ge(x, y)
    + m.eq(x, 0.5) + m.ne(y, 0.5),
    "logical": lambda m, x, y: m.logical_and(m.lt(x, 0.5), m.gt(y, 0.5))
    + m.logical_or(m.lt(x, 0.2), m.gt(y, 0.8)) + m.logical_not(m.gt(x, y)),
    "div": lambda m, x, y: x / (y + 0.1) - 2.0 / x,
    "sum_prod": lambda m, x, y: x * y * (x + y + 1.0) * 3.0 - y,
}
POWS = (-1.0, 0.5, -0.5, -1.5, 1.5, 2.0, 3.0, -2.0, 7.0, 0.3, -2.7)


@pytest.mark.parametrize("op", [*OPS, "pow"])
def test_every_op(op):
    def build(pkg):
        x, y = pkg.make_vars("x", "y")
        if op == "pow":
            return [(x + y) ** a for a in POWS], [x, y]
        return [OPS[op](pkg.math, x, y)], [x, y]

    cj, cp = _pair(build)
    pts = np.random.default_rng(3).uniform(0.1, 0.9, (257, 2))
    if op == "atanh":
        # XLA's CPU atanh is a few ulps off the correctly rounded value
        # on these inputs, torch's is not: the port holds to numpy's
        # arctanh at 1e-15, to the JAX result at 1e-14
        _close(cp(pts)[:, 0], np.arctanh(pts[:, 0] - 0.5))
        _close(cp(pts), cj(pts), NEWTON_RTOL)
        return
    _close(cp(pts), cj(pts))


def _invariants(pkg):
    """The CR3BP's Jacobi constant and the outer Solar System's energy."""
    from heyoka_tpu_torch.tools import GCONST, MASSES

    jac = pkg.models.cr3bp_jacobi(mu=0.01)
    en = pkg.models.nbody_energy(6, masses=MASSES, Gconst=GCONST)
    sys_ = pkg.models.nbody(6, masses=MASSES, Gconst=GCONST)
    return jac, en, [v for v, _ in sys_]


def test_model_invariants():
    jj, ej, vej = _invariants(hy)
    jp, ep, vep = _invariants(ht)
    rng = np.random.default_rng(4)
    names = ["px", "py", "pz", "x", "y", "z"]
    pts = rng.uniform(-1, 1, (100, 6))
    cj = hy.make_cfunc([jj], vars=[hy.make_vars(n) for n in names])
    cp = ht.make_cfunc([jp], vars=names, device="cpu")
    _close(cp(pts), cj(pts))
    from heyoka_tpu_torch.tools import IC

    st = IC[None] * (1.0 + 1e-3 * rng.standard_normal((50, 36)))
    cj = hy.make_cfunc([ej], vars=vej)
    cp = ht.make_cfunc([ep], vars=vep, device="cpu")
    _close(cp(st), cj(st))


def test_properties_repr_and_pickling():
    def build(pkg):
        x, y = pkg.make_vars("x", "y")
        return [x * pkg.par[1] + pkg.cos(y), pkg.time * y], [y, x]

    cj, cp = _pair(build)
    assert (cp.n_vars, cp.n_outs, cp.n_pars) == (cj.n_vars, cj.n_outs,
                                                cj.n_pars) == (2, 2, 2)
    assert cp.vars == cj.vars == ["y", "x"]
    assert repr(cp.fn) == repr(cj.fn)
    assert repr(cp.dc.ops) == repr(cj.dc.ops)
    assert repr(cp) == ("cfunc(n_vars=2, n_outs=2, n_pars=2, dtype=float64, "
                        "device=cpu)")
    cp2 = pickle.loads(pickle.dumps(cp))
    pts = np.random.default_rng(5).standard_normal((9, 2))
    np.testing.assert_array_equal(cp2(pts, pars=[0.5, 2.0], time=1.5),
                                  cp(pts, pars=[0.5, 2.0], time=1.5))
    assert cp2.device == cp.device and cp2.vars == cp.vars


def test_refusals():
    x = ht.make_vars("x")
    cp = ht.make_cfunc([x * ht.par[0]], vars=[x], device="cpu")
    with pytest.raises(ValueError, match="lies on meta"):
        cp(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        cp(np.zeros(3))  # one variable
    with pytest.raises(ValueError):
        cp(np.zeros((4, 1)), pars=np.zeros((3, 1)))
    with pytest.raises(ValueError, match="float64 or float32"):
        ht.make_cfunc([x], device="cpu", dtype=np.float16)
    assert ht.make_cfunc([x], device="cpu", dtype=np.float32)(
        [2.0]).dtype == torch.float32
    with pytest.raises(ValueError):
        ht.make_cfunc([x * ht.make_vars("y")], vars=[x], device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card, and nothing falls back
        with pytest.raises(RuntimeError, match="cuda"):
            ht.make_cfunc([x])
