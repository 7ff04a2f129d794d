"""The port's native host runtime (``heyoka_tpu_torch.native``,
``native_cg``, ``backend="native"``): the cases of ``tests/test_native.py``
and ``tests/test_native_backend.py`` on the port, held against what of
the JAX package needs no JAX native runtime (its ``backend="jax"``
integrators, its XLA jets, ``native_cg.generate_cpp`` text and
``pack_tape`` arrays), and the port's build rules.  The port's runtime
is compiled once for the file (a module fixture; warm, it is loaded from
``build/heyoka_tpu_torch/native``).

Tolerances: the native jets against XLA's at 1e-13 relative (the JAX
test's); states of a native integrator against the JAX ``"jax"`` one at
1e-12 (absolute on the pendulum's O(0.1) state), outcomes equal, step
counts equal without a sub-ulp landing step (``_main_steps``, as
``tests/test_torch_prop.py`` counts them); the grid and the dense output
at 1e-12; energy drift 1e-12; long double and ``__float128`` as the JAX
test states them.  The interpreter and the compiled stepper run the same
recurrences, summed in other orders (the compiler vectorizes and
contracts the stepper's into FMAs): the high orders' norms, hence the
steps, differ by ~1e-13 relative on the 3-body tape, so steps and states
agree to 1e-12 relative."""

import ctypes
import os
import pickle
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu import native_cg as hy_cg
from heyoka_tpu.expr.decompose import taylor_decompose_sys as hy_decompose
from heyoka_tpu.taylor.jet import make_jet_fn

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import _build, native, native_cg, s11n
from heyoka_tpu_torch.taylor.jet_kernels import LAUNCHES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IC = [0.05, 0.025]
#: states of the port's native integrators against the JAX "jax" ones
STATE_TOL = 1e-12
TOL = 1e-15


@pytest.fixture(scope="module", autouse=True)
def runtime():
    """The port's runtime, built (or loaded) once for the file."""
    assert native.native_available(), native.build_error()
    return native._lib()


def _pend(pkg):
    x, v = pkg.make_vars("x", "v")
    return [(x, v), (v, -9.8 * pkg.sin(x))]


def _systems(pkg):
    """The op cases of ``tests/test_native.py`` and a 3-body problem, by
    name: ``(system, state, pars)``."""
    x, y = pkg.make_vars("x", "y")
    return {
        "pendulum": (pkg.models.pendulum(), [0.05, 0.025], []),
        "trig": ([(x, pkg.sin(x) * pkg.cos(y) + pkg.tan(0.3 * x)),
                  (y, pkg.exp(-y) + pkg.atan2(x, y) + x ** -1.5)],
                 [0.7, 1.3], []),
        "kepler": ([(x, pkg.kepE(0.3, y) + pkg.sigmoid(x)),
                    (y, pkg.sqrt(x) + pkg.log(y) + pkg.erf(x)
                     + pkg.kepF(0.1, 0.2, x) + pkg.kepDE(0.1, 0.2, y))],
                   [1.2, 0.8], []),
        "par_time": ([(x, pkg.par[0] * pkg.asin(0.2 * x) + pkg.time),
                      (y, pkg.tanh(x * y))], [0.4, 0.6], [1.3]),
        "nbody3": (pkg.models.nbody(3, masses=[1.0, 1e-3, 2e-3]),
                   [0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1.5, 0, -0.8,
                    0, 0], []),
    }


def _main_steps(ns, last_h, t):
    """Step counts without a final sub-ulp landing step
    (``tests/test_torch_prop.py`` ``_main_steps``)."""
    ns = np.atleast_1d(np.asarray(ns)).copy()
    tiny = np.abs(np.atleast_1d(last_h)) < 4 * np.spacing(
        np.abs(np.atleast_1d(t)))
    return ns - tiny


# -- the files and the build -------------------------------------------------

def test_taperun_is_byte_identical():
    with open(os.path.join(REPO, "heyoka_tpu", "_native", "taperun.cpp"),
              "rb") as f:
        assert native.SOURCE.read_bytes() == f.read()


def test_runtime_builds_in_the_port_build_dir(runtime):
    so = native.library_path()
    assert so.parent == _build.build_dir() / "native" == native.native_dir()
    assert so.name.startswith("taperun_") and so.exists()
    assert so.with_suffix(".log").exists()
    assert "heyoka_tpu" not in so.parent.relative_to(
        _build.build_dir()).parts
    # the JAX package's cache is never touched by the port's build
    assert ".cache" not in so.parts


def test_temporaries_carry_the_pid(tmp_path, monkeypatch):
    # a compiler that logs its arguments, then compiles
    log = tmp_path / "argv"
    cxx = tmp_path / "cxx"
    cxx.write_text(f'#!/bin/sh\necho "$@" > {log}\nexec g++ "$@"\n')
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    src = tmp_path / "f.cpp"
    src.write_text('extern "C" int f() { return 7; }\n')
    monkeypatch.setenv("CXX", str(cxx))
    out = tmp_path / "lib" / "f.so"
    native.compile_shared(src, out, ["-O2", "-shared", "-fPIC"])
    argv = log.read_text().split()
    assert argv[argv.index("-o") + 1] == str(
        out.parent / f"f.so.{os.getpid()}.tmp")
    assert ctypes.CDLL(str(out)).f() == 7
    assert sorted(p.name for p in out.parent.iterdir()) == ["f.log", "f.so"]


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho no compiler here >&2\nexit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "_build_dir", tmp_path / "b")
    native._lib.cache_clear()
    try:
        assert not native.native_available()
        assert "no compiler here" in native.build_error()
        for mk in (ht.taylor_adaptive, ht.taylor_adaptive_batch):
            st = IC if mk is ht.taylor_adaptive else [IC]
            with pytest.raises(RuntimeError, match="requires a host C"):
                mk(_pend(ht), st, backend="native")
        with pytest.raises(RuntimeError, match="no compiler here"):
            native.native_jet(ht.taylor_decompose_sys(_pend(ht)), IC, [],
                              0.0, 5)
        # the device route does not need it
        assert ht.taylor_adaptive(_pend(ht), IC, device="cpu",
                                  backend="auto").backend == "device"
    finally:
        monkeypatch.undo()
        native._lib.cache_clear()
        native._build_err = None
    assert native.native_available()


def test_a_failing_codegen_compile_raises(tmp_path, monkeypatch):
    # the compiled stepper's compiler fails: no quiet fall back to the
    # interpreter (the JAX class falls back on any exception)
    monkeypatch.setattr(_build, "_build_dir", tmp_path / "b")
    monkeypatch.setenv("HEYOKA_CG_OPT", "-O2 -fno-such-option")
    with pytest.raises(RuntimeError, match="no-such-option"):
        ht.taylor_adaptive_batch(_pend(ht), [IC], backend="native")


@pytest.mark.parametrize("case", ["float32", "nt_event", "t_event"])
def test_float32_and_events_are_refused(case):
    v = ht.make_vars("v")
    kw = {"float32": dict(dtype=np.float32),
          "nt_event": dict(nt_events=[ht.nt_event(v, lambda *a: None)]),
          "t_event": dict(t_events=[ht.t_event(v)])}[case]
    for mk, st in ((ht.taylor_adaptive, IC),
                   (ht.taylor_adaptive_batch, [IC])):
        with pytest.raises(ValueError, match="float64 without events"):
            mk(_pend(ht), st, backend="native", **kw)


@pytest.mark.parametrize("kind", ["scalar", "batch"])
def test_auto_stays_on_the_device(kind):
    # the JAX "auto" picks the native runtime where it can; the port's
    # "auto" is the device (no auto-detection)
    mk = ht.taylor_adaptive if kind == "scalar" else ht.taylor_adaptive_batch
    st = IC if kind == "scalar" else [IC]
    for backend in ("jax", "auto"):
        ta = mk(_pend(ht), st, device="cpu", backend=backend)
        assert ta.backend == "device"
        assert "native" not in ta.engine_report()["propagate_engine"]
    ta = mk(_pend(ht), st, backend="native")
    assert ta.backend == "native"
    assert ta.engine_report()["propagate_engine"] == "native-cg"


def test_s11n_cache_leaves_the_native_libraries_alone(tmp_path,
                                                      monkeypatch):
    # host libraries built for this CPU are no cache entries: not listed,
    # not packed, not trimmed
    d = tmp_path / "kernels"
    (d / "native").mkdir(parents=True)
    lib = d / "native" / native.library_path().name
    lib.write_bytes(native.library_path().read_bytes())
    (d / f"{_build.LIB_PREFIX}aaaa.so").write_bytes(b"x" * 10)
    monkeypatch.setattr(_build, "_build_dir", d)
    monkeypatch.setattr(_build, "_loaded", None)
    assert native.native_dir() == d / "native"
    assert [os.path.basename(p) for _, _, p in s11n.cache_entries()] == [
        f"{_build.LIB_PREFIX}aaaa.so"]
    assert s11n.pack_cache(str(tmp_path / "c.tar.gz")) == 1
    s11n.clear_cache()
    assert lib.exists() and not (d / f"{_build.LIB_PREFIX}aaaa.so").exists()


# -- the tape encoding and the generated code ---------------------------------

@pytest.mark.parametrize("name", ["pendulum", "trig", "par_time", "nbody3"])
@pytest.mark.parametrize("W", [1, 8])
def test_generate_cpp_matches_jax(name, W):
    # the JAX module's text, but for the braced lane loop of the
    # convolutions (the port's fix: native_cg._conv; the sigmoid's is on
    # the "kepler" tape below)
    pt = ht.taylor_decompose_sys(_systems(ht)[name][0])
    jt = hy_decompose(_systems(hy)[name][0])
    a = native_cg.generate_cpp(pt, 9, W)
    b = hy_cg.generate_cpp(jt, 9, W)
    fixed = [ln.replace("for (int l=0;l<W;++l) C(", "for (int l=0;l<W;++l) "
                        "{ C(", 1).replace("; }", "; } }", 1)
             if ln.startswith("    for (int l=0;l<W;++l) C(")
             and "(s[l])" in ln else ln for ln in b.split("\n")]
    assert a == "\n".join(fixed)
    assert native_cg._tape_digest(pt, 9, W) == hy_cg._tape_digest(jt, 9, W)
    for k, v in native.pack_tape(pt).items():
        np.testing.assert_array_equal(v, hy.native.pack_tape(jt)[k])


def test_codegen_takes_the_sigmoid():
    # the JAX generate_cpp raises KeyError on a sigmoid (its "pair"); the
    # port's reads the square column and emits the tape
    tj = hy_decompose(_systems(hy)["kepler"][0])
    with pytest.raises(KeyError):
        hy_cg.generate_cpp(tj, 9, 8)
    src = native_cg.generate_cpp(
        ht.taylor_decompose_sys(_systems(ht)["kepler"][0]), 9, 8)
    assert "std::exp" in src


@pytest.mark.parametrize("name", ["pendulum", "trig", "kepler", "par_time",
                                  "nbody3"])
def test_compiled_stepper_matches_the_interpreter(name):
    # every op of the cases through both host engines: 8 lanes, 5 steps
    sys_, st, pars = _systems(ht)[name]
    tape = ht.taylor_decompose_sys(sys_)
    rng = np.random.default_rng(3)
    sts = np.asarray(st, float) * (1 + 1e-3 * rng.standard_normal((8, len(st))))
    pr = np.tile(np.asarray(pars, float), (8, 1))
    cg = native_cg.CompiledTape(tape, 12, W=8)
    rt = native.NativeRuntime(tape)
    a, b = sts.copy(), sts.copy()
    ta, tb_, la, lb = (np.zeros(8) for _ in range(4))
    for _ in range(5):
        ha, _ = cg.step_batch(a, pr, ta, la, np.full(8, np.inf))
        hb, _ = rt.step_batch(b, pr, tb_, lb, np.full(8, np.inf), 12)
        np.testing.assert_allclose(ha, hb, rtol=1e-12)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


# -- the runtime's functions against the XLA jets and the JAX integrator --------

@pytest.mark.parametrize("name", ["pendulum", "trig", "kepler", "par_time"])
def test_native_jet_matches_xla(name):
    sys_j, st, pars = _systems(hy)[name]
    a = np.asarray(make_jet_fn(hy_decompose(sys_j), 9)(
        jnp.asarray(np.asarray(st, float)),
        jnp.asarray(np.asarray(pars, float)), jnp.asarray(0.3)))
    tape = ht.taylor_decompose_sys(_systems(ht)[name][0])
    b = native.native_jet(tape, st, pars, 0.3, 9)[:, :a.shape[1]]
    np.testing.assert_allclose(b, a, rtol=1e-13, atol=1e-15)


@pytest.fixture(scope="module")
def jax_scalar():
    """The JAX pendulum on its "jax" backend, to t = 50 and on to 60 over a
    grid, with its states on the way."""
    tj = hy.taylor_adaptive(_pend(hy), IC, tol=TOL)
    out = {"step": tj.step()}
    out["state1"] = np.asarray(tj.state)
    out["res"] = tj.propagate_until(50.0)
    out["state50"] = np.asarray(tj.state)
    out["last_h"] = float(tj.last_h)
    out["d"] = np.asarray(tj.update_d_output(tj.time - 0.25 * tj.last_h))
    out["grid"] = np.asarray(tj.propagate_grid(np.linspace(50.0, 60.0,
                                                           21))[4])
    return out


def test_native_propagate_matches_integrator(jax_scalar):
    tape = ht.taylor_decompose_sys(ht.models.pendulum())
    st, t, ns = native.native_propagate_until(tape, IC, [], 0.0, 50.0,
                                              ht.taylor_order_from_tol(TOL))
    assert t == pytest.approx(50.0, abs=1e-12) and ns > 100
    np.testing.assert_allclose(st, jax_scalar["state50"], rtol=0,
                               atol=STATE_TOL)


def test_native_nbody_energy():
    sys_, st0, _ = _systems(ht)["nbody3"]
    st0 = np.asarray(st0, float)
    cf = ht.make_cfunc([ht.models.nbody_energy(3, masses=[1.0, 1e-3, 2e-3])],
                       vars=[lhs for lhs, _ in sys_], device="cpu")
    e0 = float(cf(st0)[0])
    st, t, ns = native.native_propagate_until(ht.taylor_decompose_sys(sys_),
                                              st0, [], 0.0, 20.0, 20)
    assert abs((float(cf(st)[0]) - e0) / e0) < 1e-12


def test_native_max_steps_and_nonfinite():
    tape = ht.taylor_decompose_sys(ht.models.pendulum())
    st, t, ns = native.native_propagate_until(tape, IC, [], 0.0, 1000.0, 20,
                                              max_steps=5)
    assert ns == 5 and t < 1000.0
    x = ht.make_vars("x")
    with pytest.raises(FloatingPointError):
        native.native_propagate_until(ht.taylor_decompose_sys([(x, x * x)]),
                                      [1.0], [], 0.0, 10.0, 20)


def test_native_propagate_until_batch():
    tape = ht.taylor_decompose_sys(ht.models.pendulum())
    states = 0.05 + 0.01 * np.random.default_rng(0).standard_normal((8, 2))
    st, tm, ns = native.native_propagate_until_batch(tape, states, None, 0.0,
                                                     10.0, 19)
    np.testing.assert_allclose(tm, 10.0, atol=1e-12)
    for i in (0, 3, 7):
        s1, t1, n1 = native.native_propagate_until(tape, states[i], None,
                                                   0.0, 10.0, 19)
        np.testing.assert_array_equal(st[i], s1)
        assert int(ns[i]) == n1
    tj = hy.taylor_adaptive(hy.models.pendulum(), states[0], tol=TOL)
    tj.propagate_until(10.0)
    np.testing.assert_allclose(st[0], tj.state, rtol=0, atol=5e-14)


def test_native_extended_precision():
    tape = ht.taylor_decompose_sys(ht.models.pendulum())
    jd = native.native_jet(tape, IC, None, 0.0, 15)
    jl = native.native_jet_ld(tape, IC, None, 0.0, 15)
    np.testing.assert_allclose(jl.astype(np.float64), jd, rtol=5e-15,
                               atol=1e-18)
    s0 = np.array(IC, np.longdouble)
    s1, t1, _ = native.native_propagate_until_ld(tape, s0, None, 0.0, 1000.0,
                                                 26)
    s2, _, _ = native.native_propagate_until_ld(tape, s1, None, t1, 0.0, 26)
    err_ld = float(np.abs(s2 - s0).max())
    sd1, td1, _ = native.native_propagate_until(tape, IC, None, 0.0, 1000.0,
                                                20)
    sd2, _, _ = native.native_propagate_until(tape, sd1, None, td1, 0.0, 20)
    err_d = float(np.abs(sd2 - np.array(IC)).max())
    assert err_ld < err_d / 50 and err_ld < 1e-16


def test_native_quad_precision_and_multiprec():
    # the pendulum 0 -> 200 -> 0 in __float128, and the f128 jet against
    # the port's 40-digit multiprec jet
    mp = pytest.importorskip("mpmath")
    from heyoka_tpu_torch.multiprec import MPTaylorIntegrator

    tape = ht.taylor_decompose_sys(ht.models.pendulum())
    hi, lo, th, tl, _ = native.native_propagate_until_f128(tape, IC, None,
                                                           0.0, 200.0, 40)
    p = native.pack_tape(tape)
    th2, tl2 = ctypes.c_double(th), ctypes.c_double(tl)
    native._lib().ht_propagate_until_f128(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], hi, lo, np.zeros(1), ctypes.byref(th2), ctypes.byref(tl2),
        0.0, np.inf, np.int64(0), np.int32(40))
    assert hi[0] == 0.05 and hi[1] == 0.025
    assert max(abs((hi[0] - 0.05) + lo[0]), abs((hi[1] - 0.025) + lo[1])) \
        < 1e-30
    m2 = MPTaylorIntegrator(tape, IC, dps=40, order=12)
    with mp.workdps(40):
        m2._t = m2.time
        cc = m2._jet()
    jh, jl = native.native_jet_f128(tape, IC, None, 0.0, 12)
    for k in range(13):
        for i in range(2):
            q = float(jh[k, i]) + float(jl[k, i])
            assert abs(q - float(cc[k][i])) <= 1e-30 + 1e-15 * abs(q)


# -- backend="native" on the scalar integrator ----------------------------------

@pytest.fixture(params=["cg", "interp"])
def engine(request, monkeypatch):
    """The compiled stepper, or the interpreter (``HEYOKA_NATIVE_CG=0``)."""
    if request.param == "interp":
        monkeypatch.setenv("HEYOKA_NATIVE_CG", "0")
    return request.param


def test_scalar_step_and_propagate_parity(jax_scalar, engine):
    LAUNCHES.clear()
    ta = ht.taylor_adaptive(_pend(ht), IC, tol=TOL, backend="native")
    assert ta.engine_report()["propagate_engine"] == f"native-{engine}"
    assert ta._tb._ncg is None or ta._tb._ncg.W == 1
    oc, h = ta.step()
    assert oc == jax_scalar["step"][0]
    assert h == pytest.approx(jax_scalar["step"][1], rel=1e-14)
    np.testing.assert_allclose(ta.state, jax_scalar["state1"], rtol=0,
                               atol=1e-15)
    res, rj = ta.propagate_until(50.0), jax_scalar["res"]
    assert res[0] == rj[0]
    assert _main_steps(res[3], ta.last_h, ta.time) == \
        _main_steps(rj[3], jax_scalar["last_h"], 50.0)
    np.testing.assert_allclose(ta.state, jax_scalar["state50"], rtol=0,
                               atol=STATE_TOL)
    assert ta.time == 50.0
    d = ta.update_d_output(ta.time - 0.25 * ta.last_h)
    np.testing.assert_allclose(d, jax_scalar["d"], rtol=0, atol=STATE_TOL)
    out = ta.propagate_grid(np.linspace(50.0, 60.0, 21))[4]
    np.testing.assert_allclose(out, jax_scalar["grid"], rtol=0,
                               atol=STATE_TOL)
    # the host route launches nothing and keeps its lanes on the host
    assert not any(LAUNCHES.values())
    assert ta._tb._state.device.type == "cpu" and ta.device.type == "cpu"


def test_scalar_step_limit_and_backward():
    ta = ht.taylor_adaptive(_pend(ht), IC, tol=TOL, backend="native")
    oc, mn, mx, ns = ta.propagate_until(1000.0, max_steps=3)
    assert oc == ht.TaylorOutcome.step_limit and ns == 3
    ta2 = ht.taylor_adaptive(_pend(ht), IC, tol=TOL, backend="native")
    assert ta2.propagate_until(-5.0)[0] == ht.TaylorOutcome.time_limit
    assert ta2.time == -5.0
    tj = hy.taylor_adaptive(_pend(hy), IC, tol=TOL)
    tj.propagate_until(-5.0)
    np.testing.assert_allclose(ta2.state, tj.state, rtol=0, atol=STATE_TOL)


def test_scalar_cout_parity():
    ta = ht.taylor_adaptive(_pend(ht), IC, tol=TOL, backend="native")
    tj = hy.taylor_adaptive(_pend(hy), IC, tol=TOL)
    c = ta.propagate_until(8.0, c_output=True)[4]
    cj = tj.propagate_until(8.0, c_output=True)[4]
    ts = np.linspace(0.3, 7.7, 9)
    np.testing.assert_allclose(np.asarray(c(ts)), np.asarray(cj(ts)),
                               rtol=0, atol=STATE_TOL)


def test_scalar_callback_and_pickle():
    seen = []
    ta = ht.taylor_adaptive(_pend(ht), IC, tol=TOL, backend="native")
    oc, mn, mx, ns = ta.propagate_until(
        5.0, callback=lambda t: seen.append(t.time) or True)
    assert oc == ht.TaylorOutcome.time_limit and len(seen) == ns
    ta2 = pickle.loads(pickle.dumps(ta))
    assert ta2.backend == "native"
    np.testing.assert_array_equal(ta2.state, ta.state)
    assert ta2.time == ta.time
    # a callback that stops
    oc, *_ = ta2.propagate_until(10.0, callback=lambda t: t.time < 7.0)
    assert oc == ht.TaylorOutcome.cb_stop and 7.0 <= ta2.time < 10.0


def test_scalar_high_accuracy():
    ta = ht.taylor_adaptive(_pend(ht), IC, tol=TOL, high_accuracy=True,
                            backend="native")
    tj = hy.taylor_adaptive(_pend(hy), IC, tol=TOL, high_accuracy=True)
    ta.propagate_until(20.0)
    tj.propagate_until(20.0)
    np.testing.assert_allclose(ta.state, tj.state, rtol=0, atol=STATE_TOL)


def test_native_nonfinite_outcome():
    # 1/x through x = 0, the division the JAX codegen leaves to the
    # interpreter: here the compiled stepper takes it
    x = ht.make_vars("x")
    ta = ht.taylor_adaptive([(x, -1.0 / x)], [1.0], tol=1e-12,
                            backend="native")
    assert ta.engine_report()["native_fallback"] is None
    assert ta.propagate_until(10.0)[0] == ht.TaylorOutcome.err_nf_state


# -- backend="native" on the batch --------------------------------------------

B = 8


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(1)
    return np.tile(IC, (B, 1)) + rng.uniform(-1e-3, 1e-3, (B, 2))


@pytest.fixture(scope="module")
def jax_batch(lanes):
    tj = hy.taylor_adaptive_batch(_pend(hy), lanes, tol=TOL)
    tj.step()
    out = {"step_res": tj.get_step_res(), "state1": np.asarray(tj.state)}
    out["res"] = tj.propagate_until(np.full(B, 30.0))
    out["state30"] = np.asarray(tj.state)
    out["last_h"] = np.asarray(tj.last_h)
    out["d"] = np.asarray(tj.update_d_output(tj.time - 0.25 * tj.last_h))
    out["grid"] = np.asarray(tj.propagate_grid(np.linspace(30.0, 36.0,
                                                           13))[4])
    return out


def test_batch_parity(lanes, jax_batch, engine):
    LAUNCHES.clear()
    tb = ht.taylor_adaptive_batch(_pend(ht), lanes, tol=TOL, backend="native")
    assert tb.backend == "native"
    assert tb.engine_report()["propagate_engine"] == f"native-{engine}"
    assert tb._ncg is None or tb._ncg.W == 8
    tb.step()
    for (oca, ha), (ocb, hb) in zip(tb.get_step_res(),
                                    jax_batch["step_res"]):
        assert oca == ocb and ha == pytest.approx(hb, rel=1e-14)
    np.testing.assert_allclose(tb.state, jax_batch["state1"], rtol=0,
                               atol=1e-15)
    res, rj = tb.propagate_until(np.full(B, 30.0)), jax_batch["res"]
    assert list(res[0]) == list(rj[0])
    np.testing.assert_array_equal(
        _main_steps(res[3], tb.last_h, tb.time),
        _main_steps(rj[3], jax_batch["last_h"], np.full(B, 30.0)))
    np.testing.assert_allclose(tb.state, jax_batch["state30"], rtol=0,
                               atol=STATE_TOL)
    assert (tb.time == 30.0).all()
    assert tb.get_propagate_res()[0][3] == res[3][0]
    d = tb.update_d_output(tb.time - 0.25 * tb.last_h)
    np.testing.assert_allclose(d, jax_batch["d"], rtol=0, atol=STATE_TOL)
    out = tb.propagate_grid(np.linspace(30.0, 36.0, 13))[4]
    np.testing.assert_allclose(out, jax_batch["grid"], rtol=0,
                               atol=STATE_TOL)
    assert not any(LAUNCHES.values())


def test_compiled_and_interpreted_agree(lanes, monkeypatch):
    a = ht.taylor_adaptive_batch(_pend(ht), lanes, tol=TOL, backend="native")
    monkeypatch.setenv("HEYOKA_NATIVE_CG", "0")
    b = ht.taylor_adaptive_batch(_pend(ht), lanes, tol=TOL, backend="native")
    assert b.native_fallback == "HEYOKA_NATIVE_CG=0"
    ra, rb = a.propagate_until(20.0), b.propagate_until(20.0)
    np.testing.assert_array_equal(ra[3], rb[3])
    np.testing.assert_allclose(a.state, b.state, rtol=0, atol=1e-12)


def test_unsupported_tape_falls_back_and_says_so(lanes, jax_batch,
                                                 monkeypatch):
    # codegen's size limit: the one fallback, recorded
    monkeypatch.setattr(native_cg.CompiledTape, "MAX_STMTS", 1)
    tb = ht.taylor_adaptive_batch(_pend(ht), lanes, tol=TOL, backend="native")
    assert tb.native_fallback.startswith("codegen: tape too large")
    assert tb.engine_report()["propagate_engine"] == "native-interp"
    tb.step()
    np.testing.assert_allclose(tb.state, jax_batch["state1"], rtol=0,
                               atol=1e-15)


def test_batch_cout_and_pickle(lanes):
    tb = ht.taylor_adaptive_batch(_pend(ht), lanes, tol=TOL, backend="native")
    tj = hy.taylor_adaptive_batch(_pend(hy), lanes, tol=TOL)
    c = tb.propagate_until(8.0, c_output=True)[4]
    cj = tj.propagate_until(8.0, c_output=True)[4]
    ts = np.linspace(0.3, 7.7, 5)
    np.testing.assert_allclose(
        np.asarray(c(np.tile(ts[:, None], (1, B)))),
        np.asarray([cj(np.full(B, t)) for t in ts]), rtol=0, atol=STATE_TOL)
    tb2 = pickle.loads(pickle.dumps(tb))
    assert tb2.backend == "native"
    np.testing.assert_array_equal(tb2.state, tb.state)
    np.testing.assert_array_equal(tb2.time, tb.time)
    tb.propagate_until(9.0)
    tb2.propagate_until(9.0)
    np.testing.assert_array_equal(tb2.state, tb.state)


def test_batch_step_limit_and_callbacks(lanes):
    tb = ht.taylor_adaptive_batch(_pend(ht), lanes, tol=TOL, backend="native")
    res = tb.propagate_until(np.full(B, 1000.0), max_steps=3)
    assert all(oc == ht.TaylorOutcome.step_limit for oc in res[0])
    assert (res[3] == 3).all()
    # an in-graph step callback runs on the host, per lane
    ar = ht.AngleReducer(["x"])
    tj = ht.taylor_adaptive_batch(_pend(ht), tb.state, tol=TOL,
                                  time=tb.time, device="cpu")
    tb.propagate_until(30.0, callback=ar)
    tj.propagate_until(30.0, callback=ht.AngleReducer(["x"]))
    np.testing.assert_allclose(tb.state, tj.state, rtol=0, atol=STATE_TOL)


def test_batch_variational(lanes):
    # a var_ode_sys on the host: the STM and the Taylor map against the JAX
    # batch on its "jax" backend
    vp = ht.var_ode_sys(ht.models.pendulum(), ht.VarArgs.vars, 1)
    vj = hy.var_ode_sys(hy.models.pendulum(), hy.VarArgs.vars, 1)
    tb = ht.taylor_adaptive_batch(vp, lanes[:2], tol=TOL, backend="native")
    tj = hy.taylor_adaptive_batch(vj, lanes[:2], tol=TOL)
    tb.propagate_until(3.0)
    tj.propagate_until(3.0)
    np.testing.assert_allclose(tb.state, tj.state, rtol=0, atol=1e-11)
    np.testing.assert_allclose(tb.eval_taylor_map([1e-3, -1e-3]),
                               tj.eval_taylor_map([1e-3, -1e-3]), rtol=0,
                               atol=1e-11)


def test_the_lanes_never_touch_the_card():
    # device="cuda" (the default) is ignored: a native integrator builds
    # and runs on a host without CUDA
    tb = ht.taylor_adaptive_batch(_pend(ht), [IC], backend="native")
    assert tb._device.type == "cpu" and tb.engine_report()["device"] == "cpu"
    tb.propagate_until(1.0)
    with pytest.raises(ValueError, match="on the host"):
        type(tb)._sharing(tb, tb.state, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ht.taylor_adaptive_batch(_pend(ht), [IC])
