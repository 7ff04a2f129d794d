"""The native CPU runtime: the JAX package's C++ tape interpreter, on the
host, behind ``backend="native"``.

The port's copy of ``heyoka_tpu/native.py`` (reference: heyoka's
integrators are native compiled steppers, ``src/taylor_adaptive.cpp``).
It builds (once) and loads ``_native/taperun.cpp``, a byte-identical copy
of the JAX package's runtime, through ``ctypes``, and packs decomposition
tapes of the port's front end (``expr.decompose``) into its flat
encoding.  It runs on the host CPU alone: no tensor, no device.

Public surface, the JAX module's:

- :func:`native_available`: True when the runtime compiled and loaded;
- :func:`pack_tape`: a tape in the runtime's encoding (also what
  :mod:`.multiprec` interprets);
- :class:`NativeRuntime`: a packed tape's per-step and whole-propagation
  drivers, one lane or many (OpenMP over lanes), the engine of
  ``backend="native"`` where :mod:`.native_cg` cannot generate code;
- :func:`native_jet`, :func:`native_propagate_until`,
  :func:`native_propagate_until_batch` in f64, ``*_ld`` in long double
  and ``*_f128`` in ``__float128`` (double-double across the boundary).

The build: ``$CXX`` (default ``g++``) with the JAX package's flags
(``-O3 -march=native -shared -fPIC -std=gnu++17 -fopenmp``, linked with
``-lquadmath``), into ``native/`` under the port's build directory
(``_build.build_dir()``: ``build/heyoka_tpu_torch`` of the checkout, which
``.gitignore`` lists, until ``s11n.enable_compilation_cache`` moves it),
never into the JAX package's ``~/.cache/heyoka_tpu``.  The library's name
carries a hash of the source, compiler and flags, and each build writes a
temporary tagged with its pid before renaming it into place, so processes
building at once never share a file.  Departure: where the JAX ``_lib``
returns None without a word, :func:`build_error` keeps the compiler's
message, which ``backend="native"`` raises with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from . import _build
from .expr.decompose import Tape

#: the runtime's source, a byte-identical copy of the JAX package's
SOURCE = Path(__file__).resolve().parent / "_native" / "taperun.cpp"
#: the runtime's compile flags (``heyoka_tpu/native.py:52-56``)
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=gnu++17",
             "-fopenmp")
#: the compiler's message of the last failed build (None: none failed)
_build_err: str | None = None

#: the most operands an op may have
_MAXA = 8

#: op name -> the runtime's opcode (``taperun.cpp`` ``OpCode``)
_OPCODES = {
    "sum": 0, "mul": 1, "div": 2, "pow": 3, "sin": 4, "cos": 5, "sinh": 6,
    "cosh": 7, "tan": 8, "tanh": 9, "exp": 10, "log": 11, "sqrt": 12,
    "sigmoid": 13, "asin": 14, "acos": 15, "atan": 16, "asinh": 17,
    "acosh": 18, "atanh": 19, "erf": 20, "atan2": 21, "relu": 22,
    "relup": 23, "select": 24, "lt": 25, "le": 26, "gt": 27, "ge": 28,
    "eq": 29, "ne": 30, "logical_and": 31, "logical_or": 32,
    "logical_not": 33, "kepE": 34, "kepF": 35, "kepDE": 36,
}


def native_dir() -> Path:
    """Where the host libraries are built: ``native/`` under the port's
    build directory (:func:`.._build.build_dir`)."""
    return _build.build_dir() / "native"


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def compile_shared(src: Path, out: Path, flags, libs=()) -> None:
    """Compile ``src`` into the shared library ``out`` with ``$CXX`` and
    ``flags`` (then ``libs``), through a temporary tagged with this
    process's pid, renamed into place; the compiler's output goes to
    ``out``'s ``.log``.  Raises RuntimeError when the compiler is missing
    or fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [_cxx(), *flags, str(src), "-o", str(tmp), *libs]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} could not run: {e}") from e
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + r.stdout
                                       + r.stderr)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed with exit code {r.returncode}:"
                           f"\n{r.stderr[:2000]}")
    os.replace(tmp, out)


def library_path() -> Path:
    """The runtime's library for the current source, compiler and flags."""
    h = hashlib.sha256(" ".join((_cxx(), *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return native_dir() / f"taperun_{h.hexdigest()[:16]}.so"


def build_error() -> str | None:
    """Why the runtime did not build (the compiler's message), None when
    it built or no build was tried."""
    return _build_err


@lru_cache(maxsize=1)
def _lib():
    """Compile (if needed) and load the native runtime; None when it does
    not build (:func:`build_error` says why) or load."""
    global _build_err
    so = library_path()
    if not so.exists():
        try:
            compile_shared(SOURCE, so, CXX_FLAGS, ("-lquadmath",))
        except RuntimeError as e:
            _build_err = str(e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _build_err = str(e)
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.ht_jet.restype = None
    lib.ht_jet.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        f64p, f64p, ctypes.c_double, ctypes.c_int32, f64p,
    ]
    lib.ht_propagate_until.restype = ctypes.c_int64
    lib.ht_propagate_until.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        f64p, f64p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
    ]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    ldp = np.ctypeslib.ndpointer(np.longdouble, flags="C")
    lib.ht_jet_ld.restype = None
    lib.ht_jet_ld.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        ldp, ldp, ctypes.c_longdouble, ctypes.c_int32, ldp,
    ]
    lib.ht_propagate_until_ld.restype = ctypes.c_int64
    lib.ht_propagate_until_ld.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        ldp, ldp, ctypes.POINTER(ctypes.c_longdouble),
        ctypes.c_longdouble, ctypes.c_longdouble, ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.ht_jet_f128.restype = None
    lib.ht_jet_f128.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        f64p, f64p, f64p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, f64p, f64p,
    ]
    lib.ht_propagate_until_f128.restype = ctypes.c_int64
    lib.ht_propagate_until_f128.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        f64p, f64p, f64p,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.ht_propagate_until_batch.restype = None
    lib.ht_propagate_until_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        ctypes.c_int32, f64p, f64p, f64p, f64p,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32, i64p,
    ]
    lib.ht_step2.restype = ctypes.c_double
    lib.ht_step2.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        f64p, f64p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_int32,
        ctypes.c_int32, f64p,
    ]
    lib.ht_propagate_until2.restype = ctypes.c_int64
    lib.ht_propagate_until2.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        f64p, f64p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f64p, f64p,
    ]
    lib.ht_step_batch.restype = None
    lib.ht_step_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        ctypes.c_int32, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_int32, ctypes.c_int32, f64p, f64p,
    ]
    lib.ht_propagate_until2_batch.restype = None
    lib.ht_propagate_until2_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, f64p, f64p, ctypes.c_int32, i32p,
        ctypes.c_int32, f64p, f64p, f64p, f64p, f64p, f64p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        f64p, f64p, i64p,
    ]
    return lib


def native_available() -> bool:
    """True when the runtime built and loaded."""
    return _lib() is not None


def _unavailable() -> str:
    return ("native runtime unavailable (no C++ compiler?): "
            f"{build_error() or 'it did not load'}")


def pack_tape(tape: Tape):
    """Flatten a decomposition tape into the native runtime's encoding.

    Operand codes: ``u`` columns as their index, literals ``-1 - i`` (the
    ``i``-th distinct constant), parameters ``-1000000 - i``, the time
    ``-2000000``."""
    if tape.rhs is None:
        raise ValueError("pack_tape requires an ODE tape")
    n_ops = len(tape.ops)
    consts: list[float] = []
    cmap: dict[float, int] = {}

    def code(operand) -> int:
        kind = operand[0]
        if kind == "u":
            return int(operand[1])
        if kind == "c":
            v = float(operand[1])
            if v not in cmap:
                cmap[v] = len(consts)
                consts.append(v)
            return -1 - cmap[v]
        if kind == "p":
            return -1000000 - int(operand[1])
        if kind == "t":
            return -2000000
        raise ValueError(operand)

    opcodes = np.zeros(n_ops, np.int32)
    arity = np.zeros(n_ops, np.int32)
    inputs = np.zeros((n_ops, _MAXA), np.int32)
    meta = np.full((n_ops, 2), -1, np.int32)
    alpha = np.zeros(n_ops, np.float64)
    for i, op in enumerate(tape.ops):
        if op.op not in _OPCODES:
            raise NotImplementedError(
                f"op {op.op!r} is not supported by the native runtime"
            )
        if len(op.inputs) > _MAXA:
            raise NotImplementedError(
                f"native runtime supports arity <= {_MAXA}; op {op.op!r} has "
                f"{len(op.inputs)} (decompose with sum splitting)"
            )
        opcodes[i] = _OPCODES[op.op]
        arity[i] = len(op.inputs)
        for a, operand in enumerate(op.inputs):
            inputs[i, a] = code(operand)
        if "pair" in op.meta:
            meta[i, 0] = int(op.meta["pair"])
        if "sq" in op.meta:
            meta[i, 0] = int(op.meta["sq"])
        if "sin" in op.meta:
            meta[i, 0] = int(op.meta["sin"])
            meta[i, 1] = int(op.meta["cos"])
        if op.op == "pow":
            alpha[i] = float(op.meta["alpha"])
    rhs = np.array([code(o) for o in tape.rhs], np.int32)
    return dict(
        n_eq=np.int32(tape.n_eq),
        n_ops=np.int32(n_ops),
        n_pars=np.int32(tape.n_pars),
        opcodes=opcodes,
        arity=arity,
        inputs=np.ascontiguousarray(inputs),
        meta=np.ascontiguousarray(meta),
        alpha=alpha,
        consts=np.asarray(consts if consts else [0.0], np.float64),
        n_consts=np.int32(len(consts) if consts else 1),
        rhs=rhs,
    )


class NativeRuntime:
    """Packed-tape handle for the native CPU runtime: pack once, then run
    per-step / whole-propagation drivers without re-encoding the tape.

    The execution backend of ``taylor_adaptive(..., backend="native")``
    (reference: heyoka's integrators ARE native compiled steppers,
    ``src/taylor_adaptive.cpp``; here the native runtime is the low-latency
    host twin of the XLA/Pallas device engines).
    """

    def __init__(self, tape: Tape):
        lib = _lib()
        if lib is None:
            raise RuntimeError(_unavailable())
        self._lib = lib
        self._tape = tape
        self._p = pack_tape(tape)
        self.n_eq = int(tape.n_eq)
        self.n_uvars = int(tape.n_uvars)
        self.n_pars = int(tape.n_pars)

    def _targs(self):
        p = self._p
        return (p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"],
                p["arity"], p["inputs"], p["meta"], p["alpha"], p["consts"],
                p["n_consts"], p["rhs"])

    def _pars(self, pars):
        if pars is None or np.size(pars) == 0:
            return np.zeros((1,), np.float64)
        return np.ascontiguousarray(pars, np.float64)

    def step(self, state, pars, t_hi: float, t_lo: float, max_dt: float,
             order: int, high_accuracy: bool = False):
        """One adaptive step.  ``state`` (numpy, modified in place);
        returns (h, t_hi, t_lo, cc) with cc the (order+1, n_uvars)
        normalized Taylor-coefficient jet."""
        cc = np.empty(((order + 1) * self.n_uvars,), np.float64)
        th = ctypes.c_double(float(t_hi))
        tl = ctypes.c_double(float(t_lo))
        h = self._lib.ht_step2(
            *self._targs(), state, self._pars(pars), ctypes.byref(th),
            ctypes.byref(tl), float(max_dt), np.int32(order),
            np.int32(bool(high_accuracy)), cc,
        )
        return (float(h), th.value, tl.value,
                cc.reshape(order + 1, self.n_uvars))

    def propagate_until(self, state, pars, t_hi: float, t_lo: float,
                        target: float, order: int, *,
                        max_delta_t: float = np.inf, max_steps: int = 0,
                        high_accuracy: bool = False):
        """Whole adaptive propagation in one native call.  ``state``
        (numpy) is updated in place; returns
        (nsteps, t_hi, t_lo, min_h, max_h, last_h, last_cc); nsteps < 0
        flags a non-finite state after |nsteps| steps; last_cc is the last
        accepted step's (order+1, n_uvars) normalized Taylor jet."""
        th = ctypes.c_double(float(t_hi))
        tl = ctypes.c_double(float(t_lo))
        stats = np.zeros((3,), np.float64)
        cc = np.zeros(((order + 1) * self.n_uvars,), np.float64)
        steps = self._lib.ht_propagate_until2(
            *self._targs(), state, self._pars(pars), ctypes.byref(th),
            ctypes.byref(tl), float(target), float(max_delta_t),
            np.int64(max_steps), np.int32(order),
            np.int32(bool(high_accuracy)), stats, cc,
        )
        return (int(steps), th.value, tl.value, float(stats[0]),
                float(stats[1]), float(stats[2]),
                cc.reshape(order + 1, self.n_uvars))

    def step_batch(self, states, pars, t_his, t_los, max_dts, order: int,
                   high_accuracy: bool = False):
        """One adaptive step in every lane (OpenMP).  ``states`` (B, n_eq),
        ``t_his``/``t_los`` (B,) are modified in place; returns (hs, ccs)
        with ccs (B, order+1, n_uvars)."""
        batch = states.shape[0]
        ccs = np.empty((batch, order + 1, self.n_uvars), np.float64)
        hs = np.empty((batch,), np.float64)
        self._lib.ht_step_batch(
            *self._targs(), np.int32(batch), states,
            self._batch_pars(pars, batch), t_his, t_los,
            np.ascontiguousarray(max_dts, np.float64), np.int32(order),
            np.int32(bool(high_accuracy)), ccs.reshape(-1), hs,
        )
        return hs, ccs

    def propagate_until_batch(self, states, pars, t_his, t_los, targets,
                              order: int, *, max_delta_t=np.inf,
                              max_steps: int = 0,
                              high_accuracy: bool = False):
        """Batched whole propagation (OpenMP over lanes); ``states``,
        ``t_his``, ``t_los`` updated in place; ``max_delta_t`` may be a
        scalar or per-lane; returns (steps (B,), h_stats (B, 3),
        last_ccs (B, order+1, n_uvars))."""
        batch = states.shape[0]
        stats = np.zeros((batch, 3), np.float64)
        steps = np.zeros((batch,), np.int64)
        ccs = np.zeros((batch, order + 1, self.n_uvars), np.float64)
        mdts = np.ascontiguousarray(
            np.broadcast_to(np.asarray(max_delta_t, np.float64), (batch,)))
        self._lib.ht_propagate_until2_batch(
            *self._targs(), np.int32(batch), states,
            self._batch_pars(pars, batch), t_his, t_los,
            np.ascontiguousarray(targets, np.float64), mdts,
            np.int64(max_steps), np.int32(order),
            np.int32(bool(high_accuracy)), stats.reshape(-1),
            ccs.reshape(-1), steps,
        )
        return steps, stats, ccs

    def _batch_pars(self, pars, batch):
        if pars is None or np.size(pars) == 0:
            return np.zeros((batch, 1), np.float64)
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(pars, np.float64),
                            (batch, max(1, self.n_pars))))


def native_jet(tape: Tape, state, pars, t: float, order: int) -> np.ndarray:
    """Normalized Taylor coefficients (order+1, n_uvars) via the native
    runtime."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    n_u = tape.n_uvars
    out = np.zeros(((order + 1), n_u), np.float64)
    state = np.ascontiguousarray(state, np.float64)
    pars = np.ascontiguousarray(
        pars if pars is not None and len(pars) else [0.0], np.float64
    )
    lib.ht_jet(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], state, pars, float(t), np.int32(order),
        out.reshape(-1),
    )
    return out


def native_propagate_until(
    tape: Tape, state, pars, t0: float, target: float, order: int,
    *, max_delta_t: float = np.inf, max_steps: int = 0,
):
    """Adaptive Taylor propagation entirely on the host CPU; returns
    (state, time, nsteps)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    state = np.array(state, np.float64)
    pars = np.ascontiguousarray(
        pars if pars is not None and len(pars) else [0.0], np.float64
    )
    t = ctypes.c_double(float(t0))
    steps = lib.ht_propagate_until(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], state, pars, ctypes.byref(t), float(target),
        float(max_delta_t), np.int64(max_steps), np.int32(order),
    )
    if steps < 0:
        raise FloatingPointError(
            f"non-finite state after {-steps} steps at t={t.value}"
        )
    return state, t.value, int(steps)


def native_propagate_until_batch(
    tape: Tape, states, pars, t0, targets, order: int,
    *, max_delta_t: float = np.inf, max_steps: int = 0,
):
    """Thread-parallel batched adaptive propagation on the host CPU
    (the native analog of the reference's batch mode: independent
    trajectories over an OpenMP pool); returns (states, times, nsteps)
    with per-lane step counts (negative where the state went non-finite).
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    states = np.array(states, np.float64, order="C")
    batch = states.shape[0]
    if pars is None or np.size(pars) == 0:
        pars = np.zeros((batch, 1), np.float64)
    pars = np.ascontiguousarray(
        np.broadcast_to(np.asarray(pars, np.float64),
                        (batch, max(1, p["n_pars"]))))
    times = np.ascontiguousarray(
        np.broadcast_to(np.asarray(t0, np.float64), (batch,)).copy()
    )
    targets = np.ascontiguousarray(
        np.broadcast_to(np.asarray(targets, np.float64), (batch,))
    )
    steps = np.zeros((batch,), np.int64)
    lib.ht_propagate_until_batch(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], np.int32(batch), states, pars, times, targets,
        float(max_delta_t), np.int64(max_steps), np.int32(order),
        steps,
    )
    return states, times, steps


def native_jet_ld(tape: Tape, state, pars, t, order: int) -> np.ndarray:
    """Extended-precision (80-bit long double) Taylor coefficients —
    the native analog of the reference's tut_extended_precision support
    (TPUs cap at emulated f64; the host runtime does not)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    n_u = tape.n_uvars
    out = np.zeros(((order + 1), n_u), np.longdouble)
    state = np.ascontiguousarray(state, np.longdouble)
    pars = np.ascontiguousarray(
        pars if pars is not None and len(pars) else [0.0], np.longdouble
    )
    lib.ht_jet_ld(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], state, pars, np.longdouble(t), np.int32(order),
        out.reshape(-1),
    )
    return out


def native_propagate_until_ld(
    tape: Tape, state, pars, t0, target, order: int,
    *, max_delta_t=np.inf, max_steps: int = 0,
):
    """Extended-precision adaptive Taylor propagation on the host CPU;
    returns (state (longdouble), time (longdouble), nsteps).

    The appropriate order for long double comes from
    ``taylor_order_from_tol(1.1e-19)`` (~26); tolerances below double
    epsilon are exactly the reason this backend exists.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    state = np.array(state, np.longdouble)
    pars = np.ascontiguousarray(
        pars if pars is not None and len(pars) else [0.0], np.longdouble
    )
    t = ctypes.c_longdouble(np.longdouble(t0))
    steps = lib.ht_propagate_until_ld(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], state, pars, ctypes.byref(t), np.longdouble(target),
        np.longdouble(max_delta_t), np.int64(max_steps), np.int32(order),
    )
    if steps < 0:
        raise FloatingPointError(
            f"non-finite state after {-steps} steps at t={t.value}"
        )
    return state, np.longdouble(t.value), int(steps)


def native_jet_f128(tape: Tape, state, pars, t, order: int):
    """Quad-precision (__float128) Taylor coefficients; inputs/outputs
    cross the boundary as double-double (hi, lo) pairs (~106 of 113 bits);
    internal arithmetic is full quad — the f128 tier of the reference's
    arbitrary-precision support. Returns (cc_hi, cc_lo)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    n_u = tape.n_uvars
    hi = np.zeros(((order + 1), n_u), np.float64)
    lo = np.zeros_like(hi)
    st = np.ascontiguousarray(state, np.float64)
    st_lo = np.zeros_like(st)
    pars = np.ascontiguousarray(
        pars if pars is not None and len(pars) else [0.0], np.float64
    )
    lib.ht_jet_f128(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], st, st_lo, pars, float(t), 0.0, np.int32(order),
        hi.reshape(-1), lo.reshape(-1),
    )
    return hi, lo


def native_propagate_until_f128(
    tape: Tape, state, pars, t0, target, order: int,
    *, max_delta_t=np.inf, max_steps: int = 0,
):
    """Quad-precision adaptive Taylor propagation on the host CPU; returns
    (state_hi, state_lo, time_hi, time_lo, nsteps).  The appropriate order
    for f128 comes from ``taylor_order_from_tol(1.9e-34)`` (~40)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(_unavailable())
    p = pack_tape(tape)
    hi = np.array(state, np.float64)
    lo = np.zeros_like(hi)
    pars = np.ascontiguousarray(
        pars if pars is not None and len(pars) else [0.0], np.float64
    )
    th = ctypes.c_double(float(t0))
    tl = ctypes.c_double(0.0)
    steps = lib.ht_propagate_until_f128(
        p["n_eq"], p["n_ops"], p["n_pars"], p["opcodes"], p["arity"],
        p["inputs"], p["meta"], p["alpha"], p["consts"], p["n_consts"],
        p["rhs"], hi, lo, pars, ctypes.byref(th), ctypes.byref(tl),
        float(target), float(max_delta_t), np.int64(max_steps),
        np.int32(order),
    )
    if steps < 0:
        raise FloatingPointError(
            f"non-finite state after {-steps} steps at t={th.value}"
        )
    return hi, lo, th.value, tl.value, int(steps)
