"""Native code generation: decomposition tape -> specialized C++ stepper
(the port's copy of ``heyoka_tpu/native_cg.py``: :func:`generate_cpp`
emits the JAX module's text for the same tape, order and width).

Reference parity: this is the rebuild's analog of heyoka's *non-compact
mode* — straight-line code specialized to one tape at one order, compiled
to native machine code (``src/taylor_02.cpp`` ``taylor_compute_jet``
non-compact path; ``src/taylor_00.cpp`` step assembly).  Where heyoka
builds LLVM IR in-process and JITs it (``llvm_state::compile``), here the
generator emits C++ and AOT-compiles it with the system toolchain into a
cached shared object — same pipeline, different compiler driver.  SIMD
batching follows the reference's batch mode: every emitted statement is a
``W``-lane loop over a lane-interleaved coefficient layout, which the host
compiler vectorizes onto AVX/NEON exactly like heyoka's explicit LLVM
vector types (``llvm_state.hpp:59-110``).

The interpreter runtime (``_native/taperun.cpp``) stays as the generic
fallback (its per-op dispatch costs ~10x); the compiled stepper is used by
``taylor_adaptive(..., backend="native")`` whenever code generation
supports the tape and a host compiler is present.

Unrolled statements scale as ``n_ops * order``; generation+compilation is
cached on disk keyed by (tape encoding, order, W, flags), in ``native/``
under the port's build directory (``native.native_dir()``), through
temporaries tagged with the pid (``native.compile_shared``).  Departure:
:class:`CompiledTape` raises :class:`_Unsupported` for a tape codegen
cannot take and RuntimeError for a compiler that fails; the integrators
fall back to the interpreter on the first only (the JAX package on
either).
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from .expr.decompose import Tape
from .native import _cxx, compile_shared, native_dir, pack_tape

_CG_VERSION = 4  # bump to invalidate cached .so files

# ---------------------------------------------------------------------------
# C++ emission
# ---------------------------------------------------------------------------

_PREAMBLE = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

inline double nt_kepE(double ecc, double M) {
    const double twopi = 2 * std::acos(-1.0);
    const double tol = 10 * std::numeric_limits<double>::epsilon();
    double Mr = M - twopi * std::floor(M / twopi);
    double E = Mr + 0.85 * ecc * (std::sin(Mr) >= 0 ? 1.0 : -1.0);
    for (int it = 0; it < 100; ++it) {
        const double f = E - ecc * std::sin(E) - Mr;
        const double fp = 1 - ecc * std::cos(E);
        const double d = f / fp;
        E -= d;
        if (std::fabs(d) < tol) break;
    }
    return E + (M - Mr);
}

inline double nt_kepF(double h, double kk, double lam) {
    const double twopi = 2 * std::acos(-1.0);
    const double tol = 10 * std::numeric_limits<double>::epsilon();
    double lr = lam - twopi * std::floor(lam / twopi);
    double F = lr;
    for (int it = 0; it < 100; ++it) {
        const double f = F + h * std::cos(F) - kk * std::sin(F) - lr;
        const double fp = 1 - h * std::sin(F) - kk * std::cos(F);
        const double d = f / fp;
        F -= d;
        if (std::fabs(d) < tol) break;
    }
    return F + (lam - lr);
}

inline double nt_kepDE(double s0, double c0, double DM) {
    const double twopi = 2 * std::acos(-1.0);
    const double tol = 10 * std::numeric_limits<double>::epsilon();
    double Dr = DM - twopi * std::floor(DM / twopi);
    double DE = Dr;
    for (int it = 0; it < 100; ++it) {
        const double f = DE + s0 * (1 - std::cos(DE)) - c0 * std::sin(DE) - Dr;
        const double fp = 1 + s0 * std::sin(DE) - c0 * std::cos(DE);
        const double d = f / fp;
        DE -= d;
        if (std::fabs(d) < tol) break;
    }
    return DE + (DM - Dr);
}

} // namespace
"""


class _Unsupported(Exception):
    pass


def _emit_order0(op, ui, col, lines):
    """Order-0 evaluation of one op (scalar libm per lane)."""
    name = op.op
    a = [col(x) for x in op.inputs]

    def g(i):
        return f"C(0,{a[i]},l)"

    if name == "sum":
        expr = " + ".join(g(i) for i in range(len(a)))
    elif name == "mul":
        expr = f"{g(0)} * {g(1)}"
    elif name == "div":
        expr = f"{g(0)} / {g(1)}"
    elif name == "pow":
        expr = f"std::pow({g(0)}, {float(op.meta['alpha'])!r})"
    elif name in ("sin", "cos", "sinh", "cosh", "tan", "tanh", "exp",
                  "log", "sqrt", "asin", "acos", "atan", "asinh",
                  "acosh", "atanh", "erf"):
        expr = f"std::{name}({g(0)})"
    elif name == "sigmoid":
        expr = f"1.0 / (1.0 + std::exp(-{g(0)}))"
    elif name == "atan2":
        expr = f"std::atan2({g(0)}, {g(1)})"
    elif name == "relu":
        expr = f"({g(0)} > 0 ? {g(0)} : 0.0)"
    elif name == "relup":
        expr = f"({g(0)} > 0 ? 1.0 : 0.0)"
    elif name == "select":
        expr = f"({g(0)} != 0 ? {g(1)} : {g(2)})"
    elif name in ("lt", "le", "gt", "ge", "eq", "ne"):
        cmp = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
               "eq": "==", "ne": "!="}[name]
        expr = f"({g(0)} {cmp} {g(1)} ? 1.0 : 0.0)"
    elif name == "logical_and":
        expr = " && ".join(f"({g(i)} != 0)" for i in range(len(a)))
        expr = f"(({expr}) ? 1.0 : 0.0)"
    elif name == "logical_or":
        expr = " || ".join(f"({g(i)} != 0)" for i in range(len(a)))
        expr = f"(({expr}) ? 1.0 : 0.0)"
    elif name == "logical_not":
        expr = f"({g(0)} == 0 ? 1.0 : 0.0)"
    elif name == "kepE":
        expr = f"nt_kepE({g(0)}, {g(1)})"
    elif name == "kepF":
        expr = f"nt_kepF({g(0)}, {g(1)}, {g(2)})"
    elif name == "kepDE":
        expr = f"nt_kepDE({g(0)}, {g(1)}, {g(2)})"
    else:
        raise _Unsupported(name)
    lines.append(f"  for (int l=0;l<W;++l) C(0,{ui},l) = {expr};")


def _conv(lines, dst, terms, k, post=""):
    """Emit a lane-vectorized convolution: s[l] = sum of terms, then
    ``dst = (s){post}``.  ``terms`` is a list of (lo, hi, coef_fmt) where
    coef_fmt produces the addend given the loop variable name.

    Departure: the lane loop's body is braced, so that a ``post`` holding
    a second statement (div, log, sqrt, tan, tanh, the inverse
    trigonometric ops) stays inside the loop.  The JAX module's unbraced
    loop leaves that statement outside, where ``l`` is undeclared, so
    ``g++`` refuses every tape with such an op and the JAX integrators
    fall back to the interpreter without a word."""
    lines.append("  { double s[W] = {0};")
    for lo, hi, fmt in terms:
        if lo > hi:
            continue
        lines.append(
            f"    for (int j={lo};j<={hi};++j) "
            f"for (int l=0;l<W;++l) s[l] += {fmt('j')};")
    lines.append(
        f"    for (int l=0;l<W;++l) {{ {dst} = (s[l]){post}; }} }}")


def _emit_order_k(op, ui, col, k, lines):
    """Order-k (k >= 1) recurrence of one op — the codegen twin of the
    interpreter's ``rec()`` (taperun.cpp) and of the per-op
    ``taylor_diff()`` rules (reference ``src/math/*.cpp``)."""
    name = op.op
    a = [col(x) for x in op.inputs]
    kd = float(k)
    dst = f"C({k},{ui},l)"

    def G(i, j):
        return f"C({j},{a[i]},l)"

    def U(c, j):
        return f"C({j},{c},l)"

    is_u = [x[0] == "u" for x in op.inputs]
    # constants/params have no derivatives; ``time`` has an order-1 term,
    # so only 'c'/'p' operands admit the collapsed specializations
    is_static = [x[0] in ("c", "p") for x in op.inputs]

    if name == "sum":
        ins = []
        for i, x in enumerate(op.inputs):
            if is_u[i]:
                ins.append(G(i, k))
            elif x[0] == "t" and k == 1:
                ins.append("1.0")
        expr = " + ".join(ins) if ins else "0.0"
        lines.append(f"  for (int l=0;l<W;++l) {dst} = {expr};")
    elif name == "mul":
        # specialize constant operands: the full Cauchy product collapses
        if is_static[0] and is_static[1]:
            lines.append(f"  for (int l=0;l<W;++l) {dst} = 0.0;")
        elif is_static[0]:
            lines.append(
                f"  for (int l=0;l<W;++l) {dst} = C(0,{a[0]},l) * {G(1, k)};")
        elif is_static[1]:
            lines.append(
                f"  for (int l=0;l<W;++l) {dst} = {G(0, k)} * C(0,{a[1]},l);")
        else:
            _conv(lines, dst,
                  [(0, k, lambda j: f"C(j,{a[0]},l) * C({k}-j,{a[1]},l)")],
                  k)
    elif name == "div":
        _conv(lines, dst,
              [(0, k - 1, lambda j: f"C(j,{ui},l) * C({k}-j,{a[1]},l)")],
              k, post=f"; {dst} = ({G(0, k)} - {dst}) / {G(1, 0)}")
    elif name == "pow":
        al = float(op.meta["alpha"])
        _conv(lines, dst,
              [(0, k - 1, lambda j:
                f"({al!r} * ({k}-j) - j) * C({k}-j,{a[0]},l) * C(j,{ui},l)")],
              k, post=f" / ({kd!r} * {G(0, 0)})")
    elif name in ("sin", "sinh", "cosh"):
        m0 = op.meta.get("pair", op.meta.get("sin", op.meta.get("cos")))
        _conv(lines, dst,
              [(1, k, lambda j: f"j * C(j,{a[0]},l) * C({k}-j,{m0},l)")],
              k, post=f" / {kd!r}")
    elif name == "cos":
        m0 = op.meta.get("pair")
        _conv(lines, dst,
              [(1, k, lambda j: f"j * C(j,{a[0]},l) * C({k}-j,{m0},l)")],
              k, post=f" * (-1.0 / {kd!r})")
    elif name == "exp":
        _conv(lines, dst,
              [(1, k, lambda j: f"j * C(j,{a[0]},l) * C({k}-j,{ui},l)")],
              k, post=f" / {kd!r}")
    elif name == "log":
        _conv(lines, dst,
              [(1, k - 1, lambda j: f"j * C(j,{ui},l) * C({k}-j,{a[0]},l)")],
              k, post=f" / {kd!r}; {dst} = ({G(0, k)} - {dst}) / {G(0, 0)}")
    elif name == "sqrt":
        _conv(lines, dst,
              [(1, k - 1, lambda j: f"C(j,{ui},l) * C({k}-j,{ui},l)")],
              k, post=f"; {dst} = ({G(0, k)} - {dst}) / (2.0 * {U(ui, 0)})")
    elif name in ("tan", "tanh"):
        sq = op.meta["sq"]
        sgn = "+" if name == "tan" else "-"
        _conv(lines, dst,
              [(0, k - 1, lambda j:
                f"C(j,{sq},l) * ({k}-j) * C({k}-j,{a[0]},l)")],
              k, post=f" / {kd!r}; {dst} = {G(0, k)} {sgn} {dst}")
    elif name == "sigmoid":
        # the square column (``meta["sq"]``), where the JAX module reads a
        # "pair" that the decomposition never sets, raising KeyError
        m0 = op.meta["sq"]
        _conv(lines, dst,
              [(0, k - 1, lambda j:
                f"(C(j,{ui},l) - C(j,{m0},l)) * ({k}-j) * C({k}-j,{a[0]},l)")],
              k, post=f" / {kd!r}")
    elif name in ("asin", "atan", "asinh", "acosh", "atanh", "acos"):
        sgn = "-1.0" if name == "acos" else "1.0"
        _conv(lines, dst,
              [(1, k - 1, lambda j:
                f"C(j,{a[1]},l) * ({k}-j) * C({k}-j,{ui},l)")],
              k, post=(f"; {dst} = (({sgn}) * {kd!r} * {G(0, k)} - {dst})"
                       f" / ({kd!r} * {G(1, 0)})"))
    elif name == "erf":
        _conv(lines, dst,
              [(0, k - 1, lambda j:
                f"C(j,{a[1]},l) * ({k}-j) * C({k}-j,{a[0]},l)")],
              k, post=(f" * (2.0 / std::sqrt(std::acos(-1.0))) / {kd!r}"))
    elif name == "atan2":
        lines.append("  { double r1[W]={0}, r2[W]={0}, s[W]={0};")
        lines.append(
            f"    for (int j=0;j<{k};++j) for (int l=0;l<W;++l) {{"
            f" r1[l] += C(j,{a[1]},l) * ({k}-j) * C({k}-j,{a[0]},l);"
            f" r2[l] += C(j,{a[0]},l) * ({k}-j) * C({k}-j,{a[1]},l); }}")
        lines.append(
            f"    for (int j=1;j<{k};++j) for (int l=0;l<W;++l)"
            f" s[l] += C(j,{a[2]},l) * ({k}-j) * C({k}-j,{ui},l);")
        lines.append(
            f"    for (int l=0;l<W;++l) {dst} = (r1[l] - r2[l] - s[l])"
            f" / ({kd!r} * {G(2, 0)}); }}")
    elif name == "relu":
        lines.append(
            f"  for (int l=0;l<W;++l) {dst} = {G(0, 0)} > 0 ? {G(0, k)} : 0.0;")
    elif name in ("relup", "lt", "le", "gt", "ge", "eq", "ne",
                  "logical_and", "logical_or", "logical_not"):
        lines.append(f"  for (int l=0;l<W;++l) {dst} = 0.0;")
    elif name == "select":
        lines.append(
            f"  for (int l=0;l<W;++l) {dst} = "
            f"{G(0, 0)} != 0 ? {G(1, k)} : {G(2, k)};")
    elif name in ("kepE", "kepF", "kepDE"):
        _emit_kep_k(op, ui, a, k, lines, name)
    else:
        raise _Unsupported(name)


def _emit_kep_k(op, ui, a, k, lines, name):
    """Order-k recurrences of the Kepler solvers (implicit-function
    differentiation; interpreter twin in taperun.cpp)."""
    kd = float(k)
    si, ci = op.meta["sin"], op.meta["cos"]
    lines.append("  { double t1[W]={0}, t2[W]={0}, t3[W]={0}, t4[W]={0},"
                 " w0[W]={0};")
    if name == "kepE":
        # q(m) = sum_j G0(j) U(ci, m-j); w0 = q(0)
        lines.append(
            f"    for (int l=0;l<W;++l) w0[l] = C(0,{a[0]},l) * C(0,{ci},l);")
        lines.append(
            f"    for (int l=0;l<W;++l) t1[l] = {kd!r} * C({k},{a[1]},l);")
        lines.append(
            f"    for (int j=1;j<={k};++j) for (int l=0;l<W;++l)"
            f" t2[l] += j * C(j,{a[0]},l) * C({k}-j,{si},l);")
        lines.append(
            f"    for (int m=1;m<{k};++m) {{ double q[W]={{0}};"
            f" for (int j=0;j<=m;++j) for (int l=0;l<W;++l)"
            f" q[l] += C(j,{a[0]},l) * C(m-j,{ci},l);"
            f" for (int l=0;l<W;++l) t3[l] += q[l] * ({k}-m) * C({k}-m,{ui},l); }}")
        lines.append(
            f"    for (int l=0;l<W;++l) C({k},{ui},l) ="
            f" (t1[l] + t2[l] + t3[l]) / ({kd!r} * (1.0 - w0[l])); }}")
    elif name == "kepF":
        lines.append(
            f"    for (int l=0;l<W;++l) w0[l] = C(0,{a[0]},l) * C(0,{si},l)"
            f" + C(0,{a[1]},l) * C(0,{ci},l);")
        lines.append(
            f"    for (int l=0;l<W;++l) t1[l] = {kd!r} * C({k},{a[2]},l);")
        lines.append(
            f"    for (int j=1;j<={k};++j) for (int l=0;l<W;++l) {{"
            f" t2[l] -= j * C(j,{a[0]},l) * C({k}-j,{ci},l);"
            f" t3[l] += j * C(j,{a[1]},l) * C({k}-j,{si},l); }}")
        lines.append(
            f"    for (int m=1;m<{k};++m) {{ double w[W]={{0}};"
            f" for (int j=0;j<=m;++j) for (int l=0;l<W;++l)"
            f" w[l] += C(j,{a[0]},l) * C(m-j,{si},l)"
            f" + C(j,{a[1]},l) * C(m-j,{ci},l);"
            f" for (int l=0;l<W;++l) t4[l] += w[l] * ({k}-m) * C({k}-m,{ui},l); }}")
        lines.append(
            f"    for (int l=0;l<W;++l) C({k},{ui},l) ="
            f" (t1[l] + t2[l] + t3[l] + t4[l]) / ({kd!r} * (1.0 - w0[l])); }}")
    else:  # kepDE
        lines.append(
            f"    for (int l=0;l<W;++l) w0[l] = C(0,{a[0]},l) * C(0,{si},l)"
            f" - C(0,{a[1]},l) * C(0,{ci},l);")
        lines.append(
            f"    for (int l=0;l<W;++l) t1[l] = {kd!r} * C({k},{a[2]},l);")
        lines.append(
            f"    for (int j=1;j<={k};++j) for (int l=0;l<W;++l) {{"
            f" const double omc = ({k}-j) == 0 ? (1.0 - C(0,{ci},l))"
            f" : -C({k}-j,{ci},l);"
            f" t2[l] -= j * C(j,{a[0]},l) * omc;"
            f" t3[l] += j * C(j,{a[1]},l) * C({k}-j,{si},l); }}")
        lines.append(
            f"    for (int m=1;m<{k};++m) {{ double w[W]={{0}};"
            f" for (int j=0;j<=m;++j) for (int l=0;l<W;++l)"
            f" w[l] += C(j,{a[0]},l) * C(m-j,{si},l)"
            f" - C(j,{a[1]},l) * C(m-j,{ci},l);"
            f" for (int l=0;l<W;++l) t4[l] -= w[l] * ({k}-m) * C({k}-m,{ui},l); }}")
        lines.append(
            f"    for (int l=0;l<W;++l) C({k},{ui},l) ="
            f" (t1[l] + t2[l] + t3[l] + t4[l]) / ({kd!r} * (1.0 + w0[l])); }}")


def generate_cpp(tape: Tape, order: int, W: int) -> str:
    """Emit the full C++ translation unit for one (tape, order, W)."""
    n_eq = tape.n_eq
    n_ops = len(tape.ops)
    n_u = n_eq + n_ops

    # virtual columns: const/par/time operands get coefficient columns so
    # every recurrence reads uniformly from the lane-interleaved cc array
    vcols: dict = {}
    vinit = []  # (col, kind, payload)

    def col(operand):
        kind = operand[0]
        if kind == "u":
            return int(operand[1])
        key = (kind, operand[1] if kind != "t" else None)
        if key not in vcols:
            c = n_u + len(vcols)
            vcols[key] = c
            vinit.append((c, kind, operand[1] if kind != "t" else None))
        return vcols[key]

    # one function per order: keeps each g++ optimization unit small (the
    # compile time of one huge straight-line function grows superlinearly —
    # the same reason the reference splits compact-mode drivers across
    # modules, taylor_02.cpp:1045)
    body0, order_fns = [], []
    for i, op in enumerate(tape.ops):
        _emit_order0(op, n_eq + i, col, body0)
    for k in range(1, order + 1):
        bk = [f"void jet_order_{k}(double *cc, const double *pars,"
              f" const double *t)", "{", "  (void)pars; (void)t;"]
        # state-variable seeding: x_i^{[k]} = rhs_i^{[k-1]} / k
        for i, rop in enumerate(tape.rhs):
            c = col(rop)
            bk.append(
                f"  for (int l=0;l<W;++l) C({k},{i},l) = "
                f"C({k - 1},{c},l) * {1.0 / k!r};")
        for i, op in enumerate(tape.ops):
            _emit_order_k(op, n_eq + i, col, k, bk)
        bk.append("}")
        order_fns.append("\n".join(bk))
    bodyk = [f"  jet_order_{k}(cc, pars, t);" for k in range(1, order + 1)]

    nux = n_u + len(vcols)
    init_lines = []
    for c, kind, payload in vinit:
        if kind == "c":
            init_lines.append(
                f"  for (int l=0;l<W;++l) C(0,{c},l) = {float(payload)!r};")
        elif kind == "p":
            init_lines.append(
                f"  for (int l=0;l<W;++l) C(0,{c},l) = "
                f"pars[{int(payload)}*W+l];")
        else:  # time
            init_lines.append(
                f"  for (int l=0;l<W;++l) C(0,{c},l) = t[l];")
            init_lines.append(
                f"  if (ORDER >= 1) for (int l=0;l<W;++l) C(1,{c},l) = 1.0;")

    src = [_PREAMBLE]
    src.append(f"""
constexpr int W = {W};
constexpr int NEQ = {n_eq};
constexpr int NU = {n_u};
constexpr int NUX = {nux};
constexpr int ORDER = {order};
#define C(k, i, l) cc[(((k) * NUX) + (i)) * W + (l)]

namespace {{

{chr(10).join(order_fns)}

// the jet: state preloaded in C(0, 0..NEQ-1, l); fills everything else
void cg_jet(double *cc, const double *pars, const double *t)
{{
  // virtual (const/par/time) columns are read at every order by the
  // convolution loops but written only below: zero them at all orders
  for (int k = 0; k <= ORDER; ++k)
    std::memset(cc + (static_cast<std::size_t>(k) * NUX + NU) * W, 0,
                sizeof(double) * (NUX - NU) * W);
{chr(10).join(init_lines)}
{chr(10).join(body0)}
{chr(10).join(bodyk)}
}}

// Jorba rho step-size control, per lane (taylor_00.cpp:102-273 semantics)
void cg_determine_h(const double *cc, const double *max_dt, double *h)
{{
  for (int l = 0; l < W; ++l) {{
    double m0 = 0, mo = 0, mo1 = 0;
    for (int i = 0; i < NEQ; ++i) {{
      m0 = std::fmax(m0, std::fabs(C(0, i, l)));
      mo = std::fmax(mo, std::fabs(C(ORDER, i, l)));
      mo1 = std::fmax(mo1, std::fabs(C(ORDER - 1, i, l)));
    }}
    const double num = m0 <= 1 ? 1.0 : m0;
    const double rho = std::fmin(std::pow(num / mo, 1.0 / ORDER),
                                 std::pow(num / mo1, 1.0 / (ORDER - 1)));
    const double e1 = std::exp(1.0);
    double hv = rho * std::exp(-0.7 / (ORDER - 1)) / (e1 * e1);
    hv = std::fmin(hv, std::fabs(max_dt[l]));
    h[l] = max_dt[l] < 0 ? -hv : hv;
  }}
}}

void cg_update(const double *cc, const double *h, int ha, double *st)
{{
  if (ha) {{
    for (int i = 0; i < NEQ; ++i) for (int l = 0; l < W; ++l) {{
      double res = C(0, i, l), comp = 0, cur_h = h[l];
      for (int k = 1; k <= ORDER; ++k) {{
        const double tmp = C(k, i, l) * cur_h;
        const double y = tmp - comp;
        const double tt = res + y;
        comp = (tt - res) - y;
        res = tt;
        if (k < ORDER) cur_h *= h[l];
      }}
      st[i * W + l] = res;
    }}
  }} else {{
    for (int i = 0; i < NEQ; ++i) for (int l = 0; l < W; ++l) {{
      double r = C(ORDER, i, l);
      for (int k = ORDER - 1; k >= 0; --k) r = C(k, i, l) + r * h[l];
      st[i * W + l] = r;
    }}
  }}
}}

inline void cg_dd_add(double &t_hi, double &t_lo, double h)
{{
  const double s = t_hi + h;
  const double v = s - t_hi;
  const double err = (t_hi - (s - v)) + (h - v);
  t_lo += err;
  t_hi = s;
  const double s2 = t_hi + t_lo;
  t_lo = t_lo - (s2 - t_hi);
  t_hi = s2;
}}

// one W-block of lanes, lockstep adaptive propagate-until with per-lane
// activity masks (the reference batch-mode driver shape,
// src/taylor_adaptive_batch.cpp)
void cg_prop_block(int nl, double *states, const double *pars_in,
                   double *t_his, double *t_los, const double *targets,
                   const double *mdts, long long max_steps, int ha,
                   double *h_stats, double *last_cc, long long *steps_out)
{{
  static thread_local std::vector<double> ccbuf;
  ccbuf.resize(static_cast<std::size_t>(ORDER + 1) * NUX * W);
  double *cc = ccbuf.data();
  double pars[{max(1, tape.n_pars)} * W];
  double st[NEQ * W], h[W], cap[W];
  double th[W], tl[W];
  long long ns[W] = {{0}};
  bool act[W], err[W] = {{false}};
  double mnh[W], mxh[W], lsh[W] = {{0}};
  for (int l = 0; l < W; ++l) {{
    const int ll = l < nl ? l : 0;
    for (int i = 0; i < NEQ; ++i) st[i * W + l] = states[ll * NEQ + i];
    for (int p = 0; p < {max(1, tape.n_pars)}; ++p)
      pars[p * W + l] = pars_in[ll * {max(1, tape.n_pars)} + p];
    th[l] = t_his[ll]; tl[l] = t_los[ll];
    act[l] = l < nl && (targets[ll] - (th[l] + tl[l])) != 0.0;
    mnh[l] = std::numeric_limits<double>::infinity();
    mxh[l] = 0.0;
  }}
  bool any = false;
  for (int l = 0; l < W; ++l) any |= act[l];
  while (any) {{
    for (int l = 0; l < W; ++l) {{
      const int ll = l < nl ? l : 0;
      const double rem = targets[ll] - (th[l] + tl[l]);
      double c = std::fmin(std::fabs(rem), mdts[ll]);
      if (!act[l]) c = 0.0;
      cap[l] = rem >= 0 ? c : -c;
    }}
    for (int i = 0; i < NEQ; ++i)
      for (int l = 0; l < W; ++l) C(0, i, l) = st[i * W + l];
    cg_jet(cc, pars, th);
    cg_determine_h(cc, cap, h);
    cg_update(cc, h, ha, st);
    for (int l = 0; l < W; ++l) {{
      if (!act[l]) continue;
      cg_dd_add(th[l], tl[l], h[l]);
      ++ns[l];
      const double ah = std::fabs(h[l]);
      mnh[l] = std::fmin(mnh[l], ah);
      mxh[l] = std::fmax(mxh[l], ah);
      lsh[l] = h[l];
      bool fin = std::isfinite(h[l]);
      for (int i = 0; i < NEQ; ++i) fin = fin && std::isfinite(st[i * W + l]);
      if (l < nl && last_cc) {{
        double *dst = last_cc + static_cast<std::size_t>(l)
                      * (ORDER + 1) * NEQ;
        for (int k = 0; k <= ORDER; ++k)
          for (int i = 0; i < NEQ; ++i)
            dst[k * NEQ + i] = C(k, i, l);
      }}
      if (!fin) {{ err[l] = true; act[l] = false; continue; }}
      const double rem = (l < nl ? targets[l] : targets[0])
                         - (th[l] + tl[l]);
      const bool fwd = h[l] >= 0;
      if ((fwd && rem <= 0) || (!fwd && rem >= 0)) act[l] = false;
      if (max_steps > 0 && ns[l] >= max_steps) act[l] = false;
    }}
    any = false;
    for (int l = 0; l < W; ++l) any |= act[l];
  }}
  for (int l = 0; l < nl; ++l) {{
    for (int i = 0; i < NEQ; ++i) states[l * NEQ + i] = st[i * W + l];
    t_his[l] = th[l]; t_los[l] = tl[l];
    steps_out[l] = err[l] ? -ns[l] : ns[l];
    h_stats[l * 3 + 0] = mnh[l];
    h_stats[l * 3 + 1] = mxh[l];
    h_stats[l * 3 + 2] = lsh[l];
  }}
}}

// one W-block, one lockstep step (per-lane max_dt); writes per-lane h and
// the state-variable jet
void cg_step_block(int nl, double *states, const double *pars_in,
                   double *t_his, double *t_los, const double *mdts, int ha,
                   double *out_cc, double *out_h)
{{
  static thread_local std::vector<double> ccbuf;
  ccbuf.resize(static_cast<std::size_t>(ORDER + 1) * NUX * W);
  double *cc = ccbuf.data();
  double pars[{max(1, tape.n_pars)} * W];
  double st[NEQ * W], h[W], mdt[W];
  double th[W];
  for (int l = 0; l < W; ++l) {{
    const int ll = l < nl ? l : 0;
    for (int i = 0; i < NEQ; ++i) st[i * W + l] = states[ll * NEQ + i];
    for (int p = 0; p < {max(1, tape.n_pars)}; ++p)
      pars[p * W + l] = pars_in[ll * {max(1, tape.n_pars)} + p];
    th[l] = t_his[ll];
    mdt[l] = mdts[ll];
  }}
  for (int i = 0; i < NEQ; ++i)
    for (int l = 0; l < W; ++l) C(0, i, l) = st[i * W + l];
  cg_jet(cc, pars, th);
  cg_determine_h(cc, mdt, h);
  cg_update(cc, h, ha, st);
  for (int l = 0; l < nl; ++l) {{
    for (int i = 0; i < NEQ; ++i) states[l * NEQ + i] = st[i * W + l];
    cg_dd_add(t_his[l], t_los[l], h[l]);
    out_h[l] = h[l];
    double *dst = out_cc + static_cast<std::size_t>(l) * (ORDER + 1) * NEQ;
    for (int k = 0; k <= ORDER; ++k)
      for (int i = 0; i < NEQ; ++i) dst[k * NEQ + i] = C(k, i, l);
  }}
}}

}} // namespace

extern "C" {{

void cg_propagate_until_batch(
    long long B, double *states, const double *pars, double *t_his,
    double *t_los, const double *targets, const double *mdts,
    long long max_steps, int ha, double *h_stats, double *last_cc,
    long long *steps_out)
{{
  const long long nb = (B + W - 1) / W;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (long long b = 0; b < nb; ++b) {{
    const long long o = b * W;
    const int nl = static_cast<int>(B - o < W ? B - o : W);
    cg_prop_block(nl, states + o * NEQ,
                  pars + o * {max(1, tape.n_pars)}, t_his + o, t_los + o,
                  targets + o, mdts + o, max_steps, ha, h_stats + o * 3,
                  last_cc ? last_cc + o * (ORDER + 1) * NEQ : nullptr,
                  steps_out + o);
  }}
}}

void cg_step_batch(
    long long B, double *states, const double *pars, double *t_his,
    double *t_los, const double *mdts, int ha, double *out_cc,
    double *out_h)
{{
  const long long nb = (B + W - 1) / W;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (long long b = 0; b < nb; ++b) {{
    const long long o = b * W;
    const int nl = static_cast<int>(B - o < W ? B - o : W);
    cg_step_block(nl, states + o * NEQ,
                  pars + o * {max(1, tape.n_pars)}, t_his + o, t_los + o,
                  mdts + o, ha, out_cc + o * (ORDER + 1) * NEQ, out_h + o);
  }}
}}

}} // extern "C"
""")
    return "\n".join(src)


# ---------------------------------------------------------------------------
# compile + load
# ---------------------------------------------------------------------------


def _tape_digest(tape: Tape, order: int, W: int) -> str:
    p = pack_tape(tape)
    h = hashlib.sha256()
    h.update(f"v{_CG_VERSION}|{order}|{W}|{tape.n_eq}|{tape.n_pars}".encode())
    for k in ("opcodes", "arity", "inputs", "meta", "alpha", "consts", "rhs"):
        h.update(np.ascontiguousarray(p[k]).tobytes())
    return h.hexdigest()[:24]


class CompiledTape:
    """A tape AOT-compiled to a specialized shared object.

    ``CompiledTape(tape, order, W=...)`` generates, compiles (disk-cached
    by content hash) and loads the stepper.  Raises ``_Unsupported`` when
    the tape is outside codegen's op set or too large (the integrators
    then fall back to the interpreter runtime, and say so), RuntimeError
    when the compiler fails (raised through the integrators).
    """

    #: tapes above this statement-count estimate fall back to the
    #: interpreter (split per-order functions compile ~linearly:
    #: ~7k stmts = 36 s at -O2 on the dev host)
    MAX_STMTS = int(os.environ.get("HEYOKA_CG_MAX_STMTS", "20000"))

    def __init__(self, tape: Tape, order: int, W: int = 8):
        if tape.rhs is None:
            raise ValueError("CompiledTape requires an ODE tape")
        est = len(tape.ops) * (order + 1)
        if est > self.MAX_STMTS:
            raise _Unsupported(
                f"tape too large for codegen ({est} > {self.MAX_STMTS} "
                f"statements); use the interpreter runtime"
            )
        self._tape = tape
        self.order = int(order)
        self.W = int(W)
        self.n_eq = tape.n_eq
        self.n_pars = tape.n_pars
        digest = _tape_digest(tape, order, W)
        so = native_dir() / f"cg_{digest}.so"
        if not so.exists():
            srcf = so.with_suffix(".cpp")
            tmp = so.parent / f"cg_{digest}.{os.getpid()}.cpp"
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(generate_cpp(tape, order, W))
            os.replace(tmp, srcf)
            opt = os.environ.get("HEYOKA_CG_OPT", "-O2")
            compile_shared(srcf, so, [*opt.split(), "-march=native",
                                      "-shared", "-fPIC", "-std=gnu++17",
                                      "-fopenmp"])
        self._lib = ctypes.CDLL(str(so))
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        self._lib.cg_propagate_until_batch.restype = None
        self._lib.cg_propagate_until_batch.argtypes = [
            ctypes.c_int64, f64p, f64p, f64p, f64p, f64p, f64p,
            ctypes.c_int64, ctypes.c_int32, f64p, f64p, i64p,
        ]
        self._lib.cg_step_batch.restype = None
        self._lib.cg_step_batch.argtypes = [
            ctypes.c_int64, f64p, f64p, f64p, f64p, f64p,
            ctypes.c_int32, f64p, f64p,
        ]

    def _pars(self, pars, batch):
        np_ = max(1, self.n_pars)
        if pars is None or np.size(pars) == 0:
            return np.zeros((batch, np_), np.float64)
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(pars, np.float64), (batch, np_)))

    def propagate_until_batch(self, states, pars, t_his, t_los, targets,
                              *, max_delta_t=np.inf, max_steps: int = 0,
                              high_accuracy: bool = False):
        """Lockstep W-lane adaptive propagation; same contract as
        ``NativeRuntime.propagate_until_batch``."""
        batch = states.shape[0]
        stats = np.zeros((batch, 3), np.float64)
        steps = np.zeros((batch,), np.int64)
        ccs = np.zeros((batch, self.order + 1, self.n_eq), np.float64)
        mdts = np.ascontiguousarray(
            np.broadcast_to(np.asarray(max_delta_t, np.float64), (batch,)))
        tgts = np.ascontiguousarray(
            np.broadcast_to(np.asarray(targets, np.float64), (batch,)))
        self._lib.cg_propagate_until_batch(
            batch, states, self._pars(pars, batch), t_his, t_los, tgts,
            mdts, np.int64(max_steps), np.int32(bool(high_accuracy)),
            stats.reshape(-1), ccs.reshape(-1), steps,
        )
        return steps, stats, ccs

    def step_batch(self, states, pars, t_his, t_los, max_dts,
                   high_accuracy: bool = False):
        """One lockstep adaptive step; returns (hs, ccs) with ccs the
        per-lane state-variable jets (B, order+1, n_eq)."""
        batch = states.shape[0]
        ccs = np.empty((batch, self.order + 1, self.n_eq), np.float64)
        hs = np.empty((batch,), np.float64)
        self._lib.cg_step_batch(
            batch, states, self._pars(pars, batch), t_his, t_los,
            np.ascontiguousarray(max_dts, np.float64),
            np.int32(bool(high_accuracy)), ccs.reshape(-1), hs,
        )
        return hs, ccs


def compiled_available() -> bool:
    import shutil

    return shutil.which(_cxx()) is not None
