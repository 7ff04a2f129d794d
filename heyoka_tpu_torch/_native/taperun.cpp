// Native CPU Taylor-method runtime: a compiled tape interpreter.
//
// Reference parity: heyoka's runtime *is* native code — an LLVM-JITed
// stepper over the decomposition tape (src/taylor_0{0,1,2}.cpp).  heyoka_tpu
// runs its hot path through XLA on the TPU; this C++ runtime provides the
// native CPU companion: the same decomposition tape, the same per-op Taylor
// recurrences (recurrences.py), the same Jorba step control
// (taylor_00.cpp:102-273 semantics), executed by an optimized C++
// interpreter.  It serves as
//   - the "opt-level-0 reference backend" of the test strategy
//     (SURVEY.md §4: compiled-vs-independent-backend equivalence),
//   - a host-side fallback/runtime when no accelerator is attached,
//   - the fast oracle for high-order recurrence validation,
//   - the extended-precision (80-bit long double) backend — the analog of
//     the reference's tut_extended_precision support, which TPUs cannot
//     provide (the numeric core is templated on the scalar type).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Tape encoding (produced by heyoka_tpu.native.pack_tape):
//   n_eq state variables, ops[] with:
//     opcode   int32   (see OpCode)
//     arity    int32
//     in[MAXA] int32   operand codes: >=0 -> u-var index; -1-j -> const j;
//                      -1000000-j -> par j; -2000000 -> time
//     meta0/1  int32   aux u-var indices (pair/sq/sin/cos), -1 if unused
//     alpha    double  (pow exponent)
//   consts[]: literal pool
//   rhs[]:    per state variable, operand code of its derivative
//
// Coefficient storage: cc[k * n_u + i] = order-k normalized coefficient of
// u-var i.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#if defined(__SIZEOF_FLOAT128__)
#include <quadmath.h>
#endif

namespace {

// math dispatch: std:: overloads for float/double/long double; quadmath
// for __float128 (libstdc++ does not provide std:: overloads for it in
// strict modes)
template <typename T> inline T m_sin(T x) { return std::sin(x); }
template <typename T> inline T m_cos(T x) { return std::cos(x); }
template <typename T> inline T m_sinh(T x) { return std::sinh(x); }
template <typename T> inline T m_cosh(T x) { return std::cosh(x); }
template <typename T> inline T m_tan(T x) { return std::tan(x); }
template <typename T> inline T m_tanh(T x) { return std::tanh(x); }
template <typename T> inline T m_exp(T x) { return std::exp(x); }
template <typename T> inline T m_log(T x) { return std::log(x); }
template <typename T> inline T m_sqrt(T x) { return std::sqrt(x); }
template <typename T> inline T m_asin(T x) { return std::asin(x); }
template <typename T> inline T m_acos(T x) { return std::acos(x); }
template <typename T> inline T m_atan(T x) { return std::atan(x); }
template <typename T> inline T m_asinh(T x) { return std::asinh(x); }
template <typename T> inline T m_acosh(T x) { return std::acosh(x); }
template <typename T> inline T m_atanh(T x) { return std::atanh(x); }
template <typename T> inline T m_erf(T x) { return std::erf(x); }
template <typename T> inline T m_atan2(T y, T x) { return std::atan2(y, x); }
template <typename T> inline T m_pow(T x, T a) { return std::pow(x, a); }
template <typename T> inline T m_fabs(T x) { return std::fabs(x); }
template <typename T> inline T m_floor(T x) { return std::floor(x); }
template <typename T> inline T m_fmax(T a, T b) { return std::fmax(a, b); }
template <typename T> inline T m_fmin(T a, T b) { return std::fmin(a, b); }
template <typename T> inline bool m_isfinite(T x) { return std::isfinite(x); }
template <typename T> inline T m_eps() { return std::numeric_limits<T>::epsilon(); }
template <typename T> inline T m_nan() { return std::numeric_limits<T>::quiet_NaN(); }

#if defined(__SIZEOF_FLOAT128__)
inline __float128 m_sin(__float128 x) { return sinq(x); }
inline __float128 m_cos(__float128 x) { return cosq(x); }
inline __float128 m_sinh(__float128 x) { return sinhq(x); }
inline __float128 m_cosh(__float128 x) { return coshq(x); }
inline __float128 m_tan(__float128 x) { return tanq(x); }
inline __float128 m_tanh(__float128 x) { return tanhq(x); }
inline __float128 m_exp(__float128 x) { return expq(x); }
inline __float128 m_log(__float128 x) { return logq(x); }
inline __float128 m_sqrt(__float128 x) { return sqrtq(x); }
inline __float128 m_asin(__float128 x) { return asinq(x); }
inline __float128 m_acos(__float128 x) { return acosq(x); }
inline __float128 m_atan(__float128 x) { return atanq(x); }
inline __float128 m_asinh(__float128 x) { return asinhq(x); }
inline __float128 m_acosh(__float128 x) { return acoshq(x); }
inline __float128 m_atanh(__float128 x) { return atanhq(x); }
inline __float128 m_erf(__float128 x) { return erfq(x); }
inline __float128 m_atan2(__float128 y, __float128 x) { return atan2q(y, x); }
inline __float128 m_pow(__float128 x, __float128 a) { return powq(x, a); }
inline __float128 m_fabs(__float128 x) { return fabsq(x); }
inline __float128 m_floor(__float128 x) { return floorq(x); }
inline __float128 m_fmax(__float128 a, __float128 b) { return a > b ? a : b; }
inline __float128 m_fmin(__float128 a, __float128 b) { return a < b ? a : b; }
inline bool m_isfinite(__float128 x) { return finiteq(x) != 0; }
template <> inline __float128 m_eps<__float128>() { return FLT128_EPSILON; }
template <> inline __float128 m_nan<__float128>() { return nanq(""); }
#endif

constexpr int MAXA = 8;

enum OpCode : int32_t {
    OP_SUM = 0,
    OP_MUL,
    OP_DIV,
    OP_POW,
    OP_SIN,
    OP_COS,
    OP_SINH,
    OP_COSH,
    OP_TAN,
    OP_TANH,
    OP_EXP,
    OP_LOG,
    OP_SQRT,
    OP_SIGMOID,
    OP_ASIN,
    OP_ACOS,
    OP_ATAN,
    OP_ASINH,
    OP_ACOSH,
    OP_ATANH,
    OP_ERF,
    OP_ATAN2,
    OP_RELU,
    OP_RELUP,
    OP_SELECT,
    OP_CMP_LT,
    OP_CMP_LE,
    OP_CMP_GT,
    OP_CMP_GE,
    OP_CMP_EQ,
    OP_CMP_NE,
    OP_LAND,
    OP_LOR,
    OP_LNOT,
    OP_KEPE,
    OP_KEPF,
    OP_KEPDE,
};

struct TapeOp {
    int32_t opcode;
    int32_t arity;
    int32_t in[MAXA];
    int32_t meta0;
    int32_t meta1;
    double alpha;
};

template <typename T>
struct Tape {
    int32_t n_eq;
    int32_t n_ops;
    int32_t n_pars;
    std::vector<TapeOp> ops;
    std::vector<T> consts;
    std::vector<int32_t> rhs;
};

// operand value at order k (G() of recurrences.py)
template <typename T>
inline T gval(const T *cc, int32_t n_u, const Tape<T> &tp, const T *pars,
              T t, int32_t code, int32_t k)
{
    if (code >= 0) {
        return cc[static_cast<std::size_t>(k) * n_u + code];
    }
    if (code == -2000000) {
        return k == 0 ? t : (k == 1 ? T(1) : T(0));
    }
    if (code <= -1000000) {
        return k == 0 ? pars[-1000000 - code] : T(0);
    }
    return k == 0 ? tp.consts[-1 - code] : T(0);
}

template <typename T>
T newton_kepE(T ecc, T M)
{
    const T twopi = 2 * m_acos(T(-1));
    const T tol = 10 * m_eps<T>();
    T Mr = M - twopi * m_floor(M / twopi);
    T E = Mr + T(0.85) * ecc * (m_sin(Mr) >= 0 ? T(1) : T(-1));
    for (int it = 0; it < 100; ++it) {
        const T f = E - ecc * m_sin(E) - Mr;
        const T fp = 1 - ecc * m_cos(E);
        const T d = f / fp;
        E -= d;
        if (m_fabs(d) < tol) break;
    }
    return E + (M - Mr);
}

template <typename T>
T newton_kepF(T h, T kk, T lam)
{
    const T twopi = 2 * m_acos(T(-1));
    const T tol = 10 * m_eps<T>();
    T lr = lam - twopi * m_floor(lam / twopi);
    T F = lr;
    for (int it = 0; it < 100; ++it) {
        const T f = F + h * m_cos(F) - kk * m_sin(F) - lr;
        const T fp = 1 - h * m_sin(F) - kk * m_cos(F);
        const T d = f / fp;
        F -= d;
        if (m_fabs(d) < tol) break;
    }
    return F + (lam - lr);
}

template <typename T>
T newton_kepDE(T s0, T c0, T DM)
{
    const T twopi = 2 * m_acos(T(-1));
    const T tol = 10 * m_eps<T>();
    T Dr = DM - twopi * m_floor(DM / twopi);
    T DE = Dr;
    for (int it = 0; it < 100; ++it) {
        const T f = DE + s0 * (1 - m_cos(DE)) - c0 * m_sin(DE) - Dr;
        const T fp = 1 + s0 * m_sin(DE) - c0 * m_cos(DE);
        const T d = f / fp;
        DE -= d;
        if (m_fabs(d) < tol) break;
    }
    return DE + (DM - Dr);
}

// order-0 evaluation of one op
template <typename T>
T eval0(const Tape<T> &tp, const TapeOp &op, const T *cc, int32_t n_u,
        const T *pars, T t)
{
    auto g = [&](int a) { return gval(cc, n_u, tp, pars, t, op.in[a], 0); };
    switch (op.opcode) {
        case OP_SUM: {
            T s = 0;
            for (int a = 0; a < op.arity; ++a) s += g(a);
            return s;
        }
        case OP_MUL: return g(0) * g(1);
        case OP_DIV: return g(0) / g(1);
        case OP_POW: return m_pow(g(0), T(op.alpha));
        case OP_SIN: return m_sin(g(0));
        case OP_COS: return m_cos(g(0));
        case OP_SINH: return m_sinh(g(0));
        case OP_COSH: return m_cosh(g(0));
        case OP_TAN: return m_tan(g(0));
        case OP_TANH: return m_tanh(g(0));
        case OP_EXP: return m_exp(g(0));
        case OP_LOG: return m_log(g(0));
        case OP_SQRT: return m_sqrt(g(0));
        case OP_SIGMOID: return 1 / (1 + m_exp(-g(0)));
        case OP_ASIN: return m_asin(g(0));
        case OP_ACOS: return m_acos(g(0));
        case OP_ATAN: return m_atan(g(0));
        case OP_ASINH: return m_asinh(g(0));
        case OP_ACOSH: return m_acosh(g(0));
        case OP_ATANH: return m_atanh(g(0));
        case OP_ERF: return m_erf(g(0));
        case OP_ATAN2: return m_atan2(g(0), g(1));
        case OP_RELU: return g(0) > 0 ? g(0) : T(0);
        case OP_RELUP: return g(0) > 0 ? T(1) : T(0);
        case OP_SELECT: return g(0) != 0 ? g(1) : g(2);
        case OP_CMP_LT: return g(0) < g(1) ? T(1) : T(0);
        case OP_CMP_LE: return g(0) <= g(1) ? T(1) : T(0);
        case OP_CMP_GT: return g(0) > g(1) ? T(1) : T(0);
        case OP_CMP_GE: return g(0) >= g(1) ? T(1) : T(0);
        case OP_CMP_EQ: return g(0) == g(1) ? T(1) : T(0);
        case OP_CMP_NE: return g(0) != g(1) ? T(1) : T(0);
        case OP_LAND: {
            for (int a = 0; a < op.arity; ++a)
                if (g(a) == 0) return T(0);
            return T(1);
        }
        case OP_LOR: {
            for (int a = 0; a < op.arity; ++a)
                if (g(a) != 0) return T(1);
            return T(0);
        }
        case OP_LNOT: return g(0) == 0 ? T(1) : T(0);
        case OP_KEPE: return newton_kepE(g(0), g(1));
        case OP_KEPF: return newton_kepF(g(0), g(1), g(2));
        case OP_KEPDE: return newton_kepDE(g(0), g(1), g(2));
    }
    return m_nan<T>();
}

// order-k recurrence of one op (k >= 1); u = this op's u-var index
template <typename T>
T rec(const Tape<T> &tp, const TapeOp &op, int32_t u, const T *cc,
      int32_t n_u, const T *pars, T t, int32_t k)
{
    const T kd = static_cast<T>(k);
    auto G = [&](int a, int32_t j) {
        return gval(cc, n_u, tp, pars, t, op.in[a], j);
    };
    auto U = [&](int32_t i, int32_t j) {
        return cc[static_cast<std::size_t>(j) * n_u + i];
    };
    switch (op.opcode) {
        case OP_SUM: {
            T s = 0;
            for (int a = 0; a < op.arity; ++a) s += G(a, k);
            return s;
        }
        case OP_MUL: {
            T s = 0;
            for (int32_t j = 0; j <= k; ++j) s += G(0, j) * G(1, k - j);
            return s;
        }
        case OP_DIV: {
            T s = 0;
            for (int32_t j = 0; j < k; ++j) s += U(u, j) * G(1, k - j);
            return (G(0, k) - s) / G(1, 0);
        }
        case OP_POW: {
            T s = 0;
            for (int32_t j = 0; j < k; ++j)
                s += (T(op.alpha) * (k - j) - j) * G(0, k - j) * U(u, j);
            return s / (kd * G(0, 0));
        }
        case OP_SIN:
        case OP_SINH:
        case OP_COSH: {
            T s = 0;
            for (int32_t j = 1; j <= k; ++j)
                s += j * G(0, j) * U(op.meta0, k - j);
            return s / kd;
        }
        case OP_COS: {
            T s = 0;
            for (int32_t j = 1; j <= k; ++j)
                s += j * G(0, j) * U(op.meta0, k - j);
            return -s / kd;
        }
        case OP_EXP: {
            T s = 0;
            for (int32_t j = 1; j <= k; ++j) s += j * G(0, j) * U(u, k - j);
            return s / kd;
        }
        case OP_LOG: {
            T s = 0;
            for (int32_t j = 1; j < k; ++j) s += j * U(u, j) * G(0, k - j);
            return (G(0, k) - s / kd) / G(0, 0);
        }
        case OP_SQRT: {
            T s = 0;
            for (int32_t j = 1; j < k; ++j) s += U(u, j) * U(u, k - j);
            return (G(0, k) - s) / (2 * U(u, 0));
        }
        case OP_TAN: {
            T s = 0;
            for (int32_t m = 0; m < k; ++m)
                s += U(op.meta0, m) * (k - m) * G(0, k - m);
            return G(0, k) + s / kd;
        }
        case OP_TANH: {
            T s = 0;
            for (int32_t m = 0; m < k; ++m)
                s += U(op.meta0, m) * (k - m) * G(0, k - m);
            return G(0, k) - s / kd;
        }
        case OP_SIGMOID: {
            T s = 0;
            for (int32_t m = 0; m < k; ++m)
                s += (U(u, m) - U(op.meta0, m)) * (k - m) * G(0, k - m);
            return s / kd;
        }
        case OP_ASIN:
        case OP_ATAN:
        case OP_ASINH:
        case OP_ACOSH:
        case OP_ATANH:
        case OP_ACOS: {
            const T sign = op.opcode == OP_ACOS ? T(-1) : T(1);
            T s = 0;
            for (int32_t m = 1; m < k; ++m)
                s += G(1, m) * (k - m) * U(u, k - m);
            return (sign * kd * G(0, k) - s) / (kd * G(1, 0));
        }
        case OP_ERF: {
            T s = 0;
            for (int32_t m = 0; m < k; ++m)
                s += G(1, m) * (k - m) * G(0, k - m);
            return (2 / m_sqrt(m_acos(T(-1)))) * s / kd;
        }
        case OP_ATAN2: {
            T r1 = 0, r2 = 0, s = 0;
            for (int32_t m = 0; m < k; ++m) {
                r1 += G(1, m) * (k - m) * G(0, k - m);
                r2 += G(0, m) * (k - m) * G(1, k - m);
            }
            for (int32_t m = 1; m < k; ++m)
                s += G(2, m) * (k - m) * U(u, k - m);
            return (r1 - r2 - s) / (kd * G(2, 0));
        }
        case OP_RELU: return G(0, 0) > 0 ? G(0, k) : T(0);
        case OP_RELUP: return T(0);
        case OP_SELECT: return G(0, 0) != 0 ? G(1, k) : G(2, k);
        case OP_CMP_LT:
        case OP_CMP_LE:
        case OP_CMP_GT:
        case OP_CMP_GE:
        case OP_CMP_EQ:
        case OP_CMP_NE:
        case OP_LAND:
        case OP_LOR:
        case OP_LNOT: return T(0);
        case OP_KEPE: {
            const int32_t si = op.meta0, ci = op.meta1;
            auto q = [&](int32_t m) {
                T s = 0;
                for (int32_t j = 0; j <= m; ++j) s += G(0, j) * U(ci, m - j);
                return s;
            };
            T t1 = kd * G(1, k), t2 = 0, t3 = 0;
            for (int32_t j = 1; j <= k; ++j) t2 += j * G(0, j) * U(si, k - j);
            for (int32_t m = 1; m < k; ++m) t3 += q(m) * (k - m) * U(u, k - m);
            return (t1 + t2 + t3) / (kd * (1 - q(0)));
        }
        case OP_KEPF: {
            const int32_t si = op.meta0, ci = op.meta1;
            auto w = [&](int32_t m) {
                T s = 0;
                for (int32_t j = 0; j <= m; ++j)
                    s += G(0, j) * U(si, m - j) + G(1, j) * U(ci, m - j);
                return s;
            };
            T t1 = kd * G(2, k), t2 = 0, t3 = 0, t4 = 0;
            for (int32_t j = 1; j <= k; ++j) {
                t2 -= j * G(0, j) * U(ci, k - j);
                t3 += j * G(1, j) * U(si, k - j);
            }
            for (int32_t m = 1; m < k; ++m) t4 += w(m) * (k - m) * U(u, k - m);
            return (t1 + t2 + t3 + t4) / (kd * (1 - w(0)));
        }
        case OP_KEPDE: {
            const int32_t si = op.meta0, ci = op.meta1;
            auto w = [&](int32_t m) {
                T s = 0;
                for (int32_t j = 0; j <= m; ++j)
                    s += G(0, j) * U(si, m - j) - G(1, j) * U(ci, m - j);
                return s;
            };
            auto omc = [&](int32_t i) {
                return i == 0 ? (1 - U(ci, 0)) : -U(ci, i);
            };
            T t1 = kd * G(2, k), t2 = 0, t3 = 0, t4 = 0;
            for (int32_t j = 1; j <= k; ++j) {
                t2 -= j * G(0, j) * omc(k - j);
                t3 += j * G(1, j) * U(si, k - j);
            }
            for (int32_t m = 1; m < k; ++m) t4 -= w(m) * (k - m) * U(u, k - m);
            return (t1 + t2 + t3 + t4) / (kd * (1 + w(0)));
        }
    }
    return m_nan<T>();
}

// full jet: cc has (order+1) * n_u scalars, state preloaded into order 0
template <typename T>
void compute_jet(const Tape<T> &tp, T *cc, const T *pars, T t, int32_t order)
{
    const int32_t n_u = tp.n_eq + tp.n_ops;
    for (int32_t i = 0; i < tp.n_ops; ++i) {
        cc[tp.n_eq + i] = eval0(tp, tp.ops[i], cc, n_u, pars, t);
    }
    for (int32_t k = 1; k <= order; ++k) {
        T *row = cc + static_cast<std::size_t>(k) * n_u;
        for (int32_t i = 0; i < tp.n_eq; ++i) {
            row[i] = gval(cc, n_u, tp, pars, t, tp.rhs[i], k - 1) / k;
        }
        for (int32_t i = 0; i < tp.n_ops; ++i) {
            row[tp.n_eq + i]
                = rec(tp, tp.ops[i], tp.n_eq + i, cc, n_u, pars, t, k);
        }
    }
}

// Jorba rho step-size control (taylor_00.cpp:102-273 semantics)
template <typename T>
T determine_h(const T *cc, int32_t n_u, int32_t n_eq, int32_t order, T max_dt)
{
    T m0 = 0, mo = 0, mo1 = 0;
    for (int32_t i = 0; i < n_eq; ++i) {
        m0 = m_fmax(m0, m_fabs(cc[i]));
        mo = m_fmax(
            mo, m_fabs(cc[static_cast<std::size_t>(order) * n_u + i]));
        mo1 = m_fmax(
            mo1,
            m_fabs(cc[static_cast<std::size_t>(order - 1) * n_u + i]));
    }
    const T num = m0 <= 1 ? T(1) : m0;
    const T rho_o = m_pow(num / mo, T(1) / order);
    const T rho_o1 = m_pow(num / mo1, T(1) / (order - 1));
    const T rho = m_fmin(rho_o, rho_o1);
    // e*e as a product (not exp(2)) to match the python/double constant
    const T e1 = m_exp(T(1));
    const T fac = m_exp(T(-0.7) / (order - 1)) / (e1 * e1);
    T h = rho * fac;
    h = m_fmin(h, m_fabs(max_dt));
    return max_dt < 0 ? -h : h;
}

template <typename T>
void horner_update(const T *cc, int32_t n_u, int32_t n_eq, int32_t order,
                   T h, T *out)
{
    for (int32_t i = 0; i < n_eq; ++i) {
        T r = cc[static_cast<std::size_t>(order) * n_u + i];
        for (int32_t k = order - 1; k >= 0; --k) {
            r = cc[static_cast<std::size_t>(k) * n_u + i] + r * h;
        }
        out[i] = r;
    }
}

// high_accuracy state update: compensated-summation monomial evaluation
// (the native twin of stepper.ceval_update / taylor_run_ceval,
// taylor_00.cpp:355)
template <typename T>
void ceval_update(const T *cc, int32_t n_u, int32_t n_eq, int32_t order,
                  T h, T *out)
{
    for (int32_t i = 0; i < n_eq; ++i) {
        T res = cc[i];
        T comp = 0;
        T cur_h = h;
        for (int32_t k = 1; k <= order; ++k) {
            const T tmp = cc[static_cast<std::size_t>(k) * n_u + i] * cur_h;
            const T y = tmp - comp;
            const T t = res + y;
            comp = (t - res) - y;
            res = t;
            if (k < order) cur_h = cur_h * h;
        }
        out[i] = res;
    }
}

// double-length (Knuth two-sum) time accumulation, shared by the step and
// propagation drivers
template <typename T>
inline void dd_time_add(T &t_hi, T &t_lo, T h)
{
    const T s = t_hi + h;
    const T v = s - t_hi;
    const T err = (t_hi - (s - v)) + (h - v);
    t_lo += err;
    t_hi = s;
    const T s2 = t_hi + t_lo;
    t_lo = t_lo - (s2 - t_hi);
    t_hi = s2;
}

// One adaptive step: jet -> h -> state update -> dd time; cc (the full
// normalized coefficient jet, (order+1) x n_u) is left in out_cc for the
// caller (dense output, events, continuous output).  Returns h.
template <typename T>
T step_impl(const Tape<T> &tp, T *state, const T *pars, T *t_hi, T *t_lo,
            T max_dt, int32_t order, int32_t ha, T *out_cc)
{
    const int32_t n_u = tp.n_eq + tp.n_ops;
    std::memset(out_cc, 0,
                sizeof(T) * static_cast<std::size_t>(order + 1) * n_u);
    std::memcpy(out_cc, state, sizeof(T) * tp.n_eq);
    compute_jet(tp, out_cc, pars, *t_hi, order);
    const T h = determine_h(out_cc, n_u, tp.n_eq, order, max_dt);
    if (ha) {
        ceval_update(out_cc, n_u, tp.n_eq, order, h, state);
    } else {
        horner_update(out_cc, n_u, tp.n_eq, order, h, state);
    }
    dd_time_add(*t_hi, *t_lo, h);
    return h;
}

template <typename T>
Tape<T> build_tape(int32_t n_eq, int32_t n_ops, int32_t n_pars,
                   const int32_t *opcodes, const int32_t *arity,
                   const int32_t *inputs, const int32_t *meta,
                   const double *alpha, const double *consts,
                   int32_t n_consts, const int32_t *rhs)
{
    Tape<T> tp;
    tp.n_eq = n_eq;
    tp.n_ops = n_ops;
    tp.n_pars = n_pars;
    tp.ops.resize(n_ops);
    for (int32_t i = 0; i < n_ops; ++i) {
        TapeOp &op = tp.ops[i];
        op.opcode = opcodes[i];
        op.arity = arity[i];
        std::memcpy(op.in, inputs + static_cast<std::size_t>(i) * MAXA,
                    sizeof(int32_t) * MAXA);
        op.meta0 = meta[2 * i];
        op.meta1 = meta[2 * i + 1];
        op.alpha = alpha[i];
    }
    tp.consts.assign(consts, consts + n_consts);
    tp.rhs.assign(rhs, rhs + n_eq);
    return tp;
}

template <typename T>
void jet_impl(int32_t n_eq, int32_t n_ops, int32_t n_pars,
              const int32_t *opcodes, const int32_t *arity,
              const int32_t *inputs, const int32_t *meta, const double *alpha,
              const double *consts, int32_t n_consts, const int32_t *rhs,
              const T *state, const T *pars, T t, int32_t order, T *out_cc)
{
    const Tape<T> tp = build_tape<T>(n_eq, n_ops, n_pars, opcodes, arity,
                                     inputs, meta, alpha, consts, n_consts,
                                     rhs);
    const int32_t n_u = n_eq + n_ops;
    std::memset(out_cc, 0,
                sizeof(T) * static_cast<std::size_t>(order + 1) * n_u);
    std::memcpy(out_cc, state, sizeof(T) * n_eq);
    compute_jet(tp, out_cc, pars, t, order);
}

template <typename T>
int64_t propagate_until_impl(const Tape<T> &tp, T *state, const T *pars,
                             T *time_io, T target, T max_dt,
                             int64_t max_steps, int32_t order)
{
    const int32_t n_u = tp.n_eq + tp.n_ops;
    std::vector<T> cc(static_cast<std::size_t>(order + 1) * n_u);
    T t_hi = *time_io, t_lo = 0;
    const bool fwd = target >= t_hi;
    int64_t steps = 0;
    while (true) {
        const T rem = target - (t_hi + t_lo);
        if ((fwd && rem <= 0) || (!fwd && rem >= 0)) break;
        T cap = m_fmin(m_fabs(rem), max_dt);
        std::fill(cc.begin(), cc.end(), T(0));
        std::memcpy(cc.data(), state, sizeof(T) * tp.n_eq);
        compute_jet(tp, cc.data(), pars, t_hi, order);
        const T h
            = determine_h(cc.data(), n_u, tp.n_eq, order, fwd ? cap : -cap);
        horner_update(cc.data(), n_u, tp.n_eq, order, h, state);
        // double-length time accumulation (Knuth two-sum)
        {
            const T s = t_hi + h;
            const T v = s - t_hi;
            const T err = (t_hi - (s - v)) + (h - v);
            t_lo += err;
            t_hi = s;
            const T s2 = t_hi + t_lo;
            t_lo = t_lo - (s2 - t_hi);
            t_hi = s2;
        }
        ++steps;
        for (int32_t i = 0; i < tp.n_eq; ++i) {
            if (!m_isfinite(state[i])) {
                *time_io = t_hi + t_lo;
                return -steps;
            }
        }
        if (max_steps > 0 && steps >= max_steps) break;
    }
    *time_io = t_hi + t_lo;
    return steps;
}

// Full-parity adaptive propagate-until: dd time in/out, high_accuracy
// switch, min/max/last |h| statistics (h_stats[0]=min, [1]=max, [2]=last,
// signed).  Returns the step count (negative on non-finite state).
template <typename T>
int64_t propagate_until2_impl(const Tape<T> &tp, T *state, const T *pars,
                              T *t_hi_io, T *t_lo_io, T target, T max_dt,
                              int64_t max_steps, int32_t order, int32_t ha,
                              T *h_stats, T *last_cc = nullptr)
{
    const int32_t n_u = tp.n_eq + tp.n_ops;
    std::vector<T> cc_own;
    T *ccp = last_cc;
    if (!ccp) {
        cc_own.resize(static_cast<std::size_t>(order + 1) * n_u);
        ccp = cc_own.data();
    }
    T t_hi = *t_hi_io, t_lo = *t_lo_io;
    const bool fwd = target >= t_hi + t_lo;
    int64_t steps = 0;
    T min_h = std::numeric_limits<T>::infinity();
    T max_h = 0, last_h = 0;
    while (true) {
        const T rem = target - (t_hi + t_lo);
        if ((fwd && rem <= 0) || (!fwd && rem >= 0)) break;
        const T cap = m_fmin(m_fabs(rem), max_dt);
        const T h = step_impl(tp, state, pars, &t_hi, &t_lo,
                              fwd ? cap : -cap, order, ha, ccp);
        ++steps;
        last_h = h;
        min_h = m_fmin(min_h, m_fabs(h));
        max_h = m_fmax(max_h, m_fabs(h));
        for (int32_t i = 0; i < tp.n_eq; ++i) {
            if (!m_isfinite(state[i])) {
                *t_hi_io = t_hi;
                *t_lo_io = t_lo;
                if (h_stats) {
                    h_stats[0] = min_h; h_stats[1] = max_h; h_stats[2] = last_h;
                }
                return -steps;
            }
        }
        if (max_steps > 0 && steps >= max_steps) break;
    }
    *t_hi_io = t_hi;
    *t_lo_io = t_lo;
    if (h_stats) {
        h_stats[0] = min_h; h_stats[1] = max_h; h_stats[2] = last_h;
    }
    return steps;
}

} // namespace

extern "C" {

// Compute the normalized Taylor-coefficient jet:
// out_cc must hold (order+1) * (n_eq + n_ops) doubles.
void ht_jet(int32_t n_eq, int32_t n_ops, int32_t n_pars,
            const int32_t *opcodes, const int32_t *arity,
            const int32_t *inputs, const int32_t *meta, const double *alpha,
            const double *consts, int32_t n_consts, const int32_t *rhs,
            const double *state, const double *pars, double t, int32_t order,
            double *out_cc)
{
    jet_impl<double>(n_eq, n_ops, n_pars, opcodes, arity, inputs, meta,
                     alpha, consts, n_consts, rhs, state, pars, t, order,
                     out_cc);
}

// Extended-precision (80-bit long double) jet.
void ht_jet_ld(int32_t n_eq, int32_t n_ops, int32_t n_pars,
               const int32_t *opcodes, const int32_t *arity,
               const int32_t *inputs, const int32_t *meta,
               const double *alpha, const double *consts, int32_t n_consts,
               const int32_t *rhs, const long double *state,
               const long double *pars, long double t, int32_t order,
               long double *out_cc)
{
    jet_impl<long double>(n_eq, n_ops, n_pars, opcodes, arity, inputs, meta,
                          alpha, consts, n_consts, rhs, state, pars, t,
                          order, out_cc);
}

// Adaptive propagate-until; returns the step count (negative on non-finite
// state).  state is updated in place; *time_io tracks the current time.
int64_t ht_propagate_until(
    int32_t n_eq, int32_t n_ops, int32_t n_pars, const int32_t *opcodes,
    const int32_t *arity, const int32_t *inputs, const int32_t *meta,
    const double *alpha, const double *consts, int32_t n_consts,
    const int32_t *rhs, double *state, const double *pars, double *time_io,
    double target, double max_dt, int64_t max_steps, int32_t order)
{
    const Tape<double> tp = build_tape<double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    return propagate_until_impl<double>(tp, state, pars, time_io, target,
                                        max_dt, max_steps, order);
}

// Extended-precision adaptive propagate-until.
int64_t ht_propagate_until_ld(
    int32_t n_eq, int32_t n_ops, int32_t n_pars, const int32_t *opcodes,
    const int32_t *arity, const int32_t *inputs, const int32_t *meta,
    const double *alpha, const double *consts, int32_t n_consts,
    const int32_t *rhs, long double *state, const long double *pars,
    long double *time_io, long double target, long double max_dt,
    int64_t max_steps, int32_t order)
{
    const Tape<long double> tp = build_tape<long double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    return propagate_until_impl<long double>(tp, state, pars, time_io,
                                             target, max_dt, max_steps,
                                             order);
}

// Batched adaptive propagate-until: B independent trajectories, thread
// parallel (the host-runtime analog of the reference's batch mode, which
// reaches SIMD lanes via LLVM vector types + a TBB pool; trajectories are
// embarrassingly parallel, so here each OpenMP thread runs the scalar
// driver on its own lanes).  Per-lane step counts land in steps_out
// (negative on non-finite state).
void ht_propagate_until_batch(
    int32_t n_eq, int32_t n_ops, int32_t n_pars, const int32_t *opcodes,
    const int32_t *arity, const int32_t *inputs, const int32_t *meta,
    const double *alpha, const double *consts, int32_t n_consts,
    const int32_t *rhs, int32_t batch, double *states, const double *pars,
    double *times, const double *targets, double max_dt, int64_t max_steps,
    int32_t order, int64_t *steps_out)
{
    const Tape<double> tp = build_tape<double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    const int32_t stride = n_pars > 0 ? n_pars : 1;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
    for (int32_t b = 0; b < batch; ++b) {
        steps_out[b] = propagate_until_impl<double>(
            tp, states + static_cast<std::size_t>(b) * n_eq,
            pars + static_cast<std::size_t>(b) * stride, times + b,
            targets[b], max_dt, max_steps, order);
    }
}

// One adaptive step with full parity: dd time in/out, high_accuracy
// switch, Taylor-coefficient writeback ((order+1) x (n_eq+n_ops) into
// out_cc).  Returns the (signed) step h actually taken; the caller is
// responsible for clamping max_dt at the remaining time when landing on a
// target.  The backbone of taylor_adaptive(..., backend="native"): step(),
// propagate_grid, continuous output and host-side event detection all ride
// on it (reference per-step semantics: taylor_adaptive.cpp:725-1030).
double ht_step2(int32_t n_eq, int32_t n_ops, int32_t n_pars,
                const int32_t *opcodes, const int32_t *arity,
                const int32_t *inputs, const int32_t *meta,
                const double *alpha, const double *consts, int32_t n_consts,
                const int32_t *rhs, double *state, const double *pars,
                double *t_hi, double *t_lo, double max_dt, int32_t order,
                int32_t ha, double *out_cc)
{
    const Tape<double> tp = build_tape<double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    return step_impl<double>(tp, state, pars, t_hi, t_lo, max_dt, order, ha,
                             out_cc);
}

// Full-parity adaptive propagate-until (dd time io, high_accuracy,
// min/max/last h statistics); the fast path of
// taylor_adaptive(..., backend="native").propagate_until/for.
int64_t ht_propagate_until2(
    int32_t n_eq, int32_t n_ops, int32_t n_pars, const int32_t *opcodes,
    const int32_t *arity, const int32_t *inputs, const int32_t *meta,
    const double *alpha, const double *consts, int32_t n_consts,
    const int32_t *rhs, double *state, const double *pars, double *t_hi,
    double *t_lo, double target, double max_dt, int64_t max_steps,
    int32_t order, int32_t ha, double *h_stats, double *last_cc)
{
    const Tape<double> tp = build_tape<double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    return propagate_until2_impl<double>(tp, state, pars, t_hi, t_lo,
                                         target, max_dt, max_steps, order,
                                         ha, h_stats, last_cc);
}

// Batched single step (OpenMP over lanes): per-lane dd times, caps and
// coefficient jets — the native analog of taylor_adaptive_batch::step().
void ht_step_batch(int32_t n_eq, int32_t n_ops, int32_t n_pars,
                   const int32_t *opcodes, const int32_t *arity,
                   const int32_t *inputs, const int32_t *meta,
                   const double *alpha, const double *consts,
                   int32_t n_consts, const int32_t *rhs, int32_t batch,
                   double *states, const double *pars, double *t_his,
                   double *t_los, const double *max_dts, int32_t order,
                   int32_t ha, double *out_ccs, double *out_hs)
{
    const Tape<double> tp = build_tape<double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    const int32_t n_u = n_eq + n_ops;
    const std::size_t cc_stride
        = static_cast<std::size_t>(order + 1) * n_u;
    const int32_t pstride = n_pars > 0 ? n_pars : 1;
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
    for (int32_t b = 0; b < batch; ++b) {
        out_hs[b] = step_impl<double>(
            tp, states + static_cast<std::size_t>(b) * n_eq,
            pars + static_cast<std::size_t>(b) * pstride, t_his + b,
            t_los + b, max_dts[b], order, ha, out_ccs + b * cc_stride);
    }
}

// Batched full-parity propagate-until (OpenMP over lanes): dd times,
// high_accuracy, per-lane max_delta_t, per-lane h statistics (batch x 3),
// per-lane last-step Taylor jets (batch x (order+1) x n_u).
void ht_propagate_until2_batch(
    int32_t n_eq, int32_t n_ops, int32_t n_pars, const int32_t *opcodes,
    const int32_t *arity, const int32_t *inputs, const int32_t *meta,
    const double *alpha, const double *consts, int32_t n_consts,
    const int32_t *rhs, int32_t batch, double *states, const double *pars,
    double *t_his, double *t_los, const double *targets,
    const double *max_dts, int64_t max_steps, int32_t order, int32_t ha,
    double *h_stats, double *last_ccs, int64_t *steps_out)
{
    const Tape<double> tp = build_tape<double>(
        n_eq, n_ops, n_pars, opcodes, arity, inputs, meta, alpha, consts,
        n_consts, rhs);
    const int32_t pstride = n_pars > 0 ? n_pars : 1;
    const std::size_t cc_stride
        = static_cast<std::size_t>(order + 1) * (n_eq + n_ops);
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
    for (int32_t b = 0; b < batch; ++b) {
        steps_out[b] = propagate_until2_impl<double>(
            tp, states + static_cast<std::size_t>(b) * n_eq,
            pars + static_cast<std::size_t>(b) * pstride, t_his + b,
            t_los + b, targets[b], max_dts[b], max_steps, order, ha,
            h_stats + static_cast<std::size_t>(b) * 3,
            last_ccs ? last_ccs + b * cc_stride : nullptr);
    }
}

// Quad-precision (__float128) backends: tape literals/pars/times enter as
// double (they are python doubles anyway); states and coefficients cross
// the boundary as double-double (hi, lo) pairs, preserving ~106 of the 113
// bits.  The *internal* arithmetic is full quad — the accumulated error of
// a long propagation stays at the 1e-34 level (the reference's
// tut_arbitrary_precision f128 tier).
#if defined(__SIZEOF_FLOAT128__)

void ht_jet_f128(int32_t n_eq, int32_t n_ops, int32_t n_pars,
                 const int32_t *opcodes, const int32_t *arity,
                 const int32_t *inputs, const int32_t *meta,
                 const double *alpha, const double *consts, int32_t n_consts,
                 const int32_t *rhs, const double *state_hi,
                 const double *state_lo, const double *pars, double t_hi,
                 double t_lo, int32_t order, double *cc_hi, double *cc_lo)
{
    using Q = __float128;
    const Tape<Q> tp = build_tape<Q>(n_eq, n_ops, n_pars, opcodes, arity,
                                     inputs, meta, alpha, consts, n_consts,
                                     rhs);
    const int32_t n_u = n_eq + n_ops;
    std::vector<Q> st(n_eq), pr(n_pars > 0 ? n_pars : 1);
    for (int32_t i = 0; i < n_eq; ++i)
        st[i] = Q(state_hi[i]) + Q(state_lo[i]);
    for (int32_t i = 0; i < (n_pars > 0 ? n_pars : 1); ++i) pr[i] = Q(pars[i]);
    std::vector<Q> cc(static_cast<std::size_t>(order + 1) * n_u, Q(0));
    for (int32_t i = 0; i < n_eq; ++i) cc[i] = st[i];
    compute_jet(tp, cc.data(), pr.data(), Q(t_hi) + Q(t_lo), order);
    for (std::size_t i = 0; i < cc.size(); ++i) {
        const double hi = static_cast<double>(cc[i]);
        cc_hi[i] = hi;
        cc_lo[i] = static_cast<double>(cc[i] - Q(hi));
    }
}

int64_t ht_propagate_until_f128(
    int32_t n_eq, int32_t n_ops, int32_t n_pars, const int32_t *opcodes,
    const int32_t *arity, const int32_t *inputs, const int32_t *meta,
    const double *alpha, const double *consts, int32_t n_consts,
    const int32_t *rhs, double *state_hi, double *state_lo,
    const double *pars, double *time_hi, double *time_lo, double target,
    double max_dt, int64_t max_steps, int32_t order)
{
    using Q = __float128;
    const Tape<Q> tp = build_tape<Q>(n_eq, n_ops, n_pars, opcodes, arity,
                                     inputs, meta, alpha, consts, n_consts,
                                     rhs);
    std::vector<Q> st(n_eq), pr(n_pars > 0 ? n_pars : 1);
    for (int32_t i = 0; i < n_eq; ++i)
        st[i] = Q(state_hi[i]) + Q(state_lo[i]);
    for (int32_t i = 0; i < (n_pars > 0 ? n_pars : 1); ++i) pr[i] = Q(pars[i]);
    Q t = Q(*time_hi) + Q(*time_lo);
    const int64_t steps = propagate_until_impl<Q>(
        tp, st.data(), pr.data(), &t, Q(target), Q(max_dt), max_steps,
        order);
    for (int32_t i = 0; i < n_eq; ++i) {
        const double hi = static_cast<double>(st[i]);
        state_hi[i] = hi;
        state_lo[i] = static_cast<double>(st[i] - Q(hi));
    }
    const double th = static_cast<double>(t);
    *time_hi = th;
    *time_lo = static_cast<double>(t - Q(th));
    return steps;
}

#endif // __SIZEOF_FLOAT128__

} // extern "C"
