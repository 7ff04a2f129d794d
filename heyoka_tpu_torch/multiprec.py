"""Arbitrary-precision Taylor integration (the MPFR tier), on the host.

A copy of ``heyoka_tpu/multiprec.py`` on the port's front end: the same
mpmath interpreter of the decomposition tape (``taylor_decompose_sys`` of
the port, the native runtime's operand encoding through
:func:`.native.pack_tape`), the same per-op Taylor recurrences
and Jorba step control, at any number of decimal digits, with events
(the port's ``t_event``/``nt_event``) and dense output.  Reference:
heyoka's ``taylor_adaptive<mppp::real>`` (doc/tut_arbitrary_precision.rst;
the pendulum benchmark at tol=1e-77 with 256-bit reals,
doc/benchmarks.rst:225-239).

It runs in pure Python on the host, never on the card: a capability, not
a performance, backend, and the oracle of the port's jets, a third
implementation of the recurrences beside the JAX package's and the
kernels' twins (``tests/test_torch_multiprec.py``).  It needs mpmath,
imported at first use: ``import heyoka_tpu_torch`` does not.
"""

from __future__ import annotations

import numpy as np

from .expr.decompose import Tape
from .native import pack_tape

_TIME = -2000000
_PARBASE = -1000000


def _mp():
    import mpmath

    return mpmath


class MPTaylorIntegrator:
    """Adaptive Taylor integrator at ``dps`` decimal digits of precision.

    The Taylor order defaults to the optimal-order rule of the reference
    (ceil(-0.5 * ln(tol)) with tol = 10^-dps), like
    ``taylor_order_from_tol``.

    Accepts either a decomposed :class:`Tape` or an ODE system (list of
    ``(lhs, rhs)`` pairs, like ``taylor_adaptive``).  Event detection
    (``t_events=`` / ``nt_events=``, the classes from
    :mod:`heyoka_tpu_torch.taylor.events`) and dense output
    (:meth:`update_d_output`, :meth:`propagate_grid`) complete the API of
    this precision rung — the reference exposes the full integrator API at
    every fp type including MPFR ``real`` (``taylor.hpp:688-709``,
    ``test/event_detection_mp.cpp``, ``test/taylor_adaptive_mp.cpp``).
    Detection here is host-side: the event equations ride the tape as
    extra outputs, so their step polynomials fall out of the jet; roots in
    the step interval come from ``mpmath.polyroots`` (all roots of the
    degree-K polynomial — no missed crossings) filtered to the real window.
    """

    def __init__(self, tape, state, *, pars=None, time=0.0,
                 dps: int = 50, order: int | None = None,
                 t_events=(), nt_events=()):
        mp = _mp()
        self.t_events = list(t_events)
        self.nt_events = list(nt_events)
        if not isinstance(tape, Tape):
            # an ODE system: decompose here (required for events, whose
            # equations must be tape outputs)
            from .expr.decompose import taylor_decompose_sys

            ev_eqs = [ev.expression for ev in self.t_events] + [
                ev.expression for ev in self.nt_events
            ]
            tape = taylor_decompose_sys(tape, extra_outputs=ev_eqs)
        elif self.t_events or self.nt_events:
            raise ValueError(
                "events require the ODE system (the event equations must "
                "be decomposed into the tape): pass the [(lhs, rhs), ...] "
                "system instead of a Tape"
            )
        self.tape = tape
        self.p = pack_tape(tape)
        self.dps = int(dps)
        if order is None:
            with mp.workdps(self.dps):
                order = int(mp.ceil(-0.5 * mp.log(mp.mpf(10) ** -self.dps))) + 1
        self.order = int(order)
        with mp.workdps(self.dps):
            self.state = [mp.mpf(s) for s in np.asarray(state).tolist()]
            self.pars = [mp.mpf(v) for v in (
                np.asarray(pars).tolist() if pars is not None else []
            )]
            self.time = mp.mpf(time)
            self.consts = [mp.mpf(c) for c in self.p["consts"].tolist()]
        # dense-output block: Taylor coefficients / start time / h of the
        # last accepted step
        self._tc = None
        self._t_prev = None
        self.last_h = None
        # per-terminal-event cooldown expiry (absolute time)
        self._te_cd_until = [None] * len(self.t_events)
        # (time, index) of the last nt trigger, for same-root dedup
        self._nt_last = [None] * len(self.nt_events)
        #: index of the terminal event that stopped the last step (-1: none)
        self.te_triggered = -1

    # -- tape evaluation ---------------------------------------------------

    def _g(self, cc, code, k):
        """operand value at order k (G() of recurrences.py)."""
        mp = _mp()
        if code >= 0:
            return cc[k][code]
        if code == _TIME:
            return self._t if k == 0 else (mp.mpf(1) if k == 1 else mp.mpf(0))
        if code <= _PARBASE:
            return self.pars[_PARBASE - code] if k == 0 else mp.mpf(0)
        return self.consts[-1 - code] if k == 0 else mp.mpf(0)

    def _newton(self, f, fp, x0, wrap):
        mp = _mp()
        tol = mp.mpf(10) ** (-(self.dps - 2))
        x = x0
        for _ in range(200):
            d = f(x) / fp(x)
            x -= d
            if abs(d) < tol:
                break
        return x + wrap

    def _eval0(self, cc, op):
        mp = _mp()
        code, ar, ins, alpha = op
        g = lambda a: self._g(cc, ins[a], 0)  # noqa: E731
        if code == 0:
            return mp.fsum(g(a) for a in range(ar))
        if code == 1:
            return g(0) * g(1)
        if code == 2:
            return g(0) / g(1)
        if code == 3:
            return g(0) ** mp.mpf(alpha)
        table = {4: mp.sin, 5: mp.cos, 6: mp.sinh, 7: mp.cosh, 8: mp.tan,
                 9: mp.tanh, 10: mp.exp, 11: mp.log, 12: mp.sqrt,
                 14: mp.asin, 15: mp.acos, 16: mp.atan, 17: mp.asinh,
                 18: mp.acosh, 19: mp.atanh, 20: mp.erf}
        if code in table:
            return table[code](g(0))
        if code == 13:  # sigmoid
            return 1 / (1 + mp.exp(-g(0)))
        if code == 21:  # atan2
            return mp.atan2(g(0), g(1))
        if code == 22:  # relu
            return g(0) if g(0) > 0 else mp.mpf(0)
        if code == 23:  # relup
            return mp.mpf(1) if g(0) > 0 else mp.mpf(0)
        if code == 24:  # select
            return g(1) if g(0) != 0 else g(2)
        if 25 <= code <= 30:  # comparisons
            a, b = g(0), g(1)
            res = [a < b, a <= b, a > b, a >= b, a == b, a != b][code - 25]
            return mp.mpf(1) if res else mp.mpf(0)
        if code == 31:  # logical_and
            return mp.mpf(1) if all(g(a) != 0 for a in range(ar)) else mp.mpf(0)
        if code == 32:  # logical_or
            return mp.mpf(1) if any(g(a) != 0 for a in range(ar)) else mp.mpf(0)
        if code == 33:  # logical_not
            return mp.mpf(1) if g(0) == 0 else mp.mpf(0)
        if code == 34:  # kepE
            e, M = g(0), g(1)
            Mr = M - 2 * mp.pi * mp.floor(M / (2 * mp.pi))
            E0 = Mr + mp.mpf("0.85") * e * (1 if mp.sin(Mr) >= 0 else -1)
            E = self._newton(lambda E_: E_ - e * mp.sin(E_) - Mr,
                             lambda E_: 1 - e * mp.cos(E_), E0, M - Mr)
            return E
        if code == 35:  # kepF
            h, kk, lam = g(0), g(1), g(2)
            lr = lam - 2 * mp.pi * mp.floor(lam / (2 * mp.pi))
            F = self._newton(
                lambda F_: F_ + h * mp.cos(F_) - kk * mp.sin(F_) - lr,
                lambda F_: 1 - h * mp.sin(F_) - kk * mp.cos(F_), lr,
                lam - lr)
            return F
        if code == 36:  # kepDE
            s0, c0, DM = g(0), g(1), g(2)
            Dr = DM - 2 * mp.pi * mp.floor(DM / (2 * mp.pi))
            DE = self._newton(
                lambda D: D + s0 * (1 - mp.cos(D)) - c0 * mp.sin(D) - Dr,
                lambda D: 1 + s0 * mp.sin(D) - c0 * mp.cos(D), Dr, DM - Dr)
            return DE
        raise ValueError(f"unknown opcode {code}")

    def _rec(self, cc, op, u, meta, k):
        """order-k recurrence (same formulas as taperun.cpp / recurrences.py)."""
        mp = _mp()
        code, ar, ins, alpha = op
        G = lambda a, j: self._g(cc, ins[a], j)  # noqa: E731
        U = lambda i, j: cc[j][i]  # noqa: E731
        kd = mp.mpf(k)
        if code == 0:
            return mp.fsum(G(a, k) for a in range(ar))
        if code == 1:
            return mp.fsum(G(0, j) * G(1, k - j) for j in range(k + 1))
        if code == 2:
            s = mp.fsum(U(u, j) * G(1, k - j) for j in range(k))
            return (G(0, k) - s) / G(1, 0)
        if code == 3:
            al = mp.mpf(alpha)
            s = mp.fsum((al * (k - j) - j) * G(0, k - j) * U(u, j)
                        for j in range(k))
            return s / (kd * G(0, 0))
        if code in (4, 6, 7):  # sin/sinh/cosh (pair recurrence)
            s = mp.fsum(j * G(0, j) * U(meta[0], k - j) for j in range(1, k + 1))
            return s / kd
        if code == 5:  # cos
            s = mp.fsum(j * G(0, j) * U(meta[0], k - j) for j in range(1, k + 1))
            return -s / kd
        if code == 10:  # exp
            s = mp.fsum(j * G(0, j) * U(u, k - j) for j in range(1, k + 1))
            return s / kd
        if code == 11:  # log
            s = mp.fsum(j * U(u, j) * G(0, k - j) for j in range(1, k))
            return (G(0, k) - s / kd) / G(0, 0)
        if code == 12:  # sqrt
            s = mp.fsum(U(u, j) * U(u, k - j) for j in range(1, k))
            return (G(0, k) - s) / (2 * U(u, 0))
        if code == 8:  # tan
            s = mp.fsum(U(meta[0], m) * (k - m) * G(0, k - m) for m in range(k))
            return G(0, k) + s / kd
        if code == 9:  # tanh
            s = mp.fsum(U(meta[0], m) * (k - m) * G(0, k - m) for m in range(k))
            return G(0, k) - s / kd
        if code == 13:  # sigmoid
            s = mp.fsum((U(u, m) - U(meta[0], m)) * (k - m) * G(0, k - m)
                        for m in range(k))
            return s / kd
        if code in (14, 16, 17, 18, 19, 15):  # inverse trig family
            sign = -1 if code == 15 else 1
            s = mp.fsum(G(1, m) * (k - m) * U(u, k - m) for m in range(1, k))
            return (sign * kd * G(0, k) - s) / (kd * G(1, 0))
        if code == 20:  # erf
            s = mp.fsum(G(1, m) * (k - m) * G(0, k - m) for m in range(k))
            return (2 / mp.sqrt(mp.pi)) * s / kd
        if code == 21:  # atan2
            r1 = mp.fsum(G(1, m) * (k - m) * G(0, k - m) for m in range(k))
            r2 = mp.fsum(G(0, m) * (k - m) * G(1, k - m) for m in range(k))
            s = mp.fsum(G(2, m) * (k - m) * U(u, k - m) for m in range(1, k))
            return (r1 - r2 - s) / (kd * G(2, 0))
        if code == 22:  # relu
            return G(0, k) if G(0, 0) > 0 else mp.mpf(0)
        if code == 24:  # select
            return G(1, k) if G(0, 0) != 0 else G(2, k)
        if code == 23 or 25 <= code <= 33:  # relup / cmp / logical
            return mp.mpf(0)
        if code == 34:  # kepE
            si, ci = meta
            q = lambda m: mp.fsum(  # noqa: E731
                G(0, j) * U(ci, m - j) for j in range(m + 1))
            t1 = kd * G(1, k)
            t2 = mp.fsum(j * G(0, j) * U(si, k - j) for j in range(1, k + 1))
            t3 = mp.fsum(q(m) * (k - m) * U(u, k - m) for m in range(1, k))
            return (t1 + t2 + t3) / (kd * (1 - q(0)))
        if code == 35:  # kepF
            si, ci = meta
            w = lambda m: mp.fsum(  # noqa: E731
                G(0, j) * U(si, m - j) + G(1, j) * U(ci, m - j)
                for j in range(m + 1))
            t1 = kd * G(2, k)
            t2 = -mp.fsum(j * G(0, j) * U(ci, k - j) for j in range(1, k + 1))
            t3 = mp.fsum(j * G(1, j) * U(si, k - j) for j in range(1, k + 1))
            t4 = mp.fsum(w(m) * (k - m) * U(u, k - m) for m in range(1, k))
            return (t1 + t2 + t3 + t4) / (kd * (1 - w(0)))
        if code == 36:  # kepDE
            si, ci = meta
            w = lambda m: mp.fsum(  # noqa: E731
                G(0, j) * U(si, m - j) - G(1, j) * U(ci, m - j)
                for j in range(m + 1))
            omc = lambda i: (1 - U(ci, 0)) if i == 0 else -U(ci, i)  # noqa: E731
            t1 = kd * G(2, k)
            t2 = -mp.fsum(j * G(0, j) * omc(k - j) for j in range(1, k + 1))
            t3 = mp.fsum(j * G(1, j) * U(si, k - j) for j in range(1, k + 1))
            t4 = -mp.fsum(w(m) * (k - m) * U(u, k - m) for m in range(1, k))
            return (t1 + t2 + t3 + t4) / (kd * (1 + w(0)))
        raise ValueError(f"unknown opcode {code}")

    def _jet(self):
        mp = _mp()
        p = self.p
        n_eq = p["n_eq"]
        n_ops = p["n_ops"]
        n_u = n_eq + n_ops
        ops = [
            (int(p["opcodes"][i]), int(p["arity"][i]),
             p["inputs"][i].tolist(), float(p["alpha"][i]))
            for i in range(n_ops)
        ]
        metas = [
            [int(m) for m in np.asarray(p["meta"]).reshape(n_ops, 2)[i]]
            for i in range(n_ops)
        ]
        self._t = self.time
        cc = [[mp.mpf(0)] * n_u for _ in range(self.order + 1)]
        cc[0][:n_eq] = list(self.state)
        for i in range(n_ops):
            cc[0][n_eq + i] = self._eval0(cc, ops[i])
        rhs = p["rhs"].tolist()
        for k in range(1, self.order + 1):
            for i in range(n_eq):
                cc[k][i] = self._g(cc, rhs[i], k - 1) / k
            for i in range(n_ops):
                cc[k][n_eq + i] = self._rec(cc, ops[i], n_eq + i, metas[i], k)
        return cc

    # -- event detection -----------------------------------------------------

    def _oval(self, cc, operand, k):
        """value of a tape *output* operand at order k."""
        mp = _mp()
        kind = operand[0]
        if kind == "u":
            return cc[k][operand[1]]
        if kind == "t":
            return self._t if k == 0 else (mp.mpf(1) if k == 1 else mp.mpf(0))
        if kind == "p":
            return self.pars[operand[1]] if k == 0 else mp.mpf(0)
        return mp.mpf(operand[1]) if k == 0 else mp.mpf(0)

    def _poly_roots(self, coeffs, h):
        """real roots tau of sum_k coeffs[k] tau^k with tau/h in [0, 1),
        each as (tau, d_sgn); mpmath.polyroots finds ALL roots, so no
        crossing is missed (the reference's rigor bar,
        event_detection.cpp:1069)."""
        mp = _mp()
        if h == 0:
            return []
        # scale to the unit interval (b_k = c_k h^k, roots in s = tau/h):
        # the Taylor coefficients decay like rho^-k, so the scaled
        # polynomial is well-conditioned in f64 — isolation runs there
        # (np.roots companion eigenvalues, microseconds), and each real
        # candidate is polished by full-precision Newton on the mpmath
        # polynomial.  This mirrors the reference's isolate-then-polish
        # structure (event_detection.cpp: rtscc bisection + toms748);
        # mp.polyroots at degree ~60 / 50 dps costs ~20 s per call.
        scaled = []
        hk = mp.mpf(1)
        for c in coeffs:
            scaled.append(c * hk)
            hk *= h
        mag = max(abs(b) for b in scaled)
        if mag == 0:
            return []
        bf = np.array([float(b / mag) for b in scaled])
        nz = np.nonzero(bf)[0]
        if len(nz) == 0 or nz[-1] == 0:
            return []
        bf = bf[: nz[-1] + 1]
        cand = np.roots(bf[::-1])
        cand = [c for c in cand
                if abs(c.imag) < 1e-5 and -0.01 < c.real < 1.01]

        deg = len(scaled) - 1

        def g(s):
            r = scaled[deg]
            for k in range(deg - 1, -1, -1):
                r = scaled[k] + r * s
            return r

        def gp(s):
            r = deg * scaled[deg]
            for k in range(deg - 1, 0, -1):
                r = k * scaled[k] + r * s
            return r

        res_tol = mag * mp.mpf(10) ** (-(self.dps - 6))
        out = []
        seen: list = []
        for c in cand:
            s = mp.mpf(c.real)
            # Newton at dps+15 working digits: the correction can then
            # shrink below 10^-dps (at plain dps it floors at the
            # rounding noise of g and never meets the tolerance)
            with mp.extradps(15):
                for _ in range(100):
                    d = gp(s)
                    if d == 0:
                        break
                    corr = g(s) / d
                    s -= corr
                    if abs(corr) < mp.mpf(10) ** (-(self.dps + 5)):
                        break
            if abs(g(s)) > res_tol:
                continue
            # accept a hair below 0: a root at the shared boundary of two
            # steps polishes to s = 0 +- noise in the later step (the
            # earlier step sees it at s ~ 1, outside its half-open [0,1));
            # the dedup in _detect_events drops true double-counts
            if not (-mp.mpf(10) ** (-(self.dps - 15)) <= s < 1):
                continue
            s = max(s, mp.mpf(0))
            if any(abs(s - s0) < mp.mpf(10) ** (-(self.dps - 12))
                   for s0 in seen):
                continue
            seen.append(s)
            # crossing direction in *time*: sign of dg/dtau = gp(s)/h
            d = gp(s)
            d_sgn = 1 if d > 0 else (-1 if d < 0 else 0)
            if h < 0:
                d_sgn = -d_sgn
            out.append((s * h, d_sgn))
        out.sort(key=lambda rd: abs(rd[0]))
        return out

    def _detect_events(self, cc, h):
        """roots of every event polynomial inside the step [0, h):
        (earliest terminal (idx, tau, d_sgn) or None, nt hit list)."""
        mp = _mp()
        K = self.order
        n_te = len(self.t_events)
        outs = self.tape.outputs
        te_best = None
        nt_hits = []
        for i, ev in enumerate(self.t_events):
            coeffs = [self._oval(cc, outs[i], k) for k in range(K + 1)]
            for tau, d_sgn in self._poly_roots(coeffs, h):
                if ev.direction != 0 and d_sgn != int(ev.direction):
                    continue
                tr = self._t + tau
                cd = self._te_cd_until[i]
                if cd is not None and (
                    (h > 0 and tr <= cd) or (h < 0 and tr >= cd)
                ):
                    continue
                if te_best is None or abs(tau) < abs(te_best[1]):
                    te_best = (i, tau, d_sgn)
                break  # roots sorted by |tau|: first admissible is earliest
        for j, ev in enumerate(self.nt_events):
            coeffs = [self._oval(cc, outs[n_te + j], k) for k in range(K + 1)]
            for tau, d_sgn in self._poly_roots(coeffs, h):
                if ev.direction != 0 and d_sgn != int(ev.direction):
                    continue
                tr = self._t + tau
                last = self._nt_last[j]
                if last is not None and abs(tr - last) <= mp.mpf(10) ** (
                    -(self.dps - 10)
                ) * max(abs(tr), mp.mpf(1)):
                    continue  # same root re-seen at a step boundary
                if te_best is not None and abs(tau) >= abs(te_best[1]):
                    continue  # beyond the truncated step
                nt_hits.append((tr, j, d_sgn))
        nt_hits.sort(key=lambda x: abs(x[0] - self._t))
        return te_best, nt_hits

    # -- stepping ------------------------------------------------------------

    def _apply(self, cc, h):
        """Horner state update at step size h; stores the dense-output
        block (tc, t_prev, last_h)."""
        n_eq = self.p["n_eq"]
        K = self.order
        for i in range(n_eq):
            r = cc[K][i]
            for k in range(K - 1, -1, -1):
                r = cc[k][i] + r * h
            self.state[i] = r
        self._tc = cc
        self._t_prev = self.time
        self.last_h = h
        self.time += h

    def step(self, max_delta_t=None):
        """One adaptive Taylor step (Jorba rho control, Horner update);
        returns the step size taken.  With events configured, the step is
        truncated at the earliest terminal-event root (``te_triggered``
        records its index) and nt callbacks fire chronologically."""
        mp = _mp()
        with mp.workdps(self.dps):
            n_eq = self.p["n_eq"]
            K = self.order
            cc = self._jet()
            m0 = max(abs(v) for v in cc[0][:n_eq])
            mo = max(abs(v) for v in cc[K][:n_eq])
            mo1 = max(abs(v) for v in cc[K - 1][:n_eq])
            num = mp.mpf(1) if m0 <= 1 else m0
            rho = min((num / mo) ** (mp.mpf(1) / K),
                      (num / mo1) ** (mp.mpf(1) / (K - 1)))
            fac = mp.exp(mp.mpf("-0.7") / (K - 1)) / mp.exp(1) ** 2
            h = rho * fac
            if max_delta_t is not None:
                cap = mp.mpf(abs(max_delta_t))
                h = min(h, cap)
                if max_delta_t < 0:
                    h = -h
            self.te_triggered = -1
            if self.t_events or self.nt_events:
                te, nt_hits = self._detect_events(cc, h)
                if te is not None:
                    i, tau, d_sgn = te
                    h = tau
                self._apply(cc, h)
                for tr, j, _d in nt_hits:
                    self._nt_last[j] = tr
                    self.nt_events[j].callback(self, tr, _d)
                if te is not None:
                    ev = self.t_events[i]
                    cd = ev.cooldown
                    if cd is None:
                        # auto cooldown: wide enough to skip the just-fired
                        # root at the restart, narrow vs any real dynamics
                        cd = mp.mpf(10) ** (-(self.dps - 10)) * max(
                            abs(self.time), mp.mpf(1))
                    self._te_cd_until[i] = self.time + (
                        cd if h >= 0 else -cd)
                    self.te_triggered = i
                    if ev.callback is not None:
                        ev.callback(self, False, d_sgn)
            else:
                self._apply(cc, h)
            return h

    def propagate_until(self, target, *, max_steps: int = 0):
        """Adaptive propagation to ``target``; returns the step count.
        Stops early when a terminal event without a continuing callback
        triggers (``te_triggered`` holds its index)."""
        mp = _mp()
        with mp.workdps(self.dps):
            tgt = mp.mpf(target)
            fwd = tgt >= self.time
            steps = 0
            while (self.time < tgt) if fwd else (self.time > tgt):
                cap = tgt - self.time
                self.step(max_delta_t=cap if fwd else cap)
                steps += 1
                if self.te_triggered >= 0:
                    break
                if max_steps and steps >= max_steps:
                    break
            return steps

    # -- dense output ----------------------------------------------------

    def update_d_output(self, t):
        """Dense output: evaluate the last step's Taylor polynomials at
        absolute time ``t`` (must lie within the last step interval);
        returns the state list (reference ``update_d_output``,
        taylor_adaptive.cpp)."""
        mp = _mp()
        if self._tc is None:
            raise RuntimeError("no step taken yet (dense output empty)")
        with mp.workdps(self.dps):
            hr = mp.mpf(t) - self._t_prev
            n_eq = self.p["n_eq"]
            K = self.order
            out = []
            for i in range(n_eq):
                r = self._tc[K][i]
                for k in range(K - 1, -1, -1):
                    r = self._tc[k][i] + r * hr
                out.append(r)
            return out

    def propagate_grid(self, grid, *, max_steps: int = 0):
        """Dense-output sampling at the (monotone) ``grid`` times; returns
        a list of state rows (lists of mpf)."""
        mp = _mp()
        with mp.workdps(self.dps):
            pts = [mp.mpf(g) for g in np.asarray(grid, object).tolist()]
            if not pts:
                return []
            fwd = pts[-1] >= self.time
            res = []
            i = 0
            # grid points at/behind the current time: dense output if the
            # last step covers them, else current state
            while i < len(pts) and (
                (pts[i] <= self.time) if fwd else (pts[i] >= self.time)
            ):
                if self._tc is not None and pts[i] != self.time:
                    res.append(self.update_d_output(pts[i]))
                else:
                    res.append(list(self.state))
                i += 1
            steps = 0
            while i < len(pts):
                cap = pts[-1] - self.time
                self.step(max_delta_t=cap)
                steps += 1
                while i < len(pts) and (
                    (pts[i] <= self.time) if fwd else (pts[i] >= self.time)
                ):
                    res.append(self.update_d_output(pts[i]))
                    i += 1
                if self.te_triggered >= 0 or (max_steps and steps >= max_steps):
                    break
            return res
