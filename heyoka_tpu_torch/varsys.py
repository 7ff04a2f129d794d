"""Variational ODE systems (arbitrary differentiation order; a copy of
``heyoka_tpu.varsys`` whose initial conditions and Taylor map evaluate
through the port's :mod:`.cfunc`).

Reference parity: heyoka ``var_ode_sys`` (``include/heyoka/var_ode_sys.hpp:34-77``,
``src/var_ode_sys.cpp:177-330``): augment an ODE system with its variational
equations up to order k wrt initial conditions / params / initial time, plus
the helpers to set up the variational initial conditions
(``src/detail/setup_variational_ics.cpp``) and the Taylor-map evaluation
(``src/detail/vsys_data.cpp:114``, ``taylor_adaptive.cpp`` ``eval_taylor_map``).

Where the reference substitutes state variables with implicit-function
``dfun`` nodes and runs ``diff_tensors`` over them, here the same equations
come from iterating a *total-derivative* operator: for variational argument
``a``, ``D_a`` maps each (variational) state variable to its successor
derivative variable and adds the direct partial for parameters.  Both
formulations commute and produce identical RHS expressions; multi-indices
are enumerated exactly once with the canonical "extend only with args <=
the first already-used arg" walk (the same walk as ``expr.dtens``).

The augmented state is laid out in the reference's dtens flat order: the
original state (order 0), then the derivative blocks grouped by total
order, within each order by state component, within each component by the
dtens multi-index ordering (``setup_variational_ics.cpp:215-222`` write
indices; ``taylor_adaptive.cpp`` ``get_vslice``/``get_mindex``).
"""

from __future__ import annotations

import enum
import math as _pymath
from typing import Sequence

import numpy as np

from .expr.core import (
    Expr,
    Number,
    Param,
    TimeExpr,
    Variable,
    expr,
    get_params,
    get_variables,
    sum_expr,
)
from .expr.diff import diff
from .expr.dtens import dtens


class VarArgs(enum.IntEnum):
    """Which quantities to differentiate against (heyoka ``var_args``,
    ``var_ode_sys.hpp:29``)."""

    vars = 1  # initial conditions
    params = 2
    time = 4  # initial time
    all = 7


def _vname(counts, name: str) -> str:
    """Name of the variational variable ∂^counts x_name (names starting
    with '∂' are reserved, as in the reference)."""
    return f"∂[{','.join(str(c) for c in counts)}]{name}"


class var_ode_sys:
    """An ODE system augmented with variational equations up to ``order``.

    ``args`` is a :class:`VarArgs` selector or an explicit list of state
    variables / params / ``heyoka_tpu.time`` (derivative wrt the initial
    time), mirroring the reference ctor.
    """

    def __init__(self, sys, args=VarArgs.vars, order: int = 1):
        from .taylor.batch import _normalize_sys

        order = int(order)
        if order < 1:
            raise ValueError(
                "the 'order' argument to var_ode_sys must be nonzero"
            )
        self.orig_sys = _normalize_sys(sys)
        self.order = order
        n = len(self.orig_sys)
        xs = [lhs for lhs, _ in self.orig_sys]
        fs = [rhs for _, rhs in self.orig_sys]
        for x in xs:
            if x.name.startswith("∂"):
                raise ValueError(
                    "state variable names starting with '∂' are reserved "
                    "in a variational ODE system"
                )

        # -- the list of variational arguments --------------------------------
        if isinstance(args, VarArgs):
            arglist: list = []
            if args & VarArgs.vars:
                arglist += xs
            if args & VarArgs.params:
                arglist += [Param(i) for i in get_params(fs)]
            if args & VarArgs.time:
                arglist += [TimeExpr()]
        else:
            arglist = []
            names = {x.name for x in xs}
            for a in args:
                if isinstance(a, str):
                    a = Variable(a)
                a = expr(a)
                if isinstance(a, Variable) and a.name not in names:
                    raise ValueError(
                        f"cannot formulate variational equations wrt the "
                        f"initial conditions of '{a.name}': not a state "
                        f"variable"
                    )
                if not isinstance(a, (Variable, Param, TimeExpr)):
                    raise ValueError(
                        "variational arguments must be state variables, "
                        "params or time"
                    )
                arglist.append(a)
            if len(set(map(repr, arglist))) != len(arglist):
                raise ValueError("duplicate variational arguments")
        if not arglist:
            raise ValueError(
                "cannot formulate variational equations wrt an empty "
                "argument list"
            )
        self.vargs = arglist
        K = len(arglist)

        state_idx = {x.name: i for i, x in enumerate(xs)}

        # variational variable factory: (component, counts) -> Variable;
        # counts == zeros means the original state variable
        def vv(i, counts):
            if not any(counts):
                return xs[i]
            return Variable(_vname(counts, xs[i].name))

        # name -> (component, counts) decoder for the total derivative
        def decode(name):
            if not name.startswith("∂["):
                return state_idx[name], (0,) * K
            body, base = name[2:].split("]", 1)
            return state_idx[base], tuple(int(c) for c in body.split(","))

        def add(counts, j):
            nc = list(counts)
            nc[j] += 1
            return tuple(nc)

        def Dop(e: Expr, j: int) -> Expr:
            """Total derivative of ``e`` wrt variational argument j: every
            (variational) state variable maps to its successor derivative;
            params add their direct partial (the trajectory depends on all
            vargs, the analog of the reference's dfun substitution)."""
            terms = []
            for name in get_variables(e):
                i, counts = decode(name)
                pd = diff(e, Variable(name))
                if isinstance(pd, Number) and pd.value == 0:
                    continue
                terms.append(pd * vv(i, add(counts, j)))
            a = arglist[j]
            if isinstance(a, Param):
                terms.append(diff(e, a))
            # wrt an initial condition or the initial time there is no
            # direct dependence (t is the integration time, not t0)
            if not terms:
                return expr(0.0)
            return sum_expr(terms)

        # -- enumerate the variational equations (canonical walk) -------------
        entries: dict = {}
        level: dict = {}
        for i, f in enumerate(fs):
            key = (i, (0,) * K)
            entries[key] = f
            level[key] = f
        for _ord in range(1, order + 1):
            nxt: dict = {}
            for (i, counts), e in level.items():
                first_nz = next(
                    (a for a, c in enumerate(counts) if c), K - 1
                )
                for j in range(first_nz + 1):
                    key = (i, add(counts, j))
                    if key in nxt:
                        continue
                    nxt[key] = Dop(e, j)
            entries.update(nxt)
            level = nxt

        # dtens container: reference ``var_ode_sys::get_dtens()`` — the keys
        # define the augmented-state flat ordering, the values are the
        # variational RHS expressions
        args_hr = list(arglist)
        self._dt = dtens(entries, n, args_hr, order)

        self.sys = [
            (vv(i, counts), rhs) for (i, counts), rhs in self._dt.items()
        ]
        self.n_orig = n

    # -- introspection (reference var_ode_sys / taylor_adaptive API) ---------

    @property
    def n_vargs(self) -> int:
        return len(self.vargs)

    def get_dtens(self) -> dtens:
        return self._dt

    def get_mindex(self, i: int):
        """Multi-index key ``(component, counts)`` of augmented-state slot
        ``i`` (reference ``taylor_adaptive::get_mindex``)."""
        return self._dt.index_of(i)

    def get_vslice(self, order: int, component: int | None = None) -> slice:
        """Augmented-state slice holding the derivatives of total order
        ``order`` (optionally of one component) — reference
        ``taylor_adaptive::get_vslice``."""
        b, e = self._dt.get_derivatives_slice(order, component)
        return slice(b, e)

    # -- initial conditions ----------------------------------------------------

    def initial_state(self, state0, pars=None, t0=0.0) -> np.ndarray:
        """Full augmented initial state from the original initial conditions
        (heyoka ``setup_variational_ics``, ``setup_variational_ics.cpp:49``):
        order-1 blocks get the identity wrt initial conditions, zeros wrt
        params, ``-f(x0, t0)`` wrt the initial time; all higher-order blocks
        are zero.  Like the reference, t0-derivatives beyond order 1 have no
        automatic setup (``setup_variational_ics.cpp:146-152``).

        ``state0`` (n,) gives (len(sys),); the lanes of a batch, ``state0``
        (B, n) with ``pars`` (B, n_pars) and ``t0`` a scalar or (B,), give
        (B, len(sys)) in one call, equal to the rows one call a lane gives
        (``-f`` from one multi-evaluation of the port's CPU cfunc)."""
        state0 = np.asarray(state0, dtype=float)
        n = self.n_orig
        if state0.shape[-1:] != (n,) or state0.ndim not in (1, 2):
            raise ValueError(f"expected {n} initial conditions")
        has_time = any(isinstance(a, TimeExpr) for a in self.vargs)
        if has_time and self.order > 1:
            raise ValueError(
                "automatic variational initial conditions wrt the initial "
                "time are supported only at order 1 (as in the reference)"
            )
        f0 = None
        if has_time:
            from .cfunc import make_cfunc

            cf = make_cfunc(
                [rhs for _, rhs in self.orig_sys],
                vars=[lhs for lhs, _ in self.orig_sys],
                device="cpu",
            )
            t0 = np.asarray(t0, dtype=float)
            if state0.ndim == 2:
                t0 = np.array(np.broadcast_to(t0, state0.shape[:1]))
            f0 = cf(state0, pars=pars, time=t0).numpy()

        out = np.zeros(state0.shape[:-1] + (len(self.sys),), dtype=float)
        out[..., :n] = state0
        for pos, ((i, counts), _rhs) in enumerate(self._dt.items()):
            if sum(counts) != 1:
                continue
            j = next(a for a, c in enumerate(counts) if c)
            a = self.vargs[j]
            if isinstance(a, Variable):
                if a.name == self.orig_sys[i][0].name:
                    out[..., pos] = 1.0
            elif isinstance(a, TimeExpr):
                out[..., pos] = -f0[..., i]
        return out

    # -- Taylor map -------------------------------------------------------------

    def make_taylor_map(self, dtype=None, device="cuda"):
        """Compiled Taylor-map evaluator (reference
        ``vsys_data_create_tm_expr``, ``src/detail/vsys_data.cpp:114``):
        returns ``tm(deltas, var_state) -> state`` evaluating

            x_i(a + da) = sum_m  d^m x_i / prod(m_j!) * prod da_j^m_j

        where the derivative values come from the *augmented state* of the
        variational integrator (they ride in as cfunc pars, exactly like
        the reference's tm cfunc).  The cfunc runs on ``device`` in
        ``dtype`` (float64 by default, or float32): ``deltas`` (n_vargs,)
        with ``var_state`` (len(sys),) give (n_orig,), and (B, n_vargs)
        with (B, len(sys)) give (B, n_orig), a tensor there."""
        from .cfunc import make_cfunc

        K = self.n_vargs
        deltas = [Variable(f"delta_{j}") for j in range(K)]
        # exprs per original component, indexed by flat dtens position
        flat = self._dt.items()
        comp_terms: list[list] = [[] for _ in range(self.n_orig)]
        for pos, ((i, counts), _rhs) in enumerate(flat):
            coeff = 1.0
            for c in counts:
                coeff /= _pymath.factorial(c)
            term = Param(pos) * coeff if coeff != 1.0 else Param(pos)
            for j, c in enumerate(counts):
                for _ in range(c):
                    term = term * deltas[j]
            comp_terms[i].append(term)
        outs = [sum_expr(ts) for ts in comp_terms]
        cf = make_cfunc(outs, vars=deltas, device=device,
                        dtype=np.float64 if dtype is None else dtype)

        def tm(deltas_vals, var_state):
            return cf(deltas_vals, pars=var_state)

        return tm
