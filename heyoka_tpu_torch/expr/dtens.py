"""Derivative tensors of arbitrary order (dtens; a copy of
``heyoka_tpu.expr.dtens``).

Reference parity: heyoka ``diff_tensors`` / ``dtens``
(``include/heyoka/expression.hpp:394-529``, ``src/expression_diff.cpp``,
``src/dtens.cpp``): derivative tensors of a vector function up to order k wrt
a selection of variables/params, with sparse multi-index storage.

Implementation: repeated symbolic differentiation over the shared DAG, with
the canonical "differentiate only wrt args <= the first already-used arg"
enumeration so every distinct multi-index is produced exactly once.  The
reference picks forward/reverse mode per pass for efficiency
(``expression_diff.cpp:770``); here both reduce to the same DAG-memoized
``diff`` since expressions stay shared.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from .core import Expr, Param, Variable, expr
from .diff import diff


def _norm_args(diff_args) -> list:
    out = []
    for a in diff_args:
        if isinstance(a, str):
            a = Variable(a)
        if not isinstance(a, (Variable, Param)):
            raise TypeError("diff args must be variables or params")
        out.append(a)
    if len(out) == 0:
        raise ValueError("at least one differentiation argument required")
    return out


class dtens:
    """Sparse container of derivative tensors.

    Entries are keyed by ``(component, counts)`` where ``counts`` is a tuple
    of per-argument derivative orders (heyoka's dense multi-index form,
    ``dtens.cpp``).
    """

    def __init__(self, entries: dict, n_outs: int, args: list, order: int):
        self._entries = entries
        self._n_outs = n_outs
        self._args = args
        self._order = order

    @property
    def order(self) -> int:
        return self._order

    @property
    def nouts(self) -> int:
        return self._n_outs

    @property
    def nargs(self) -> int:
        return len(self._args)

    @property
    def args(self) -> list:
        return list(self._args)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, key):
        comp, counts = key
        return self._entries[(int(comp), tuple(int(c) for c in counts))]

    def __contains__(self, key):
        comp, counts = key
        return (int(comp), tuple(int(c) for c in counts)) in self._entries

    def index_set(self):
        return sorted(self._entries.keys())

    # -- flat (graded) ordering ------------------------------------------------
    # The reference's dtens is an ordered container: entries sorted by total
    # derivative order, then component, then multi-index (dtens.cpp).  The
    # flat position in this ordering is what ``get_dslice``/``get_mindex``
    # expose (``sgp4_propagator::get_dslice``, ``model/sgp4.hpp:190-192``).

    def _flat(self):
        if not hasattr(self, "_flat_cache"):
            out = []
            for o in range(self._order + 1):
                out.extend(self.get_derivatives(o))
            self._flat_cache = out
        return self._flat_cache

    def __iter__(self):
        return iter(self._flat())

    def items(self):
        return list(self._flat())

    def index_of(self, i: int):
        """Multi-index key ``(component, counts)`` at flat position ``i``."""
        return self._flat()[i][0]

    def get_derivatives_slice(self, order: int, component: int | None = None):
        """``(begin, end)`` flat-position range of the derivatives at a given
        total order (optionally of a single component)."""
        flat = self._flat()
        idxs = [
            i
            for i, (k, _) in enumerate(flat)
            if sum(k[1]) == order and (component is None or k[0] == component)
        ]
        if not idxs:
            raise ValueError(f"no derivatives at order {order}")
        return idxs[0], idxs[-1] + 1

    def get_derivatives(self, order: int, component: int | None = None):
        """All ((component, counts), expr) at a given total order, sorted."""
        out = [
            (k, v)
            for k, v in self._entries.items()
            if sum(k[1]) == order and (component is None or k[0] == component)
        ]
        # sort by (component, earliest-arg-first): reversing the counts tuple
        # makes d/d a_0 sort before d/d a_1 (graded ordering like the
        # reference's dtens indexing, dtens.cpp)
        out.sort(key=lambda kv: (kv[0][0], kv[0][1][::-1]))
        return out

    # -- convenience extractors (heyoka gradient()/jacobian()/hessian()) -----

    def gradient(self) -> list:
        if self._n_outs != 1:
            raise ValueError("gradient() requires a single-output function")
        return [e for _, e in self.get_derivatives(1, component=0)]

    def jacobian(self) -> list:
        return [
            [e for _, e in self.get_derivatives(1, component=i)]
            for i in range(self._n_outs)
        ]

    def hessian(self, component: int = 0):
        """Dense symmetric Hessian (list of lists) for one component."""
        n = self.nargs
        H = [[None] * n for _ in range(n)]
        for (comp, counts), e in self.get_derivatives(2, component=component):
            idxs = [i for i, c in enumerate(counts) for _ in range(c)]
            i, j = idxs[0], idxs[-1]
            H[i][j] = e
            H[j][i] = e
        return H


def diff_tensors(fns: Sequence, diff_args: Iterable, diff_order: int = 1) -> dtens:
    """Derivative tensors of ``fns`` wrt ``diff_args`` up to ``diff_order``
    (heyoka ``diff_tensors``, ``expression.hpp:394-529``)."""
    fns = [expr(f) for f in fns]
    args = _norm_args(diff_args)
    diff_order = int(diff_order)
    if diff_order < 0:
        raise ValueError("diff_order must be non-negative")
    n = len(args)

    entries: dict = {}
    level: dict = {}
    for fi, f in enumerate(fns):
        key = (fi, (0,) * n)
        entries[key] = f
        level[key] = f

    for _ord in range(1, diff_order + 1):
        nxt: dict = {}
        for (fi, counts), e in level.items():
            # first argument already differentiated (lowest index with
            # nonzero count); only differentiate wrt args <= it, so each
            # multi-index is generated exactly once
            first_nz = next((i for i, c in enumerate(counts) if c), n - 1)
            for j in range(first_nz + 1):
                nc = list(counts)
                nc[j] += 1
                key = (fi, tuple(nc))
                if key in nxt:
                    continue
                nxt[key] = diff(e, args[j])
        entries.update(nxt)
        level = nxt

    return dtens(entries, len(fns), args, diff_order)
