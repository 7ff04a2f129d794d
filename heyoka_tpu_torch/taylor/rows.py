"""The row-class partition of a tape for the rolled jet (kernel B3).

Copied from ``heyoka_tpu/taylor/pallas_phase.py`` (``_opsets`` :172,
``_row_classes`` :1480), restricted to the port's rule set ``{sum, mul,
div, sqrt, pow}``.  Plain numpy on a :class:`~.compact._Plan`.

A huge instance-regular tape (mascons, fixed centres) has most of its
columns consumed only at the order they are produced, or constant: only
the columns that a convolution reads at lower orders need their whole
``(K+1)``-order history.  The partition:

- **H** (class 0): full ``(K+1)`` history — every operand set of a
  convolution recurrence (``_opsets``), the state variables, the
  right-hand sides, the sv-func outputs and the time column;
- **C** (class 1): the current order only — op outputs read only at the
  order they are produced (``sum`` inputs, a ``div`` numerator, the
  argument of ``sqrt``);
- **V** (class 2): literals and parameters — a value at order 0 and zero
  above.
"""

from __future__ import annotations

import numpy as np


def _opsets(g):
    """Operand column sets of group ``g`` that its recurrence reads at
    orders below the current one (with the group's own outputs where the
    recurrence reads its own history)."""
    if g.name == "mul":
        return [g.in_cols[:, 0], g.in_cols[:, 1]]
    if g.name == "pow":
        return [g.out_cols, g.in_cols[:, 0]]
    if g.name == "div":
        return [g.out_cols, g.in_cols[:, 1]]
    if g.name == "sqrt":
        return [g.out_cols, g.in_cols[:, 0]]
    if g.name == "sum":
        return []
    raise ValueError(f"op {g.name!r} is outside the rolled jet's rule set")


def _row_classes(plan):
    """Partition the tape columns of ``plan`` into the classes H (0), C (1)
    and V (2).  Returns ``(classv, rowmap, sizes)``: the class of each
    column, each column's row within its class buffer (ascending column
    order) and the class sizes ``(WH, WC, WV)``."""
    W = plan.width
    n_eq = plan.n_eq
    need_h = np.zeros(W, bool)
    need_h[:n_eq] = True
    for lv in plan.levels:
        for g in lv:
            for cols in _opsets(g):
                need_h[np.asarray(cols)] = True
    if plan.rhs_cols.size:
        need_h[np.asarray(plan.rhs_cols)] = True
    if plan.out_cols.size:
        need_h[np.asarray(plan.out_cols)] = True

    classv = np.full(W, 2, np.int8)
    classv[:n_eq] = 0
    for lv in plan.levels:
        for g in lv:
            a, m = g.out_start, g.out_cols.size
            # per column: one merged instance-regular group can mix
            # convolution-read outputs (H) with current-order ones (C),
            # e.g. mascon's mul group of squares and mass products
            classv[a:a + m] = np.where(need_h[a:a + m], 0, 1)
    if plan.time_col is not None:
        classv[plan.time_col] = 0  # order-1 coefficient is 1, not 0
    rowmap = np.zeros(W, np.int64)
    sizes = []
    for cls in (0, 1, 2):
        idx = np.flatnonzero(classv == cls)
        rowmap[idx] = np.arange(idx.size)
        sizes.append(int(idx.size))
    return classv, rowmap, tuple(sizes)


#: the most literal factors an alias chain applies (csrc/taylor_jet_rolled.cu
#: ``AliasRec``); a column whose chain would apply more keeps its history
MAX_SCALES = 2


def _aliases(plan, classv):
    """The literal aliases among the H op columns of ``plan`` (classes
    ``classv`` from :func:`_row_classes`).

    A column ``a + literal`` (a ``sum`` of exactly one non-literal operand
    plus literals) has order k >= 1 equal to ``a[k]``, and a column
    ``literal * a`` (a ``mul`` of one non-literal operand and one literal,
    a constant or a parameter) equal to ``literal * a[k]``: the literals
    are zero above order 0, so the other terms of the jet's sum and Cauchy
    product are zeros, and the value is the same up to the sign of a zero.
    Such a column, if its source ``a`` is itself H or of this form, needs
    no history of its own: it keeps order 0 and its orders k >= 1 are read
    as its root's, scaled.  A chain may pass through a C column of this
    form (mascon's ``x - p_j`` is ``(-1 * x) + p_j``, and ``-1 * x`` is
    read at the current order only); it ends at an H column, its root.

    Returns ``{column: (root, scales)}`` for the H columns that are
    aliases, in column order: ``root`` the H column at the end of the
    chain, ``scales`` the literal columns the chain multiplies by,
    innermost first (applied one after the other, as the values were
    rounded).  A chain of more than ``MAX_SCALES`` multiplies stops: that
    column keeps its history and becomes a root."""
    lit = classv == 2
    if plan.time_col is not None:
        lit[plan.time_col] = False
    chain = {}  # every column of alias form with a root, H or C
    for lv in plan.levels:
        for g in lv:
            if g.name not in ("sum", "mul") or (
                    g.name == "mul" and g.in_cols.shape[1] != 2):
                continue
            for c, args in zip(g.out_cols, np.asarray(g.in_cols)):
                src = [int(a) for a in args if not lit[a]]
                if len(src) != 1:
                    continue
                s = src[0]
                if s in chain:
                    root, scales = chain[s]
                elif classv[s] == 0:
                    root, scales = s, ()
                else:
                    continue  # a current-order source keeps no history
                if g.name == "mul":
                    scales = scales + (int(args[0] if lit[args[0]]
                                           else args[1]),)
                if len(scales) <= MAX_SCALES:
                    chain[int(c)] = (root, scales)
    return {c: v for c, v in chain.items() if classv[c] == 0}
