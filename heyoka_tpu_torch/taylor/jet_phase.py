"""The phase jet (kernel B4): Taylor orders ``lo..K`` of every tape column
over the whole recurrence rule set, its wrapper and its plain torch twin.

It replaces ``make_phase_kernel`` (``heyoka_tpu/taylor/pallas_phase.py:
899``), whose rules are ``_rule`` (:633) and ``_synth_w`` (:206), and
whose f64 yardstick is the staged engine's ``_f_*`` rules
(``heyoka_tpu/taylor/compact_flat.py:1311-1569``).  The JAX package
reaches its kernel with ``pallas_phase=True``: order 0 in f64 XLA, orders
``mp_order+1..K`` in f32 in the kernel.  The H100 has f64, so here one
run from ``lo = 1`` gives the whole jet in the buffer's dtype, f64 or
f32 (the integrators' ``dtype=float32``):

- :func:`order0`: order 0 of every group in level order, with the
  numeric rules of :mod:`..expr.numeric`, in the buffer's dtype;
- :func:`phase`: orders ``lo..K`` in place on a ``(K+1, W, B)`` f64 or
  f32 buffer.  A CPU tensor runs :func:`phase_plain`; a CUDA tensor
  launches ``hy_phase_f64`` or ``hy_phase_f32`` (``csrc/taylor_phase.cu``,
  ``ENTRIES``) or raises, never casting;
- :func:`jet_phase`: the contract of ``jet_kernels.jet`` over the two.

This is the port's route for every tape with an op outside kernels
B1/B2/B3's rule set (``convert.JET_OPS``), and for every f32 tape.  The buffer is worked on in
place, so the caller seeds it: orders >= 1 of the virtual columns
(literals, parameters, time) zero, the time column's order 1 one
(``jet_kernels._seed_plain``).  Neither the kernel nor the twin writes a
virtual column or order 0.

Auxiliary columns (the sin/cos ``pair``, the ``sq`` of tan/tanh/sigmoid,
the Kepler ``sin``/``cos``) come after their op in the tape; every rule
reads them only below the current order.  The Kepler ops' synthetic
series (kepE q = e cos E; kepF w = h sin F + k cos F; kepDE w = s0 sin DE
- c0 cos DE) live in a ``(K+1, n_syn, B)`` buffer, one row per Kepler
column, filled for orders below ``lo`` first and then once per order, as
the JAX kernel keeps ``hist[(gi, "synth")]``.

Dense trig series (``expr/series.py``): :func:`order0` fills the series
columns' orders ``0..K`` together (``PhaseTape.ser_launches``: before the
first group that reads one, once a step on the ephemeris tapes), through
``series_jet.series_jets`` (kernel S1 on the card, each entry launched
once) at ``u0`` the input columns' order 0 and ``u1`` their rates
(``series_jet.AffineInput``), into a read-only ``(K+1, n_ser, B)`` buffer
``ser`` that it returns; the twin and kernel B4 copy order k of a column
from it.

Dataset interpolants (``eop_sw.py``: opcode ``interp``, their slopes
``interp_p``) and ``dayfrac``: :func:`order0` gives an interpolant
column its value and writes the lane's slope at the input, ``S =
slope(u_0)``, into a side row after the series rows (order 0 of row
``n_ser + j`` of the same buffer, which it then returns, now ``(K+1,
n_side, B)``: the other orders of a slope row are never read); above
order 0 the reference's recurrences run in the twin and in kernel B4:
``a_k = S u_k`` for an interpolant (``eop_sw.py:512-521`` of the JAX
package, for any input), ``0`` for a slope and ``a_k = u_k`` for
``dayfrac`` (``models/dayfrac.py:87``).  NaN out of a table's range
stays NaN: ``S`` is NaN there.
"""

from __future__ import annotations

import math as _pymath
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .. import eop_sw
from ..convert import (
    AUX_KEYS, INTERP, PHASE_OPS, SERIES, op_kind, series_names,
)
from ..expr.numeric import evaluate
from .jet_kernels import (
    LAUNCHES, SMS, SMEM_MAX, JetTape, _F64, _HDR, _HDR_LEN,
    _check, _device_of, _eval0, _eval_k, _norms, _ptr, _rows, _seed_plain,
    _sms, blocks_per_sm, table_bytes,
)

#: kernel B4's C entry and its ``LAUNCHES`` counter for each dtype of the
#: buffer; another dtype raises
ENTRIES = {torch.float64: ("hy_phase_f64", "phase"),
           torch.float32: ("hy_phase_f32", "phase_f32")}
from .series_jet import AffineInput, series_jets, tables_on, work_of

#: header of the phase kernels' int32 table (csrc/taylor_common.cuh ``enum
#: Hdr``): ``jet_kernels._HDR``, then the offsets of the level table (the
#: first column of each level, then one past the last op column), the
#: opcode of each op column, the op column of each synthetic row, the aux
#: table (two slots per op column, -1 where unused) and the side-row
#: table (one per op column: a Kepler column's synthetic row, a series
#: column's or an interpolant's row of the side buffer, -1 elsewhere), and
#: the numbers of synthetic rows and of levels
_PHDR = _HDR + ("lvl", "cop", "syncol", "aux", "syn", "n_syn", "n_lv")
assert len(_PHDR) == _HDR_LEN

#: ops with a synthetic convolution series
SYNTH = ("kepE", "kepF", "kepDE")

_TWO_SQRTPI = 2.0 / _pymath.sqrt(_pymath.pi)


class PhaseTape(JetTape):
    """A :class:`JetTape` over the whole rule set ``convert.PHASE_OPS``,
    with the aux columns, the Kepler synthetic rows, the dense series and
    the interpolants' slope rows: the twin's groups ``pgroups``, kernel
    B4's packed tables (``itab``, ``dtab``, header ``_PHDR``), per series
    row in column order ``series`` ``(column, AffineInput,
    SeriesTables)``, and the side buffer's rows ``n_side = n_ser +
    n_slope`` (the series', then one for each interpolant column, in
    column order).  Raises ValueError where a series op's input is not
    affine in time."""

    RULES = PHASE_OPS

    def __init__(self, arrays: dict, device):
        super().__init__(arrays, device)
        aux, syn = arrays["aux"], self._syn_rows(arrays)
        ser = np.asarray(arrays["ser"], np.int64)
        side = side_rows(arrays)
        n_eq = self.n_eq
        self.n_syn = int(syn.max(initial=-1)) + 1
        self.lvl = level_table(arrays)
        self._shapes = {}  # (B, itemsize, device) -> block_shape's default
        names = series_names(arrays)
        self.series = [
            (n_eq + int(o), AffineInput(arrays, n_eq + int(o), names),
             tables_on(names[int(ser[o])], self.device))
            for o in np.flatnonzero(ser >= 0)]
        self.n_ser = len(self.series)
        self.n_slope = int(
            (op_codes(arrays) == PHASE_OPS.index(INTERP)).sum())
        self.n_side = self.n_ser + self.n_slope

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        # per group, in level order: (op name, first column, rows, operand
        # columns, pow exponents, aux key -> columns, synthetic rows or,
        # for a series or an interpolant, its rows of the side buffer)
        self.pgroups = []
        for name, s, m, cols, alpha in self.groups:
            o = slice(s - n_eq, s - n_eq + m)
            r0 = int(side[o][0])
            self.pgroups.append((
                name, s, m, cols, alpha,
                {key: idx(aux[o, slot])
                 for slot, key in enumerate(AUX_KEYS.get(name, ()))},
                None if r0 < 0 else (r0, r0 + m)))
        self.ser_launches = series_launches(arrays, self.pgroups,
                                            self.series)

    @staticmethod
    def _syn_rows(a):
        """The synthetic row of every op column (-1 for non-Kepler ones):
        the Kepler columns in column order."""
        n_eq = int(a["meta"][1])
        syn = np.full(a["arg_ptr"].size - 1, -1, np.int64)
        nxt = 0
        for op, s, m in zip(a["g_op"], a["g_start"], a["g_m"]):
            if PHASE_OPS[int(op)] in SYNTH:
                syn[s - n_eq:s - n_eq + m] = np.arange(nxt, nxt + m)
                nxt += m
        return syn

    def _pack(self, a, norm):
        syn = self._syn_rows(a)
        lvl = level_table(a)
        check_levels(a, lvl)
        side = side_rows(a)
        return super()._pack(
            a, norm, {"lvl": lvl, "cop": op_codes(a),
                      "syncol": np.flatnonzero(syn >= 0),
                      "aux": np.asarray(a["aux"]).reshape(-1), "syn": side},
            {"n_syn": int(syn.max(initial=-1)) + 1, "n_lv": lvl.size - 1})


def series_launches(a, pgroups, series) -> dict:
    """Where :func:`order0` runs kernel S1: ``{group index: series rows}``,
    the rows' jets made just before that group (a key ``len(pgroups)``:
    at the end of order 0).  The series columns met in level order wait
    together until a group reads one of them: their inputs are affine in
    time (:class:`AffineInput`) and set by then.  So a tape on which no
    group reads a series before the last series' level (the ELP2000's,
    planet 9's) runs each entry of kernel S1 once a step."""
    n_eq = int(a["meta"][1])
    ptr, args = a["arg_ptr"], a["args"]
    row_of = {col: r for r, (col, _, _) in enumerate(series)}
    out, pending = {}, []
    for gi, (name, s, m, *_) in enumerate(pgroups):
        ops = args[ptr[s - n_eq]:ptr[s - n_eq + m]]
        if pending and any(row_of.get(int(c), -1) in pending for c in ops):
            out[gi], pending = tuple(pending), []
        if op_kind(name) == SERIES:
            pending += [row_of[c] for c in range(s, s + m)]
    if pending:
        out[len(pgroups)] = tuple(pending)
    return out


def side_rows(a) -> np.ndarray:
    """The row of every op column of plan arrays ``a`` in its side rows,
    -1 for none: a Kepler column's synthetic row, a series column's row of
    the side buffer (its series, in column order), an interpolant's row
    ``n_ser + j`` there (the ``j``-th interpolant column)."""
    syn = PhaseTape._syn_rows(a)
    ser = np.asarray(a["ser"], np.int64)
    side = np.where(ser >= 0, ser, syn)
    itp = np.flatnonzero(op_codes(a) == PHASE_OPS.index(INTERP))
    side[itp] = int((ser >= 0).sum()) + np.arange(itp.size)
    return side


def level_table(a) -> np.ndarray:
    """The first column of each level of a plan's arrays, then one past the
    last op column: the kernels' passes.  Raises ValueError unless every
    level's groups hold contiguous columns, in level order, from ``n_eq``
    on (``build_plan`` lays them out so)."""
    n_eq = int(a["meta"][1])
    n_w = n_eq + a["arg_ptr"].size - 1
    lvl, end = [], n_eq
    for li in range(int(a["g_level"].max(initial=-1)) + 1):
        lvl.append(end)
        for s, m in zip(a["g_start"][a["g_level"] == li],
                        a["g_m"][a["g_level"] == li]):
            if s != end:
                raise ValueError(f"level {li}: a group starts at column {s}, "
                                 f"not {end}")
            end += int(m)
    if end != n_w or np.any(np.diff(a["g_level"]) < 0):
        raise ValueError("the levels do not cover the op columns in order")
    return np.array(lvl + [n_w], np.int64)


def op_codes(a) -> np.ndarray:
    """The opcode (``convert.OPCODES``) of every op column."""
    n_eq = int(a["meta"][1])
    cop = np.empty(a["arg_ptr"].size - 1, np.int64)
    for op, s, m in zip(a["g_op"], a["g_start"], a["g_m"]):
        cop[s - n_eq:s - n_eq + m] = op
    return cop


def check_levels(a, lvl) -> None:
    """Raise ValueError unless every operand of every op column lies in an
    earlier level (or is a state or virtual column).  The kernels run a
    level's items in one pass, so an item must not read, at the order being
    computed, a column written in the same pass; every rule reads at that
    order its operands only (its own column, the aux columns and the
    synthetic rows below it), so this check covers them all."""
    n_eq = int(a["meta"][1])
    n_w = int(lvl[-1])
    col_lvl = np.full(int(a["meta"][0]), -1, np.int64)
    for v in range(lvl.size - 1):
        col_lvl[lvl[v]:lvl[v + 1]] = v
    ptr, args = a["arg_ptr"], a["args"]
    for c in range(n_eq, n_w):
        ops = args[ptr[c - n_eq]:ptr[c - n_eq + 1]]
        ops = ops[ops != c]  # its own column: below the order only
        if ops.size and col_lvl[ops].max() >= col_lvl[c]:
            raise ValueError(f"column {c} (level {col_lvl[c]}) reads a "
                             f"column of level {col_lvl[ops].max()}")


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _hist(tc, syn, s, m, cols, aux, srows, side=None):
    """``hist(q, j0, j1)``: orders ``j0..j1-1`` of one group's operand set
    ``q`` as ``(j1 - j0, m, B)`` — an int is an operand (``in_cols[:,
    q]``), -1 the group's own columns, a string an aux key, ``"syn"`` the
    group's synthetic rows, ``"side"`` its rows of the side buffer."""
    def hist(q, j0, j1):
        if q == -1:
            return tc[j0:j1, s:s + m]
        if q == "syn":
            return syn[j0:j1, srows[0]:srows[1]]
        if q == "side":
            return side[j0:j1, srows[0]:srows[1]]
        c = aux[q] if isinstance(q, str) else cols[:, q]
        return tc[j0:j1].index_select(1, c)
    return hist


def _wts(a, b, like):
    """Weights ``a, a+1, ..., b-1`` (or down to ``b+1`` for ``a > b``) as
    an ``(n, 1, 1)`` column of ``like``'s dtype and device."""
    step = 1 if b >= a else -1
    return torch.arange(a, b, step, dtype=like.dtype,
                        device=like.device)[:, None, None]


def _conv(w, A, Bf):
    """``sum_j (w_j A_j) Bf_j`` over the order axis: the products in the
    kernel's order, the sum vectorised."""
    return ((w * A) * Bf).sum(0)


def _phase_k(name, alpha, k: int, hist, nargs: int, like):
    """Order ``k`` (>= 1) of one group's columns (``_rule`` in ``like``'s
    dtype, the buffer's).  Every rule reads aux and synthetic rows below
    order ``k`` only."""
    if name in ("sum", "mul", "div", "sqrt", "pow"):
        return _eval_k(name, alpha, k, hist, nargs)
    kind = op_kind(name)
    if kind == INTERP:
        # a_k = S u_k, S the lane's slope at u_0 (order 0 of its side row)
        return hist("side", 0, 1)[0] * hist(0, k, k + 1)[0]
    if kind == "dayfrac":
        return hist(0, k, k + 1)[0]
    up = _wts(1, k + 1, like)    # j = 1..k
    dn = _wts(k, 0, like)        # k - m for m = 0..k-1
    dn1 = _wts(k - 1, 0, like)   # k - m for m = 1..k-1
    if name == "exp":
        # e_k = (sum_{j=1..k} j b_j e_{k-j}) / k
        return _conv(up, hist(0, 1, k + 1), hist(-1, 0, k).flip(0)) / k
    if name in ("sin", "cos", "sinh", "cosh"):
        # s_k = +-(sum_{j=1..k} j b_j p_{k-j}) / k, p the pair column
        v = _conv(up, hist(0, 1, k + 1), hist("pair", 0, k).flip(0)) / k
        return -v if name == "cos" else v
    if name == "log":
        # c_k = (b_k - (sum_{j=1..k-1} j c_j b_{k-j}) / k) / b_0
        s = _conv(_wts(1, k, like), hist(-1, 1, k), hist(0, 1, k).flip(0))
        return (hist(0, k, k + 1)[0] - s / k) / hist(0, 0, 1)[0]
    if name in ("tan", "tanh"):
        # t_k = b_k +- (sum_{m=0..k-1} (k-m) q_m b_{k-m}) / k, q = t^2
        s = _conv(dn, hist("sq", 0, k), hist(0, 1, k + 1).flip(0)) / k
        bk = hist(0, k, k + 1)[0]
        return bk + s if name == "tan" else bk - s
    if name == "sigmoid":
        # s_k = (sum_{m=0..k-1} (k-m) (s_m - q_m) b_{k-m}) / k, q = s^2
        d = hist(-1, 0, k) - hist("sq", 0, k)
        return _conv(dn, d, hist(0, 1, k + 1).flip(0)) / k
    if name in ("asin", "acos", "atan", "atanh", "asinh", "acosh"):
        # a c = +-b' with the aux operand c (in_cols[:, 1]):
        # a_k = (+-b_k - (sum_{m=1..k-1} (k-m) c_m a_{k-m}) / k) / c_0
        s = _conv(dn1, hist(1, 1, k), hist(-1, 1, k).flip(0))
        bk = hist(0, k, k + 1)[0]
        return ((-bk if name == "acos" else bk) - s / k) / hist(1, 0, 1)[0]
    if name == "erf":
        # (2/sqrt(pi)) (sum_{m=0..k-1} (k-m) e_m b_{k-m}) / k,
        # e = exp(-b^2) (in_cols[:, 1])
        return _TWO_SQRTPI * (
            _conv(dn, hist(1, 0, k), hist(0, 1, k + 1).flip(0)) / k)
    if name == "atan2":
        # a = atan2(y, x), d = x^2 + y^2: a_k = (sum_{m<k} (k-m) (x_m
        # y_{k-m} - y_m x_{k-m}) - sum_{1<=m<k} (k-m) d_m a_{k-m}) / (k d_0)
        Y, X = hist(0, 0, k + 1), hist(1, 0, k + 1)
        r = (dn * (X[:k] * Y[1:].flip(0))).sum(0) \
            - (dn * (Y[:k] * X[1:].flip(0))).sum(0)
        s = (dn1 * (hist(2, 1, k) * hist(-1, 1, k).flip(0))).sum(0)
        return (r - s) / (k * hist(2, 0, 1)[0])
    if name == "kepE":
        # E - e sin E = M, q = e cos E: E_k = (k M_k + sum_{j=1..k} j e_j
        # s_{k-j} + sum_{m=1..k-1} (k-m) q_m E_{k-m}) / (k (1 - q_0))
        t1 = k * hist(1, k, k + 1)[0]
        t2 = _conv(up, hist(0, 1, k + 1), hist("sin", 0, k).flip(0))
        t3 = _conv(dn1, hist("syn", 1, k), hist(-1, 1, k).flip(0))
        return (t1 + t2 + t3) / (k * (1.0 - hist("syn", 0, 1)[0]))
    if name == "kepF":
        # F + h cos F - kk sin F = lam, w = h sin F + kk cos F:
        # F_k = (k lam_k - sum_{j=1..k} j h_j c_{k-j} + sum_{j=1..k} j kk_j
        #        s_{k-j} + sum_{m=1..k-1} (k-m) w_m F_{k-m}) / (k (1 - w_0))
        t1 = k * hist(2, k, k + 1)[0]
        t2 = _conv(up, hist(0, 1, k + 1), hist("cos", 0, k).flip(0))
        t3 = _conv(up, hist(1, 1, k + 1), hist("sin", 0, k).flip(0))
        t4 = _conv(dn1, hist("syn", 1, k), hist(-1, 1, k).flip(0))
        return (t1 - t2 + t3 + t4) / (k * (1.0 - hist("syn", 0, 1)[0]))
    if name == "kepDE":
        # DE + s0 (1 - cos DE) - c0 sin DE = DM, w = s0 sin - c0 cos:
        # DE_k = (k DM_k - k s0_k (1 - c_0) + sum_{j=1..k-1} j s0_j c_{k-j}
        #   + sum_{j=1..k} j c0_j s_{k-j} - sum_{m=1..k-1} (k-m) w_m
        #   DE_{k-m}) / (k (1 + w_0))
        C = hist("cos", 0, k)
        t1 = k * hist(2, k, k + 1)[0]
        t2 = (k * hist(0, k, k + 1)[0]) * (1.0 - C[0])
        t3 = _conv(_wts(1, k, like), hist(0, 1, k), C[1:].flip(0))
        t4 = _conv(up, hist(1, 1, k + 1), hist("sin", 0, k).flip(0))
        t5 = _conv(dn1, hist("syn", 1, k), hist(-1, 1, k).flip(0))
        return (t1 - t2 + t3 + t4 - t5) / (k * (1.0 + hist("syn", 0, 1)[0]))
    if name == "relu":
        bk = hist(0, k, k + 1)[0]
        return torch.where(hist(0, 0, 1)[0] > 0.0, bk, torch.zeros_like(bk))
    if name == "select":
        return torch.where(hist(0, 0, 1)[0] != 0.0, hist(1, k, k + 1)[0],
                           hist(2, k, k + 1)[0])
    # relup, the relational and the logical ops and an interpolant's
    # slope (``interp_p``): zero above order 0
    return torch.zeros_like(hist(0, 0, 1)[0])


def _synth_j(name, j: int, hist):
    """Order ``j`` of a Kepler group's synthetic series (``_synth_w``)."""
    def cv(q, aux):
        return (hist(q, 0, j + 1) * hist(aux, 0, j + 1).flip(0)).sum(0)
    if name == "kepE":
        return cv(0, "cos")
    if name == "kepF":
        return cv(0, "sin") + cv(1, "cos")
    return cv(0, "sin") - cv(1, "cos")


def order0(tape: PhaseTape, tc):
    """Order 0 of every group column, in level order, in place on the
    ``(K+1, W, B)`` buffer whose order-0 state and virtual columns are
    set.  Returns the side buffer ``ser (K+1, n_side, B)`` (None where
    ``n_side`` is 0): orders ``0..K`` of every series column, then at
    order 0 each interpolant column's slope at its input
    (``eop_sw.interp0``, which also gives the column's value).  The
    series columns' jets are made together (:func:`_series_rows`: kernel
    S1 on the card, each entry launched once) where
    ``tape.ser_launches`` puts them: before the first group that reads one
    of the series met so far, else at the end of order 0.  Both run in
    f64 on the f64 tables: on an f32 buffer the input column is widened
    exactly and each order, value and slope is rounded once into the
    buffer, as the JAX package's f64 tables promote an f32 integrator's
    input."""
    ser = tc.new_empty((tape.order + 1, tape.n_side, tc.shape[2])) \
        if tape.n_side else None
    for gi, (name, s, m, cols, alpha, aux, srows) in enumerate(
            tape.pgroups):
        if gi in tape.ser_launches:
            _series_rows(tape, tc, ser, tape.ser_launches[gi])
        kind = op_kind(name)
        if kind == INTERP:
            tc[0, s:s + m], ser[0, srows[0]:srows[1]] = eop_sw.interp0(
                name, tc[0].index_select(0, cols[:, 0]).to(_F64))
            continue
        if kind == SERIES:  # made with the others at its launch
            continue
        hist = _hist(tc, None, s, m, cols, aux, srows)
        if name == "pow":  # the exponent per column, as kernel B2 has it
            v = _eval0(name, alpha, hist, 1)
        else:
            v = evaluate(name, *(hist(q, 0, 1)[0]
                                 for q in range(cols.shape[1])))
        tc[0, s:s + m] = v
    if len(tape.pgroups) in tape.ser_launches:
        _series_rows(tape, tc, ser, tape.ser_launches[len(tape.pgroups)])
    return ser


def _series_rows(tape: PhaseTape, tc, ser, rows):
    """Orders ``0..K`` of the series rows ``rows`` into ``ser`` in one
    :func:`series_jet.series_jets` (kernel S1 on the card), at ``u0`` the
    input columns' order 0 and ``u1`` their rates, in f64; then order 0
    of each series column into ``tc``."""
    aff = [tape.series[r][1] for r in rows]
    U0 = torch.stack([tc[0, x.in_col] for x in aff]).to(_F64)
    U1 = torch.stack([x.u1(tc).to(_F64) for x in aff])
    work = work_of([tape.series[r][2] for r in rows], tape.order)
    if ser.dtype == _F64:
        series_jets(work, U0, U1, ser, rows)
    else:
        tmp = U0.new_empty((tape.order + 1, len(rows), U0.shape[1]))
        series_jets(work, U0, U1, tmp, range(len(rows)))
        ser[:, list(rows)] = tmp.to(ser.dtype)
    for r in rows:
        tc[0, tape.series[r][0]] = ser[0, r]


def _synth(tape: PhaseTape, tc, syn, j: int):
    for name, s, m, cols, alpha, aux, srows in tape.pgroups:
        if name in SYNTH:
            syn[j, srows[0]:srows[1]] = _synth_j(
                name, j, _hist(tc, syn, s, m, cols, aux, srows))


def phase_plain(tape: PhaseTape, tc, lo: int, ser=None):
    """Plain torch twin of kernel B4: orders ``lo..K`` of ``tc (K+1, W,
    B)`` in place, from its orders below ``lo``; returns ``tc``.  Each
    order: the state rows from the right-hand sides at ``k-1`` over ``k``,
    then the groups in level order (a series column's row copied from
    ``ser``, :func:`order0`'s side buffer, where an interpolant also finds
    its slope), then the synthetic rows."""
    K, n_eq = tape.order, tape.n_eq
    _check_lo(lo, K)
    _check_ser(tape, tc, ser)
    syn = tc.new_empty((K + 1, tape.n_syn, tc.shape[2])) if tape.n_syn \
        else None
    for j in range(lo):
        _synth(tape, tc, syn, j)
    for k in range(lo, K + 1):
        tc[k, :n_eq] = tc[k - 1].index_select(0, tape.rhs) / k
        for name, s, m, cols, alpha, aux, srows in tape.pgroups:
            if op_kind(name) == SERIES:
                tc[k, s:s + m] = ser[k, srows[0]:srows[1]]
                continue
            tc[k, s:s + m] = _phase_k(
                name, alpha, k, _hist(tc, syn, s, m, cols, aux, srows, ser),
                cols.shape[1], tc)
        if k < K:
            _synth(tape, tc, syn, k)
    return tc


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check_lo(lo, K):
    if not 1 <= lo <= K + 1:
        raise ValueError(f"lo must lie in 1..{K + 1}; got {lo}")


def _check_ser(tape: PhaseTape, tc, ser):
    """``ser`` must be :func:`order0`'s side buffer on a tape with series
    or interpolants, None on one without."""
    if not tape.n_side:
        if ser is not None:
            raise ValueError("a side buffer for a tape without series or "
                             "interpolants")
        return
    if ser is None:
        raise ValueError("the tape has dense series or interpolants: pass "
                         "order0's series buffer (its side rows)")
    _check("ser", ser, (tape.order + 1, tape.n_side, tc.shape[-1]),
           tc.dtype, tc.device)


def phase(tape: PhaseTape, tc, lo: int, ser=None):
    """Orders ``lo..K`` of ``tc (K+1, W, B)`` (f64 or f32) in place;
    returns ``tc``.  A CPU tensor runs :func:`phase_plain`; a CUDA tensor
    launches kernel B4's entry for its dtype (``hy_phase_f64`` or
    ``hy_phase_f32``, ``ENTRIES``) at the block shape of
    :func:`block_shape`, and raises for any other dtype.  ``ser``:
    :func:`order0`'s side buffer, on a tape with dense series or
    interpolants."""
    if _device_of(tc, tape).type == "cpu":
        return phase_plain(tape, tc, lo, ser)
    return _phase_cuda(tape, tc, lo, ser=ser)


def _phase_cuda(tape: PhaseTape, tc, lo: int, lanes=None, threads=None,
                layout=None, ser=None):
    """Kernel B4 on ``tc``'s dtype (``ENTRIES``; ValueError for a dtype
    without an entry) at a block shape of ``lanes`` x ``threads`` on
    ``layout`` (default: :func:`block_shape`'s)."""
    if tc.dtype not in ENTRIES:
        raise ValueError(f"kernel B4 takes float64 or float32 buffers; got "
                         f"{tc.dtype}")
    _check_ser(tape, tc, ser)
    entry, counter = ENTRIES[tc.dtype]
    return launch(entry, counter, tape, tc, lo, tc.dtype, lanes, threads,
                  layout,
                  series=(None if ser is None else _ptr(ser), tape.n_side))


def stage(tape: PhaseTape, tc, lo: int):
    """The staging alone of kernel B4's default launch on ``tc``: the
    blocks' rows copied in and back, no pass (``hy_phase_stage_f64``),
    for timing it; leaves orders ``lo..K`` of the written columns
    undefined, so give it a scratch buffer.  Not counted in ``LAUNCHES``.
    Raises ValueError where the default shape is on the global layout,
    which stages nothing."""
    sh, cfg, stream = _launch_args(tape, tc, lo, _F64)
    if sh is None:
        return tc
    if sh.layout != "smem":
        raise ValueError("kernel B4 stages nothing on the global layout")
    _run("hy_phase_stage_f64", _ptr(tape.itab), _ptr(tape.dtab), _ptr(tc),
         *cfg, stream)
    return tc


def launch(entry, counter, tape, tc, lo, dtype, lanes=None, threads=None,
           layout=None, series=()):
    """One launch of kernel B4 or T2 (C entry ``entry``, counted in
    ``LAUNCHES[counter]``) on ``tc (K+1, W, B)`` of ``dtype``, in place;
    returns ``tc``.  No launch where there is no work (no lanes, or ``lo =
    K + 1``).  On the global layout the Kepler synthetic rows go to a
    ``(K+1, n_syn, B)`` scratch buffer.  ``series``: the arguments after
    ``syn`` that kernel B4 takes (the side buffer and its rows), none
    for T2."""
    sh, cfg, stream = _launch_args(tape, tc, lo, dtype, lanes, threads,
                                  layout)
    if sh is None:
        return tc
    glob = sh.layout == "global"
    syn = None
    if glob and tape.n_syn:
        syn = torch.empty((tape.order + 1, tape.n_syn, tc.shape[-1]),
                          dtype=dtype, device=tc.device)
    _run(entry, _ptr(tape.itab), _ptr(tape.dtab), _ptr(tc),
         None if syn is None else _ptr(syn), *series, *cfg, int(glob),
         stream)
    LAUNCHES[counter] += 1
    return tc


def _launch_args(tape, tc, lo, dtype, lanes=None, threads=None, layout=None):
    """Checks ``tc`` and returns ``(shape, (B, lo, lanes, threads, smem,
    n_it, n_dt), stream)`` of a launch on it, or ``(None, None, None)``
    where there is no work.  The default shape is cached on the tape."""
    dev, K = tc.device, tape.order
    _check_lo(lo, K)
    B = tc.shape[-1] if tc.ndim == 3 else 0
    _check("tc", tc, (K + 1, tape.width, B), dtype, dev)
    if B == 0 or lo > K:
        return None, None, None
    if lanes is None and threads is None and layout is None:
        key = (B, tc.element_size(), dev)
        if key not in tape._shapes:
            tape._shapes[key] = block_shape(tape, B, key[1], sms=_sms(dev))
        sh = tape._shapes[key]
    else:
        sh = block_shape(tape, B, tc.element_size(), lanes, threads, layout,
                         _sms(dev))
    return sh, (B, int(lo), sh.lanes, sh.threads, sh.smem, sh.n_it,
                sh.n_dt), torch.cuda.current_stream(dev).cuda_stream


def _run(entry, *args):
    rc = getattr(_build.load(), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# the kernels' block shape
# ---------------------------------------------------------------------------

#: threads a block of kernels B4 and T2 may have (csrc/phase_block.cuh
#: ``kPhaseMaxThreads``), and the threads a block gives each item of its
#: widest pass: the spare ones speed the staging
BLOCK_THREADS = (32, 64, 128, 256)
THREADS_PER_ITEM = 2
#: the most lanes a block (a row of them fills eight sectors of f64)
MAX_LANES = 32
#: a sector of global memory (bytes): where a row of the lanes a block's
#: shared memory holds is shorter, the staging would read and write
#: sectors by parts, and the global layout runs instead
SECTOR = 32


class PhaseShape(NamedTuple):
    """A launch of kernel B4 or T2: ``layout`` (``"smem"``: the block's
    lanes staged in shared memory; ``"global"``: worked on in place in
    the caller's buffer), ``lanes`` and ``threads`` a block, ``smem`` (the
    dynamic shared memory of a block, in bytes) and the lengths of the
    tables copied into it (``n_it`` ints, ``n_dt`` doubles; 0 where they
    are read in place)."""
    layout: str
    lanes: int
    threads: int
    smem: int
    n_it: int
    n_dt: int


def lane_bytes(tape: PhaseTape, itemsize: int) -> int:
    """Shared memory of one lane: its ``(K+1, W)`` coefficients and its
    ``(K+1, n_syn)`` synthetic rows."""
    return itemsize * (tape.order + 1) * (tape.width + tape.n_syn)


def widest(tape: PhaseTape) -> int:
    """Rows of the widest pass at orders k >= lo: a level, or the synthetic
    rows of one order with the state rows of the next."""
    return int(max(np.diff(tape.lvl).max(initial=0),
                   tape.n_eq + tape.n_syn))


def _threads_for(tape: PhaseTape, lanes: int) -> int:
    fit = [t for t in BLOCK_THREADS
           if t >= THREADS_PER_ITEM * widest(tape) * lanes]
    return min(fit, default=BLOCK_THREADS[-1])


def block_shape(tape: PhaseTape, B: int, itemsize: int, lanes=None,
                threads=None, layout=None, sms: int = SMS) -> PhaseShape:
    """The block shape of kernel B4 (``itemsize`` 8 in f64, 4 in f32) or
    T2 (4) on ``B`` lanes of ``tape``, or the ``lanes``, ``threads`` and ``layout`` given
    (the tests and ``chip_smoke.py`` hold every shape to the default).

    - Lanes: as many as a block's shared memory holds (:func:`lane_bytes`),
      up to ``MAX_LANES`` and to ``B``; ``MAX_LANES`` on the global layout.
    - Layout: ``"smem"`` where a row of the lanes a block holds fills a
      ``SECTOR``, else ``"global"``.
    - Threads: the fewest of ``BLOCK_THREADS`` that give each item of the
      widest pass (:func:`widest`) ``THREADS_PER_ITEM`` threads, else the
      most.
    - The tables go to shared memory where they cost no block an SM that
      the launch's blocks need.

    Measured on an H100 (``chip_smoke.py`` phases 12 and 14, every forced
    shape): a block's time is its chain of barrier-closed passes, which
    more lanes do not lengthen, so the fewest, largest blocks win even
    where they leave SMs idle (1,024 ``hyper`` lanes: 32 blocks of 32
    lanes beat 79 of 13), and where a block holds under a sector's row of
    lanes (the outer SS: three f64 lanes, seven f32 ones) the global
    layout's blocks of 32 lanes beat the staged ones.  The rule picks the
    fastest forced shape, or one within 2% of it, on the pendulum at
    10,240 lanes, ``hyper`` at 1,024 and the outer SS at 10,240 in f64 and
    f32; tapes whose blocks hold 4-31 f64 lanes are not measured."""
    per = lane_bytes(tape, itemsize)
    fits = min(MAX_LANES, SMEM_MAX // per)
    own = "smem" if fits * itemsize >= SECTOR else "global"
    layout = own if layout is None else layout
    if layout not in ("smem", "global"):
        raise ValueError(f"unknown layout {layout!r}")
    if lanes is None:
        lanes = max(1, min(MAX_LANES if layout == "global" else fits, B))
    lanes = int(lanes)
    nt = _threads_for(tape, lanes) if threads is None else int(threads)
    if nt not in BLOCK_THREADS or lanes < 1:
        raise ValueError(f"kernels B4/T2 take 1 lane or more and "
                         f"{BLOCK_THREADS} threads a block, not {lanes} x "
                         f"{nt}")
    smem = lanes * per if layout == "smem" else 0
    if smem > SMEM_MAX:
        raise ValueError(f"{lanes} lanes of {per} B exceed a block's "
                         f"{SMEM_MAX} B of shared memory")
    tab = table_bytes(tape)
    need = min(blocks_per_sm(smem, nt), -(-B // (lanes * sms)))
    if smem + tab <= SMEM_MAX and blocks_per_sm(smem + tab, nt) >= need:
        return PhaseShape(layout, lanes, nt, smem + tab, tape.itab.numel(),
                          tape.dtab.numel())
    return PhaseShape(layout, lanes, nt, smem, 0, 0)


def sweep_shapes(tape: PhaseTape, itemsize: int,
                 lanes=(1, 2, 3, 8, 16, 32)) -> list:
    """``(layout, lanes, threads)`` of the block shapes that
    ``chip_smoke.py``, ``tools.proto_phase`` and the GPU tests force: each
    of ``lanes`` with each of ``BLOCK_THREADS`` on the smem layout where
    the lanes fit a block, and on the global layout."""
    per = lane_bytes(tape, itemsize)
    return [("smem", L, nt) for L in lanes if L * per <= SMEM_MAX
            for nt in BLOCK_THREADS] \
        + [("global", L, nt) for L in lanes for nt in BLOCK_THREADS]


def layout_report(tape: PhaseTape, B: int, itemsize: int = 8) -> dict:
    """:func:`block_shape` as a dict, with the bytes of one lane."""
    return dict(block_shape(tape, B, itemsize)._asdict(),
                lane_bytes=lane_bytes(tape, itemsize))


def jet_phase(tape: PhaseTape, state, pars, t=None):
    """Taylor jet with the contract of ``jet_kernels.jet``: ``(tc (n_eq +
    n_out, K+1, B), norms (3, B))`` from ``state (n_eq, B)``, ``pars
    (n_pars, B)`` and ``t (B,)``, all of one dtype, f64 or f32, which the
    jet keeps.  Seeds the buffer, runs :func:`order0` and then
    :func:`phase` from ``lo = 1``, which launches kernel B4's entry for the
    dtype on a CUDA tensor.  The jet is in place in the buffer, every op column
    written back by the kernel, so the sv-func rows (the event equations,
    the JAX kernel's ``sv_extra``) are gathered from it after the state
    rows.  On a tape with dense series, :func:`order0` launches each
    entry of kernel S1 once a step where no group reads a series before
    the last series' level."""
    dev = _device_of(state, tape)
    B = state.shape[1]
    dt = state.dtype if state.dtype in ENTRIES else _F64
    _check("state", state, (tape.n_eq, B), dt, dev)
    _check("pars", pars, (tape.n_pars, B), dt, dev)
    tc = _seed_plain(tape, state, pars, t)
    ser = order0(tape, tc)
    phase(tape, tc, 1, ser)
    return _rows(tape, tc), _norms(tape, tc)
