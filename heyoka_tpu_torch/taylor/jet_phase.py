"""The phase jet (kernel B4): Taylor orders ``lo..K`` of every tape column
over the whole recurrence rule set, its wrapper and its plain torch twin.

It replaces ``make_phase_kernel`` (``heyoka_tpu/taylor/pallas_phase.py:
899``), whose rules are ``_rule`` (:633) and ``_synth_w`` (:206), and
whose f64 yardstick is the staged engine's ``_f_*`` rules
(``heyoka_tpu/taylor/compact_flat.py:1311-1569``).  The JAX package
reaches its kernel with ``pallas_phase=True``: order 0 in f64 XLA, orders
``mp_order+1..K`` in f32 in the kernel.  The H100 has f64, so here one
f64 run from ``lo = 1`` gives the whole jet:

- :func:`order0`: order 0 of every group in level order, with the
  numeric rules of :mod:`..expr.numeric`, in f64 torch;
- :func:`phase`: orders ``lo..K`` in place on a ``(K+1, W, B)`` f64
  buffer.  A CPU tensor runs :func:`phase_plain`; a CUDA tensor launches
  ``hy_phase_f64`` (``csrc/taylor_phase.cu``) or raises;
- :func:`jet_phase`: the contract of ``jet_kernels.jet`` over the two.

This is the port's route for every tape with an op outside kernels
B1/B2/B3's rule set (``convert.JET_OPS``).  The buffer is worked on in
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
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from .. import _build
from ..convert import AUX_KEYS, PHASE_OPS
from ..expr.numeric import evaluate
from .jet_kernels import (
    LAUNCHES, JetTape, _F64, _HDR, _HDR_LEN, _check, _device_of, _eval0,
    _eval_k, _norms, _ptr, _seed_plain,
)

#: header of the phase kernel's int32 table (csrc/taylor_phase.cu ``enum
#: Hdr``): ``jet_kernels._HDR``, then the offsets of the aux table (two
#: slots per op column, -1 where unused) and of the synthetic-row table
#: (one per op column, -1 but for Kepler columns), and the number of
#: synthetic rows
_PHDR = _HDR + ("aux", "syn", "n_syn")
assert len(_PHDR) == _HDR_LEN

#: ops with a synthetic convolution series
SYNTH = ("kepE", "kepF", "kepDE")

_TWO_SQRTPI = 2.0 / _pymath.sqrt(_pymath.pi)


class PhaseTape(JetTape):
    """A :class:`JetTape` over the whole rule set ``convert.PHASE_OPS``,
    with the aux columns and the Kepler synthetic rows: the twin's groups
    ``pgroups`` and kernel B4's packed tables (``itab``, ``dtab``, header
    ``_PHDR``)."""

    RULES = PHASE_OPS

    def __init__(self, arrays: dict, device):
        super().__init__(arrays, device)
        aux, syn = arrays["aux"], self._syn_rows(arrays)
        n_eq = self.n_eq
        self.n_syn = int(syn.max(initial=-1)) + 1

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        # per group, in level order: (op name, first column, rows, operand
        # columns, pow exponents, aux key -> columns, synthetic rows)
        self.pgroups = []
        for name, s, m, cols, alpha in self.groups:
            o = slice(s - n_eq, s - n_eq + m)
            self.pgroups.append((
                name, s, m, cols, alpha,
                {key: idx(aux[o, slot])
                 for slot, key in enumerate(AUX_KEYS.get(name, ()))},
                (int(syn[o][0]), int(syn[o][0]) + m) if name in SYNTH
                else None))

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
        return super()._pack(
            a, norm, {"aux": np.asarray(a["aux"]).reshape(-1), "syn": syn},
            {"n_syn": int(syn.max(initial=-1)) + 1})


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _hist(tc, syn, s, m, cols, aux, srows):
    """``hist(q, j0, j1)``: orders ``j0..j1-1`` of one group's operand set
    ``q`` as ``(j1 - j0, m, B)`` — an int is an operand (``in_cols[:,
    q]``), -1 the group's own columns, a string an aux key, ``"syn"`` the
    group's synthetic rows."""
    def hist(q, j0, j1):
        if q == -1:
            return tc[j0:j1, s:s + m]
        if q == "syn":
            return syn[j0:j1, srows[0]:srows[1]]
        c = aux[q] if isinstance(q, str) else cols[:, q]
        return tc[j0:j1].index_select(1, c)
    return hist


def _wts(a, b, dev):
    """Weights ``a, a+1, ..., b-1`` (or down to ``b+1`` for ``a > b``) as
    an ``(n, 1, 1)`` f64 column."""
    step = 1 if b >= a else -1
    return torch.arange(a, b, step, dtype=_F64, device=dev)[:, None, None]


def _conv(w, A, Bf):
    """``sum_j (w_j A_j) Bf_j`` over the order axis: the products in the
    kernel's order, the sum vectorised."""
    return ((w * A) * Bf).sum(0)


def _phase_k(name, alpha, k: int, hist, nargs: int, dev):
    """Order ``k`` (>= 1) of one group's columns (``_rule`` in f64).
    Every rule reads aux and synthetic rows below order ``k`` only."""
    if name in ("sum", "mul", "div", "sqrt", "pow"):
        return _eval_k(name, alpha, k, hist, nargs)
    up = _wts(1, k + 1, dev)    # j = 1..k
    dn = _wts(k, 0, dev)        # k - m for m = 0..k-1
    dn1 = _wts(k - 1, 0, dev)   # k - m for m = 1..k-1
    if name == "exp":
        # e_k = (sum_{j=1..k} j b_j e_{k-j}) / k
        return _conv(up, hist(0, 1, k + 1), hist(-1, 0, k).flip(0)) / k
    if name in ("sin", "cos", "sinh", "cosh"):
        # s_k = +-(sum_{j=1..k} j b_j p_{k-j}) / k, p the pair column
        v = _conv(up, hist(0, 1, k + 1), hist("pair", 0, k).flip(0)) / k
        return -v if name == "cos" else v
    if name == "log":
        # c_k = (b_k - (sum_{j=1..k-1} j c_j b_{k-j}) / k) / b_0
        s = _conv(_wts(1, k, dev), hist(-1, 1, k), hist(0, 1, k).flip(0))
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
        t3 = _conv(_wts(1, k, dev), hist(0, 1, k), C[1:].flip(0))
        t4 = _conv(up, hist(1, 1, k + 1), hist("sin", 0, k).flip(0))
        t5 = _conv(dn1, hist("syn", 1, k), hist(-1, 1, k).flip(0))
        return (t1 - t2 + t3 + t4 - t5) / (k * (1.0 + hist("syn", 0, 1)[0]))
    if name == "relu":
        bk = hist(0, k, k + 1)[0]
        return torch.where(hist(0, 0, 1)[0] > 0.0, bk, torch.zeros_like(bk))
    if name == "select":
        return torch.where(hist(0, 0, 1)[0] != 0.0, hist(1, k, k + 1)[0],
                           hist(2, k, k + 1)[0])
    # relup, the relational and the logical ops: zero above order 0
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
    set."""
    for name, s, m, cols, alpha, aux, srows in tape.pgroups:
        hist = _hist(tc, None, s, m, cols, aux, srows)
        if name == "pow":  # the exponent per column, as kernel B2 has it
            v = _eval0(name, alpha, hist, 1)
        else:
            v = evaluate(name, *(hist(q, 0, 1)[0]
                                 for q in range(cols.shape[1])))
        tc[0, s:s + m] = v


def _synth(tape: PhaseTape, tc, syn, j: int):
    for name, s, m, cols, alpha, aux, srows in tape.pgroups:
        if srows is not None:
            syn[j, srows[0]:srows[1]] = _synth_j(
                name, j, _hist(tc, syn, s, m, cols, aux, srows))


def phase_plain(tape: PhaseTape, tc, lo: int):
    """Plain torch twin of kernel B4: orders ``lo..K`` of ``tc (K+1, W,
    B)`` in place, from its orders below ``lo``; returns ``tc``.  Each
    order: the state rows from the right-hand sides at ``k-1`` over ``k``,
    then the groups in level order, then the synthetic rows."""
    K, n_eq = tape.order, tape.n_eq
    _check_lo(lo, K)
    dev = tc.device
    syn = tc.new_empty((K + 1, tape.n_syn, tc.shape[2])) if tape.n_syn \
        else None
    for j in range(lo):
        _synth(tape, tc, syn, j)
    for k in range(lo, K + 1):
        tc[k, :n_eq] = tc[k - 1].index_select(0, tape.rhs) / k
        for name, s, m, cols, alpha, aux, srows in tape.pgroups:
            tc[k, s:s + m] = _phase_k(
                name, alpha, k, _hist(tc, syn, s, m, cols, aux, srows),
                cols.shape[1], dev)
        if k < K:
            _synth(tape, tc, syn, k)
    return tc


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check_lo(lo, K):
    if not 1 <= lo <= K + 1:
        raise ValueError(f"lo must lie in 1..{K + 1}; got {lo}")


def phase(tape: PhaseTape, tc, lo: int):
    """Orders ``lo..K`` of ``tc (K+1, W, B)`` f64 in place; returns
    ``tc``.  A CPU tensor runs :func:`phase_plain`; a CUDA tensor launches
    kernel B4 (``hy_phase_f64``)."""
    dev = _device_of(tc, tape)
    if dev.type == "cpu":
        return phase_plain(tape, tc, lo)
    K = tape.order
    _check_lo(lo, K)
    B = tc.shape[-1] if tc.ndim == 3 else 0
    _check("tc", tc, (K + 1, tape.width, B), _F64, dev)
    if B == 0:
        return tc
    syn = torch.empty((K + 1, tape.n_syn, B), dtype=_F64, device=dev)
    lib = _build.load()
    rc = lib.hy_phase_f64(
        _ptr(tape.itab), _ptr(tape.dtab), _ptr(tc), _ptr(syn), B, int(lo),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hy_phase_f64 launch failed: CUDA error {rc}")
    LAUNCHES["phase"] += 1
    return tc


def jet_phase(tape: PhaseTape, state, pars, t=None):
    """Taylor jet with the contract of ``jet_kernels.jet``: ``(tc (n_eq,
    K+1, B), norms (3, B))`` from ``state (n_eq, B)``, ``pars (n_pars,
    B)`` and ``t (B,)``.  Seeds the buffer, runs :func:`order0` and then
    :func:`phase` from ``lo = 1``, which launches kernel B4 on a CUDA
    tensor."""
    dev = _device_of(state, tape)
    B = state.shape[1]
    _check("state", state, (tape.n_eq, B), _F64, dev)
    _check("pars", pars, (tape.n_pars, B), _F64, dev)
    tc = _seed_plain(tape, state, pars, t)
    order0(tape, tc)
    phase(tape, tc, 1)
    return tc[:, :tape.n_eq].permute(1, 0, 2).contiguous(), _norms(tape, tc)
