"""The least time an NVIDIA H100 could take for a kernel's work: its bound.

The bound is the larger of two times: the bytes the function must move
(each input read once, each output written once; scratch the wrapper
allocates is neither) over the card's memory rate, and the operations it
does on its data over the card's peak rate for their type.  Peaks: NVIDIA's
H100 SXM data sheet at its 700 W power limit, outside the tensor cores
(34 TFLOP/s f64, 67 TFLOP/s f32) and 3.35 TB/s of HBM3.

Operations are those of each rule's recurrence in its plain form, the
form the kernels write (``csrc/taylor_jet.cu`` ``jet_orders``,
``csrc/taylor_phase.cu`` ``phase_k``): one for each add, subtract,
multiply and divide of coefficients, and for each multiply by a weight.
What a kernel does beyond that is not the function's work and is not
counted: a sum started at zero costs no add, and a weight that is a
constant of the order k, the term j and the exponent (``alpha (k-j) -
j``, ``j``, ``k - m``) costs nothing to make.  A square root or a power
at order 0 counts one; a negation, a cast, a comparison and index
arithmetic none.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import OPCODES

PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype) -> dict:
    """``{"bound_ms", "bound_by", "flops", "bytes"}`` for ``flops``
    operations of type ``dtype`` and ``nbytes`` bytes moved."""
    t_op = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_op, t_mem),
                bound_by="operations" if t_op > t_mem else "bytes",
                flops=float(flops), bytes=float(nbytes))


def nbytes(*tensors) -> int:
    """Bytes of ``tensors`` (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def phase_bytes(arrays: dict, n_lanes: int, lo: int, itemsize: int) -> int:
    """Bytes of a phase run in place (kernels B4 and T2) on ``n_lanes``
    lanes: the whole buffer read once, orders ``lo..K`` of the state and op
    columns written once."""
    W, n_eq, K = (int(x) for x in arrays["meta"][:3])
    n_w = n_eq + int(arrays["arg_ptr"].size) - 1
    return itemsize * n_lanes * (W * (K + 1) + n_w * (K + 1 - lo))


def op_columns(arrays: dict):
    """``(op name, operand count)`` of every op column of a plan's arrays
    (``convert.plan_to_arrays``), in level order."""
    n_eq = int(arrays["meta"][1])
    na = np.diff(arrays["arg_ptr"])
    for op, s, m in zip(arrays["g_op"], arrays["g_start"], arrays["g_m"]):
        for o in range(s - n_eq, s - n_eq + m):
            yield OPCODES[int(op)], int(na[o])


def _dot(n: int, w: int) -> int:
    """A sum of ``n`` terms of ``w`` multiplies each, started at its first
    term."""
    return n * w + max(n - 1, 0)


#: operations of order k >= 1 of one column, by op; ``n`` is the operand
#: count.  The form of each recurrence is in the comment of its case in
#: ``phase_k``; the products run over j (or m) as written there, and the
#: outer adds, multiplies and divides are counted where their sums are not
#: empty
_ORDER_K = {
    "sum": lambda k, n: n - 1,
    "mul": lambda k, n: _dot(k + 1, 1),
    "div": lambda k, n: _dot(k, 1) + 2,
    "sqrt": lambda k, n: _dot(k - 1, 1) + (k > 1) + 2,
    "pow": lambda k, n: _dot(k, 2) + 2,
    **{op: (lambda k, n: _dot(k, 2) + 1)
       for op in ("exp", "sin", "cos", "sinh", "cosh")},
    **{op: (lambda k, n: _dot(k - 1, 2) + 2 * (k > 1) + 1)
       for op in ("log", "asin", "acos", "atan", "atanh", "asinh",
                  "acosh")},
    **{op: (lambda k, n: _dot(k, 2) + 2) for op in ("tan", "tanh", "erf")},
    "sigmoid": lambda k, n: _dot(k, 3) + 1,
    "atan2": lambda k, n: 2 * _dot(k, 2) + _dot(k - 1, 2) + (k > 1) + 3,
    "kepE": lambda k, n: 1 + _dot(k, 2) + _dot(k - 1, 2) + 1 + (k > 1) + 3,
    "kepF": lambda k, n: (1 + 2 * _dot(k, 2) + _dot(k - 1, 2) + 2
                          + (k > 1) + 3),
    "kepDE": lambda k, n: (4 + _dot(k, 2) + 2 * _dot(k - 1, 2) + 2
                           + 2 * (k > 1) + 3),
}
#: operations of order j of a Kepler column's synthetic series (B4's
#: ``synth``): one Cauchy product, or two and their sum
_SYNTH = {"kepE": lambda j: _dot(j + 1, 1),
          "kepF": lambda j: 2 * _dot(j + 1, 1) + 1,
          "kepDE": lambda j: 2 * _dot(j + 1, 1) + 1}


def phase_flops(arrays: dict, lo: int) -> int:
    """Operations of one lane of a phase (kernels B4 and T2: orders
    ``lo..K`` in place): the state rows (one divide by k each), every op
    column and the Kepler synthetic series."""
    K, n_eq = int(arrays["meta"][2]), int(arrays["meta"][1])
    cols = list(op_columns(arrays))
    total = n_eq * (K + 1 - lo)
    for k in range(lo, K + 1):
        total += sum(_ORDER_K.get(op, lambda k, n: 0)(k, n)
                     for op, n in cols)
    total += sum(_SYNTH[op](j) for op, _ in cols if op in _SYNTH
                 for j in range(K))
    return total


def jet_flops(arrays: dict) -> int:
    """Operations of one lane's jet in kernels B1, B2 and B3 (rule set
    {sum, mul, div, sqrt, pow}): order 0 of every op column, then orders
    1..K."""
    order0 = sum(n - 1 if op == "sum" else 1 for op, n in op_columns(arrays))
    return order0 + phase_flops(arrays, 1)


def step_flops(n_eq: int, K: int, high_accuracy: bool = True) -> int:
    """Operations of one step of kernel B1 beyond its jet: the step size,
    the update of every state row (the compensated sum or Horner) and the
    two double-length time sums."""
    update = 6 * K - 1 if high_accuracy else 2 * K
    return n_eq * update + 26


def rolled_traffic(tape) -> dict:
    """What one lane-jet of kernel B3 reads, counted from the packed
    tables of ``tape`` (a ``taylor.jet_rolled.RolledTape``) and the reads
    of ``csrc/taylor_jet_rolled.cu`` at order 0 and each order k >= 1:

    - ``table_bytes``: the items' records (4 B an int), the offset pair of
      an item with one, a pow's exponent (8 B), and for each distinct
      operand of an item read through the alias table its record (16 B);
    - ``table_bytes_before``: the previous design's per-column tables at
      every order (op, two argptr words, oloc and every operand word of
      every op column, as kernel B3 read them before the item lists);
    - ``coef_loads``: the doubles read from H, A, C and S (shared memory
      on the smem layout): every term's operands as each recurrence reads
      them, an alias's literals once an item, and the state rows'
      right-hand sides."""
    from ..taylor.jet_rolled import _RHDR, CLS_SHIFT, SEG_INTS, V, A
    it = tape.ritab.cpu().numpy().astype(np.int64)
    h = dict(zip(_RHDR, it[:len(_RHDR)].tolist()))
    K, n_lv = h["K"], h["n_levels"]
    alias = it[h["alias"]:h["alias"] + 4 * h["NA"]].reshape(-1, 4)
    n_seg = it[h["lvlk"] + n_lv]
    seg = it[h["seg"]:h["seg"] + SEG_INTS * n_seg].reshape(-1, SEG_INTS)
    rec, off = it[h["rec"]:], it[h["off"]:]

    def literals(loc):
        return int((alias[loc & ((1 << CLS_SHIFT) - 1), 1:3] >= 0).sum())

    def walk(lo, hi, k):
        tb = cl = 0
        for op, n, first, ar, aux, per in seg[lo:hi]:
            name = OPCODES[op]
            for i in range(n):
                if ar > 0:
                    r = rec[first + i * (1 + ar * per):][:1 + ar * per]
                else:
                    r = rec[first + off[aux + i]:first + off[aux + i + 1]]
                    tb += 8
                a = r[1::per]
                tb += 4 * r.size + 8 * (name == "pow")
                lits = int((a >> CLS_SHIFT == V).sum())
                if k == 0:
                    cl += a.size - lits
                    continue
                # the operands an item resolves, each once (its own
                # column is H)
                al = [x for x in set(a.tolist()) if x >> CLS_SHIFT == A]
                tb += 16 * len(al) * (per == 1)
                cl += sum(literals(x) for x in al)
                cl += {"sum": a.size - lits, "mul": 2 * (k + 1),
                       "div": 2 * k + 2, "sqrt": 2 * k,
                       "pow": 2 * k + 1}[name]
        return tb, cl

    lvl0 = it[h["lvl0"]:h["lvl0"] + n_lv + 1]
    lvlk = it[h["lvlk"]:h["lvlk"] + n_lv + 1]
    tb, cl = walk(lvl0[0], lvl0[-1], 0)
    for k in range(1, K + 1):
        t, c = walk(lvlk[0], lvlk[-1], k)
        tb, cl = tb + t + 4 * h["n_eq"], cl + c + h["n_eq"]
    n_ops = tape.arrays["arg_ptr"].size - 1
    before = (K + 1) * 4 * (4 * n_ops + tape.arrays["args"].size)
    return dict(table_bytes=int(tb), table_bytes_before=int(before),
                coef_loads=int(cl))


def series_flops_a_term(d: int, q: int, K: int) -> int:
    """Operations of kernel S1 on one (lane, term) pair at orders 0..K
    (sin and cos count one each): the Taylor shifts (``d(d+1)`` and
    ``q(q+1)``), the powers of ``u1`` and the scaling (``max(d, q) - 1``,
    ``d + q``), the weights ``j p_j`` (``d``), sin and cos (2), ``a_0 s_0``
    (1), then per order m two weighted sums of ``min(m, d)`` products each
    with their scale by ``1/m``, and the amplitude's sum of ``min(m, q) +
    1`` products."""
    total = d * (d + 1) + q * (q + 1) + max(max(d, q) - 1, 0) + 2 * d + q \
        + 3
    for m in range(1, K + 1):
        md, mq = min(m, d), min(m, q)
        total += 4 * md + 2 * mq + 1
    return total


def series_flops(n: int, d: int, q: int, K: int) -> int:
    """Operations of one lane of kernel S1 at orders 0..K on a series of
    ``n`` terms with phase degree ``d`` and amplitude degree ``q``: each
    term's (:func:`series_flops_a_term`) and the adds of the terms' orders
    into the lane's sums, ``(K+1)(n-1)``."""
    return n * series_flops_a_term(d, q, K) + (K + 1) * max(n - 1, 0)


def series_bytes(n: int, d: int, q: int, K: int, B: int) -> int:
    """Bytes of one launch of kernel S1: the tables read once (``n (d + 1
    + q + 1)`` doubles), ``u0`` and ``u1`` (``2B``) and the ``(K+1, B)``
    output written once."""
    return 8 * (n * (d + 1 + q + 1) + 2 * B + (K + 1) * B)
