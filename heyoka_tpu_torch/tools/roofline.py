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
