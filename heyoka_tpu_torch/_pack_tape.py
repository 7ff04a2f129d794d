"""The tape encoding of the JAX package's native runtime, without the
runtime: a copy of ``heyoka_tpu/native.py`` ``pack_tape`` (:161) and its
opcode table, which the multiple-precision integrator
(:mod:`.multiprec`) interprets.  The native C++ runtime itself, its
ctypes bindings and ``backend="native"`` are not ported (ROADMAP A.22).

Operand codes: ``u`` columns as their index, literals ``-1 - i`` (the
``i``-th distinct constant), parameters ``-1000000 - i``, the time
``-2000000``.
"""

from __future__ import annotations

import numpy as np

from .expr.decompose import Tape

#: the most operands an op may have
_MAXA = 8

#: op name -> the runtime's opcode
_OPCODES = {
    "sum": 0, "mul": 1, "div": 2, "pow": 3, "sin": 4, "cos": 5, "sinh": 6,
    "cosh": 7, "tan": 8, "tanh": 9, "exp": 10, "log": 11, "sqrt": 12,
    "sigmoid": 13, "asin": 14, "acos": 15, "atan": 16, "asinh": 17,
    "acosh": 18, "atanh": 19, "erf": 20, "atan2": 21, "relu": 22,
    "relup": 23, "select": 24, "lt": 25, "le": 26, "gt": 27, "ge": 28,
    "eq": 29, "ne": 30, "logical_and": 31, "logical_or": 32,
    "logical_not": 33, "kepE": 34, "kepF": 35, "kepDE": 36,
}


def pack_tape(tape: Tape):
    """Flatten a decomposition tape into the native runtime's encoding."""
    if tape.rhs is None:
        raise ValueError("pack_tape requires an ODE tape")
    n_ops = len(tape.ops)
    consts: list[float] = []
    cmap: dict[float, int] = {}

    def code(operand) -> int:
        kind = operand[0]
        if kind == "u":
            return int(operand[1])
        if kind == "c":
            v = float(operand[1])
            if v not in cmap:
                cmap[v] = len(consts)
                consts.append(v)
            return -1 - cmap[v]
        if kind == "p":
            return -1000000 - int(operand[1])
        if kind == "t":
            return -2000000
        raise ValueError(operand)

    opcodes = np.zeros(n_ops, np.int32)
    arity = np.zeros(n_ops, np.int32)
    inputs = np.zeros((n_ops, _MAXA), np.int32)
    meta = np.full((n_ops, 2), -1, np.int32)
    alpha = np.zeros(n_ops, np.float64)
    for i, op in enumerate(tape.ops):
        if op.op not in _OPCODES:
            raise NotImplementedError(
                f"op {op.op!r} is not supported by the native runtime"
            )
        if len(op.inputs) > _MAXA:
            raise NotImplementedError(
                f"native runtime supports arity <= {_MAXA}; op {op.op!r} has "
                f"{len(op.inputs)} (decompose with sum splitting)"
            )
        opcodes[i] = _OPCODES[op.op]
        arity[i] = len(op.inputs)
        for a, operand in enumerate(op.inputs):
            inputs[i, a] = code(operand)
        if "pair" in op.meta:
            meta[i, 0] = int(op.meta["pair"])
        if "sq" in op.meta:
            meta[i, 0] = int(op.meta["sq"])
        if "sin" in op.meta:
            meta[i, 0] = int(op.meta["sin"])
            meta[i, 1] = int(op.meta["cos"])
        if op.op == "pow":
            alpha[i] = float(op.meta["alpha"])
    rhs = np.array([code(o) for o in tape.rhs], np.int32)
    return dict(
        n_eq=np.int32(tape.n_eq),
        n_ops=np.int32(n_ops),
        n_pars=np.int32(tape.n_pars),
        opcodes=opcodes,
        arity=arity,
        inputs=np.ascontiguousarray(inputs),
        meta=np.ascontiguousarray(meta),
        alpha=alpha,
        consts=np.asarray(consts if consts else [0.0], np.float64),
        n_consts=np.int32(len(consts) if consts else 1),
        rhs=rhs,
    )
