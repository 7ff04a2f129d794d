"""What an integrator carries across from the JAX package: its tape and
its lane state.

An ODE integrator has no weights: what defines it is the level-grouped op
plan of its tape (``taylor.compact.build_plan``) and the per-lane state,
parameters and double-length time.  ``plan_to_arrays`` flattens a plan —
the port's own or ``heyoka_tpu.taylor.compact.build_plan``'s, read through
its dataclass fields — into plain numpy arrays, which are what the jet
(``taylor/jet_kernels.py``) and the CUDA kernels consume;
``plan_from_arrays`` rebuilds the plan.

Array layout (all int32 unless noted):

- ``meta`` (int64): ``[width, n_eq, order, time_col (-1: none), zero_col]``;
- ``rhs_cols`` (n_eq,), ``out_cols`` (n_out,): the state derivatives' and
  the sv-funcs' columns;
- ``const_cols`` / ``const_vals`` (f64), ``par_cols`` / ``par_idx``: the
  virtual columns;
- per group, in level order: ``g_level``, ``g_op`` (index into
  ``OPCODES``), ``g_start`` (first output column), ``g_m`` (outputs),
  ``g_nargs`` (operand count; an n-ary sum's widest row);
- ``arg_ptr`` (n_ops + 1,) and ``args``: the operand columns of every op
  column ``n_eq + i`` in CSR form, ``args[arg_ptr[i]:arg_ptr[i + 1]]``.
  An n-ary sum's zero padding is dropped (``plan_from_arrays`` restores
  it from ``g_nargs`` and ``zero_col``);
- ``alpha`` (f64, (n_ops,)): the pow exponent of each op column, 0
  elsewhere;
- ``aux`` ((n_ops, 2)): the auxiliary columns of each op column
  (``_Group.aux``, in the order of ``AUX_KEYS``: the sin/cos ``pair``, the
  ``sq`` square of tan/tanh/sigmoid, the Kepler ``sin``/``cos``), -1 where
  there is none;
- the dense trig series (``expr/series.py``; every series op has the one
  opcode ``"trigseries"``, its group the op's full name
  ``trigseries%<key>``): ``ser`` ((n_ops,)) the series row of each op
  column in column order, -1 elsewhere; ``ser_key`` ((n_ser,)) the index
  of each row's series in ``ser_names`` (str, one per distinct series);
  and that series' tables, flattened in ``ser_amp`` / ``ser_ph`` (f64)
  with ``ser_shape`` ((n_names, 3): terms, amplitude and phase
  coefficients a term), so that the arrays carry everything the jets need
  and ``plan_from_arrays`` can restore the store.
"""

from __future__ import annotations

import numpy as np
import torch

from .expr import series
from .taylor.compact import _Group, _Plan

#: every op the port has a recurrence for; the position is the opcode the
#: CUDA kernels switch on (csrc/taylor_common.cuh ``enum Op``).  The first
#: five are kernels B1/B2/B3's rule set (``JET_OPS``); the phase kernel B4
#: takes them all (``PHASE_OPS``, ``heyoka_tpu/taylor/pallas_phase.py``
#: ``_SUPPORTED``, and the dense series, whose rows kernel S1 computes and
#: B4 copies in).
OPCODES = (
    "sum", "mul", "div", "sqrt", "pow",
    "exp", "log", "sin", "cos", "sinh", "cosh", "tan", "tanh", "sigmoid",
    "asin", "acos", "atan", "atanh", "asinh", "acosh", "erf", "atan2",
    "kepE", "kepF", "kepDE", "relu", "relup", "select",
    "lt", "le", "gt", "ge", "eq", "ne",
    "logical_and", "logical_or", "logical_not", "trigseries",
)
JET_OPS = OPCODES[:5]
PHASE_OPS = OPCODES

#: the auxiliary columns each op carries (``_Group.aux`` keys, in the
#: order of the ``aux`` array's two slots)
AUX_KEYS = {
    **{n: ("pair",) for n in ("sin", "cos", "sinh", "cosh")},
    **{n: ("sq",) for n in ("tan", "tanh", "sigmoid")},
    **{n: ("sin", "cos") for n in ("kepE", "kepF", "kepDE")},
}


SERIES = "trigseries"


def op_kind(name: str) -> str:
    """The ``OPCODES`` entry of op ``name``: ``"trigseries"`` for every
    dense series op (``trigseries%<key>``), the name itself otherwise."""
    return SERIES if series.is_series(name) else name


class UnsupportedKernelOp(Exception):
    """A tape op outside the rule set of the route that was asked for."""


def check_supported(plan, rules=JET_OPS) -> None:
    """Raise :class:`UnsupportedKernelOp` unless every group of ``plan``
    has a rule in ``rules``: ``JET_OPS`` for kernels B1/B2/B3,
    ``PHASE_OPS`` for the phase kernel B4."""
    for lv in plan.levels:
        for g in lv:
            if op_kind(g.name) not in rules:
                raise UnsupportedKernelOp(
                    f"op {g.name!r} has no rule in this jet (rule set: "
                    f"{', '.join(rules)})")


def plan_to_arrays(plan) -> dict[str, np.ndarray]:
    """Flatten a plan into numpy arrays (layout in the module docstring)."""
    check_supported(plan, PHASE_OPS)
    n_eq = int(plan.n_eq)
    n_ops = int(plan.width) - n_eq - len(plan.const_cols) \
        - len(plan.par_cols) - (plan.time_col is not None)
    zero_col = int(plan.zero_col)
    g_level, g_op, g_start, g_m, g_nargs = [], [], [], [], []
    row_args = [None] * n_ops
    alpha = np.zeros(n_ops, np.float64)
    aux = np.full((n_ops, 2), -1, np.int64)
    ser = np.full(n_ops, -1, np.int64)
    ser_names: list[str] = []
    for li, lv in enumerate(plan.levels):
        for g in lv:
            in_cols = np.asarray(g.in_cols, np.int64)
            m, nargs = in_cols.shape
            start = int(g.out_start)
            g_level.append(li)
            g_op.append(OPCODES.index(op_kind(g.name)))
            if op_kind(g.name) == SERIES:
                if g.name not in ser_names:
                    ser_names.append(g.name)
                ser[start - n_eq:start - n_eq + m] = ser_names.index(g.name)
            g_start.append(start)
            g_m.append(m)
            g_nargs.append(nargs)
            for r in range(m):
                row = list(in_cols[r])
                if g.name == "sum":
                    while len(row) > 1 and row[-1] == zero_col:
                        row.pop()
                row_args[start - n_eq + r] = row
            if g.name == "pow":
                alpha[start - n_eq:start - n_eq + m] = np.asarray(g.alpha)
            keys = AUX_KEYS.get(g.name, ())
            if set(g.aux) != set(keys):
                raise ValueError(f"group {g.name!r} carries aux columns "
                                 f"{sorted(g.aux)}, expected {list(keys)}")
            for slot, key in enumerate(keys):
                aux[start - n_eq:start - n_eq + m, slot] = np.asarray(
                    g.aux[key])
    if any(r is None for r in row_args):
        raise ValueError("the plan's groups do not cover every op column")
    arg_ptr = np.zeros(n_ops + 1, np.int64)
    arg_ptr[1:] = np.cumsum([len(r) for r in row_args])
    args = np.array([c for r in row_args for c in r], np.int64)
    i32 = np.int32
    # the series rows in column order, each with its series' index
    is_ser = ser >= 0
    ser_key = ser[is_ser]
    ser[is_ser] = np.arange(ser_key.size)
    tabs = [_series_tables(n) for n in ser_names]
    return dict(
        meta=np.array([plan.width, n_eq, plan.order,
                       -1 if plan.time_col is None else plan.time_col,
                       zero_col], np.int64),
        rhs_cols=np.asarray(plan.rhs_cols, i32),
        out_cols=np.asarray(plan.out_cols, i32),
        const_cols=np.array([c for c, _ in plan.const_cols], i32),
        const_vals=np.array([v for _, v in plan.const_cols], np.float64),
        par_cols=np.array([c for c, _ in plan.par_cols], i32),
        par_idx=np.array([j for _, j in plan.par_cols], i32),
        g_level=np.array(g_level, i32),
        g_op=np.array(g_op, i32),
        g_start=np.array(g_start, i32),
        g_m=np.array(g_m, i32),
        g_nargs=np.array(g_nargs, i32),
        arg_ptr=arg_ptr.astype(i32),
        args=args.astype(i32),
        alpha=alpha,
        aux=aux.astype(i32),
        ser=ser.astype(i32),
        ser_key=ser_key.astype(i32),
        ser_names=np.array(ser_names, dtype=str),
        ser_shape=np.array([[a.shape[0], a.shape[1], p.shape[1]]
                            for a, p in tabs], np.int64).reshape(-1, 3),
        ser_amp=np.concatenate([a.ravel() for a, _ in tabs]
                               + [np.zeros(0)]),
        ser_ph=np.concatenate([p.ravel() for _, p in tabs] + [np.zeros(0)]),
    )


def _series_tables(name):
    try:
        return series.tables(name)
    except KeyError:
        raise KeyError(f"series op {name!r} is not in the port's store: "
                       "build its expression with the port") from None


def series_names(d: dict) -> list[str]:
    """The op name of every series row of ``d`` (plan arrays), with the
    tables restored to the series store where it lacks them."""
    names, off_a, off_p = [], 0, 0
    for name, (n, q1, d1) in zip(d["ser_names"], d["ser_shape"]):
        n, q1, d1 = int(n), int(q1), int(d1)
        amp = d["ser_amp"][off_a:off_a + n * q1].reshape(n, q1)
        ph = d["ser_ph"][off_p:off_p + n * d1].reshape(n, d1)
        off_a, off_p = off_a + n * q1, off_p + n * d1
        if series.add(amp, ph) != name:
            raise ValueError(f"the tables of {name!r} do not hash to it")
        names.append(str(name))
    return [names[int(k)] for k in d["ser_key"]]


def plan_from_arrays(d: dict) -> _Plan:
    """Rebuild a :class:`~.taylor.compact._Plan` from :func:`plan_to_arrays`
    output.  Every field the jets read, the aux columns included,
    round-trips exactly; ``_Group.ops``
    (the tape op objects behind each group) is not carried and comes back
    empty."""
    width, n_eq, order, time_col, zero_col = (int(x) for x in d["meta"])
    n_levels = int(d["g_level"].max()) + 1 if d["g_level"].size else 0
    levels: list[list[_Group]] = [[] for _ in range(n_levels)]
    arg_ptr, args = d["arg_ptr"], d["args"]
    ser_rows = series_names(d)
    for li, op, start, m, nargs in zip(d["g_level"], d["g_op"], d["g_start"],
                                       d["g_m"], d["g_nargs"]):
        start, m, nargs = int(start), int(m), int(nargs)
        name = OPCODES[int(op)]
        if name == SERIES:
            name = ser_rows[int(d["ser"][start - n_eq])]
        in_cols = np.full((m, nargs), zero_col, np.int64)
        for r in range(m):
            o = start - n_eq + r
            row = args[arg_ptr[o]:arg_ptr[o + 1]]
            in_cols[r, :row.size] = row
        alpha = (np.asarray(d["alpha"][start - n_eq:start - n_eq + m],
                            np.float64) if name == "pow" else None)
        aux = {key: np.asarray(d["aux"][start - n_eq:start - n_eq + m, slot],
                               np.int64)
               for slot, key in enumerate(AUX_KEYS.get(name, ()))}
        levels[int(li)].append(_Group(
            name, np.arange(start, start + m, dtype=np.int64), in_cols, aux,
            alpha, [], start))
    return _Plan(
        width=width, n_eq=n_eq, order=order,
        rhs_cols=np.asarray(d["rhs_cols"], np.int64),
        out_cols=np.asarray(d["out_cols"], np.int64),
        const_cols=[(int(c), float(v)) for c, v in
                    zip(d["const_cols"], d["const_vals"])],
        par_cols=[(int(c), int(j)) for c, j in
                  zip(d["par_cols"], d["par_idx"])],
        time_col=None if time_col < 0 else time_col,
        zero_col=zero_col,
        levels=levels,
    )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device where there is none (the port never falls back to the CPU:
    pass ``device="cpu"`` for the plain versions of the kernels)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev


def check_dtype(dtype) -> None:
    """Accept float64 (numpy's, torch's or their names), the one precision
    the port integrates in; raise ``ValueError`` for any other ``dtype``
    (the JAX package's integrators also take float32)."""
    if isinstance(dtype, torch.dtype):
        ok = dtype == torch.float64
    else:
        try:
            ok = np.dtype(dtype) == np.float64
        except TypeError:
            ok = False
    if not ok:
        raise ValueError(f"dtype {dtype!r} is not supported: the port "
                         "integrates in float64 only (pass float64)")


def state_from_numpy(state, pars, t_hi, t_lo, device) -> dict:
    """The port's lane state from the arrays of a JAX
    ``TaylorAdaptiveBatch`` (``state`` (B, n), ``pars`` (B, p), and the
    double-length time ``dtime`` pair, each (B,)): f64 tensors on
    ``device``, under the keys the port's integrator keeps."""
    def f64(a):
        return torch.as_tensor(np.array(a, np.float64), device=device)

    state = f64(state)
    if state.ndim != 2:
        raise ValueError(f"state must be (batch, n); got {tuple(state.shape)}")
    B = state.shape[0]
    pars = f64(pars).reshape(B, -1)
    t_hi = f64(t_hi).reshape(-1).expand(B).contiguous()
    t_lo = f64(t_lo).reshape(-1).expand(B).contiguous()
    return dict(state=state.contiguous(), pars=pars.contiguous(),
                t_hi=t_hi, t_lo=t_lo)
