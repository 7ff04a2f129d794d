"""The Taylor jet (kernel B2) and the fused multi-step propagation (kernel
B1): their wrappers and their plain torch twins.

They replace the Pallas kernels of ``heyoka_tpu/taylor/pallas_phase.py``:

- ``jet`` / ``jet_plain`` <- ``make_dd_jet_kernel`` (:1604) with
  ``slim=True, order0="dd"``: from the order-0 state (and the parameter
  and time values) compute order 0 of every tape column, then orders
  1..K; return the state columns' coefficients, then those of the tape's
  sv-func columns (``out_cols``: the event equations, in event order; the
  JAX kernel's ``sv_extra`` rows, :1632-1662), ``(n_eq + n_out, K+1, B)``,
  and the per-lane infinity norms ``(3, B)`` of orders ``[K-1, K, 0]``
  over the state and sv-func columns;
- ``prop`` / ``prop_plain`` <- ``make_dd_prop_kernel`` (:2454): up to
  ``n_steps`` whole adaptive steps per lane, with the same lane protocol
  (freeze on near-target, on a non-finite step — reverted — and on the
  step budget) and outputs ``state (n_eq, B)``, ``of (5, B) =
  [acc_hi, acc_lo, min_h, max_h, last_h]`` (``acc``: two-sum accumulator of
  the signed steps) and ``oi (3, B) int32 = [n_taken, near, err]``.

The TPU kernels compute in two-f32 arithmetic with an f32 tail and a
per-lane power-of-two scaling, because the TPU has no f64; here everything
is f64 and none of that is carried over.  The recurrences are those of
``heyoka_tpu/taylor/compact_flat.py`` (``_f_sum`` :1311, ``_f_mul`` :1316,
``_f_div`` :1323, ``_f_sqrt`` :1367, ``_f_pow`` :1377).

Layout: lanes are the LAST axis everywhere; the twins' coefficient buffer
is ``(K+1, W, B)``.  The kernels keep a block's lanes' jets as ``(K+1, W,
lanes)`` in shared memory, or, where one lane's jet does not fit there, in
a global scratch buffer of the same per-block layout; :func:`block_layout`
picks from ``(W, K)``.  The wrappers dispatch on the device of their
input: a CPU tensor runs the plain twin, a CUDA tensor launches the
kernel built from ``csrc/taylor_jet.cu`` (and raises if it cannot).  The
plain twins run on any device — ``chip_smoke.py`` uses them on the card
as the yardstick of the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..convert import (
    JET_OPS, UnsupportedKernelOp, check_supported, plan_from_arrays,
)
from ..dfloat import dd_add_d
from .stepper import ceval_update, h_from_norms, horner_update, rho_factor

#: launches of each kernel; a wrapper adds one where it launches its kernel
#: (``conv_f32``, ``conv_dd`` and ``proto_phase`` are the kernels of the
#: tools, ``heyoka_tpu_torch.tools``; ``series`` is kernel S1,
#: ``taylor/series_jet.py``)
LAUNCHES = {"jet": 0, "prop": 0, "jet_rolled": 0, "phase": 0,
            "conv_f32": 0, "conv_dd": 0, "proto_phase": 0, "series": 0}

#: header of the packed int32 table the kernels read (csrc/taylor_jet.cu
#: ``enum Hdr``): sizes, then offsets of the sub-tables in ``itab`` (and of
#: the f64 sub-tables in ``dtab``); the phase kernel's tape adds its own
#: fields after these (``jet_phase._PHDR``)
_HDR = ("W", "n_eq", "K", "time_col", "n_groups", "n_const", "n_pcol",
        "n_norm", "rhs", "norm", "ccols", "pcols", "pidx", "gop", "gstart",
        "gm", "argptr", "args", "d_rhofac", "d_cvals", "d_alpha", "n_out",
        "outc")
_HDR_LEN = 30

_F64 = torch.float64


class JetTape:
    """A plan, flattened by ``convert.plan_to_arrays``, with its tables on
    one device: the packed tables of the CUDA kernels (``itab``, ``dtab``)
    and the index tensors of the plain twins.  Its ops must lie in
    ``RULES``, the rule set of kernels B1/B2 (UnsupportedKernelOp)."""

    RULES = JET_OPS

    def __init__(self, arrays: dict, device):
        self.arrays = arrays
        self.device = torch.device(device)
        W, n_eq, K, time_col, _ = (int(x) for x in arrays["meta"])
        self.width, self.n_eq, self.order = W, n_eq, K
        self.time_col = None if time_col < 0 else time_col
        self.n_pars = int(arrays["par_idx"].max()) + 1 \
            if arrays["par_idx"].size else 0
        norm = np.concatenate([np.arange(n_eq), arrays["out_cols"]])

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=self.device)

        self.rhs = idx(arrays["rhs_cols"])
        self.norm_cols = idx(norm)
        self.n_out = int(arrays["out_cols"].size)
        self.const_cols = idx(arrays["const_cols"])
        self.const_vals = f64(arrays["const_vals"])
        self.par_cols = idx(arrays["par_cols"])
        self.par_idx = idx(arrays["par_idx"])
        plan = plan_from_arrays(arrays)
        check_supported(plan, self.RULES)
        # per group, in level order: (op name, first column, rows, operand
        # columns (m, nargs) with sums padded by the zero column, pow
        # exponents (m,) or None)
        self.groups = [
            (g.name, g.out_start, g.out_cols.size, idx(g.in_cols), g.alpha)
            for lv in plan.levels for g in lv
        ]
        self.ops = frozenset(g[0] for g in self.groups)
        self.itab, self.dtab = self._pack(arrays, norm)
        self.device = self.itab.device  # with its index ("cuda:0")

    def _pack(self, a, norm, extra_parts=None, extra_sizes=None):
        """The packed tables; ``extra_parts`` (int sub-tables appended after
        ``args``) and ``extra_sizes`` take the header fields after
        ``_HDR``'s, in that order."""
        extra_parts, extra_sizes = extra_parts or {}, extra_sizes or {}
        parts = {
            "rhs": a["rhs_cols"], "norm": norm, "ccols": a["const_cols"],
            "pcols": a["par_cols"], "pidx": a["par_idx"], "gop": a["g_op"],
            "gstart": a["g_start"], "gm": a["g_m"], "argptr": a["arg_ptr"],
            "args": a["args"], "outc": a["out_cols"], **extra_parts,
        }
        hdr = dict(W=self.width, n_eq=self.n_eq, K=self.order,
                   time_col=-1 if self.time_col is None else self.time_col,
                   n_groups=a["g_op"].size, n_const=a["const_cols"].size,
                   n_pcol=a["par_cols"].size, n_norm=norm.size,
                   n_out=a["out_cols"].size, **extra_sizes)
        body, off = [], _HDR_LEN
        for key, arr in parts.items():
            hdr[key] = off
            body.append(np.asarray(arr, np.int64))
            off += body[-1].size
        dparts = [np.array([rho_factor(self.order)]), a["const_vals"],
                  a["alpha"]]
        hdr["d_rhofac"] = 0
        hdr["d_cvals"] = 1
        hdr["d_alpha"] = 1 + a["const_vals"].size
        keys = _HDR + tuple(extra_parts) + tuple(extra_sizes)
        assert len(set(keys)) == len(keys)
        assert len(keys) <= _HDR_LEN
        head = np.zeros(_HDR_LEN, np.int64)
        head[:len(keys)] = [hdr[k] for k in keys]
        itab = np.concatenate([head, *body])
        if itab.max(initial=0) >= 2**31:
            raise ValueError("tape too large for the int32 kernel tables")
        dtab = np.concatenate([np.asarray(p, np.float64) for p in dparts])
        return (torch.as_tensor(itab.astype(np.int32), device=self.device),
                torch.as_tensor(dtab, device=self.device))


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _pow0_plain(b, alpha: float):
    """Order-0 power with the JAX package's special cases
    (``heyoka_tpu/taylor/jet.py`` ``_pow0``); csrc ``pow0`` mirrors it."""
    if alpha == -1.0:
        return 1.0 / b
    if alpha == 0.5:
        return torch.sqrt(b)
    if alpha == -0.5:
        return 1.0 / torch.sqrt(b)
    if alpha == -1.5:
        r = 1.0 / torch.sqrt(b)
        return r * r * r
    if alpha == 1.5:
        return b * torch.sqrt(b)
    if alpha == float(int(alpha)) and abs(alpha) <= 512:
        n = int(alpha)
        x = b if n > 0 else 1.0 / b
        n = abs(n)
        if n == 0:
            return torch.ones_like(b)
        r = None
        while n:
            if n & 1:
                r = x if r is None else r * x
            n >>= 1
            if n:
                x = x * x
        return r
    return torch.pow(b, alpha)


def _eval0(name, alpha, hist, nargs):
    """Order 0 of one group's columns.  ``hist(q, j0, j1)`` gives operand
    ``q``'s coefficients of orders ``j0..j1-1`` as ``(j1 - j0, m, B)``;
    ``q = -1`` names the group's own columns.  Shared by both twins, which
    differ only in where the coefficients live."""
    a0 = hist(0, 0, 1)[0]
    if name == "sum":
        v = a0
        for q in range(1, nargs):
            v = v + hist(q, 0, 1)[0]
        return v
    if name == "mul":
        return a0 * hist(1, 0, 1)[0]
    if name == "div":
        return a0 / hist(1, 0, 1)[0]
    if name == "sqrt":
        return torch.sqrt(a0)
    v = torch.empty_like(a0)
    for al in np.unique(alpha):
        sel = torch.as_tensor(np.flatnonzero(alpha == al), device=a0.device)
        v[sel] = _pow0_plain(a0[sel], float(al))
    return v


def _eval_k(name, alpha, k: int, hist, nargs):
    """Order ``k`` (>= 1) of one group's columns, from the lower orders
    (``hist`` as in :func:`_eval0`)."""
    if name == "sum":
        v = hist(0, k, k + 1)[0]
        for q in range(1, nargs):
            v = v + hist(q, k, k + 1)[0]
        return v
    if name == "mul":
        # sum_{j=0..k} a_j b_{k-j}
        return (hist(0, 0, k + 1) * hist(1, 0, k + 1).flip(0)).sum(0)
    if name == "div":
        # (a_k - sum_{j<k} q_j b_{k-j}) / b_0
        Q = hist(-1, 0, k)
        Bf = hist(1, 1, k + 1).flip(0)
        return (hist(0, k, k + 1)[0] - (Q * Bf).sum(0)) / hist(1, 0, 1)[0]
    if name == "sqrt":
        # (a_k - sum_{j=1..k-1} q_j q_{k-j}) / (2 q_0)
        Q = hist(-1, 1, k)
        return (hist(0, k, k + 1)[0] - (Q * Q.flip(0)).sum(0)) \
            / (2.0 * hist(-1, 0, 1)[0])
    # pow: (sum_{j<k} (alpha (k-j) - j) q_j b_{k-j}) / (k b_0)
    Q = hist(-1, 0, k)
    Bf = hist(0, 1, k + 1).flip(0)
    dev = Q.device
    j = torch.arange(k, dtype=_F64, device=dev)[:, None, None]
    al = torch.as_tensor(alpha, device=dev)[:, None]
    s1 = ((Q * Bf) * (k - j)).sum(0)
    s2 = ((Q * j) * Bf).sum(0)
    return (s1 * al - s2) / (k * hist(0, 0, 1)[0])


def _dense_hist(tc, s, m, cols):
    """``hist`` of one group over the dense ``(K+1, W, B)`` buffer."""
    def hist(q, j0, j1):
        if q < 0:
            return tc[j0:j1, s:s + m]
        return tc[j0:j1].index_select(1, cols[:, q])
    return hist


def _order0(tape: JetTape, tc):
    """Order 0 of every group column, in level order, in place."""
    for name, s, m, cols, alpha in tape.groups:
        tc[0, s:s + m] = _eval0(name, alpha, _dense_hist(tc, s, m, cols),
                                cols.shape[1])


def _order_k(tape: JetTape, tc, k: int):
    """Order k (>= 1) of every column, in place: the state rows from the
    right-hand sides at order k-1, then the groups in level order."""
    tc[k, :tape.n_eq] = tc[k - 1].index_select(0, tape.rhs) / k
    for name, s, m, cols, alpha in tape.groups:
        tc[k, s:s + m] = _eval_k(name, alpha, k,
                                 _dense_hist(tc, s, m, cols), cols.shape[1])


def _seed_plain(tape: JetTape, state, pars, t):
    """A zeroed ``(K+1, W, B)`` buffer with the order-0 state and the
    virtual columns (constants, parameters, time) seeded."""
    B = state.shape[1]
    tc = torch.zeros((tape.order + 1, tape.width, B), dtype=_F64,
                     device=state.device)
    tc[0, :tape.n_eq] = state
    tc[0, tape.const_cols] = tape.const_vals[:, None]
    if tape.par_cols.numel():
        tc[0, tape.par_cols] = pars.index_select(0, tape.par_idx)
    if tape.time_col is not None:
        tc[0, tape.time_col] = t
        tc[1, tape.time_col] = 1.0
    return tc


def _jet_fill(tape: JetTape, tc):
    _order0(tape, tc)
    for k in range(1, tape.order + 1):
        _order_k(tape, tc, k)


def _norms(tape: JetTape, tc):
    K = tape.order
    return torch.stack([tc[o].index_select(0, tape.norm_cols).abs().amax(0)
                        for o in (K - 1, K, 0)])


def _rows(tape: JetTape, tc):
    """The jet's rows of the dense buffer ``tc (K+1, W, B)``: the state
    columns, then the sv-func columns, ``(n_eq + n_out, K+1, B)`` (the
    norm columns, in their order)."""
    rows = tc[:, :tape.n_eq] if not tape.n_out else \
        tc.index_select(1, tape.norm_cols)
    return rows.permute(1, 0, 2).contiguous()


def jet_plain(tape: JetTape, state, pars, t=None):
    """Plain torch twin of kernel B2 (see the module docstring)."""
    _check_rules(tape)
    tc = _seed_plain(tape, state, pars, t)
    _jet_fill(tape, tc)
    return _rows(tape, tc), _norms(tape, tc)


def prop_plain(tape: JetTape, state, pars, aux, auxi, n_steps: int,
               high_accuracy: bool = True):
    """Plain torch twin of kernel B1: the same lane protocol, run for all
    lanes in lockstep with masks."""
    _check_rules(tape)
    _check_autonomous(tape)
    K, n_eq = tape.order, tape.n_eq
    B = state.shape[1]
    dev = state.device
    tc = _seed_plain(tape, state, pars, None)
    st = state.clone()
    mdt, dirv = aux[0], aux[1]
    rem_h, rem_l = aux[2].clone(), aux[3].clone()
    act = aux[4] > 0.5
    budget = auxi[0]
    zero = torch.zeros(B, dtype=_F64, device=dev)
    acc_h, acc_l = zero.clone(), zero.clone()
    min_h = torch.full((B,), float("inf"), dtype=_F64, device=dev)
    max_h, last_h = zero.clone(), zero.clone()
    ns = torch.zeros(B, dtype=torch.int32, device=dev)
    near = torch.zeros(B, dtype=torch.bool, device=dev)
    err = torch.zeros_like(near)
    update = ceval_update if high_accuracy else horner_update
    for _ in range(n_steps):
        if not bool(act.any()):
            break
        tc[0, :n_eq] = st
        _jet_fill(tape, tc)
        m1, mo, m0 = _norms(tape, tc)
        h = h_from_norms(m0, m1, mo, K, mdt)
        near_now = act & (h >= rem_h)
        take = act & ~near_now & (ns < budget)
        hs = h * dirv
        res = update(tc[:, :n_eq], hs, K, n_eq)
        ok = (h > 0.0) & torch.isfinite(h) & torch.isfinite(res).all(0)
        step_t = take & ok
        st = torch.where(step_t, res, st)
        nrh, nrl = dd_add_d(rem_h, rem_l, -h)
        rem_h = torch.where(step_t, nrh, rem_h)
        rem_l = torch.where(step_t, nrl, rem_l)
        nah, nal = dd_add_d(acc_h, acc_l, hs)
        acc_h = torch.where(step_t, nah, acc_h)
        acc_l = torch.where(step_t, nal, acc_l)
        min_h = torch.where(step_t, torch.minimum(min_h, h), min_h)
        max_h = torch.where(step_t, torch.maximum(max_h, h), max_h)
        last_h = torch.where(step_t, hs, last_h)
        ns = ns + step_t.to(torch.int32)
        near = near | near_now
        err = err | (take & ~ok)
        act = step_t & (ns < budget)
    of = torch.stack([acc_h, acc_l, min_h, max_h, last_h])
    oi = torch.stack([ns, near.to(torch.int32), err.to(torch.int32)])
    return st, of, oi


# ---------------------------------------------------------------------------
# the kernels' block layout
# ---------------------------------------------------------------------------

#: dynamic shared memory a block may have on the H100 (227 KB; above 48 KB
#: a kernel must be allowed it, which the C entry points do once per
#: kernel), the shared memory of an SM (228 KB), what the card keeps of it
#: for each resident block, and the threads an SM holds
SMEM_MAX, SM_SMEM, BLOCK_RESERVED = 232_448, 233_472, 1_024
SM_THREADS = 2048
#: doubles of kernel B1's per-lane step state behind the jets
#: (csrc/taylor_jet.cu ``kLaneScalars``, ``LaneVars``)
LANE_SCALARS = 16
#: lanes and threads a block with the jets in shared memory: the fastest of
#: lanes {1, 2, 3} x threads {128, 256} for B1 and B2 at 10,240 lanes of
#: the outer-Solar-System tape on an H100 (``chip_smoke.py`` phase 6,
#: PERF.md)
LANES, THREADS = 1, 256
#: lanes and threads a block where one lane's jet does not fit a block's
#: shared memory and the jets live in a global scratch buffer (csrc
#: ``kGlobalLanes``: a 32-byte sector of each row)
GLOBAL_LANES, GLOBAL_THREADS = 4, 256


def lane_bytes(W: int, K: int) -> int:
    """Shared memory of one lane in kernels B1/B2: its jet, ``(K+1) W``
    doubles, and its ``LANE_SCALARS``."""
    return 8 * ((K + 1) * W + LANE_SCALARS)


def block_layout(W: int, K: int):
    """``(lanes, smem_bytes)`` a block of kernels B1/B2 takes on a tape of
    ``W`` columns at order ``K``.  ``smem_bytes`` is the block's dynamic
    shared memory, its lanes' jets and scalars, or None where one lane's
    (:func:`lane_bytes`) exceeds ``SMEM_MAX``: then the jets live in a
    global scratch buffer, ``GLOBAL_LANES`` lanes a block, and the block's
    shared memory holds the lanes' scalars only."""
    per = lane_bytes(W, K)
    if per > SMEM_MAX:
        return GLOBAL_LANES, None
    lanes = min(LANES, SMEM_MAX // per)
    return lanes, lanes * per


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory an SM holds, as far as those two limit it."""
    return min(SM_SMEM // (smem + BLOCK_RESERVED), SM_THREADS // threads)


def table_bytes(tape: JetTape) -> int:
    """Bytes of the tape's packed tables (``itab`` ints, ``dtab``
    doubles)."""
    return 4 * tape.itab.numel() + 8 * tape.dtab.numel()


def tables_in_smem(tape: JetTape, smem, threads: int = THREADS) -> bool:
    """Whether kernels B1/B2 copy the tape's tables into shared memory
    behind the jets: only with the jets there (``smem``, a block's bytes
    without the tables, not None), and only where they cost no block an
    SM."""
    if smem is None:
        return False
    total = smem + table_bytes(tape)
    return total <= SMEM_MAX and (blocks_per_sm(total, threads)
                                  == blocks_per_sm(smem, threads))


def layout_report(tape: JetTape) -> dict:
    """The block layout kernels B1/B2 run ``tape`` with: ``layout``
    (``"smem"`` or ``"global"``), ``lanes_per_block``, ``smem_bytes``
    (:func:`block_layout`'s; None for the global layout) and ``tables``
    (``"smem"`` or ``"global"``, :func:`tables_in_smem`)."""
    lanes, smem = block_layout(tape.width, tape.order)
    return dict(layout="global" if smem is None else "smem",
                lanes_per_block=lanes, smem_bytes=smem,
                tables="smem" if tables_in_smem(tape, smem) else "global")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_rules(tape: JetTape):
    """Kernels B1/B2 and their twins know only ``JET_OPS``; a tape with
    other ops (a phase tape, ``jet_phase.PhaseTape``) raises."""
    bad = sorted(tape.ops - set(JET_OPS))
    if bad:
        raise UnsupportedKernelOp(
            f"op {bad[0]!r} has no rule in kernels B1/B2 (rule set: "
            f"{', '.join(JET_OPS)})")


def _check_autonomous(tape: JetTape):
    if tape.time_col is not None:
        raise UnsupportedKernelOp(
            "fused propagation needs an autonomous tape (no time column)")


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
            f"on {device}; got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def _device_of(state, tape: JetTape):
    dev = state.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if tape.device != dev:
        raise ValueError(f"tape tables live on {tape.device}, state on {dev}")
    return dev


def _ptr(x):
    """A tensor's device address for a ``c_void_p`` argument (None for an
    empty tensor: the kernels never read one)."""
    return x.data_ptr() if x.numel() else None


def _launch_cfg(tape: JetTape, B: int, dev, lanes=None, threads=None):
    """``(lanes, threads, smem bytes, scratch or None, n_it, n_dt)`` of one
    launch of kernel B1 or B2: :func:`block_layout`'s, or the ``lanes`` and
    ``threads`` given (jets in shared memory only; ``chip_smoke.py`` times
    the choices with them).  ``n_it``, ``n_dt``: the lengths of the tables
    where they go to shared memory (:func:`tables_in_smem`), else 0."""
    K, W = tape.order, tape.width
    L, smem = block_layout(W, K)
    if smem is None:
        n_blk = -(-B // L)
        tc = torch.empty(n_blk * (K + 1) * W * L, dtype=_F64, device=dev)
        return L, GLOBAL_THREADS, 8 * LANE_SCALARS * L, tc, 0, 0
    L = L if lanes is None else int(lanes)
    nt = THREADS if threads is None else int(threads)
    smem = L * lane_bytes(W, K)
    if smem > SMEM_MAX:
        raise ValueError(f"{L} lanes of {lane_bytes(W, K)} B exceed a "
                         f"block's {SMEM_MAX} B of shared memory")
    if not tables_in_smem(tape, smem, nt):
        return L, nt, smem, None, 0, 0
    return (L, nt, smem + table_bytes(tape), None, tape.itab.numel(),
            tape.dtab.numel())


def jet(tape: JetTape, state, pars, t=None):
    """Taylor jet of ``state (n_eq, B)`` with parameters ``pars (n_pars,
    B)`` and, for a tape with a time column, times ``t (B,)`` -> ``(tc
    (n_eq + n_out, K+1, B), norms (3, B))``: the state rows, then the
    tape's sv-func rows (``out_cols``, the event equations).  A CPU tensor runs :func:`jet_plain`;
    a CUDA tensor launches kernel B2 (``hy_jet_f64``) with the block
    layout of :func:`block_layout`."""
    _check_rules(tape)
    if _device_of(state, tape).type == "cpu":
        return jet_plain(tape, state, pars, t)
    return _jet_cuda(tape, state, pars, t)


def _jet_cuda(tape: JetTape, state, pars, t=None, lanes=None, threads=None,
              pad=0):
    """Kernel B2 at a block shape of ``lanes`` x ``threads``, with ``pad``
    more bytes of shared memory a block than it uses (fewer blocks an SM:
    ``tools.jet_scan`` times the kernel against its blocks an SM)."""
    dev = state.device
    B = state.shape[1]
    K, n_eq = tape.order, tape.n_eq
    _check("state", state, (n_eq, B), _F64, dev)
    _check("pars", pars, (tape.n_pars, B), _F64, dev)
    if tape.time_col is not None:
        _check("t", t, (B,), _F64, dev)
    out = torch.empty((n_eq + tape.n_out, K + 1, B), dtype=_F64, device=dev)
    norms = torch.empty((3, B), dtype=_F64, device=dev)
    if B == 0:
        return out, norms
    L, nt, smem, tc, n_it, n_dt = _launch_cfg(tape, B, dev, lanes, threads)
    smem += int(pad)
    lib = _build.load()
    rc = lib.hy_jet_f64(
        _ptr(tape.itab), _ptr(tape.dtab), _ptr(state), _ptr(pars),
        None if t is None or tape.time_col is None else _ptr(t),
        None if tc is None else _ptr(tc), _ptr(out), _ptr(norms), B, L, nt,
        smem, n_it, n_dt, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hy_jet_f64 launch failed: CUDA error {rc}")
    LAUNCHES["jet"] += 1
    return out, norms


def prop(tape: JetTape, state, pars, aux, auxi, n_steps: int,
         high_accuracy: bool = True):
    """Up to ``n_steps`` adaptive steps per lane from ``state (n_eq, B)``
    with ``aux (5, B) = [max_dt, dir, rem_hi, rem_lo, active]`` (``rem``:
    the remaining time in the direction of travel, >= 0) and ``auxi (1, B)
    int32`` (the step budget) -> ``(state (n_eq, B), of (5, B), oi (3, B)
    int32)``.  A CPU tensor runs :func:`prop_plain`; a CUDA tensor
    launches kernel B1 (``hy_prop_f64``) with the block layout of
    :func:`block_layout`."""
    _check_rules(tape)
    dev = _device_of(state, tape)
    _check_autonomous(tape)
    if dev.type == "cpu":
        return prop_plain(tape, state, pars, aux, auxi, n_steps,
                          high_accuracy)
    return _prop_cuda(tape, state, pars, aux, auxi, n_steps, high_accuracy)


def _prop_cuda(tape: JetTape, state, pars, aux, auxi, n_steps: int,
               high_accuracy: bool = True, lanes=None, threads=None):
    dev = state.device
    B = state.shape[1]
    n_eq = tape.n_eq
    _check("state", state, (n_eq, B), _F64, dev)
    _check("pars", pars, (tape.n_pars, B), _F64, dev)
    _check("aux", aux, (5, B), _F64, dev)
    _check("auxi", auxi, (1, B), torch.int32, dev)
    st = torch.empty((n_eq, B), dtype=_F64, device=dev)
    of = torch.empty((5, B), dtype=_F64, device=dev)
    oi = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B == 0:
        return st, of, oi
    L, nt, smem, tc, n_it, n_dt = _launch_cfg(tape, B, dev, lanes, threads)
    lib = _build.load()
    rc = lib.hy_prop_f64(
        _ptr(tape.itab), _ptr(tape.dtab), _ptr(state), _ptr(pars),
        _ptr(aux), _ptr(auxi), None if tc is None else _ptr(tc), _ptr(st),
        _ptr(of), _ptr(oi), B, int(n_steps), int(bool(high_accuracy)), L, nt,
        smem, n_it, n_dt, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hy_prop_f64 launch failed: CUDA error {rc}")
    LAUNCHES["prop"] += 1
    return st, of, oi
