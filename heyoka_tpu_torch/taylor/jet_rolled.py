"""The rolled jet for huge tapes (kernel B3): its tape tables, its wrapper
and its plain torch twin.

It replaces ``make_dd_jet_kernel_rolled`` (``heyoka_tpu/taylor/
pallas_phase.py:1842``) and has the contract of ``jet_kernels.jet``:
``(state (n_eq, B), pars (n_pars, B), t (B,))`` in, ``(tc (n_eq, K+1, B),
norms (3, B))`` out.  What differs is where the coefficients live: in the
row classes of :mod:`.rows` — H ``(K+1, WH, B)`` for the columns whose
history a recurrence reads, C ``(WC, B)`` for those read only at the
order they are produced (one order held, overwritten by the next), V
``(WV, B)`` for literals and parameters (zero above order 0).  At
mascon-512 and order 19 that is 0.70 MB per lane instead of the dense
1.48 MB.

Both the twin and the kernel read every operand through the class maps,
so the twin's agreement with the dense jet is what shows the partition
sound.  A CPU tensor runs :func:`jet_rolled_plain`; a CUDA tensor launches
``hy_jet_rolled_f64`` (``csrc/taylor_jet_rolled.cu``) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..convert import OPCODES, plan_from_arrays
from .jet_kernels import (
    LAUNCHES, JetTape, _F64, _check, _device_of, _eval0, _eval_k, _ptr,
)
from .rows import _row_classes

#: a column's location word for the kernel: its class above bit 28, its
#: row within the class buffer below (csrc/taylor_jet_rolled.cu ``ref``)
CLS_SHIFT = 28

#: header of the kernel's int32 table (csrc/taylor_jet_rolled.cu
#: ``enum RHdr``): sizes, then offsets of the sub-tables in ``itab`` (and
#: of the f64 ones in ``dtab``)
_RHDR = ("n_eq", "K", "WH", "WC", "WV", "time_row", "n_levels", "n_const",
         "n_pcol", "n_norm", "rhs", "norm", "crows", "prows", "pidx", "lvl",
         "op", "oloc", "argptr", "aloc", "d_cvals", "d_alpha")
_RHDR_LEN = 24


class _Cols:
    """A set of tape columns, read and written through the class maps: for
    each class present, the positions in the set (None: all of them) and
    the rows in the class buffer."""

    def __init__(self, cols, classv, rowmap, device):
        cols = np.asarray(cols, np.int64)
        cls = classv[cols]
        self.n = cols.size
        self.parts = []
        for c in np.unique(cls):
            pos = np.flatnonzero(cls == c)
            self.parts.append((
                int(c),
                None if pos.size == cols.size
                else torch.as_tensor(pos, device=device),
                torch.as_tensor(rowmap[cols[pos]], device=device)))

    def hist(self, bufs, j0: int, j1: int):
        """Coefficients of orders ``j0..j1-1``, ``(j1 - j0, n, B)``: an H
        row holds them all, a C row only the current order (returned for
        every order, as the kernel reads it), a V row its value at order 0
        and zero above."""
        H, C, V = bufs
        n_o = j1 - j0
        out = None
        for c, pos, rows in self.parts:
            if c == 0:
                v = H[j0:j1].index_select(1, rows)
            elif c == 1:
                v = C.index_select(0, rows).expand(n_o, -1, -1)
            else:
                v = H.new_zeros((n_o, rows.numel(), H.shape[2]))
                if j0 == 0 < j1:
                    v[0] = V.index_select(0, rows)
            if pos is None:
                return v
            if out is None:
                out = H.new_empty((n_o, self.n, H.shape[2]))
            out[:, pos] = v
        return out

    def write(self, bufs, k: int, v):
        """Store order ``k`` of a set of op columns (H rows at order k, C
        rows in their one slot; an op column is never V)."""
        H, C, _ = bufs
        for c, pos, rows in self.parts:
            x = v if pos is None else v.index_select(0, pos)
            (H[k] if c == 0 else C).index_copy_(0, rows, x)


class RolledTape(JetTape):
    """A :class:`JetTape` with the row-class partition of its plan: the
    class maps, the twin's column sets and the packed tables of kernel
    B3 (``ritab``, ``rdtab``)."""

    def __init__(self, arrays: dict, device):
        super().__init__(arrays, device)
        plan = plan_from_arrays(arrays)
        classv, rowmap, (WH, WC, WV) = _row_classes(plan)
        self.classv, self.rowmap = classv, rowmap
        self.sizes = (WH, WC, WV)
        n_eq = self.n_eq
        # the layout the kernel and the seeding rely on
        assert (rowmap[:n_eq] == np.arange(n_eq)).all() \
            and (classv[:n_eq] == 0).all(), "state columns lead H"
        virt = np.concatenate([arrays["const_cols"], arrays["par_cols"]])
        assert (classv[virt.astype(np.int64)] == 2).all(), "literals are V"
        n_ops = arrays["arg_ptr"].size - 1
        assert (classv[n_eq:n_eq + n_ops] != 2).all(), "ops are H or C"
        if self.time_col is not None:
            assert classv[self.time_col] == 0, "the time column is H"

        def cols(c):
            return _Cols(c, classv, rowmap, self.device)

        self.rhs_set = cols(arrays["rhs_cols"])
        self.norm_set = cols(self.norm_cols.cpu().numpy())
        self.rgroups = []
        for name, s, m, gcols, alpha in self.groups:
            gcols = gcols.cpu().numpy()
            self.rgroups.append((
                name, alpha, cols(np.arange(s, s + m)),
                [cols(gcols[:, q]) for q in range(gcols.shape[1])]))
        self.ritab, self.rdtab = self._pack_rolled(plan, arrays)

    def _pack_rolled(self, plan, a):
        n_eq = self.n_eq
        loc = (self.classv.astype(np.int64) << CLS_SHIFT) | self.rowmap
        groups = [g for lv in plan.levels for g in lv]
        m = [g.out_cols.size for g in groups]
        # the groups, in plan order, fill the op columns one after the
        # other, so each level is one contiguous range of op indices
        assert [g.out_start - n_eq for g in groups] == \
            np.cumsum([0] + m[:-1]).tolist()
        lvl = np.cumsum([0] + [sum(g.out_cols.size for g in lv)
                               for lv in plan.levels])
        op = np.repeat([OPCODES.index(g.name) for g in groups], m)
        n_ops = op.size
        parts = {
            "rhs": loc[a["rhs_cols"]],
            "norm": loc[self.norm_cols.cpu().numpy()],
            "crows": self.rowmap[a["const_cols"].astype(np.int64)],
            "prows": self.rowmap[a["par_cols"].astype(np.int64)],
            "pidx": a["par_idx"], "lvl": lvl, "op": op,
            "oloc": loc[n_eq:n_eq + n_ops], "argptr": a["arg_ptr"],
            "aloc": loc[a["args"].astype(np.int64)],
        }
        WH, WC, WV = self.sizes
        hdr = dict(n_eq=n_eq, K=self.order, WH=WH, WC=WC, WV=WV,
                   time_row=-1 if self.time_col is None
                   else int(self.rowmap[self.time_col]),
                   n_levels=len(plan.levels), n_const=a["const_cols"].size,
                   n_pcol=a["par_cols"].size, n_norm=parts["norm"].size)
        body, off = [], _RHDR_LEN
        for key, arr in parts.items():
            hdr[key] = off
            body.append(np.asarray(arr, np.int64))
            off += body[-1].size
        hdr["d_cvals"] = 0
        hdr["d_alpha"] = a["const_vals"].size
        head = np.zeros(_RHDR_LEN, np.int64)
        head[:len(_RHDR)] = [hdr[k] for k in _RHDR]
        itab = np.concatenate([head, *body])
        if itab.max(initial=0) >= 2**31 or max(self.sizes) >= 2**CLS_SHIFT:
            raise ValueError("tape too large for the int32 kernel tables")
        dtab = np.concatenate([a["const_vals"], a["alpha"]]).astype(
            np.float64)
        return (torch.as_tensor(itab.astype(np.int32), device=self.device),
                torch.as_tensor(dtab, device=self.device))


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def jet_rolled_plain(tape: RolledTape, state, pars, t=None):
    """Plain torch twin of kernel B3: the jet of :func:`jet_kernels.
    jet_plain`, with the coefficients in the H/C/V class buffers and every
    operand read through the class maps.  H and C start as NaN, so a read
    of a slot that was never written shows in the result."""
    K, n_eq = tape.order, tape.n_eq
    WH, WC, WV = tape.sizes
    B = state.shape[1]
    dev = state.device
    H = torch.full((K + 1, WH, B), float("nan"), dtype=_F64, device=dev)
    C = torch.full((WC, B), float("nan"), dtype=_F64, device=dev)
    V = torch.empty((WV, B), dtype=_F64, device=dev)
    bufs = (H, C, V)
    # seeds: the state, the literals and parameters, the time (t, 1, 0, ...)
    H[0, :n_eq] = state
    rm = tape.rowmap
    V[rm[tape.arrays["const_cols"].astype(np.int64)]] = \
        tape.const_vals[:, None]
    if tape.par_cols.numel():
        V[rm[tape.arrays["par_cols"].astype(np.int64)]] = \
            pars.index_select(0, tape.par_idx)
    if tape.time_col is not None:
        r = int(rm[tape.time_col])
        H[:, r] = 0.0
        H[0, r] = t
        H[1, r] = 1.0

    def hist_of(own, ops):
        def hist(q, j0, j1):
            return (own if q < 0 else ops[q]).hist(bufs, j0, j1)
        return hist

    for name, alpha, own, ops in tape.rgroups:
        own.write(bufs, 0, _eval0(name, alpha, hist_of(own, ops), len(ops)))
    for k in range(1, K + 1):
        H[k, :n_eq] = tape.rhs_set.hist(bufs, k - 1, k)[0] / k
        for name, alpha, own, ops in tape.rgroups:
            own.write(bufs, k, _eval_k(name, alpha, k, hist_of(own, ops),
                                       len(ops)))
    norms = torch.stack([tape.norm_set.hist(bufs, o, o + 1)[0].abs().amax(0)
                         for o in (K - 1, K, 0)])
    return H[:, :n_eq].permute(1, 0, 2).contiguous(), norms


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def jet_rolled(tape: RolledTape, state, pars, t=None):
    """Taylor jet with the contract of :func:`jet_kernels.jet`, over the
    class buffers.  A CPU tensor runs :func:`jet_rolled_plain`; a CUDA
    tensor launches kernel B3 (``hy_jet_rolled_f64``)."""
    dev = _device_of(state, tape)
    if dev.type == "cpu":
        return jet_rolled_plain(tape, state, pars, t)
    B = state.shape[1]
    K, n_eq = tape.order, tape.n_eq
    WH, WC, WV = tape.sizes
    _check("state", state, (n_eq, B), _F64, dev)
    _check("pars", pars, (tape.n_pars, B), _F64, dev)
    if tape.time_col is not None:
        _check("t", t, (B,), _F64, dev)
    out = torch.empty((n_eq, K + 1, B), dtype=_F64, device=dev)
    norms = torch.empty((3, B), dtype=_F64, device=dev)
    if B == 0:
        return out, norms
    H = torch.empty((K + 1, WH, B), dtype=_F64, device=dev)
    C = torch.empty((WC, B), dtype=_F64, device=dev)
    V = torch.empty((WV, B), dtype=_F64, device=dev)
    lib = _build.load()
    rc = lib.hy_jet_rolled_f64(
        _ptr(tape.ritab), _ptr(tape.rdtab), _ptr(state), _ptr(pars),
        None if t is None or tape.time_col is None else _ptr(t),
        _ptr(H), _ptr(C), _ptr(V), _ptr(out), _ptr(norms), B,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"hy_jet_rolled_f64 launch failed: CUDA error {rc}")
    LAUNCHES["jet_rolled"] += 1
    return out, norms
