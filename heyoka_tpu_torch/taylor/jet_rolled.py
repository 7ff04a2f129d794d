"""The rolled jet for huge tapes (kernel B3): its tape tables, its block
layout, its wrapper and its plain torch twin.

It replaces ``make_dd_jet_kernel_rolled`` (``heyoka_tpu/taylor/
pallas_phase.py:1842``, with its ``sv_extra`` rows :1896-1903) and has
the contract of ``jet_kernels.jet``: ``(state (n_eq, B), pars (n_pars,
B), t (B,))`` in, ``(tc (n_eq + n_out, K+1, B), norms (3, B))`` out, the
state rows and then the sv-func rows (the event equations).  What differs is where the coefficients live: in the
row classes of :mod:`.rows`, with the literal aliases taken out of H.
One lane's coefficients are

- H ``(K+1, WH)``: the full history of the columns a recurrence reads at
  lower orders (the state, the time, every root of an alias chain);
- A ``(NA,)``: order 0 of each alias (``rows._aliases``), a column ``a +
  literal`` or ``literal * a`` whose orders k >= 1 are read as its root's
  history times its chain's literals, one multiply after the other;
- C ``(WC,)``: the current order of the columns read only at the order
  they are produced (one order held, overwritten by the next);
- V ``(WV,)``: literals and parameters, a value at order 0 and zero above.

At mascon-512 and order 19 H, A and C take 214,488 B a lane, which fits a
block's shared memory (:func:`block_layout`) beside S, the literals the
alias chains multiply by (513 doubles), a zero (a literal above order 0)
and a staging row of a double a thread for the wide sums; V stays in
global memory.

An sv-func column is H (``rows._row_classes``) but may still be an
alias (an event ``x - 1.5`` is ``x + (-1.5)``): its rows are read through
its root and literals, as every alias operand is, so the event rows cost
no bytes a lane.

Both the twin and the kernel read every operand through the class maps
and the alias table, so the twin's agreement with the dense jet is what
shows the partition and the aliasing sound.  A CPU tensor runs
:func:`jet_rolled_plain`; a CUDA tensor launches ``hy_jet_rolled_f64``
(``csrc/taylor_jet_rolled.cu``) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..convert import OPCODES, plan_from_arrays
from .jet_kernels import (
    LAUNCHES, SMEM_MAX, JetTape, _F64, _check, _device_of, _eval0, _eval_k,
    _ptr, blocks_per_sm,
)
from .rows import MAX_SCALES, _aliases, _row_classes

#: a column's location word for the kernel: its class above bit 28, its
#: row within the class buffer below (csrc/taylor_jet_rolled.cu
#: ``kClsShift``); classes H 0, C 1, V 2 and the aliases A 3
CLS_SHIFT = 28
H, C, V, A = 0, 1, 2, 3

#: header of the kernel's int32 table (csrc/taylor_jet_rolled.cu
#: ``enum RHdr``): sizes, then offsets of the sub-tables in ``ritab`` (and
#: of the f64 ones in ``rdtab``)
_RHDR = ("n_eq", "K", "WH", "WC", "WV", "NA", "NS", "time_row",
         "n_levels", "n_const", "n_pcol", "n_norm", "rhs", "norm", "crows",
         "prows", "pidx", "srows", "alias", "lvl0", "lvlk", "seg", "rec",
         "off", "d_cvals", "d_alpha", "n_out", "outc")
_RHDR_LEN = 32
#: ints of one segment of the tables: op, items, first record, arity
#: (``SEG_VAR``: records through ``off``, a thread an item; ``SEG_WIDE``:
#: the same, a warp an item), aux (the first ``off`` entry of a sum, the
#: first ``d_alpha`` entry of a pow) and the ints of an operand in a
#: record: 1 (its location word) or, in an order-k list with an alias
#: among its operands, ``RESOLVED`` (the word, the alias's root row and its
#: two S indices plus one, packed 16 bits each; 0 where there is none)
SEG_INTS = 6
SEG_VAR, SEG_WIDE = 0, -1
RESOLVED = 3
#: a sum segment whose items average this many operands or more is
#: summed by a warp an item (csrc ``warp_sum``)
WIDE_SUM = 32

#: threads a block of kernel B3 (one lane a block) may have, and the items
#: a thread takes in the tape's widest pass: a block of the largest size
#: with at least ``ITEMS_PER_THREAD`` items a thread there, the smallest
#: where none has (:func:`block_threads`).  On an H100 at 1,024 lanes the
#: idle threads of a larger block cost more than its items gain: mascon-32
#: runs fastest with 64, mascon-128 with 128, mascon-256 and -512 with
#: 256 (``tools/rolled_scan.py``, PERF.md)
BLOCK_THREADS = (64, 128, 256)
ITEMS_PER_THREAD = 3
#: threads an SM on the global layout, in blocks that each walk over the
#: lanes (two of 256 threads, four of 128, eight of 64): as many as the
#: kernel's 128 registers a thread let an SM hold (ptxas, ``chip_smoke.py``
#: phase 2); one block of 256 ran mascon-512 1.5x slower on an H100
#: (``tools/rolled_scan.py``)
GLOBAL_SM_THREADS = 512


def lane_bytes(WH: int, NA: int, WC: int, K: int) -> int:
    """Bytes of one lane's H, A and C in kernel B3."""
    return 8 * ((K + 1) * WH + NA + WC)


def block_threads(tape: "RolledTape") -> int:
    """Threads a block of kernel B3 on ``tape``: the largest of
    ``BLOCK_THREADS`` that leaves ``ITEMS_PER_THREAD`` items a thread in
    the widest pass of the orders k >= 1 (``tape.widest``, a wide sum
    counting a warp's 32), else the smallest."""
    fit = [t for t in BLOCK_THREADS if t * ITEMS_PER_THREAD <= tape.widest]
    return max(fit, default=BLOCK_THREADS[0])


def smem_bytes(tape: "RolledTape", layout: str, threads: int) -> int:
    """A block's dynamic shared memory: the lane's H, A and C on the smem
    layout, then S, a zero and a staging double a thread."""
    WH, WC, _, NA, NS = tape.sizes
    own = lane_bytes(WH, NA, WC, tape.order) if layout == "smem" else 0
    return own + 8 * (NS + 1 + threads)


def block_layout(tape: "RolledTape"):
    """``(layout, lane bytes)`` of kernel B3 on ``tape``: one lane a
    block, its H, A and C (:func:`lane_bytes`) in the block's dynamic
    shared memory (``"smem"``) where an SM holds two such blocks or more,
    else in a global scratch buffer of the same layout (``"global"``,
    ``GLOBAL_SM_THREADS`` threads an SM): one block alone on an SM has no
    other lane's work to hide its latency behind."""
    WH, WC, _, NA, NS = tape.sizes
    per = lane_bytes(WH, NA, WC, tape.order)
    nt = block_threads(tape)
    two = blocks_per_sm(smem_bytes(tape, "smem", nt), nt) >= 2
    return ("smem" if two else "global"), per


def layout_report(tape: "RolledTape") -> dict:
    """The layout kernel B3 runs ``tape`` with: ``layout``,
    ``lanes_per_block`` (1), ``threads``, ``smem_bytes`` (a block's
    dynamic shared memory, :func:`smem_bytes`), ``lane_bytes``,
    ``aliases`` and ``tables`` (always in global memory)."""
    layout, per = block_layout(tape)
    nt = block_threads(tape)
    return dict(layout=layout, lanes_per_block=1, threads=nt,
                smem_bytes=smem_bytes(tape, layout, nt), lane_bytes=per,
                aliases=tape.sizes[3], tables="global")


class _Cols:
    """A set of tape columns, read and written through the class maps: for
    each class present, the positions in the set (None: all of them) and
    the rows in the class buffer (for an alias its index, with its root
    row and scale rows)."""

    def __init__(self, cols, tape, device):
        cols = np.asarray(cols, np.int64)
        cls = tape.classv[cols]
        self.n = cols.size
        self.parts = []
        for c in np.unique(cls):
            pos = np.flatnonzero(cls == c)
            rows = tape.rowmap[cols[pos]]
            extra = None
            if c == A:
                extra = (torch.as_tensor(tape.alias_root[rows], device=device),
                         [(torch.as_tensor(np.flatnonzero(s >= 0),
                                           device=device),
                           torch.as_tensor(s[s >= 0], device=device))
                          for s in tape.alias_scales[rows].T])
            self.parts.append((
                int(c),
                None if pos.size == cols.size
                else torch.as_tensor(pos, device=device),
                torch.as_tensor(rows, device=device), extra))

    def hist(self, bufs, j0: int, j1: int):
        """Coefficients of orders ``j0..j1-1``, ``(j1 - j0, n, B)``: an H
        row holds them all, a C row only the current order (returned for
        every order, as the kernel reads it), a V row its value at order 0
        and zero above, an alias its order 0 and above it its root's
        orders, times each literal of its chain in turn."""
        Hb, Cb, Vb, Ab = bufs
        n_o = j1 - j0
        out = None
        for c, pos, rows, extra in self.parts:
            if c == H:
                v = Hb[j0:j1].index_select(1, rows)
            elif c == C:
                v = Cb.index_select(0, rows).expand(n_o, -1, -1)
            elif c == V:
                v = Hb.new_zeros((n_o, rows.numel(), Hb.shape[2]))
                if j0 == 0 < j1:
                    v[0] = Vb.index_select(0, rows)
            else:
                root, scales = extra
                v = Hb.new_empty((n_o, rows.numel(), Hb.shape[2]))
                if j0 == 0:
                    v[0] = Ab.index_select(0, rows)
                lo = max(j0, 1)
                if lo < j1:
                    x = Hb[lo:j1].index_select(1, root)
                    for sel, srows in scales:
                        x[:, sel] = Vb.index_select(0, srows) * x[:, sel]
                    v[lo - j0:] = x
            if pos is None:
                return v
            if out is None:
                out = Hb.new_empty((n_o, self.n, Hb.shape[2]))
            out[:, pos] = v
        return out

    def write(self, bufs, k: int, v):
        """Store order ``k`` of a set of op columns: H rows at order k, C
        rows in their one slot, an alias's order 0 (an alias is never
        computed above order 0; an op column is never V)."""
        Hb, Cb, _, Ab = bufs
        for c, pos, rows, _ in self.parts:
            assert c != V and (c != A or k == 0), "write to a literal"
            x = v if pos is None else v.index_select(0, pos)
            (Hb[k] if c == H else Cb if c == C else Ab).index_copy_(
                0, rows, x)


class RolledTape(JetTape):
    """A :class:`JetTape` with the row classes of its plan and its literal
    aliases: the class maps, the alias table, the twin's column sets, the
    packed tables of kernel B3 (``ritab``, ``rdtab``) and ``widest``, the
    thread slots of its widest pass at orders k >= 1 (an item a thread, a
    wide sum a warp's 32)."""

    def __init__(self, arrays: dict, device, *, _with_aliases: bool = True,
                 _wide_sum: int = WIDE_SUM):
        # the two private switches build the variants tools/rolled_scan.py
        # times: no literal aliases (every H column keeps its history) and
        # sums given to a warp from ``_wide_sum`` operands on
        super().__init__(arrays, device)
        plan = plan_from_arrays(arrays)
        classv, rowmap, (_, WC, WV) = _row_classes(plan)
        aliases = _aliases(plan, classv) if _with_aliases else {}
        self._wide_sum = _wide_sum
        n_eq = self.n_eq
        classv = classv.copy()
        cols = np.fromiter(aliases, np.int64, len(aliases))
        classv[cols] = A
        rowmap = rowmap.copy()
        roots = np.flatnonzero(classv == H)
        rowmap[roots] = np.arange(roots.size)
        rowmap[cols] = np.arange(cols.size)
        self.classv, self.rowmap = classv, rowmap
        # per alias: its root's H row and its chain's V rows (-1: none);
        # S holds each V row a chain reads once (``srows``)
        self.alias_root = np.array(
            [rowmap[r] for r, _ in aliases.values()], np.int64)
        self.alias_scales = np.full((cols.size, MAX_SCALES), -1, np.int64)
        for i, (_, sc) in enumerate(aliases.values()):
            self.alias_scales[i, :len(sc)] = rowmap[list(sc)]
        sc = self.alias_scales
        self.srows = np.unique(sc[sc >= 0])
        self.sizes = (roots.size, WC, WV, cols.size, self.srows.size)
        # the layout the kernel and the seeding rely on
        assert (rowmap[:n_eq] == np.arange(n_eq)).all() \
            and (classv[:n_eq] == H).all(), "state columns lead H"
        virt = np.concatenate([arrays["const_cols"], arrays["par_cols"]])
        assert (classv[virt.astype(np.int64)] == V).all(), "literals are V"
        n_ops = arrays["arg_ptr"].size - 1
        assert (classv[n_eq:n_eq + n_ops] != V).all(), "ops are H, A or C"
        if self.time_col is not None:
            assert classv[self.time_col] == H, "the time column is H"

        def cset(c):
            return _Cols(c, self, self.device)

        self.rhs_set = cset(arrays["rhs_cols"])
        self.norm_set = cset(self.norm_cols.cpu().numpy())
        self.out_set = cset(arrays["out_cols"]) if self.n_out else None
        # per group: order 0 over all its columns; orders k >= 1 over those
        # that are not aliases (None where none is left)
        self.rgroups = []
        for name, s, m, gcols, alpha in self.groups:
            gcols = gcols.cpu().numpy()
            keep = np.flatnonzero(classv[s:s + m] != A)

            def part(sel):
                return (cset(s + sel), [cset(gcols[sel, q])
                                        for q in range(gcols.shape[1])],
                        None if alpha is None else alpha[sel])

            every = part(np.arange(m))
            above = None if keep.size == 0 else \
                every if keep.size == m else part(keep)
            self.rgroups.append((name, every, above))
        # an alias's literals as S indices, and an operand resolved:
        # (word, root row, S indices plus one, 16 bits each)
        self.alias_s = np.where(sc >= 0, np.searchsorted(self.srows, sc), -1)
        if self.srows.size >= 0xFFFF or roots.size >= 2**31:
            raise ValueError("tape too large for the packed alias literals")
        self.ritab, self.rdtab = self._pack_rolled(plan, arrays)

    def _resolved(self, word: int):
        """An operand's ints in an order-k record with aliases: its word,
        and for an alias its root's H row and its literals' S indices."""
        if word >> CLS_SHIFT != A:
            return [word, 0, 0]
        i = word & ((1 << CLS_SHIFT) - 1)
        s0, s1 = self.alias_s[i] + 1
        return [word, int(self.alias_root[i]), int(s0) | int(s1) << 16]

    def _segments(self, plan, a, loc, lvl_key):
        """The segments of one of the kernel's two item lists, level by
        level: every op column (``lvl0``, order 0) or the columns that are
        not aliases (``lvlk``, orders k >= 1).  Returns the per-level
        segment counts and, per segment, ``(op, [(out word, operand
        ints)], alphas or None, ints an operand)``."""
        n_eq = self.n_eq
        arg_ptr, args = a["arg_ptr"], a["args"].astype(np.int64)
        counts, segs = [], []
        for lv in plan.levels:
            n = 0
            for g in lv:
                cols = g.out_cols
                if lvl_key == "lvlk":
                    cols = cols[self.classv[cols] != A]
                if cols.size == 0:
                    continue
                items = [(int(loc[c]),
                          loc[args[arg_ptr[c - n_eq]:arg_ptr[c - n_eq + 1]]]
                          .tolist()) for c in cols]
                al = a["alpha"][cols - n_eq] if g.name == "pow" else None
                res = lvl_key == "lvlk" and any(
                    x >> CLS_SHIFT == A for _, xs in items for x in xs)
                if res:
                    items = [(o, [v for x in xs for v in self._resolved(x)])
                             for o, xs in items]
                segs.append((g.name, items, al, RESOLVED if res else 1))
                n += 1
            counts.append(n)
        return counts, segs

    def _pack_rolled(self, plan, a):
        n_eq = self.n_eq
        loc = (self.classv.astype(np.int64) << CLS_SHIFT) | self.rowmap
        rec, off, alphas, seg, lvls = [], [], [], [], {}
        for key in ("lvl0", "lvlk"):
            counts, segs = self._segments(plan, a, loc, key)
            lvls[key] = len(seg) // SEG_INTS + np.cumsum([0] + counts)
            slots = []  # per segment: its items, a wide sum a warp's 32
            for name, items, al, per in segs:
                ar = {len(x) // per for _, x in items}
                wide = np.mean([len(x) for _, x in items]) \
                    >= self._wide_sum * per
                first = len(rec)
                if len(ar) == 1 and not wide:
                    # instance-regular: the arity once for the segment
                    kind, aux = ar.pop(), 0
                    for o, x in items:
                        rec += [o, *x]
                else:
                    kind, aux = (SEG_WIDE if wide else SEG_VAR), len(off)
                    for o, x in items:
                        off.append(len(rec) - first)
                        rec += [o, *x]
                    off.append(len(rec) - first)
                if al is not None:
                    aux = len(alphas)
                    alphas += list(al)
                seg += [OPCODES.index(name), len(items), first, kind, aux,
                        per]
                slots.append(len(items) * (32 if wide else 1))
            if key == "lvlk":
                ends = np.cumsum([0] + counts)
                self.widest = max((sum(slots[i:j]) for i, j in
                                   zip(ends[:-1], ends[1:])), default=0)
        nrm = self.norm_cols.cpu().numpy()
        alias = np.zeros((self.sizes[3], 4), np.int64)
        alias[:, 0] = self.alias_root
        alias[:, 1:1 + MAX_SCALES] = self.alias_s
        parts = {
            "rhs": loc[a["rhs_cols"]], "norm": loc[nrm],
            "crows": self.rowmap[a["const_cols"].astype(np.int64)],
            "prows": self.rowmap[a["par_cols"].astype(np.int64)],
            "pidx": a["par_idx"], "srows": self.srows,
            "alias": alias.ravel(),
            "lvl0": lvls["lvl0"], "lvlk": lvls["lvlk"], "seg": seg,
            "rec": rec, "off": off, "outc": loc[a["out_cols"]],
        }
        WH, WC, WV, NA, NS = self.sizes
        hdr = dict(n_eq=n_eq, K=self.order, WH=WH, WC=WC, WV=WV, NA=NA, NS=NS,
                   time_row=-1 if self.time_col is None
                   else int(self.rowmap[self.time_col]),
                   n_levels=len(plan.levels), n_const=a["const_cols"].size,
                   n_pcol=a["par_cols"].size, n_norm=nrm.size,
                   n_out=a["out_cols"].size)
        body, off_ = [], _RHDR_LEN
        for key, arr in parts.items():
            if key == "alias":  # int4 records: 16-byte aligned
                pad = -off_ % 4
                body.append(np.zeros(pad, np.int64))
                off_ += pad
            hdr[key] = off_
            body.append(np.asarray(arr, np.int64))
            off_ += body[-1].size
        hdr["d_cvals"] = 0
        hdr["d_alpha"] = a["const_vals"].size
        head = np.zeros(_RHDR_LEN, np.int64)
        head[:len(_RHDR)] = [hdr[k] for k in _RHDR]
        itab = np.concatenate([head, *body])
        if itab.max(initial=0) >= 2**31 or max(self.sizes) >= 2**CLS_SHIFT:
            raise ValueError("tape too large for the int32 kernel tables")
        dtab = np.concatenate([a["const_vals"], np.asarray(alphas, float)])
        return (torch.as_tensor(itab.astype(np.int32), device=self.device),
                torch.as_tensor(dtab.astype(np.float64), device=self.device))


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def jet_rolled_plain(tape: RolledTape, state, pars, t=None):
    """Plain torch twin of kernel B3: the jet of :func:`jet_kernels.
    jet_plain`, with the coefficients in the H/C/V/A buffers, every operand
    read through the class maps and the alias table, and the aliases
    computed at order 0 only.  H, C and A start as NaN, so a read of a slot
    that was never written shows in the result.  It runs in ``state``'s
    dtype (the kernel in f64 only; the tests also hold an f32 twin against
    the multiple-precision jet)."""
    K, n_eq = tape.order, tape.n_eq
    WH, WC, WV, NA, _ = tape.sizes
    B = state.shape[1]
    dev, dt = state.device, state.dtype
    nan = float("nan")
    bufs = (torch.full((K + 1, WH, B), nan, dtype=dt, device=dev),
            torch.full((WC, B), nan, dtype=dt, device=dev),
            torch.empty((WV, B), dtype=dt, device=dev),
            torch.full((NA, B), nan, dtype=dt, device=dev))
    Hb, _, Vb, _ = bufs
    # seeds: the state, the literals and parameters, the time (t, 1, 0, ...)
    Hb[0, :n_eq] = state
    rm = tape.rowmap
    Vb[rm[tape.arrays["const_cols"].astype(np.int64)]] = \
        tape.const_vals[:, None].to(dt)
    if tape.par_cols.numel():
        Vb[rm[tape.arrays["par_cols"].astype(np.int64)]] = \
            pars.index_select(0, tape.par_idx)
    if tape.time_col is not None:
        r = int(rm[tape.time_col])
        Hb[:, r] = 0.0
        Hb[0, r] = t
        Hb[1, r] = 1.0

    def hist_of(own, ops):
        def hist(q, j0, j1):
            return (own if q < 0 else ops[q]).hist(bufs, j0, j1)
        return hist

    for name, (own, ops, alpha), _ in tape.rgroups:
        own.write(bufs, 0, _eval0(name, alpha, hist_of(own, ops), len(ops)))
    for k in range(1, K + 1):
        Hb[k, :n_eq] = tape.rhs_set.hist(bufs, k - 1, k)[0] / k
        for name, _, above in tape.rgroups:
            if above is not None:
                own, ops, alpha = above
                own.write(bufs, k, _eval_k(name, alpha, k,
                                           hist_of(own, ops), len(ops)))
    norms = torch.stack([tape.norm_set.hist(bufs, o, o + 1)[0].abs().amax(0)
                         for o in (K - 1, K, 0)])
    rows = Hb[:, :n_eq]
    if tape.out_set is not None:
        # the sv-func rows, read as every operand is: an alias through its
        # root and literals
        rows = torch.cat([rows, tape.out_set.hist(bufs, 0, K + 1)], 1)
    return rows.permute(1, 0, 2).contiguous(), norms


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def jet_rolled(tape: RolledTape, state, pars, t=None):
    """Taylor jet with the contract of :func:`jet_kernels.jet`, over the
    class buffers.  A CPU tensor runs :func:`jet_rolled_plain`; a CUDA
    tensor launches kernel B3 (``hy_jet_rolled_f64``) with the layout of
    :func:`block_layout`."""
    if _device_of(state, tape).type == "cpu":
        return jet_rolled_plain(tape, state, pars, t)
    return _jet_rolled_cuda(tape, state, pars, t)


def _launch_cfg(tape: RolledTape, B: int, dev, threads=None, layout=None):
    """``(threads, smem bytes, lane doubles, blocks, scratch or None)`` of
    one launch of kernel B3: :func:`block_threads`' and
    :func:`block_layout`'s, or the ``threads`` and ``layout`` given (the
    tests and ``chip_smoke.py`` hold every block size and layout to the
    twin).  On the global layout ``GLOBAL_SM_THREADS`` threads an SM, in
    blocks, walk over the lanes, each block with its region of the
    scratch."""
    nt = block_threads(tape) if threads is None else int(threads)
    if nt not in BLOCK_THREADS:
        raise ValueError(f"kernel B3 takes {BLOCK_THREADS} threads a block, "
                         f"not {nt}")
    own, per = block_layout(tape)
    layout = own if layout is None else layout
    if layout not in ("smem", "global"):
        raise ValueError(f"unknown layout {layout!r}")
    smem = smem_bytes(tape, layout, nt)
    if smem > SMEM_MAX:
        raise ValueError(f"a block of {smem} B exceeds the "
                         f"{SMEM_MAX} B of shared memory it may have")
    if layout == "smem":
        return nt, smem, per // 8, B, None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else B
    blocks = min(B, sms * (GLOBAL_SM_THREADS // nt))
    return nt, smem, per // 8, blocks, torch.empty(blocks * per // 8,
                                                    dtype=_F64, device=dev)


def trace_len(tape: RolledTape) -> int:
    """Clock readings of a traced launch: the start, after the seeds, after
    each level of order 0, after the state rows and each level that is not
    all aliases of each order k >= 1, and at the end."""
    it = tape.ritab.cpu().numpy()
    h = dict(zip(_RHDR, it[:len(_RHDR)].tolist()))
    lvlk = it[h["lvlk"]:h["lvlk"] + h["n_levels"] + 1]
    busy = int((np.diff(lvlk) > 0).sum())
    return 3 + h["n_levels"] + tape.order * (1 + busy)


def _jet_rolled_cuda(tape: RolledTape, state, pars, t=None, threads=None,
                     layout=None, trace=None):
    """Kernel B3 with ``threads`` threads a block on ``layout`` (default:
    :func:`_launch_cfg`'s); ``trace``, an int64 tensor of
    :func:`trace_len` on the card, takes the clock (``clock64``) after each
    barrier of block 0's first lane (``tools/rolled_scan.py``)."""
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
    nt, smem, lane_dbl, blocks, scratch = _launch_cfg(
        tape, B, dev, threads, layout)
    Vb = torch.empty((B, tape.sizes[2]), dtype=_F64, device=dev)
    lib = _build.load()
    rc = lib.hy_jet_rolled_f64(
        _ptr(tape.ritab), _ptr(tape.rdtab), _ptr(state), _ptr(pars),
        None if t is None or tape.time_col is None else _ptr(t),
        None if scratch is None else _ptr(scratch), _ptr(Vb), _ptr(out),
        _ptr(norms), None if trace is None else _ptr(trace), B, nt, smem,
        lane_dbl, blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"hy_jet_rolled_f64 launch failed: CUDA error {rc}")
    LAUNCHES["jet_rolled"] += 1
    return out, norms
