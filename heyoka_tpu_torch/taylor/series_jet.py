"""The Taylor jet of dense trig series (kernel S1, entries S1-L and S1-G),
its wrappers and its plain torch twin.

A series op (``expr/series.py``) is ``f(u) = sum_i a_i(u) sin(P_i(u))``
over dense tables ``amp (n, q+1)`` and ``ph (n, d+1)``.  Its input is
affine in time, ``u = u0 + u1 t``, so the Taylor coefficients of ``f`` in
t have a closed form per term:

- the shifted tables ``p_j = sum_{r>=j} C(r,j) ph_r u0^(r-j) u1^j`` (and
  ``a_j`` alike): a Taylor shift by ``u0`` (synthetic division, whose
  first pass is Horner's rule, the JAX evaluator's order of operations),
  then a scale by ``u1^j``;
- ``s_0 = sin p_0``, ``c_0 = cos p_0``;
- ``s_m = (1/m) sum_{j=1..min(m,d)} j p_j c_{m-j}``,
  ``c_m = -(1/m) sum_j j p_j s_{m-j}``;
- ``f_m = sum_{j<=min(m,q)} a_j s_{m-j}``, summed over the terms.

This is what ``_series_jet`` computes in the JAX package
(``heyoka_tpu/expr/series.py:427-507``, a ``lax.scan`` over orders in
XLA, not a Pallas kernel) without its TPU workarounds (the f32 tail, the
power-of-two step scale).  The outputs are plain Taylor coefficients in
t, the phase buffer's convention (``jet_phase``).

The port splits each series' terms, in table order, into two classes
(:func:`split_of`; only the device layout: the op, its key and
``series.tables`` stay as they are):

- **class L**, a constant amplitude and a linear phase (``amp[:, 1:] ==
  0``, ``ph[:, 2:] == 0``), whose weights ``a w^m`` (``w = ph_1``) stay
  in f64's normal range for every order up to K: there ``s_m = (w u1)^m /
  m! sin(p_0 + m pi/2)``, so the class's orders are two matrix products,
  ``F_m = (u1^m / m!) sum_t W[m, t] X[t, lane]``, ``W[m, t] = +-a_t
  w_t^m`` (the sign of ``sin(x + m pi/2)`` folded in), ``X = sin p_0``
  for even m and ``cos p_0`` for odd m (:func:`_closed_form`; kernel S1-L
  ``hy_series_lin_f64`` on the FP64 tensor cores).  Every VSOP2013 term
  and 93% of the ELP2000's are in it;
- **class G**, the rest: the recurrence above (:func:`_recurrence`;
  kernel S1-G ``hy_series_gen_f64``).

- :func:`series_jet_plain`: the f64 torch twin, the two classes' sums
  added, chunked over terms so that no ``(B, n_terms)`` tensor is held;
- :class:`SeriesWork`: the series of a step as one work list of
  (series, class, term chunk) items; :func:`series_jets` runs it, the
  twin on CPU tensors, kernel S1 on CUDA ones (S1-L and S1-G once each,
  the one launched last adding each series' partial sums in a fixed
  order), ValueError otherwise;
- :func:`series_jet`: one series through :func:`series_jets`;
- :func:`series_value`: order 0 at any points (the compiled functions'
  and ``expr.numeric``'s rule);
- :class:`AffineInput`: ``u1`` of a series column before the jet.  Kernel
  B4 computes order 1 of the input's column in the same launch that needs
  the series rows, so ``u1 = du/dt`` is split off symbolically when the
  tape is built (``expr/diff.py``) and evaluated over the lanes'
  parameters with the order-0 rules; ``u0`` is the input column's order 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..convert import OPCODES, SERIES
from .jet_kernels import LAUNCHES, _F64, _ptr

#: elements of the twin's per-chunk ``(terms, lanes)`` tensors
CHUNK_ELEMS = 1 << 21

#: kernel S1's C entries (class L, class G), each counted in
#: ``LAUNCHES[COUNTERS[entry]]``; ``engine_report()["series"]`` on the card
ENTRIES = ("hy_series_lin_f64", "hy_series_gen_f64")
COUNTERS = {"hy_series_lin_f64": "series_lin",
            "hy_series_gen_f64": "series_gen"}
REPORT = "+".join(ENTRIES)

# ---------------------------------------------------------------------------
# the tables on a device
# ---------------------------------------------------------------------------


class SeriesTables(NamedTuple):
    """One series' tables on a device: ``amp (n, q+1)``, ``ph (n, d+1)``
    (contiguous f64), ``q`` and ``d`` the degrees."""
    name: str
    amp: torch.Tensor
    ph: torch.Tensor
    q: int
    d: int

    @property
    def n(self) -> int:
        return self.amp.shape[0]


_ON_DEVICE: dict = {}


def tables_on(name: str, device) -> SeriesTables:
    """The tables of series op ``name`` on ``device``, copied there once."""
    from ..expr import series

    dev = torch.device(device)
    key = (name, str(dev))
    tab = _ON_DEVICE.get(key)
    if tab is None:
        amp, ph = series.tables(name)
        tab = SeriesTables(
            name, torch.as_tensor(amp, dtype=_F64, device=dev).contiguous(),
            torch.as_tensor(ph, dtype=_F64, device=dev).contiguous(),
            amp.shape[1] - 1, ph.shape[1] - 1)
        _ON_DEVICE[key] = tab
    return tab


# ---------------------------------------------------------------------------
# the two classes of terms
# ---------------------------------------------------------------------------

#: the most order kernel S1-L takes (two row tiles of 16 orders a parity);
#: above it every term is in class G
LIN_MAX_ORDER = 63
#: the exponents of f64's normal range with a margin of one for rounding:
#: a class-L weight ``|a w^m|`` stays within ``2^LOG2_MIN..2^LOG2_MAX``
LOG2_MIN, LOG2_MAX = -1021.0, 1023.0


def lin_mask(amp: np.ndarray, ph: np.ndarray, K: int) -> np.ndarray:
    """The class-L terms of tables ``amp (n, q+1)``, ``ph (n, d+1)`` at
    order ``K``: a constant amplitude, a linear phase, and every weight
    ``a w^m`` (m = 0..K, ``w = ph[:, 1]``) zero or in f64's normal range;
    none above ``LIN_MAX_ORDER``.  ``w = 0`` is exact: its weights are
    ``a`` at m = 0 and 0 above."""
    n = amp.shape[0]
    if K > LIN_MAX_ORDER:
        return np.zeros(n, bool)
    shape = (amp[:, 1:] == 0).all(1) & (ph[:, 2:] == 0).all(1)
    a = amp[:, 0]
    w = ph[:, 1] if ph.shape[1] > 1 else np.zeros(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        la, lw = np.log2(np.abs(a)), np.log2(np.abs(w))
        top = la + K * lw  # the weight's exponent at m = K (m = 0: la)
    ok_a = (la >= LOG2_MIN) & (la <= LOG2_MAX)
    ok_w = (w == 0) | ((np.minimum(la, top) >= LOG2_MIN)
                       & (np.maximum(la, top) <= LOG2_MAX))
    return shape & ((a == 0) | (ok_a & ok_w))


def lin_weights(a: np.ndarray, w: np.ndarray, K: int) -> np.ndarray:
    """The signed class-L weights ``W (K+1, n)``: ``a w^m`` by repeated
    multiplication, negated where ``m % 4`` is 2 or 3 (``sin(x + m pi/2)
    = sin x, cos x, -sin x, -cos x``)."""
    W = np.empty((K + 1, a.size))
    p = a.astype(np.float64).copy()
    for m in range(K + 1):
        W[m] = -p if m % 4 >= 2 else p
        p = p * w
    return W


class SeriesSplit(NamedTuple):
    """One series' terms at an order K on a device, by class (each in
    table order): ``lin``/``gen`` the table rows of classes L and G;
    class L as ``W (K+1, n_L)`` (:func:`lin_weights`), ``ph0``, ``ph1``
    ``(n_L,)``; class G as the tables of its rows, ``gen_tab``."""
    name: str
    lin: np.ndarray
    gen: np.ndarray
    W: torch.Tensor
    ph0: torch.Tensor
    ph1: torch.Tensor
    gen_tab: SeriesTables


_SPLITS: dict = {}


def split_of(tab: SeriesTables, K: int) -> SeriesSplit:
    """The class split of ``tab`` at order ``K`` (:func:`lin_mask`), on
    the tables' device, made once per (series, K, device)."""
    key = (tab.name, K, str(tab.amp.device))
    sp = _SPLITS.get(key)
    if sp is None:
        amp, ph = tab.amp.cpu().numpy(), tab.ph.cpu().numpy()
        mask = lin_mask(amp, ph, K)
        lin, gen = np.flatnonzero(mask), np.flatnonzero(~mask)
        w = ph[lin, 1] if ph.shape[1] > 1 else np.zeros(lin.size)
        dev = tab.amp.device

        def on(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=_F64,
                                   device=dev)
        sp = SeriesSplit(
            tab.name, lin, gen, on(lin_weights(amp[lin, 0], w, K)),
            on(ph[lin, 0]), on(w),
            SeriesTables(tab.name, on(amp[gen]), on(ph[gen]), tab.q, tab.d))
        _SPLITS[key] = sp
    return sp


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _shifted(tab, u0, u1):
    """``tab (c, m+1)`` shifted by ``u0 (B,)`` and scaled by ``u1 (B,)``:
    the ``m+1`` coefficients of ``T(u0 + u1 x)``, each ``(c, B)``, in the
    kernel's order of operations."""
    m = tab.shape[1] - 1
    b = [tab[:, r:r + 1] + 0.0 * u0 for r in range(m + 1)]
    for i in range(m):
        for r in range(m - 1, i - 1, -1):
            b[r] = b[r] + u0 * b[r + 1]
    up = u1
    for j in range(1, m + 1):
        b[j] = b[j] * up
        up = up * u1
    return b


def _recurrence(tab: SeriesTables, u0, u1, K: int, with_scale=False):
    """Orders ``0..K`` of the terms of ``tab`` by the recurrence (class G's
    rule; any term): ``f (K+1, B)``, with ``with_scale`` also the sums of
    ``|a_j s_{m-j}|`` over the terms."""
    B = u0.shape[0]
    out = u0.new_zeros((K + 1, B))
    mag = u0.new_zeros((K + 1, B)) if with_scale else None
    d, q = tab.d, tab.q
    step = max(1, CHUNK_ELEMS // max(B, 1))
    for i0 in range(0, tab.n, step):
        p = _shifted(tab.ph[i0:i0 + step], u0, u1)
        a = _shifted(tab.amp[i0:i0 + step], u0, u1)
        jp = [None] + [j * p[j] for j in range(1, d + 1)]
        s, c = [torch.sin(p[0])], [torch.cos(p[0])]

        def acc(m):
            v = w = None
            for j in range(min(m, q) + 1):
                t = a[j] * s[m - j]
                v = t if v is None else v + t
                if with_scale:
                    w = t.abs() if w is None else w + t.abs()
            out[m] += v.sum(0)
            if with_scale:
                mag[m] += w.sum(0)

        acc(0)
        for m in range(1, K + 1):
            ss = cc = None
            for j in range(1, min(m, d) + 1):
                ts, tc = jp[j] * c[m - j], jp[j] * s[m - j]
                ss = ts if ss is None else ss + ts
                cc = tc if cc is None else cc + tc
            if ss is None:  # a constant phase
                ss = cc = torch.zeros_like(p[0])
            s.append(ss / m)
            c.append(-(cc / m))
            acc(m)
            # the windows: s back to max(d, q) orders, c back to d
            if m >= max(d, q):
                s[m - max(d, q)] = None
            if m >= d:
                c[m - d] = None
    return (out, mag) if with_scale else out


def _closed_form(sp: SeriesSplit, u0, u1, K: int, with_scale=False):
    """Orders ``0..K`` of the class-L terms of ``sp`` by the closed form
    (kernel S1-L's arithmetic): per chunk of terms ``p_0 = ph0 + u0 ph1``
    (no fma), its sin and cos, and the products ``W[even] @ sin``,
    ``W[odd] @ cos``; then order m times ``u1^m / m!`` (``sc_m = sc_{m-1}
    u1 / m``).  With ``with_scale`` also the sums of ``|a p1^m / m! sin(p_0
    + m pi/2)|`` over the terms."""
    B = u0.shape[0]
    out = u0.new_zeros((K + 1, B))
    mag = u0.new_zeros((K + 1, B)) if with_scale else None
    step = max(1, CHUNK_ELEMS // max(B, 1))
    for i0 in range(0, sp.ph0.shape[0], step):
        p0 = sp.ph0[i0:i0 + step, None] + u0 * sp.ph1[i0:i0 + step, None]
        for par, x in ((0, torch.sin(p0)), (1, torch.cos(p0))):
            w = sp.W[par::2, i0:i0 + step]
            if w.shape[0]:
                out[par::2] += w @ x
                if with_scale:
                    mag[par::2] += w.abs() @ x.abs()
    sc = torch.ones_like(u0)
    for m in range(1, K + 1):
        sc = sc * u1 / m
        out[m] *= sc
        if with_scale:
            mag[m] *= sc.abs()
    return (out, mag) if with_scale else out


def series_jet_plain(tab: SeriesTables, u0, u1, K: int,
                     with_scale: bool = False):
    """Plain twin of kernel S1: ``f (K+1, B)`` f64, the Taylor coefficients
    of the series at ``u = u0 + u1 t`` (``u0``, ``u1`` (B,) on the tables'
    device): class L's closed form plus class G's recurrence
    (:func:`split_of`).  With ``with_scale`` it returns ``(f, scale)``,
    ``scale`` the sums of the terms' magnitudes (``|a_j s_{m-j}|``) per
    order: the scale of each order that the checks hold S1 to."""
    _check_inputs(tab, u0, u1, K)
    sp = split_of(tab, K)
    lin = _closed_form(sp, u0, u1, K, with_scale)
    gen = _recurrence(sp.gen_tab, u0, u1, K, with_scale)
    if not with_scale:
        return lin + gen
    return lin[0] + gen[0], lin[1] + gen[1]


# ---------------------------------------------------------------------------
# the work list of a step
# ---------------------------------------------------------------------------

#: kernel S1-L (csrc/series_jet.cu): a tile of ``LIN_TERMS`` terms (the
#: product's k), ``LIN_WARPS`` warps a block, ``LIN_STAGE`` tiles a stage
#: of the ring; a warp holds ``32 / mt`` lanes, mt the row tiles of 16
#: orders a parity
LIN_TERMS, LIN_WARPS, LIN_STAGE = 16, 4, 4
#: kernel S1-G: ``GEN_LANES`` lanes by ``GEN_SLICES`` term slices a block,
#: ``GEN_STAGE`` terms a stage, ``GEN_ORDERS`` orders summed in registers
#: at once
GEN_LANES, GEN_SLICES, GEN_STAGE, GEN_ORDERS = 32, 4, 128, 21
GEN_THREADS = GEN_LANES * GEN_SLICES
#: the blocks a launch aims at (four an SM of an H100), and the fewest
#: tiles (S1-L) or terms (S1-G) an item takes
TARGET_BLOCKS, LIN_MIN_TILES, GEN_MIN_TERMS = 4 * 132, 4, 64
#: the most phase (d+1) and amplitude (q+1) coefficients a term, in S1-G's
#: widest instance
MAX_COEFS = 8
SMEM_MAX = 232448


def lin_row_tiles(K: int) -> int:
    """Row tiles of 16 orders a parity that kernel S1-L needs at ``K``."""
    return 1 if K < 32 else 2


def lin_tile_doubles(mt: int) -> int:
    """Doubles of one packed class-L tile (``csrc/series_jet.cu``
    ``lin_tile_doubles``)."""
    return 2 * LIN_TERMS + 2 * mt * 256


def lin_lanes(mt: int) -> int:
    """Lanes of one block of kernel S1-L."""
    return LIN_WARPS * 32 // mt


def lin_smem(mt: int) -> int:
    """Dynamic shared memory of a block of kernel S1-L: the ring of two
    stages, or the epilogue's ``(32 mt, 32 / mt)`` orders by lanes a
    warp, whichever is larger."""
    return 8 * max(2 * LIN_STAGE * lin_tile_doubles(mt), LIN_WARPS * 1024)


def gen_row_doubles(q: int, d: int) -> int:
    """Doubles of one packed class-G row: ``amp | ph``, padded to 16 B."""
    return -(-(q + 1 + d + 1) // 2) * 2


def gen_ring(rw: int) -> int:
    """Doubles of kernel S1-G's ring at rows of ``rw`` doubles: two
    stages, and at least the slices' sums of a window."""
    return max(2 * GEN_STAGE * rw, GEN_ORDERS * GEN_THREADS)


def pack_lin(sp: SeriesSplit, mt: int) -> np.ndarray:
    """Class L of ``sp`` as kernel S1-L's tiles, ``(tiles, lin_tile_doubles
    (mt))``, the terms zero-padded to a whole tile: ``ph0[16]``,
    ``ph1[16]``, then the A fragments of ``W``'s even and odd orders
    (``16 mt`` rows each, zero-padded), ``[parity][row tile][j][thread]
    [2]``: thread l's elements ``2j, 2j+1`` of the m16n8k16 fragment,
    element i at row ``l // 4 + 8 (i % 2)``, term ``l % 4 + 4 (i // 2)``."""
    W, n = sp.W.cpu().numpy(), sp.ph0.shape[0]
    nt = -(-n // LIN_TERMS)
    rows = 16 * mt
    out = np.zeros((nt, lin_tile_doubles(mt)))
    for j, x in enumerate((sp.ph0, sp.ph1)):
        v = np.zeros(nt * LIN_TERMS)
        v[:n] = x.cpu().numpy()
        out[:, LIN_TERMS * j:LIN_TERMS * (j + 1)] = v.reshape(nt, LIN_TERMS)
    lane, el = np.arange(32)[:, None], np.arange(8)[None, :]
    row = lane // 4 + 8 * (el % 2)
    term = lane % 4 + 4 * (el // 2)
    for par in range(2):
        Wp = np.zeros((rows, nt * LIN_TERMS))
        w = W[par::2]
        Wp[:w.shape[0], :n] = w
        Wp = Wp.reshape(rows, nt, LIN_TERMS)
        for mt_ in range(mt):
            frag = Wp[16 * mt_ + row, :, term]  # (32, 8, nt)
            frag = frag.transpose(2, 0, 1).reshape(nt, 32, 4, 2)
            o = 2 * LIN_TERMS + (par * mt + mt_) * 256
            out[:, o:o + 256] = frag.transpose(0, 2, 1, 3).reshape(nt, 256)
    return out


def pack_gen(sp: SeriesSplit) -> np.ndarray:
    """Class G of ``sp`` as kernel S1-G's rows, ``(n_G, rw)``: ``amp |
    ph | 0`` (:func:`gen_row_doubles`)."""
    g = sp.gen_tab
    out = np.zeros((g.n, gen_row_doubles(g.q, g.d)))
    out[:, :g.q + 1] = g.amp.cpu().numpy()
    out[:, g.q + 1:g.q + g.d + 2] = g.ph.cpu().numpy()
    return out


def per_item(units: int, X: int, least: int, sms: int = 132) -> int:
    """Units (tiles or terms) an item takes: as many items over all the
    series' ``units`` as bring ``X`` blocks of lanes to ``TARGET_BLOCKS``
    blocks (scaled to the card's SMs), ``least`` units at least."""
    want = max(1, -(-(TARGET_BLOCKS * sms // 132) // X))
    return max(least, -(-units // want))


class WorkList(NamedTuple):
    """The items of one launch of kernel S1 on ``B`` lanes: ``lin``
    ``(n, 4)`` int32 (series, first tile, tiles, slot) and ``gen`` ``(n,
    8)`` (series, first double, terms, q+1, d+1, rw, slot, 0); ``sstart``
    ``(n_ser + 1,)``: the slots of series i are ``sstart[i] ..
    sstart[i+1]-1``, its class-L chunks first, in term order."""
    lin: np.ndarray
    gen: np.ndarray
    sstart: np.ndarray

    @property
    def n_slots(self) -> int:
        return int(self.sstart[-1])


class SeriesWork:
    """The series ``tabs`` of one step at order ``K`` as one work list for
    kernel S1 (:meth:`items`): the class-L tiles of every series in one
    buffer, its class-G rows in another, each series' items in term
    order."""

    def __init__(self, tabs, K: int):
        self.tabs, self.K = tuple(tabs), int(K)
        self.device = tabs[0].amp.device
        self.splits = [split_of(t, self.K) for t in self.tabs]
        self.mt = lin_row_tiles(self.K)
        self.lin_tiles = [-(-sp.ph0.shape[0] // LIN_TERMS)
                          for sp in self.splits]
        self.gen_n = [sp.gen_tab.n for sp in self.splits]
        self.rw = [gen_row_doubles(t.q, t.d) for t in self.tabs]
        self._lists, self._dst, self._packs = {}, {}, None

    def items(self, B: int, which: str = "both", sms: int = 132
              ) -> WorkList:
        """The items on ``B`` lanes, of class L and G (``which="both"``,
        the step) or of one class (``"lin"``, ``"gen"``: each entry held
        alone against its twin)."""
        if which not in ("both", "lin", "gen"):
            raise ValueError(f"unknown class {which!r}")
        X_l = -(-B // lin_lanes(self.mt))
        X_g = -(-B // GEN_LANES)
        per_l = per_item(sum(self.lin_tiles), X_l, LIN_MIN_TILES, sms)
        per_g = per_item(sum(self.gen_n), X_g, GEN_MIN_TERMS, sms)
        lin, gen, sstart = [], [], [0]
        tile0 = off = 0
        for i, (tab, nt, ng, rw) in enumerate(zip(
                self.tabs, self.lin_tiles, self.gen_n, self.rw)):
            slot = sstart[-1]
            if which != "gen":
                for c in range(0, nt, per_l):
                    lin.append((i, tile0 + c, min(per_l, nt - c), slot))
                    slot += 1
            if which != "lin":
                for c in range(0, ng, per_g):
                    gen.append((i, off + c * rw, min(per_g, ng - c),
                                tab.q + 1, tab.d + 1, rw, slot, 0))
                    slot += 1
            tile0 += nt
            off += ng * rw
            sstart.append(slot)
        return WorkList(np.array(lin, np.int32).reshape(-1, 4),
                        np.array(gen, np.int32).reshape(-1, 8),
                        np.array(sstart, np.int32))

    def packs(self):
        """The class-L tiles and the class-G rows of every series on the
        device, built once."""
        if self._packs is None:
            self._packs = tuple(
                torch.as_tensor(np.concatenate([pack(sp).reshape(-1)
                                                for sp in self.splits]),
                                dtype=_F64, device=self.device)
                for pack in (lambda sp: pack_lin(sp, self.mt), pack_gen))
        return self._packs

    def launch_items(self, B: int, which: str, sms: int):
        """:meth:`items` as int32 tensors on the device (None for an
        empty class), cached."""
        key = (B, which, sms)
        got = self._lists.get(key)
        if got is None:
            wl = self.items(B, which, sms)

            def on(x):
                return torch.as_tensor(x, device=self.device) \
                    if x.size else None
            got = (wl, on(wl.lin), on(wl.gen), on(wl.sstart))
            self._lists[key] = got
        return got

    def dst(self, rows) -> torch.Tensor:
        key = tuple(int(r) for r in rows)
        t = self._dst.get(key)
        if t is None:
            t = torch.as_tensor(np.array(key, np.int32), device=self.device)
            self._dst[key] = t
        return t


_WORKS: dict = {}


def work_of(tabs, K: int) -> SeriesWork:
    """The :class:`SeriesWork` of ``tabs`` at order ``K``, made once per
    (series, K, device)."""
    key = (tuple(t.name for t in tabs), int(K), str(tabs[0].amp.device))
    w = _WORKS.get(key)
    if w is None:
        w = _WORKS[key] = SeriesWork(tabs, K)
    return w


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(tab, u0, u1, K):
    dev = tab.amp.device
    if K < 0:
        raise ValueError(f"order must be >= 0; got {K}")
    for name, x in (("u0", u0), ("u1", u1)):
        if x.device != dev or x.dtype != _F64 or x.ndim != 1 \
                or x.shape != u0.shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected a contiguous f64 (B,) tensor on {dev}; "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def series_jets(work: SeriesWork, U0, U1, out, rows):
    """Orders ``0..K`` of every series ``i`` of ``work`` at ``u = U0[i] +
    U1[i] t`` (``U0``, ``U1`` contiguous f64 ``(n_ser, B)``) into row
    ``rows[i]`` of ``out (K+1, R, B)`` (contiguous f64); returns ``out``.
    CPU tensors run :func:`series_jet_plain` a series; CUDA tensors launch
    kernel S1 (:func:`_series_cuda`)."""
    n, K = len(work.tabs), work.K
    B = U0.shape[-1] if U0.ndim == 2 else -1
    dev = work.device
    for name, x in (("U0", U0), ("U1", U1)):
        if x.device != dev or x.dtype != _F64 or tuple(x.shape) != (n, B) \
                or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous f64 ({n}, B) "
                             f"tensor on {dev}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if out.device != dev or out.dtype != _F64 or out.ndim != 3 \
            or out.shape[0] != K + 1 or out.shape[2] != B \
            or not out.is_contiguous() or len(rows) != n:
        raise ValueError(f"out: expected a contiguous f64 ({K + 1}, R, {B}) "
                         f"tensor on {dev} and {n} rows")
    if dev.type == "cpu":
        for i, (tab, r) in enumerate(zip(work.tabs, rows)):
            out[:, r] = series_jet_plain(tab, U0[i], U1[i], K)
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _series_cuda(work, U0, U1, out, rows)


def _series_cuda(work: SeriesWork, U0, U1, out, rows, which="both"):
    """Kernel S1 on the work list: ``hy_series_lin_f64`` over the class-L
    items and ``hy_series_gen_f64`` over the class-G ones, each launched
    once where it has items and counted in ``LAUNCHES["series_lin"]`` /
    ``["series_gen"]``; the one launched last adds each series' partial
    sums in slot order into ``out``.  ``which``: ``"lin"`` or ``"gen"``
    runs one class alone (its twin is :func:`_closed_form` or
    :func:`_recurrence`)."""
    K, B = work.K, U0.shape[1]
    if B == 0:
        return out
    for t in work.tabs:
        if t.d + 1 > MAX_COEFS or t.q + 1 > MAX_COEFS:
            raise ValueError(
                f"kernel S1 takes up to {MAX_COEFS} phase and amplitude "
                f"coefficients a term; got d={t.d}, q={t.q}")
    dev = U0.device
    wl, lin, gen, sstart = work.launch_items(B, which, _sms(dev))
    dst = work.dst(rows)
    if lin is None and gen is None:  # no terms
        out[:, list(rows)] = 0.0
        return out
    lin_pack, gen_pack = work.packs()
    part = U0.new_empty((wl.n_slots, K + 1, B))
    stream = torch.cuda.current_stream(dev).cuda_stream
    red = (_ptr(sstart), _ptr(dst), _ptr(out), len(work.tabs), out.shape[1])
    lib = _build.load()
    if lin is not None:
        mt = work.mt
        smem = lin_smem(mt)
        rc = lib.hy_series_lin_f64(
            _ptr(lin_pack), _ptr(lin), wl.lin.shape[0], _ptr(U0), _ptr(U1),
            _ptr(part), B, K, mt, smem,
            *(red if gen is None else (None, None, None, 0, 0)), stream)
        _raise(rc, "hy_series_lin_f64")
    if gen is not None:
        ring = gen_ring(max(work.rw))
        smem = 8 * (ring + K + 1)
        if smem > SMEM_MAX:
            raise ValueError(f"order {K} needs {smem} B of shared memory a "
                             f"block of kernel S1-G, over {SMEM_MAX}")
        rc = lib.hy_series_gen_f64(
            _ptr(gen_pack), _ptr(gen), wl.gen.shape[0], _ptr(U0), _ptr(U1),
            _ptr(part), B, K, ring, smem, *red, stream)
        _raise(rc, "hy_series_gen_f64")
    return out


def _raise(rc, entry):
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[COUNTERS[entry]] += 1


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def series_jet(tab: SeriesTables, u0, u1, K: int):
    """Orders ``0..K`` of the series at ``u = u0 + u1 t``, ``(K+1, B)``
    f64: :func:`series_jet_plain` for CPU tensors, kernel S1 (a one-series
    :func:`series_jets`) for CUDA ones."""
    dev = tab.amp.device
    if dev.type == "cpu":
        return series_jet_plain(tab, u0, u1, K)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_inputs(tab, u0, u1, K)
    out = u0.new_empty((K + 1, 1, u0.shape[0]))
    _series_cuda(work_of((tab,), K), u0[None], u1[None], out, (0,))
    return out[:, 0]


def series_value(name: str, u):
    """The value of series op ``name`` at ``u`` (an f64 tensor of any
    shape, on the CPU or a CUDA device): order 0 of :func:`series_jet` at
    the flattened points, reshaped.  On the card kernel S1 walks the terms
    for every point in one launch of each entry; the twin goes by chunks
    of terms."""
    if not isinstance(u, torch.Tensor):
        u = torch.as_tensor(u, dtype=_F64)
    u = u.to(_F64)
    tab = tables_on(name, u.device)
    flat = u.reshape(-1).contiguous()
    return series_jet(tab, flat, torch.zeros_like(flat), 0)[0].reshape(
        u.shape)


# ---------------------------------------------------------------------------
# the affine input
# ---------------------------------------------------------------------------

def column_expr(a: dict, col: int, names: list, memo=None):
    """The expression of column ``col`` of plan arrays ``a`` (an op column
    rebuilt from its opcode and operands; a state column a variable
    ``x<i>``; the virtual columns a number, a parameter, the time).
    ``names``: the op name of each series row (``convert.series_names``)."""
    from ..expr import core
    from ..expr.math import sqrt
    from ..expr.numeric import EVAL_ARITY

    memo = {} if memo is None else memo
    if col in memo:
        return memo[col]
    n_eq, time_col = int(a["meta"][1]), int(a["meta"][3])
    n_w = n_eq + a["arg_ptr"].size - 1
    if col < n_eq:
        e = core.Variable(f"x{col}")
    elif col == time_col:
        e = core.time
    elif col >= n_w:
        hit = np.flatnonzero(a["const_cols"] == col)
        if hit.size:
            e = core.Number(float(a["const_vals"][hit[0]]))
        else:
            j = np.flatnonzero(a["par_cols"] == col)[0]
            e = core.Param(int(a["par_idx"][j]))
    else:
        o = col - n_eq
        g = np.flatnonzero((a["g_start"] <= col)
                           & (col < a["g_start"] + a["g_m"]))[0]
        name = OPCODES[int(a["g_op"][g])]
        args = [column_expr(a, int(c), names, memo) for c in
                a["args"][a["arg_ptr"][o]:a["arg_ptr"][o + 1]]]
        if name == "sum":
            e = core.sum_expr(args)
        elif name == "mul":
            e = args[0] * args[1]
        elif name == "div":
            e = args[0] / args[1]
        elif name == "pow":
            e = args[0] ** float(a["alpha"][o])
        elif name == "sqrt":
            e = sqrt(args[0])
        elif name == SERIES:
            e = core.Func(names[int(a["ser"][o])], (args[0],))
        else:
            e = core.Func(name, tuple(args[:EVAL_ARITY.get(name,
                                                           len(args))]))
    memo[col] = e
    return e


class AffineInput:
    """The input ``u = c0 + c1 t`` of the series column ``col`` of plan
    arrays ``a``: ``c1 = du/dt`` from ``expr.diff``; raises ValueError
    where ``u`` depends on the state or ``c1`` on the time (the closed-form
    jet needs ``u_k = 0`` for k >= 2)."""

    def __init__(self, a: dict, col: int, names: list):
        from ..expr.core import Number, get_variables, is_time_dependent, time
        from ..expr.decompose import function_decompose
        from ..expr.diff import diff

        n_eq = int(a["meta"][1])
        o = col - n_eq
        self.in_col = int(a["args"][a["arg_ptr"][o]])
        u = column_expr(a, self.in_col, names)
        what = f"the input of series column {col} ({u!r})"
        if get_variables(u):
            raise ValueError(f"{what} depends on the state: a series op's "
                             "input must be affine in time")
        try:
            c1 = diff(u, time)
        except NotImplementedError as err:
            raise ValueError(f"{what}: {err}") from None
        if is_time_dependent(c1):
            raise ValueError(f"{what} is not affine in time: du/dt = "
                             f"{c1!r}")
        self.c1 = c1
        self.const = float(c1.value) if isinstance(c1, Number) else None
        if self.const is None:
            self.tape = function_decompose([c1], [])
            cols = {int(j): int(c) for c, j in zip(a["par_cols"],
                                                   a["par_idx"])}
            self.par_cols = [cols.get(j, -1)
                             for j in range(self.tape.n_pars)]

    def u1(self, tc):
        """``c1`` on every lane of the ``(K+1, W, B)`` buffer ``tc`` whose
        order-0 parameter columns are set: ``(B,)`` f64."""
        B = tc.shape[-1]
        if self.const is not None:
            return tc.new_full((B,), self.const)
        from ..cfunc import tape_eval

        pars = tc.new_zeros((B, len(self.par_cols)))
        for j, c in enumerate(self.par_cols):
            if c >= 0:
                pars[:, j] = tc[0, c]
        v = tape_eval(self.tape, tc.new_zeros((B, 0)), pars,
                      tc.new_zeros(B))[0]
        return (v * tc.new_ones(B)).contiguous()
