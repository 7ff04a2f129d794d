"""The Taylor jet of a dense trig series (kernel S1), its wrapper and its
plain torch twin.

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

- :func:`series_jet_plain`: the f64 torch twin, chunked over terms so
  that no ``(B, n_terms)`` tensor is held;
- :func:`series_jet`: the twin for a CPU tensor, kernel S1
  (``hy_series_jet_f64``, ``csrc/series_jet.cu``) for a CUDA tensor,
  ValueError otherwise;
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


def series_jet_plain(tab: SeriesTables, u0, u1, K: int,
                     with_scale: bool = False):
    """Plain twin of kernel S1: ``f (K+1, B)`` f64, the Taylor coefficients
    of the series at ``u = u0 + u1 t`` (``u0``, ``u1`` (B,) on the tables'
    device).  With ``with_scale`` it returns ``(f, scale)``, ``scale`` the
    sums of ``|a_j s_{m-j}|`` over the terms: the scale of each order that
    the checks hold S1 to."""
    _check_inputs(tab, u0, u1, K)
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


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

#: kernel S1's block: ``LANES`` lanes by ``SLICES`` term slices
#: (csrc/series_jet.cu ``kSerLanes``, ``kSerSlices``), the terms staged in
#: shared memory ``TILE`` at a time (``kSerTile``)
LANES, SLICES, TILE = 32, 4, 256
THREADS = LANES * SLICES
#: the blocks a launch aims at (four an SM of an H100), and the fewest
#: terms a thread of a chunk walks
TARGET_BLOCKS, MIN_TERMS = 4 * 132, 16
#: the most phase (d+1) and amplitude (q+1) coefficients a term, in S1's
#: widest instance
MAX_COEFS = 8
SMEM_MAX = 232448


class SeriesShape(NamedTuple):
    """A launch of kernel S1: ``chunks`` blocks of terms (``per`` terms
    each) over ``ceil(B / LANES)`` lane tiles, ``smem`` bytes of dynamic
    shared memory a block."""
    chunks: int
    per: int
    smem: int


def launch_shape(n: int, q: int, d: int, B: int, K: int,
                 sms: int = 132) -> SeriesShape:
    """The grid of kernel S1 on ``n`` terms and ``B`` lanes: as many term
    chunks as bring the launch to ``TARGET_BLOCKS`` blocks (scaled to the
    card's SMs), each chunk ``MIN_TERMS`` a thread at least.  The partial
    sums of the chunks are added in a second pass, in chunk order."""
    if d + 1 > MAX_COEFS or q + 1 > MAX_COEFS:
        raise ValueError(f"kernel S1 takes up to {MAX_COEFS} phase and "
                         f"amplitude coefficients a term; got d={d}, q={q}")
    tiles = -(-B // LANES)
    target = TARGET_BLOCKS * sms // 132
    chunks = max(1, min(-(-target // tiles), -(-n // (SLICES * MIN_TERMS))))
    per = -(-n // chunks)
    chunks = -(-n // per)
    smem = 8 * ((K + 1) * THREADS + (K + 1) + TILE * (q + 1 + d + 1))
    if smem > SMEM_MAX:
        raise ValueError(f"order {K} needs {smem} B of shared memory a "
                         f"block of kernel S1, over {SMEM_MAX}")
    return SeriesShape(chunks, per, smem)


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


def series_jet(tab: SeriesTables, u0, u1, K: int):
    """Orders ``0..K`` of the series at ``u = u0 + u1 t``, ``(K+1, B)``
    f64: :func:`series_jet_plain` for CPU tensors, kernel S1 for CUDA
    ones."""
    dev = tab.amp.device
    if dev.type == "cpu":
        return series_jet_plain(tab, u0, u1, K)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _series_cuda(tab, u0, u1, K)


def _series_cuda(tab: SeriesTables, u0, u1, K: int):
    """Kernel S1 (``hy_series_jet_f64``): one launch (two passes where the
    terms are split into chunks), counted in ``LAUNCHES["series"]``."""
    _check_inputs(tab, u0, u1, K)
    B = u0.shape[0]
    out = u0.new_empty((K + 1, B))
    if B == 0:
        return out
    if tab.n == 0:
        return out.zero_()
    sh = launch_shape(tab.n, tab.q, tab.d, B, K, _sms(u0.device))
    part = u0.new_empty((sh.chunks, K + 1, B)) if sh.chunks > 1 else None
    rc = _build.load().hy_series_jet_f64(
        _ptr(tab.amp), _ptr(tab.ph), _ptr(u0), _ptr(u1), _ptr(out),
        None if part is None else _ptr(part), tab.n, tab.q + 1, tab.d + 1,
        B, K, sh.per, sh.chunks, sh.smem,
        torch.cuda.current_stream(u0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hy_series_jet_f64 launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["series"] += 1
    return out


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def series_value(name: str, u):
    """The value of series op ``name`` at ``u`` (an f64 tensor of any
    shape, on the CPU or a CUDA device): order 0 of :func:`series_jet` at
    the flattened points, reshaped.  On the card kernel S1 walks the terms
    for every point in one launch; the twin goes by chunks of terms."""
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
