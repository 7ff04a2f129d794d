"""Continuous output: the whole propagation's Taylor polynomials, evaluated
anywhere inside it.

The counterpart of ``heyoka_tpu/taylor/continuous.py`` (reference: heyoka
``continuous_output[_batch]``, ``include/heyoka/continuous_output.hpp:
49-204``): ``propagate_until(..., c_output=True)`` records every step's
Taylor coefficients and (hi, lo) start time, and the objects below find a
query's step by binary search and evaluate it by Horner.

The JAX recorder is a ring of steps re-entered until the target, since XLA
needs static shapes; here the per-step driver (``compact_flat._pu_while``)
keeps each step's whole-batch coefficients on the device and one stack at
the end builds the JAX layout: per lane, the steps padded to the longest
lane, the step boundaries padded with +-inf in the direction of travel.
Evaluation runs on the device of the records (``torch.searchsorted``
over every lane at once).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import DTYPES, numpy_dtype, resolve_device
from .compact_flat import make_propagate_until_flat
from .jet_kernels import JetTape, jet
from .outcome import TaylorOutcome
from .stepper import horner


def make_propagate_until_cout(tape: JetTape, *, high_accuracy: bool = True,
                              jet=jet, ev=None):
    """The per-step propagate-until driver over ``jet``, or over the event
    step ``ev``, that also records every step: ``pu(state, pars, t_hi,
    t_lo, target_hi, target_lo, max_delta_t, max_steps, **kw) -> dict``,
    the fields of ``compact_flat.make_propagate_until_flat``'s result (its
    keyword arguments ``kw`` passed on) and the records in
    :class:`ContinuousOutputBatch`'s layout: ``times_hi``, ``times_lo``
    (B, cap+1), ``tcs`` (B, cap, K+1, n), ``n_rec`` (B,) and ``fwd`` (B,).

    A lane's records are its accepted steps: every step but a non-finite
    last one (the JAX recorder's rule); they are the first ``n_rec`` rows
    of its ``tcs``, since a lane that stops stays stopped.  With events
    the last record of a lane that a terminal event stopped is its
    truncated step, and the records keep the state columns only."""
    pu = make_propagate_until_flat(tape, high_accuracy=high_accuracy,
                                   jet=jet, ev=ev)

    def pu_cout(state, pars, t_hi, t_lo, target_hi, target_lo, max_delta_t,
                max_steps, **kw):
        fwd = target_hi + target_lo >= t_hi + t_lo
        rec = []
        res = pu(state, pars, t_hi, t_lo, target_hi, target_lo, max_delta_t,
                 max_steps, record=rec, **kw)
        n_rec = res["nsteps"] - (
            res["outcome"] == int(TaylorOutcome.err_nf_state)).to(torch.int64)
        res.update(_pad_records(rec, n_rec, fwd, res["t_hi"], res["t_lo"],
                                tape.order, tape.n_eq))
        return res

    return pu_cout


def _pad_records(rec, n_rec, fwd, t_hi, t_lo, order, n_eq):
    """The recorded steps ``rec`` (a list of ``(tc (B, K+1, n), t_hi,
    t_lo)``) in the padded layout: rows past a lane's ``n_rec`` hold zero
    coefficients, its boundary ``n_rec`` the final time, the later ones
    +inf (forward lanes) or -inf (backward lanes) with a zero low part."""
    B, dev = n_rec.shape[0], n_rec.device
    cap = max(1, int(n_rec.max()) if B else 1)
    del rec[cap:]
    if rec:
        tcs = torch.stack([r[0][..., :n_eq] for r in rec], 1)
        th = torch.stack([r[1] for r in rec], 1)
        tl = torch.stack([r[2] for r in rec], 1)
        rec.clear()  # the stacks hold the only copy from here on
    else:
        tcs = torch.zeros((B, 1, order + 1, n_eq), dtype=t_hi.dtype,
                          device=dev)
        th = tl = torch.zeros((B, 1), dtype=t_hi.dtype, device=dev)
    live = torch.arange(cap, device=dev)[None, :] < n_rec[:, None]
    tcs.masked_fill_(~live[:, :, None, None], 0.0)
    inf = torch.full((B,), float("inf"), dtype=t_hi.dtype, device=dev)
    pad = torch.where(fwd, inf, -inf)
    times_hi = torch.cat([torch.where(live, th, pad[:, None]), pad[:, None]],
                         1)
    times_lo = torch.cat([torch.where(live, tl, 0.0), torch.zeros_like(pad)[
        :, None]], 1)
    lanes = torch.arange(B, device=dev)
    times_hi[lanes, n_rec] = t_hi
    times_lo[lanes, n_rec] = t_lo
    return dict(times_hi=times_hi, times_lo=times_lo, tcs=tcs, n_rec=n_rec,
                fwd=fwd)


def _step_index(bnd, t, fwd):
    """The step each query ``t`` falls in: the last boundary <= t going
    forward, >= t going backward (``bnd`` sorted the lane's way along its
    last axis; the JAX package's two searches, as one over the boundaries
    negated on backward lanes)."""
    sgn = torch.where(fwd, 1.0, -1.0).to(bnd.dtype)
    key = (bnd * sgn[..., None]).contiguous()
    return torch.searchsorted(key, (t * sgn[..., None]).contiguous(),
                              right=True) - 1


def _tensor(a, device, dtype=None):
    """``a`` as a ``dtype`` tensor on ``device`` (default: ``a``'s own
    dtype where it is float32 or float64, else float64): a tensor moved
    (no copy where it is there already), anything else copied through
    numpy."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.array(a))
    if dtype is None:
        dtype = a.dtype if a.dtype in DTYPES else torch.float64
    return a.to(device=device, dtype=dtype)


class ContinuousOutput:
    """Dense output over one trajectory's propagation (heyoka
    ``continuous_output``): ``times_hi``/``times_lo`` (n_steps + 1,) step
    boundaries, ``tcs`` (n_steps, order+1, dim) per-step coefficients, on
    ``device``.  Calling it with a time or an array of times evaluates the
    trajectory there."""

    def __init__(self, times_hi, times_lo, tcs, order: int, dim: int,
                 fwd: bool, *, device="cuda"):
        self._device = resolve_device(device)
        self._times_hi = _tensor(times_hi, self._device)
        self._times_lo = _tensor(times_lo, self._device)
        self._tcs = _tensor(tcs, self._device)
        self._order, self._dim, self._fwd = int(order), int(dim), bool(fwd)

    @property
    def n_steps(self) -> int:
        return int(self._tcs.shape[0])

    @property
    def times(self) -> np.ndarray:
        """Step boundary times (n_steps + 1,)."""
        return (self._times_hi + self._times_lo).cpu().numpy()

    @property
    def tcs(self) -> np.ndarray:
        return self._tcs.cpu().numpy()

    @property
    def bounds(self) -> tuple:
        """(initial time, final time) of the recorded propagation, in
        propagation order (heyoka ``get_bounds``)."""
        t = self.times
        return (float(t[0]), float(t[-1]))

    def _eval(self, ts):
        bnd = self._times_hi + self._times_lo
        fwd = torch.tensor(self._fwd, device=self._device)
        idx = _step_index(bnd, ts, fwd).clamp(0, self.n_steps - 1)
        rel = (ts - self._times_hi[idx]) - self._times_lo[idx]
        tc = self._tcs[idx]  # (n, order+1, dim)
        return horner(lambda i: tc[:, i, :], rel, self._order)

    def __call__(self, t):
        scalar = np.ndim(t) == 0
        ts = _tensor(np.atleast_1d(t), self._device, self._tcs.dtype)
        out = self._eval(ts).cpu().numpy()
        self._output = out[0] if scalar else out
        return self._output

    @property
    def output(self):
        """The result of the last evaluation (reference ``get_output``)."""
        if not hasattr(self, "_output"):
            self._output = np.zeros((self._tcs.shape[-1],),
                                    numpy_dtype(self._tcs.dtype))
        return self._output

    def __getstate__(self):
        return {"times_hi": self._times_hi.cpu().numpy(),
                "times_lo": self._times_lo.cpu().numpy(),
                "tcs": self.tcs, "order": self._order, "dim": self._dim,
                "fwd": self._fwd, "device": str(self._device)}

    def __setstate__(self, st):
        """From :meth:`__getstate__`'s dict or the JAX class's (the same
        keys without ``device``, which then defaults to ``"cuda"``)."""
        self.__init__(st["times_hi"], st["times_lo"], st["tcs"], st["order"],
                      st["dim"], st["fwd"], device=st.get("device", "cuda"))


class ContinuousOutputBatch:
    """Batch continuous output (heyoka ``continuous_output_batch``): per
    lane ``times_hi``/``times_lo`` (B, cap+1), ``tcs`` (B, cap, order+1,
    dim) padded to the longest lane, ``n_steps`` (B,) and ``fwd`` (B,), on
    ``device`` (numpy arrays or tensors; tensors already there stay
    uncopied).  ``__call__`` takes one time per lane, ``(B,)``, or
    ``(n_times, B)``."""

    def __init__(self, times_hi, times_lo, tcs, n_steps, order: int,
                 dim: int, fwd, *, device="cuda"):
        self._device = resolve_device(device)
        self._times_hi = _tensor(times_hi, self._device)
        self._times_lo = _tensor(times_lo, self._device)
        self._tcs = _tensor(tcs, self._device)
        self._n_steps = _tensor(n_steps, self._device, torch.int64)
        self._order, self._dim = int(order), int(dim)
        self._fwd = _tensor(fwd, self._device, torch.bool)

    @property
    def n_steps(self) -> np.ndarray:
        return self._n_steps.cpu().numpy()

    @property
    def batch_size(self) -> int:
        return int(self._tcs.shape[0])

    def _eval(self, ts):
        """``ts`` (B, T) -> (B, T, dim): each lane's queries in its own
        steps."""
        bnd = self._times_hi + self._times_lo
        idx = _step_index(bnd, ts, self._fwd)
        idx = torch.minimum(idx.clamp(min=0),
                            (self._n_steps - 1).clamp(min=0)[:, None])
        rows = torch.arange(self.batch_size, device=self._device)[:, None]
        rel = (ts - self._times_hi[rows, idx]) - self._times_lo[rows, idx]
        # one order at a time: (B, T, dim), never (B, T, order+1, dim)
        return horner(lambda i: self._tcs[rows, idx, i], rel, self._order)

    def __call__(self, t):
        t = np.asarray(t, np.float64)
        if t.ndim not in (1, 2) or t.shape[-1] != self.batch_size:
            raise ValueError("t must be (batch,) or (n_times, batch)")
        ts = _tensor(np.atleast_2d(t).T, self._device, self._tcs.dtype)
        out = self._eval(ts).transpose(0, 1).cpu().numpy()
        return out[0] if t.ndim == 1 else out

    def __getstate__(self):
        return {"times_hi": self._times_hi.cpu().numpy(),
                "times_lo": self._times_lo.cpu().numpy(),
                "tcs": self._tcs.cpu().numpy(), "n_steps": self.n_steps,
                "order": self._order, "dim": self._dim,
                "fwd": self._fwd.cpu().numpy(), "device": str(self._device)}

    def __setstate__(self, st):
        """From :meth:`__getstate__`'s dict or the JAX class's (the same
        keys without ``device``, which then defaults to ``"cuda"``)."""
        self.__init__(st["times_hi"], st["times_lo"], st["tcs"],
                      st["n_steps"], st["order"], st["dim"], st["fwd"],
                      device=st.get("device", "cuda"))
