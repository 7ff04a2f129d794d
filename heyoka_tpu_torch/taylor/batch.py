"""The batch integrator: many trajectories of one ODE system, one per lane.

The counterpart of ``heyoka_tpu.taylor.batch.TaylorAdaptiveBatch``
(reference: heyoka ``taylor_adaptive_batch``, ``include/heyoka/
taylor.hpp:781-1121``) without events, callbacks and variational systems:
the constructor, ``step``/``step_backward``, ``propagate_until``/
``propagate_for`` (with continuous output), ``propagate_grid``, the dense
output of the last step, the per-lane state, parameters and double-length
time with their setters, ``get_step_res``/``get_propagate_res``,
``engine_report``/``assert_engine``, ``warmup`` and pickling.

Every tensor lives on the ``device`` given to the constructor, CUDA unless
the caller asks for the CPU.  On a CUDA device ``step`` launches kernel B2
and ``propagate_until`` kernel B1 (with B2 for the exact landing steps);
on the CPU the plain twins run.  ``propagate_grid`` and
``propagate_until(c_output=True)`` take the per-step driver over the
route's jet on every tape (B2, B3 or B4), since kernel B1 keeps no
per-step coefficients.  A tape
with a time column propagates through the per-step driver, since kernel B1
carries no time.  A huge tape (``ROLLED_MIN_WIDTH`` columns or more) takes
the rolled jet, kernel B3, for ``step`` and for every step of the per-step
driver, as the JAX package routes it (``compact_flat.py:458-475``,
``fused.py:81-83``).  A tape with any op outside B1/B2/B3's rule set
(``convert.JET_OPS``: trig, Kepler, relational ...) takes the phase jet at
any width: order 0 in f64 torch, orders 1..K in kernel B4
(``jet_phase.jet_phase``), and the per-step driver, since B1 has no
order-0 rules for those ops.  The public getters return numpy arrays,
like the JAX class's.
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from .. import _build
from ..convert import (JET_OPS, plan_to_arrays, resolve_device,
                       state_from_numpy)
from ..expr.core import Variable, expr
from ..expr.decompose import Tape, taylor_decompose_sys
from ..dfloat import dd_add_d, dd_normalize
from . import stepper as _st
from .compact import build_plan
from .compact_flat import (
    check_grid, make_batched_step_flat, make_propagate_grid_flat,
    make_propagate_until_flat,
)
from .continuous import ContinuousOutputBatch, make_propagate_until_cout
from .fused import make_propagate_until_fused
from .jet_kernels import JetTape, jet, layout_report
from .jet_phase import PhaseTape, jet_phase
from .jet_rolled import RolledTape, jet_rolled
from .jet_rolled import layout_report as rolled_layout
from .outcome import TaylorOutcome

#: lane steps per launch of kernel B1 in ``propagate_until``
CHUNK_STEPS = 64

#: tapes with at least this many columns take the rolled jet (kernel B3)
#: and the per-step driver.  The threshold sits just above the
#: outer-Solar-System tape (381 columns), which keeps the north-star path
#: on kernel B1; whether it moves is ROADMAP A.16's decision, from the
#: routes' times side by side in ``chip_smoke.py`` phases 5 and 9
#: (PERF.md).
ROLLED_MIN_WIDTH = 512


def _normalize_sys(sys_):
    out = []
    for lhs, rhs in sys_:
        if isinstance(lhs, str):
            lhs = Variable(lhs)
        if not isinstance(lhs, Variable):
            raise TypeError("ODE system lhs entries must be variables")
        out.append((lhs, expr(rhs)))
    return out


def _no_callbacks(callback=None, events=()):
    if callback is not None or len(events):
        raise NotImplementedError(
            "step callbacks and events are not ported yet (ROADMAP A.11)")


class TaylorAdaptiveBatch:
    def __init__(self, sys, state, *, device="cuda", time=None, pars=None,
                 tol=None, high_accuracy=False, t_events=(), nt_events=()):
        _no_callbacks(events=(*t_events, *nt_events))
        self._device = resolve_device(device)
        self._sys = sys = _normalize_sys(sys)
        self._tol = tol = float(np.finfo(np.float64).eps if tol is None
                                else tol)
        self._order = _st.taylor_order_from_tol(tol)
        self._high_accuracy = high_accuracy = bool(high_accuracy)
        self._tape: Tape = taylor_decompose_sys(sys)
        plan = build_plan(self._tape, self._order)
        # the route: B4 for ops outside JET_OPS, else B3 for huge tapes,
        # else B1/B2; UnsupportedKernelOp for ops without any rule
        self._phase = any(g.name not in JET_OPS
                          for lv in plan.levels for g in lv)
        self._rolled = not self._phase and plan.width >= ROLLED_MIN_WIDTH
        tape_cls = PhaseTape if self._phase else \
            RolledTape if self._rolled else JetTape
        self._jtape = tape_cls(plan_to_arrays(plan), self._device)

        n_eq = self._tape.n_eq
        state = np.asarray(state, dtype=np.float64)
        if state.ndim != 2 or state.shape[1] != n_eq:
            raise ValueError(
                f"batch state must have shape (batch, {n_eq}); got "
                f"{state.shape}")
        B = state.shape[0]
        n_pars = self._tape.n_pars
        pars = np.zeros((B, n_pars)) if pars is None else np.asarray(pars)
        if n_pars and pars.shape != (B, n_pars):
            raise ValueError(f"batch pars must have shape ({B}, {n_pars})")
        time = np.broadcast_to(
            np.asarray(0.0 if time is None else time, np.float64), (B,))
        lanes = state_from_numpy(state, pars.reshape(B, n_pars), time,
                                 np.zeros(B), self._device)
        self._batch = B
        self._state, self._pars = lanes["state"], lanes["pars"]
        self._t_hi, self._t_lo = lanes["t_hi"], lanes["t_lo"]
        self._last_h = torch.zeros(B, dtype=torch.float64, device=self._device)
        self._tc = torch.zeros((B, self._order + 1, n_eq), dtype=torch.float64,
                               device=self._device)
        self._last_res = [(TaylorOutcome.success, 0.0)] * B
        self._last_prop_res = None

        jet_fn = jet_phase if self._phase else \
            jet_rolled if self._rolled else jet
        self._step_fn = make_batched_step_flat(
            self._jtape, high_accuracy=high_accuracy, jet=jet_fn)
        self._pg_fn = make_propagate_grid_flat(
            self._jtape, high_accuracy=high_accuracy, jet=jet_fn)
        self._cout_fn = make_propagate_until_cout(
            self._jtape, high_accuracy=high_accuracy, jet=jet_fn)
        if self._jtape.time_col is None and jet_fn is jet:
            self._pu_fn = make_propagate_until_fused(
                self._jtape, high_accuracy=high_accuracy,
                chunk_steps=CHUNK_STEPS)
            self._pu_engine = "fused"
        else:
            self._pu_fn = make_propagate_until_flat(
                self._jtape, high_accuracy=high_accuracy, jet=jet_fn)
            self._pu_engine = "flat"

    # -- introspection ---------------------------------------------------------

    def engine_report(self) -> dict:
        """Which engine and kernels this integrator runs: ``device``,
        ``jet`` (kernel B2 ``hy_jet_f64`` on CUDA, ``jet_plain`` on the
        CPU; for a huge tape kernel B3 ``hy_jet_rolled_f64`` /
        ``jet_rolled_plain``; for a tape with ops outside B2's rule set
        kernel B4 ``hy_phase_f64`` / ``phase_plain``),
        ``propagate_engine`` (``"fused"``: chunks of
        kernel B1 plus the exact landing; ``"flat"``: the per-step driver),
        ``prop`` (``hy_prop_f64`` / ``prop_plain``, None without the
        fused engine), ``grid_engine`` and ``c_output_engine``, the driver
        of ``propagate_grid`` and of ``propagate_until(c_output=True)``
        (``"flat"``, the per-step driver over ``jet``, on every tape), and
        ``layout``, the block layout of kernels B1/B2 on this tape
        (``jet_kernels.layout_report``) or of kernel B3 on a huge one
        (``jet_rolled.layout_report``; the CPU names the one the card would
        run), None on the B4 route."""
        cuda = self._device.type == "cuda"
        fused = self._pu_engine == "fused"
        if self._phase:
            jet_name = "hy_phase_f64" if cuda else "phase_plain"
        elif self._rolled:
            jet_name = "hy_jet_rolled_f64" if cuda else "jet_rolled_plain"
        else:
            jet_name = "hy_jet_f64" if cuda else "jet_plain"
        return dict(
            device=str(self._device),
            jet=jet_name,
            propagate_engine=self._pu_engine,
            prop=("hy_prop_f64" if cuda else "prop_plain") if fused
            else None,
            grid_engine="flat",
            c_output_engine="flat",
            layout=None if self._phase else rolled_layout(self._jtape)
            if self._rolled else layout_report(self._jtape),
        )

    def assert_engine(self, **expected):
        """Raise ``AssertionError`` unless :meth:`engine_report` matches
        every ``expected`` item (e.g. ``tb.assert_engine(jet="hy_jet_f64",
        propagate_engine="fused")``); returns ``self``."""
        rep = self.engine_report()
        for k, v in expected.items():
            if rep.get(k) != v:
                raise AssertionError(
                    f"engine check failed: {k}={rep.get(k)!r}, expected "
                    f"{v!r} (full report: {rep})")
        return self

    @property
    def is_variational(self) -> bool:
        return False

    def _variational(self, *args, **kwargs):
        raise NotImplementedError(
            "variational systems are not ported yet (ROADMAP A.20)")

    get_vargs = get_vorder = get_vslice = get_mindex = _variational
    eval_taylor_map = get_tstate = _variational

    @property
    def batch_size(self) -> int:
        return self._batch

    @property
    def order(self) -> int:
        return self._order

    @property
    def tol(self) -> float:
        return self._tol

    @property
    def dim(self) -> int:
        return self._tape.n_eq

    @property
    def decomposition(self) -> Tape:
        return self._tape

    @property
    def sys(self):
        """The (normalized) ODE system (reference ``get_sys``)."""
        return self._sys

    @property
    def high_accuracy(self) -> bool:
        return self._high_accuracy

    @property
    def state(self) -> np.ndarray:
        return self._state.cpu().numpy()

    @state.setter
    def state(self, v):
        v = np.asarray(v, dtype=np.float64)
        if v.shape != (self._batch, self.dim):
            raise ValueError("bad state shape")
        self._state = torch.as_tensor(v.copy(), device=self._device)

    @property
    def pars(self) -> np.ndarray:
        return self._pars.cpu().numpy()

    @pars.setter
    def pars(self, v):
        self._pars = torch.as_tensor(
            np.asarray(v, np.float64).reshape(self._pars.shape).copy(),
            device=self._device)

    @property
    def time(self) -> np.ndarray:
        return (self._t_hi + self._t_lo).cpu().numpy()

    def set_time(self, v):
        self._t_hi = self._lanes(v)
        self._t_lo = torch.zeros_like(self._t_hi)

    @property
    def dtime(self) -> tuple:
        """Per-lane (hi, lo) double-length times."""
        return self._t_hi.cpu().numpy(), self._t_lo.cpu().numpy()

    def set_dtime(self, hi, lo):
        """Set the per-lane double-length times, renormalized (heyoka
        ``set_dtime``)."""
        hi, lo = self._lanes(hi), self._lanes(lo)
        if not bool((torch.isfinite(hi) & torch.isfinite(lo)).all()):
            raise ValueError("the dtime components must be finite")
        self._t_hi, self._t_lo = dd_normalize(hi, lo)

    @property
    def last_h(self) -> np.ndarray:
        return self._last_h.cpu().numpy()

    @property
    def tc(self) -> np.ndarray:
        """Taylor coefficients of the last step, (batch, order+1, dim)."""
        return self._tc.cpu().numpy()

    # -- stepping ----------------------------------------------------------------

    def _lanes(self, x):
        return torch.as_tensor(
            np.array(np.broadcast_to(np.asarray(x, np.float64),
                                     (self._batch,))),
            device=self._device)

    def step(self, max_delta_t=None, write_tc: bool = False):
        """One adaptive step in every lane; per-lane ``(outcome, h)`` via
        :meth:`get_step_res`.  The coefficients of the step are always kept
        (:attr:`tc`), as in the JAX package: ``write_tc`` is accepted and
        changes nothing."""
        mdt = self._lanes(_pymath.inf if max_delta_t is None else max_delta_t)
        new_state, h, tc = self._step_fn(self._state, self._pars, self._t_hi,
                                         mdt)
        self._state, self._last_h, self._tc = new_state.contiguous(), h, tc
        self._t_hi, self._t_lo = dd_add_d(self._t_hi, self._t_lo, h)
        finite = (torch.isfinite(new_state).all(1)
                  & torch.isfinite(h)).tolist()
        clamped = (torch.abs(h) >= torch.abs(mdt)).tolist()
        self._last_res = [
            (TaylorOutcome.err_nf_state if not f else
             TaylorOutcome.time_limit if c else
             TaylorOutcome.success, hi)
            for f, c, hi in zip(finite, clamped, h.tolist())
        ]

    def step_backward(self):
        self.step(max_delta_t=-_pymath.inf)

    def get_step_res(self):
        return list(self._last_res)

    def get_propagate_res(self):
        """Per-lane ``(outcome, min_h, max_h, nsteps)`` of the last
        ``propagate_*`` call."""
        if self._last_prop_res is None:
            raise ValueError("no propagate_* call has completed yet")
        return list(self._last_prop_res)

    # -- dense output ------------------------------------------------------------

    def update_d_output(self, t, rel_time: bool = False) -> np.ndarray:
        """Per-lane dense output of the last step at time(s) ``t`` (scalar
        or per lane; relative to the step's start with ``rel_time``): the
        Taylor polynomials of :attr:`tc` by Horner in f64 on the device,
        (batch, dim) (reference ``update_d_output``)."""
        rel = self._lanes(t)
        if not rel_time:
            # the step's start as the JAX package takes it: time - last_h
            rel = rel - ((self._t_hi + self._t_lo) - self._last_h)
        self._d_output = _st.horner(lambda i: self._tc[:, i], rel,
                                    self._order).cpu().numpy()
        return self._d_output

    @property
    def d_output(self) -> np.ndarray:
        """The last dense output computed by :meth:`update_d_output`
        (zeros before the first call)."""
        if not hasattr(self, "_d_output"):
            self._d_output = np.zeros((self._batch, self.dim))
        return self._d_output

    # -- propagation ---------------------------------------------------------------

    def _finish(self, res):
        """Take a driver's result: the lanes' new state, time, last step
        and coefficients, and the per-lane results (one host copy per
        field, then plain Python lists: iterating a tensor lane by lane
        costs microseconds per lane).  Returns ``(outcomes, min_h, max_h,
        nsteps)``."""
        self._state = res["state"].contiguous()
        self._t_hi, self._t_lo = res["t_hi"], res["t_lo"]
        self._last_h, self._tc = res["last_h"], res["tc"]
        oc = [TaylorOutcome(o) for o in res["outcome"].tolist()]
        self._last_res = list(zip(oc, res["last_h"].tolist()))
        mn, mx, ns = (res[k].cpu().numpy() for k in ("min_h", "max_h",
                                                     "nsteps"))
        self._last_prop_res = list(zip(oc, mn.tolist(), mx.tolist(),
                                       ns.tolist()))
        return oc, mn, mx, ns

    def propagate_until(self, t, *, max_delta_t=None, max_steps=0,
                        c_output=False, callback=None):
        """Propagate every lane to time ``t`` (scalar or per lane); returns
        ``(outcomes, min_h, max_h, nsteps)`` per lane, and with
        ``c_output`` a :class:`.continuous.ContinuousOutputBatch` last,
        whose records stay on the device (the per-step driver over the
        route's jet, on every tape)."""
        _no_callbacks(callback)
        target = self._lanes(t)
        mdt = self._lanes(_pymath.inf if max_delta_t is None else max_delta_t)
        args = (self._state, self._pars, self._t_hi, self._t_lo, target,
                torch.zeros_like(target), mdt, int(max_steps))
        if not c_output:
            return self._finish(self._pu_fn(*args))
        res = self._cout_fn(*args)
        return (*self._finish(res), ContinuousOutputBatch(
            res["times_hi"], res["times_lo"], res["tcs"], res["n_rec"],
            self._order, self.dim, res["fwd"], device=self._device))

    def propagate_for(self, delta_t, **kw):
        target = self.time + np.broadcast_to(
            np.asarray(delta_t, dtype=np.float64), (self._batch,))
        return self.propagate_until(target, **kw)

    def propagate_grid(self, grid, *, max_delta_t=None, max_steps=0,
                       callback=None):
        """Propagate every lane over the shared, monotonic time ``grid``;
        returns ``(outcomes, min_h, max_h, nsteps, out (batch, len(grid),
        dim))``, the rows a lane did not reach zero.  The per-step driver
        over the route's jet on every tape
        (``compact_flat.make_propagate_grid_flat``)."""
        _no_callbacks(callback)
        grid = torch.as_tensor(check_grid(grid), device=self._device)
        mdt = self._lanes(_pymath.inf if max_delta_t is None else max_delta_t)
        res = self._pg_fn(self._state, self._pars, self._t_hi, self._t_lo,
                          grid, mdt, int(max_steps))
        return (*self._finish(res), res["out"].cpu().numpy())

    def warmup(self, drivers=("step", "propagate_until"), grid_size=8):
        """Build the kernels (``nvcc``, on a CUDA device) and run each of
        ``drivers`` (``"step"``, ``"propagate_until"``,
        ``"propagate_grid"``) once with no-op arguments (a step of at most
        0, a target equal to the lanes' time, a grid of ``grid_size``
        points at the first lane's time, one step at most), discarding the
        results: the state does not advance.  Build and launch errors are
        raised.  Returns ``self``."""
        unknown = set(drivers) - {"step", "propagate_until", "propagate_grid"}
        if unknown:
            raise ValueError(f"unknown drivers {sorted(unknown)}")
        if self._device.type == "cuda":
            _build.load()
        zero = torch.zeros_like(self._t_hi)
        args = (self._state, self._pars, self._t_hi)
        if "step" in drivers:
            self._step_fn(*args, zero)
        if "propagate_until" in drivers:
            self._pu_fn(*args, self._t_lo, self._t_hi, self._t_lo, zero, 1)
        if "propagate_grid" in drivers:
            self._pg_fn(*args, self._t_lo,
                        self._t_hi[:1].expand(int(grid_size)).contiguous(),
                        zero, 1)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    # -- pickling ------------------------------------------------------------------

    def __getstate__(self):
        """The system, tolerance, ``high_accuracy``, the device's name and
        numpy copies of the lanes (state, parameters, time, last step and
        its coefficients)."""
        return {
            "sys": self._sys, "tol": self._tol,
            "high_accuracy": self._high_accuracy,
            "device": str(self._device),
            "state": self.state, "pars": self.pars,
            "t_hi": self._t_hi.cpu().numpy(), "t_lo": self._t_lo.cpu().numpy(),
            "last_h": self.last_h, "tc": self.tc,
        }

    def __setstate__(self, st):
        """Rebuild on the pickled device (raises where it is absent)."""
        self.__init__(st["sys"], st["state"], pars=st["pars"], tol=st["tol"],
                      high_accuracy=st["high_accuracy"], device=st["device"])
        dev = self._device
        self._t_hi, self._t_lo, self._last_h, self._tc = (
            torch.as_tensor(np.array(st[k], np.float64), device=dev)
            for k in ("t_hi", "t_lo", "last_h", "tc"))


def taylor_adaptive_batch(sys, state, **kw) -> TaylorAdaptiveBatch:
    return TaylorAdaptiveBatch(sys, state, **kw)
