"""The batch integrator: many trajectories of one ODE system, one per lane.

The counterpart of ``heyoka_tpu.taylor.batch.TaylorAdaptiveBatch``
(reference: heyoka ``taylor_adaptive_batch``, ``include/heyoka/
taylor.hpp:781-1121``): the constructor with its terminal and
non-terminal events and variational systems (a ``var_ode_sys``: its
augmented system on the route its tape takes, the variational getters and
the Taylor map, a cfunc on the device), ``step``/``step_backward``,
``propagate_until``/``propagate_for`` (with continuous output and step
callbacks), ``propagate_grid``, the dense output of the last step, the
per-lane state, parameters, double-length time and terminal-event
cooldowns with their setters, ``get_step_res``/``get_propagate_res``,
``engine_report``/``assert_engine``, ``warmup`` and pickling.

Events (:mod:`.events`, :mod:`.events_impl`): the event equations are the
tape's sv-funcs, so the route's jet (B2, B3 or B4) returns their rows
after the state's and they take part in the step-size norms; every
propagation of a tape with events runs the per-step drivers over the
event step (``engine_report()["propagate_engine"] == "events"``), never
kernel B1.  A step callback also takes ``propagate_until`` off kernel B1:
an in-graph one runs in the per-step driver, a host one in the
host-driven driver (``events.propagate_stepwise``).

Every tensor lives on the ``device`` given to the constructor, CUDA unless
the caller asks for the CPU, in f64: the constructor's ``dtype=`` takes
float64 and refuses any other.  On a CUDA device ``step`` launches kernel B2
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
order-0 rules for those ops.  A dense trig series (``expr/series.py``,
the ephemeris models' ``series_op=True``) is such an op: kernel S1
(``taylor/series_jet.py``) makes its column's orders 0..K before B4's
launch, which copies them; its input must be affine in time, or the
constructor raises ValueError.  The public getters return numpy arrays,
like the JAX class's.
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from .. import _build
from ..convert import (JET_OPS, check_dtype, plan_to_arrays,
                       resolve_device, state_from_numpy)
from ..expr.core import Variable, expr
from ..expr.decompose import Tape, taylor_decompose_sys
from ..dfloat import dd_add_d, dd_normalize
from . import stepper as _st
from ..callback import is_in_graph
from . import events as _ev
from .compact import build_plan
from .compact_flat import (
    check_grid, make_batched_step_flat, make_propagate_grid_flat,
    make_propagate_until_flat,
)
from .continuous import ContinuousOutputBatch, make_propagate_until_cout
from .events_impl import build_event_step_batch
from .fused import make_propagate_until_fused
from .jet_kernels import JetTape, jet, layout_report
from .jet_phase import PhaseTape, jet_phase
from .jet_rolled import RolledTape, jet_rolled
from .jet_rolled import layout_report as rolled_layout
from .outcome import TaylorOutcome
from ..varsys import var_ode_sys

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


class TaylorAdaptiveBatch:
    def __init__(self, sys, state, *, device="cuda", time=None, pars=None,
                 tol=None, high_accuracy=False, t_events=(), nt_events=(),
                 dtype=np.float64):
        check_dtype(dtype)
        # a var_ode_sys integrates its augmented system; lanes given by
        # their original initial conditions get the variational ones
        # (``heyoka_tpu/taylor/batch.py:54-75``), all lanes in one call
        self._vsys = sys if isinstance(sys, var_ode_sys) else None
        if self._vsys is not None:
            state = np.asarray(state, dtype=np.float64)
            if state.ndim == 2 and state.shape[1] == self._vsys.n_orig:
                state = self._vsys.initial_state(
                    state, pars=pars, t0=0.0 if time is None else time)
            sys = self._vsys.sys
        self._sys = sys = _normalize_sys(sys)
        self._tol = tol = float(np.finfo(np.float64).eps if tol is None
                                else tol)
        self._order = _st.taylor_order_from_tol(tol)
        self._high_accuracy = bool(high_accuracy)
        # the event equations are the tape's sv-funcs, terminal ones first
        self._t_events, self._nt_events = list(t_events), list(nt_events)
        self._tape: Tape = taylor_decompose_sys(
            sys, extra_outputs=[ev.expression for ev in
                                (*self._t_events, *self._nt_events)])
        plan = build_plan(self._tape, self._order)
        # the route: B4 for ops outside JET_OPS, else B3 for huge tapes,
        # else B1/B2; UnsupportedKernelOp for ops without any rule
        self._phase = any(g.name not in JET_OPS
                          for lv in plan.levels for g in lv)
        self._rolled = not self._phase and plan.width >= ROLLED_MIN_WIDTH
        self._arrays = plan_to_arrays(plan)
        self._build_engine(resolve_device(device))
        self._set_lanes(state, pars, time)

    @classmethod
    def _sharing(cls, src, state, *, pars=None, time=None, device=None,
                 t_events=None, nt_events=None):
        """A new batch of ``src``'s system, tolerance and route with the
        lanes ``state``/``pars``/``time``, neither decomposing nor packing
        the tape again: on ``src``'s device it shares ``src``'s jet tape
        and drivers, on another it loads the packed tables there.
        ``t_events``/``nt_events`` (default ``src``'s) must match
        ``src``'s in expression, direction and cooldown: they may differ
        in their callbacks only (the ensembles' and the scalar
        integrator's)."""
        # a shallow copy of every attribute (copy.copy would go through
        # __getstate__ and rebuild), whose lanes _set_lanes then replaces
        tb = cls.__new__(cls)
        tb.__dict__.update(src.__dict__)
        tb._t_events = list(src._t_events if t_events is None else t_events)
        tb._nt_events = list(src._nt_events if nt_events is None
                             else nt_events)
        if (len(tb._t_events), len(tb._nt_events)) != (
                len(src._t_events), len(src._nt_events)):
            raise ValueError("the events must match the source's")
        dev = src._device if device is None else resolve_device(device)
        if dev != src._device:
            tb._build_engine(dev)
        tb._set_lanes(state, pars, time)
        return tb

    def _build_engine(self, device):
        """The jet tape on ``device`` and the drivers over it."""
        self._device = device
        tape_cls = PhaseTape if self._phase else \
            RolledTape if self._rolled else JetTape
        self._jtape = tape_cls(self._arrays, device)
        jet_fn = jet_phase if self._phase else \
            jet_rolled if self._rolled else jet
        high_accuracy = self._high_accuracy
        self._ev = build_event_step_batch(
            self._jtape, self._t_events, self._nt_events, self._tol,
            high_accuracy=high_accuracy, jet=jet_fn) \
            if self._t_events or self._nt_events else None
        kw = dict(high_accuracy=high_accuracy, jet=jet_fn, ev=self._ev)
        self._step_fn = make_batched_step_flat(
            self._jtape, high_accuracy=high_accuracy, jet=jet_fn)
        self._pg_fn = make_propagate_grid_flat(self._jtape, **kw)
        self._cout_fn = make_propagate_until_cout(self._jtape, **kw)
        # the per-step driver: events, an in-graph callback, and every
        # tape kernel B1 cannot take
        self._flat_pu = make_propagate_until_flat(self._jtape, **kw)
        if self._ev is not None:
            self._pu_fn, self._pu_engine = self._flat_pu, "events"
        elif self._jtape.time_col is None and jet_fn is jet:
            self._pu_fn = make_propagate_until_fused(
                self._jtape, high_accuracy=high_accuracy,
                chunk_steps=CHUNK_STEPS)
            self._pu_engine = "fused"
        else:
            self._pu_fn, self._pu_engine = self._flat_pu, "flat"

    def _set_lanes(self, state, pars, time):
        """The lanes (state (B, n), pars (B, p), time (B,) or a scalar),
        with zero last steps, coefficients and cooldowns."""
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
        self._d_output = np.zeros((B, n_eq))
        # the lanes whose last step a terminal event stopped for good (no
        # callback, or one that returned False): the host-driven driver
        # ends them
        self._event_stop = np.zeros(B, bool)
        self._tstate = None
        self._te_cooldowns = torch.zeros((B, len(self._t_events)),
                                         dtype=torch.float64,
                                         device=self._device)

    # -- introspection ---------------------------------------------------------

    def engine_report(self) -> dict:
        """Which engine and kernels this integrator runs: ``device``,
        ``jet`` (kernel B2 ``hy_jet_f64`` on CUDA, ``jet_plain`` on the
        CPU; for a huge tape kernel B3 ``hy_jet_rolled_f64`` /
        ``jet_rolled_plain``; for a tape with ops outside B2's rule set
        kernel B4 ``hy_phase_f64`` / ``phase_plain``),
        ``propagate_engine`` (``"fused"``: chunks of
        kernel B1 plus the exact landing; ``"flat"``: the per-step driver;
        ``"events"``: the per-step driver over the event step, on a tape
        with events), ``prop`` (``hy_prop_f64`` / ``prop_plain``, None
        without the fused engine), ``grid_engine`` and
        ``c_output_engine``, the driver of ``propagate_grid`` and of
        ``propagate_until(c_output=True)`` (``"flat"``, the per-step
        driver over ``jet``, or ``"events"`` with events), and
        ``layout``, the block layout of kernels B1/B2 on this tape
        (``jet_kernels.layout_report``) or of kernel B3 on a huge one
        (``jet_rolled.layout_report``; the CPU names the one the card would
        run), None on the B4 route, and, on a tape with dense trig series
        only, ``series``, their jet (kernel S1 ``hy_series_jet_f64`` /
        ``series_jet_plain``)."""
        cuda = self._device.type == "cuda"
        fused = self._pu_engine == "fused"
        if self._phase:
            jet_name = "hy_phase_f64" if cuda else "phase_plain"
        elif self._rolled:
            jet_name = "hy_jet_rolled_f64" if cuda else "jet_rolled_plain"
        else:
            jet_name = "hy_jet_f64" if cuda else "jet_plain"
        rep = dict(
            device=str(self._device),
            jet=jet_name,
            propagate_engine=self._pu_engine,
            prop=("hy_prop_f64" if cuda else "prop_plain") if fused
            else None,
            grid_engine="events" if self._ev is not None else "flat",
            c_output_engine="events" if self._ev is not None else "flat",
            layout=None if self._phase else rolled_layout(self._jtape)
            if self._rolled else layout_report(self._jtape),
        )
        if getattr(self._jtape, "n_ser", 0):
            rep["series"] = "hy_series_jet_f64" if cuda \
                else "series_jet_plain"
        return rep

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

    # -- variational API (``heyoka_tpu/taylor/batch.py:457-519``) -------------

    def _check_variational(self, name):
        if self._vsys is None:
            raise ValueError(
                f"{name} requires an integrator built from a var_ode_sys")

    @property
    def is_variational(self) -> bool:
        return self._vsys is not None

    def get_n_orig_sv(self) -> int:
        """Number of original (non-variational) state variables
        (reference ``get_n_orig_sv``)."""
        return self._vsys.n_orig if self._vsys is not None else self.dim

    def get_vargs(self):
        self._check_variational("get_vargs")
        return list(self._vsys.vargs)

    def get_vorder(self) -> int:
        self._check_variational("get_vorder")
        return self._vsys.order

    def get_vslice(self, order: int, component: int | None = None) -> slice:
        self._check_variational("get_vslice")
        return self._vsys.get_vslice(order, component)

    def get_mindex(self, i: int):
        self._check_variational("get_mindex")
        return self._vsys.get_mindex(i)

    def _taylor_map(self):
        """The Taylor map's cfunc on this batch's device, built once a
        device (the ensembles' batches share the cache)."""
        tms = self.__dict__.setdefault("_tms", {})
        key = str(self._device)
        if key not in tms:
            tms[key] = self._vsys.make_taylor_map(device=self._device)
        return tms[key]

    def eval_taylor_map(self, s) -> np.ndarray:
        """Evaluate the Taylor map at deviations ``s`` for every lane
        (reference ``taylor_adaptive_batch::eval_taylor_map``): ``s`` is
        ``(n_vargs,)`` (shared across lanes) or ``(batch, n_vargs)``;
        returns the ``(batch, n_orig)`` mapped states.  The map is a cfunc
        on the device, each lane's augmented state its parameters."""
        self._check_variational("eval_taylor_map")
        s = np.asarray(s, dtype=np.float64)
        K = self._vsys.n_vargs
        if s.shape == (K,):
            s = np.broadcast_to(s, (self._batch, K))
        if s.shape != (self._batch, K):
            raise ValueError(
                f"expected deviations of shape ({K},) or "
                f"({self._batch}, {K}); got {s.shape}")
        self._tstate = self._taylor_map()(s, self._state).cpu().numpy()
        return self._tstate

    def get_tstate(self) -> np.ndarray:
        """The last :meth:`eval_taylor_map` result, zeros before it."""
        self._check_variational("get_tstate")
        if self._tstate is None:
            self._tstate = np.zeros((self._batch, self._vsys.n_orig))
        return self._tstate

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
        """Taylor coefficients of the last step, (batch, order+1, dim);
        after a step with events (batch, order+1, dim + events), the event
        equations' columns kept, as the JAX class keeps them."""
        return self._tc.cpu().numpy()

    def _tc_with_events(self):
        """:attr:`tc` on the device, widened with zero event columns to
        the event step's width (the JAX driver's carry, ``batch.py:
        1481-1489``)."""
        n_sv = self.dim + self._jtape.n_out
        tc = self._tc
        if tc.shape[2] != n_sv:
            tc = torch.cat([tc, tc.new_zeros(
                (self._batch, self._order + 1, n_sv - tc.shape[2]))], 2)
        return tc

    @property
    def t_events(self):
        return list(self._t_events)

    @property
    def nt_events(self):
        return list(self._nt_events)

    @property
    def te_cooldowns(self) -> np.ndarray:
        """Per-lane terminal-event cooldowns, (batch, n_te) (heyoka
        ``get_te_cooldowns``)."""
        return self._te_cooldowns.cpu().numpy()

    def reset_cooldowns(self, lane=None):
        """Zero the terminal-event cooldowns of every lane, or of ``lane``
        (heyoka ``reset_cooldowns``)."""
        cd = self._te_cooldowns.clone()
        if lane is None:
            cd.zero_()
        else:
            cd[int(lane)] = 0.0
        self._te_cooldowns = cd

    # -- stepping ----------------------------------------------------------------

    def _lanes(self, x):
        return torch.as_tensor(
            np.array(np.broadcast_to(np.asarray(x, np.float64),
                                     (self._batch,))),
            device=self._device)

    def step(self, max_delta_t=None, write_tc: bool = False):
        """One adaptive step in every lane; per-lane ``(outcome, h)`` via
        :meth:`get_step_res` (the outcome of a step that a terminal event
        stopped is the event's index).  With events, each lane then calls
        its non-terminal callbacks ``cb(tb, t, d_sgn, lane)`` in time
        order and the callback of the terminal event that stopped it,
        ``cb(tb, d_sgn, lane)`` (``batch.py:855-904``).  The coefficients
        of the step are always kept (:attr:`tc`), as in the JAX package:
        ``write_tc`` is accepted and changes nothing."""
        mdt = self._lanes(_pymath.inf if max_delta_t is None else max_delta_t)
        if self._ev is not None:
            return self._step_events(mdt)
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

    def _step_events(self, mdt):
        res = self._ev(self._state, self._pars, self._t_hi, self._t_lo, mdt,
                       self._te_cooldowns)
        self._state = res["state"].contiguous()
        self._t_hi, self._t_lo = res["t_hi"], res["t_lo"]
        self._last_h, self._tc = res["last_h"], res["tc"]
        self._te_cooldowns = res["cooldowns"]
        h = res["last_h"].tolist()
        self._last_res = [(_ev.outcome_of(o), hi) for o, hi in
                          zip(res["outcome"].tolist(), h)]
        B = self._batch
        self._event_stop = np.zeros(B, bool)
        mask = res["nt_mask"].cpu().numpy()
        te_idx = res["te_idx"].tolist()
        if not mask.any() and max(te_idx, default=-1) < 0:
            return
        times, idx, sgn = (res[k].cpu().numpy()
                           for k in ("nt_times", "nt_idx", "nt_sgn"))
        te_sgn = res["te_sgn"].tolist()
        t_hi = self._t_hi.tolist()
        for i in range(B):
            if self._nt_events and mask[i].any():
                m = mask[i]
                order = np.argsort(np.abs(times[i][m] - (t_hi[i] - h[i])),
                                   kind="stable")
                for k in order:
                    cb = self._nt_events[int(idx[i][m][k])].callback
                    if cb is not None:
                        cb(self, float(times[i][m][k]), int(sgn[i][m][k]), i)
            if te_idx[i] >= 0:
                cb = self._t_events[te_idx[i]].callback
                self._event_stop[i] = cb is None or \
                    cb(self, te_sgn[i], i) is False

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
        self._d_output = _st.horner(lambda i: self._tc[:, i, :self.dim],
                                    rel, self._order).cpu().numpy()
        return self._d_output

    @property
    def d_output(self) -> np.ndarray:
        """The last dense output computed by :meth:`update_d_output`
        (zeros before the first call)."""
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
        if "cooldowns" in res:
            self._te_cooldowns = res["cooldowns"]
            self._last_te_sgn = res["te_sgn"]
        oc = [_ev.outcome_of(o) for o in res["outcome"].tolist()]
        self._last_res = list(zip(oc, res["last_h"].tolist()))
        mn, mx, ns = (res[k].cpu().numpy() for k in ("min_h", "max_h",
                                                     "nsteps"))
        return self._prop_res(oc, mn, mx, ns)

    def _prop_res(self, oc, mn, mx, ns):
        """Keep ``(outcomes, min_h, max_h, nsteps)`` for
        :meth:`get_propagate_res` and return them."""
        self._last_prop_res = list(zip(oc, np.asarray(mn).tolist(),
                                       np.asarray(mx).tolist(),
                                       np.asarray(ns).tolist()))
        return oc, mn, mx, ns

    def _te_callbacks(self) -> bool:
        return any(ev.callback is not None for ev in self._t_events)

    def _ev_kw(self, hits):
        """The event drivers' carry: cooldowns, last step and
        coefficients, the hit log (empty without events)."""
        if self._ev is None:
            return {}
        return dict(cooldowns=self._te_cooldowns, last_h=self._last_h,
                    tc=self._tc_with_events(), hits=hits)

    def propagate_until(self, t, *, max_delta_t=None, max_steps=0,
                        c_output=False, callback=None):
        """Propagate every lane to time ``t`` (scalar or per lane); returns
        ``(outcomes, min_h, max_h, nsteps)`` per lane, and with
        ``c_output`` a :class:`.continuous.ContinuousOutputBatch` last,
        whose records stay on the device (the per-step driver over the
        route's jet, on every tape).

        With events a lane stops at a terminal event without a callback
        (its outcome the event's index); the non-terminal callbacks run
        after the propagation, lane by lane in time order
        (:func:`.events.propagate_until_ev`); terminal events with
        callbacks go through :func:`.events.propagate_until_te_cb`.
        ``callback``: an in-graph step callback (:mod:`..callback`) runs
        after every step of the per-step driver and stops the lanes whose
        ``keep`` is False with ``cb_stop``; a host callback ``cb(tb) ->
        bool`` (or an in-graph one with events) runs after every lockstep
        step of :func:`.events.propagate_stepwise`, and False stops every
        lane still running."""
        t_np = np.array(np.broadcast_to(np.asarray(t, np.float64),
                                        (self._batch,)))
        mdt_np = np.array(np.broadcast_to(np.asarray(
            _pymath.inf if max_delta_t is None else max_delta_t,
            np.float64), (self._batch,)))
        max_steps = int(max_steps)
        stepwise = callback is not None and (
            self._ev is not None or not is_in_graph(callback))
        if c_output and (stepwise or self._te_callbacks()):
            oc, mn, mx, ns, rec = _ev.propagate_stepwise(
                self, t_np, mdt_np, max_steps, callback, record=True)
            return (*self._prop_res(oc, mn, mx, ns), self._cout(rec))
        if stepwise:
            return self._prop_res(*_ev.propagate_stepwise(
                self, t_np, mdt_np, max_steps, callback))
        if self._ev is not None and not c_output:
            if self._te_callbacks():
                return self._prop_res(*_ev.propagate_until_te_cb(
                    self, t_np, mdt_np, max_steps))
            return _ev.propagate_until_ev(self, t_np, np.zeros_like(t_np),
                                          mdt_np, max_steps)
        target, mdt = self._lanes(t_np), self._lanes(mdt_np)
        args = (self._state, self._pars, self._t_hi, self._t_lo, target,
                torch.zeros_like(target), mdt, max_steps)
        hits = _ev.HitLog() if self._nt_events else None
        fwd = t_np >= self.time
        if c_output:
            res = self._cout_fn(*args, **self._ev_kw(hits))
            out = (*self._finish(res), self._cout(res))
        elif callback is not None:
            if hasattr(callback, "pre_hook"):
                callback.pre_hook(self)
            out = self._finish(self._flat_pu(*args, hook=callback))
        else:
            out = self._finish(self._pu_fn(*args))
        if hits is not None:
            _ev.dispatch_nt(self, hits, fwd)
        return out

    def _cout(self, rec) -> ContinuousOutputBatch:
        return ContinuousOutputBatch(
            rec["times_hi"], rec["times_lo"], rec["tcs"], rec["n_rec"],
            self._order, self.dim, rec["fwd"], device=self._device)

    def propagate_for(self, delta_t, **kw):
        target = self.time + np.broadcast_to(
            np.asarray(delta_t, dtype=np.float64), (self._batch,))
        return self.propagate_until(target, **kw)

    def propagate_grid(self, grid, *, max_delta_t=None, max_steps=0,
                       callback=None):
        """Propagate every lane over the shared, monotonic time ``grid``;
        returns ``(outcomes, min_h, max_h, nsteps, out (batch, len(grid),
        dim))``, the rows a lane did not reach zero, or NaN with events or
        a callback, as the JAX class fills them.  The per-step driver over
        the route's jet on every tape, over the event step with events
        (``compact_flat.make_propagate_grid_flat``; the non-terminal
        callbacks run after it, lane by lane in time order); with a step
        callback or terminal-event callbacks the host-driven
        :func:`.events.propagate_stepwise`."""
        *res, out = self._grid(grid, max_delta_t, max_steps, callback)
        return (*res, out.cpu().numpy() if isinstance(out, torch.Tensor)
                else out)

    def _grid(self, grid, max_delta_t=None, max_steps=0, callback=None):
        """:meth:`propagate_grid` with the rows as the driver gives them: a
        tensor on the device from the device driver (the ensembles keep
        it there), a numpy array from the host-driven one."""
        grid_np = check_grid(grid)
        mdt_np = np.array(np.broadcast_to(np.asarray(
            _pymath.inf if max_delta_t is None else max_delta_t,
            np.float64), (self._batch,)))
        if callback is not None or self._te_callbacks():
            oc, mn, mx, ns, out = _ev.propagate_stepwise(
                self, None, mdt_np, int(max_steps), callback, grid=grid_np)
            return (*self._prop_res(oc, mn, mx, ns), out)
        grid = torch.as_tensor(grid_np, device=self._device)
        hits = _ev.HitLog() if self._nt_events else None
        fwd = np.full(self._batch, grid_np[-1]) >= self.time
        res = self._pg_fn(self._state, self._pars, self._t_hi, self._t_lo,
                          grid, self._lanes(mdt_np), int(max_steps),
                          fill=0.0 if self._ev is None else float("nan"),
                          **self._ev_kw(hits))
        out = (*self._finish(res), res["out"])
        if hits is not None:
            _ev.dispatch_nt(self, hits, fwd)
        return out

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
            if self._ev is not None:
                self._ev(*args, self._t_lo, zero, self._te_cooldowns)
            else:
                self._step_fn(*args, zero)
        if "propagate_until" in drivers:
            self._pu_fn(*args, self._t_lo, self._t_hi, self._t_lo, zero, 1,
                        **self._ev_kw(None))
        if "propagate_grid" in drivers and self._ev is None:
            self._pg_fn(*args, self._t_lo,
                        self._t_hi[:1].expand(int(grid_size)).contiguous(),
                        zero, 1)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return self

    # -- pickling ------------------------------------------------------------------

    def __getstate__(self):
        """The system (and the ``var_ode_sys``, None without one), tolerance,
        ``high_accuracy``, the device's name, the events (their callbacks
        pickled with them, or the pickling fails as the JAX class's does)
        and numpy copies of the lanes (state, parameters, time, last step
        and its coefficients, cooldowns)."""
        return {
            "vsys": self._vsys, "sys": self._sys, "tol": self._tol,
            "high_accuracy": self._high_accuracy,
            "device": str(self._device),
            "t_events": self._t_events, "nt_events": self._nt_events,
            "state": self.state, "pars": self.pars,
            "t_hi": self._t_hi.cpu().numpy(), "t_lo": self._t_lo.cpu().numpy(),
            "last_h": self.last_h, "tc": self.tc,
            "cooldowns": self.te_cooldowns,
        }

    def __setstate__(self, st):
        """Rebuild on the pickled device (raises where it is absent)."""
        sys_ = st.get("vsys") or st["sys"]
        self.__init__(sys_, st["state"], pars=st["pars"], tol=st["tol"],
                      high_accuracy=st["high_accuracy"], device=st["device"],
                      t_events=st.get("t_events", ()),
                      nt_events=st.get("nt_events", ()))
        self._load_carry(st)

    def _load_carry(self, st):
        """The lanes' double-length time, last step, coefficients and
        cooldowns from :meth:`__getstate__`'s arrays."""
        dev = self._device
        self._t_hi, self._t_lo, self._last_h, self._tc = (
            torch.as_tensor(np.array(st[k], np.float64), device=dev)
            for k in ("t_hi", "t_lo", "last_h", "tc"))
        if "cooldowns" in st:
            self._te_cooldowns = torch.as_tensor(
                np.array(st["cooldowns"], np.float64), device=dev)


def taylor_adaptive_batch(sys, state, **kw) -> TaylorAdaptiveBatch:
    return TaylorAdaptiveBatch(sys, state, **kw)
