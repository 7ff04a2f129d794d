"""The batch integrator: many trajectories of one ODE system, one per lane.

The counterpart of ``heyoka_tpu.taylor.batch.TaylorAdaptiveBatch``
(reference: heyoka ``taylor_adaptive_batch``, ``include/heyoka/
taylor.hpp:781-1121``) for the port's first slice: the constructor,
``step``, ``propagate_until``/``propagate_for``, the per-lane state and
double-length time, ``get_step_res``/``get_propagate_res`` and
``engine_report``.

Every tensor lives on the ``device`` given to the constructor.  On a CUDA
device ``step`` launches kernel B2 and ``propagate_until`` kernel B1 (with
B2 for the exact landing steps); on the CPU the plain twins run.  A tape
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

from ..convert import JET_OPS, plan_to_arrays, state_from_numpy
from ..expr.core import Variable, expr
from ..expr.decompose import Tape, taylor_decompose_sys
from ..dfloat import dd_add_d
from . import stepper as _st
from .compact import build_plan
from .compact_flat import make_batched_step_flat, make_propagate_until_flat
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


class TaylorAdaptiveBatch:
    def __init__(self, sys, state, *, device, time=None, pars=None, tol=None,
                 high_accuracy=False):
        self._device = torch.device(device)
        sys = _normalize_sys(sys)
        tol = float(np.finfo(np.float64).eps if tol is None else tol)
        self._order = _st.taylor_order_from_tol(tol)
        high_accuracy = bool(high_accuracy)
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
        fused engine) and ``layout``, the block layout of kernels B1/B2 on
        this tape (``jet_kernels.layout_report``) or of kernel B3 on a huge
        one (``jet_rolled.layout_report``; the CPU names the one the card
        would run), None on the B4 route."""
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
            layout=None if self._phase else rolled_layout(self._jtape)
            if self._rolled else layout_report(self._jtape),
        )

    @property
    def order(self) -> int:
        return self._order

    @property
    def dim(self) -> int:
        return self._tape.n_eq

    @property
    def state(self) -> np.ndarray:
        return self._state.cpu().numpy()

    @property
    def time(self) -> np.ndarray:
        return (self._t_hi + self._t_lo).cpu().numpy()

    @property
    def dtime(self) -> tuple:
        """Per-lane (hi, lo) double-length times."""
        return self._t_hi.cpu().numpy(), self._t_lo.cpu().numpy()

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

    def step(self, max_delta_t=None):
        """One adaptive step in every lane; per-lane ``(outcome, h)`` via
        :meth:`get_step_res`."""
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

    def get_step_res(self):
        return list(self._last_res)

    def get_propagate_res(self):
        """Per-lane ``(outcome, min_h, max_h, nsteps)`` of the last
        ``propagate_*`` call."""
        if self._last_prop_res is None:
            raise ValueError("no propagate_* call has completed yet")
        return list(self._last_prop_res)

    def propagate_until(self, t, *, max_delta_t=None, max_steps=0):
        """Propagate every lane to time ``t`` (scalar or per lane); returns
        ``(outcomes, min_h, max_h, nsteps)`` per lane."""
        target = self._lanes(t)
        mdt = self._lanes(_pymath.inf if max_delta_t is None else max_delta_t)
        res = self._pu_fn(self._state, self._pars, self._t_hi, self._t_lo,
                          target, torch.zeros_like(target), mdt,
                          int(max_steps))
        self._state = res["state"].contiguous()
        self._t_hi, self._t_lo = res["t_hi"], res["t_lo"]
        self._last_h, self._tc = res["last_h"], res["tc"]
        # one host copy per field, then plain Python lists: iterating a
        # tensor lane by lane costs microseconds per lane
        oc = [TaylorOutcome(o) for o in res["outcome"].tolist()]
        self._last_res = list(zip(oc, res["last_h"].tolist()))
        mn, mx, ns = (res[k].cpu().numpy() for k in ("min_h", "max_h",
                                                     "nsteps"))
        self._last_prop_res = list(zip(oc, mn.tolist(), mx.tolist(),
                                       ns.tolist()))
        return oc, mn, mx, ns

    def propagate_for(self, delta_t, **kw):
        target = self.time + np.broadcast_to(
            np.asarray(delta_t, dtype=np.float64), (self._batch,))
        return self.propagate_until(target, **kw)


def taylor_adaptive_batch(sys, state, **kw) -> TaylorAdaptiveBatch:
    return TaylorAdaptiveBatch(sys, state, **kw)
