"""The scalar integrator: one trajectory, as a one-lane batch on the device.

The counterpart of ``heyoka_tpu.taylor.adaptive.TaylorAdaptive``
(``heyoka_tpu/taylor/adaptive.py:45-1042``; reference: heyoka
``taylor_adaptive<T>``, ``include/heyoka/taylor.hpp:355-670``):
``step``/``step_backward``, ``propagate_until``/
``propagate_for`` (``max_delta_t``, ``max_steps``, step callbacks,
continuous output), ``propagate_grid``, the dense output of the last step,
the state, parameters, double-length time and cooldowns with their
setters, events, variational systems (a ``var_ode_sys``, whose one-lane
batch carries it: the variational getters, ``eval_taylor_map``) and
pickling.

One integrator holds a one-lane :class:`.batch.TaylorAdaptiveBatch` on
its ``device`` (CUDA unless the caller asks for the CPU) and translates
the API: ``state`` (n,), ``pars`` (p,), ``time``/``last_h`` floats,
``dtime`` a pair of floats, ``tc`` (order+1, dim), and scalar results
``(outcome, min_h, max_h, nsteps[, ContinuousOutput])``.  So its routes
are the batch's: ``step()`` launches kernel B2 (B3 on a huge tape, B4 on
a tape with trig, Kepler or other ops outside B1/B2's rule set);
``propagate_until`` runs kernel B1 with B2 for the landing on a tape of
sum, mul, div, sqrt and pow without a time column, and the per-step
driver over the route's jet otherwise (``engine_report()``).

Events: an ``nt_event`` callback is ``cb(ta, t, d_sgn)`` and a
``t_event`` callback ``cb(ta, d_sgn) -> bool``, given this integrator, as
``heyoka_tpu/taylor/events.py:99-123`` dispatches them; the batch's
drivers call them through :class:`_ScalarEvent`.  Step callbacks are host
callables ``cb(ta) -> bool`` (given this integrator) or in-graph ones
(:mod:`..callback`, one lane's tensors).  As in the JAX class, with
pure-stop terminal events ``propagate_until`` dispatches the non-terminal
callbacks after the propagation, in time order.

Knobs: ``dtype=`` takes float64 (the default) or float32, as the batch
does (a float32 integrator runs kernel B4's f32 entry on every tape, its
events, variational system, series and interpolants too).
``backend="jax"`` and ``"auto"`` run the port's kernels on ``device``
and :attr:`backend` is ``"device"``; ``backend="native"`` runs the host
C++ runtime (:mod:`..native`, the stepper of :mod:`..native_cg`
compiled for one lane, ``W = 1``, as the JAX class builds it) through a
one-lane native batch on the host, whatever ``device`` says, and
:attr:`backend` is ``"native"``: ``step`` and ``propagate_until`` in one
host call, the grid, ``c_output`` and step callbacks through the
host-driven driver over ``step`` (``adaptive.py:512-522, 601-615`` of
the JAX package).  It raises the JAX class's RuntimeError without a
working compiler and its ValueError for float32 or events.  Departure:
the JAX ``"auto"`` picks the native runtime where it is available
(``adaptive.py:151-177``); the port has no auto-detection, and its
``"auto"`` is the device.  ``compact_mode=`` is accepted and has no
effect: the port has one device engine.  Unlike the JAX class, whose
getters return host arrays of a device computation too, each getter here
copies from the device.
"""

from __future__ import annotations

import math as _pymath

import numpy as np

from ..convert import check_dtype, numpy_dtype
from ..dfloat import dd_add_d, dd_add_dd
from ..callback import is_in_graph
from ..logging import host_read, trace_ctx
from .batch import TaylorAdaptiveBatch
from .continuous import ContinuousOutput
from .events import t_event
from ..varsys import var_ode_sys


class _ScalarEvent:
    """A scalar integrator's event as its one-lane batch sees it: the
    user's event (its expression, direction and cooldown) with a callback
    in the batch drivers' signature that hands the user's callback the
    scalar integrator, looked up at each call; None where the user's is
    None (pure-stop terminal events keep the batch's device driver)."""

    def __init__(self, ev, ta):
        self._ev, self._ta = ev, ta
        self._terminal = isinstance(ev, t_event)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._ev, name)

    @property
    def callback(self):
        cb, ta = self._ev.callback, self._ta
        if cb is None:
            return None
        if self._terminal:
            return lambda tb, d_sgn, lane: cb(ta, d_sgn)
        return lambda tb, t, d_sgn, lane: cb(ta, t, d_sgn)


class _LaneCallback:
    """An in-graph step callback handed to the one-lane batch without its
    ``pre_hook``, which the scalar integrator runs with itself."""

    in_graph = True

    def __init__(self, cb):
        self._cb = cb

    def __call__(self, *args):
        return self._cb(*args)


class TaylorAdaptive:
    """Adaptive Taylor integrator of one trajectory (heyoka
    ``taylor_adaptive``): ``tol`` (default the dtype's epsilon),
    ``high_accuracy``, ``pars``, ``time``, ``t_events``/``nt_events``,
    ``device``; ``dtype``, ``compact_mode`` and ``backend`` as in the
    module's docstring."""

    def __init__(self, sys, state, *, time=0.0, pars=None, tol=None,
                 high_accuracy=False, compact_mode=False, dtype=np.float64,
                 t_events=(), nt_events=(), backend="jax", device="cuda"):
        npd = numpy_dtype(check_dtype(dtype))
        if backend not in ("jax", "native", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        # a var_ode_sys integrates its augmented system; given the original
        # initial conditions only, the variational ones are filled in
        # (``heyoka_tpu/taylor/adaptive.py:69-82``)
        state = np.asarray(state, dtype=npd)
        if isinstance(sys, var_ode_sys):
            if state.shape == (sys.n_orig,):
                state = sys.initial_state(state, pars=pars, t0=float(time))
            n_eq = len(sys.sys)
        else:
            sys = list(sys)
            n_eq = len(sys)
        if state.shape != (n_eq,):
            raise ValueError(
                f"state must have shape ({n_eq},), got {state.shape}")
        self._compact_mode = bool(compact_mode)
        self._t_events, self._nt_events = list(t_events), list(nt_events)
        self._event_stop = False
        self._tstate = None
        self._tb = TaylorAdaptiveBatch(
            sys, state[None], device=device, time=float(time),
            pars=None if pars is None else np.asarray(
                pars, npd).reshape(1, -1),
            tol=tol, high_accuracy=high_accuracy, dtype=npd,
            t_events=self._lane_events(self._t_events),
            nt_events=self._lane_events(self._nt_events), backend=backend,
            _cg_width=1)

    def _lane_events(self, evs):
        return [_ScalarEvent(ev, self) for ev in evs]

    @classmethod
    def _copy_of(cls, ta):
        """A working copy of ``ta`` (its system, tolerance, events and
        lanes) on ``ta``'s jet tape: no decomposition, no packing (the
        ensembles' per-instance fallback)."""
        new = cls.__new__(cls)
        new.__dict__.update(ta.__dict__)
        new._t_events, new._nt_events = list(ta._t_events), \
            list(ta._nt_events)
        new._event_stop = False
        new._tstate = None
        tb = ta._tb
        new._tb = TaylorAdaptiveBatch._sharing(
            tb, tb.state, pars=tb.pars, time=tb.time,
            t_events=new._lane_events(new._t_events),
            nt_events=new._lane_events(new._nt_events))
        return new

    # -- introspection --------------------------------------------------------

    @property
    def sys(self):
        return list(self._tb.sys)

    # -- variational API (``heyoka_tpu/taylor/adaptive.py:202-252``) ---------

    def is_variational(self) -> bool:
        return self._tb.is_variational

    def _check_variational(self, fname):
        if not self._tb.is_variational:
            raise ValueError(f"'{fname}()' cannot be invoked on "
                             "non-variational integrators")

    def get_vargs(self):
        self._check_variational("get_vargs")
        return self._tb.get_vargs()

    def get_vorder(self) -> int:
        self._check_variational("get_vorder")
        return self._tb.get_vorder()

    def get_vslice(self, order: int, component: int | None = None) -> slice:
        self._check_variational("get_vslice")
        return self._tb.get_vslice(order, component)

    def get_mindex(self, i: int):
        self._check_variational("get_mindex")
        return self._tb.get_mindex(i)

    def eval_taylor_map(self, s) -> np.ndarray:
        """Evaluate the Taylor map of the flow at the deviations ``s``
        (n_vargs,) of the variational arguments (reference
        ``eval_taylor_map``, ``taylor_adaptive.cpp:2013``); returns the
        (n_orig,) mapped state."""
        self._check_variational("eval_taylor_map")
        s = np.asarray(s, dtype=self.dtype)
        K = len(self._tb.get_vargs())
        if s.shape != (K,):
            raise ValueError(f"expected {K} deviation values, got {s.shape}")
        self._tstate = self._tb.eval_taylor_map(s[None])[0]
        return self._tstate

    def get_tstate(self) -> np.ndarray:
        """The last :meth:`eval_taylor_map` result, zeros before it."""
        self._check_variational("get_tstate")
        if getattr(self, "_tstate", None) is None:
            self._tstate = np.zeros((self.get_n_orig_sv(),), self.dtype)
        return self._tstate

    def get_n_orig_sv(self) -> int:
        """Number of original (non-variational) state variables (reference
        ``get_n_orig_sv``)."""
        return self._tb.get_n_orig_sv()

    def engine_report(self) -> dict:
        """The one-lane batch's :meth:`.batch.TaylorAdaptiveBatch.
        engine_report`."""
        return self._tb.engine_report()

    def assert_engine(self, **expected):
        self._tb.assert_engine(**expected)
        return self

    @property
    def decomposition(self):
        return self._tb.decomposition

    @property
    def order(self) -> int:
        return self._tb.order

    @property
    def tol(self) -> float:
        return self._tb.tol

    @property
    def dim(self) -> int:
        return self._tb.dim

    @property
    def high_accuracy(self) -> bool:
        return self._tb.high_accuracy

    @property
    def compact_mode(self) -> bool:
        return self._compact_mode

    @property
    def backend(self) -> str:
        """``"device"`` (the port's kernels) or ``"native"`` (the host
        runtime)."""
        return self._tb.backend

    @property
    def dtype(self) -> np.dtype:
        return self._tb.dtype

    @property
    def device(self):
        return self._tb._device

    @property
    def state(self) -> np.ndarray:
        return host_read("hy.sync.state", self._tb._state[0].cpu).numpy()

    @state.setter
    def state(self, v):
        v = np.asarray(v, dtype=self.dtype)
        if v.shape != (self.dim,):
            raise ValueError("bad state shape")
        self._tb.state = v[None]

    @property
    def pars(self) -> np.ndarray:
        return self._tb._pars[0].cpu().numpy()

    @pars.setter
    def pars(self, v):
        self._tb.pars = np.asarray(v, self.dtype).reshape(1, -1)

    @property
    def time(self) -> float:
        hi, lo = self.dtime
        return hi + lo

    @time.setter
    def time(self, v):
        self._tb.set_time(float(v))

    @property
    def dtime(self) -> tuple:
        """The (hi, lo) double-length time (heyoka ``get_dtime``)."""
        hi, lo = self._tb.dtime
        return float(hi[0]), float(lo[0])

    def set_dtime(self, hi: float, lo: float):
        """Set the double-length time, renormalized; raises
        ``ValueError`` unless both parts are finite (heyoka
        ``set_dtime``)."""
        self._tb.set_dtime(float(hi), float(lo))

    @property
    def last_h(self) -> float:
        return float(self._tb._last_h[0])

    @property
    def tc(self) -> np.ndarray:
        """Taylor coefficients of the last step, shape (order+1, dim)."""
        return self._tb._tc[0, :, :self.dim].cpu().numpy()

    @property
    def with_events(self) -> bool:
        return bool(self._t_events or self._nt_events)

    @property
    def t_events(self):
        return list(self._t_events)

    @property
    def nt_events(self):
        return list(self._nt_events)

    @property
    def te_cooldowns(self) -> np.ndarray:
        """The terminal events' cooldowns (heyoka ``get_te_cooldowns``; 0
        inactive)."""
        return self._tb.te_cooldowns[0]

    def reset_cooldowns(self):
        """Zero every terminal-event cooldown (heyoka
        ``reset_cooldowns``)."""
        self._tb.reset_cooldowns()

    # -- stepping -------------------------------------------------------------

    def step(self, max_delta_t=None, write_tc: bool = False):
        """One adaptive step forward, at most ``max_delta_t``; returns
        ``(outcome, h)`` (the outcome of a step a terminal event stopped is
        the event's index).  ``write_tc`` is accepted and changes nothing:
        :attr:`tc` is always kept, as in the JAX class."""
        if max_delta_t is None:
            max_delta_t = _pymath.inf
        return self._do_step(float(max_delta_t))

    def step_backward(self, max_delta_t=None):
        if max_delta_t is None:
            max_delta_t = _pymath.inf
        return self._do_step(-abs(float(max_delta_t)))

    def _do_step(self, max_dt: float):
        """The one lane's step in a ``hy.step`` span (:mod:`..logging`),
        the batch's own left out."""
        with trace_ctx("hy.step"):
            tb = self._tb
            tb._step(max_dt)
            self._event_stop = bool(tb._event_stop[0])
            oc, h = tb._last_res[0]
            return oc, float(h)

    # -- propagation ----------------------------------------------------------

    def _lane_callback(self, callback):
        """A step callback in the batch's terms: an in-graph one after its
        ``pre_hook`` with this integrator, a host ``cb(ta)`` given this
        integrator."""
        if callback is None:
            return None
        if is_in_graph(callback):
            if hasattr(callback, "pre_hook"):
                callback.pre_hook(self)
            return _LaneCallback(callback)
        return lambda tb: callback(self)

    def _result(self, res):
        oc, mn, mx, ns = res[:4]
        self._event_stop = bool(self._tb._event_stop[0])
        return oc[0], float(mn[0]), float(mx[0]), int(ns[0])

    def propagate_until(self, t, *, max_delta_t=None, max_steps=0,
                        callback=None, c_output=False):
        """Propagate to time ``t``; returns ``(outcome, min_h, max_h,
        nsteps)``, with ``c_output`` a :class:`.continuous.ContinuousOutput`
        last (its records on the device).  ``callback``: a step callback
        (host or in-graph), after every step; False stops with
        ``cb_stop``."""
        res = self._tb.propagate_until(
            float(t), max_delta_t=max_delta_t, max_steps=max_steps,
            c_output=c_output, callback=self._lane_callback(callback))
        out = self._result(res)
        if c_output:
            out = (*out, self._scalar_cout(res[4]))
        return out

    def _scalar_cout(self, co) -> ContinuousOutput:
        """The one lane of a :class:`.continuous.ContinuousOutputBatch`,
        its records left on the device."""
        n = int(co.n_steps[0])
        return ContinuousOutput(
            co._times_hi[0, :n + 1], co._times_lo[0, :n + 1],
            co._tcs[0, :n], self.order, self.dim, bool(co._fwd[0]),
            device=self.device)

    def propagate_for(self, delta_t, **kw):
        """Propagate for ``delta_t`` from the current time (heyoka
        ``propagate_for``): the target is the double-length sum, rounded
        to one f64, as the JAX class takes it."""
        hi, lo = dd_add_d(*self.dtime, float(delta_t))
        return self.propagate_until(hi + lo, **kw)

    def propagate_grid(self, grid, *, max_delta_t=None, max_steps=0,
                       callback=None):
        """The states at the points of a strictly monotonic time ``grid``;
        returns ``(outcome, min_h, max_h, nsteps, out (len(grid), dim))``.
        Rows not reached are zeros, or NaN with events or a callback, as in
        the JAX class."""
        grid = np.asarray(grid, dtype=self.dtype)
        if grid.ndim != 1 or grid.size == 0:
            raise ValueError("grid must be a non-empty 1-D array")
        d = np.diff(grid)
        if grid.size > 1 and not ((d > 0).all() or (d < 0).all()):
            raise ValueError("grid must be strictly monotonic")
        res = self._tb.propagate_grid(
            grid, max_delta_t=max_delta_t, max_steps=max_steps,
            callback=self._lane_callback(callback))
        return (*self._result(res), res[4][0])

    # -- dense output ---------------------------------------------------------

    def update_d_output(self, t, rel_time: bool = False) -> np.ndarray:
        """The dense output of the last step at time ``t`` (relative to the
        step's start with ``rel_time``), by Horner over :attr:`tc` on the
        device; the step's start and ``t - start`` in double length, as
        the JAX class takes them."""
        if rel_time:
            rel = float(t)
        else:
            sh, sl = dd_add_d(*self.dtime, -self.last_h)
            rh, rl = dd_add_dd(float(t), 0.0, -sh, -sl)
            rel = rh + rl
        self._d_output = self._tb.update_d_output(rel, rel_time=True)[0]
        return self._d_output

    @property
    def d_output(self) -> np.ndarray:
        """The last dense output computed by :meth:`update_d_output`
        (zeros before the first call)."""
        if not hasattr(self, "_d_output"):
            self._d_output = np.zeros((self.dim,), self.dtype)
        return self._d_output

    # -- pickling -------------------------------------------------------------

    def __getstate__(self):
        """The system (and the ``var_ode_sys``, None without one),
        tolerance, flags, the device's name, the events (their callbacks
        pickled with them, or the pickling fails as the JAX class's does)
        and numpy copies of the lane."""
        tb = self._tb
        hi, lo = self.dtime
        return {
            "vsys": tb._vsys, "sys": tb.sys, "tol": tb.tol,
            "high_accuracy": tb.high_accuracy, "dtype": self.dtype.name,
            "compact_mode": self._compact_mode, "device": str(tb._device),
            "backend": tb._backend_setting,
            "t_events": self._t_events, "nt_events": self._nt_events,
            "state": self.state, "pars": self.pars, "t_hi": hi, "t_lo": lo,
            "last_h": self.last_h, "tc": tb.tc[0],
            "cooldowns": self.te_cooldowns, "event_stop": self._event_stop,
        }

    def __setstate__(self, st):
        """Rebuild on the pickled device (raises where it is absent)."""
        self.__init__(st.get("vsys") or st["sys"], st["state"],
                      pars=st["pars"], tol=st["tol"],
                      high_accuracy=st["high_accuracy"],
                      compact_mode=st["compact_mode"], device=st["device"],
                      t_events=st["t_events"], nt_events=st["nt_events"],
                      dtype=st.get("dtype", "float64"),
                      backend=st.get("backend", "jax"))
        self._tb._load_carry(dict(
            t_hi=[st["t_hi"]], t_lo=[st["t_lo"]], last_h=[st["last_h"]],
            tc=np.asarray(st["tc"])[None],
            cooldowns=np.asarray(st["cooldowns"])[None]))
        self._event_stop = st["event_stop"]

    def __repr__(self):
        return (f"TaylorAdaptive(order={self.order}, tol={self.tol}, "
                f"dim={self.dim}, time={self.time}, "
                f"dtype={self.dtype.name}, "
                f"high_accuracy={self.high_accuracy}, "
                f"device={self.device})")


def taylor_adaptive(sys, state, **kw) -> TaylorAdaptive:
    """Build a :class:`TaylorAdaptive` (heyoka's ``taylor_adaptive<T>{...}``
    constructor)."""
    return TaylorAdaptive(sys, state, **kw)
