"""The batched adaptive step over the jet, and the per-step
propagate-until and propagate-grid drivers.

The counterpart of ``heyoka_tpu/taylor/compact_flat.py``:
``make_batched_step_flat`` (:168), ``make_propagate_until_flat`` (:1157),
its lockstep loop ``_pu_while`` (:1214) and ``make_propagate_grid_flat``
(:1571).  The JAX step evaluates the
jet in XLA (or in a Pallas kernel) and then the step size and the state
update; here the jet is the one passed in — ``jet_kernels.jet`` (kernel
B2) or, for huge tapes, ``jet_rolled.jet_rolled`` (kernel B3), each
launching its kernel on a CUDA tensor and running its plain twin on a CPU
tensor — and the rest is plain torch on the same device, in the lane
state's dtype (f64, or f32 for a float32 integrator, whose double-length
time is an f32 pair).  There is one engine: the TPU layouts, the staged buffers,
the mixed-precision phase and the coefficient scaling have no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..callback import apply as apply_callback
from ..dfloat import dd_add_d, dd_add_dd
from ..logging import host_read, trace_ctx
from .jet_kernels import JetTape, jet
from .outcome import TaylorOutcome
from .stepper import ceval_update, h_from_norms, horner, horner_update


def make_batched_step_flat(tape: JetTape, *, high_accuracy: bool = True,
                           jet=jet):
    """Whole-batch adaptive Taylor step over ``jet`` (a function with the
    contract of :func:`.jet_kernels.jet`): ``step(states (B, n), pars
    (B, p), t (B,), max_dt (B,)) -> (new_states (B, n), h (B,), tc (B,
    K+1, n))``, the JAX step's ``return_tc=True`` contract."""
    K, n_eq = tape.order, tape.n_eq
    update = ceval_update if high_accuracy else horner_update

    def step(states, pars, t, max_dt):
        tcs, norms = jet(tape, states.T.contiguous(), pars.T.contiguous(),
                         t.contiguous())
        h = h_from_norms(norms[2], norms[0], norms[1], K, max_dt)
        tc = tcs.permute(1, 0, 2)  # (K+1, n_eq, B)
        new = update(tc, h, K, n_eq)
        return new.T, h, tcs.permute(2, 1, 0)

    return step


def _carry(tape: JetTape, state, t_hi, t_lo, done, ev=None, cooldowns=None,
           last_h=None, tc=None):
    """The initial carry of the per-step drivers: the lanes, zero
    statistics, the outcome ``time_limit`` and ``done``; with an event
    step ``ev``, the width of its coefficients (the event columns kept),
    the terminal events' ``cooldowns`` and ``te_sgn``.  ``last_h`` and
    ``tc`` seed what a lane that takes no step returns (zeros where
    None)."""
    B = state.shape[0]
    dev, f64 = state.device, state.dtype
    n_tc = tape.n_eq + (tape.n_out if ev is not None else 0)
    c = dict(
        state=state, t_hi=t_hi, t_lo=t_lo,
        last_h=torch.zeros(B, dtype=f64, device=dev) if last_h is None
        else last_h,
        tc=torch.zeros((B, tape.order + 1, n_tc), dtype=f64, device=dev)
        if tc is None else tc,
        nsteps=torch.zeros(B, dtype=torch.int64, device=dev),
        min_h=torch.full((B,), float("inf"), dtype=f64, device=dev),
        max_h=torch.zeros(B, dtype=f64, device=dev),
        outcome=torch.full((B,), int(TaylorOutcome.time_limit),
                           dtype=torch.int32, device=dev),
        done=done,
    )
    if ev is not None:
        c["cooldowns"] = cooldowns
        c["te_sgn"] = torch.zeros(B, dtype=torch.int32, device=dev)
    return c


def make_propagate_until_flat(tape: JetTape, *, high_accuracy: bool = True,
                              jet=jet, ev=None):
    """Lockstep propagate-until over :func:`make_batched_step_flat` with
    ``jet``, or over the event step ``ev``
    (``events_impl.build_event_step_batch``):
    ``pu(state (B, n), pars (B, p), t_hi, t_lo, target_hi, target_lo,
    max_delta_t, max_steps, record=None, *, cooldowns=None, last_h=None,
    tc=None, hits=None, hook=None) -> dict`` of per-lane fields
    (``state``, ``t_hi``, ``t_lo``, ``last_h``, ``tc``, ``nsteps``,
    ``min_h``, ``max_h``, ``outcome``, ``done``; with events also
    ``cooldowns`` and ``te_sgn``); ``record``, ``hits`` and ``hook`` as
    in :func:`_pu_while`, ``last_h`` and ``tc`` as in :func:`_carry`."""
    step = make_batched_step_flat(tape, high_accuracy=high_accuracy,
                                  jet=jet)

    def pu(state, pars, t_hi, t_lo, target_hi, target_lo, max_delta_t,
           max_steps, record=None, *, cooldowns=None, last_h=None, tc=None,
           hits=None, hook=None):
        rem0, _ = dd_add_dd(target_hi, target_lo, -t_hi, -t_lo)
        init = _carry(tape, state, t_hi, t_lo, rem0 == 0.0, ev, cooldowns,
                      last_h, tc)
        return _pu_while(step, pars, target_hi, target_lo, max_delta_t,
                         max_steps, rem0 > 0.0, init, record, ev=ev,
                         hits=hits, hook=hook)

    return pu


def _advance(step, ev, c, pars, dt):
    """One lockstep step from the carry ``c``: ``(new_state, h, tc, t_hi,
    t_lo, res)``, with ``res`` the event step's result (None for the
    plain ``step``)."""
    if ev is None:
        new_state, h, tc = step(c["state"], pars, c["t_hi"], dt)
        nt_hi, nt_lo = dd_add_d(c["t_hi"], c["t_lo"], h)
        return new_state, h, tc, nt_hi, nt_lo, None
    res = ev(c["state"], pars, c["t_hi"], c["t_lo"], dt, c["cooldowns"])
    return (res["state"], res["last_h"], res["tc"], res["t_hi"],
            res["t_lo"], res)


def _lane_end(res, keep, finite, hit_step_limit, reached, hits, alive):
    """The outcome of a step and the lanes it ends: a non-finite step
    (``err_nf_state``), then a terminal event (its index), then a callback
    that returned False (``cb_stop``), then the step limit, else
    ``time_limit``; the lanes that reached their target end too.  Logs
    the step's non-terminal hits of the live lanes to ``hits``.  Returns
    ``(outcome, done)``."""
    outcome = torch.full_like(finite, int(TaylorOutcome.time_limit),
                              dtype=torch.int32)
    outcome.masked_fill_(hit_step_limit, int(TaylorOutcome.step_limit))
    done = ~finite | hit_step_limit | reached
    if keep is not None:
        outcome.masked_fill_(~keep, int(TaylorOutcome.cb_stop))
        done = done | ~keep
    if res is not None:
        te_hit = res["te_idx"] >= 0
        outcome = torch.where(te_hit, res["te_idx"], outcome)
        done = done | te_hit
        if hits is not None:
            hits.add(res["nt_mask"] & (alive & finite)[:, None],
                     res["nt_times"], res["nt_sgn"])
    outcome.masked_fill_(~finite, int(TaylorOutcome.err_nf_state))
    return outcome, done


def _callback(hook, new_state, pars, t_hi, t_lo, h, tc):
    """An in-graph step callback ``hook(state, pars, t_hi, t_lo, h, tc) ->
    (state, keep)`` after a step, run per lane (``callback.apply``): the
    states it returns and its ``keep`` as a ``(B,)`` bool tensor (None
    without a hook)."""
    if hook is None:
        return new_state, None
    return apply_callback(hook, new_state, pars, t_hi, t_lo, h, tc)


def _pu_while(step, pars, target_hi, target_lo, max_delta_t, max_steps,
              fwd, c, record=None, *, ev=None, hits=None, hook=None,
              step_span="hy.pu.step"):
    """The lockstep propagate-until loop over a batched ``step``, or over
    the event step ``ev``, from the carry ``c`` (:func:`_carry`).  Shared
    with the fused driver (:mod:`.fused`), whose exact landing enters
    mid-flight with the kernel's state, time and statistics.  One host
    sync per step (the loop's exit test, a ``hy.sync.pu_done`` span), each
    step a ``step_span`` span (:mod:`..logging`) holding the sync after
    it.  With a list ``record``, each
    step appends the whole batch's ``(tc (B, K+1, n), t_hi, t_lo)``, the
    coefficients and the start time of the step, on the device (the
    continuous-output recorder, :mod:`.continuous`).

    With ``ev``: a terminal event ends its lane at the truncated step with
    the event's index as the outcome, the cooldowns and the crossing's
    sign (``te_sgn``) are carried, and ``hits`` (``events.HitLog``) logs
    the non-terminal hits (the JAX ``events.make_propagate_until_ev_batch``
    lockstep loop, ``events.py:312``).  ``hook``, a step callback (see
    :func:`_callback`), runs after every step; a lane whose ``keep`` is
    False ends with ``cb_stop`` (the JAX loop engine's
    ``step_callback``)."""
    c = dict(c)

    def remaining(th, tl):
        rh, _ = dd_add_dd(target_hi, target_lo, -th, -tl)
        return rh

    def all_done():
        return host_read("hy.sync.pu_done", c["done"].all().item)

    finished = all_done()
    while not finished:
        with trace_ctx(step_span):
            done = c["done"]
            rem = remaining(c["t_hi"], c["t_lo"])
            cap = torch.minimum(torch.abs(rem), max_delta_t)
            # finished lanes step with dt = 0 (their results are masked
            # out)
            cap = torch.where(done, torch.zeros_like(cap), cap)
            dt = torch.where(fwd, cap, -cap)

            new_state, h, tc, nt_hi, nt_lo, res = _advance(step, ev, c, pars,
                                                           dt)
            if record is not None:
                record.append((tc, c["t_hi"], c["t_lo"]))

            finite = torch.isfinite(new_state).all(1) & torch.isfinite(h)
            new_state, keep = _callback(hook, new_state, pars, nt_hi, nt_lo,
                                        h, tc)
            nsteps = c["nsteps"] + 1
            rem_after = remaining(nt_hi, nt_lo)
            reached = torch.where(fwd, rem_after <= 0.0, rem_after >= 0.0)
            hit_step_limit = (nsteps >= max_steps) & ~reached \
                if max_steps > 0 else torch.zeros_like(reached)
            alive = ~done
            outcome, ended = _lane_end(res, keep, finite, hit_step_limit,
                                       reached, hits, alive)

            def sel(new, old):
                return torch.where(alive, new, old)

            abs_h = torch.abs(h)
            c_new = dict(
                state=torch.where(alive[:, None], new_state, c["state"]),
                t_hi=sel(nt_hi, c["t_hi"]),
                t_lo=sel(nt_lo, c["t_lo"]),
                last_h=sel(h, c["last_h"]),
                tc=torch.where(alive[:, None, None], tc, c["tc"]),
                nsteps=sel(nsteps, c["nsteps"]),
                min_h=sel(torch.minimum(c["min_h"], abs_h), c["min_h"]),
                max_h=sel(torch.maximum(c["max_h"], abs_h), c["max_h"]),
                outcome=sel(outcome, c["outcome"]),
                done=sel(ended, done),
            )
            if res is not None:
                _ev_carry(c_new, c, res, alive)
            c = c_new
            finished = all_done()
    return c


def _ev_carry(c_new, c, res, alive):
    """The event step's carried fields: the cooldowns and, where a
    terminal event ended the step, the crossing's sign."""
    c_new["cooldowns"] = torch.where(alive[:, None], res["cooldowns"],
                                     c["cooldowns"])
    c_new["te_sgn"] = torch.where(alive & (res["te_idx"] >= 0),
                                  res["te_sgn"], c["te_sgn"])


def make_propagate_grid_flat(tape: JetTape, *, high_accuracy: bool = True,
                             jet=jet, ev=None):
    """Lockstep propagate-grid over :func:`make_batched_step_flat` with
    ``jet``, or over the event step ``ev``: ``pg(state (B, n), pars (B,
    p), t_hi, t_lo, grid (ngrid,), max_delta_t, max_steps, *,
    cooldowns=None, last_h=None, tc=None, hits=None, fill=0.0) -> dict``
    with the fields of :func:`make_propagate_until_flat`'s result and
    ``out (B, ngrid, n)``, the state at every grid point (``fill`` where a
    lane stopped first: zeros by default, NaN as the JAX class fills them
    with events, ``batch.py:1715``).  With ``ev`` a terminal event ends
    its lane after the grid points inside its truncated step, and
    ``hits`` logs the non-terminal hits, as in :func:`_pu_while`.

    The JAX driver's rules (``compact_flat.py:1571-1741``): grid points
    equal to a lane's start time take its state; the step is capped by
    ``grid[-1] - t_hi`` in single f64; a grid point inside a step's span
    takes the step's Taylor polynomials at the high part of ``grid - t``
    (double-length); a lane is done when its last grid point is filled, on
    a non-finite state or at the step limit.  The grid is shared and
    monotonic (:func:`check_grid`); a lane whose direction of travel goes
    against the grid's order reaches no point and, without a step limit,
    raises ``ValueError``.  One host sync per step: the exit
    test and the most grid points any lane filled, after which one Horner
    over ``(B, m)`` points fills them."""
    step = make_batched_step_flat(tape, high_accuracy=high_accuracy,
                                  jet=jet)
    K, n_eq = tape.order, tape.n_eq

    def pg(state, pars, t_hi, t_lo, grid, max_delta_t, max_steps, *,
           cooldowns=None, last_h=None, tc=None, hits=None, fill=0.0):
        B, ngrid = state.shape[0], grid.shape[0]
        dev, f64 = state.device, state.dtype
        lanes = torch.arange(B, device=dev)
        target = grid[-1]
        fwd = target - t_hi >= 0.0
        # a forward lane fills the grid points <= its time, a backward one
        # those >= it: on a grid sorted the lane's way a prefix of the grid
        # (binary search); a lane going against the grid's order stops at
        # grid[-1] and never reaches grid[0], so it fills nothing
        s = 1.0 if bool(grid[-1] >= grid[0]) else -1.0
        key = s * grid
        along = fwd == (s > 0)

        def cursor(gi, t):
            prefix = torch.searchsorted(key, (s * t)[:, None],
                                        right=True)[:, 0]
            return torch.where(along, torch.maximum(gi, prefix), gi)

        # row ngrid takes the writes of the lanes that fill fewer points
        out = torch.full((B, ngrid + 1, n_eq), fill, dtype=f64, device=dev)
        # leading grid points equal to the start time take the state
        lead = (grid[None, :] == t_hi[:, None]).to(torch.int64).cumprod(1)
        gi = lead.sum(1)
        out[:, :ngrid] = torch.where(lead.bool()[:, :, None], state[:, None],
                                     out[:, :ngrid])
        c = _carry(tape, state, t_hi, t_lo, gi >= ngrid, ev, cooldowns,
                   last_h, tc)
        c["gi"] = gi
        all_done, stuck = torch.stack([c["done"].all(),
                                       (~along & ~c["done"]).any()]).tolist()
        if stuck and max_steps <= 0:
            # the JAX driver would step such a lane forever
            raise ValueError("a lane goes against the grid's order: it can "
                             "reach no grid point (pass max_steps to let "
                             "it stop)")
        while not all_done:
            done, gi = c["done"], c["gi"]
            alive = ~done
            cap = torch.minimum(torch.abs(target - c["t_hi"]), max_delta_t)
            cap = torch.where(alive, cap, torch.zeros_like(cap))
            dt = torch.where(fwd, cap, -cap)

            new_state, h, tc, nt_hi, nt_lo, res = _advance(step, ev, c, pars,
                                                           dt)
            finite = torch.isfinite(new_state).all(1) & torch.isfinite(h)
            new_gi = torch.where(finite & alive, cursor(gi, nt_hi), gi)

            nsteps = c["nsteps"] + 1
            reached = new_gi >= ngrid
            hit_step_limit = (nsteps >= max_steps) & ~reached \
                if max_steps > 0 else torch.zeros_like(reached)
            outcome, ended = _lane_end(res, None, finite, hit_step_limit,
                                       reached, hits, alive)

            def sel(new, old):
                return torch.where(alive, new, old)

            abs_h = torch.abs(h)
            t_prev_hi, t_prev_lo = c["t_hi"], c["t_lo"]
            c_new = dict(
                state=torch.where(alive[:, None], new_state, c["state"]),
                t_hi=sel(nt_hi, c["t_hi"]),
                t_lo=sel(nt_lo, c["t_lo"]),
                last_h=sel(h, c["last_h"]),
                tc=torch.where(alive[:, None, None], tc, c["tc"]),
                nsteps=sel(nsteps, c["nsteps"]),
                min_h=sel(torch.minimum(c["min_h"], abs_h), c["min_h"]),
                max_h=sel(torch.maximum(c["max_h"], abs_h), c["max_h"]),
                outcome=sel(outcome, c["outcome"]),
                done=sel(ended, done),
                gi=new_gi,
            )
            if res is not None:
                _ev_carry(c_new, c, res, alive)
            c = c_new
            n_fill = new_gi - gi
            all_done, m = torch.stack([c["done"].all().to(torch.int64),
                                       n_fill.max()]).tolist()
            if m:
                j = torch.arange(m, device=dev)
                idx = gi[:, None] + j
                tg = grid[idx.clamp(max=ngrid - 1)]
                rel, _ = dd_add_dd(tg, torch.zeros_like(tg),
                                   -t_prev_hi[:, None], -t_prev_lo[:, None])
                idx = torch.where(j < n_fill[:, None], idx, ngrid)
                out[lanes[:, None], idx] = horner(
                    lambda i: tc[:, i, None, :n_eq], rel, K)
        c["out"] = out[:, :ngrid]
        return c

    return pg


def check_grid(grid, dtype=np.float64):
    """``grid`` as a non-empty 1-D numpy array of ``dtype`` (the lanes'),
    monotonic (non-decreasing or non-increasing): the grid driver finds
    each lane's next point by binary search.  Raises ``ValueError``
    otherwise."""
    grid = np.asarray(grid, dtype=dtype)
    if grid.ndim != 1 or grid.size == 0:
        raise ValueError("the grid must be a non-empty 1-D array")
    if not np.isfinite(grid).all():
        raise ValueError("the grid must be finite")
    d = np.diff(grid)
    if not ((d >= 0).all() or (d <= 0).all()):
        raise ValueError("the grid must be monotonic")
    return grid
