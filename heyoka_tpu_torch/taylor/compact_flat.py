"""The batched adaptive step over the jet, and the per-step
propagate-until driver.

The counterpart of ``heyoka_tpu/taylor/compact_flat.py``:
``make_batched_step_flat`` (:168), ``make_propagate_until_flat`` (:1157)
and its lockstep loop ``_pu_while`` (:1214).  The JAX step evaluates the
jet in XLA (or in a Pallas kernel) and then the step size and the state
update; here the jet is the one passed in — ``jet_kernels.jet`` (kernel
B2) or, for huge tapes, ``jet_rolled.jet_rolled`` (kernel B3), each
launching its kernel on a CUDA tensor and running its plain twin on a CPU
tensor — and the rest is plain f64 torch on the same device.  There is one engine: the TPU layouts, the staged buffers,
the mixed-precision phase and the coefficient scaling have no
counterpart.
"""

from __future__ import annotations

import torch

from ..dfloat import dd_add_d, dd_add_dd
from .jet_kernels import JetTape, jet
from .outcome import TaylorOutcome
from .stepper import ceval_update, h_from_norms, horner_update


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


def make_propagate_until_flat(tape: JetTape, *, high_accuracy: bool = True,
                              jet=jet):
    """Lockstep propagate-until over :func:`make_batched_step_flat` with
    ``jet``:
    ``pu(state (B, n), pars (B, p), t_hi, t_lo, target_hi, target_lo,
    max_delta_t, max_steps) -> dict`` of per-lane fields (``state``,
    ``t_hi``, ``t_lo``, ``last_h``, ``tc``, ``nsteps``, ``min_h``,
    ``max_h``, ``outcome``, ``done``)."""
    step = make_batched_step_flat(tape, high_accuracy=high_accuracy,
                                  jet=jet)

    def pu(state, pars, t_hi, t_lo, target_hi, target_lo, max_delta_t,
           max_steps):
        B = state.shape[0]
        dev = state.device
        rem0, _ = dd_add_dd(target_hi, target_lo, -t_hi, -t_lo)
        init = dict(
            state=state, t_hi=t_hi, t_lo=t_lo,
            last_h=torch.zeros(B, dtype=state.dtype, device=dev),
            tc=torch.zeros((B, tape.order + 1, tape.n_eq), dtype=state.dtype,
                           device=dev),
            nsteps=torch.zeros(B, dtype=torch.int64, device=dev),
            min_h=torch.full((B,), float("inf"), dtype=state.dtype,
                             device=dev),
            max_h=torch.zeros(B, dtype=state.dtype, device=dev),
            outcome=torch.full((B,), int(TaylorOutcome.time_limit),
                               dtype=torch.int32, device=dev),
            done=rem0 == 0.0,
        )
        return _pu_while(step, pars, target_hi, target_lo, max_delta_t,
                         max_steps, rem0 > 0.0, init)

    return pu


def _pu_while(step, pars, target_hi, target_lo, max_delta_t, max_steps,
              fwd, c):
    """The lockstep propagate-until loop over a batched ``step``, from the
    carry ``c`` (the fields of :func:`make_propagate_until_flat`'s
    result).  Shared with the fused driver (:mod:`.fused`), whose exact
    landing enters mid-flight with the kernel's state, time and
    statistics.  One host sync per step (the loop's exit test)."""
    c = dict(c)

    def remaining(th, tl):
        rh, _ = dd_add_dd(target_hi, target_lo, -th, -tl)
        return rh

    while not bool(c["done"].all()):
        done = c["done"]
        rem = remaining(c["t_hi"], c["t_lo"])
        cap = torch.minimum(torch.abs(rem), max_delta_t)
        # finished lanes step with dt = 0 (their results are masked out)
        cap = torch.where(done, torch.zeros_like(cap), cap)
        dt = torch.where(fwd, cap, -cap)

        new_state, h, tc = step(c["state"], pars, c["t_hi"], dt)
        nt_hi, nt_lo = dd_add_d(c["t_hi"], c["t_lo"], h)

        finite = torch.isfinite(new_state).all(1) & torch.isfinite(h)
        nsteps = c["nsteps"] + 1
        rem_after = remaining(nt_hi, nt_lo)
        reached = torch.where(fwd, rem_after <= 0.0, rem_after >= 0.0)
        hit_step_limit = (nsteps >= max_steps) & ~reached if max_steps > 0 \
            else torch.zeros_like(reached)
        outcome = torch.full_like(c["outcome"], int(TaylorOutcome.time_limit))
        outcome.masked_fill_(hit_step_limit, int(TaylorOutcome.step_limit))
        outcome.masked_fill_(~finite, int(TaylorOutcome.err_nf_state))
        alive = ~done

        def sel(new, old):
            return torch.where(alive, new, old)

        abs_h = torch.abs(h)
        c = dict(
            state=torch.where(alive[:, None], new_state, c["state"]),
            t_hi=sel(nt_hi, c["t_hi"]),
            t_lo=sel(nt_lo, c["t_lo"]),
            last_h=sel(h, c["last_h"]),
            tc=torch.where(alive[:, None, None], tc, c["tc"]),
            nsteps=sel(nsteps, c["nsteps"]),
            min_h=sel(torch.minimum(c["min_h"], abs_h), c["min_h"]),
            max_h=sel(torch.maximum(c["max_h"], abs_h), c["max_h"]),
            outcome=sel(outcome, c["outcome"]),
            done=sel(~finite | hit_step_limit | reached, done),
        )
    return c
