"""Fused adaptive propagation: ``propagate_until`` in chunks of kernel B1.

The counterpart of ``heyoka_tpu/taylor/fused.py`` (``make_propagate_until_
fused`` :45).  Each launch of ``jet_kernels.prop`` takes up to
``chunk_steps`` whole adaptive steps per lane; between launches the driver
folds each lane's accumulated signed steps into its double-length time,
merges the statistics and refreshes the remaining time.  One host sync per
chunk (the loop's exit test).  Spans (:mod:`..logging`): ``hy.fused.chunk``
a launch, its bookkeeping and the sync that waits for it, whose first is a
``hy.sync.fused_go`` span alone; ``hy.landing`` the per-step landing.

Landing stays exact: the kernel freezes a lane when its natural step would
reach the target, and the last step(s) of every lane run through the
per-step driver (``compact_flat._pu_while``), so the final ``t`` equals the
target bit for bit and the outcomes follow the per-step semantics.

The JAX driver picks the in-kernel step sizes in f32; here they are f64
and computed exactly as the per-step driver computes them, so a lane walks
the same step sequence as under ``compact_flat.make_propagate_until_flat``.
"""

from __future__ import annotations

import torch

from ..dfloat import dd_add_dd
from ..logging import host_read, trace_ctx
from .compact_flat import _pu_while, make_batched_step_flat
from .jet_kernels import JetTape, _check_autonomous, prop
from .outcome import TaylorOutcome

_I32_MAX = 2**31 - 1


def make_propagate_until_fused(tape: JetTape, *, high_accuracy: bool = True,
                               chunk_steps: int = 64):
    """Build ``pu(state (B, n), pars (B, p), t_hi, t_lo, target_hi,
    target_lo, max_delta_t, max_steps) -> dict`` with the signature and
    result fields of :func:`.compact_flat.make_propagate_until_flat`.

    Raises ``UnsupportedKernelOp`` for a tape with a time column (the
    kernel carries no time)."""
    _check_autonomous(tape)
    land_step = make_batched_step_flat(tape, high_accuracy=high_accuracy)

    def pu(state, pars, t_hi, t_lo, target_hi, target_lo, max_delta_t,
           max_steps):
        B = state.shape[0]
        dev, f64 = state.device, state.dtype
        rem0, _ = dd_add_dd(target_hi, target_lo, -t_hi, -t_lo)
        fwd = rem0 > 0.0
        sgn = torch.where(fwd, 1.0, -1.0).to(f64)
        pars_t = pars.T.contiguous()

        st = state.T.contiguous()
        nsteps = torch.zeros(B, dtype=torch.int64, device=dev)
        min_h = torch.full((B,), float("inf"), dtype=f64, device=dev)
        max_h = torch.zeros(B, dtype=f64, device=dev)
        last_h = torch.zeros(B, dtype=f64, device=dev)
        near = torch.zeros(B, dtype=torch.bool, device=dev)
        err = torch.zeros_like(near)
        act = rem0 != 0.0
        stalled_mask = torch.zeros_like(act)

        def left(ns):
            # steps the kernel may still take: the per-step landing keeps
            # the last one (max_steps counts every step of the lane)
            if max_steps > 0:
                return (max_steps - 1 - ns).clamp(0, _I32_MAX)
            return torch.full_like(ns, _I32_MAX)

        def go():
            # the loop's one host sync: go on while a lane is active; a lane
            # that stayed active without taking a step means a faulty chunk
            more, stalled = host_read("hy.sync.fused_go", torch.stack(
                [act.any(), (act & stalled_mask).any()]).tolist)
            if stalled:
                raise RuntimeError("fused propagation: an active lane took "
                                   "no step in a chunk")
            return more

        going = go()
        while going:
            with trace_ctx("hy.fused.chunk"):
                # remaining time in the direction of travel (>= 0), as a dd
                # pair
                rh, rl = dd_add_dd(target_hi, target_lo, -t_hi, -t_lo)
                aux = torch.stack([max_delta_t, sgn, rh * sgn, rl * sgn,
                                   act.to(f64)])
                auxi = left(nsteps).to(torch.int32)[None]
                st, of, oi = prop(tape, st, pars_t, aux, auxi, chunk_steps,
                                  high_accuracy)
                ns = oi[0].to(torch.int64)
                t_hi, t_lo = dd_add_dd(t_hi, t_lo, of[0], of[1])
                near = near | (oi[1] > 0)
                err = err | (oi[2] > 0)
                nsteps = nsteps + ns
                min_h = torch.minimum(min_h, of[2])
                max_h = torch.maximum(max_h, of[3])
                last_h = torch.where(ns > 0, of[4], last_h)
                act = act & ~near & ~err & (left(nsteps) > 0)
                stalled_mask = ns == 0
                going = go()

        rem_l, _ = dd_add_dd(target_hi, target_lo, -t_hi, -t_lo)
        land = dict(
            state=st.T.contiguous(), t_hi=t_hi, t_lo=t_lo, last_h=last_h,
            tc=torch.zeros((B, tape.order + 1, tape.n_eq), dtype=f64,
                           device=dev),
            nsteps=nsteps, min_h=min_h, max_h=max_h,
            outcome=torch.full((B,), int(TaylorOutcome.time_limit),
                               dtype=torch.int32, device=dev),
            done=rem_l == 0.0,
        )
        with trace_ctx("hy.landing"):
            return _pu_while(land_step, pars, target_hi, target_lo,
                             max_delta_t, max_steps, fwd, land,
                             step_span="hy.landing.step")

    return pu
