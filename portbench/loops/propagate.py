"""The ``propagate`` loop: a closed loop of one client over a batch of
lanes, ``propagate_until(t + span)`` on every lane and the states read
back to the host, then the next span on the same lanes.

The program is ``heyoka_tpu_torch.taylor_adaptive_batch`` with the
configuration's equations, tolerance and the traffic's ``integrator``
options.  Traffic keys: ``lanes``, ``span``, and ``check``: ``lanes``
sampled from the seed, ``chain`` calls followed from the seed and
``calls`` more compared on their own.

The numbers, each held to the limit of ``cells/<cell>.json``:

- ``state_gap``: the largest of a sampled lane's ``max |x - x_ref| /
  max |x_ref|`` in a compared call.  The reference follows the first
  ``chain`` calls (set-up's and the window's first) from the seed's
  initial states on; each later compared call (the window's last and
  others drawn from the seed) it integrates from the state the program
  returned before it, since a chain of tens of spans would outlast the
  window and errors of 1e-15 grow with the span in a chaotic lane;
- ``steps_gap``: the largest ``(|n - n_ref| - 1) / n_ref`` (0 at least)
  of a lane's steps in a compared call, the work a lane-step rate
  counts: one step either way is the landing, since the program keeps
  time in two doubles and may take one more step, of less than an ulp of
  the time, to land exactly on the target;
- ``energy_drift``: the largest ``|E(x) - E(x_0)| / |E(x_0)|`` of a
  sampled lane's state after the window's last call against its initial
  state, ``E`` the configuration's conserved energy in the reference:
  the whole window from the seed, without following the program;
- ``landing_misses``: lanes of any call that did not end on the call's
  target with the outcome ``time_limit`` and a finite state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check
from portbench.reference import taylor

#: the faults of ``faults.py`` a call can have
FAULTS = ("unchanged", "half_batch", "altered", "steps_doubled")


class Port:
    """``heyoka_tpu_torch.taylor_adaptive_batch`` over every lane.  A call
    returns ``nsteps (B,)``, ``state (B, n)``, ``time (B,)`` and ``ok
    (B,)``: the lane landed on ``t`` with the outcome ``time_limit`` and a
    finite state."""

    def __init__(self, ht, cell, ics, device):
        self.tb = ht.taylor_adaptive_batch(
            cell.port_system.system(ht, cell.cfg), ics, device=device,
            **cell.integrator_options())
        self._limit = int(ht.TaylorOutcome.time_limit)

    def call(self, t):
        oc, _, _, ns = self.tb.propagate_until(t)
        state, time_ = self.tb.state, self.tb.time
        ok = ((np.fromiter((int(o) for o in oc), np.int64, len(oc))
               == self._limit) & (time_ == t) & np.isfinite(state).all(1))
        return dict(nsteps=np.asarray(ns, np.int64), state=state, time=time_,
                    ok=ok)


class Control:
    """The reference in the program's place, every lane, in ``dtype``."""

    def __init__(self, cell, ics, device, dtype):
        self.sys = cell.ref.make(cell.cfg, dtype, device)
        self.K = taylor.order_from_tol(cell.cfg["tol"])
        self.x = torch.as_tensor(ics, dtype=dtype, device=device)
        self.t = 0.0

    def call(self, t):
        self.x, ns = taylor.propagate(self.sys.jet, self.x, t - self.t,
                                      self.K)
        self.t = t
        state = self.x.double().cpu().numpy()
        return dict(nsteps=ns.cpu().numpy(), state=state,
                    time=np.full(state.shape[0], t),
                    ok=np.isfinite(state).all(1))


def run(s, cell, ics, seed, seconds, window):
    """Set-up's call from the initial states, then ``propagate_until(t +
    span)`` until ``seconds`` have passed.  The record keeps each call's
    sampled lanes."""
    tr = cell.traffic
    span = float(tr["span"])
    lanes = check.lane_sample(seed, ics.shape[0], tr["check"]["lanes"])
    calls = []

    def take():
        t = span * (len(calls) + 1)
        r = s.call(t)
        calls.append(dict(state=r["state"][lanes], nsteps=r["nsteps"][lanes],
                          misses=int((~r["ok"]).sum())))
        return int(r["nsteps"].sum())

    take()
    lane_steps, call_s = 0, []
    t_begin = time.perf_counter()
    with window():
        while True:
            a = time.perf_counter()
            lane_steps += take()
            b = time.perf_counter()
            call_s.append(b - a)
            if b - t_begin >= seconds:
                break
        window_s = time.perf_counter() - t_begin
    return dict(t_begin=t_begin, window_s=window_s, lane_steps=lane_steps,
                call_s=call_s, attempted=len(calls) - 1,
                failed=sum(c["misses"] > 0 for c in calls[1:]),
                state_bytes=(len(calls) - 1) * ics.shape[0] * ics.shape[1]
                * 16, ic=ics[lanes], calls=calls)


def numbers(rec, cell, device):
    """The numbers of the record ``rec`` of :func:`run`."""
    sys_ = cell.ref.make(cell.cfg, torch.float64, device)
    K = taylor.order_from_tol(cell.cfg["tol"])
    chk, span, calls = cell.traffic["check"], float(cell.traffic["span"]), \
        rec["calls"]
    chain = min(chk["chain"], len(calls))
    mine, n_mine, x_ref, n_ref = [], [], [], []
    # the first calls, followed from the seed's initial states
    x = torch.as_tensor(rec["ic"], device=device)
    for c in calls[:chain]:
        x, ns = taylor.propagate(sys_.jet, x, span, K)
        x_ref.append(x.cpu().numpy())
        n_ref.append(ns.cpu().numpy())
        mine.append(c["state"])
        n_mine.append(c["nsteps"])
    # later calls, each from the state the program returned before it
    later = check.index_sample(rec["seed"], chain, len(calls), chk["calls"])
    if later:
        x, ns = taylor.propagate(
            sys_.jet, torch.as_tensor(np.concatenate(
                [calls[c - 1]["state"] for c in later]), device=device),
            span, K)
        x_ref.append(x.cpu().numpy())
        n_ref.append(ns.cpu().numpy())
        mine += [calls[c]["state"] for c in later]
        n_mine += [calls[c]["nsteps"] for c in later]
    mine, x_ref = np.concatenate(mine), np.concatenate(x_ref)
    n_mine, n_ref = np.concatenate(n_mine), np.concatenate(n_ref)
    return dict(
        state_gap=check.largest([check.gaps(mine, x_ref)]),
        steps_gap=check.largest([np.maximum(np.abs(n_mine - n_ref) - 1, 0)
                                 / n_ref]),
        energy_drift=check.energy_drift(sys_, rec["ic"], calls[-1]["state"],
                                        device),
        landing_misses=int(sum(c["misses"] for c in calls)))
