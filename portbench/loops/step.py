"""The ``step`` loop: a closed loop of one client on one trajectory,
``step()`` and the state read back to the host, then the next step.

The program is ``heyoka_tpu_torch.taylor_adaptive`` on lane 0 with the
configuration's equations, tolerance and the traffic's ``integrator``
options.  Traffic keys: ``warmup_steps`` (set-up's), and ``check``:
``chain`` window steps followed from the seed after set-up's, and
``steps`` more compared on their own.

The numbers, each held to the limit of ``cells/<cell>.json``:

- ``state_gap``: the largest ``max |x - x_ref| / max |x_ref|`` of a
  compared step.  The reference follows set-up's steps and the window's
  first ``chain`` from the initial state on, step by step; each later
  compared step (the window's last and others drawn from the seed) it
  takes from the state the program returned before it;
- ``h_gap``: the largest ``|h - h_ref| / h_ref`` of a compared step;
- ``energy_drift``: ``|E(x) - E(x_0)| / |E(x_0)|`` of the state after the
  window's last step against the initial state, ``E`` the
  configuration's conserved energy in the reference: the whole window
  from the seed, without following the program;
- ``step_misses``: steps without the outcome ``success`` and a finite
  state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check
from portbench.reference import taylor

#: the faults of ``faults.py`` a step can have
FAULTS = ("unchanged", "altered")


class Port:
    """``heyoka_tpu_torch.taylor_adaptive`` on lane 0.  A step returns
    ``h``, ``state (n,)``, ``time`` and ``ok`` (the outcome ``success``
    and a finite state)."""

    def __init__(self, ht, cell, ics, device):
        self.ta = ht.taylor_adaptive(
            cell.port_system.system(ht, cell.cfg), ics[0], device=device,
            **cell.integrator_options())
        self._success = ht.TaylorOutcome.success

    def step(self):
        oc, h = self.ta.step()
        state = self.ta.state
        return dict(h=h, state=state, time=self.ta.time,
                    ok=oc == self._success and bool(np.isfinite(state).all()))


class Control:
    """The reference's step in the program's place on lane 0, in
    ``dtype``."""

    def __init__(self, cell, ics, device, dtype):
        self.sys = cell.ref.make(cell.cfg, dtype, device)
        self.K = taylor.order_from_tol(cell.cfg["tol"])
        self.x = torch.as_tensor(ics[:1], dtype=dtype, device=device)
        self.t = 0.0

    def step(self):
        c = self.sys.jet(self.x, self.K)
        h = taylor.step_size(c, self.K)
        self.x = taylor.horner(c, h)
        self.t += float(h[0])
        state = self.x[0].double().cpu().numpy()
        return dict(h=float(h[0]), state=state, time=self.t,
                    ok=bool(np.isfinite(state).all()))


def run(s, cell, ics, seed, seconds, window):
    """Set-up's steps from the initial state, then ``step()`` until
    ``seconds`` have passed, each timed until its state is on the host."""
    warm = []
    for _ in range(cell.traffic["warmup_steps"]):
        r = s.step()
        warm.append((r["h"], r["state"]))
    steps, step_ms, misses = [], [], 0
    t_begin = time.perf_counter()
    with window():
        while True:
            a = time.perf_counter()
            r = s.step()
            b = time.perf_counter()
            step_ms.append(1e3 * (b - a))
            steps.append((r["h"], r["state"]))
            misses += not r["ok"]
            if b - t_begin >= seconds:
                break
        window_s = time.perf_counter() - t_begin
    return dict(t_begin=t_begin, window_s=window_s, step_ms=step_ms,
                attempted=len(steps), failed=misses, misses=misses,
                ic=ics[0], steps=warm + steps, warm=len(warm))


def numbers(rec, cell, device):
    """The numbers of the record ``rec`` of :func:`run`."""
    sys_ = cell.ref.make(cell.cfg, torch.float64, device)
    K = taylor.order_from_tol(cell.cfg["tol"])
    chk, steps = cell.traffic["check"], rec["steps"]

    def one(x):
        c = sys_.jet(torch.as_tensor(x, device=device), K)
        h = taylor.step_size(c, K)
        return taylor.horner(c, h).cpu().numpy(), h.cpu().numpy()

    # set-up's steps and the window's first, followed from the initial
    # state on
    chain = min(rec["warm"] + chk["chain"], len(steps))
    x = rec["ic"][None]
    s_gaps, h_gaps = [], []
    for h_mine, st in steps[:chain]:
        x, h = one(x)
        s_gaps.append(check.gaps(st[None], x))
        h_gaps.append(np.abs(h_mine - h) / h)
    # later steps, each from the state the program returned before it
    later = check.index_sample(rec["seed"], chain, len(steps), chk["steps"])
    if later:
        x, h = one(np.stack([steps[i - 1][1] for i in later]))
        s_gaps.append(check.gaps(np.stack([steps[i][1] for i in later]), x))
        h_gaps.append(np.abs(np.array([steps[i][0] for i in later]) - h) / h)
    return dict(state_gap=check.largest(s_gaps),
                h_gap=check.largest(h_gaps),
                energy_drift=check.energy_drift(sys_, rec["ic"][None],
                                                steps[-1][1][None], device),
                step_misses=int(rec["misses"]))
