"""Faults planted under a run's timed path, to show that the check turns
``correct`` false when the program breaks in these ways
(``tests/test_portbench_check.py``), and to read the numbers a fault
gives on the card (``control.py --fault``).  Each wraps a system of a
loop (``loops/<loop>.py``, which lists the faults it can have in
``FAULTS``) and breaks what it returns, where it is produced:

- ``unchanged``: a call or step returns the state it returned before;
- ``half_batch``: a call leaves the second half of its lanes out (their
  state and time as the call before returned them);
- ``altered``: an answer altered: every state's first component moved
  by a relative 1e-6;
- ``steps_doubled``: a call reports twice the steps it took (a count a
  rate is made of, inflated).
"""

from __future__ import annotations

import numpy as np


class _Fault:
    def __init__(self, inner, name):
        self.inner, self.name = inner, name
        self._prev = None

    def call(self, t):
        r = {k: np.array(v, copy=True) for k, v in self.inner.call(t).items()}
        prev = self._prev
        n = self.name
        if n == "unchanged" and prev is not None:
            r["state"] = prev["state"]
        elif n == "half_batch" and prev is not None:
            half = slice(r["state"].shape[0] // 2, None)
            for k in ("state", "time"):
                r[k][half] = prev[k][half]
            r["ok"][half] &= r["time"][half] == t
        elif n == "altered":
            r["state"][:, 0] += 1e-6 * np.abs(r["state"]).max(1)
        elif n == "steps_doubled":
            r["nsteps"] = 2 * r["nsteps"]
        self._prev = {k: r[k].copy() for k in ("state", "time")}
        return r

    def step(self):
        r = dict(self.inner.step())
        r["state"] = r["state"].copy()
        if self.name == "unchanged" and self._prev is not None:
            r["state"] = self._prev
        elif self.name == "altered":
            r["state"][0] += 1e-6 * np.abs(r["state"]).max()
        self._prev = r["state"].copy()
        return r


def plant(name):
    """A wrapper that plants the fault ``name`` into a system."""
    return lambda system: _Fault(system, name)
