"""What decides ``correct``: the answers the timed path produced, held
against the plain reference of ``reference/<config>.py`` in float64,
once the window has closed.  Each loop (``loops/<loop>.py``) says which
answers it compares and how (its ``numbers``); the pieces they share,
and the judgement against the limits of ``cells/<cell>.json``, are here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import yardstick


def lane_sample(seed, lanes, n):
    """The sampled lanes, sorted: ``n`` of ``lanes`` drawn from the seed."""
    return np.sort(yardstick.rng(seed, 1).choice(lanes, min(n, lanes),
                                                 replace=False))


def index_sample(seed, lo, count, n):
    """At most ``n`` indices of ``range(lo, count)``, sorted: the last,
    and others drawn from the seed."""
    if count <= lo or n < 1:
        return []
    others = np.arange(lo, count - 1)
    k = min(n - 1, others.size)
    pick = yardstick.rng(seed, 2).choice(others, k, replace=False).tolist()
    return sorted(pick + [count - 1])


def gaps(x, ref):
    """Each row's ``max |x - ref| / max |ref|`` (NaN where either is)."""
    return np.abs(x - ref).max(1) / np.abs(ref).max(1)


def largest(parts):
    """The largest of the arrays ``parts``, NaN if one holds a NaN, 0 if
    they are empty."""
    a = np.concatenate([np.ravel(p) for p in parts] + [np.zeros(1)])
    return float(a.max())


def energy_drift(sys_, x0, x, device):
    """The largest ``|E(x) - E(x0)| / |E(x0)|`` over the rows of ``x0``
    and ``x`` (``(B, n)``), ``E`` the reference system's energy in
    float64."""
    e0, e = (sys_.energy(torch.as_tensor(np.asarray(v), dtype=torch.float64,
                                         device=device)).cpu().numpy()
             for v in (x0, x))
    return largest([np.abs(e - e0) / np.abs(e0)])


def judge(numbers, limits):
    """``(correct, checks)``: each number beside its limit, in the order
    of ``limits``; a number without a limit is an error of the cell's
    files."""
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits if k in numbers}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
