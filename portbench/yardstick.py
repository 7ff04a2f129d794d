"""The benchmark's fixed arithmetic: the card's published peaks, the least
time a count of work could take on it, and the lanes' initial states
drawn from a seed.  Later changes to the program leave this file as it
is; the work itself is counted per configuration, from its equations, in
``reference/<config>.py`` (``flops_per_step``).
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM (80 GB HBM3), the data sheet's dense peaks at 700 W.
#: FP64 counts at the tensor cores' rate, the higher of the two FP64
#: rates (34 TFLOP/s outside them), so that no implementation of the
#: jets, on either unit, can read above 100 %.
PEAK_FP64_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the card could take for ``flops`` FP64 operations
    and ``bytes_`` bytes to and from its memory: the larger of the two
    bounds."""
    return max(flops / PEAK_FP64_FLOPS, bytes_ / PEAK_HBM_BYTES)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one of a run's independent streams (0: initial
    states, 1 and 2: the samples the check compares), from any whole
    ``seed``."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def initial_conditions(cfg: dict, lanes: int, seed: int) -> np.ndarray:
    """``(lanes, n)`` initial states: the configuration's ``ic`` perturbed
    per component by ``scale N(0, 1)``, relative to the component's size
    (``relative_normal``) or absolute (``absolute_normal``).  The same
    seed gives the same states.
    (After the north-star lanes of ``chip_smoke.lanes``, a relative
    uniform 1e-8, and ``chip_smoke.hh_lanes``, an absolute normal 1e-3;
    here both are normal and drawn from the seed.)"""
    ic = np.asarray(cfg["ic"], dtype=np.float64)
    p = cfg["perturbation"]
    z = rng(seed, 0).standard_normal((lanes, ic.size)) * p["scale"]
    if p["kind"] == "relative_normal":
        return ic[None] + np.abs(ic)[None] * z
    if p["kind"] == "absolute_normal":
        return ic[None] + z
    raise ValueError(f"unknown perturbation {p['kind']!r}")
