"""The port's counterparts of the JAX package's Pallas tools (``tools/`` at
the root of the repository), and what they share with ``chip_smoke.py``.

- :mod:`.microbench_conv`: the order-k Cauchy convolution microbenchmark
  (kernel T1, f32 and two-f32), ``tools/microbench_pallas_conv.py``;
- :mod:`.proto_phase`: the f32 phase prototype (kernel T2) on the
  outer-Solar-System tape, ``tools/proto_pallas_phase.py``, timed beside
  kernel B4 in f64;
- :mod:`.roofline`: the least time the H100 could take for a kernel's work;
- :mod:`.jet_scan`: kernel B2's time against the blocks an SM holds and
  against the order, on the outer-Solar-System tape;
- :mod:`.rolled_scan`: where kernel B3's time goes on the mascon-512 tape
  (against K, lanes, block size and layout, and a per-pass clock trace);
- :mod:`.same_bits`: kernels B1, B2, B3, B4 and T2 of two checkouts of the
  port on the same inputs, bit for bit, and the pendulum slice of either
  (a script run with a checkout on ``PYTHONPATH``);
- :mod:`.cases`: the phase route's test tapes and lanes.

Each tool runs on the card: ``python -m heyoka_tpu_torch.tools.<name>``.

The north-star constants below are copies of ``bench.py``'s (the outer
Solar System: masses in solar masses, G in AU^3 / (Msun yr^2), J2000-ish
initial conditions in AU and AU/yr); the port imports neither ``bench``
nor ``tools``, and the tests hold the copies equal to the originals.
:func:`mascon_body` and :func:`mascon_lanes` make the mascon cells' body
and lanes as ``benchmarks/mascon_bench.py`` draws them.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

MASSES = [
    1.00000597682,
    1.0 / 1047.355,
    1.0 / 3501.6,
    1.0 / 22869.0,
    1.0 / 19314.0,
    7.4074074e-09,
]
GCONST = 0.01720209895**2 * 365 * 365

IC = np.array([
    # Sun
    -4.06428567034226e-3, -6.08813756435987e-3, -1.66162304225834e-6,
    +6.69048890636161e-6 * 365, -6.33922479583593e-6 * 365, -3.13202145590767e-9 * 365,
    # Jupiter
    +3.40546614227466e+0, +3.62978190075864e+0, +3.42386261766577e-2,
    -5.59797969310664e-3 * 365, +5.51815399480116e-3 * 365, -2.66711392865591e-6 * 365,
    # Saturn
    +6.60801554403466e+0, +6.38084674585064e+0, -1.36145963724542e-1,
    -4.17354020307064e-3 * 365, +3.99723751748116e-3 * 365, +1.67206320571441e-5 * 365,
    # Uranus
    +1.11636331405597e+1, +1.60373479057256e+1, +3.61783279369958e-1,
    -3.25884806151064e-3 * 365, +2.06438412905916e-3 * 365, -2.17699042180559e-5 * 365,
    # Neptune
    -3.01777243405203e+1, +1.91155314998064e+0, -1.53887595621042e-1,
    -2.17471785045538e-4 * 365, -3.11361111025884e-3 * 365, +3.58344705491441e-5 * 365,
    # Pluto
    -2.13858977531573e+1, +3.20719104739886e+1, +2.49245689556096e+0,
    -1.76936577252484e-3 * 365, -2.06720938381724e-3 * 365, +6.58091931493844e-4 * 365,
])


def cuda_device(device) -> torch.device:
    """``device`` as a CUDA device; raises unless it is one and a card is
    there (the tools time the card and never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the tools run on a CUDA device; got {dev} "
            f"(torch.cuda.is_available() is {torch.cuda.is_available()})")
    return dev


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one
    warm-up run unless ``warmup`` is False (CUDA events on the current
    stream)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs captured in
    one CUDA graph and replayed, after one warm-up run and one replay: for
    a kernel that takes about as long as its launch from Python, whose
    back-to-back launches :func:`cuda_ms` would time at the host's rate."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mascon_body(N):
    """``benchmarks/mascon_bench.py``'s body: N mascons drawn in the unit
    ball, total mass 1, spinning about z with period 10; returns the
    system's keywords and the generator, positioned where the benchmark
    draws its lanes."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1.0, 1.0, (4 * N, 3))
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0][:N]
    masses = rng.uniform(0.5, 1.0, N)
    masses /= masses.sum()
    kw = dict(Gconst=1.0, masses=masses.tolist(), positions=pts.tolist(),
              omega=(0.0, 0.0, 2.0 * np.pi / 10.0))
    return kw, rng


def mascon_lanes(rng, B, omega=None):
    """``mascon_bench.py``'s lanes: at r ~ 2, with the circular speed
    along the orbit.  The model works in the body's rotating frame, so
    these lanes move at the circular speed plus the frame's (about twice
    the escape speed) and leave the body.  Given ``omega``, the frame's
    velocity w x r is taken out, which makes them the bound near-circular
    orbits the benchmark describes."""
    ang = rng.uniform(0, 2 * np.pi, B)
    r0 = 2.0 + 0.05 * rng.standard_normal(B)
    vc = np.sqrt(1.0 / r0)
    st = np.zeros((B, 6))
    st[:, 0] = r0 * np.cos(ang)
    st[:, 1] = r0 * np.sin(ang)
    st[:, 3] = -vc * np.sin(ang)
    st[:, 4] = vc * np.cos(ang)
    if omega is not None:
        st[:, 3:] -= np.cross(omega, st[:, :3])
    return st
